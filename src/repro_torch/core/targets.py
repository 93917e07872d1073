"""First-class target descriptions and the active-target state.

The paper's contribution is not a fixed conversion ladder but *choosing*
the right lowering per function by analyzing generated code against the
target's vector architecture (VLA, ``vlen >= width``).  That choice is
target-parametric: the best lowering flips between vector widths.  This
module makes the target a first-class, thread-scoped parameter consumed
by the cost models (:mod:`repro_torch.core.trace`), the selection engine
(:mod:`repro_torch.core.registry`), and the tile mapper
(:mod:`repro_torch.core.vtypes`).

Three target families are registered:

  * ``h100`` — the physical machine the port's kernels are *compiled*
    for (kind ``"cuda"``).  Its fields come from the NVIDIA H100 SXM data
    sheet: a warp of 32 lanes, the 64-row ``wgmma`` tile, the 227 KB of
    shared memory one block can use as the scratch budget, 80 GB of HBM
    at 3.35 TB/s, 989 TFLOP/s dense bf16, 450 GB/s NVLink each way.
    It behaves as a fixed-tile machine everywhere a cost model asks.
  * ``tpu-v5e`` / ``tpu-v6`` — fixed-tile cost models kept with the
    field values of the JAX reference, so cost parity can be checked.
  * ``rvv-64`` .. ``rvv-1024`` — the paper's VLA RISC-V vector family.
    ``vlen`` is the register width in bits; the Table-2 validity rule is
    :meth:`Target.supports_width` (a fixed-width logical register maps
    iff ``vlen >= width``).  ``has_vector_libm`` is False: the baseline
    RVV toolchain scalarizes transcendental calls, which is why the
    paper's vtanh/vsigmoid baselines are slow.

``TARGET`` (the default, h100) lives *only* here — every other module
reads the active target through :func:`current_target` or receives it as
an explicit parameter.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Dict, Optional, Union

import numpy as np
import torch


def itemsize(dtype) -> int:
    """Bytes per element of a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


def resolve_device(device="cuda") -> torch.device:
    """The device a tensor-creating function of the port builds on.

    The default is the card; asking for CUDA where none is present
    raises rather than falling back to the CPU (pass ``device="cpu"``
    explicitly for the plain path)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda is not "
                           "available; pass device='cpu' explicitly")
    return dev


@dataclasses.dataclass(frozen=True)
class Target:
    """Hardware constants consumed by lowering selection + cost models."""

    name: str
    kind: str = "tpu"               # "tpu" | "cuda" (fixed tiles) |
                                    # "rvv" (VLA)
    lane: int = 128                 # minor-most vector dimension (elements
                                    # of fp32 for the rvv family)
    mxu: int = 128                  # matrix tile; 1 = no matrix unit
    vlen: int = 0                   # VLA register width in bits (rvv only)
    lmul: int = 1                   # RVV register-group multiplier (1/2/4/8):
                                    # a grouped op touches lmul registers
                                    # and retires lmul register micro-ops
    vmem_bytes: Optional[int] = 16 * 2**20  # None = no scratch constraint
    hbm_bytes: int = 16 * 2**30
    peak_flops_bf16: float = 197e12
    hbm_bw: float = 819e9
    ici_bw: float = 50e9
    has_vector_libm: bool = True    # False => transcendentals scalarize

    # -- derived properties ---------------------------------------------------

    @property
    def vla(self) -> bool:
        """Vector-length-agnostic register file (the paper's RVV model)."""
        return self.kind == "rvv"

    @property
    def has_mxu(self) -> bool:
        return self.mxu >= 8

    def sublane(self, dtype) -> int:
        """Native second-minor tiling for ``dtype`` (fp32:8 bf16:16 i8:32)."""
        if self.vla:
            return 1
        size = itemsize(dtype)
        return max(8, 32 // max(1, size)) if size < 4 else 8

    def vreg_elems(self, dtype) -> int:
        """Elements per vector *register group* for ``dtype``.

        Fixed-tile machines: sublane x lane physical tile.  RVV:
        ``lmul * vlen`` bits re-divided by the element width — the
        paper's Table-2 type mapping generalized to LMUL>1 register
        grouping (vint32m2_t holds 2x the m1 elements).
        """
        size = itemsize(dtype)
        if self.vla:
            return max(1, self.lmul * self.vlen // (8 * size))
        return self.sublane(dtype) * self.lane

    def vinstrs(self, n_elems: int, dtype) -> int:
        """Dynamic vector micro-ops to process ``n_elems`` of ``dtype``.

        An LMUL=m instruction occupies the datapath for m register
        passes, so each grouped instruction is charged ``lmul`` retired
        register micro-ops.  With lmul=1 this is exactly
        ``ceil(n / vreg_elems)``.
        """
        per = math.ceil(max(1, n_elems) / self.vreg_elems(dtype))
        return per * (self.lmul if self.vla else 1)

    @property
    def effective_vlen(self) -> int:
        """Usable register-group width in bits: VLEN x LMUL on the VLA
        family (0 on fixed-tile machines, whose per-dtype capacity is
        :meth:`vreg_elems`)."""
        return self.lmul * self.vlen if self.vla else 0

    def retile_factor(self, lanes: int, dtype) -> int:
        """How many ``lanes``-wide logical registers of ``dtype`` one
        register group holds (1 = no headroom).  Fixed-tile machines are
        never strip-re-tiled: kernels are compiled for them at tensor
        granularity instead."""
        if not self.vla:
            return 1
        return max(1, self.vreg_elems(dtype) // max(1, lanes))

    def supports_width(self, bits: int) -> bool:
        """The paper's substitution rule: a fixed-width logical register
        maps onto this target iff the vector register group can hold it
        (``lmul * vlen >= width``).  Fixed-tile machines hold any NEON
        width."""
        if self.vla:
            return self.lmul * self.vlen >= bits
        return True

    # RVV architectural register file: 32 vector registers.  An LMUL=m
    # value occupies m of them (2m for a widened 2xSEW destination).
    N_VREGS = 32

    def admissible_lmuls(self, width_scale: int = 1,
                         live_values: int = 0) -> tuple:
        """LMUL candidates legal for a kernel on this target's register
        file: ``lmul * width_scale <= 8`` and ``live_values`` registers
        of ``lmul x width_scale`` each fit the 32-register file (a few
        held back for temporaries).  Non-VLA targets: ``(1,)``."""
        if not self.vla:
            return (1,)
        scale = max(1, int(width_scale))
        out = []
        for m in (1, 2, 4, 8):
            if m * scale > 8:
                continue
            if live_values and live_values * m * scale > self.N_VREGS - 4:
                continue
            out.append(m)
        return tuple(out) or (1,)


def _rvv(bits: int, lmul: int = 1) -> Target:
    suffix = "" if lmul == 1 else f"-m{lmul}"
    return Target(name=f"rvv-{bits}{suffix}", kind="rvv",
                  lane=max(1, bits // 32), mxu=1, vlen=bits, lmul=lmul,
                  vmem_bytes=None, hbm_bytes=0, peak_flops_bf16=0.0,
                  hbm_bw=0.0, ici_bw=0.0, has_vector_libm=False)


def with_lmul(t: Union[str, "Target"], lmul: int) -> "Target":
    """Derive the LMUL=``lmul`` register-grouping variant of an RVV
    target (``rvv-128`` -> ``rvv-128-m4``)."""
    t = get_target(t)
    if not t.vla:
        raise ValueError(f"lmul grouping only applies to rvv targets, "
                         f"not {t.name!r}")
    if lmul not in (1, 2, 4, 8):
        raise ValueError(f"lmul must be 1/2/4/8, got {lmul}")
    base = t.name.split("-m")[0]
    return dataclasses.replace(t, name=base if lmul == 1
                               else f"{base}-m{lmul}", lmul=lmul)


TARGETS: Dict[str, Target] = {}


def register_target(t: Target) -> Target:
    TARGETS[t.name] = t
    return t


# The default target: the card the kernels are compiled for (NVIDIA H100
# SXM data sheet values).  Nothing outside this module imports the
# constant; consumers go through current_target()/use_target().
TARGET = register_target(Target(
    name="h100", kind="cuda", lane=32, mxu=64, vmem_bytes=232448,
    hbm_bytes=80 * 2**30, peak_flops_bf16=989e12, hbm_bw=3.35e12,
    ici_bw=450e9, has_vector_libm=True))
register_target(Target(name="tpu-v5e"))
register_target(Target(name="tpu-v6", vmem_bytes=32 * 2**20,
                       hbm_bytes=32 * 2**30, peak_flops_bf16=918e12,
                       hbm_bw=1640e9, ici_bw=90e9))
for _bits in (64, 128, 256, 512, 1024):
    register_target(_rvv(_bits))
    for _m in (2, 4, 8):
        register_target(_rvv(_bits, _m))

# The paper's evaluation family (Figure 2 sweeps these widths).
RVV_FAMILY = ("rvv-128", "rvv-256", "rvv-512", "rvv-1024")


def get_target(t: Union[str, Target]) -> Target:
    if isinstance(t, Target):
        return t
    try:
        return TARGETS[t]
    except KeyError:
        raise KeyError(f"unknown target {t!r}; known: {sorted(TARGETS)}")


def resolve_target(t: Optional[Union[str, Target]] = None) -> Target:
    """Resolve a target argument to the Target *value* it denotes now.

    ``None`` means the ambient thread-scoped target; anything else goes
    through :func:`get_target`."""
    return current_target() if t is None else get_target(t)


# ---------------------------------------------------------------------------
# Active-target state (thread-scoped, like registry policy)
# ---------------------------------------------------------------------------

_tls = threading.local()
_default_target = TARGET


def current_target() -> Target:
    return getattr(_tls, "target", _default_target)


def set_default_target(t: Union[str, Target]) -> None:
    global _default_target
    _default_target = get_target(t)


@contextlib.contextmanager
def use_target(t: Union[str, Target]):
    """Scope the active target (accepts a name or a Target)."""
    prev = getattr(_tls, "target", None)
    _tls.target = get_target(t)
    try:
        yield _tls.target
    finally:
        if prev is None:
            del _tls.target
        else:
            _tls.target = prev


def compile_target() -> Target:
    """The physical machine kernels are compiled for.

    Kernel launch geometry always needs the real card; when the *cost*
    target is a model (an RVV width or a TPU), kernels still compile
    for the default CUDA description (honoring set_default_target when
    it names a CUDA-kind machine).
    """
    t = current_target()
    if t.kind == "cuda":
        return t
    return _default_target if _default_target.kind == "cuda" else TARGET
