"""Customized lowering of the Mamba2 SSD (state-space duality) scan.

The sequential recurrence

    S_t = exp(dt_t A) S_{t-1} + dt_t x_t (x) B_t ;   y_t = C_t . S_t

runs, in the reference's TPU kernel, as chunks of L steps on a
sequential grid axis with the (p, n) state in VMEM scratch.  The Hopper
kernel (``csrc/ssd.cu``) gives each (batch, head) one block, which walks
the chunks in order with the state, the chunk's x, B, C and its L x L
decay matrix in shared memory:

    y_intra = ((C B^T) * decay) @ (dt * x)
    y_inter = exp(la) * (C @ S^T)
    S_next  = exp(la_L) S + (w * x)^T B

Groups are read per head (h // (h/g)), nothing is repeated or padded in
device memory: rows past the sequence load as zero (dt = 0 is a no-op
step).  The skip term D is added outside the kernel, as the reference
adds it.

  * ``ssd_plain`` — the plain version: ``ref.ssd_chunked`` at the
    kernel's chunk length (the decay masked before ``exp``);
  * ``ssd`` — the wrapper: a CUDA tensor launches the kernel and counts
    it in ``LAUNCHES``, a CPU tensor runs the plain version;
  * ``cost`` / ``supports`` — the reference's, verbatim; ``supports``
    adds the kernel's dtypes and its shared-memory budget.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..core.targets import compile_target, current_target
from ..core.vtypes import round_up
from . import _build, ref

LAUNCHES = {"ssd": 0}
SUBLANE_F32 = 8            # the reference's chunk rounding (fp32 sublane)


def chunk_len(s: int, chunk: int = 128) -> int:
    """The kernel's chunk length: the reference's min(chunk, round_up(s,
    8))."""
    return min(chunk, round_up(max(1, s), SUBLANE_F32))


def smem_bytes(L: int, p: int, n: int) -> int:
    """Shared memory of one block: x (L,p), B (L,n+1), C (L,n), the state
    (p,n+1), the decay matrix (L,L) and three length-L vectors, fp32."""
    return 4 * (L * p + L * (n + 1) + L * n + p * (n + 1) + L * L + 3 * L)


def _smem_budget() -> int:
    """Shared memory one block of the card can use."""
    return compile_target().vmem_bytes


def _add_d(y, x, D):
    if D is None:
        return y
    return y + (D[None, None, :, None] * x.to(torch.float32)).to(y.dtype)


def ssd_plain(x, dt, A, B, C, D=None, chunk=128):
    """x:(b,s,h,p) dt:(b,s,h) A:(h,) B,C:(b,s,g,n) -> y:(b,s,h,p): the
    chunked oracle at the kernel's chunk length."""
    return ref.ssd_chunked(x, dt, A, B, C, D,
                           chunk=chunk_len(x.shape[1], chunk))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd")
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    for dt in _build.DTYPES.values():
        fn = getattr(lib, f"repro_ssd_{dt}")
        fn.restype = ctypes.c_int
        fn.argtypes = [ptr] * 6 + [i64] * 7 + [i64] * 12 + [ptr]
    return lib


def _takes(x, dt, A, B, C) -> bool:
    return (x.dtype in _build.DTYPES and B.dtype == x.dtype
            and C.dtype == x.dtype and dt.dtype == torch.float32
            and A.dtype == torch.float32)


def ssd(x, dt, A, B, C, D=None, chunk=128):
    """Chunked SSD.  x:(b,s,h,p) dt:(b,s,h) A:(h,) B,C:(b,s,g,n)."""
    if _build.route("ssd", x, dt, A, B, C, D) == "cpu":
        return ssd_plain(x, dt, A, B, C, D, chunk)
    if not _takes(x, dt, A, B, C):
        raise TypeError(f"ssd: kernel takes float32 or bfloat16 x, B, C of "
                        f"one dtype and float32 dt, A, not {x.dtype}/"
                        f"{B.dtype}/{C.dtype}, {dt.dtype}/{A.dtype}")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    L = chunk_len(s, chunk)
    if tuple(dt.shape) != (b, s, h) or tuple(A.shape) != (h,) or \
            B.shape != C.shape or tuple(B.shape[:2]) != (b, s) or \
            g == 0 or h % g or smem_bytes(L, p, n) > _smem_budget():
        raise ValueError(f"ssd: shapes x {tuple(x.shape)} dt "
                         f"{tuple(dt.shape)} A {tuple(A.shape)} B "
                         f"{tuple(B.shape)} C {tuple(C.shape)}; the kernel "
                         f"takes h % g == 0 and {_smem_budget()} bytes of "
                         f"shared memory per block")
    ts = [t if t.stride(-1) == 1 else t.contiguous() for t in (x, B, C)]
    x_, B_, C_ = ts
    dt_, A_ = dt.contiguous(), A.contiguous()
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    if y.numel() and b * h:
        fn = getattr(_lib(), f"repro_ssd_{_build.DTYPES[x.dtype]}")
        _build.launch(fn, x.device, x_.data_ptr(), dt_.data_ptr(),
                      A_.data_ptr(), B_.data_ptr(), C_.data_ptr(),
                      y.data_ptr(), b, s, h, p, g, n, L,
                      *x_.stride()[:3], *dt_.stride(), *B_.stride()[:3],
                      *C_.stride()[:3], what="ssd kernel")
        LAUNCHES["ssd"] += 1
    return _add_d(y, x, D)


KERNELS = {"ssd": ssd}
PLAIN = {"ssd": ssd_plain}


def reset_launches() -> None:
    LAUNCHES["ssd"] = 0


def supports(x, dt, A, B, C, D=None, *_, **kw) -> bool:
    """The reference's rule (h % g == 0), with the kernel's dtypes and its
    shared-memory budget at the default chunk."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    return (h % B.shape[2] == 0 and _takes(x, dt, A, B, C)
            and smem_bytes(chunk_len(s), p, n) <= _smem_budget())


def cost(x, dt, A, B, C, D=None, *, chunk=128, **_) -> int:
    """The reference's kernel-structure count."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    L = chunk
    tgt = current_target()
    nch = math.ceil(s / L)
    vreg = tgt.vreg_elems(x.dtype)
    if tgt.has_mxu:
        mx = tgt.mxu
        mm = (math.ceil(L / mx) ** 2 * math.ceil(n / mx)         # C B^T
              + math.ceil(L / mx) ** 2 * math.ceil(p / mx)       # (GW) x
              + 2 * math.ceil(L / mx) * math.ceil(n / mx) * math.ceil(p / mx))
    else:                        # vfma ladder at VLA width
        mm = math.ceil(L * L * (n + p) / vreg) + 2 * math.ceil(L * n * p / vreg)
    per_chunk = mm + 8 * math.ceil(L * L / vreg)
    return b * h * nch * per_chunk
