"""Customized lowering of the XNNPACK f32/bf16 GEMM microkernel.

XNNPACK's NEON gemm ladders 4x8 register tiles of C with a fused bias +
minmax clamp.  The reference's TPU kernel retiles for the MXU with an
fp32 VMEM accumulator across the K grid axis; the Hopper kernel
(``csrc/gemm.cu``) computes 64x64 tiles of C per block, each thread a
4x4 tile of fp32 sums in registers, K walked in 16-deep slices staged in
shared memory, bias and clamp fused into the store.  Ragged M, N and K
are masked by bounds; nothing is padded.

Layouts are the reference's: a (M, K), b (K, N), bias (N,), all of one
dtype (float32 or bfloat16); the output has a's dtype.

  * ``gemm_plain`` — the plain version, in torch ops;
  * ``gemm`` — the wrapper: a CUDA tensor launches the kernel and counts
    the launch in ``LAUNCHES``; a CPU tensor runs the plain version; any
    other device raises, and so does a dtype the kernel does not take;
  * ``cost`` / ``supports`` — what the registry ranks and validates it
    by (the reference's cost model, verbatim).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..core import trace
from . import _build, ref

LAUNCHES = {"gemm": 0}

# The plain version is the oracle's own steps: one fp32 product, the bias
# add and the two-sided clamp, rounded once to a's dtype.
gemm_plain = ref.gemm


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("gemm")
    p, i64, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
    for dt in _build.DTYPES.values():
        fn = getattr(lib, f"repro_gemm_{dt}")
        fn.restype = ctypes.c_int
        fn.argtypes = [p, p, p, p, i64, i64, i64, f32, f32, p]
    return lib


def gemm(a, b, bias=None, clamp_min=float("-inf"), clamp_max=float("inf")):
    """clamp(A @ B + bias).  a:(M,K) b:(K,N) bias:(N,) or None."""
    if _build.route("gemm", a, b, bias) == "cpu":
        return gemm_plain(a, b, bias, clamp_min, clamp_max)
    if not _takes(a, b, bias):
        raise TypeError(f"gemm: kernel takes float32 or bfloat16 operands "
                        f"of one dtype, not {a.dtype}/{b.dtype}/"
                        f"{None if bias is None else bias.dtype}")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0] or (
            bias is not None and tuple(bias.shape) != (b.shape[1],)):
        raise ValueError(f"gemm: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)} + "
                         f"{None if bias is None else tuple(bias.shape)}")
    a, b = a.contiguous(), b.contiguous()
    bias = None if bias is None else bias.contiguous()
    (m, k), n = a.shape, b.shape[1]
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    fn = getattr(_lib(), f"repro_gemm_{_build.DTYPES[a.dtype]}")
    _build.launch(fn, a.device, a.data_ptr(), b.data_ptr(),
                  _build.ptr(bias), out.data_ptr(), m, n, k, clamp_min,
                  clamp_max, what="gemm kernel")
    LAUNCHES["gemm"] += 1
    return out


KERNELS = {"gemm": gemm}
PLAIN = {"gemm": gemm_plain}


def reset_launches() -> None:
    LAUNCHES["gemm"] = 0


def _takes(a, b, bias) -> bool:
    return a.dtype in _build.DTYPES and b.dtype == a.dtype and (
        bias is None or bias.dtype == a.dtype)


def cost(a, b, bias=None, *_, **kw) -> int:
    """Dynamic instruction model (cost-target aware: MXU macro-ops on a
    matrix-unit target, vfma ladder at RVV width)."""
    m, k = a.shape
    n = b.shape[1]
    tgt = trace.current_target()
    vreg = trace.vreg_for(a.dtype)
    if tgt.mxu >= 8:
        macro = math.ceil(m / tgt.mxu) * math.ceil(n / tgt.mxu) * \
            math.ceil(k / tgt.mxu)
    else:
        macro = math.ceil(m * n * k / vreg)
    epilogue = math.ceil(m * n / vreg) * 2
    return macro + epilogue


def supports(a, b, bias=None, *_, **kw) -> bool:
    """2-D operands of one dtype, float32 or bfloat16: the reference's
    rule, with the kernel's one dtype for a, b and bias."""
    return a.ndim == 2 and b.ndim == 2 and _takes(a, b, bias)
