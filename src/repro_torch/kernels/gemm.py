"""Customized lowering of the XNNPACK f32/bf16 GEMM microkernel.

XNNPACK's NEON gemm ladders 4x8 register tiles of C with a fused bias +
minmax clamp.  The reference's TPU kernel retiles for the MXU with an
fp32 VMEM accumulator across the K grid axis.  On the H100
(``csrc/gemm.cu``) the wrapper picks one of three kernels from the dtype
and M alone (:func:`variant`), deterministically:

  * ``small_m`` -- M <= ``SMALL_M_MAX[dtype]`` (8 in bf16, 16 in fp32;
    a decode step: M is the batch).  Split-K weight streaming: B is read
    once as 16-byte vectors, the M rows of A sit in shared memory, K is
    cut into :func:`split_k` slices so ~132 blocks are in flight, and
    a second pass adds the slices' fp32 partial sums (a workspace made
    here with ``torch.empty``) in slice order, then bias, clamp and one
    rounding.  No atomics: two runs agree bitwise.
  * ``mma`` -- M > 8, bfloat16 (prefill).  wgmma (m64n128k16, bf16 in,
    fp32 sums) on 128 x 128 tiles, K through a 3-stage ring of
    128-byte-swizzled tiles filled by TMA (element by element where K or
    N is not a multiple of 8); B read N-major in place with the
    instruction's transpose bit; bias, clamp and rounding in the store.
  * ``simt`` -- M > 16, float32.  fp32 FMA (the tensor cores would round
    fp32 to TF32), bound by operations: 2MNK against the 67 TFLOP/s of
    the H100 SXM data sheet (700 W).  256 threads a block, 8 x 8 sums a
    thread on 128 x 128 tiles; K through a 3-stage ``cp.async`` ring of
    16-deep slots, so loads overlap the products; A stored k-major and B
    row-major, each thread reading both as ``float4``, bank-conflict
    free.  :func:`simt_plan` picks the tile from the shapes alone: where
    128 x 128 tiles leave the card empty, 128 x 64 or 64 x 64, then K
    slices until ~``SIMT_BLOCKS`` blocks are in flight, their fp32 sums
    added in slice order by the split-K kernel's second pass (so two runs
    agree bitwise).

Ragged M, N and K are masked (zero-filled past the end); no operand is
padded or copied.  An empty output launches nothing (a grid of size 0
is no valid launch); K = 0 (the output projection of a 'model' rank
with no heads) launches the chosen kernel, whose K loop then runs no
step: it writes the bias, clamped.  Layouts are the reference's: a
(M, K), b (K, N), bias (N,), all of one dtype (float32 or bfloat16);
the output has a's dtype.

  * ``gemm_plain`` -- the plain version, in torch ops;
  * ``gemm`` -- the wrapper: a CUDA tensor launches the chosen kernel and
    counts the launch in ``LAUNCHES["gemm"]`` and in
    ``LAUNCHES["gemm_<variant>"]`` (a stand-in's is recorded, not
    counted: ``_build.launch``); a CPU tensor runs the plain version;
    any other device raises, and so does a dtype the kernel does not
    take;
  * ``cost`` / ``supports`` -- what the registry ranks and validates it
    by (the reference's cost model, verbatim);
  * ``GemmFn`` -- the autograd Function a train step calls it through.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..core import registry, trace
from . import _build, ref

LAUNCHES = {"gemm": 0, "gemm_small_m": 0, "gemm_mma": 0, "gemm_simt": 0}
VARIANTS = ("small_m", "mma", "simt")
TAKES = {"small_m": (torch.float32, torch.bfloat16),
         "mma": (torch.bfloat16,), "simt": (torch.float32,)}

# M at or below which the split-K kernel runs, by dtype (chip_smoke.py's
# gemm_threshold rows: above 8 bf16 rows wgmma is as fast; fp32 has only
# the SIMT tiles above it); the kernel keeps M x 8 (bf16) or M x 4 (fp32)
# sums per thread in registers, so it takes at most 16 rows
SMALL_M_MAX = {torch.bfloat16: 8, torch.float32: 16}
# split-K: blocks to put in flight (one per SM of the H100's 132: each
# block streams its slice with the next rows' loads in flight), and the
# fewest K rows a slice takes (8 per warp of the block's eight)
SMALL_M_BLOCKS = 132
MIN_SLICE = 64
# the SIMT kernel's block tiles (bm, bn), largest first, its K slot depth,
# and the blocks it puts in flight before it takes smaller tiles or cuts
# K (about one per SM of the H100's 132)
SIMT_TILES = ((128, 128), (128, 64), (64, 64))
SIMT_BK = 16
SIMT_BLOCKS = 128

# The plain version is the oracle's own steps: one fp32 product, the bias
# add and the two-sided clamp, rounded once to a's dtype.
gemm_plain = ref.gemm


def variant(dtype: torch.dtype, m: int) -> str:
    """The kernel a CUDA call with ``m`` rows of ``dtype`` launches."""
    if m <= SMALL_M_MAX[dtype]:
        return "small_m"
    return "mma" if dtype == torch.bfloat16 else "simt"


def split_k(n: int, k: int, dtype: torch.dtype) -> tuple:
    """(splits, ks) of the small-M kernel: slice s covers K rows
    [s*ks, min(k, (s+1)*ks)); every slice is non-empty and together they
    cover [0, k) once.  Enough slices that the ceil(n / (32 * vector))
    column blocks times ``splits`` reach ``SMALL_M_BLOCKS``, each slice a
    multiple of 8 rows and at least ``MIN_SLICE`` of them, or all of k."""
    if k <= 0:
        return 1, 0
    cols = -(-n // (32 * 16 // dtype.itemsize))
    want = -(-SMALL_M_BLOCKS // cols)
    ks = min(k, max(-(-k // want) // 8 * 8, MIN_SLICE))
    return -(-k // ks), ks


def simt_plan(m: int, n: int, k: int) -> tuple:
    """(bm, bn, splits, ks) of the SIMT kernel: the largest tile of
    ``SIMT_TILES`` that gives ``SIMT_BLOCKS`` blocks; where none does,
    the smallest, with K cut into slices [s*ks, min(k, (s+1)*ks)) of a
    multiple of ``SIMT_BK`` rows and at least ``MIN_SLICE`` of them (or
    all of k) until the tiles times the slices reach ``SIMT_BLOCKS``.
    Every slice is non-empty and together they cover [0, k) once."""
    for bm, bn in SIMT_TILES:
        tiles = -(-m // bm) * -(-n // bn)
        if tiles >= SIMT_BLOCKS:
            return bm, bn, 1, k
    if k <= 0:
        return bm, bn, 1, k
    want = -(-SIMT_BLOCKS // tiles)
    ks = min(k, max(-(-k // want) // SIMT_BK * SIMT_BK, MIN_SLICE))
    return bm, bn, -(-k // ks), ks


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("gemm")
    p, i64, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
    lib.repro_gemm_mma_bf16.restype = ctypes.c_int
    lib.repro_gemm_mma_bf16.argtypes = [p, p, p, p, i64, i64, i64, f32, f32,
                                        p]
    lib.repro_gemm_simt_f32.restype = ctypes.c_int
    lib.repro_gemm_simt_f32.argtypes = [p, p, p, p, p] + [i64] * 7 + [f32,
                                                                     f32, p]
    for dt in _build.DTYPES.values():
        fn = getattr(lib, f"repro_gemm_small_m_{dt}")
        fn.restype = ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i64, i64, i64, i64, i64, f32, f32, p]
    return lib


def gemm(a, b, bias=None, clamp_min=float("-inf"), clamp_max=float("inf")):
    """clamp(A @ B + bias).  a:(M,K) b:(K,N) bias:(N,) or None.  The
    kernel is ``variant(a.dtype, M)``."""
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
    return launch(variant(a.dtype, a.shape[0]), a.contiguous(),
                  b.contiguous(), None if bias is None else bias.contiguous(),
                  clamp_min, clamp_max)


def launch(kind, a, b, bias, clamp_min, clamp_max):
    """Launch variant ``kind`` on contiguous CUDA operands that ``gemm``
    has checked, and count it.  ``gemm`` passes ``variant(dtype, M)``;
    ``chip_smoke.py`` also passes the others to time them off their M.
    A variant that does not take the operands raises."""
    (m, k), n = a.shape, b.shape[1]
    if a.dtype not in TAKES[kind]:
        raise TypeError(f"gemm: the {kind} kernel does not take {a.dtype}")
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    ptrs = (_build.ptr(a), _build.ptr(b), _build.ptr(bias), _build.ptr(out))
    tally = dict(count=(LAUNCHES, ("gemm", f"gemm_{kind}")),
                 work=("gemm", (a, b, bias, clamp_min, clamp_max), out))
    if kind == "small_m":
        splits, ks = split_k(n, k, a.dtype)
        ws = torch.empty((splits, m, n), dtype=torch.float32,
                         device=a.device)
        _build.launch(_lib, f"repro_gemm_small_m_{_build.DTYPES[a.dtype]}",
                      a.device, *ptrs, _build.ptr(ws), m, n, k, splits, ks,
                      clamp_min, clamp_max, what="gemm small_m kernel",
                      **tally)
    elif kind == "simt":
        bm, bn, splits, ks = simt_plan(m, n, k)
        ws = None if splits == 1 else torch.empty(
            (splits, m, n), dtype=torch.float32, device=a.device)
        _build.launch(_lib, "repro_gemm_simt_f32", a.device, *ptrs,
                      _build.ptr(ws), m, n, k, bm, bn, splits, ks, clamp_min,
                      clamp_max, what="gemm simt kernel", **tally)
    else:
        _build.launch(_lib, "repro_gemm_mma_bf16", a.device, *ptrs, m, n, k,
                      clamp_min, clamp_max, what="gemm mma kernel", **tally)
    return out


class GemmFn(torch.autograd.Function):
    """clamp(A @ B + bias) through the kernel, with its gradient: dA =
    dY Bᵀ and dB = Aᵀ dY as two more ``ops.gemm`` calls (the kernel
    wherever the registry picks it, under the forward's policy and
    target), each on a transposed contiguous copy, and dbias = Σ dY in
    fp32.  dY is zeroed where the output sits on a finite clamp bound,
    where clamp is flat."""

    @staticmethod
    def forward(ctx, a, b, bias, clamp_min, clamp_max):
        y = gemm(a, b, bias, clamp_min, clamp_max)
        clamped = clamp_min > float("-inf") or clamp_max < float("inf")
        ctx.save_for_backward(a, b, y if clamped else None)
        ctx.bounds = (clamp_min, clamp_max)
        ctx.scope = registry.current_scope()
        ctx.bias_dtype = None if bias is None else bias.dtype
        return y

    @staticmethod
    def backward(ctx, g):
        from . import ops
        a, b, y = ctx.saved_tensors
        if y is not None:
            lo, hi = ctx.bounds
            g = g.masked_fill((y <= lo) | (y >= hi), 0)
        da = db = dbias = None
        with torch.no_grad(), registry.use_scope(ctx.scope):
            if ctx.needs_input_grad[0]:
                da = ops.gemm(g, b.t().contiguous())
            if ctx.needs_input_grad[1]:
                db = ops.gemm(a.t().contiguous(), g)
        if ctx.needs_input_grad[2]:
            dbias = g.sum(0, dtype=torch.float32).to(ctx.bias_dtype)
        return da, db, dbias, None, None


KERNELS = {"gemm": gemm}
PLAIN = {"gemm": gemm_plain}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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
