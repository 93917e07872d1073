"""Customized lowering of attention: flash attention and flash decode.

The reference's TPU kernels keep the running softmax statistics (m, l)
and the fp32 accumulator in VMEM scratch across a sequential kv grid
axis, pad D to 128 lanes and the sequences to their blocks, and take a
decode row's valid length by scalar prefetch.  The Hopper kernels
(``csrc/flash_attention.cu``):

  * ``flash_attention`` — bfloat16 on the tensor cores (mma.sync
    m16n8k16, FlashAttention-2's shape): one block per (b, h, 64 query
    rows), one warp per 16 rows; Q and a double-buffered cp.async ring of
    64-key K and V tiles in shared memory as bf16, D zero-padded to 64,
    128 or 256; S, the online softmax and the fp32 O accumulator in
    registers, P rounded to bf16 as the A operand of P·V.  float32 keeps
    the fp32 SIMT kernel (one block per 32 rows, 32-key tiles), since the
    tensor cores would round it to TF32.  kv tiles that causal order or
    the window mask wholly are never visited.
  * ``decode_attention`` — flash-decoding, bound by the bytes of the
    cache's valid prefix.  :func:`decode_plan` cuts each row's S slots
    into splits (from the shapes alone, never ``lengths``), so
    b * h * splits blocks put ~2 on each SM; each block clips its slots
    to the row's valid range, read from device memory, and reads no key
    outside it.  K and V rows come in as 16-byte vectors (a 256-byte bf16
    row over 16 lanes, two keys a warp instruction; element by element
    where rows are not whole aligned chunks), the next tile's K and V in
    flight during this tile's dots and softmax.  Each split's (m, l, acc)
    goes in fp32 to a workspace made here with ``torch.empty``; a second
    kernel merges the splits in split order, so two runs agree bitwise.

A call with no heads (a 'model' rank that holds none) returns its empty
output and launches nothing: a grid of size 0 is no valid launch.  Both
take the JAX package's op-boundary layout, q (B, Sq, H, D) and k, v
(B, Sk, Hkv, D), and read through strides (D must be contiguous), so the
(B, H, S, D) transposes of the reference's ``ops.py`` are never copied.
D from 1 to 256; GQA (H % Hkv == 0), causal with q_offset = Sk - Sq,
sliding window and tanh softcap are all in the kernels.  Ragged edges
are masked by bounds, nothing is padded.

  * ``flash_attention_plain`` / ``decode_attention_plain`` — the plain
    versions: the oracles ``ref.attention`` and ``ref.decode_attention``
    (a decode row with no valid key gives 0, as the kernels do);
  * ``flash_attention`` / ``decode_attention`` — the wrappers: a CUDA
    tensor launches the kernel and counts it in ``LAUNCHES``, a CPU
    tensor runs the plain version, anything else raises;
  * ``cost`` / ``supports`` — the reference's cost model and validity
    rule, verbatim, in the reference kernel's (B, H, S, D) layout;
    ``supports`` adds the kernels' own limits;
  * ``FlashAttentionFn`` — the autograd Function a train step calls
    flash through.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..core.targets import current_target
from . import _autograd, _build, ref

LAUNCHES = {"flash_attention": 0, "decode_attention": 0}
MAX_D = 256
# decode: blocks to put in flight (two per SM of the H100's 132), and the
# fewest slots a split takes: 64, more where rows are short (at least
# DEC_MIN_ELEMS elements of K a split), so a block's fixed cost stays
# small against its reads
DEC_BLOCKS = 264
DEC_MIN_SLICE = 64
DEC_MIN_ELEMS = 8192


def _scale(d, scale):
    return float(d) ** -0.5 if scale is None else float(scale)


def flash_attention_plain(q, k, v, causal=True, window=None, softcap=None,
                          scale=None):
    """q:(B,Sq,H,D) k,v:(B,Sk,Hkv,D) -> (B,Sq,H,D): ``ref.attention``."""
    return ref.attention(q, k, v, causal=causal, window=window,
                         softcap=softcap, scale=scale)


def decode_attention_plain(q, k, v, lengths, window=None, softcap=None,
                           scale=None):
    """q:(B,1,H,D) k,v:(B,S,Hkv,D) lengths:(B,) int -> (B,1,H,D):
    ``ref.decode_attention``, except that a row with no valid key gives
    0, as the kernels do, where the oracle gives the mean of v."""
    lengths = lengths.to(q.device)
    out = ref.decode_attention(q, k, v, lengths, window, softcap, scale)
    return torch.where((lengths > 0)[:, None, None, None], out, 0.0)


def decode_plan(b: int, h: int, s: int, d: int) -> tuple:
    """(splits, ks) of the decode kernel: split i covers cache slots
    [i*ks, min(s, (i+1)*ks)); every split is non-empty and together they
    cover [0, s) once.  The s slots are cut evenly into as many splits as
    bring b * h * splits to ``DEC_BLOCKS``, as far as each keeps the
    least length, max(``DEC_MIN_SLICE``, ``DEC_MIN_ELEMS`` / d) slots.  A
    function of the shapes alone: reading ``lengths`` would need a host
    sync."""
    if s <= 0:
        return 1, 0
    least = max(DEC_MIN_SLICE, -(-DEC_MIN_ELEMS // d))
    n = max(1, min(-(-DEC_BLOCKS // (b * h)), s // least))
    ks = -(-s // n)
    return -(-s // ks), ks


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    p, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_float)
    for dt in _build.DTYPES.values():
        fn = getattr(lib, f"repro_flash_attention_{dt}")
        fn.restype = ctypes.c_int
        fn.argtypes = [p, p, p, p] + [i64] * 15 + [i32, i64, i32, f32, f32,
                                                  p]
        fn = getattr(lib, f"repro_decode_attention_{dt}")
        fn.restype = ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p] + [i64] * 16 + [i32, f32, f32, i64,
                                                         i64, p]
    return lib


def _check(op, q, k, v):
    if not (q.dtype in _build.DTYPES and k.dtype == q.dtype
            and v.dtype == q.dtype):
        raise TypeError(f"{op}: kernel takes float32 or bfloat16 q, k, v of "
                        f"one dtype, not {q.dtype}/{k.dtype}/{v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape or \
            q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3] or \
            not _grouped(q.shape[2], k.shape[2]) or \
            not 0 < q.shape[3] <= MAX_D:
        raise ValueError(f"{op}: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}; the kernel "
                         f"takes (B,S,H,D) with H % Hkv == 0, D <= {MAX_D}")


def _grouped(h, hkv) -> bool:
    """H q heads over Hkv kv heads: a whole number of q heads a kv head,
    or no heads at all (a 'model' rank that holds none: nothing to
    launch)."""
    return h == hkv == 0 or (hkv > 0 and h % hkv == 0)


def _strided(t):
    """``t`` with a contiguous last axis, and its first three strides."""
    t = t if t.stride(-1) == 1 else t.contiguous()
    return t, list(t.stride()[:3])


def flash_attention(q, k, v, causal=True, window=None, softcap=None,
                    scale=None):
    """Flash attention.  q:(B,Sq,H,D) k,v:(B,Sk,Hkv,D) -> (B,Sq,H,D)."""
    if _build.route("flash_attention", q, k, v) == "cpu":
        return flash_attention_plain(q, k, v, causal, window, softcap, scale)
    _check("flash_attention", q, k, v)
    (q, qs), (k, ks), (v, vs) = _strided(q), _strided(k), _strided(v)
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    _build.launch(_lib, f"repro_flash_attention_{_build.DTYPES[q.dtype]}",
                  q.device, *map(_build.ptr, (q, k, v, out)), b, h, hkv, sq,
                  sk, d, *qs, *ks, *vs, int(bool(causal)),
                  -1 if window is None else int(window),
                  int(softcap is not None),
                  0.0 if softcap is None else float(softcap),
                  _scale(d, scale), what="flash_attention kernel",
                  count=(LAUNCHES, ("flash_attention",)),
                  work=("flash_attention", (q, k, v, causal, window), out))
    return out


def decode_attention(q, k, v, lengths, window=None, softcap=None,
                     scale=None):
    """Flash decode.  q:(B,1,H,D) k,v:(B,S,Hkv,D) lengths:(B,) -> (B,1,H,D)."""
    if _build.route("decode_attention", q, k, v, lengths) == "cpu":
        return decode_attention_plain(q, k, v, lengths, window, softcap,
                                      scale)
    _check("decode_attention", q, k, v)
    if q.shape[1] != 1 or tuple(lengths.shape) != (q.shape[0],):
        raise ValueError(f"decode_attention: q {tuple(q.shape)} must hold "
                         f"one query per row and lengths "
                         f"{tuple(lengths.shape)} one length per row")
    lengths = lengths.to(torch.int32).contiguous()
    (q, qs), (k, ks), (v, vs) = _strided(q), _strided(k), _strided(v)
    b, _, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    out = torch.empty((b, 1, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    splits, span = decode_plan(b, h, s, d)
    ws = torch.empty(b * h * splits * (d + 2), dtype=torch.float32,
                     device=q.device)
    _build.launch(_lib, f"repro_decode_attention_{_build.DTYPES[q.dtype]}",
                  q.device, *map(_build.ptr, (q, k, v, lengths, out, ws)), b,
                  h, hkv, 1, s, d, *qs, *ks, *vs,
                  -1 if window is None else int(window),
                  int(softcap is not None),
                  0.0 if softcap is None else float(softcap),
                  _scale(d, scale), splits, span,
                  what="decode_attention kernel",
                  count=(LAUNCHES, ("decode_attention",)),
                  work=("decode_attention", (q, k, v, lengths, window), out))
    return out


# Batch rows the backward recomputes at a time: the vector tier's chunked
# attention keeps each q chunk's fp32 (B, H, 512, Sk) logits and
# probabilities for autograd, about 8 GB a row at zamba2's 32 heads and
# 4096 positions
GRAD_ROWS = 1


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention through the kernel, with the gradient of the op's
    vector tier (``ops._attn_vector``: ``ref.attention``, chunked past
    2048 x 2048) recomputed from the saved q, k, v: the gradient the
    reference computes, which differentiates its vector tier.  The rows
    of the batch are recomputed ``GRAD_ROWS`` at a time."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        out = flash_attention(q, k, v, causal, window, softcap, scale)
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, window, softcap, scale)
        return out

    @staticmethod
    def backward(ctx, g):
        from .ops import _attn_vector
        grads = _autograd.vjp(
            lambda q, k, v: _attn_vector(q, k, v, *ctx.args),
            ctx.saved_tensors, g, ctx.needs_input_grad[:3],
            (True, True, True), GRAD_ROWS)
        return (*grads, None, None, None, None)


KERNELS = {"flash_attention": flash_attention,
           "decode_attention": decode_attention}
PLAIN = {"flash_attention": flash_attention_plain,
         "decode_attention": decode_attention_plain}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def supports(q, k, v, **kw) -> bool:
    """The reference's rule on (B,H,S,D) operands (4-D, H % Hkv == 0,
    or no heads), with the kernels' own limits: q, k, v of one dtype,
    float32 or bfloat16, one head dim of at most 256."""
    return (q.ndim == 4 and k.ndim == 4 and _grouped(q.shape[1], k.shape[1])
            and q.dtype in _build.DTYPES and k.dtype == q.dtype
            and v.dtype == q.dtype and q.shape[-1] == k.shape[-1]
            == v.shape[-1] and q.shape[-1] <= MAX_D)


def cost(q, k, v, *, causal=True, **kw) -> int:
    """The reference's kernel-structure count, on (B,H,S,D) operands."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    tgt = current_target()
    frac = 0.5 if causal and sq == sk else 1.0
    if tgt.has_mxu:
        mx = tgt.mxu
        qk = b * h * math.ceil(sq / mx) * math.ceil(sk / mx) * \
            math.ceil(d / mx)
        pv = b * h * math.ceil(sq / mx) * math.ceil(d / mx) * \
            math.ceil(sk / mx)
    else:                        # vfma ladder at VLA width
        vreg = tgt.vreg_elems(q.dtype)
        qk = pv = b * h * math.ceil(sq * sk * d / vreg)
    soft = 6 * b * h * math.ceil(sq * sk / tgt.vreg_elems(q.dtype))
    return int(frac * (qk + pv + soft))
