"""The work of each kernel's function, and the card's least time for it.

One home for what ``chip_smoke.py``'s bound column and the stand-in
launches of :func:`_build.launch` (the dry run's kernel counts) read:
:func:`work` gives the (bytes, operations) a call of a kernel's function
must move and do on these inputs, each input read once and each output
written once; :func:`bound` turns them into the least time the H100 SXM
could take (its data sheet's rates at 700 W), the larger of the bytes
over the memory rate and the operations over the peak rate of the unit
that runs them (:func:`rate`).

Operations, by op:

  * gemm: 2MNK, plus MN for the bias add and 2MN for a clamp with a
    finite bound;
  * conv_hwc: (2 kh kw Ci + 1) an output; dwconv (2 kh kw + 1);
  * maxpool: kh kw - 1 comparisons an output, argmaxpool kh kw;
  * ibilinear: 12 an output (3 subtractions, 6 products, 3 sums);
  * the elementwise four: the fp32 vector instructions of their plain
    math under the ``h100`` target (``core.trace``), times the lanes;
  * flash_attention: 4 D a visible (query, key) pair an (batch, head);
    decode_attention: 4 D a valid key a head, and of the cache only the
    valid keys are read;
  * ssd: two a multiply-add of its chunk products (chunks of
    min(128, S rounded up to 8)), three times that in float32 (each
    product as three bf16 products of split terms, ``csrc/ssd.cu``).

Where the work depends on the data (decode's valid lengths), the data
is read; a stand-in tensor (``_build.stand_in``) has none, and then the
whole cache is counted, which is the dry run's decode cell.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

# H100 SXM data sheet (700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12          # fp32 outside the tensor cores
BF16_MMA_PER_S = 989e12         # dense bf16 tensor cores
# the ops whose products run on the tensor cores in bf16 (ssd in both
# dtypes)
MMA_OPS = ("gemm", "conv_hwc", "flash_attention", "decode_attention")
EW_OPS = ("vtanh", "vsigmoid", "vsqrt", "vrelu")


def nbytes(*tensors) -> int:
    """Bytes of the tensors among ``tensors`` (others skipped)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def _has_data(t) -> bool:
    from ._build import stand_in
    return not stand_in(t)


@functools.lru_cache(maxsize=256)
def _ew_ops(op, shape, scalars):
    from ..core import trace, use_target
    from . import elementwise as ew
    fn = {"vtanh": ew.vtanh_math, "vsigmoid": ew.vsigmoid_math,
          "vsqrt": ew.vsqrt_math,
          "vrelu": lambda x: ew.vrelu_math(x, *scalars)}[op]
    with use_target("h100"):
        f32 = torch.empty(shape, device="meta")
        return trace.fx_vector_instrs(fn, f32) * trace.vreg_for(f32.dtype)


def visible_pairs(sq, sk, causal, window) -> int:
    """(query, key) pairs attention reads: query i sits at key position
    i + sk - sq, sees keys at or before it where ``causal`` and fewer
    than ``window`` behind it where one is given."""
    pos = np.arange(sq, dtype=np.int64) + (sk - sq)
    hi = np.minimum(pos, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(pos - window + 1, 0) if window is not None \
        else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _flash(q, k, v, causal=True, window=None, *_, out):
    b, sq, h, d = q.shape
    return (nbytes(q, k, v, out),
            4 * b * h * visible_pairs(sq, k.shape[1], causal, window) * d)


def _decode(q, k, v, lengths, window=None, *_, out):
    b, _, h, d = q.shape
    slots, hkv = k.shape[1], k.shape[2]
    if _has_data(lengths):
        hi = lengths.detach().to("cpu", torch.int64).clamp(0, slots)
        lo = (hi - window).clamp(min=0) if window is not None else 0 * hi
        keys = int((hi - lo).sum())
    else:
        keys = b * (min(window, slots) if window is not None else slots)
    return (nbytes(q, lengths, out) + 2 * keys * hkv * d * k.element_size(),
            4 * h * d * keys)


def _ssd(x, dt, A, B, C, D=None, *_, out):
    b, s, h, p = x.shape
    n = B.shape[-1]
    L = min(128, -(-s // 8) * 8)
    macs = b * h * math.ceil(s / L) * (L * (L + 1) // 2 * (n + p)
                                       + 2 * L * p * n)
    products = 1 if x.dtype == torch.bfloat16 else 3
    return nbytes(x, dt, A, B, C, D, out), 2 * macs * products


def _gemm(a, b, bias=None, clamp_min=-math.inf, clamp_max=math.inf, *_,
          out):
    (m, k), n = a.shape, b.shape[1]
    ops = 2 * m * n * k + (m * n if bias is not None else 0)
    if math.isfinite(clamp_min) or math.isfinite(clamp_max):
        ops += 2 * m * n
    return nbytes(a, b, bias, out), ops


def work(op, args, out):
    """(bytes, operations) a call ``op(*args)`` giving ``out`` (a tensor
    or a tuple of them) must move and do."""
    outs = out if isinstance(out, tuple) else (out,)
    if op == "gemm":
        return _gemm(*args, out=outs[0])
    if op == "flash_attention":
        return _flash(*args, out=outs[0])
    if op == "decode_attention":
        return _decode(*args, out=outs[0])
    if op == "ssd":
        return _ssd(*args, out=outs[0])
    total = nbytes(*args, *outs)
    y = outs[0].numel()
    if op in EW_OPS:
        scalars = tuple(float(a) for a in args[1:])
        return total, _ew_ops(op, tuple(args[0].shape), scalars)
    if op == "conv_hwc":
        kh, kw, ci, _ = args[1].shape
        return total, y * (2 * kh * kw * ci + 1)
    if op == "dwconv":
        kh, kw, _ = args[1].shape
        return total, y * (2 * kh * kw + 1)
    if op in ("maxpool", "argmaxpool"):
        kh, kw = args[1]
        return total, y * (kh * kw - (op == "maxpool"))
    if op == "ibilinear":
        return total, 12 * y
    raise ValueError(f"no work model for {op!r}")


def rate(op, dtype) -> float:
    """Peak operations a second of the unit that runs ``op`` in
    ``dtype``: the bf16 tensor cores for the products of gemm, conv_hwc
    and attention in bf16, and of ssd in both dtypes; else fp32."""
    if op == "ssd" or (op in MMA_OPS and dtype == torch.bfloat16):
        return BF16_MMA_PER_S
    return FP32_OPS_PER_S


def bound_ms(n_bytes, n_ops, ops_per_s=FP32_OPS_PER_S):
    """(ms, "bytes" or "operations"): the larger of the bytes at the HBM
    rate and the operations at ``ops_per_s``."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / ops_per_s * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms \
        else "operations"


def bound(op, args, out):
    """(bound ms, by, bytes, operations) of ``op(*args)`` giving ``out``
    on the card."""
    n_bytes, n_ops = work(op, args, out)
    ms, by = bound_ms(n_bytes, n_ops, rate(op, args[0].dtype))
    return ms, by, n_bytes, n_ops
