"""Customized lowerings: conv_hwc (direct conv) + dwconv (depthwise).

XNNPACK's NEON convhwc walks HWC pointers with 4-wide vfma ladders.  The
reference's TPU kernel holds a whole (H, W, Ci) image in VMEM and turns
the kh*kw taps into (oh*ow, Ci) x (Ci, Co) MXU products.  A whole image
does not fit the 227 KB of shared memory a Hopper block can use, so the
CUDA kernel (``csrc/conv.cu``) is an implicit GEMM instead: M = N*oh*ow
output pixels, N = Co, K = kh*kw*Ci, on the fp32 SIMT product that gemm's
fp32 variant runs (``csrc/simt_mm.cuh``), with tile and K slices from
:func:`conv_plan` (``gemm.simt_plan`` of those three) and A read as the
im2col rows of x, never written: :func:`im2col_offsets` is the decode the
kernel does.  dwconv has no contraction: a thread runs the reference
kernel's multiply-add chain over the taps in (i, j) order for 4
channels (one vector) along a run of output columns
(:func:`dwconv_plan`), so its loads and stores are vectors and each input
column is loaded once per output row.

Layouts are the reference's: x NHWC (N, H, W, Ci), conv weights HWIO
(Kh, Kw, Ci, Co), depthwise weights (Kh, Kw, C), bias (Co,); VALID
padding; the output has x's dtype.  Only the plain versions permute to
NCHW / OIHW for their torch calls.

Each op has a plain version (``*_plain``), a wrapper that launches the
kernel for CUDA tensors (counted in ``LAUNCHES``) and runs the plain
version for CPU tensors, and the cost model and validity predicate the
registry uses.  ``supports_*`` keeps the reference's rule that the image
slab fit the scratch budget on the targets that have one (tpu-*), since
the committed Figure-2 rows depend on it; on a ``cuda``-kind target the
kernel streams from global memory and only its own limits apply.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..core import trace
from ..core.vtypes import vmem_fit
from . import _build, gemm, ref

LAUNCHES = {"conv_hwc": 0, "dwconv": 0}
# dwconv's launch shape: channels a thread takes on its vector path,
# threads a block, the output columns a thread may take (largest first),
# and the blocks to put in flight before it takes fewer (one per SM of
# the H100's 132)
DW_LANES = 4
DW_THREADS = 256
DW_RUNS = (8, 4, 2, 1)
DW_BLOCKS = 132

# The plain conv is the oracle's own steps: one fp32 convolution, then
# the bias add, rounded once to x's dtype.
conv_hwc_plain = ref.conv_hwc


def dwconv_plain(x, w, bias=None):
    """The TPU kernel's tap chain in fp32 torch ops: acc = 0, then
    acc = acc + x_tap * w[i, j] for each tap in (i, j) order, then the
    bias, rounded once to x's dtype.  Stride 1, VALID."""
    kh, kw, c = w.shape
    n, h, iw, _ = x.shape
    oh, ow = h - kh + 1, iw - kw + 1
    xf, wf = x.to(torch.float32), w.to(torch.float32)
    acc = torch.zeros((n, oh, ow, c), dtype=torch.float32, device=x.device)
    for i in range(kh):
        for j in range(kw):
            acc = acc + xf[:, i:i + oh, j:j + ow, :] * wf[i, j]
    if bias is not None:
        acc = acc + bias.to(torch.float32)
    return acc.to(x.dtype)


def out_hw(h, w, kh, kw, stride=(1, 1)):
    """(oh, ow) of a VALID conv."""
    return (h - kh) // stride[0] + 1, (w - kw) // stride[1] + 1


def conv_plan(x_shape, w_shape, stride=(1, 1)) -> tuple:
    """(bm, bn, splits, ks) of conv_hwc's kernel: ``gemm.simt_plan`` of
    the implicit GEMM, M = N*oh*ow pixels, N = Co, K = kh*kw*Ci."""
    n, h, w, ci = x_shape
    kh, kw, _, co = w_shape
    oh, ow = out_hw(h, w, kh, kw, stride)
    return gemm.simt_plan(n * oh * ow, co, kh * kw * ci)


def im2col_offsets(x_shape, w_shape, stride=(1, 1)):
    """The kernel's decode of A = im2col(x), as element offsets into the
    contiguous x: A[r, kc] = x.flatten()[rows[r] + cols[kc]].  Row r is
    output pixel (img, oy, ox) and starts at its window origin; column kc
    = (i*kw + j)*Ci + c is tap (i, j), channel c, which lies
    (kc // (kw*Ci)) * W*Ci + kc % (kw*Ci) past it (a row of kw taps is
    one contiguous run of x).  Returns two int64 tensors (M,), (K,)."""
    n, h, w, ci = x_shape
    kh, kw, _, _ = w_shape
    oh, ow = out_hw(h, w, kh, kw, stride)
    g = torch.arange(n * oh * ow, dtype=torch.int64)
    ox, oy, img = g % ow, g // ow % oh, g // (ow * oh)
    rows = ((img * h + oy * stride[0]) * w + ox * stride[1]) * ci
    kc = torch.arange(kh * kw * ci, dtype=torch.int64)
    run = kw * ci
    return rows, kc // run * (w * ci) + kc % run


def dwconv_plan(x_shape, w_shape, vector: bool) -> dict:
    """dwconv's launch shape.  ``vector``: a thread takes ``DW_LANES``
    channels (:func:`dwconv_vector`), else one.  A block takes ``group``
    channel vectors (the next power of two, up to 32) by ``DW_THREADS //
    group`` tasks; a task is ``run`` output columns of one output row,
    the largest of ``DW_RUNS`` that still gives ``DW_BLOCKS`` blocks (or
    1)."""
    n, h, w, c = x_shape
    kh, kw, _ = w_shape
    oh, ow = out_hw(h, w, kh, kw)
    lanes = DW_LANES if vector else 1
    nv = c // lanes
    group = min(32, 1 << (nv - 1).bit_length())
    rows = DW_THREADS // group
    gy = -(-nv // group)
    for run in DW_RUNS:
        gx = -(-(n * oh * -(-ow // run)) // rows)
        if gx * gy >= DW_BLOCKS:
            break
    return {"vector": vector, "lanes": lanes, "group": group, "run": run,
            "block": [group, rows], "grid": [gx, gy], "blocks": gx * gy}


def dwconv_vector(x, w, bias=None) -> bool:
    """Whether dwconv's kernel takes 4 channels a thread (one 16-byte fp32
    or 8-byte bf16 vector) for these operands: C a multiple of 4 and
    every operand aligned to the vector (the output, made by
    ``torch.empty``, always is)."""
    size = DW_LANES * x.element_size()
    return x.shape[-1] % DW_LANES == 0 and all(
        t is None or _build.ptr(t) % size == 0 for t in (x, w, bias))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("conv")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    for dt in _build.DTYPES.values():
        fn = getattr(lib, f"repro_conv_hwc_{dt}")
        fn.restype = ctypes.c_int
        fn.argtypes = [p] * 5 + [i64] * 13 + [p]
        fn = getattr(lib, f"repro_dwconv_{dt}")
        fn.restype = ctypes.c_int
        fn.argtypes = [p] * 4 + [i64] * 9 + [p]
    return lib


def _takes(x, w, bias) -> bool:
    return x.dtype in _build.DTYPES and w.dtype == x.dtype and (
        bias is None or bias.dtype == x.dtype)


def _check(op, x, w, bias, w_ndim, c_out, window):
    """Raise unless the kernel takes these operands."""
    if not _takes(x, w, bias):
        raise TypeError(f"{op}: kernel takes float32 or bfloat16 operands "
                        f"of one dtype, not {x.dtype}/{w.dtype}/"
                        f"{None if bias is None else bias.dtype}")
    if x.ndim != 4 or w.ndim != w_ndim or w.shape[2] != x.shape[3] or (
            bias is not None and tuple(bias.shape) != (c_out,)) or \
            window[0] > x.shape[1] or window[1] > x.shape[2]:
        raise ValueError(f"{op}: shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, bias "
                         f"{None if bias is None else tuple(bias.shape)}")


def conv_hwc(x, w, bias=None, stride=(1, 1)):
    """x:(N,H,W,Ci) w:(Kh,Kw,Ci,Co), VALID padding, any stride."""
    if _build.route("conv_hwc", x, w, bias) == "cpu":
        return conv_hwc_plain(x, w, bias, stride)
    kh, kw, _, co = w.shape
    _check("conv_hwc", x, w, bias, 4, co, (kh, kw))
    sh, sw = stride
    if sh < 1 or sw < 1:
        raise ValueError(f"conv_hwc: stride {stride}")
    n, h, iw, ci = x.shape
    oh, ow = out_hw(h, iw, kh, kw, stride)
    x, w = x.contiguous(), w.contiguous()
    bias = None if bias is None else bias.contiguous()
    out = torch.empty((n, oh, ow, co), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    bm, bn, splits, ks = conv_plan(x.shape, w.shape, stride)
    ws = None if splits == 1 else torch.empty(
        (splits, n * oh * ow, co), dtype=torch.float32, device=x.device)
    _build.launch(_lib, f"repro_conv_hwc_{_build.DTYPES[x.dtype]}",
                  x.device, _build.ptr(x), _build.ptr(w), _build.ptr(bias),
                  _build.ptr(out), _build.ptr(ws), n, h, iw, ci, kh, kw, co,
                  sh, sw, bm, bn, splits, ks, what="conv_hwc kernel",
                  count=(LAUNCHES, ("conv_hwc",)),
                  work=("conv_hwc", (x, w, bias), out))
    return out


def dwconv(x, w, bias=None):
    """Depthwise conv, stride 1, VALID.  x:(N,H,W,C) w:(Kh,Kw,C)."""
    if _build.route("dwconv", x, w, bias) == "cpu":
        return dwconv_plain(x, w, bias)
    kh, kw, c = w.shape
    _check("dwconv", x, w, bias, 3, c, (kh, kw))
    n, h, iw, _ = x.shape
    x, w = x.contiguous(), w.contiguous()
    bias = None if bias is None else bias.contiguous()
    out = torch.empty((n, h - kh + 1, iw - kw + 1, c), dtype=x.dtype,
                      device=x.device)
    if out.numel() == 0:
        return out
    plan = dwconv_plan(x.shape, w.shape, dwconv_vector(x, w, bias))
    _build.launch(_lib, f"repro_dwconv_{_build.DTYPES[x.dtype]}", x.device,
                  _build.ptr(x), _build.ptr(w), _build.ptr(bias),
                  _build.ptr(out), n, h, iw, c, kh, kw, int(plan["vector"]),
                  plan["group"], plan["run"], what="dwconv kernel",
                  count=(LAUNCHES, ("dwconv",)),
                  work=("dwconv", (x, w, bias), out))
    return out


KERNELS = {"conv_hwc": conv_hwc, "dwconv": dwconv}
PLAIN = {"conv_hwc": conv_hwc_plain, "dwconv": dwconv_plain}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _streams() -> bool:
    """The kernels stream from global memory on a CUDA target: no slab
    has to fit a scratch budget there."""
    return trace.current_target().kind == "cuda"


def supports_conv(x, w, bias=None, stride=(1, 1), **kw) -> bool:
    if x.ndim != 4 or w.ndim != 4 or not _takes(x, w, bias):
        return False
    if _streams():
        return True
    n, h, iw, ci = x.shape
    co = w.shape[-1]
    # slab + weights + fp32 accumulator must fit the scratch budget
    return vmem_fit([(h * iw * ci, x.dtype), (w.numel(), w.dtype),
                     (h * iw * co, torch.float32)])


def supports_dwconv(x, w, bias=None, stride=(1, 1), **kw) -> bool:
    if x.ndim != 4 or w.ndim != 3 or tuple(stride) != (1, 1) or \
            not _takes(x, w, bias):
        return False
    if _streams():
        return True
    n, h, iw, c = x.shape
    return vmem_fit([(h * iw * c, x.dtype), (h * iw * c, torch.float32)])


def cost_conv(x, w, bias=None, stride=(1, 1), **_) -> int:
    n, h, iw, ci = x.shape
    kh, kw_, _, co = w.shape
    oh, ow = out_hw(h, iw, kh, kw_, stride)
    tgt = trace.current_target()
    if tgt.mxu >= 8:
        return kh * kw_ * n * math.ceil(oh * ow / tgt.mxu) * \
            math.ceil(co / tgt.mxu) * math.ceil(ci / tgt.mxu)
    vreg = trace.vreg_for(x.dtype)
    return math.ceil(kh * kw_ * n * oh * ow * co * ci / vreg)


def cost_dwconv(x, w, bias=None, stride=(1, 1), **_) -> int:
    # takes the stride that ops.dwconv passes, unlike the reference's
    # model, which raises on it (ROADMAP C.4); the count is the same
    n, h, iw, c = x.shape
    kh, kw_, _ = w.shape
    oh, ow = h - kh + 1, iw - kw_ + 1
    return kh * kw_ * math.ceil(n * oh * ow * c / trace.vreg_for(x.dtype))
