"""Customized lowerings: conv_hwc (direct conv) + dwconv (depthwise).

XNNPACK's NEON convhwc walks HWC pointers with 4-wide vfma ladders.  The
reference's TPU kernel holds a whole (H, W, Ci) image in VMEM and turns
the kh*kw taps into (oh*ow, Ci) x (Ci, Co) MXU products.  A whole image
does not fit the 227 KB of shared memory a Hopper block can use, so the
CUDA kernel (``csrc/conv.cu``) is an implicit GEMM instead: M = N*oh*ow
output pixels, N = Co, K = kh*kw*Ci walked tap by tap in 16-channel
slices, the im2col rows staged from x without ever being written.
dwconv has no contraction: one thread per output runs the reference
kernel's multiply-add chain over the taps in (i, j) order.

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
from . import _build, ref

LAUNCHES = {"conv_hwc": 0, "dwconv": 0}

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


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("conv")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    for dt in _build.DTYPES.values():
        fn = getattr(lib, f"repro_conv_hwc_{dt}")
        fn.restype = ctypes.c_int
        fn.argtypes = [p, p, p, p] + [i64] * 9 + [p]
        fn = getattr(lib, f"repro_dwconv_{dt}")
        fn.restype = ctypes.c_int
        fn.argtypes = [p, p, p, p] + [i64] * 6 + [p]
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
    oh, ow = (h - kh) // sh + 1, (iw - kw) // sw + 1
    x, w = x.contiguous(), w.contiguous()
    bias = None if bias is None else bias.contiguous()
    out = torch.empty((n, oh, ow, co), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    fn = getattr(_lib(), f"repro_conv_hwc_{_build.DTYPES[x.dtype]}")
    _build.launch(fn, x.device, x.data_ptr(), w.data_ptr(),
                  _build.ptr(bias), out.data_ptr(), n, h, iw, ci, kh, kw,
                  co, sh, sw, what="conv_hwc kernel")
    LAUNCHES["conv_hwc"] += 1
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
    fn = getattr(_lib(), f"repro_dwconv_{_build.DTYPES[x.dtype]}")
    _build.launch(fn, x.device, x.data_ptr(), w.data_ptr(),
                  _build.ptr(bias), out.data_ptr(), n, h, iw, c, kh, kw,
                  what="dwconv kernel")
    LAUNCHES["dwconv"] += 1
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
    sh, sw = stride
    oh, ow = (h - kh) // sh + 1, (iw - kw_) // sw + 1
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
