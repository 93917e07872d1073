"""Plain torch oracles — the paper's "original SIMDe" tier.

Each function is the straightforward whole-tensor translation a generic
portability layer produces: op-by-op, no fusion, fp32 math.  They serve
two roles:

  1. correctness oracle for the customized kernels,
  2. the *baseline* side of the paper's Figure-2 comparison (the
     registry's vector tier costs them by walking their aten graphs).

Layouts are the reference's: NHWC activations, HWIO conv weights,
(Kh, Kw, C) depthwise weights, (H, W, C) ibilinear images.  The torch
calls that want NCHW / OIHW get permuted views.

The cost walk must give the reference's numbers (``BENCH_xnnpack.json``)
from these graphs — equal numbers, not equal graphs.  Two oracles are
written so that their aten graphs hold the nodes jnp's lowering emits:

  * ``argmaxpool``: jnp lowers each strided window slice
    ``x[:, i::sh, j::sw]`` to a gather with its own index arithmetic
    (an iota, a multiply and an add per axis, and the concatenation of
    the index pair).  Torch strided slicing is a free view, so the
    oracle builds the same indices with ``arange``/``mul``/``add``/
    ``cat`` and gathers with them; the values are those of the slices.
  * ``ibilinear``: jnp's ``img[iy, ix]`` wraps negative indices (``lt``,
    ``add``, ``select_n`` per index array) and concatenates the index
    pair before its gather; ``aten.index`` does neither, so ``_take``
    writes them out.  Both are harmless to the result for in-range
    indices.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# 1. gemm — XNNPACK f32-gemm with minmax (bias + clamp) epilogue
# ---------------------------------------------------------------------------

def gemm(a, b, bias=None, clamp_min=float("-inf"), clamp_max=float("inf")):
    """C = clamp(A @ B + bias).  a:(M,K) b:(K,N) bias:(N,)."""
    out = a.to(torch.float32) @ b.to(torch.float32)
    if bias is not None:
        out = out + bias.to(torch.float32)
    # two-sided, as jnp.clip: max then min, a NaN passes through
    out = torch.clamp(out, clamp_min, clamp_max)
    return out.to(a.dtype)


# ---------------------------------------------------------------------------
# 2. conv_hwc — direct conv, NHWC input, HWIO weights, VALID padding
# ---------------------------------------------------------------------------

def conv_hwc(x, w, bias=None, stride=(1, 1)):
    """x:(N,H,W,Ci) w:(Kh,Kw,Ci,Co) -> (N,Ho,Wo,Co)."""
    out = F.conv2d(x.to(torch.float32).permute(0, 3, 1, 2),
                   w.to(torch.float32).permute(3, 2, 0, 1),
                   stride=tuple(stride)).permute(0, 2, 3, 1)
    # the bias is a separate add, as in the reference (not conv2d's own
    # bias): the unfused byte count reads and writes the output again
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# 3. dwconv — depthwise conv, per-channel kernels, VALID padding
# ---------------------------------------------------------------------------

def dwconv(x, w, bias=None, stride=(1, 1)):
    """x:(N,H,W,C) w:(Kh,Kw,C) -> (N,Ho,Wo,C)."""
    kh, kw, c = w.shape
    out = F.conv2d(x.to(torch.float32).permute(0, 3, 1, 2),
                   w.to(torch.float32).reshape(kh, kw, 1, c)
                   .permute(3, 2, 0, 1),
                   stride=tuple(stride), groups=c).permute(0, 2, 3, 1)
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# 4/5. maxpool / argmaxpool
# ---------------------------------------------------------------------------

def maxpool(x, window=(2, 2), stride=None):
    """x:(N,H,W,C), VALID padding; NaN propagates."""
    stride = stride or window
    return F.max_pool2d(x.permute(0, 3, 1, 2), tuple(window),
                        tuple(stride)).permute(0, 2, 3, 1)


def argmaxpool(x, window=(2, 2), stride=None):
    """Returns (max, flat-window-index-of-max).  x:(N,H,W,C)."""
    stride = stride or window
    n, h, w, c = x.shape
    kh, kw = window
    sh, sw = stride
    oh = (h - kh) // sh + 1
    ow = (w - kw) // sw + 1
    cols = []
    for i in range(kh):
        for j in range(kw):
            # the window slice x[:, i::sh, j::sw] as jnp gathers it
            rows = torch.arange(oh, dtype=torch.int32, device=x.device) \
                * sh + i
            cs = torch.arange(ow, dtype=torch.int32, device=x.device) \
                * sw + j
            idx = torch.cat([rows[:, None, None].expand(oh, ow, 1),
                             cs[None, :, None].expand(oh, ow, 1)], dim=-1)
            cols.append(x[:, idx[..., 0], idx[..., 1], :])
    stack = torch.stack(cols, dim=-1)         # (N,oh,ow,C,kh*kw)
    idx = torch.argmax(stack, dim=-1)
    mx = torch.amax(stack, dim=-1)
    return mx, idx.to(torch.int32)


# ---------------------------------------------------------------------------
# 6-9. elementwise: vrelu (clamp), vsqrt, vtanh, vsigmoid
# ---------------------------------------------------------------------------

def vrelu(x, clamp_min=0.0, clamp_max=float("inf")):
    """XNNPACK vrelu is a minmax clamp."""
    return torch.clamp(x, clamp_min, clamp_max)


def vsqrt(x):
    return torch.sqrt(x.to(torch.float32)).to(x.dtype)


def vtanh(x):
    return torch.tanh(x.to(torch.float32)).to(x.dtype)


def vsigmoid(x):
    return torch.sigmoid(x.to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# 10. ibilinear — bilinear interpolation with precomputed corners+weights
# ---------------------------------------------------------------------------

def _take(img, iy, ix):
    """``img[iy, ix]`` as jnp lowers it: negative indices wrap, the index
    pair is concatenated, then one gather."""
    h, w = img.shape[:2]
    iy = torch.where(iy < 0, iy + h, iy)
    ix = torch.where(ix < 0, ix + w, ix)
    idx = torch.cat([iy[:, None], ix[:, None]], dim=1)
    return img[idx[:, 0], idx[:, 1]]


def ibilinear(img, iy, ix, wy, wx):
    """XNNPACK-style ibilinear.

    img:(H,W,C); iy,ix:(P,) int32 top-left corner per output pixel;
    wy,wx:(P,) fractional weights.  Returns (P,C).
    """
    tl = _take(img, iy, ix).to(torch.float32)
    tr = _take(img, iy, ix + 1).to(torch.float32)
    bl = _take(img, iy + 1, ix).to(torch.float32)
    br = _take(img, iy + 1, ix + 1).to(torch.float32)
    wy = wy[:, None].to(torch.float32)
    wx = wx[:, None].to(torch.float32)
    top = tl * (1 - wx) + tr * wx
    bot = bl * (1 - wx) + br * wx
    return (top * (1 - wy) + bot * wy).to(img.dtype)
