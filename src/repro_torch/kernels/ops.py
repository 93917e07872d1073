"""Public kernel API — every op dispatches through the conversion ladder.

This is the framework's ``simde/arm/neon.h``: callers import these
functions; the registry picks the lowering tier exactly like SIMDe's
preprocessor ladder picks an implementation (DESIGN.md §3).

  policy 'pallas' (default with CUDA) — customized kernels (enhanced SIMDe)
  policy 'vector' (default without)   — whole-tensor torch (original SIMDe)
  policy 'generic'                    — scalar-emulation oracle tier

Each op runs on the device of its input tensor.  ``repro_torch.core.
use_policy`` overrides per scope.  The ten Figure-2 functions of the
paper are registered here; the LM ops (attention, decode_attention,
ssd) arrive with their kernels.
"""
from __future__ import annotations

import torch

from ..core import registry, trace
from ..core.registry import dispatch, register
from . import conv as _conv
from . import elementwise as _ew
from . import gemm as _gemm
from . import ibilinear as _ib
from . import pooling as _pool
from . import ref


def default_policy() -> str:
    return "pallas" if torch.cuda.is_available() else "vector"


# ---------------------------------------------------------------------------
# Cost models.  The generic tier counts the scalar loop's element ops;
# the vector tier *analyzes its own generated code* against the active
# target (trace.traced_cost — the paper's §4 methodology), including the
# original-SIMDe union round-trip and target-dependent scalarization of
# transcendentals; the customized tier declares its kernel-structure
# count.  registry.select compares these per (op, shape, target) and
# picks the cheapest.
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# gemm
# ---------------------------------------------------------------------------

def _gemm_scalar_cost(a, b, *_, **__):
    m, k = a.shape
    return 2 * m * k * b.shape[1]


register("gemm", "generic", cost=_gemm_scalar_cost,
         doc="scalar MAC loop emulation")(ref.gemm)
register("gemm", "vector", cost=trace.traced_cost(ref.gemm),
         doc="torch matmul (vector-attribute tier)")(ref.gemm)


@register("gemm", "pallas", cost=_gemm.cost, supports=_gemm.supports,
          doc="register-tiled fused bias+clamp GEMM")
def _gemm_pallas(a, b, bias=None, clamp_min=float("-inf"),
                 clamp_max=float("inf")):
    return _gemm.gemm(a, b, bias, clamp_min, clamp_max)


def gemm(a, b, bias=None, clamp_min=float("-inf"), clamp_max=float("inf"),
         *, policy=None, target=None):
    return dispatch("gemm", a, b, bias, clamp_min, clamp_max, policy=policy,
                    target=target)


# ---------------------------------------------------------------------------
# convolutions
# ---------------------------------------------------------------------------

def _conv_scalar_cost(x, w, bias=None, stride=(1, 1), **_):
    n, h, iw, ci = x.shape
    kh, kw_, _, co = w.shape
    sh, sw = stride
    oh, ow = (h - kh) // sh + 1, (iw - kw_) // sw + 1
    return 2 * n * oh * ow * co * kh * kw_ * ci


register("conv_hwc", "generic", cost=_conv_scalar_cost)(ref.conv_hwc)
register("conv_hwc", "vector",
         cost=trace.traced_cost(ref.conv_hwc))(ref.conv_hwc)


@register("conv_hwc", "pallas", cost=_conv.cost_conv,
          supports=_conv.supports_conv, doc="implicit-GEMM direct conv")
def _conv_pallas(x, w, bias=None, stride=(1, 1)):
    return _conv.conv_hwc(x, w, bias, stride)


def conv_hwc(x, w, bias=None, stride=(1, 1), *, policy=None):
    return dispatch("conv_hwc", x, w, bias, stride, policy=policy)


def _dwconv_scalar_cost(x, w, bias=None, stride=(1, 1), **_):
    n, h, iw, c = x.shape
    kh, kw_, _ = w.shape
    sh, sw = stride
    oh, ow = (h - kh) // sh + 1, (iw - kw_) // sw + 1
    return 2 * n * oh * ow * c * kh * kw_


register("dwconv", "generic", cost=_dwconv_scalar_cost)(ref.dwconv)
register("dwconv", "vector", cost=trace.traced_cost(ref.dwconv))(ref.dwconv)


@register("dwconv", "pallas", cost=_conv.cost_dwconv,
          supports=_conv.supports_dwconv, doc="vfma-chain depthwise conv")
def _dwconv_pallas(x, w, bias=None, stride=(1, 1)):
    return _conv.dwconv(x, w, bias)


def dwconv(x, w, bias=None, stride=(1, 1), *, policy=None):
    return dispatch("dwconv", x, w, bias, stride, policy=policy)


# ---------------------------------------------------------------------------
# pooling
# ---------------------------------------------------------------------------

def _pool_scalar_cost(mult):
    def cost(x, window=(2, 2), stride=None, **_):
        return mult * x.numel()  # one compare/update per input element
    return cost


register("maxpool", "generic", cost=_pool_scalar_cost(1))(ref.maxpool)
register("maxpool", "vector",
         cost=trace.traced_cost(ref.maxpool))(ref.maxpool)


@register("maxpool", "pallas", cost=_pool.cost_maxpool,
          supports=_pool.supports, doc="one-thread-per-output vmax pooling")
def _maxpool_pallas(x, window=(2, 2), stride=None):
    return _pool.maxpool(x, window)


def maxpool(x, window=(2, 2), stride=None, *, policy=None):
    return dispatch("maxpool", x, window, stride, policy=policy)


register("argmaxpool", "generic", cost=_pool_scalar_cost(2))(ref.argmaxpool)
register("argmaxpool", "vector",
         cost=trace.traced_cost(ref.argmaxpool))(ref.argmaxpool)


@register("argmaxpool", "pallas", cost=_pool.cost_argmaxpool,
          supports=_pool.supports, doc="select-ladder argmax pooling")
def _argmaxpool_pallas(x, window=(2, 2), stride=None):
    return _pool.argmaxpool(x, window)


def argmaxpool(x, window=(2, 2), stride=None, *, policy=None):
    return dispatch("argmaxpool", x, window, stride, policy=policy)


# ---------------------------------------------------------------------------
# elementwise
# ---------------------------------------------------------------------------

register("vrelu", "generic", cost=trace.scalar_cost(2))(ref.vrelu)
register("vrelu", "vector", cost=trace.traced_cost(ref.vrelu))(ref.vrelu)


@register("vrelu", "pallas", cost=_ew.cost_vrelu, supports=_ew.supports,
          doc="fused minmax clamp")
def _vrelu_pallas(x, clamp_min=0.0, clamp_max=float("inf")):
    return _ew.vrelu(x, clamp_min, clamp_max)


def vrelu(x, clamp_min=0.0, clamp_max=float("inf"), *, policy=None):
    return dispatch("vrelu", x, clamp_min, clamp_max, policy=policy)


# For the transcendentals the vector tier's true cost is target-dependent:
# with no vector libm (the baseline RVV toolchain) the call scalarizes —
# the paper's Figure-2 story.  traced_cost(transcendental=True) models
# exactly that via targets.Target.has_vector_libm.
register("vsqrt", "generic",
         cost=trace.scalar_cost(trace.PRIM_SCALAR_COST["sqrt"]))(ref.vsqrt)
register("vsqrt", "vector",
         cost=trace.traced_cost(ref.vsqrt, transcendental=True))(ref.vsqrt)


@register("vsqrt", "pallas", cost=_ew.cost_vsqrt, supports=_ew.supports,
          doc="rsqrt seed + Newton ladder")
def _vsqrt_pallas(x):
    return _ew.vsqrt(x)


def vsqrt(x, *, policy=None):
    return dispatch("vsqrt", x, policy=policy)


register("vtanh", "generic",
         cost=trace.scalar_cost(trace.PRIM_SCALAR_COST["tanh"]))(ref.vtanh)
register("vtanh", "vector",
         cost=trace.traced_cost(ref.vtanh, transcendental=True))(ref.vtanh)


@register("vtanh", "pallas", cost=_ew.cost_vtanh, supports=_ew.supports,
          doc="exp2 range-reduction rational tanh")
def _vtanh_pallas(x):
    return _ew.vtanh(x)


def vtanh(x, *, policy=None):
    return dispatch("vtanh", x, policy=policy)


register("vsigmoid", "generic",
         cost=trace.scalar_cost(
             trace.PRIM_SCALAR_COST["logistic"]))(ref.vsigmoid)
register("vsigmoid", "vector",
         cost=trace.traced_cost(ref.vsigmoid,
                                transcendental=True))(ref.vsigmoid)


@register("vsigmoid", "pallas", cost=_ew.cost_vsigmoid, supports=_ew.supports,
          doc="exp2 reduction + reciprocal Newton sigmoid")
def _vsigmoid_pallas(x):
    return _ew.vsigmoid(x)


def vsigmoid(x, *, policy=None):
    return dispatch("vsigmoid", x, policy=policy)


# ---------------------------------------------------------------------------
# ibilinear
# ---------------------------------------------------------------------------

def _ibilinear_scalar_cost(img, iy, ix, wy, wx, **_):
    # per output element: 4 gathered loads + 8 mul/add
    return 12 * iy.shape[0] * img.shape[-1]


register("ibilinear", "generic", cost=_ibilinear_scalar_cost)(ref.ibilinear)
register("ibilinear", "vector",
         cost=trace.traced_cost(ref.ibilinear))(ref.ibilinear)


@register("ibilinear", "pallas", cost=_ib.cost, supports=_ib.supports,
          doc="channel-per-thread corner loads, fp32 bilinear blend")
def _ibilinear_pallas(img, iy, ix, wy, wx):
    return _ib.ibilinear(img, iy, ix, wy, wx)


def ibilinear(img, iy, ix, wy, wx, *, policy=None):
    return dispatch("ibilinear", img, iy, ix, wy, wx, policy=policy)


# default policy: customized kernels where CUDA is present, the vector
# tier elsewhere (the same "native if available" rule as SIMDe's ladder).
registry.REGISTRY.set_default_policy(default_policy())
