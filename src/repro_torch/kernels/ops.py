"""Public kernel API — every op dispatches through the conversion ladder.

This is the framework's ``simde/arm/neon.h``: callers import these
functions; the registry picks the lowering tier exactly like SIMDe's
preprocessor ladder picks an implementation (DESIGN.md §3).

  policy 'pallas' (default with CUDA) — customized kernels (enhanced SIMDe)
  policy 'vector' (default without)   — whole-tensor torch (original SIMDe)
  policy 'generic'                    — scalar-emulation oracle tier

Each op runs on the device of its input tensor.  ``repro_torch.core.
use_policy`` overrides per scope.  All thirteen functions with a
customized kernel are registered here: the ten Figure-2 functions of
the paper and the three LM ops (attention, decode_attention, ssd) that
the serving path of ``repro_torch.models`` calls.
"""
from __future__ import annotations

import torch

from ..core import registry, trace
from ..core.registry import dispatch, register
from . import conv as _conv
from . import elementwise as _ew
from . import flash_attention as _fa
from . import gemm as _gemm
from . import ibilinear as _ib
from . import pooling as _pool
from . import ref
from . import ssd as _ssd


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


# ---------------------------------------------------------------------------
# attention (model-facing layout (B, S, H, D))
#
# ``dispatch`` passes every argument positionally, so the cost and
# supports functions take them positionally too (the reference's lambdas
# do not, and its registry never ranks the kernel tier: ROADMAP C.7).
# The kernel tier's cost is the reference kernel's, on (B, H, S, D) views.
# ---------------------------------------------------------------------------

def _bhsd(t):
    return t.transpose(1, 2)


def _attn_vector(q, k, v, causal=True, window=None, softcap=None, scale=None):
    if q.shape[1] * k.shape[1] > 2048 * 2048:
        return ref.attention_chunked(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale)
    return ref.attention(q, k, v, causal=causal, window=window,
                         softcap=softcap, scale=scale)


register("attention", "vector", cost=trace.traced_cost(_attn_vector),
         doc="attention; chunked online-softmax beyond 2k seq")(_attn_vector)


def _attn_supports(q, k, v, causal=True, window=None, softcap=None,
                   scale=None):
    # the fused kernel requires equal q/v head dims (MLA's split dims fall
    # back to the vector tier — the paper's validity-predicate pattern)
    return (q.shape[-1] == v.shape[-1] and
            _fa.supports(_bhsd(q), _bhsd(k), _bhsd(v)))


def _attn_cost(q, k, v, causal=True, *_, **__):
    return _fa.cost(_bhsd(q), _bhsd(k), _bhsd(v), causal=causal)


@register("attention", "pallas", supports=_attn_supports, cost=_attn_cost,
          doc="online-softmax flash attention, register-resident stats")
def _attn_pallas(q, k, v, causal=True, window=None, softcap=None, scale=None):
    return _fa.flash_attention(q, k, v, causal, window, softcap, scale)


def attention(q, k, v, *, causal=True, window=None, softcap=None, scale=None,
              policy=None, target=None):
    """q:(B,Sq,H,D) k,v:(B,Sk,Hkv,D) -> (B,Sq,H,D).

    ``target`` selects the lowering against an explicit machine model;
    None uses the ambient thread-scoped target.
    """
    return dispatch("attention", q, k, v, causal, window, softcap, scale,
                    policy=policy, target=target)


def _dec_attn_vector(q, k, v, lengths, window=None, softcap=None, scale=None):
    # q:(B,1,H,D); mask cache positions >= per-row valid length
    return ref.decode_attention(q, k, v, lengths, window, softcap, scale)


register("decode_attention", "vector",
         cost=trace.traced_cost(_dec_attn_vector))(_dec_attn_vector)


def _dec_supports(q, k, v, lengths, *_, **__):
    return q.shape[1] == 1 and _fa.supports(_bhsd(q), _bhsd(k), _bhsd(v))


def _dec_cost(q, k, v, lengths, *_, **__):
    return _fa.cost(_bhsd(q), _bhsd(k), _bhsd(v), causal=False)


@register("decode_attention", "pallas", supports=_dec_supports,
          cost=_dec_cost,
          doc="flash-decode, valid length read on the device")
def _dec_attn_pallas(q, k, v, lengths, window=None, softcap=None, scale=None):
    return _fa.decode_attention(q, k, v, lengths, window, softcap, scale)


def decode_attention(q, k, v, lengths, *, window=None, softcap=None,
                     scale=None, policy=None, target=None):
    """q:(B,1,H,D) k,v:(B,S,Hkv,D) lengths:(B,) -> (B,1,H,D)."""
    return dispatch("decode_attention", q, k, v, lengths, window, softcap,
                    scale, policy=policy, target=target)


# ---------------------------------------------------------------------------
# ssd (Mamba2)
# ---------------------------------------------------------------------------

def _ssd_vector(x, dt, A, B, C, D=None, *, chunk=128):
    if x.shape[1] > 256:
        return ref.ssd_chunked(x, dt, A, B, C, D, chunk=chunk)
    return ref.ssd(x, dt, A, B, C, D)


register("ssd", "vector", cost=trace.traced_cost(_ssd_vector),
         doc="chunked torch SSD (sequential scan below 256 steps)")(_ssd_vector)


@register("ssd", "pallas", cost=_ssd.cost, supports=_ssd.supports,
          doc="chunk-parallel SSD, start states chained in chunk order")
def _ssd_pallas(x, dt, A, B, C, D=None, *, chunk=128):
    return _ssd.ssd(x, dt, A, B, C, D, chunk)


def ssd(x, dt, A, B, C, D=None, *, chunk=128, policy=None, target=None):
    """x:(b,s,h,p) dt:(b,s,h) A:(h,) B,C:(b,s,g,n) -> (b,s,h,p).

    As in the reference, ``chunk`` is not passed on: both tiers run at
    their default of 128 (ROADMAP C.8)."""
    return dispatch("ssd", x, dt, A, B, C, D, policy=policy, target=target)


# default policy: customized kernels where CUDA is present, the vector
# tier elsewhere (the same "native if available" rule as SIMDe's ladder).
registry.REGISTRY.set_default_policy(default_policy())
