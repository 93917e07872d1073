"""Public kernel API — every op dispatches through the conversion ladder.

This is the framework's ``simde/arm/neon.h``: callers import these
functions; the registry picks the lowering tier exactly like SIMDe's
preprocessor ladder picks an implementation (DESIGN.md §3).

  policy 'pallas' (default with CUDA) — customized kernels (enhanced SIMDe)
  policy 'vector' (default without)   — whole-tensor torch (original SIMDe)
  policy 'generic'                    — scalar-emulation oracle tier

Each op runs on the device of its input tensor.  ``repro_torch.core.
use_policy`` overrides per scope.  The elementwise four are registered
here; the other ops arrive with their kernels.
"""
from __future__ import annotations

import torch

from ..core import registry, trace
from ..core.registry import dispatch, register
from . import elementwise as _ew
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


# default policy: customized kernels where CUDA is present, the vector
# tier elsewhere (the same "native if available" rule as SIMDe's ladder).
registry.REGISTRY.set_default_policy(default_policy())
