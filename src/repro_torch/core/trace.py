"""Dynamic vector-instruction counting — the Spike-simulator analogue.

The paper measures on Spike, a *functional* RISC-V simulator, and reports
**dynamic instruction count** as the performance metric.  The registry's
cost models use the same metric:

  * every registry lowering declares ``cost(*args) -> int`` — the number
    of dynamic vector instructions it retires for those operand shapes
    (generic/scalar tiers count element ops; vector tiers count
    ceil(elems/vreg) whole-register ops; customized kernels count their
    per-register op structure);
  * :func:`count` runs a function and accumulates the per-op counts
    through dispatch — giving the baseline-vs-customized instruction
    ratio, directly comparable to the paper's Figure 2;
  * :func:`fx_vector_instrs` estimates the instruction count of a torch
    function from its aten graph, captured by ``make_fx`` on meta
    tensors (nothing is allocated, whatever the input size): each node
    = ceil(out_elems / vreg) vector instructions, transcendentals
    scalarized when the target has no vector libm — the reason the
    paper's vtanh/vsigmoid baselines are slow.

The per-node rules are those the JAX reference applies to jaxpr
equations.  Aten splits some ops differently, so nodes are mapped to the
reference's primitives first: ``aten.clamp`` with both bounds is two
ops (max and min), ``aten.sigmoid`` is ``logistic``, and dtype casts,
views and copies are free.  ``argmax``/``argmin`` count at int32 width,
as jnp's indices are int32 where aten's are int64, and
``max_pool2d_with_indices`` moves its values only (``max_pool2d`` drops
the indices, and the reference's ``reduce_window`` has none).
"""
from __future__ import annotations

import contextlib
import logging
import math
import threading
from collections import defaultdict
from typing import Dict, Optional

import torch
from torch.fx.experimental.proxy_tensor import make_fx

from .targets import current_target, itemsize, use_target

log = logging.getLogger(__name__)

_tls = threading.local()


def _counts() -> Optional[Dict]:
    return getattr(_tls, "counts", None)


_cost_warned = set()

# ---------------------------------------------------------------------------
# Profile-guided calibration.
#
# The declared cost models are *estimates*.  A calibration maps measured
# counts back onto the abstract model as per-op multiplicative
# correction factors; the registry consults it for every non-generic
# candidate so selection ranks by *measured*, not declared, cost.
# ---------------------------------------------------------------------------

_calibration_lock = threading.Lock()
_calibration: Optional[Dict] = None


def set_calibration(factors: Optional[Dict[str, float]],
                    default: float = 1.0) -> None:
    """Install per-op correction factors (``{op: measured/estimated}``)
    applied by the registry to every non-generic candidate cost.
    ``None`` uninstalls.  Callers that memoize selections (the registry
    does) must invalidate after changing this — use
    ``registry.REGISTRY.set_calibration`` which does both."""
    global _calibration
    with _calibration_lock:
        if factors is None:
            _calibration = None
        else:
            _calibration = {"factors": {str(k): float(v)
                                        for k, v in factors.items()},
                            "default": float(default)}


def get_calibration() -> Optional[Dict]:
    """The installed calibration (``{"factors": {...}, "default": f}``)
    or None."""
    with _calibration_lock:
        return None if _calibration is None else {
            "factors": dict(_calibration["factors"]),
            "default": _calibration["default"]}


def calibrated_cost(op: str, cost: Optional[int]) -> Optional[int]:
    """Apply the installed per-op correction factor to an abstract cost
    (identity when no calibration is installed or cost is unknown).
    Never rounds a positive cost below 1 — a measured op is never free."""
    if cost is None:
        return None
    with _calibration_lock:
        cal = _calibration
    if cal is None:
        return cost
    f = cal["factors"].get(op, cal["default"])
    return max(1, int(round(cost * f))) if cost > 0 else 0


def warn_cost_model(lowering, exc, consequence: str) -> None:
    """Log a broken cost model once per (op, tier) — it is a real defect
    in the selection data, not something to silently mask."""
    key = (lowering.op, lowering.tier)
    if key not in _cost_warned:
        _cost_warned.add(key)
        log.warning("cost model for %s/%s raised %r; %s (fix the model — "
                    "selection quality depends on it)",
                    lowering.op, lowering.tier, exc, consequence)


def record(lowering, *args, cost=None, **kw) -> None:
    """Called by registry.dispatch for every op issue.

    ``cost`` is the count already evaluated (and memoized) at selection
    time; when absent the lowering's model is evaluated here.
    """
    c = _counts()
    if c is None:
        return
    n = 0
    if cost is not None:
        n = int(cost)
    elif lowering.cost is not None:
        try:
            n = int(lowering.cost(*args, **kw))
        except Exception as e:
            warn_cost_model(lowering, e, "counting 0")
    c["per_op"][(lowering.op, lowering.tier)] += n
    c["total"] += n


@contextlib.contextmanager
def count():
    """Collect dynamic instruction counts for dispatches in this scope."""
    prev = _counts()
    _tls.counts = {"per_op": defaultdict(int), "total": 0}
    try:
        yield _tls.counts
    finally:
        _tls.counts = prev


# the reference's historical name for scoping the active target during
# cost evaluation (``targets.use_target``)
cost_target = use_target


def vreg_for(dtype) -> int:
    """Elements per vector register for ``dtype`` on the active target."""
    return current_target().vreg_elems(dtype)


def vinstrs_for(n_elems: int, dtype) -> int:
    """Dynamic vector micro-ops to touch ``n_elems`` of ``dtype`` on the
    active target — ceil(n / vreg_elems), times ``lmul`` on VLA targets."""
    return current_target().vinstrs(n_elems, dtype)


# scalar libm call costs (instructions per element) when the baseline
# toolchain scalarizes — grounded in typical libm implementations
PRIM_SCALAR_COST = {"tanh": 30, "exp": 25, "logistic": 28, "log": 25,
                    "log1p": 28, "expm1": 28, "erf": 30, "sin": 28,
                    "cos": 28, "pow": 40, "sqrt": 10, "rsqrt": 8,
                    "atan2": 40, "cbrt": 30}
# vector-libm polynomial expansions (ops per vreg) when NOT scalarized
VEC_EXPANSION = {"tanh": 22, "exp": 14, "logistic": 24, "log": 20,
                 "log1p": 22, "expm1": 16, "erf": 24, "sin": 20, "cos": 20,
                 "pow": 34, "sqrt": 1, "rsqrt": 1, "atan2": 36, "cbrt": 24}


def _is_arr(a) -> bool:
    return hasattr(a, "shape") and hasattr(a, "dtype")


def _elems(x) -> int:
    shape = getattr(x, "shape", ())
    return math.prod(shape) if len(shape) else 1


def _arrays(args):
    return [a for a in args if _is_arr(a)]


def scalar_cost(ops_per_elem: int = 1):
    """Generic-tier cost: the scalar loop retires one instr per element op.

    Scalar (non-array) operands count as a single element.
    """

    def cost(*args, **kw):
        elems = [_elems(a) for a in _arrays(args)]
        return ops_per_elem * (max(elems) if elems else 1)

    return cost


def vector_cost(ops_per_vec: int = 1):
    """Vector-tier cost: whole-register ops, ceil(elems / vreg_elems).

    With no array operand the op still retires one whole-register
    instruction.
    """

    def cost(*args, **kw):
        arrs = _arrays(args)
        if not arrs:
            return ops_per_vec
        n = max(_elems(a) for a in arrs)
        return ops_per_vec * vinstrs_for(n, arrs[0].dtype)

    return cost


def traced_cost(fn, *, union_overhead: bool = True,
                transcendental: bool = False):
    """Cost model that *analyzes the lowering's generated code* (its aten
    graph) against the active target — the paper's §4 methodology.

    ``union_overhead``: the original-SIMDe generic-union memory
    round-trip per op (paper §3.2 / Listing 4) — charged only on VLA
    targets, where the SIMDe flow actually materializes the union.
    ``transcendental``: on targets without a vector libm (the baseline
    RVV toolchain) the prim scalarizes.
    """

    def cost(*args, **kw):
        tgt = current_target()
        scalarize = transcendental and not tgt.has_vector_libm
        ovh = union_overhead and tgt.vla
        return fx_vector_instrs(fn, *args, scalarize=scalarize,
                                union_overhead=ovh, **kw)

    return cost


# ---------------------------------------------------------------------------
# Aten-graph estimate.
# ---------------------------------------------------------------------------

# Primitives with no vector libm on the baseline path: the compiler falls
# back to a scalarized loop.
SCALARIZED_PRIMS = set(PRIM_SCALAR_COST)

# aten op -> reference primitive name, where they differ or matter
_ATEN_PRIM = {"sigmoid": "logistic", "mm": "dot_general",
              "bmm": "dot_general", "addmm": "dot_general",
              "convolution": "conv_general_dilated",
              "max_pool2d": "reduce_window",
              "max_pool2d_with_indices": "reduce_window",
              "avg_pool2d": "reduce_window",
              "gather": "gather", "index": "gather",
              "index_select": "gather", "scatter": "scatter",
              "scatter_add": "scatter-add", "index_put": "scatter",
              "index_add": "scatter-add", "sort": "sort", "topk": "top_k",
              "sum": "reduce_sum", "amax": "reduce_max",
              "amin": "reduce_min", "argmax": "argmax", "argmin": "argmin"}
for _p in SCALARIZED_PRIMS:
    _ATEN_PRIM.setdefault(_p, _p)

# dtype casts, views, copies and constants: no vector instruction
_FREE_ATEN = {"_to_copy", "view", "_unsafe_view", "expand", "squeeze",
              "unsqueeze", "detach", "alias", "clone", "copy", "t",
              "transpose", "permute", "slice", "select", "lift_fresh_copy",
              "scalar_tensor", "full", "zeros", "ones", "empty",
              "as_strided"}


def _aten_name(node) -> Optional[str]:
    packet = getattr(node.target, "overloadpacket", None)
    return None if packet is None else packet.__name__


def _tensors(x):
    """Tensor values (from node meta) among a node's args, flattened."""
    if isinstance(x, torch.fx.Node):
        v = x.meta.get("val")
        return [v] if isinstance(v, torch.Tensor) else []
    if isinstance(x, (tuple, list)):
        return [t for u in x for t in _tensors(u)]
    return []


# aten ops whose output is an index tensor (int64 in aten, int32 in jnp)
_INDEX_OUT = {"argmax", "argmin"}


def _out(node) -> Optional[torch.Tensor]:
    v = node.meta.get("val")
    if isinstance(v, (tuple, list)):
        v = v[0] if v else None
    if isinstance(v, torch.Tensor) and _aten_name(node) in _INDEX_OUT:
        # the reference's indices are int32 (jnp without x64), aten's
        # int64: count them at the reference's width
        v = torch.empty(v.shape, dtype=torch.int32, device="meta")
    return v if isinstance(v, torch.Tensor) else None


def _multiplicity(name: str, node) -> int:
    """Reference primitives one aten node stands for: a two-sided clamp
    is max then min, as ``jnp.clip`` is."""
    if name == "clamp":
        lo = node.args[1] if len(node.args) > 1 else node.kwargs.get("min")
        hi = node.args[2] if len(node.args) > 2 else node.kwargs.get("max")
        return max(1, (lo is not None) + (hi is not None))
    return 1


def _is_reduction(name: str, node) -> bool:
    if name in ("max", "min"):
        # max.default / max.dim reduce; max.other is elementwise maximum
        return node.target._overloadname in ("default", "dim")
    return name in ("sum", "amax", "amin", "argmax", "argmin", "mean")


def _capture(fn, args, kw) -> torch.fx.GraphModule:
    """Aten graph of ``fn(*args, **kw)`` on meta stand-ins for the tensor
    arguments; non-tensor positional args are closed over."""
    is_arr = [isinstance(a, torch.Tensor) for a in args]
    metas = [torch.empty(a.shape, dtype=a.dtype, device="meta")
             for a, ok in zip(args, is_arr) if ok]

    def wrapper(*traced):
        it = iter(traced)
        full = [next(it) if ok else a for a, ok in zip(args, is_arr)]
        return fn(*full, **kw)

    return make_fx(wrapper)(*metas)


def fx_vector_instrs(fn, *args, scalarize: bool = False,
                     union_overhead: bool = False, **kw) -> int:
    """Estimate dynamic vector instrs of ``fn(*args)`` from its aten graph.

    ``scalarize``: transcendentals cost their scalar-libm instruction
    counts (baseline has no vector libm).  ``union_overhead``: every
    vector op pays a 2x factor for the SIMDe generic union round-trip
    through memory (paper §3.2 Listing 4 discussion).
    """
    return _walk(_capture(fn, args, kw).graph, scalarize, union_overhead)


def _walk(graph, scalarize: bool, union_overhead: bool = False) -> int:
    tgt = current_target()
    ovh = 2 if union_overhead else 1
    total = 0
    for node in graph.nodes:
        if node.op != "call_function":
            continue
        name = _aten_name(node)
        out = _out(node)
        if name is None or name in _FREE_ATEN or out is None:
            continue
        prim = _ATEN_PRIM.get(name, name)
        n = out.numel()
        ins = _tensors(node.args)
        dt = out.dtype
        if dt == torch.bool and ins:
            # mask-producing op (vmseq & co): the compare executes at the
            # *data* register width
            dt = ins[0].dtype
        vi = lambda m: tgt.vinstrs(m, dt)  # noqa: E731
        if prim == "dot_general":
            a = ins[1] if name == "addmm" else ins[0]
            k = a.shape[-1]
            if tgt.has_mxu:    # matrix-unit macro-ops
                total += math.ceil(n / (tgt.mxu * tgt.mxu)) * \
                    math.ceil(k / tgt.mxu)
            else:              # vfma ladder (+ union loads on baseline)
                total += ovh * vi(n * k)
            if name == "addmm":            # the fused bias add
                total += ovh * vi(n)
        elif prim == "conv_general_dilated":
            # OIHW weight: contracted size per output element is
            # ci_per_group * kh * kw regardless of groups
            w = ins[1]
            k_total = math.prod(w.shape[1:])
            groups = node.args[8] if len(node.args) > 8 else 1
            if tgt.has_mxu and groups == 1:     # depthwise can't use MXU
                total += math.ceil(n / (tgt.mxu * tgt.mxu)) * \
                    math.ceil(k_total / tgt.mxu)
            else:
                total += ovh * vi(n * k_total)
            if len(ins) > 2:                    # the fused bias add
                total += ovh * vi(n)
        elif prim == "reduce_window":
            win = math.prod(node.args[1]) if len(node.args) > 1 else 2
            total += ovh * win * vi(n)
        elif prim in ("gather", "scatter", "scatter-add"):
            # no per-lane vector gather; tiled machines move whole rows
            gran = 8 if tgt.has_mxu else 1
            total += max(1, n // gran)
        elif prim in ("sort", "top_k"):
            total += ovh * vi(n * max(1, int(math.log2(max(2, n)))))
        elif prim in SCALARIZED_PRIMS:
            if scalarize:
                total += PRIM_SCALAR_COST[prim] * n
            else:
                total += ovh * VEC_EXPANSION.get(prim, 1) * vi(n)
        elif _is_reduction(name, node):
            total += ovh * vi(ins[0].numel() if ins else n)
            if name == "mean":                  # reduce_sum, then divide
                total += ovh * vi(n)
        else:
            total += _multiplicity(name, node) * ovh * vi(n)
    return total


def fx_hbm_bytes(fn, *args, **kw) -> int:
    """HBM traffic of the *unfused* op-by-op translation: every node
    reads its operands and writes its output (the SIMDe generic-union
    semantics — each intrinsic round-trips memory).  Customized kernels
    pay only their true inputs+outputs; the ratio is the fusion win."""
    return _walk_bytes(_capture(fn, args, kw).graph)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * itemsize(t.dtype)


def _walk_bytes(graph) -> int:
    total = 0
    for node in graph.nodes:
        if node.op != "call_function":
            continue
        name = _aten_name(node)
        if name is None or name in _FREE_ATEN:
            continue
        v = node.meta.get("val")
        if name in _INDEX_OUT or \
                _ATEN_PRIM.get(name) == "reduce_window":
            # one output as the reference writes it: int32 indices; a
            # pooling window's values only (max_pool2d's indices are an
            # aten artifact that max_pool2d drops)
            v = _out(node)
        outs = v if isinstance(v, (tuple, list)) else [v]
        moved = sum(_nbytes(o) for o in outs if isinstance(o, torch.Tensor))
        moved += sum(_nbytes(t) for t in _tensors(node.args))
        total += _multiplicity(name, node) * moved
    return total


def io_bytes(*arrays) -> int:
    """True input+output bytes of a fused kernel."""
    return sum(_elems(a) * itemsize(a.dtype) for a in arrays if _is_arr(a))
