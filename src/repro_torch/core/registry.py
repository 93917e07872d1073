"""Lowering registry — cost-driven, target-aware selection.

SIMDe selects an implementation per intrinsic with a compile-time
preprocessor ladder (paper Listing 2): native ISA intrinsic, else vector
builtins, else vector-attribute ops, else auto-vectorized scalar loop.
The paper's actual contribution is *choosing* the customized RVV
conversion per function by analyzing the generated code against the
target's vector architecture — the ladder is only the candidate set.

This registry implements that choice as a runtime feature consulted at
every dispatch (memoized, so a repeated shape pays one dictionary
lookup):

  tier 'pallas'  — customized kernel   (paper: customized RVV intrinsics)
  tier 'vector'  — whole-tensor torch ops (paper: vector attributes)
  tier 'generic' — scalar-semantics emulation, always valid
                   (paper: auto-vectorized scalar loop; also the oracle)

The tier names are those of the JAX reference.  In this port ``pallas``
names the customized-kernel tier — a CUDA kernel written by hand for the
H100 — so that ``explain()`` tables and the committed cost numbers of
``BENCH_xnnpack.json`` compare one to one.

Selection (:meth:`_Registry.select`):

  1. candidates = registered lowerings with tier rank <= the policy cap
     (``use_policy('vector')`` therefore still reproduces the
     original-SIMDe baseline: customized conversions excluded);
  2. a non-generic candidate is valid only if its ``supports`` predicate
     holds *and* the target can hold the op's fixed-width logical
     register (the paper's ``vlen >= width`` Table-2 rule);
  3. each valid candidate's declared ``cost(*args)`` is evaluated under
     the active target and the cheapest wins; tier rank is only the
     tie-break (higher — more specialized — first).  On a CUDA target
     (the default ``h100``) the kernel tier wins wherever it is valid:
     on the card the port runs its hand-written kernel, never a plain
     torch version in the kernel's place, and the declared costs model
     the reference's TPU and RVV machines, not the card.  Where the
     kernel tier is invalid the costs rank the lower tiers as on any
     target.

Selections are memoized in a bounded LRU on (op, abstract
shapes/dtypes/device types, policy, target).  :meth:`_Registry.explain`
returns the full per-candidate report — the paper's analysis tables as
a feature.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import logging
import math
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

from . import targets as _targets

log = logging.getLogger(__name__)

TIERS = ("generic", "vector", "pallas")
_TIER_RANK = {t: i for i, t in enumerate(TIERS)}


@dataclasses.dataclass
class Lowering:
    op: str
    tier: str
    fn: Callable
    # instruction-cost model: (*args, **kw) -> int dynamic vector-instr
    # count under the *active* target (targets.current_target()).
    cost: Optional[Callable] = None
    # validity predicate, e.g. shape/dtype/scratch-budget constraints.
    supports: Optional[Callable] = None
    # fixed-width logical register this lowering manipulates, for the
    # Table-2 vlen>=width rule: an int (bits) or (*args, **kw)->bits.
    # None = infer from the widest array operand.
    width: Optional[Any] = None
    doc: str = ""

    def ok(self, *args, **kw) -> bool:
        if self.supports is None:
            return True
        try:
            return bool(self.supports(*args, **kw))
        except Exception:
            return False


@dataclasses.dataclass
class Candidate:
    """One row of an explain() report."""
    lowering: Lowering
    valid: bool
    width_ok: bool
    cost: Optional[int]
    chosen: bool = False
    note: str = ""

    @property
    def tier(self) -> str:
        return self.lowering.tier


def _logical_width_bits(args) -> Optional[int]:
    """Width of the fixed-width logical register an op manipulates:
    the *widest* array operand, saturated at NEON Q-register width.

    Tensor-granularity ops strip-mine at Q-register granularity, so the
    requirement saturates at 128 bits; smaller operands (D registers)
    only need their own width — reproducing Table 2's rows.
    """
    widest = None
    for a in args:
        if hasattr(a, "shape") and hasattr(a, "dtype"):
            try:
                n = math.prod(a.shape) if len(a.shape) else 1
                bits = n * _targets.itemsize(a.dtype) * 8
            except Exception:
                return None
            widest = bits if widest is None else max(widest, bits)
    return None if widest is None else min(128, widest)


_UNCACHEABLE = object()


def _akey(v) -> Any:
    """Abstract cache key for one argument: tensors by (shape, dtype,
    device type), scalars by value; unhashables poison the key
    (selection still works, it just isn't memoized)."""
    if hasattr(v, "shape") and hasattr(v, "dtype"):
        try:
            dev = getattr(v, "device", None)
            return ("#arr", tuple(v.shape), str(v.dtype),
                    getattr(dev, "type", None))
        except Exception:
            return _UNCACHEABLE
    if isinstance(v, (tuple, list)):
        sub = tuple(_akey(u) for u in v)
        return _UNCACHEABLE if _UNCACHEABLE in sub else ("#seq",) + sub
    try:
        hash(v)
    except TypeError:
        return _UNCACHEABLE
    return v


class _Registry:
    # Default LRU capacity: generous for any realistic op x shape x
    # target working set, but bounded so a serving path cannot grow
    # without limit under adversarial shape diversity.
    DEFAULT_CACHE_CAPACITY = 4096

    def __init__(self, cache_capacity: int = DEFAULT_CACHE_CAPACITY):
        self._ops: Dict[str, Dict[str, Lowering]] = {}
        self._tls = threading.local()
        self._default = "pallas"
        # LRU: key -> (lowering, evaluated cost).  The lock covers every
        # cache read/write: the hit path mutates recency order.
        self._cache: "collections.OrderedDict[Tuple, Tuple[Lowering, Optional[int]]]" = \
            collections.OrderedDict()
        self._cache_lock = threading.Lock()
        self._capacity = int(cache_capacity)
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        # lookups whose key was poisoned by an unhashable argument,
        # counted apart so hits + misses + uncacheable == lookups.
        self._uncacheable = 0

    # -- registration -------------------------------------------------------
    def register(self, op: str, tier: str, *, cost=None, supports=None,
                 width=None, doc=""):
        if tier not in TIERS:
            raise ValueError(f"unknown tier {tier!r}")

        def deco(fn):
            self._ops.setdefault(op, {})[tier] = Lowering(
                op=op, tier=tier, fn=fn, cost=cost, supports=supports,
                width=width, doc=doc)
            with self._cache_lock:
                self._cache.clear()
            return fn

        return deco

    # -- policy (a *cap* on the candidate tier set) -------------------------
    @property
    def policy(self) -> str:
        return getattr(self._tls, "policy", self._default)

    def set_default_policy(self, policy: str) -> None:
        if policy not in TIERS:
            raise ValueError(f"unknown policy {policy!r}")
        self._default = policy

    @contextlib.contextmanager
    def use_policy(self, policy: str):
        if policy not in TIERS:
            raise ValueError(f"unknown policy {policy!r}")
        prev = self.policy
        self._tls.policy = policy
        try:
            yield
        finally:
            self._tls.policy = prev

    # -- cost evaluation ----------------------------------------------------
    @staticmethod
    def _eval_cost(low: Lowering, args, kw) -> Optional[int]:
        if low.cost is None:
            return None
        try:
            return int(low.cost(*args, **kw))
        except Exception as e:
            from . import trace  # local import to avoid cycle at init
            trace.warn_cost_model(low, e, "treating cost as unknown")
            return None

    def _candidates(self, op: str, args, kw, policy: str,
                    target: _targets.Target) -> List[Candidate]:
        tiers = self._ops.get(op)
        if not tiers:
            raise KeyError(f"no lowering registered for op {op!r}")
        cap = _TIER_RANK[policy]
        cands = []
        # validity predicates AND cost models both read the active
        # target — evaluate every candidate under the *requested*
        # target, or the cache would memoize a selection made against
        # the wrong machine.
        with _targets.use_target(target):
            for tier in TIERS[:cap + 1]:
                low = tiers.get(tier)
                if low is None:
                    continue
                width = (low.width(*args, **kw) if callable(low.width)
                         else low.width) if low.width is not None \
                    else _logical_width_bits(args)
                width_ok = (tier == "generic" or width is None
                            or target.supports_width(width))
                valid = width_ok and low.ok(*args, **kw)
                note = "" if width_ok else \
                    f"vlen {target.vlen} < width {width}"
                cost = self._eval_cost(low, args, kw) if valid else None
                if cost is not None and tier != "generic":
                    # measured-count term: per-op correction factors
                    # scale the abstract estimate (trace.set_calibration)
                    from . import trace  # local import to avoid cycle
                    cost = trace.calibrated_cost(op, cost)
                cands.append(Candidate(lowering=low, valid=valid,
                                       width_ok=width_ok, cost=cost,
                                       note=note))
        return cands

    @staticmethod
    def _pick(cands: List[Candidate],
              kernel_first: bool = False) -> Optional[Candidate]:
        valid = [c for c in cands if c.valid]
        if not valid:
            return None
        costed = [c for c in valid if c.cost is not None]
        kernel = [c for c in valid if c.tier == "pallas"]
        if kernel_first and kernel:
            best = kernel[0]
        elif costed:
            best = min(costed, key=lambda c: (c.cost,
                                              -_TIER_RANK[c.tier]))
        else:
            best = max(valid, key=lambda c: _TIER_RANK[c.tier])
        best.chosen = True
        return best

    # -- dispatch -----------------------------------------------------------
    def _select_entry(self, op, args, kw, policy, target):
        """Cache-aware selection: (lowering, evaluated cost).

        The cost rides along so dispatch-time instruction counting
        (trace.count) reuses the selection-time evaluation instead of
        re-tracing the cost model per issue.
        """
        pol = policy or self.policy
        if pol not in TIERS:
            raise ValueError(f"unknown policy {pol!r}")
        tgt = _targets.resolve_target(target)
        key = None
        akeys = tuple(_akey(a) for a in args) + tuple(
            sorted((k, _akey(v)) for k, v in kw.items()))
        if _UNCACHEABLE not in akeys and not any(
                isinstance(k, tuple) and _UNCACHEABLE in k for k in akeys):
            # key on the Target *value* (frozen dataclass), not its name:
            # an ad-hoc Target sharing a registered name must not collide.
            key = (op, pol, tgt, akeys)
            with self._cache_lock:
                hit = self._cache.get(key)
                if hit is not None:
                    self._hits += 1
                    self._cache.move_to_end(key)
                    return hit
        else:
            with self._cache_lock:
                self._uncacheable += 1
        best = self._pick(self._candidates(op, args, kw, pol, tgt),
                          tgt.kind == "cuda")
        if best is None:
            raise KeyError(f"no valid lowering for op {op!r} at policy "
                           f"{pol!r} on target {tgt.name!r} with given args")
        entry = (best.lowering, best.cost)
        if key is not None:
            with self._cache_lock:
                self._misses += 1
                self._cache[key] = entry
                while len(self._cache) > self._capacity:
                    self._cache.popitem(last=False)
                    self._evictions += 1
        return entry

    def select(self, op: str, *args, policy: Optional[str] = None,
               target: Optional[Union[str, "_targets.Target"]] = None,
               **kw) -> Lowering:
        """Pick the cheapest valid lowering under the active target."""
        return self._select_entry(op, args, kw, policy, target)[0]

    def cost_of(self, op: str, *args, policy: Optional[str] = None,
                target: Optional[Union[str, "_targets.Target"]] = None,
                **kw) -> Tuple[str, Optional[int]]:
        """(tier, evaluated cost) of the selected lowering — the memoized
        selection-time entry, for analytic consumers that need the cost
        without issuing the op."""
        low, cost = self._select_entry(op, args, kw, policy, target)
        return low.tier, cost

    def lowering(self, op: str, tier: str) -> Lowering:
        """The registered Lowering for (op, tier); KeyError if absent."""
        return self._ops[op][tier]

    def explain(self, op: str, *args, policy: Optional[str] = None,
                target: Optional[Union[str, "_targets.Target"]] = None,
                **kw) -> Dict:
        """Per-candidate selection report (cost, validity, chosen tier) —
        the paper's analysis tables as an API.  Uncached by design."""
        pol = policy or self.policy
        if pol not in TIERS:
            raise ValueError(f"unknown policy {pol!r}")
        tgt = _targets.resolve_target(target)
        cands = self._candidates(op, args, kw, pol, tgt)
        best = self._pick(cands, tgt.kind == "cuda")
        return {
            "op": op,
            "policy": pol,
            "target": tgt.name,
            "chosen": best.tier if best else None,
            "chosen_cost": best.cost if best else None,
            "candidates": [
                {"tier": c.tier, "valid": c.valid, "width_ok": c.width_ok,
                 "cost": c.cost, "chosen": c.chosen, "doc": c.lowering.doc,
                 "note": c.note}
                for c in cands],
        }

    def dispatch(self, op: str, *args, policy: Optional[str] = None,
                 target: Optional[Union[str, "_targets.Target"]] = None,
                 **kw):
        low, cost = self._select_entry(op, args, kw, policy, target)
        from . import trace  # local import to avoid cycle
        trace.record(low, *args, cost=cost, **kw)
        return low.fn(*args, **kw)

    # -- calibration --------------------------------------------------------
    def set_calibration(self, factors, default: float = 1.0) -> None:
        """Install (or with ``None`` clear) per-op cost correction
        factors and invalidate memoized selections — cached entries were
        ranked under the previous cost surface."""
        from . import trace  # local import to avoid cycle
        trace.set_calibration(factors, default=default)
        with self._cache_lock:
            self._cache.clear()

    # -- introspection ------------------------------------------------------
    def cache_info(self) -> Dict[str, int]:
        with self._cache_lock:
            return {"hits": self._hits, "misses": self._misses,
                    "size": len(self._cache), "capacity": self._capacity,
                    "evictions": self._evictions,
                    "uncacheable": self._uncacheable,
                    "lookups": self._hits + self._misses
                    + self._uncacheable}

    def set_cache_capacity(self, capacity: int) -> None:
        """Bound the selection cache (LRU eviction past ``capacity``)."""
        if capacity < 1:
            raise ValueError(f"cache capacity must be >= 1, got {capacity}")
        with self._cache_lock:
            self._capacity = int(capacity)
            while len(self._cache) > self._capacity:
                self._cache.popitem(last=False)
                self._evictions += 1

    def cache_clear(self) -> None:
        with self._cache_lock:
            self._cache.clear()
            self._hits = self._misses = self._evictions = 0
            self._uncacheable = 0

    def tiers_of(self, op: str):
        return sorted(self._ops.get(op, {}), key=_TIER_RANK.get)


REGISTRY = _Registry()
register = REGISTRY.register
dispatch = REGISTRY.dispatch
select = REGISTRY.select
explain = REGISTRY.explain
use_policy = REGISTRY.use_policy


def current_scope():
    """The calling thread's (policy, target): what its dispatches select
    under.  Both are thread-local, and autograd runs a CUDA op's backward
    (and ``torch.utils.checkpoint``'s recompute) on a thread of its own,
    so code that runs there re-enters the scope of the forward with
    :func:`use_scope`."""
    return REGISTRY.policy, _targets.current_target()


@contextlib.contextmanager
def use_scope(scope):
    """Run under a (policy, target) that :func:`current_scope` took."""
    policy, target = scope
    with REGISTRY.use_policy(policy), _targets.use_target(target):
        yield
