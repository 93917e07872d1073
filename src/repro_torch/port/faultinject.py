"""Seeded fault injection at the port pipeline's seams (chaos harness).

Product code marks each seam with a cheap hook:

    from repro_torch.port import faultinject as _fi
    _fi.fault_point("compile.trace", kernel=fn.name)       # may raise
    hit = _fi.corrupt_value("cache.entry", hit, key=key)   # may mutate

Disarmed (the default, always in production) both are a single module
-global check and a return.  Tests arm a seam with an error factory, a
fire budget, and an optional context predicate:

    with _fi.injected("compile.trace", error=CompileError("boom"),
                      times=1, where=lambda ctx: ctx["kernel"] == "vadd"):
        ...

The seams of the pipeline (see DESIGN.md §13):

    revec.retile     forced re-vectorization veto (RevecVeto)
    compile.trace    compile-time raise / timeout (CompiledKernel build)
    compile.run      runtime fault inside the traced program
    interp.run       interpreter failure (exercises full exhaustion)
    cache.entry      corrupted compiled-cache hit (value mutator)
    sim.mem          simulator memory fault on a vector access
    engine.batch     batched-program failure inside PortEngine

Plus two cache-shaped helpers that need no seam: ``eviction_storm``
(shrinks the compiled LRU so every lookup thrashes) and
``corrupt_cache_entry`` (poisons a live entry in place, exercising the
cache's hit-validation path).

Everything is deterministic: probabilities draw from a
``random.Random(seed)`` owned by the armed seam, and fire budgets are
exact counters — same seed, same plan, same faults.
"""
from __future__ import annotations

import contextlib
import random
import threading
from typing import Any, Callable, Dict, List, Optional

__all__ = [
    "fault_point", "corrupt_value", "arm", "disarm", "disarm_all",
    "fired", "injected", "eviction_storm", "corrupt_cache_entry",
    "FaultPlan", "SEAMS",
]

SEAMS = (
    "revec.retile", "compile.trace", "compile.run", "interp.run",
    "cache.entry", "sim.mem", "engine.batch",
)

# Fast path: product code checks one module global before taking the
# lock.  Only writes under _LOCK flip it.
_ARMED = False
_LOCK = threading.RLock()
_PLANS: Dict[str, "FaultPlan"] = {}


class FaultPlan:
    """One armed seam: what to raise/mutate, how often, for whom."""

    def __init__(self, seam: str, *,
                 error: Any = None,
                 mutate: Optional[Callable[[Any, Dict], Any]] = None,
                 times: Optional[int] = 1,
                 probability: float = 1.0,
                 seed: int = 0,
                 where: Optional[Callable[[Dict], bool]] = None):
        if error is None and mutate is None:
            raise ValueError("arm() needs an error or a mutate callable")
        self.seam = seam
        self.error = error
        self.mutate = mutate
        self.times = times
        self.probability = float(probability)
        self.where = where
        self.rng = random.Random(seed)
        self.fired = 0
        self.seen = 0

    def _should_fire(self, ctx: Dict) -> bool:
        self.seen += 1
        if self.times is not None and self.fired >= self.times:
            return False
        if self.where is not None and not self.where(ctx):
            return False
        if self.probability < 1.0 and self.rng.random() >= self.probability:
            return False
        self.fired += 1
        return True

    def _make_error(self, ctx: Dict) -> BaseException:
        err = self.error
        if isinstance(err, type):
            err = err(f"injected fault at seam {self.seam!r}")
        elif callable(err) and not isinstance(err, BaseException):
            err = err(ctx)
        # Enrich taxonomy errors with the seam context.
        add = getattr(err, "add_context", None)
        if add is not None:
            add(**{k: v for k, v in ctx.items() if isinstance(
                v, (str, int, float))})
        return err


def arm(seam: str, *, error: Any = None,
        mutate: Optional[Callable[[Any, Dict], Any]] = None,
        times: Optional[int] = 1, probability: float = 1.0,
        seed: int = 0,
        where: Optional[Callable[[Dict], bool]] = None) -> FaultPlan:
    """Arm ``seam``; returns the plan (read ``.fired`` afterwards)."""
    global _ARMED
    plan = FaultPlan(seam, error=error, mutate=mutate, times=times,
                     probability=probability, seed=seed, where=where)
    with _LOCK:
        _PLANS[seam] = plan
        _ARMED = True
    return plan


def disarm(seam: str) -> None:
    global _ARMED
    with _LOCK:
        _PLANS.pop(seam, None)
        _ARMED = bool(_PLANS)


def disarm_all() -> None:
    global _ARMED
    with _LOCK:
        _PLANS.clear()
        _ARMED = False


def fired(seam: str) -> int:
    with _LOCK:
        plan = _PLANS.get(seam)
        return plan.fired if plan else 0


@contextlib.contextmanager
def injected(seam: str, **kwargs):
    """``arm`` for the duration of a with-block, then disarm."""
    plan = arm(seam, **kwargs)
    try:
        yield plan
    finally:
        disarm(seam)


# ---------------------------------------------------------------------------
# seams (called from product code)
# ---------------------------------------------------------------------------

def fault_point(seam: str, **ctx: Any) -> None:
    """No-op unless ``seam`` is armed; may raise the planned error."""
    if not _ARMED:
        return
    with _LOCK:
        plan = _PLANS.get(seam)
        if plan is None or plan.error is None:
            return
        if not plan._should_fire(ctx):
            return
        err = plan._make_error(ctx)
    raise err


def corrupt_value(seam: str, value: Any, **ctx: Any) -> Any:
    """Return ``value``, possibly mutated by an armed plan."""
    if not _ARMED:
        return value
    with _LOCK:
        plan = _PLANS.get(seam)
        if plan is None or plan.mutate is None:
            return value
        if not plan._should_fire(ctx):
            return value
        mutate = plan.mutate
    return mutate(value, ctx)


# ---------------------------------------------------------------------------
# cache-shaped chaos helpers
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def eviction_storm(capacity: int = 1):
    """Shrink the compiled-kernel LRU so every lookup thrashes."""
    from .. import port
    old = port.compiled_cache_info()["capacity"]
    port.set_compiled_cache_capacity(capacity)
    try:
        yield
    finally:
        port.set_compiled_cache_capacity(old)


def corrupt_cache_entry(kernel: Optional[str] = None) -> List:
    """Poison live compiled-cache entries in place (swap their payloads
    across keys, or break a lone entry's callable) and return the
    affected keys.  The cache's hit validation must detect the damage
    and transparently recompile."""
    from .. import port
    cache = port._COMPILED_CACHE
    with cache._lock:
        keys = [k for k in cache._cache
                if kernel is None or k[0].fn.name == kernel]
        if not keys:
            return []
        if len(keys) >= 2:
            a, b = keys[0], keys[1]
            cache._cache[a], cache._cache[b] = (
                cache._cache[b], cache._cache[a])
            return [a, b]
        k = keys[0]
        entry = cache._cache[k]
        entry._call = _broken_callable
        entry._corrupted = True
        return [k]


def _broken_callable(*_a, **_k):
    raise RuntimeError("corrupted cache entry: payload clobbered")
