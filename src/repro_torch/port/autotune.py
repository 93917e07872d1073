"""repro_torch.port.autotune — profile-guided cost calibration + per-kernel
knob search with a persistent autotuning cache.

Selection (:mod:`repro_torch.core.registry`) ranks lowerings by *abstract*
dynamic-instruction estimates.  The estimates are honest about shape
but drift from what the emitted RVV stream actually retires: they
charge LMUL micro-ops per grouped issue while the machine retires one
instruction per mnemonic, and per-op constants miss codegen facts
(``vbsl`` estimates 3 bitwise ops but retires a 2-instruction
mask+merge).  The AVX/NEON "When Should They Be Used?" result
(PAPERS.md) is that intrinsic payoff is config-dependent in ways a
static model cannot see — so this module closes the loop:

1. **Calibration** (:func:`calibrate`): run corpus kernels through
   real RVV codegen (:mod:`repro_torch.rvv`), join the simulator's per-site
   retired counts against the abstract per-intrinsic estimates, and
   fit one multiplicative correction factor per logical-ISA op.
   :meth:`CalibrationModel.install` wires the factors into
   ``registry.select``/``cost_of`` (the measured-count term), so every
   subsequent selection ranks by calibrated, not declared, cost.

2. **Knob search** (:func:`tune`): per (kernel, target), enumerate the
   two big knobs — LMUL via a register-pressure model
   (:meth:`repro_torch.core.targets.Target.admissible_lmuls`: the widened
   register group must exist and concurrently-live vector values must
   fit the 32-register file) instead of the target's fixed grouping,
   and retile factor cap x tail policy
   (:func:`repro_torch.port.revec.retile`).  Candidates are ranked by the
   calibrated prediction, then the leaders are *fact-checked* on the
   simulator: the winner is the configuration that retires the fewest
   instructions, and its outputs must match the static default's
   bitwise before it is accepted.

3. **Persistence** (:class:`AutotuneCache`): tuned decisions live in
   an on-disk JSON cache keyed on the kernel's IR fingerprint plus the
   resolved Target *values* (vlen/lane/kind — not the name, and not
   LMUL: the decision chooses LMUL).  Loads are corruption-detecting
   (a truncated or hand-mangled file degrades to static costs and
   records a typed :class:`~repro_torch.port.resilience.CacheCorruption`),
   writes are atomic (tmp + ``os.replace``), and tuning is
   single-flight per key so a concurrent ``warmup()`` tunes each
   (kernel, target) exactly once.  ``PortedKernel.compile(tuned=True)``
   and ``serve.PortEngine(tuned=True)`` consult the cache, so a deploy
   restart starts tuned without re-measuring.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from ..core import targets as _targets
from ..core.registry import REGISTRY

from ..core.vtypes import numpy_dtype
from .resilience import CacheCorruption, PortError

__all__ = [
    "CalibrationModel", "TunedDecision", "AutotuneCache",
    "calibrate", "tune", "tune_corpus", "lookup", "cache",
    "set_cache_path", "reset_cache", "install", "uninstall",
    "admissible_lmuls", "width_scale", "live_vec_values",
]

CACHE_VERSION = 1
# the port keeps its own cache file: it reads and writes the file this
# variable names, never the one the JAX package's variable names
CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"

# targets the calibration is fit on: m1 members of the width family,
# where estimate micro-ops and retired instructions are 1:1 in LMUL
CALIBRATION_TARGETS = ("rvv-128", "rvv-512")

# tail policies the tuner searches (revec.TAIL_POLICIES minus "masked",
# which "auto" already prefers when provable)
_SEARCH_TAILS = ("auto", "epilogue")

# how many calibrated leaders get simulator fact-checks per (kernel,
# target) — the rest are pruned on predicted cost alone
_SIM_TOP_K = 3


# ---------------------------------------------------------------------------
# Calibration: fit per-op correction factors from retired counts
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CalibrationModel:
    """Per-isa-op correction factors: ``retired / estimated``.

    ``samples`` keeps the raw per-op totals the fit came from;
    ``fitted_on`` the targets.  ``predict`` maps an abstract
    per-intrinsic estimate to expected retired instructions at a given
    LMUL (estimates charge ``lmul`` micro-ops per grouped issue, the
    machine retires one instruction per mnemonic — hence the divide).
    """

    factors: Dict[str, float]
    default: float = 1.0
    samples: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict)
    fitted_on: Tuple[str, ...] = ()

    def factor(self, op: str) -> float:
        return self.factors.get(op, self.default)

    def predict(self, per_intrinsic: Dict[str, Dict], lmul: int = 1) -> float:
        """Expected retired instructions for an abstract estimate's
        ``per_intrinsic`` rows under LMUL=``lmul`` grouping."""
        total = 0.0
        m = max(1, int(lmul))
        for row in per_intrinsic.values():
            total += row.get("instrs", 0) * self.factor(
                row.get("isa_op", "")) / m
        return total

    def install(self) -> None:
        """Wire these factors into registry selection (the
        measured-count term in ``cost_of``); invalidates the selection
        memo."""
        REGISTRY.set_calibration(self.factors, default=self.default)

    def to_dict(self) -> Dict[str, Any]:
        return {"factors": dict(self.factors), "default": self.default,
                "samples": {k: dict(v) for k, v in self.samples.items()},
                "fitted_on": list(self.fitted_on)}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CalibrationModel":
        return cls(factors={str(k): float(v)
                            for k, v in d["factors"].items()},
                   default=float(d.get("default", 1.0)),
                   samples={str(k): {"estimated": int(v["estimated"]),
                                     "retired": int(v["retired"])}
                            for k, v in d.get("samples", {}).items()},
                   fitted_on=tuple(d.get("fitted_on", ())))


def uninstall() -> None:
    """Remove any installed calibration; selection reverts to the
    static declared cost models."""
    REGISTRY.set_calibration(None)


def install(calibration: "CalibrationModel") -> None:
    calibration.install()


def calibrate(items: Iterable[Tuple[Any, tuple]],
              targets: Sequence[str] = CALIBRATION_TARGETS,
              policy: str = "pallas") -> CalibrationModel:
    """Fit per-op correction factors from measured retired counts.

    ``items`` is an iterable of ``(PortedKernel, example_args)``.  For
    each kernel x target the re-tiled IR is abstract-interpreted (the
    estimate) and the emitted RVV stream executed on the simulator (the
    fact); per-site retired counts join per-intrinsic estimates by
    intrinsic name, and totals accumulate per logical-ISA op.  vl=0
    parked sites still retire (and count) — the join is a union, so a
    fully-parked site cannot make its op look free.
    """
    from .. import rvv
    from .interp import Machine
    from .revec import retile

    est_tot: Dict[str, int] = {}
    ret_tot: Dict[str, int] = {}
    for kernel, args in items:
        for tname in targets:
            tgt = _targets.get_target(tname)
            if not tgt.vla:
                raise ValueError(f"calibration targets must be rvv, "
                                 f"got {tname!r}")
            res = retile(kernel.fn, tgt)
            est = Machine(res.fn, policy=policy, target=tgt,
                          abstract=True).run(*args)
            try:
                prog = rvv.emit(kernel, tgt)
                _, counts = rvv.run(prog, *args, with_counts=True)
            except (rvv.CodegenError, rvv.SimError):
                continue    # unemittable kernel: no measurement to fit
            per_est = est["per_intrinsic"]
            per_site = counts["per_site"]
            for name in set(per_est) | set(per_site):
                row = per_est.get(name)
                if row is None:
                    continue    # sim-only site with no estimate row
                op = row.get("isa_op", "")
                est_tot[op] = est_tot.get(op, 0) + int(row["instrs"])
                ret_tot[op] = ret_tot.get(op, 0) + int(
                    per_site.get(name, 0))
    factors = {op: ret_tot.get(op, 0) / est_tot[op]
               for op in est_tot if est_tot[op] > 0}
    samples = {op: {"estimated": est_tot[op],
                    "retired": ret_tot.get(op, 0)}
               for op in est_tot}
    return CalibrationModel(factors=factors, samples=samples,
                            fitted_on=tuple(targets))


# ---------------------------------------------------------------------------
# Register-pressure model: which LMULs are even legal for this kernel?
# ---------------------------------------------------------------------------

def width_scale(fn) -> int:
    """Widest/narrowest element-width ratio across the kernel's strip
    bodies.  The re-tiler fills the register group with the *narrowest*
    type, so a 2xSEW widening body needs EMUL = 2 x LMUL register
    groups — LMUL=8 on a widening kernel would demand a nonexistent
    EMUL=16 group.  1 for uniform-width (or strip-free) kernels."""
    from .revec import _body_vec_types, strip_loops
    scale = 1
    for strip in strip_loops(fn):
        bits = [8 * numpy_dtype(ty.dtype).itemsize
                for ty in _body_vec_types(strip.loop)]
        if bits:
            scale = max(scale, max(bits) // min(bits))
    return scale


def live_vec_values(fn) -> int:
    """Vector values that must stay *resident across strip iterations*:
    vector loop-carried phis plus loop-invariant vector operands used
    inside the body.  Transient body temporaries rotate through the
    same registers, so they are not pressure; accumulators and hoisted
    constants are.  Max over the kernel's strip loops."""
    from .ir import VecTupleType, VecType
    from .revec import strip_loops

    def _regs(ty) -> int:
        if isinstance(ty, VecTupleType):
            return len(ty.elems)
        return 1 if isinstance(ty, VecType) else 0

    worst = 0
    for strip in strip_loops(fn):
        loop = strip.loop
        live = sum(_regs(p.type) for p in loop.phis)
        defined: set = {id(p) for p in loop.phis}

        def _walk(block, defined):
            invariant = 0
            for ins in block.instrs:
                for a in ins.args:
                    if getattr(a, "type", None) is not None \
                            and id(a) not in defined \
                            and _regs(a.type):
                        invariant += _regs(a.type)
                        defined.add(id(a))   # count each value once
                if getattr(ins, "result", None) is not None:
                    defined.add(id(ins.result))
                for sub in ("cond", "body", "then", "els"):
                    b = getattr(ins, sub, None)
                    if b is not None:
                        for p in getattr(ins, "phis", ()):
                            defined.add(id(p))
                        invariant += _walk(b, defined)
                for r in getattr(ins, "results", ()) or ():
                    defined.add(id(r))
            return invariant

        live += _walk(loop.body, set(defined))
        worst = max(worst, live)
    return worst


def admissible_lmuls(kernel, target) -> Tuple[int, ...]:
    """LMUL candidates the register-pressure model admits for this
    kernel on ``target``'s register file (see
    :meth:`repro_torch.core.targets.Target.admissible_lmuls`)."""
    tgt = _targets.get_target(target)
    fn = kernel.fn if hasattr(kernel, "fn") else kernel
    return tgt.admissible_lmuls(width_scale(fn), live_vec_values(fn))


# ---------------------------------------------------------------------------
# The knob search
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TunedDecision:
    """One tuned configuration for a (kernel, target) pair.

    ``lmul`` replaces the target's fixed grouping via
    ``Target.with_lmul``; ``factor_cap``/``tail`` feed
    :func:`repro_torch.port.revec.retile`.  ``measured``/``static`` are the
    simulator's retired counts for the tuned and default configs (the
    evidence), ``predicted`` the calibrated estimate that ranked it.
    """

    lmul: int = 1
    factor_cap: Optional[int] = None
    tail: str = "auto"
    predicted: Optional[float] = None
    measured: Optional[int] = None
    static: Optional[int] = None

    @property
    def improvement(self) -> Optional[float]:
        """static/measured retired-count ratio (>1 = tuned wins)."""
        if not self.measured or not self.static:
            return None
        return self.static / self.measured

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TunedDecision":
        lmul = int(d["lmul"])
        if lmul not in (1, 2, 4, 8):
            raise ValueError(f"bad lmul {lmul}")
        tail = str(d.get("tail", "auto"))
        from .revec import TAIL_POLICIES
        if tail not in TAIL_POLICIES:
            raise ValueError(f"bad tail {tail!r}")
        cap = d.get("factor_cap")
        return cls(lmul=lmul,
                   factor_cap=None if cap is None else int(cap),
                   tail=tail,
                   predicted=d.get("predicted"),
                   measured=d.get("measured"),
                   static=d.get("static"))


def _sim_retired(kernel, args, tgt, factor_cap, tail):
    """(outputs, retired instruction count) of the emitted RVV stream
    under one knob configuration; raises CodegenError/SimError when the
    configuration cannot be emitted or executed."""
    from .. import rvv
    prog = rvv.emit(kernel, tgt, factor_cap=factor_cap, tail=tail)
    out, counts = rvv.run(prog, *args, with_counts=True)
    return out, int(counts["executed"])


def _same_outputs(a, b) -> bool:
    import numpy as np
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        if x.shape != y.shape:
            return False
        if np.issubdtype(x.dtype, np.floating) \
                or np.issubdtype(y.dtype, np.floating):
            if not np.allclose(x.astype(np.float64),
                               y.astype(np.float64),
                               rtol=1e-5, atol=1e-6):
                return False
        elif not np.array_equal(x, y):
            return False
    return True


def tune(kernel, args, target, calibration: Optional[CalibrationModel]
         = None, policy: str = "pallas") -> TunedDecision:
    """Search (LMUL, factor cap, tail policy) for ``kernel`` on
    ``target`` and return the winning :class:`TunedDecision`.

    Candidates come from the register-pressure model x the retile
    knobs; each is retiled and abstract-interpreted, ranked by the
    calibrated prediction, and the top :data:`_SIM_TOP_K` leaders are
    fact-checked on the simulator.  A configuration only wins if it
    (a) emits and executes, (b) produces outputs matching the static
    default's (floats to 1e-5/1e-6, everything else bitwise), and
    (c) retires no more instructions than the static default.  When
    nothing beats static, the static configuration itself is returned
    (with its measurement), so a cached decision is never worse than
    not tuning.
    """
    from .. import rvv
    from .interp import Machine
    from .revec import retile

    tgt = _targets.get_target(target)
    if not tgt.vla:
        raise ValueError(f"autotuning applies to rvv targets, "
                         f"not {tgt.name!r}")
    cal = calibration or CalibrationModel(factors={})

    # the static default: the target exactly as handed in
    try:
        static_out, static_retired = _sim_retired(kernel, args, tgt,
                                                  None, "auto")
    except (rvv.CodegenError, rvv.SimError) as e:
        raise PortError(f"static configuration does not simulate: {e}",
                        kernel=getattr(kernel, "name", "?"),
                        target=tgt.name, stage="autotune")

    # candidate knob grid
    natural = None
    cands: List[Tuple[int, Optional[int], str]] = []
    for m in admissible_lmuls(kernel, tgt):
        tgt_m = _targets.with_lmul(tgt, m)
        for tail in _SEARCH_TAILS:
            cands.append((m, None, tail))
        # one capped variant at this LMUL's natural factor / 2: less
        # remainder work when n barely fills the group
        res_probe = retile(kernel.fn, tgt_m)
        natural = res_probe.factor
        if natural and natural >= 4:
            cands.append((m, natural // 2, "auto"))

    scored: List[Tuple[float, Tuple[int, Optional[int], str]]] = []
    for (m, cap, tail) in cands:
        tgt_m = _targets.with_lmul(tgt, m)
        try:
            res = retile(kernel.fn, tgt_m, factor_cap=cap, tail=tail)
            est = Machine(res.fn, policy=policy, target=tgt_m,
                          abstract=True).run(*args)
        except Exception:
            continue
        scored.append((cal.predict(est["per_intrinsic"], m),
                       (m, cap, tail)))
    scored.sort(key=lambda s: (s[0], s[1][0]))

    best = TunedDecision(lmul=tgt.lmul, factor_cap=None, tail="auto",
                         measured=static_retired, static=static_retired)
    best_retired = static_retired
    for pred, (m, cap, tail) in scored[:_SIM_TOP_K]:
        if (m, cap, tail) == (tgt.lmul, None, "auto"):
            continue
        tgt_m = _targets.with_lmul(tgt, m)
        try:
            out, retired = _sim_retired(kernel, args, tgt_m, cap, tail)
        except (rvv.CodegenError, rvv.SimError):
            continue
        if not _same_outputs(out, static_out):
            continue    # conformance first: a fast wrong answer loses
        if retired < best_retired:
            best = TunedDecision(lmul=m, factor_cap=cap, tail=tail,
                                 predicted=pred, measured=retired,
                                 static=static_retired)
            best_retired = retired
    return best


# ---------------------------------------------------------------------------
# The persistent autotuning cache
# ---------------------------------------------------------------------------

def _ir_fingerprint(kernel) -> str:
    fn = kernel.fn if hasattr(kernel, "fn") else kernel
    return hashlib.sha256(fn.pretty().encode()).hexdigest()[:16]


def _target_key(tgt: _targets.Target) -> str:
    # resolved Target *values*, LMUL-independent: the tuned decision
    # chooses LMUL, so rvv-128 and rvv-128-m4 must share an entry
    return f"{tgt.kind}-v{tgt.vlen}-l{tgt.lane}"


class AutotuneCache:
    """On-disk JSON cache of tuned decisions (plus the calibration that
    produced them), next to the selection LRU in spirit: bounded
    surprise, typed failure.

    * **Keying** — ``<kernel name>:<IR sha256 prefix>@<kind-vlen-lane>``
      from resolved Target values; editing a kernel's source changes
      its fingerprint and orphans the stale decision (invalidation by
      construction).
    * **Corruption** — a missing file is a cold cache; an unreadable,
      truncated, or wrong-version file records a typed
      :class:`CacheCorruption` in :attr:`load_error`, serves static
      decisions (every ``get`` misses), and never raises on the read
      path unless constructed with ``strict=True``.
    * **Atomicity** — writes go through a temp file + ``os.replace``;
      a crashed writer can truncate nothing.
    * **Single-flight** — :meth:`tune_or_get` parks racers on a
      per-key event while one thread tunes, so a concurrent
      ``warmup()`` measures each (kernel, target) exactly once.
    """

    def __init__(self, path: Optional[str] = None,
                 strict: bool = False):
        self.path = path
        self._lock = threading.RLock()
        self._inflight: Dict[str, threading.Event] = {}
        self._entries: Dict[str, TunedDecision] = {}
        self._calibration: Optional[CalibrationModel] = None
        self.load_error: Optional[CacheCorruption] = None
        self._hits = 0
        self._misses = 0
        self._stores = 0
        if path is not None and os.path.exists(path):
            self._load(strict=strict)

    # -- persistence -------------------------------------------------------
    def _load(self, strict: bool = False) -> None:
        try:
            with open(self.path) as f:
                data = json.load(f)
            if not isinstance(data, dict):
                raise ValueError("cache root is not an object")
            if data.get("version") != CACHE_VERSION:
                raise ValueError(
                    f"cache version {data.get('version')!r} != "
                    f"{CACHE_VERSION}")
            entries = {str(k): TunedDecision.from_dict(v)
                       for k, v in data.get("entries", {}).items()}
            cal = data.get("calibration")
            calibration = (CalibrationModel.from_dict(cal)
                           if cal is not None else None)
        except Exception as e:
            err = CacheCorruption(
                f"autotune cache {self.path!r} is corrupt: {e}",
                stage="autotune")
            if strict:
                raise err
            # degrade to static: empty cache, typed record of why
            with self._lock:
                self.load_error = err
                self._entries = {}
                self._calibration = None
            return
        with self._lock:
            self.load_error = None
            self._entries = entries
            self._calibration = calibration

    def _persist(self) -> None:
        if self.path is None:
            return
        data = {"version": CACHE_VERSION,
                "entries": {k: d.to_dict()
                            for k, d in sorted(self._entries.items())},
                "calibration": (self._calibration.to_dict()
                                if self._calibration else None)}
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=1, sort_keys=True)
        os.replace(tmp, self.path)

    # -- decisions ---------------------------------------------------------
    @staticmethod
    def key(kernel, target) -> str:
        tgt = _targets.get_target(target)
        name = getattr(kernel, "name", None) or \
            getattr(getattr(kernel, "fn", None), "name", "?")
        return f"{name}:{_ir_fingerprint(kernel)}@{_target_key(tgt)}"

    def get(self, kernel, target) -> Optional[TunedDecision]:
        k = self.key(kernel, target)
        with self._lock:
            d = self._entries.get(k)
            if d is None:
                self._misses += 1
            else:
                self._hits += 1
            return d

    def put(self, kernel, target, decision: TunedDecision) -> None:
        k = self.key(kernel, target)
        with self._lock:
            self._entries[k] = decision
            self._stores += 1
            self._persist()

    @property
    def calibration(self) -> Optional[CalibrationModel]:
        with self._lock:
            return self._calibration

    def set_calibration(self, cal: Optional[CalibrationModel]) -> None:
        with self._lock:
            self._calibration = cal
            self._persist()

    # -- single-flight tuning ---------------------------------------------
    def tune_or_get(self, kernel, args, target,
                    calibration: Optional[CalibrationModel] = None,
                    policy: str = "pallas") -> TunedDecision:
        """Return the cached decision for (kernel, target) or tune one
        (single-flight: concurrent callers for the same key wait for
        the first tuner rather than re-measuring)."""
        k = self.key(kernel, target)
        while True:
            with self._lock:
                d = self._entries.get(k)
                if d is not None:
                    self._hits += 1
                    return d
                ev = self._inflight.get(k)
                if ev is None:
                    ev = threading.Event()
                    self._inflight[k] = ev
                    building = True
                else:
                    building = False
            if not building:
                ev.wait(timeout=600.0)
                continue
            try:
                cal = calibration or self.calibration
                d = tune(kernel, args, target, calibration=cal,
                         policy=policy)
            except BaseException:
                with self._lock:
                    self._inflight.pop(k, None)
                ev.set()
                raise
            with self._lock:
                self._entries[k] = d
                self._misses += 1
                self._stores += 1
                self._persist()
                self._inflight.pop(k, None)
            ev.set()
            return d

    # -- introspection -----------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"path": self.path, "entries": len(self._entries),
                    "hits": self._hits, "misses": self._misses,
                    "stores": self._stores,
                    "load_error": (str(self.load_error)
                                   if self.load_error else None),
                    "inflight": len(self._inflight)}

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._calibration = None
            self._hits = self._misses = self._stores = 0
            self._persist()


# ---------------------------------------------------------------------------
# Process-wide default cache (what compile(tuned=True) consults)
# ---------------------------------------------------------------------------

_cache_lock = threading.Lock()
_CACHE: Optional[AutotuneCache] = None


def cache() -> AutotuneCache:
    """The process-wide autotune cache.  Backed by the file named in
    ``$REPRO_TORCH_AUTOTUNE_CACHE`` when set, else in-memory only."""
    global _CACHE
    with _cache_lock:
        if _CACHE is None:
            _CACHE = AutotuneCache(os.environ.get(CACHE_ENV))
        return _CACHE


def set_cache_path(path: Optional[str],
                   strict: bool = False) -> AutotuneCache:
    """Point the process-wide cache at ``path`` (None = memory-only);
    returns the new cache."""
    global _CACHE
    with _cache_lock:
        _CACHE = AutotuneCache(path, strict=strict)
        return _CACHE


def reset_cache() -> None:
    """Drop the process-wide cache object (tests)."""
    global _CACHE
    with _cache_lock:
        _CACHE = None


def lookup(kernel, target) -> Optional[TunedDecision]:
    """The cached tuned decision for (kernel, target), or None.  Never
    raises — a broken cache means static behavior, not a failed
    compile."""
    try:
        return cache().get(kernel, target)
    except Exception:
        return None


def tune_corpus(items: Iterable[Tuple[Any, tuple]],
                targets: Sequence[str],
                calibration: Optional[CalibrationModel] = None,
                policy: str = "pallas",
                into: Optional[AutotuneCache] = None
                ) -> Dict[str, TunedDecision]:
    """Tune every (kernel, args) for every target, persisting into
    ``into`` (default: the process-wide cache).  Returns
    ``{cache key: decision}``."""
    c = into if into is not None else cache()
    if calibration is not None:
        c.set_calibration(calibration)
    out: Dict[str, TunedDecision] = {}
    for kernel, args in items:
        for t in targets:
            d = c.tune_or_get(kernel, args, t, calibration=calibration,
                              policy=policy)
            out[c.key(kernel, t)] = d
    return out
