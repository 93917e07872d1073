"""Resilience layer for the port pipeline: typed errors, the
degradation ladder, and the circuit breaker.

Every failure mode in the pipeline maps onto one taxonomy:

    PortError
      ParseError(SyntaxError)   tokenizing / parsing NEON C
      LowerError(TypeError)     AST -> typed SSA IR
      RevecVeto                 re-tiling refused or injected to refuse
      CompileError(RuntimeError)  tracing / jitting the IR
      CompileTimeout            transient-by-default compile deadline
      ExecError(RuntimeError)   interpreter execution
      SimError(RuntimeError)    RVV architectural simulator
      CacheCorruption           a compiled-cache entry failed validation
      DeadlineExceeded          per-request deadline passed
      LadderExhausted           every rung failed (carries the attempts)

Errors carry *provenance* — keyword facts (kernel, intrinsic, file,
line, col, target, stage, mnemonic, site, ...) rendered into ``str(e)``
as a ``file:line:col:`` prefix plus a ``[k=v ...]`` suffix — and a
``transient`` flag the retry machinery keys off.  Multiple inheritance
keeps the historical bases (``SyntaxError``/``TypeError``/
``RuntimeError``) so existing ``except`` clauses and tests keep
working unchanged.

The **degradation ladder** (:func:`run_resilient`) resolves a kernel
execution down three rungs —

    compiled+revec  ->  compiled (narrow)  ->  interpreter

— recording every attempt in a :class:`DegradationRecord`.  The ladder
contract: a lower rung may only trade *speed*, never *values*; each
rung is conformance-identical (tests/test_port_conformance.py), so a
degraded result is still a correct result.  A per-(kernel, target,
rung) circuit breaker quarantines a rung after ``K`` consecutive
failures so a poisoned kernel fails fast instead of stalling a slate.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "PortError", "ParseError", "LowerError", "RevecVeto", "CompileError",
    "CompileTimeout", "ExecError", "SimError", "CacheCorruption",
    "DeadlineExceeded", "LadderExhausted",
    "Attempt", "DegradationRecord", "CircuitBreaker",
    "run_resilient", "wrap_error", "degradation_records", "resilience_stats",
    "reset_resilience", "breaker", "RUNGS",
]

_PROV_POS = ("file", "line", "col")


class PortError(Exception):
    """Base of the port-pipeline error taxonomy.

    ``PortError("msg", kernel="vadd", line=3, col=7, stage="lower")``
    renders as ``<source>:3:7: msg [kernel=vadd stage=lower]``.
    """

    default_stage: Optional[str] = None

    def __init__(self, message: Any = "", **provenance: Any):
        self.transient = bool(provenance.pop("transient", False))
        self.provenance: Dict[str, Any] = {
            k: v for k, v in provenance.items() if v is not None}
        if self.default_stage is not None:
            self.provenance.setdefault("stage", self.default_stage)
        self.message = str(message)
        super().__init__(self.message)

    def add_context(self, **provenance: Any) -> "PortError":
        """Fill in provenance facts not already present; returns self."""
        for k, v in provenance.items():
            if v is not None and k not in self.provenance:
                self.provenance[k] = v
        return self

    # Convenience accessors used by reports and tests.
    @property
    def kernel(self):
        return self.provenance.get("kernel")

    @property
    def stage(self):
        return self.provenance.get("stage")

    @property
    def line(self):
        return self.provenance.get("line")

    def __str__(self) -> str:
        head = self.message
        line = self.provenance.get("line")
        if line is not None:
            fname = self.provenance.get("file") or "<source>"
            col = self.provenance.get("col")
            head = (f"{fname}:{line}:{col}: {head}" if col is not None
                    else f"{fname}:{line}: {head}")
        rest = {k: v for k, v in self.provenance.items()
                if k not in _PROV_POS}
        if rest:
            facts = " ".join(f"{k}={v}" for k, v in sorted(rest.items()))
            head = f"{head} [{facts}]"
        return head


class ParseError(PortError, SyntaxError):
    """Tokenizer / parser rejection of a NEON C source."""
    default_stage = "parse"


class LowerError(PortError, TypeError):
    """AST -> typed SSA IR lowering rejection."""
    default_stage = "lower"


class RevecVeto(PortError):
    """Re-tiling refused (structurally, or by injection)."""
    default_stage = "revec"


class CompileError(PortError, RuntimeError):
    """IR tracing / jitting failure."""
    default_stage = "compile"


class CompileTimeout(CompileError):
    """Compile exceeded its deadline; transient by default."""

    def __init__(self, message: Any = "", **provenance: Any):
        provenance.setdefault("transient", True)
        super().__init__(message, **provenance)


class ExecError(PortError, RuntimeError):
    """Interpreter execution failure."""
    default_stage = "execute"


class SimError(PortError, RuntimeError):
    """RVV architectural-simulator fault."""
    default_stage = "simulate"


class CacheCorruption(PortError, RuntimeError):
    """A compiled-cache hit failed validation against its key."""
    default_stage = "cache"


class DeadlineExceeded(PortError, RuntimeError):
    """Per-request deadline passed before a rung could finish."""
    default_stage = "serve"


class LadderExhausted(PortError, RuntimeError):
    """Every ladder rung failed; ``.attempts`` holds the trail."""
    default_stage = "resolve"

    def __init__(self, message: Any = "", attempts=None, **provenance: Any):
        super().__init__(message, **provenance)
        self.attempts: List["Attempt"] = list(attempts or ())


# ---------------------------------------------------------------------------
# degradation records
# ---------------------------------------------------------------------------

RUNGS = ("compiled+revec", "compiled", "interp")


@dataclasses.dataclass
class Attempt:
    """One rung tried (or skipped) while resolving a kernel run."""
    rung: str
    ok: bool = False
    skipped: bool = False          # quarantined by the breaker
    error: Optional[str] = None
    error_type: Optional[str] = None
    retries: int = 0               # transient retries consumed
    elapsed_ms: float = 0.0

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class DegradationRecord:
    """How one kernel execution resolved down the ladder."""
    kernel: str
    target: str
    requested: str                 # rung the caller asked for
    used: Optional[str] = None     # rung that produced the result
    attempts: List[Attempt] = dataclasses.field(default_factory=list)

    @property
    def degraded(self) -> bool:
        return self.used is not None and self.used != self.requested

    def to_dict(self) -> Dict[str, Any]:
        return {
            "kernel": self.kernel, "target": self.target,
            "requested": self.requested, "used": self.used,
            "degraded": self.degraded,
            "attempts": [a.to_dict() for a in self.attempts],
        }


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------

class CircuitBreaker:
    """Quarantines a (kernel, target, rung) after K consecutive failures.

    ``failure`` returns True when the key just opened.  A later
    ``success`` (after an explicit ``reset``) closes it again.
    """

    def __init__(self, threshold: int = 3):
        self.threshold = int(threshold)
        self._lock = threading.RLock()
        self._consecutive: Dict[Tuple, int] = {}
        self._open: set = set()

    def is_open(self, key: Tuple) -> bool:
        with self._lock:
            return key in self._open

    def failure(self, key: Tuple) -> bool:
        with self._lock:
            n = self._consecutive.get(key, 0) + 1
            self._consecutive[key] = n
            if n >= self.threshold and key not in self._open:
                self._open.add(key)
                return True
            return False

    def success(self, key: Tuple) -> None:
        with self._lock:
            self._consecutive.pop(key, None)
            self._open.discard(key)

    def open_keys(self) -> List[Tuple]:
        with self._lock:
            return sorted(self._open)

    def reset(self, key: Optional[Tuple] = None) -> None:
        with self._lock:
            if key is None:
                self._consecutive.clear()
                self._open.clear()
            else:
                self._consecutive.pop(key, None)
                self._open.discard(key)


# ---------------------------------------------------------------------------
# module state: records + counters + the process breaker
# ---------------------------------------------------------------------------

class _State:
    def __init__(self):
        self.lock = threading.RLock()
        self.records: collections.deque = collections.deque(maxlen=512)
        self.breaker = CircuitBreaker()
        self.counters: Dict[str, Any] = self._fresh_counters()

    @staticmethod
    def _fresh_counters() -> Dict[str, Any]:
        return {
            "runs": 0,
            "degraded": 0,
            "fallback_rungs": collections.Counter(),
            "transient_retries": 0,
            "exhausted": 0,
            "deadline_misses": 0,
            "breaker_trips": 0,
        }


_STATE = _State()


def breaker() -> CircuitBreaker:
    """The process-wide ladder circuit breaker."""
    return _STATE.breaker


def degradation_records(kernel: Optional[str] = None,
                        target: Optional[str] = None) -> List[Dict]:
    """Recent DegradationRecords (dicts), optionally filtered."""
    with _STATE.lock:
        recs = list(_STATE.records)
    out = []
    for r in recs:
        if kernel is not None and r.kernel != kernel:
            continue
        if target is not None and r.target != target:
            continue
        out.append(r.to_dict())
    return out


def resilience_stats() -> Dict[str, Any]:
    """Process-wide ladder counters + breaker state."""
    with _STATE.lock:
        c = _STATE.counters
        return {
            "runs": c["runs"],
            "degraded": c["degraded"],
            "fallback_rungs": dict(c["fallback_rungs"]),
            "transient_retries": c["transient_retries"],
            "exhausted": c["exhausted"],
            "deadline_misses": c["deadline_misses"],
            "breaker_trips": c["breaker_trips"],
            "breaker_open": ["/".join(map(str, k))
                             for k in _STATE.breaker.open_keys()],
            "records": len(_STATE.records),
        }


def reset_resilience() -> None:
    """Clear records, counters, and the breaker (tests / fresh deploys)."""
    with _STATE.lock:
        _STATE.records.clear()
        _STATE.counters = _State._fresh_counters()
        _STATE.breaker.reset()


def _bump(key: str, n: int = 1) -> None:
    with _STATE.lock:
        _STATE.counters[key] += n


def _bump_fallback(rung: str) -> None:
    with _STATE.lock:
        _STATE.counters["degraded"] += 1
        _STATE.counters["fallback_rungs"][rung] += 1


# ---------------------------------------------------------------------------
# the ladder
# ---------------------------------------------------------------------------

def wrap_error(exc: Exception, *, stage: str, kernel: str,
          target: str) -> PortError:
    """Coerce any exception into the taxonomy with provenance."""
    if isinstance(exc, PortError):
        return exc.add_context(kernel=kernel, target=target)
    cls = CompileError if stage in ("compile", "retile") else ExecError
    err = cls(f"{type(exc).__name__}: {exc}", kernel=kernel,
              target=target, stage=stage)
    err.__cause__ = exc
    return err


def run_resilient(kernel, *args,
                  target=None,
                  policy: str = "pallas",
                  revec: bool = True,
                  jit: bool = True,
                  deadline_s: Optional[float] = None,
                  compile_retries: int = 1,
                  breaker: Optional[CircuitBreaker] = None,
                  record: bool = True,
                  device=None):
    """Execute ``kernel`` down the degradation ladder.

    Returns ``(result, DegradationRecord)``.  The ladder tries
    ``compiled+revec`` (skipped when ``revec=False``), then narrow
    ``compiled``, then the interpreter.  Transient failures (e.g. a
    :class:`CompileTimeout`) are retried up to ``compile_retries``
    times on the same rung before falling through.  Rungs whose
    breaker is open are skipped without being attempted.  When every
    rung fails, raises :class:`LadderExhausted` (a typed
    :class:`PortError`) chaining the last rung error.

    Contract: any rung that succeeds returns conformance-identical
    values — the ladder may only trade speed, never values.  Every rung
    runs on ``device`` (default: the card); a compiled rung's failed
    graph capture is an error of that rung like any other, so it shows
    as a degraded record, never as a silent eager run.
    """
    from ..core import targets as _targets
    tgt = _targets.resolve_target(target)
    brk = breaker if breaker is not None else _STATE.breaker
    requested = "compiled+revec" if revec else "compiled"
    rungs = RUNGS[RUNGS.index(requested):]
    rec = DegradationRecord(kernel=kernel.fn.name, target=tgt.name,
                            requested=requested)
    t0 = time.monotonic()
    last_err: Optional[PortError] = None
    _bump("runs")

    def _finish(result, rung):
        rec.used = rung
        brk.success((rec.kernel, rec.target, rung))
        if rec.degraded:
            _bump_fallback(rung)
        if record:
            with _STATE.lock:
                _STATE.records.append(rec)
        return result, rec

    for rung in rungs:
        key = (rec.kernel, rec.target, rung)
        if brk.is_open(key):
            rec.attempts.append(Attempt(
                rung, skipped=True, error="quarantined (circuit open)",
                error_type="CircuitOpen"))
            continue
        if deadline_s is not None and time.monotonic() - t0 >= deadline_s:
            _bump("deadline_misses")
            err = DeadlineExceeded(
                f"deadline of {deadline_s}s passed before rung "
                f"{rung!r}", kernel=rec.kernel, target=rec.target)
            rec.attempts.append(Attempt(
                rung, error=str(err), error_type="DeadlineExceeded"))
            if record:
                with _STATE.lock:
                    _STATE.records.append(rec)
            raise err
        attempt = Attempt(rung)
        ta = time.monotonic()
        while True:
            try:
                if rung == "interp":
                    out = kernel(*args, policy=policy, target=tgt,
                                 device=device)
                else:
                    ck = kernel.compile(target=tgt, policy=policy,
                                        revec=(rung == "compiled+revec"),
                                        jit=jit, device=device)
                    out = ck(*args)
                attempt.ok = True
                attempt.elapsed_ms = (time.monotonic() - ta) * 1e3
                rec.attempts.append(attempt)
                return _finish(out, rung)
            except Exception as exc:        # noqa: BLE001 — ladder seam
                stage = "execute" if rung == "interp" else "compile"
                err = wrap_error(exc, stage=stage, kernel=rec.kernel,
                            target=rec.target)
                if err.transient and attempt.retries < compile_retries:
                    attempt.retries += 1
                    _bump("transient_retries")
                    continue
                attempt.elapsed_ms = (time.monotonic() - ta) * 1e3
                attempt.error = str(err)
                attempt.error_type = type(err).__name__
                rec.attempts.append(attempt)
                if brk.failure(key):
                    _bump("breaker_trips")
                last_err = err
                break

    _bump("exhausted")
    if record:
        with _STATE.lock:
            _STATE.records.append(rec)
    exhausted = LadderExhausted(
        "every ladder rung failed or was quarantined",
        attempts=rec.attempts, kernel=rec.kernel, target=rec.target)
    exhausted.__cause__ = last_err
    raise exhausted
