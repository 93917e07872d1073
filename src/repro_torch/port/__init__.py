"""repro_torch.port — the NEON-source migration frontend.

The paper's primary task is *automated migration* of legacy NEON
intrinsic code: SIMDe ingests real C kernels and maps their types and
functions onto the target's vector architecture.  This package is that
frontend for the port's logical ISA (``repro_torch.core.isa``):

    C NEON kernel --cparse--> AST --lower--> typed SSA IR
        --intrinsics--> logical-ISA calls --interp--> registry.dispatch
                                                (cost-driven selection)
    typed SSA IR --revec--> re-tiled IR --compile--> one CUDA graph per
                                                call signature

``compile_kernel`` turns source into a callable that executes on torch
tensors, on the card unless told otherwise; ``report`` emits the paper's
§4 analysis tables (per-intrinsic substitution/tier/instruction-count
across the RVV width family, with the re-tiled, simulated and ladder
columns on request).

    >>> from repro_torch import port
    >>> k = port.compile_file("examples/neon_corpus/vadd.c")
    >>> out = k(n, a, b, out_buf)                    # runs on the card
    >>> out = k(n, a, b, out_buf, device="cpu")      # or on the CPU
    >>> ck = k.compile(target="rvv-1024", revec=True)
    >>> out = ck(n, a, b, out_buf)                   # replays a CUDA graph
    >>> out, rec = k.run_resilient(n, a, b, out_buf, target="h100")
    >>> rep = port.report(k, n, a, b, out_buf)       # migration report

The JIT backend is ``compile`` (:mod:`repro_torch.port.compile`): the
whole kernel is walked once per call signature and, on the card, captured
in one CUDA graph that later calls replay; ``revec`` re-tiles the strip
loops at an RVV target's VLEN x LMUL first.  Compiled kernels live in a
process-wide LRU (:func:`compiled_cache_info`) keyed on the device too.
``autotune`` calibrates the cost models against the RVV simulator and
tunes LMUL and the retile knobs per (kernel, target); ``compile(tuned=True)``
applies the cached decision.
"""
from __future__ import annotations

import collections
import os
import threading
from typing import Dict, Optional

from . import cparse, faultinject, intrinsics, interp, ir, lower, revec
from . import resilience
from .compile import compile_fn
from .cparse import ParseError, parse
from .interp import ExecError, Machine
from .intrinsics import UnknownIntrinsic, resolve
from .ir import TFunction
from .lower import LowerError, lower_function
from .report import PORT_SWEEP, format_report
from .report import report as _report
from .resilience import (
    CacheCorruption, CompileError, CompileTimeout, DeadlineExceeded,
    DegradationRecord, LadderExhausted, PortError, RevecVeto, SimError,
    degradation_records, resilience_stats, reset_resilience,
    run_resilient,
)
from .revec import RetileResult, retile

__all__ = [
    "PortedKernel", "CompiledKernel", "compile_kernel", "compile_file",
    "load_corpus", "report", "format_report", "PORT_SWEEP",
    "parse", "lower_function", "resolve", "retile", "compile_fn",
    "Machine", "compiled_cache_info", "set_compiled_cache_capacity",
    "compiled_cache_clear",
    "ParseError", "LowerError", "ExecError", "UnknownIntrinsic",
    "CompileError", "RetileResult",
    # resilience layer
    "PortError", "RevecVeto", "SimError", "CompileTimeout",
    "CacheCorruption", "DeadlineExceeded", "LadderExhausted",
    "DegradationRecord", "run_resilient", "degradation_records",
    "resilience_stats", "reset_resilience", "resilience", "faultinject",
    "autotune",
]


class _CompiledKernelCache:
    """Process-wide bounded LRU of :class:`CompiledKernel` instances.

    Every compiled variant of a ported kernel holds its recorded lowering
    selections and, on the card, one CUDA graph per call signature with
    its memory pool — dropping them on the floor per PortedKernel
    instance makes a long-lived serving process grow without bound as
    targets and revec/jit variants accumulate.  This mirrors the selection
    LRU in :mod:`repro_torch.core.registry`: OrderedDict recency order,
    hit/miss/eviction counters, a settable capacity, and keys built from
    the *resolved* Target value (a frozen dataclass) — an ad-hoc Target
    sharing a registered name must not collide, and ``target=None``
    under two different ``use_target`` scopes must not alias.  The key
    also holds the resolved device, so an entry built for the CPU never
    serves a call on the card (and the reverse).

    Eviction only forgets the cache's reference: holders of an evicted
    CompiledKernel keep a working callable; the next ``compile`` call
    for that key re-traces (and its graphs are freed with the last
    holder).

    Concurrency: all bookkeeping runs under one RLock, and builds are
    *single-flight* — the first thread to miss a key traces it (outside
    the lock; compilation is slow and reentrant) while racers park on a
    per-key Event and pick up the stored result, so a concurrent
    ``warmup`` compiles each variant exactly once (graph capture is
    thread-local, so one thread's capture never trips another's work).
    Every hit is validated against its key (kernel identity, target,
    policy, revec/jit flags, device); a corrupted entry is dropped,
    counted, and transparently recompiled instead of being served.
    """

    DEFAULT_CAPACITY = 256

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._cache: "collections.OrderedDict" = collections.OrderedDict()
        self._lock = threading.RLock()
        self._inflight: Dict[tuple, threading.Event] = {}
        self._capacity = int(capacity)
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        self._corruptions = 0

    @staticmethod
    def _validate(key, hit) -> bool:
        return (isinstance(hit, CompiledKernel)
                and not getattr(hit, "_corrupted", False)
                and hit.source_kernel is key[0]
                and hit.target == key[1]
                and hit.policy == key[2]
                and bool(hit.revec) == key[3]
                and bool(getattr(hit, "jit", key[4])) == key[4]
                and getattr(hit, "factor_cap", None) == key[5]
                and getattr(hit, "tail", "auto") == key[6]
                and getattr(hit, "device", None) == key[7])

    def get(self, kernel: "PortedKernel", *, target=None,
            policy: Optional[str] = "pallas", revec: bool = False,
            jit: bool = True, factor_cap: Optional[int] = None,
            tail: str = "auto", device=None) -> "CompiledKernel":
        from ..core import targets as _targets
        tgt = _targets.resolve_target(target)
        dev = _targets.resolve_device("cuda" if device is None else device)
        # PortedKernel hashes by identity; keeping it in the key also
        # keeps it alive for as long as its compiled variants are cached.
        # The retile knobs (factor_cap, tail) are part of the key: two
        # tuned variants of one (kernel, target) are distinct
        # executables and must not alias.
        key = (kernel, tgt, policy, bool(revec), bool(jit),
               factor_cap, tail, dev)
        while True:
            with self._lock:
                hit = self._cache.get(key)
                if hit is not None:
                    hit = faultinject.corrupt_value(
                        "cache.entry", hit, kernel=kernel.fn.name,
                        target=tgt.name)
                    if self._validate(key, hit):
                        self._hits += 1
                        self._cache.move_to_end(key)
                        return hit
                    # Poisoned entry: never serve it — drop, count,
                    # and fall through to a fresh build.
                    self._corruptions += 1
                    self._cache.pop(key, None)
                ev = self._inflight.get(key)
                if ev is None:
                    ev = threading.Event()
                    self._inflight[key] = ev
                    building = True
                else:
                    building = False
            if not building:
                # Another thread is tracing this key; wait and re-check.
                # If its build raised, the loop elects a new building thread.
                ev.wait(timeout=300.0)
                continue
            try:
                compiled = CompiledKernel(kernel, target=tgt,
                                          policy=policy, revec=revec,
                                          jit=jit, factor_cap=factor_cap,
                                          tail=tail, device=dev)
            except BaseException:
                with self._lock:
                    self._inflight.pop(key, None)
                ev.set()
                raise
            with self._lock:
                self._misses += 1
                self._cache[key] = compiled
                while len(self._cache) > self._capacity:
                    self._cache.popitem(last=False)
                    self._evictions += 1
                self._inflight.pop(key, None)
            ev.set()
            return compiled

    def cache_info(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self._hits, "misses": self._misses,
                    "size": len(self._cache), "capacity": self._capacity,
                    "evictions": self._evictions,
                    "corruptions": self._corruptions,
                    "inflight": len(self._inflight)}

    def set_capacity(self, n: int) -> None:
        if n < 1:
            raise ValueError(f"capacity must be >= 1, got {n}")
        with self._lock:
            self._capacity = int(n)
            while len(self._cache) > self._capacity:
                self._cache.popitem(last=False)
                self._evictions += 1

    def clear(self) -> None:
        with self._lock:
            self._cache.clear()
            self._hits = self._misses = self._evictions = 0
            self._corruptions = 0


_COMPILED_CACHE = _CompiledKernelCache()


def compiled_cache_info() -> Dict[str, int]:
    """Counters for the process-wide CompiledKernel LRU:
    hits/misses/size/capacity/evictions."""
    return _COMPILED_CACHE.cache_info()


def set_compiled_cache_capacity(n: int) -> None:
    """Bound the process-wide CompiledKernel cache (evicts LRU-first
    immediately if already over)."""
    _COMPILED_CACHE.set_capacity(n)


def compiled_cache_clear() -> None:
    """Drop all cached CompiledKernels and reset the counters."""
    _COMPILED_CACHE.clear()


class PortedKernel:
    """A NEON kernel compiled onto the logical ISA.

    Calling it runs the kernel: pass one Python value per C parameter in
    order — ints for ``size_t``/scalar params, 1-D arrays or tensors for
    pointer params.  The return value is the final contents of the
    written-to buffer(s) (functional out-params), as tensors on
    ``device`` (default: the card).
    """

    def __init__(self, fn: TFunction):
        self.fn = fn

    @property
    def name(self) -> str:
        return self.fn.name

    @property
    def param_names(self):
        return [p.hint for p in self.fn.params]

    def __call__(self, *args, policy: Optional[str] = "pallas",
                 target=None, device=None):
        return Machine(self.fn, policy=policy, target=target,
                       device=device).run(*args)

    def estimate(self, *args, policy: Optional[str] = "pallas",
                 target=None) -> Dict:
        """Estimated dynamic vector-instruction counts for these example
        args: abstract interpretation — scalar control flow runs, every
        vector issue becomes a selection-cache cost lookup."""
        return Machine(self.fn, policy=policy, target=target,
                       abstract=True).run(*args)

    # -- the JIT backend ---------------------------------------------------
    def retile(self, target, *, factor_cap: Optional[int] = None,
               tail: str = "auto") -> RetileResult:
        """Re-tile this kernel's strip loops at ``target``'s effective
        register width (VLEN x LMUL) — see :mod:`repro_torch.port.revec`."""
        return retile(self.fn, target, factor_cap=factor_cap, tail=tail)

    def compile(self, *, target=None, policy: Optional[str] = "pallas",
                revec: bool = False, jit: bool = True,
                tuned: bool = False, factor_cap: Optional[int] = None,
                tail: str = "auto", device=None) -> "CompiledKernel":
        """Compile to one callable: on the card, one CUDA graph per call
        signature instead of one Python dispatch per strip iteration
        (:mod:`repro_torch.port.compile`).

        With ``revec=True`` the IR is first re-tiled at ``target``'s
        VLEN x LMUL, so a 128-bit NEON strip runs at the full register
        group width with a predicated tail.  ``target=None`` resolves to
        the ambient thread-scoped target *now* — the lowering selections
        are recorded in the compiled kernel, so the resolved machine is
        pinned into it (and the cache key), not re-read per call.
        ``device=None`` is the card, as for calling the kernel.

        Results come from the process-wide bounded LRU (see
        :func:`compiled_cache_info`), keyed on this kernel plus the
        resolved Target *value*, the retile knobs and the device.

        ``tuned=True`` consults the persisted autotuning cache
        (:mod:`repro_torch.port.autotune`): when a tuned decision exists
        for this kernel on the resolved target, its LMUL regrouping
        (``Target.with_lmul``) and retile knobs (factor cap, tail
        policy) are applied; without one the static default compiles
        unchanged.  Explicit ``factor_cap``/``tail`` arguments override
        the cached decision.
        """
        from ..core import targets as _targets
        tgt = _targets.resolve_target(target)
        if tuned and revec and tgt.vla:
            from . import autotune as _autotune
            d = _autotune.lookup(self, tgt)
            if d is not None:
                tgt = _targets.with_lmul(tgt, d.lmul)
                if factor_cap is None:
                    factor_cap = d.factor_cap
                if tail == "auto":
                    tail = d.tail
        return _COMPILED_CACHE.get(self, target=tgt, policy=policy,
                                   revec=revec, jit=jit,
                                   factor_cap=factor_cap, tail=tail,
                                   device=device)

    def run_resilient(self, *args, target=None,
                      policy: Optional[str] = "pallas", revec: bool = True,
                      jit: bool = True, deadline_s: Optional[float] = None,
                      compile_retries: int = 1, device=None):
        """Execute down the degradation ladder (compiled+revec ->
        compiled -> interpreter); returns ``(result,
        DegradationRecord)``.  See :func:`repro_torch.port.resilience.
        run_resilient` for the contract: rungs may only trade speed,
        never values."""
        return run_resilient(self, *args, target=target, policy=policy,
                             revec=revec, jit=jit, deadline_s=deadline_s,
                             compile_retries=compile_retries,
                             device=device)

    def substitution(self, target) -> Dict[str, bool]:
        """Table 2 for this kernel: per intrinsic, does its fixed-width
        register map natively onto ``target`` (``vlen >= width``)?"""
        from ..core import targets as _targets
        tgt = _targets.get_target(target)
        return {ins.attrs["intrinsic"]:
                tgt.supports_width(ins.attrs["width_bits"])
                for ins in self.fn.intrinsic_sites()}

    def pretty(self) -> str:
        return self.fn.pretty()

    def __repr__(self):
        return (f"PortedKernel({self.name!r}, params="
                f"{self.param_names}, writes={self.fn.writes})")


class CompiledKernel:
    """A ported kernel compiled to one callable per call signature (a
    CUDA graph on the card).

    ``revec=True`` re-tiles the strip loops at the target's effective
    width first; ``retiling`` then reports what the re-vectorizer did
    (factor, masked tails, per-loop notes).  Calling convention matches
    :class:`PortedKernel`; outputs are tensors on ``device``.
    ``last_call`` says whether the latest call replayed a graph and how
    many scalars it read to the host.
    """

    def __init__(self, kernel: PortedKernel, *, target=None,
                 policy: Optional[str] = "pallas", revec: bool = False,
                 jit: bool = True, factor_cap: Optional[int] = None,
                 tail: str = "auto", device=None):
        from ..core import targets as _targets
        self.source_kernel = kernel
        self.target = _targets.resolve_target(target)
        self.device = _targets.resolve_device(
            "cuda" if device is None else device)
        self.policy = policy
        self.revec = revec
        self.jit = jit
        self.factor_cap = factor_cap
        self.tail = tail
        self.retiling: Optional[RetileResult] = None
        fn = kernel.fn
        if revec:
            self.retiling = retile(fn, self.target,
                                   factor_cap=factor_cap, tail=tail)
            fn = self.retiling.fn
        self.fn = fn
        self._call = compile_fn(fn, policy=policy, target=self.target,
                                jit=jit, device=self.device)

    @property
    def name(self) -> str:
        return self.fn.name

    @property
    def last_call(self) -> Dict:
        return getattr(self._call, "last_call", {})

    def __call__(self, *args):
        return self._call(*args)

    def batched(self):
        """A :class:`~repro_torch.port.compile.BatchedFn` of the IR this
        kernel runs (re-tiled where it is): a bucket of requests as one
        walk, on the card one CUDA graph a bucket."""
        from .compile import BatchedFn
        return BatchedFn(self.fn, policy=self.policy, target=self.target,
                         device=self.device)

    def estimate(self, *args) -> Dict:
        """Abstract dynamic-instruction estimate of the (possibly
        re-tiled) IR this compiled kernel executes."""
        return Machine(self.fn, policy=self.policy, target=self.target,
                       abstract=True).run(*args)

    def __repr__(self):
        rv = ""
        if self.retiling is not None:
            rv = (f", revec={self.retiling.factor}x"
                  f"/{self.retiling.retiled} strips")
        return (f"CompiledKernel({self.name!r}, "
                f"target={self.target.name}, device={self.device}{rv})")


def compile_kernel(source: str, name: Optional[str] = None,
                   filename: Optional[str] = None) -> PortedKernel:
    """Parse + type + translate one kernel from C source.

    ``name`` selects a function when the translation unit defines
    several (default: the only one, or error).  ``filename`` feeds the
    ``file:line:col`` provenance on ParseError/LowerError.
    """
    fns = parse(source, filename=filename)
    if not fns:
        raise ParseError("no function definition found", file=filename)
    if name is None:
        if len(fns) > 1:
            raise ParseError(
                f"source defines {[f.name for f in fns]}; pass name=",
                file=filename)
        fdef = fns[0]
    else:
        try:
            fdef = next(f for f in fns if f.name == name)
        except StopIteration:
            raise ParseError(f"no function {name!r} in source "
                             f"(found {[f.name for f in fns]})",
                             file=filename)
    return PortedKernel(lower_function(fdef, source=source,
                                       filename=filename))


def compile_file(path: str, name: Optional[str] = None) -> PortedKernel:
    with open(path) as f:
        return compile_kernel(f.read(), name=name, filename=path)


def load_corpus(dirpath: str) -> Dict[str, PortedKernel]:
    """Compile every ``.c`` file in a corpus directory (sorted)."""
    out: Dict[str, PortedKernel] = {}
    for fname in sorted(os.listdir(dirpath)):
        if fname.endswith(".c"):
            k = compile_file(os.path.join(dirpath, fname))
            out[k.name] = k
    return out


def report(kernel, *example_args, **kw) -> Dict:
    """Migration report; accepts a PortedKernel or raw C source."""
    if isinstance(kernel, str):
        kernel = compile_kernel(kernel)
    return _report(kernel, *example_args, **kw)


# imported last: autotune consults PortedKernel/CompiledKernel machinery
from . import autotune  # noqa: E402
