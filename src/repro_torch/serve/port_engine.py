"""serve.port_engine — batched, bucketed serving tier for compiled ported
kernels.

A migrated NEON kernel compiled through :meth:`PortedKernel.compile`
answers one request per call: one graph replay for one ``n``.  A serving
process sees thousands of small independent requests — vadd over a few
hundred elements, a qs8 dot-product per feature row — and per-request
launch overhead dominates.  This engine batches them:

* **one walk a bucket** — requests for the same (kernel, target) run as
  one :class:`~repro_torch.port.compile.BatchedFn` call: every pointer
  param becomes a ``(B, L)`` buffer and every scalar param a ``(B,)``
  vector.  Loops run to the bucket's envelope with each row masked past
  its own trip count, so on the card one CUDA graph serves every request
  of a bucket whatever its ``n``.

* **geometric shape buckets** — buffer lengths are padded up to per-bucket
  canonical shapes (``BucketPolicy``: base x growth^k) and the batch axis
  is padded to a fixed ``max_batch`` with inert ``n = 0`` rows, so the
  program count is bounded by buckets x targets x kernels per engine.
  Padding is legal for the same reason the re-vectorizer's masked tails
  are: trip counts derive from the *actual* per-row ``n``, so padded
  regions are never read into results and never written; outputs are
  sliced back to request length.

* **shape model from the IR** — how long must a padded buffer be for a
  given ``n``?  The strip-loop matcher
  (:func:`repro_torch.port.revec.strip_loops`) already proves each
  pointer's affine walk; ``ptr_step / step`` is its element stride per
  unit ``n``.  Buffers the strip does not walk (the length-1 ``sum``
  output of a dot kernel, packed weights) keep their exact length and
  join the group key instead.

* **compile reuse** — all compilation goes through the process-wide
  bounded CompiledKernel LRU (:func:`repro_torch.port.compiled_cache_info`)
  with ``jit=False``, as the JAX package's engine does; the batched
  program is built from that CompiledKernel's (re-tiled) IR and cached on
  the engine per (kernel, target).  :meth:`PortEngine.warmup`
  pre-populates the LRU from a corpus, the deploy-time shape probe.

Mixed fleets route per request: ``Request(target="rvv-1024")`` overrides
the engine default, so rvv-128 and rvv-1024 traffic batch side by side in
one :meth:`submit` call (grouped separately).  Results are tensors on the
engine's device (default: the card), each a row's slice of a column
cloned out of the graph.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import targets as _targets
from ..port import PortedKernel, revec
from ..port import faultinject as _fi
from ..port import resilience as _resilience
from ..port.ir import PtrType, ScalarType
from ..port.resilience import DeadlineExceeded, LadderExhausted, PortError

__all__ = ["BucketPolicy", "Request", "PortEngine"]


@dataclasses.dataclass(frozen=True)
class BucketPolicy:
    """Geometric length buckets: ``base * growth^k`` for k = 0, 1, ...

    Finer buckets waste less padding per request but admit more shapes
    (more graphs); coarser buckets bound captures harder at higher
    padding waste.  ``bucket(n)`` returns the smallest bucket holding
    ``n``.
    """

    name: str
    base: int = 64
    growth: int = 2

    def bucket(self, n: int) -> int:
        n = max(1, int(n))
        b = self.base
        while b < n:
            b *= self.growth
        return b

    @staticmethod
    def preset(name: str) -> "BucketPolicy":
        try:
            return _BUCKET_PRESETS[name]
        except KeyError:
            raise KeyError(f"unknown bucket policy {name!r}; "
                           f"known: {sorted(_BUCKET_PRESETS)}")


_BUCKET_PRESETS = {
    "fine": BucketPolicy("fine", base=64, growth=2),
    "coarse": BucketPolicy("coarse", base=64, growth=4),
}


@dataclasses.dataclass
class Request:
    """One kernel invocation: args follow the PortedKernel calling
    convention (ints for scalar params, 1-D arrays or tensors for
    pointers).  ``target=None`` uses the engine's default target.

    ``deadline_s`` is a per-request budget in seconds, measured from
    :meth:`PortEngine.submit` entry: a request whose deadline has
    passed before its chunk launches (or before per-row recovery work
    starts) resolves to a typed :class:`DeadlineExceeded` instead of
    consuming more engine time."""

    kernel: PortedKernel
    args: Sequence[Any]
    target: Any = None
    deadline_s: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class _ShapeModel:
    """Per-kernel padding rules derived from the strip-loop IR.

    ``strides[i]`` is the element stride per unit ``n`` for pointer
    param ``i`` (padded length = bucket(n) * stride); pointer params
    absent from ``strides`` keep their exact length in the group key.
    ``counter`` is the scalar param index driving the strip (None when
    no strip loop matched — every buffer then keys on exact length and
    batching still works, just without length bucketing).
    """

    counter: Optional[int]
    strides: Tuple[Tuple[int, int], ...]

    @staticmethod
    def derive(kernel: PortedKernel) -> "_ShapeModel":
        fn = kernel.fn
        pindex = {p: i for i, p in enumerate(fn.params)}
        counter: Optional[int] = None
        strides: Dict[int, int] = {}
        for info in revec.strip_loops(fn):
            loop = info.loop
            init = loop.init[loop.phis.index(info.counter)]
            ci = pindex.get(init)
            if ci is None or not isinstance(fn.params[ci].type, ScalarType):
                continue
            if counter is None:
                counter = ci
            elif counter != ci:
                continue            # second strip on a different counter
            for pphi, d in info.ptr_steps.items():
                pinit = loop.init[loop.phis.index(pphi)]
                pi = pindex.get(pinit)
                if pi is None or d <= 0 or d % info.step != 0:
                    continue
                strides.setdefault(pi, d // info.step)
        return _ShapeModel(counter, tuple(sorted(strides.items())))


def _length(a) -> int:
    return a.shape[0] if isinstance(a, torch.Tensor) else len(a)


class PortEngine:
    """Batched, bucketed, cache-managed serving of ported kernels.

    Hardened for mixed production slates: engine state is guarded by an
    RLock; batched-program failures degrade to per-row recovery down the
    ladder (:func:`repro_torch.port.resilience.run_resilient` — compiled
    narrow, then the interpreter, conformance-identical results); a
    failing request resolves to its typed :class:`PortError` in the
    results list (``on_error="return"``, the default) instead of
    aborting the slate; compile attempts retry ``compile_retries`` times
    on transient errors and share the process-wide circuit breaker, so a
    persistently poisoned (kernel, target) is quarantined and fails fast
    without stalling its batch-mates.  A kernel whose loaded data steers
    its control cannot batch: its batched program raises a typed
    CompileError and its rows take the same per-row path.
    """

    def __init__(self, *, target: Any = None, policy: str = "pallas",
                 revec: bool = True, bucket_policy: Any = "fine",
                 max_batch: int = 32, compile_retries: int = 1,
                 on_error: str = "return", tuned: bool = False,
                 device=None):
        self.target = target            # engine default; per-request override
        self.policy = policy
        self.revec = bool(revec)
        # consult the persisted autotuning cache on every compile: a
        # deploy that ran (or shipped) a tuning pass starts with the
        # tuned LMUL regrouping + retile knobs instead of the static
        # defaults (repro_torch.port.autotune)
        self.tuned = bool(tuned)
        self.bucket_policy = (BucketPolicy.preset(bucket_policy)
                              if isinstance(bucket_policy, str)
                              else bucket_policy)
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if on_error not in ("return", "raise"):
            raise ValueError(f"on_error must be 'return' or 'raise', "
                             f"got {on_error!r}")
        self.max_batch = int(max_batch)
        self.compile_retries = int(compile_retries)
        self.on_error = on_error
        self.device = _targets.resolve_device(
            "cuda" if device is None else device)
        self._lock = threading.RLock()
        self._models: Dict[int, _ShapeModel] = {}
        self._programs: Dict[Tuple[int, Any], Any] = {}
        self._shapes_seen: set = set()
        self._stats = {"requests": 0, "batches": 0, "inert_rows": 0,
                       "padded_elems": 0, "payload_elems": 0,
                       "batch_faults": 0, "row_fallbacks": 0,
                       "errors_returned": 0, "deadline_misses": 0,
                       "program_fallbacks": 0}

    def _bump(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._stats[key] += n

    # -- shape model -------------------------------------------------------

    def _model(self, kernel: PortedKernel) -> _ShapeModel:
        with self._lock:
            m = self._models.get(id(kernel))
            if m is None:
                m = self._models[id(kernel)] = _ShapeModel.derive(kernel)
            return m

    def _plan(self, req: Request):
        """Group key + padded buffer lengths for one request."""
        kernel, args = req.kernel, req.args
        if len(args) != len(kernel.fn.params):
            raise ValueError(
                f"{kernel.name} takes {len(kernel.fn.params)} args, "
                f"got {len(args)}")
        tgt = _targets.resolve_target(
            req.target if req.target is not None else self.target)
        model = self._model(kernel)
        strides = dict(model.strides)
        bucket = 0
        if model.counter is not None:
            # the bucket must hold both the request's n and every
            # strip-walked buffer the caller handed us (a buffer longer
            # than n*stride promotes the bucket so padding never
            # truncates untouched caller bytes)
            need = int(args[model.counter])
            for pi, s in strides.items():
                need = max(need, math.ceil(_length(args[pi]) / s))
            bucket = self.bucket_policy.bucket(need)
        lens = []
        for i, p in enumerate(kernel.fn.params):
            if not isinstance(p.type, PtrType):
                lens.append(None)
            elif i in strides:
                lens.append(bucket * strides[i])
            else:
                lens.append(_length(args[i]))
        # exact-length (non-strip) buffers join the key so every row in
        # a group shares one canonical shape tuple
        extras = tuple(lens[i] for i, p in enumerate(kernel.fn.params)
                       if isinstance(p.type, PtrType) and i not in strides)
        key = (id(kernel), tgt, bucket, extras)
        return key, tgt, lens

    # -- batch programs ----------------------------------------------------

    def _program(self, kernel: PortedKernel, tgt):
        """The batched program for (kernel, target).

        Compiles down the batched rungs (revec first, then narrow) with
        bounded transient retry and the process-wide breaker: a rung
        whose breaker is open is skipped without an attempt, and a
        success closes it again.  Raises a typed :class:`PortError`
        only when every batched rung is out — the caller then degrades
        to per-row recovery."""
        pk = (id(kernel), tgt)
        with self._lock:
            prog = self._programs.get(pk)
        if prog is not None:
            return prog
        brk = _resilience.breaker()
        rungs = (["compiled+revec", "compiled"] if self.revec
                 else ["compiled"])
        last_err: Optional[PortError] = None
        for rung in rungs:
            bkey = (kernel.fn.name, tgt.name, rung)
            if brk.is_open(bkey):
                continue
            retries = 0
            while True:
                try:
                    # jit=False from the process-wide LRU, as the
                    # reference engine compiles; the batched program
                    # walks that CompiledKernel's IR and captures its own
                    # graphs, one a bucket
                    ck = kernel.compile(
                        target=tgt, policy=self.policy,
                        revec=(rung == "compiled+revec"), jit=False,
                        tuned=self.tuned, device=self.device)
                    prog = ck.batched()
                except Exception as exc:    # noqa: BLE001 — serve seam
                    err = _resilience.wrap_error(
                        exc, stage="compile", kernel=kernel.fn.name,
                        target=tgt.name)
                    if err.transient and retries < self.compile_retries:
                        retries += 1
                        continue
                    brk.failure(bkey)
                    last_err = err
                    break
                brk.success(bkey)
                with self._lock:
                    self._programs[pk] = prog
                    if rung != rungs[0]:
                        self._stats["program_fallbacks"] += 1
                return prog
        if last_err is not None:
            raise last_err
        raise LadderExhausted(
            "every batched compile rung is quarantined",
            kernel=kernel.fn.name, target=tgt.name)

    # -- serving -----------------------------------------------------------

    def submit(self, requests: Sequence[Request]) -> List[Any]:
        """Run a slate of requests; returns results in request order,
        each what calling the compiled kernel directly would return (one
        tensor, or a tuple for multi-output kernels).

        A request that cannot be served — its deadline passed, or every
        ladder rung failed — resolves to its typed :class:`PortError`
        in the results list (``on_error="return"``); the rest of the
        slate is unaffected."""
        t0 = time.monotonic()
        groups: Dict[Any, List[int]] = {}
        plans = []
        for idx, req in enumerate(requests):
            key, tgt, lens = self._plan(req)
            plans.append((key, tgt, lens))
            groups.setdefault(key, []).append(idx)
        results: List[Any] = [None] * len(requests)
        for key, members in groups.items():
            for lo in range(0, len(members), self.max_batch):
                chunk = members[lo:lo + self.max_batch]
                self._run_chunk(requests, plans, chunk, results, t0)
        self._bump("requests", len(requests))
        return results

    def __call__(self, requests: Sequence[Request]) -> List[Any]:
        return self.submit(requests)

    def _deadline_missed(self, req: Request, t0: float) -> bool:
        return (req.deadline_s is not None and
                time.monotonic() - t0 >= req.deadline_s)

    def _column(self, rows, L: int):
        """``(B, L)`` zero-padded buffer of the chunk's rows on the
        engine's device (one host-to-device copy for host rows)."""
        B = self.max_batch
        if all(isinstance(a, torch.Tensor) for a in rows):
            col = torch.zeros((B, L), dtype=rows[0].dtype,
                              device=self.device)
            for r, a in enumerate(rows):
                col[r, :a.shape[0]] = a
            return col
        first = np.asarray(rows[0])
        col = np.zeros((B, L), dtype=first.dtype)
        for r, a in enumerate(rows):
            a = a.cpu().numpy() if isinstance(a, torch.Tensor) else \
                np.asarray(a)
            col[r, :len(a)] = a
        return torch.from_numpy(col).to(self.device)

    def _run_chunk(self, requests, plans, chunk, results, t0):
        # Expired requests resolve before any compile/launch work; they
        # never hold up their batch-mates.
        live = []
        for idx in chunk:
            if self._deadline_missed(requests[idx], t0):
                self._bump("deadline_misses")
                err = DeadlineExceeded(
                    f"deadline of {requests[idx].deadline_s}s passed "
                    f"before the batch launched",
                    kernel=requests[idx].kernel.fn.name)
                results[idx] = self._resolve_error(err)
            else:
                live.append(idx)
        chunk = live
        if not chunk:
            return
        req0 = requests[chunk[0]]
        kernel = req0.kernel
        key, tgt, lens = plans[chunk[0]]
        model = self._model(kernel)
        params = kernel.fn.params
        B = self.max_batch

        cols = []
        for i, p in enumerate(params):
            if isinstance(p.type, PtrType):
                cols.append(self._column(
                    [requests[idx].args[i] for idx in chunk], lens[i]))
            else:
                vals = [requests[idx].args[i] for idx in chunk]
                # inert padding rows: n = 0 makes every trip count zero,
                # so the zero buffers are never touched
                pad_val = 0 if i == model.counter else (
                    vals[0] if vals else 0)
                cols.append(np.asarray(vals + [pad_val] * (B - len(chunk))))
        # the strip counter's range is the whole bucket: one graph serves
        # every n the bucket holds
        bounds = {} if model.counter is None else {model.counter: key[2]}

        shape_sig = (id(kernel), tgt, tuple(lens))
        with self._lock:
            self._shapes_seen.add(shape_sig)
            self._stats["batches"] += 1
            self._stats["inert_rows"] += B - len(chunk)

        try:
            _fi.fault_point("engine.batch", kernel=kernel.fn.name,
                            target=tgt.name)
            outs = self._program(kernel, tgt)(*cols, bounds=bounds)
        except Exception as exc:    # noqa: BLE001 — degrade, never corrupt
            self._bump("batch_faults")
            err = _resilience.wrap_error(
                exc, stage="execute", kernel=kernel.fn.name,
                target=tgt.name)
            self._fallback_rows(requests, chunk, tgt, results, t0, err)
            return
        writes = kernel.fn.writes
        out_params = [i for i, p in enumerate(params)
                      if isinstance(p.type, PtrType) and p.hint in writes]
        for r, idx in enumerate(chunk):
            per_req = []
            for oi, pi in zip(range(len(writes)), out_params):
                orig_len = _length(requests[idx].args[pi])
                per_req.append(outs[oi][r, :orig_len])
                self._bump("payload_elems", orig_len)
                self._bump("padded_elems", outs[oi].shape[1])
            results[idx] = (per_req[0] if len(per_req) == 1
                            else tuple(per_req))

    def _fallback_rows(self, requests, chunk, tgt, results, t0, batch_err):
        """Per-row recovery when the batched program is unavailable: each
        live request descends the full degradation ladder on its own
        (conformance-identical output, just slower).  A row whose ladder
        also exhausts resolves to its typed error."""
        for idx in chunk:
            req = requests[idx]
            if self._deadline_missed(req, t0):
                self._bump("deadline_misses")
                err = DeadlineExceeded(
                    f"deadline of {req.deadline_s}s passed during "
                    f"batch-fault recovery", kernel=req.kernel.fn.name)
                err.__cause__ = batch_err
                results[idx] = self._resolve_error(err)
                continue
            remaining = None
            if req.deadline_s is not None:
                remaining = max(0.0, req.deadline_s -
                                (time.monotonic() - t0))
            try:
                out, _rec = _resilience.run_resilient(
                    req.kernel, *req.args, target=tgt, policy=self.policy,
                    revec=self.revec, jit=False, deadline_s=remaining,
                    compile_retries=self.compile_retries,
                    device=self.device)
            except PortError as err:
                results[idx] = self._resolve_error(err)
                continue
            self._bump("row_fallbacks")
            results[idx] = out

    def _resolve_error(self, err: PortError):
        self._bump("errors_returned")
        if self.on_error == "raise":
            raise err
        return err

    # -- deploy hooks ------------------------------------------------------

    def warmup(self, corpus, targets: Sequence[Any] = ()) -> Dict[str, int]:
        """Pre-populate the compile cache for a deploy: ``jit=False``
        compiles of every corpus kernel for every target — the cheap
        pass that burns in re-tiling without capturing graphs up front.

        ``corpus`` is a dict (name -> PortedKernel, as returned by
        :func:`repro_torch.port.load_corpus`) or an iterable of kernels;
        ``targets`` defaults to the engine's own target.  On a
        ``tuned=True`` engine every warmup compile consults the persisted
        autotuning cache.
        """
        kernels = (corpus.values() if isinstance(corpus, dict) else corpus)
        kernels = list(kernels)
        tgts = [_targets.resolve_target(t) for t in targets] or \
               [_targets.resolve_target(self.target)]
        n = 0
        for k in kernels:
            self._model(k)          # derive the padding rules up front
            for t in tgts:
                k.compile(target=t, policy=self.policy, revec=self.revec,
                          jit=False, tuned=self.tuned, device=self.device)
                n += 1
        return {"kernels": len(kernels), "targets": len(tgts),
                "compiles": n}

    # -- observability -----------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """Serving counters.  ``batch_programs`` counts distinct
        (kernel, target, canonical shape) signatures, bounded by
        buckets x targets x kernels; ``graphs`` the CUDA graphs the
        engine's programs have captured (0 off the card)."""
        from .. import port as _port
        with self._lock:
            s = dict(self._stats)
            s["batch_programs"] = len(self._shapes_seen)
            s["graphs"] = sum(p.graphs for p in self._programs.values())
        s["pad_overhead"] = (
            0.0 if s["payload_elems"] == 0
            else s["padded_elems"] / s["payload_elems"] - 1.0)
        s["compile_cache"] = _port.compiled_cache_info()
        s["resilience"] = {
            "batch_faults": s["batch_faults"],
            "row_fallbacks": s["row_fallbacks"],
            "errors_returned": s["errors_returned"],
            "deadline_misses": s["deadline_misses"],
            "program_fallbacks": s["program_fallbacks"],
            "breaker_open": [list(k) for k in
                             _resilience.breaker().open_keys()],
            "ladder": _resilience.resilience_stats(),
        }
        return s

    def cache_info(self) -> Dict[str, int]:
        """The process-wide CompiledKernel LRU counters (shared across
        engines — see :func:`repro_torch.port.compiled_cache_info`)."""
        from .. import port as _port
        return _port.compiled_cache_info()
