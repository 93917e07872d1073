"""Compile ported-kernel IR into one callable: on the card, one CUDA graph
per call signature.

The interpreter (:mod:`repro_torch.port.interp`) issues one Python
dispatch per intrinsic and reads every data-derived scalar back to the
host.  This backend walks the whole typed SSA function once per call
signature and, on a CUDA device, captures that walk in one
``torch.cuda.CUDAGraph``; later calls copy their buffers into the graph's
static inputs, replay it and clone the written buffers out.  The walk
mirrors the JAX package's ``repro.port.compile`` (one jaxpr per shape):

* **host: all scalar control.**  A counted loop runs a closed-form trip
  count derived from its condition (``phi + c <op> bound`` with a
  constant integer step, :func:`~repro_torch.port.revec.loop_condition`)
  and is unrolled into the walk; a loop without one raises
  :class:`CompileError` where the reference raises.  Pointer offsets are
  affine in host counters and stay host integers, so every isa op keeps
  its host-side clamp, wrap and drop addressing.
* **device: every data-derived scalar** (``sload``, ``get_lane``,
  ``reduce``) stays a 0-d tensor, held as float64, int64 or bool so that
  scalar arithmetic on it gives the interpreter's Python-number results
  bit for bit.  An ``if`` on such a condition runs both arms and merges
  their yields and written buffers with ``torch.where`` (the values
  ``lax.cond`` gives).  A data-derived scalar that reaches a trip count,
  an offset or a pointer is read to the host and counted
  (``host_reads``); that call signature then runs without a graph, every
  call dispatching afresh.
* **lowerings are picked once.**  The first call of a signature issues
  every intrinsic through ``REGISTRY`` (the cost-driven selector, counted
  by ``trace.count``) and records the chosen lowering in issue order;
  every later walk of the signature, the capture included, calls the
  recorded lowerings directly.  No registry lookup, ``.item()`` or
  host-to-device copy runs under capture (``isa.full``/``lane_scalar``
  are fill kernels).

``jit=True`` on a CUDA device captures (after the first, eager walk on a
side stream); on the CPU, or with ``jit=False``, the same walk runs
eagerly on every call.  ``torch.compile`` is not used: the unrolled strip
loops would give FX graphs of 10^4-10^5 nodes.

:class:`BatchedFn` walks the same IR over a bucket of requests at once —
``(B, L)`` buffers, per-row scalars, loops unrolled to a host envelope
with each row masked past its own trip count — so that on the card one
graph serves a whole bucket (the serving engine,
:mod:`repro_torch.serve.port_engine`).
"""
from __future__ import annotations

import collections
import contextlib
import gc
import itertools
import threading
import warnings
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core import isa
from ..core import targets as _targets
from ..core import trace as _trace
from ..core.registry import REGISTRY
from ..core.targets import resolve_device
from ..core.vtypes import numpy_dtype, torch_dtype
from . import faultinject as _fi
from .interp import _as_np_index, _sbin, _scast, _scmp
from .ir import IfOp, Instr, Loop, PtrType, ScalarType, TFunction, Value
from .resilience import CompileError
from .revec import loop_affine, loop_condition

__all__ = ["CompileError", "compile_fn", "CompiledFn", "BatchedFn",
           "envelope"]

# call signatures kept per compiled function (each may hold a CUDA graph)
SIGNATURES = 32

_STORES = ("store", "store_masked", "store2", "store2_masked")


def compile_fn(fn: TFunction, *, policy: Optional[str] = "pallas",
               target=None, jit: bool = True, device=None) -> "CompiledFn":
    """Build a callable executing ``fn`` as one walk per call signature.

    Same calling convention as the interpreter: one value per C param
    (ints for scalars, 1-D arrays or tensors for pointers); returns the
    written buffer(s) as tensors on ``device`` (default: the card).  With
    ``jit=True`` on a CUDA device the first call per signature (buffer
    shapes and dtypes plus the scalar arguments' values) captures a CUDA
    graph and every call replays it.
    """
    tgt = _targets.get_target(target) if target is not None else None
    _fi.fault_point("compile.trace", kernel=fn.name,
                    target=getattr(tgt, "name", None))
    return CompiledFn(fn, policy=policy, target=tgt, jit=jit,
                      device=resolve_device("cuda" if device is None
                                            else device))


class _Plan:
    """One call signature: its recorded lowerings and, on the card, its
    graph with static inputs and outputs."""

    def __init__(self, tape, host_reads: int, issues: int):
        self.tape = tape              # None: data steers control
        self.host_reads = host_reads
        self.issues = issues
        self.graph = None
        self.static_in: List[torch.Tensor] = []
        self.static_out: List[torch.Tensor] = []


class CompiledFn:
    """The callable :func:`compile_fn` returns.  ``last_call`` describes
    the latest call: whether its signature replays a graph, the host reads
    it made and the intrinsic issues of one walk."""

    def __init__(self, fn: TFunction, *, policy, target, jit: bool,
                 device: torch.device):
        self.fn = fn
        self.policy = policy
        self.target = target
        self.jit = jit
        self.device = device
        self.__name__ = f"compiled_{fn.name}"
        self._plans: "collections.OrderedDict" = collections.OrderedDict()
        self._lock = threading.Lock()
        self.last_call: Dict[str, Any] = {}

    @property
    def _graphs(self) -> bool:
        return self.jit and self.device.type == "cuda"

    def __call__(self, *args):
        _fi.fault_point("compile.run", kernel=self.fn.name,
                        target=getattr(self.target, "name", None))
        inputs, reads, key = self._inputs(args)
        with self._lock:
            plan = self._plans.get(key)
            if plan is None:
                outs, plan = self._first(inputs)
                reads += plan.host_reads
                self._plans[key] = plan
                while len(self._plans) > SIGNATURES:
                    self._plans.popitem(last=False)
            else:
                self._plans.move_to_end(key)
                outs, reads_now = self._again(plan, inputs)
                reads += reads_now
        self.last_call = {"captured": plan.graph is not None,
                          "host_reads": reads if plan.graph is None
                          else 0, "issues": plan.issues}
        return outs[0] if len(outs) == 1 else tuple(outs)

    # -- arguments ----------------------------------------------------------
    def _inputs(self, args):
        params = self.fn.params
        if len(args) != len(params):
            raise CompileError(
                f"{self.fn.name} takes {len(params)} args "
                f"({', '.join(p.hint for p in params)}), got {len(args)}",
                kernel=self.fn.name)
        inputs, key, reads = [], [], 0
        for p, a in zip(params, args):
            if isinstance(p.type, PtrType):
                t = a.to(self.device) if isinstance(a, torch.Tensor) else \
                    torch.as_tensor(np.asarray(a), device=self.device)
                if t.dim() != 1:
                    raise CompileError(f"pointer param {p.hint!r} wants "
                                       f"a 1-D buffer", kernel=self.fn.name)
                inputs.append(t)
                key.append((tuple(t.shape), t.dtype))
            else:
                if isinstance(a, torch.Tensor):
                    reads += 1
                    a = isa.host_value(a)
                elif not isinstance(a, (int, float, bool)):
                    a = np.asarray(a).item()
                inputs.append(a)
                key.append((type(a), a))
        return inputs, reads, tuple(key)

    # -- the walks ----------------------------------------------------------
    def _walk(self, tape=None) -> "_Walk":
        return _Walk(self.fn, self.policy, self.target, self.device, tape)

    def _first(self, inputs):
        """Walk once through the registry, then capture where allowed."""
        walk = self._walk()
        outs = _warm(self.device, lambda: walk.run(inputs)) \
            if self._graphs else walk.run(inputs)
        plan = _Plan(walk.recorded if walk.host_reads == 0 else None,
                     walk.host_reads, walk.issues)
        if self._graphs and plan.tape is not None:
            plan.static_in = [t.clone() if isinstance(t, torch.Tensor)
                              else t for t in inputs]
            cap = self._walk(plan.tape)
            plan.graph, plan.static_out = _capture(
                self.device, lambda: cap.run(plan.static_in), self.fn.name,
                self.target)
            if cap.host_reads:
                raise CompileError(f"{self.fn.name}: the capture read "
                                   f"{cap.host_reads} scalars to the host",
                                   kernel=self.fn.name)
            outs = _replay(plan, inputs)
        return outs, plan

    def _again(self, plan: _Plan, inputs):
        if plan.graph is not None:
            return _replay(plan, inputs), 0
        walk = self._walk(plan.tape)
        return walk.run(inputs), walk.host_reads


def _warm(device, run):
    """``run()`` on a side stream (a first walk before a capture)."""
    side = torch.cuda.Stream(device)
    main = torch.cuda.current_stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        outs = run()
    main.wait_stream(side)
    for t in outs:
        t.record_stream(main)
    return outs


def _capture(device, run, name: str, target):
    """Capture ``run()`` in a CUDA graph: ``(graph, its outputs)``."""
    graph = torch.cuda.CUDAGraph()
    try:
        with _CAPTURE_LOCK, warnings.catch_warnings(), _gc_paused():
            # a signature that launches nothing (n = 0 with no store)
            # captures an empty graph, which replays as a no-op
            warnings.filterwarnings("ignore", "The CUDA Graph is empty")
            with torch.cuda.graph(graph, stream=_capture_stream(device),
                                  capture_error_mode="thread_local"):
                outs = run()
    except CompileError:
        raise
    except Exception as e:   # noqa: BLE001 — any capture failure
        raise CompileError(f"{name}: CUDA graph capture failed: {e}",
                           kernel=name,
                           target=getattr(target, "name", None)) from e
    return graph, outs


def _replay(plan, inputs):
    for s, t in zip(plan.static_in, inputs):
        if isinstance(s, torch.Tensor):
            s.copy_(t)
    plan.graph.replay()
    return [t.clone() for t in plan.static_out]


_STREAMS: Dict[int, "torch.cuda.Stream"] = {}
# one capture at a time in the process (they share a capture stream);
# other threads' eager walks go on meanwhile: capture is thread-local
_CAPTURE_LOCK = threading.Lock()


@contextlib.contextmanager
def _gc_paused():
    """Python's cyclic collector off for a capture: a collection there
    could free an unreachable plan's CUDA graph, and destroying a graph
    is not permitted while a stream captures (it invalidates the
    capture)."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _STREAMS:
        _STREAMS[idx] = torch.cuda.Stream(idx)
    return _STREAMS[idx]


# ---------------------------------------------------------------------------
# one walk of the IR
# ---------------------------------------------------------------------------

class _Walk:
    """One walk over concrete buffers; pointers are (buffer name, host
    offset), data-derived scalars 0-d tensors."""

    def __init__(self, fn: TFunction, policy, target, device, tape=None):
        self.fn = fn
        self.policy = policy
        self.target = target
        self.device = device
        self.tape = tape
        self.pos = 0
        self.recorded: list = []
        self.memory: Dict[str, torch.Tensor] = {}
        self.host_reads = 0
        self.issues = 0
        self._forms: Dict[int, tuple] = {}

    def issue(self, isa_op: str, *args, site=None):
        """One intrinsic: chosen by the registry on a first walk, the
        recorded lowering on a later one."""
        self.issues += 1
        if self.tape is None:
            low, cost = REGISTRY._select_entry(isa_op, args, {},
                                               self.policy, self.target)
            _trace.record(low, *args, cost=cost)
            self.recorded.append(low)
        else:
            if self.pos >= len(self.tape) or \
                    self.tape[self.pos].op != isa_op:
                raise CompileError(f"{self.fn.name}: the walk left its "
                                   f"recorded lowerings at issue "
                                   f"{self.pos} ({isa_op})",
                                   kernel=self.fn.name)
            low = self.tape[self.pos]
            self.pos += 1
        return low.fn(*args)

    def host(self, x):
        """A host value for control: a device scalar is read (counted)."""
        if isinstance(x, torch.Tensor):
            self.host_reads += 1
            return isa.host_value(x)
        return x

    def index(self, x) -> int:
        return int(self.host(x))

    # -- the hooks the batched walk overrides ----------------------------
    def offset(self, x):
        return self.index(x)

    def select_ptr(self, c, a, b):
        """``c ? a : b`` over pointers: control, read to the host."""
        return a if self.host(c) else b

    @staticmethod
    def load_scalar(t, off):
        return t[isa.static_index(off, t.shape[0])]

    @staticmethod
    def store_scalar(t, off, v):
        return isa.store_scalar(t, off, v)

    # -- entry ------------------------------------------------------------
    def run(self, inputs):
        env: Dict[Value, Any] = {}
        for p, a in zip(self.fn.params, inputs):
            if isinstance(p.type, PtrType):
                self.memory[p.hint] = a
                env[p] = (p.hint, 0)
            else:
                env[p] = a
        self.block(self.fn.body, env)
        return [self.memory[p.hint] for p in self.fn.params
                if p.hint in self.fn.writes]

    # -- regions ----------------------------------------------------------
    def block(self, b, env):
        for ins in b.instrs:
            if isinstance(ins, Loop):
                self.loop(ins, env)
            elif isinstance(ins, IfOp):
                self.if_op(ins, env)
            else:
                self.instr(ins, env)

    def loop(self, ins: Loop, env):
        carried = [env[v] for v in ins.init]
        for _ in range(self._trip_count(ins, env)):
            env.update(zip(ins.phis, carried))
            self.block(ins.body, env)
            carried = [env[y] for y in ins.yields]
        env.update(zip(ins.results, carried))

    def _trip_count(self, ins: Loop, env):
        """The reference's closed form (``compile.py`` ``_trip_count``)
        over host integers."""
        return _loop_trips(self.fn.name, ins, env, self.trip_operand,
                           self._forms)

    def trip_operand(self, x):
        return self.index(x)

    def if_op(self, ins: IfOp, env):  # noqa: C901
        cond = env[ins.cond_value]
        if not isinstance(cond, torch.Tensor):
            arm, ys = (ins.then, ins.then_yields) if cond else \
                (ins.els, ins.els_yields)
            self.block(arm, env)
            env.update(zip(ins.results, [env[y] for y in ys]))
            return
        # a device condition: both arms run, their values are merged
        before = dict(self.memory)
        arms = []
        for block, ys in ((ins.then, ins.then_yields),
                          (ins.els, ins.els_yields)):
            self.memory = dict(before)
            inner = dict(env)
            self.block(block, inner)
            arms.append(([inner[y] for y in ys], self.memory))
        (tv, tmem), (ev, emem) = arms
        c = _truth(cond)
        if any(_is_ptr(a) and a != b for a, b in zip(tv, ev)):
            # arms that leave a pointer in different places: control
            take = bool(self.host(c))
            vals, self.memory = (tv, tmem) if take else (ev, emem)
            env.update(zip(ins.results, vals))
            return
        self.memory = {name: buf if emem[name] is buf else
                       isa.where(c, buf, emem[name])
                       for name, buf in tmem.items()}
        env.update(zip(ins.results, [self._merge(c, a, b)
                                     for a, b in zip(tv, ev)]))

    def _merge(self, c, a, b):
        if _is_ptr(a) or (_static(a, b) and not isinstance(a, tuple)
                          and a == b and type(a) is type(b)):
            return a
        if isinstance(a, tuple):          # a register struct
            return tuple(self._merge(c, x, y) for x, y in zip(a, b))
        if isinstance(a, torch.Tensor) and a.dim() > 0:
            return isa.where(c, a, b)
        return _dwhere(c, a, b, self.device)

    # -- straight-line instructions ----------------------------------------
    def instr(self, ins: Instr, env):  # noqa: C901
        op = ins.op
        if op == "const":
            env[ins.result] = ins.attrs["value"]
        elif op == "sbin":
            a, b = env[ins.args[0]], env[ins.args[1]]
            env[ins.result] = _sbin(ins.attrs["op"], a, b) \
                if _static(a, b) else _dsbin(ins.attrs["op"], a, b,
                                             self.device)
        elif op == "scmp":
            a, b = env[ins.args[0]], env[ins.args[1]]
            env[ins.result] = _scmp(ins.attrs["op"], a, b) \
                if _static(a, b) else _dscmp(ins.attrs["op"], a, b,
                                             self.device)
        elif op == "sneg":
            v = env[ins.args[0]]
            env[ins.result] = -v if _static(v) else torch.neg(_num(v))
        elif op == "snot":
            v = env[ins.args[0]]
            env[ins.result] = (not v) if _static(v) else \
                torch.logical_not(v)
        elif op == "sinv":
            v = env[ins.args[0]]
            env[ins.result] = ~int(v) if _static(v) else \
                torch.bitwise_not(_int(v))
        elif op == "sselect":
            c, a, b = (env[v] for v in ins.args)
            if isinstance(c, torch.Tensor) and (_is_ptr(a) or _is_ptr(b)):
                env[ins.result] = self.select_ptr(_truth(c), a, b)
            elif not isinstance(c, torch.Tensor):
                env[ins.result] = a if c else b
            else:
                env[ins.result] = _dwhere(_truth(c), a, b, self.device)
        elif op == "scast":
            v = env[ins.args[0]]
            dt = ins.result.type.dtype
            env[ins.result] = _scast(v, dt) if _static(v) else \
                _dscast(v, dt)
        elif op == "ptradd":
            buf, off = env[ins.args[0]]
            env[ins.result] = (buf, off + self.offset(env[ins.args[1]]))
        elif op == "ptrcast":
            env[ins.result] = env[ins.args[0]]
        elif op == "sload":
            buf, off = env[ins.args[0]]
            env[ins.result] = _scalar(self.load_scalar(self.memory[buf],
                                                       off))
        elif op == "sstore":
            buf, off = env[ins.args[0]]
            t = self.memory[buf]
            v = env[ins.args[1]]
            if _static(v):
                # the value as the lane type holds it (numpy conversion)
                v = np.asarray(v).astype(numpy_dtype(t.dtype)).item()
            else:
                v = isa.astype(v, t.dtype)
            self.memory[buf] = self.store_scalar(t, off, v)
        elif op == "intrin":
            self.intrin(ins, env)
        else:
            raise CompileError(f"unknown IR op {op!r}")

    # -- intrinsic issue ----------------------------------------------------
    def intrin(self, ins: Instr, env):  # noqa: C901
        kind = ins.attrs["kind"]
        isa_op = ins.attrs["isa_op"]
        rty = ins.result.type if ins.result is not None else None

        if kind == "tuple_undef":
            env[ins.result] = tuple(isa.full((e.lanes,), 0, e.dtype,
                                             self.device)
                                    for e in rty.elems)
            return
        if kind == "tuple_get":
            env[ins.result] = env[ins.args[0]][ins.attrs["index"]]
            return
        if kind == "tuple_set":
            t = list(env[ins.args[0]])
            t[ins.attrs["index"]] = env[ins.args[1]]
            env[ins.result] = tuple(t)
            return
        if kind == "get_lane":
            vec, lane = env[ins.args[0]], self.index(env[ins.args[1]])
            env[ins.result] = _scalar(vec[isa.static_index(
                lane, vec.shape[0])])
            return

        def mem(i):
            buf, off = env[ins.args[i]]
            return self.memory[buf], _as_np_index(off)

        def cnt(i):
            return _as_np_index(self.index(env[ins.args[i]]))

        fill = ins.attrs.get("fill", 0)
        if kind == "vv":
            args = [env[v] for v in ins.args]
        elif kind == "dup":
            x = env[ins.args[0]]
            x = isa.lane_scalar(numpy_dtype(rty.dtype).type(x).item(),
                                rty.dtype, self.device) if _static(x) \
                else isa.astype(x, rty.dtype)
            args = [x, (rty.lanes,)]
        elif kind in ("load", "load2"):
            args = [*mem(0), rty.lanes]
        elif kind == "load_dup":
            t, off = mem(0)
            # the one lane as a 0-d device tensor: no host read
            args = [t[isa.static_index(int(off), t.shape[0])],
                    (rty.lanes,)]
        elif kind in ("load_masked", "load2_masked"):
            args = [*mem(0), rty.lanes, cnt(1), fill]
        elif kind == "load_group":
            args = [*mem(0), ins.attrs["reps"], ins.attrs["groups"]]
        elif kind == "load_group_masked":
            args = [*mem(0), ins.attrs["reps"], ins.attrs["groups"],
                    cnt(1), fill]
        elif kind == "fold":
            args = [env[ins.args[0]], ins.attrs["factor"]]
        elif kind == "store":
            args = [*mem(0), env[ins.args[1]]]
        elif kind == "store_masked":
            args = [*mem(0), env[ins.args[1]], cnt(2)]
        elif kind == "store2":
            args = [*mem(0), *env[ins.args[1]]]
        elif kind == "store2_masked":
            args = [*mem(0), *env[ins.args[1]], cnt(2)]
        elif kind == "tile":
            args = [env[ins.args[0]], ins.attrs["reps"]]
        elif kind == "shift":
            args = [env[ins.args[0]], self.index(env[ins.args[1]])]
        elif kind == "ext":
            args = [env[ins.args[0]], env[ins.args[1]],
                    self.index(env[ins.args[2]])]
        elif kind == "reduce":
            args = [env[ins.args[0]]]
        elif kind in ("cvt", "reinterpret"):
            args = [env[ins.args[0]], torch_dtype(rty.dtype)]
        elif kind == "vv_cvt":
            args = [env[v] for v in ins.args] + [torch_dtype(rty.dtype)]
        else:
            raise CompileError(f"unknown intrinsic kind {kind!r}")

        out = self.issue(isa_op, *args, site=ins)
        if kind in _STORES:
            self.memory[env[ins.args[0]][0]] = out
        elif kind == "reduce":
            env[ins.result] = _scalar(out)
        else:
            env[ins.result] = _typed(out, rty)


# ---------------------------------------------------------------------------
# the batched walk: a bucket of requests, one graph
# ---------------------------------------------------------------------------
#
# A serving engine answers many small requests of one kernel at once.  The
# batched walk takes ``(B, L)`` buffers, one padded row per request, and a
# ``(B,)`` vector per scalar param, and gives every row what a direct call
# on that row's buffers gives:
#
# * a loop whose trip count differs per row runs to a host bound, the
#   *envelope*: the largest count any row of the bucket can need, found on
#   the host by walking only the scalar control for every value the
#   steering scalars can take (the strip counter up to the bucket, the
#   others up to the chunk's largest).  Iteration ``it`` is live in the
#   rows with ``it < trips``; a loop-carried value keeps its old value in
#   the others (``torch.where``), and stores drop their rows.  An affine
#   phi (a counter, a pointer) is ``init + it * step`` inside the loop and
#   ``init + trips * step`` after it, so offsets inside a strip stay host
#   integers and only what follows a ragged loop addresses per row.
# * a branch on a per-row condition runs both arms with their rows live.
# * the lowering of every intrinsic site is chosen once, by the registry
#   on the per-row shapes, and reused by every later walk; the memory ops
#   run their lowering's batched form (``isa.BATCHED_MEMORY``), which keeps
#   each op's clamp, wrap and drop rules per row against the padded ``L``.
#
# Data that steers control (a host read in the unbatched walk) cannot be
# batched: the batched walk raises CompileError and the engine serves those
# rows one at a time.

# assignments the envelope may enumerate before the bucket is refused
ENVELOPE_LIMIT = 1 << 16


class _Opaque:
    """A scalar the control walk does not know: loaded data (``params``
    empty) or a function of the scalar params ``params``."""

    __slots__ = ("params",)

    def __init__(self, params=frozenset()):
        self.params = frozenset(params)


_DATA = _Opaque()


def _opaque(*xs) -> Optional[_Opaque]:
    """The _Opaque that ``xs`` together make, or None if all are known."""
    found = [x for x in xs if isinstance(x, _Opaque)]
    if not found:
        return None
    if any(not o.params for o in found):
        return _DATA
    return _Opaque(frozenset().union(*(o.params for o in found)))


class _Steered(Exception):
    """Scalar params ``params`` reach a trip count."""

    def __init__(self, params):
        super().__init__(sorted(params))
        self.params = params


def _advance(v, k, device):
    """An affine phi ``v`` after ``k`` steps of one (``k`` may be a
    per-row tensor)."""
    if _is_ptr(v):
        off = v[1]
        return (v[0], off if isinstance(off, _Opaque) else off + k)
    if isinstance(v, _Opaque):
        return v
    if _static(v, k):
        return v + k
    return _dsbin("+", v, k, device)


def _has_loop(block) -> bool:
    for ins in block.instrs:
        if isinstance(ins, Loop):
            return True
        if isinstance(ins, IfOp) and (_has_loop(ins.then) or
                                      _has_loop(ins.els)):
            return True
    return False


class _ControlWalk:
    """The scalar control of ``fn`` under one assignment of its scalar
    params, recording the largest trip count each loop instance (a loop at
    one unrolled position) has had.  Vectors and loaded data are opaque."""

    def __init__(self, fn: TFunction):
        self.fn = fn
        self.trips: Dict[tuple, int] = {}
        self._forms: Dict[int, tuple] = {}
        self._steps: Dict[int, dict] = {}
        self._flat: Dict[int, bool] = {}

    def run(self, values):
        env: Dict[Value, Any] = {}
        for p, v in zip(self.fn.params, values):
            env[p] = (p.hint, 0) if isinstance(p.type, PtrType) else v
        self.block(self.fn.body, env, ())

    def block(self, b, env, path):
        for ins in b.instrs:
            if isinstance(ins, Loop):
                self.loop(ins, env, path)
            elif isinstance(ins, IfOp):
                self.if_op(ins, env, path)
            else:
                self.instr(ins, env)

    def _operand(self, x):
        if isinstance(x, _Opaque):
            if x.params:
                raise _Steered(x.params)
            raise CompileError(f"{self.fn.name}: loaded data steers a "
                               f"loop; the kernel does not batch",
                               kernel=self.fn.name)
        return int(x)

    def loop(self, ins: Loop, env, path):
        key = path + (id(ins),)
        trips = _loop_trips(self.fn.name, ins, env, self._operand,
                            self._forms)
        self.trips[key] = max(self.trips.get(key, 0), trips)
        steps = self._steps.get(id(ins))
        if steps is None:
            steps = self._steps[id(ins)] = loop_affine(ins)
            self._flat[id(ins)] = not _has_loop(ins.body) and all(
                steps.get(p) is not None for p in ins.phis
                if isinstance(p.type, (PtrType, ScalarType)))
        init = [env[v] for v in ins.init]
        if self._flat[id(ins)]:
            # no loop inside and every scalar phi affine: closed form
            out = [_advance(v, trips * steps[p], None)
                   if steps.get(p) is not None else _DATA
                   for p, v in zip(ins.phis, init)]
        else:
            out = init
            for it in range(trips):
                env.update(zip(ins.phis, out))
                self.block(ins.body, env, key + (it,))
                out = [env[y] for y in ins.yields]
        env.update(zip(ins.results, out))

    def if_op(self, ins: IfOp, env, path):
        c = env[ins.cond_value]
        if not isinstance(c, _Opaque):
            arm, ys = (ins.then, ins.then_yields) if c else \
                (ins.els, ins.els_yields)
            self.block(arm, env, path)
            env.update(zip(ins.results, [env[y] for y in ys]))
            return
        arms = []
        for block, ys in ((ins.then, ins.then_yields),
                          (ins.els, ins.els_yields)):
            inner = dict(env)
            self.block(block, inner, path)
            arms.append([inner[y] for y in ys])
        env.update(zip(ins.results, [self._join(c, a, b)
                                     for a, b in zip(*arms)]))

    @staticmethod
    def _join(c, a, b):
        if _is_ptr(a) and _is_ptr(b):
            same = a[0] == b[0] and not _opaque(a[1], b[1]) and a[1] == b[1]
            return a if same else (a[0], _opaque(c, a[1], b[1]))
        if not _opaque(a, b) and type(a) is type(b) and \
                not isinstance(a, tuple) and a == b:
            return a
        return _opaque(c, a, b) if not isinstance(a, tuple) else _DATA

    def instr(self, ins: Instr, env):  # noqa: C901
        op = ins.op
        args = [env.get(a) for a in ins.args]
        if op == "const":
            env[ins.result] = ins.attrs["value"]
        elif op in ("sbin", "scmp"):
            unknown = _opaque(*args)
            env[ins.result] = unknown if unknown else (
                _sbin if op == "sbin" else _scmp)(ins.attrs["op"], *args)
        elif op in ("sneg", "snot", "sinv", "scast"):
            v = args[0]
            if isinstance(v, _Opaque):
                env[ins.result] = v
            elif op == "sneg":
                env[ins.result] = -v
            elif op == "snot":
                env[ins.result] = not v
            elif op == "sinv":
                env[ins.result] = ~int(v)
            else:
                env[ins.result] = _scast(v, ins.result.type.dtype)
        elif op == "sselect":
            c, a, b = args
            env[ins.result] = self._join(c, a, b) \
                if isinstance(c, _Opaque) else (a if c else b)
        elif op == "ptradd":
            (buf, off), k = args
            unknown = _opaque(off, k)
            env[ins.result] = (buf, unknown if unknown else off + int(k))
        elif op == "ptrcast":
            env[ins.result] = args[0]
        elif ins.result is not None:
            env[ins.result] = _DATA         # loads and intrinsics


def envelope(fn: TFunction, domains: Dict[int, Any],
             steering: set) -> Dict[tuple, int]:
    """Every loop instance's largest trip count over all assignments of
    the scalar params in ``steering`` within ``domains`` (``{param index:
    the values it may take}``); the other scalar params are opaque.  A
    param found to steer a trip count joins ``steering`` (in place) and
    the walk starts over; one without a domain (a float) makes the kernel
    unbatchable."""
    params = fn.params
    while True:
        steer = sorted(steering)
        missing = [i for i in steer if i not in domains]
        if missing:
            raise CompileError(
                f"{fn.name}: scalar param(s) "
                f"{[params[i].hint for i in missing]} steer a loop but "
                f"are not integers; the kernel does not batch",
                kernel=fn.name)
        sizes = [len(domains[i]) for i in steer]
        if int(np.prod(sizes, dtype=np.int64)) > ENVELOPE_LIMIT:
            raise CompileError(
                f"{fn.name}: the loop envelope would enumerate "
                f"{sizes} values of {[params[i].hint for i in steer]}; "
                f"the bucket does not batch", kernel=fn.name)
        walk = _ControlWalk(fn)
        values = [None if isinstance(p.type, PtrType) else
                  _Opaque(frozenset([i])) for i, p in enumerate(params)]
        try:
            for combo in itertools.product(*(domains[i] for i in steer)):
                for i, v in zip(steer, combo):
                    values[i] = v
                walk.run(values)
        except _Steered as e:
            steering |= set(e.params)
            continue
        return walk.trips


class _BatchWalk(_Walk):
    """One walk over ``(B, L)`` buffers and ``(B,)`` scalars: pointers
    are (buffer name, host or per-row offset), and stores write only the
    ``active`` rows."""

    def __init__(self, fn, policy, target, device, rows: int,
                 sites: dict, trips: Dict[tuple, int], frozen: bool):
        super().__init__(fn, policy, target, device)
        self.rows = rows
        self.sites = sites
        self.trips = trips
        self.frozen = frozen
        self.active: Optional[torch.Tensor] = None
        self.path: tuple = ()
        self._steps: Dict[int, dict] = {}

    # -- host values: a per-row scalar never becomes one -----------------
    def host(self, x):
        if isinstance(x, torch.Tensor):
            raise CompileError(
                f"{self.fn.name}: a per-row scalar steers host control (a "
                f"shift, a lane or a pointer choice); the kernel does not "
                f"batch", kernel=self.fn.name,
                target=getattr(self.target, "name", None))
        return x

    def trip_operand(self, x):
        return _int(x) if isinstance(x, torch.Tensor) else int(x)

    offset = trip_operand

    def select_ptr(self, c, a, b):
        return self._merge(c, a, b)

    @staticmethod
    def load_scalar(t, off):
        return isa.batched_index(t, off)

    def store_scalar(self, t, off, v):
        if not isinstance(v, torch.Tensor):
            v = isa.lane_scalar(v, t.dtype, t.device)
        return isa.batched_store_scalar(t, off, v, self.active)

    # -- lowerings: chosen once per site on the per-row shapes -------------
    def lowering(self, site, isa_op: str, row_args):
        self.issues += 1
        low = self.sites.get(site)
        if low is None:
            if self.frozen:
                raise CompileError(f"{self.fn.name}: the batched walk met "
                                   f"an intrinsic its first walk did not "
                                   f"({isa_op})", kernel=self.fn.name)
            low, cost = REGISTRY._select_entry(isa_op, row_args, {},
                                               self.policy, self.target)
            _trace.record(low, *row_args, cost=cost)
            self.sites[site] = low
        return low

    def issue(self, isa_op: str, *args, site=None):
        return self.lowering(site, isa_op, [_row(a) for a in args]).fn(*args)

    # -- regions ----------------------------------------------------------
    def loop(self, ins: Loop, env):
        trips = self._trip_count(ins, env)
        ragged = isinstance(trips, torch.Tensor)
        key = self.path + (id(ins),)
        bound = self.trips.get(key, 0) if ragged else trips
        steps = self._steps.get(id(ins))
        if steps is None:
            steps = self._steps[id(ins)] = loop_affine(ins)
        init = [env[v] for v in ins.init]
        carried = list(init)
        outer, outer_path = self.active, self.path
        try:
            for it in range(bound):
                if ragged:
                    live = trips > it
                    self.active = live if outer is None else outer & live
                for j, p in enumerate(ins.phis):
                    d = steps.get(p)
                    env[p] = carried[j] if d is None else \
                        _advance(init[j], it * d, self.device)
                self.path = key + (it,)
                self.block(ins.body, env)
                for j, (p, y) in enumerate(zip(ins.phis, ins.yields)):
                    if steps.get(p) is None:
                        carried[j] = self._merge(live, env[y], carried[j]) \
                            if ragged else env[y]
        finally:
            self.active, self.path = outer, outer_path
        env.update(zip(ins.results, [
            carried[j] if steps.get(p) is None else
            _advance(init[j], trips * steps[p], self.device)
            for j, p in enumerate(ins.phis)]))

    def if_op(self, ins: IfOp, env):
        cond = env[ins.cond_value]
        if not isinstance(cond, torch.Tensor):
            return super().if_op(ins, env)
        c = _truth(cond)
        outer = self.active
        arms = []
        try:
            for block, ys, rows in ((ins.then, ins.then_yields, c),
                                    (ins.els, ins.els_yields, ~c)):
                self.active = rows if outer is None else outer & rows
                inner = dict(env)
                self.block(block, inner)
                arms.append([inner[y] for y in ys])
        finally:
            self.active = outer
        env.update(zip(ins.results, [self._merge(c, a, b)
                                     for a, b in zip(*arms)]))

    def _merge(self, c, a, b):
        """Row ``r`` of the result is ``a``'s if ``c[r]`` else ``b``'s."""
        if _is_ptr(a) or _is_ptr(b):
            if not (_is_ptr(a) and _is_ptr(b)) or a[0] != b[0]:
                raise CompileError(f"{self.fn.name}: rows would point "
                                   f"into different buffers; the kernel "
                                   f"does not batch", kernel=self.fn.name)
            if _static(a[1], b[1]) and a[1] == b[1]:
                return a
            return (a[0], torch.where(c, _on(a[1], torch.int64, self.device),
                                      _on(b[1], torch.int64, self.device)))
        if isinstance(a, tuple):
            return tuple(self._merge(c, x, y) for x, y in zip(a, b))
        if _static(a, b) and a == b and type(a) is type(b):
            return a
        if isinstance(a, torch.Tensor) and a.dim() > 1:
            return isa.where(c.reshape(-1, 1), a, b)
        return _dwhere(c, a, b, self.device)

    # -- intrinsics ---------------------------------------------------------
    def intrin(self, ins: Instr, env):  # noqa: C901
        kind = ins.attrs["kind"]
        isa_op = ins.attrs["isa_op"]
        rty = ins.result.type if ins.result is not None else None
        if kind == "tuple_undef":
            env[ins.result] = tuple(isa.full((self.rows, e.lanes), 0,
                                             e.dtype, self.device)
                                    for e in rty.elems)
            return
        if kind == "get_lane":
            env[ins.result] = _scalar(isa.batched_index(
                env[ins.args[0]], self.trip_operand(env[ins.args[1]])))
            return
        if kind in ("dup", "load_dup"):
            if kind == "load_dup":
                buf, off = env[ins.args[0]]
                x = isa.batched_index(self.memory[buf], off)
            else:
                x = env[ins.args[0]]
                x = isa.lane_scalar(numpy_dtype(rty.dtype).type(x).item(),
                                    rty.dtype, self.device) \
                    if _static(x) else isa.astype(x, rty.dtype)
            low = self.lowering(ins, isa_op, [_row(x), (rty.lanes,)])
            out = low.fn(x.reshape(-1, 1) if x.dim() else x,
                         (self.rows, rty.lanes))
            env[ins.result] = _typed(out, rty)
            return
        if kind not in _MEMORY:
            return super().intrin(ins, env)
        buf, off = env[ins.args[0]]
        t = self.memory[buf]
        masked = kind.endswith("masked")
        # a masked op's count is its last operand
        c = self.trip_operand(env[ins.args[-1]]) if masked else None
        if kind.startswith("load"):
            head = [ins.attrs["reps"], ins.attrs["groups"]] \
                if kind.startswith("load_group") else [rty.lanes]
            fill = ins.attrs.get("fill", 0)
            tail, row_tail = ([c, fill], [_np_count(c), fill]) if masked \
                else ([], [])
        else:
            v = env[ins.args[1]]
            head = list(v) if kind.startswith("store2") else [v]
            tail, row_tail = ([c], [_np_count(c)]) if masked else ([], [])
        # selection sees row 0's operands as the unbatched walk passes them
        low = self.lowering(ins, isa_op, [t[0], _np_count(off)] +
                            [_row(a) for a in head] + row_tail)
        rest = head + tail
        fn = isa.BATCHED_MEMORY[(low.op, low.tier)]
        if kind in _STORES:
            self.memory[buf] = fn(t, off, *rest, active=self.active)
        else:
            env[ins.result] = _typed(fn(t, off, *rest), rty)


_MEMORY = ("load", "load2", "load_masked", "load2_masked", "load_group",
           "load_group_masked") + _STORES


def _np_count(x):
    """An offset or count as the unbatched walk hands it to selection (a
    per-row one by a stand-in: no cost model reads its value)."""
    return _as_np_index(0 if isinstance(x, torch.Tensor) else x)


def _row(a):
    """Row 0 of a batched operand (what selection sees)."""
    if isinstance(a, torch.Tensor) and a.dim() > 0:
        return a[0]
    if isinstance(a, tuple) and a and isinstance(a[0], torch.Tensor):
        return tuple(_row(x) for x in a)
    return a


def _typed(out, rty):
    """NEON semantics fix the result register type statically."""
    if isinstance(out, torch.Tensor) and out.dtype != rty.dtype:
        return isa.astype(out, rty.dtype)
    return out


class _BatchPlan:
    """One graph key: the envelope, the lowering of every site and, on
    the card, the graph with its static inputs and outputs."""

    def __init__(self, trips):
        self.trips = trips
        self.rows = 0
        self.sites: dict = {}
        self.issues = 0
        self.graph = None
        self.static_in: List[torch.Tensor] = []
        self.static_out: List[torch.Tensor] = []


class BatchedFn:
    """``fn`` over a bucket of requests: ``(B, L)`` buffers, one padded row
    a request, and a 1-D host array of ``B`` values a scalar param.  Row
    ``r`` of each written buffer is what a direct call on row ``r`` gives.

    On the card each graph key — the buffers' shapes and
    dtypes and the value range of every scalar that steers a loop, the
    strip counter's range reaching its bucket (``bounds``) — captures one
    CUDA graph, and every later call with that key replays it whatever
    its rows' values.  ``graphs`` counts the captures; ``last_call`` says
    whether the latest call replayed one."""

    def __init__(self, fn: TFunction, *, policy, target, device):
        self.fn = fn
        self.policy = policy
        self.target = target
        self.device = device
        self.__name__ = f"batched_{fn.name}"
        self._plans: "collections.OrderedDict" = collections.OrderedDict()
        self._steering: set = set()
        self._lock = threading.Lock()
        self.graphs = 0
        self.last_call: Dict[str, Any] = {}

    @property
    def _graphs(self) -> bool:
        return self.device.type == "cuda"

    def __call__(self, *cols, bounds: Optional[Dict[int, int]] = None):
        inputs, domains, shape = self._inputs(cols, bounds or {})
        with self._lock:
            key = (shape, self._domain_key(domains))
            plan = self._plans.get(key)
            if plan is None:
                plan = _BatchPlan(envelope(self.fn, domains, self._steering))
                outs = self._first(plan, inputs)
                self._plans[(shape, self._domain_key(domains))] = plan
                while len(self._plans) > SIGNATURES:
                    self._plans.popitem(last=False)
            else:
                self._plans.move_to_end(key)
                outs = _replay(plan, inputs) if plan.graph is not None \
                    else self._walk(plan, frozen=True).run(inputs)
        self.last_call = {"captured": plan.graph is not None,
                          "issues": plan.issues}
        return outs

    def _domain_key(self, domains):
        return tuple((i, domains[i]) for i in sorted(self._steering)
                     if i in domains)

    def _inputs(self, cols, bounds):
        params = self.fn.params
        if len(cols) != len(params):
            raise CompileError(f"{self.fn.name} takes {len(params)} "
                               f"columns, got {len(cols)}",
                               kernel=self.fn.name)
        inputs, domains, shape, rows = [], {}, [], set()
        for i, (p, c) in enumerate(zip(params, cols)):
            if isinstance(p.type, PtrType):
                t = c.to(self.device) if isinstance(c, torch.Tensor) else \
                    torch.as_tensor(np.asarray(c), device=self.device)
                if t.dim() != 2:
                    raise CompileError(f"pointer param {p.hint!r} wants "
                                       f"a (B, L) buffer",
                                       kernel=self.fn.name)
                inputs.append(t)
                shape.append((tuple(t.shape), t.dtype))
                rows.add(t.shape[0])
                continue
            v = np.asarray(c)
            if v.ndim != 1:
                raise CompileError(f"scalar param {p.hint!r} wants one "
                                   f"value a row", kernel=self.fn.name)
            rows.add(v.shape[0])
            if v.dtype.kind in "iu":
                if i in bounds:
                    # every value up to the bound: one graph serves them
                    lo = min(int(v.min(initial=0)), 0)
                    domains[i] = range(lo, max(int(v.max(initial=0)),
                                               int(bounds[i])) + 1)
                else:
                    domains[i] = tuple(sorted({int(x) for x in v}))
                dt = torch.int64
            elif v.dtype.kind == "b":
                dt = torch.bool
            else:
                dt = torch.float64
            inputs.append(torch.as_tensor(v, device=self.device).to(dt))
            shape.append(dt)
        if len(rows) > 1:
            raise CompileError(f"{self.fn.name}: columns of {sorted(rows)} "
                               f"rows", kernel=self.fn.name)
        return inputs, domains, tuple(shape)

    def _walk(self, plan: _BatchPlan, frozen: bool) -> _BatchWalk:
        return _BatchWalk(self.fn, self.policy, self.target, self.device,
                          plan.rows, plan.sites, plan.trips, frozen)

    def _first(self, plan: _BatchPlan, inputs):
        plan.rows = inputs[0].shape[0]
        walk = self._walk(plan, frozen=False)
        outs = _warm(self.device, lambda: walk.run(inputs)) \
            if self._graphs else walk.run(inputs)
        plan.issues = walk.issues
        if self._graphs:
            cap = self._walk(plan, frozen=True)
            plan.static_in = [t.clone() for t in inputs]
            plan.graph, plan.static_out = _capture(
                self.device, lambda: cap.run(plan.static_in), self.fn.name,
                self.target)
            self.graphs += 1
            outs = _replay(plan, inputs)
        return outs


# ---------------------------------------------------------------------------
# device scalars: the interpreter's Python-number semantics on 0-d tensors
# ---------------------------------------------------------------------------

def _static(*xs) -> bool:
    return not any(isinstance(x, torch.Tensor) for x in xs)


def _loop_trips(name: str, ins: Loop, env, operand, forms=None):
    """``ins``'s trip count from the values in ``env`` (each read through
    ``operand``); CompileError where the reference has no closed form.
    ``forms`` caches each loop's condition and step by ``id``."""
    form = None if forms is None else forms.get(id(ins))
    if form is None:
        cond = loop_condition(ins)
        if cond is None:
            raise CompileError(
                f"{name}: loop condition is not of the affine form "
                f"`phi + c <op> bound` — compile needs a counted loop (the "
                f"interpreter still runs it)")
        step = loop_affine(ins).get(cond[0])
        if step is None or step == 0:
            raise CompileError(
                f"{name}: counter {cond[0].hint!r} has no constant integer "
                f"step — cannot derive a trip count")
        form = (*cond, step)
        if forms is not None:
            forms[id(ins)] = form
    phi, phi_off, op, bound, step = form
    v0 = operand(env[ins.init[ins.phis.index(phi)]]) + phi_off
    if bound.root is None:
        b = bound.off
    else:
        broot = env.get(bound.root)
        if broot is None:
            raise CompileError(f"loop bound {bound.root} is unbound")
        b = operand(broot) + bound.off
    trips = _closed_form(v0, op, b, step)
    if trips is None:
        raise CompileError(
            f"{name}: loop `{phi.hint} {op} ...` with step {step} has no "
            f"closed-form trip count")
    return trips


def _closed_form(v0, op: str, b, d: int):
    """The reference's trip count of ``for (v = v0; v <op> b; v += d)``
    over host integers or int64 tensors (per-row counts); None when the
    form has none."""
    if _static(v0, b):
        def floor0(t):
            return max(0, t)
    else:
        def floor0(t):
            return torch.clamp(t, min=0)
    if d < 0 and op in (">=", ">"):
        lo = b if op == ">=" else b + 1
        t = v0 - lo
        q = (-1 if t < 0 else t // (-d)) if _static(t) else \
            torch.where(t < 0, -1, t // (-d))
        return floor0(q + 1)
    if d < 0 and op == "!=":
        return floor0((v0 - b) // (-d))
    if d > 0 and op in ("<", "<="):
        hi = b if op == "<" else b + 1
        return floor0((hi - v0 + d - 1) // d)
    if d > 0 and op == "!=":
        return floor0((b - v0) // d)
    return None


def _is_ptr(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], str)


def _scalar(t: torch.Tensor) -> torch.Tensor:
    """A lane read as the interpreter's host read gives it: float64 for
    floats, int64 for integers (unsigned lanes by value), bool."""
    if t.dtype == torch.bool:
        return t
    return isa.astype(t, torch.float64 if t.is_floating_point()
                      else torch.int64)


def _is_float(x) -> bool:
    return x.is_floating_point() if isinstance(x, torch.Tensor) \
        else isinstance(x, float)


def _on(x, dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    return torch.full((), x, dtype=dtype, device=device)


def _num(x):
    """Arithmetic operand: bool counts as int, as in Python."""
    return x.to(torch.int64) if x.dtype == torch.bool else x


def _int(x):
    """``int(x)``: floats truncate toward zero."""
    x = _num(x)
    return torch.trunc(x).to(torch.int64) if x.is_floating_point() else x


def _truth(x):
    return x if x.dtype == torch.bool else x != 0


def _dsbin(op: str, a, b, device):
    if op in ("&&", "||"):
        a, b = (_truth(_on(v, torch.float64 if _is_float(v) else
                           torch.int64, device)) for v in (a, b))
        return torch.logical_and(a, b) if op == "&&" else \
            torch.logical_or(a, b)
    if op in ("<<", ">>", "&", "|", "^"):
        a, b = (_int(_on(v, torch.float64 if _is_float(v) else
                         torch.int64, device)) for v in (a, b))
        return {"<<": torch.bitwise_left_shift,
                ">>": torch.bitwise_right_shift,
                "&": torch.bitwise_and, "|": torch.bitwise_or,
                "^": torch.bitwise_xor}[op](a, b)
    dt = torch.float64 if _is_float(a) or _is_float(b) else torch.int64
    a, b = _on(a, dt, device), _on(b, dt, device)
    if op == "+":
        return a + b
    if op == "-":
        return a - b
    if op == "*":
        return a * b
    if op == "/":
        return a / b if dt == torch.float64 else \
            torch.div(a, b, rounding_mode="trunc")     # C division
    if op == "%":
        return torch.fmod(a, b)                         # C remainder
    raise CompileError(f"unknown scalar op {op!r}")


def _dscmp(op: str, a, b, device):
    dt = torch.float64 if _is_float(a) or _is_float(b) else torch.int64
    a, b = _on(a, dt, device), _on(b, dt, device)
    return {"==": torch.eq, "!=": torch.ne, "<": torch.lt, ">": torch.gt,
            "<=": torch.le, ">=": torch.ge}[op](a, b)


def _dscast(v: torch.Tensor, dtype: str):
    """The interpreter's ``_scast`` (numpy scalar conversion) on a device
    scalar: floats round to the type and back, integers truncate and keep
    the type's low bits."""
    if dtype == "bool":
        return _truth(v)
    if dtype.startswith("float"):
        return _num(v).to(torch_dtype(dtype)).to(torch.float64)
    return isa.astype(isa.astype(_int(v), dtype), torch.int64)


def _dwhere(c, a, b, device):
    dt = torch.float64 if _is_float(a) or _is_float(b) else \
        torch.bool if all(isinstance(x, bool) or (
            isinstance(x, torch.Tensor) and x.dtype == torch.bool)
            for x in (a, b)) else torch.int64
    return torch.where(c, _on(a, dt, device), _on(b, dt, device))
