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
"""
from __future__ import annotations

import collections
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
from .ir import IfOp, Instr, Loop, PtrType, TFunction, Value
from .resilience import CompileError
from .revec import loop_affine, loop_condition

__all__ = ["CompileError", "compile_fn", "CompiledFn"]

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
        if self._graphs:
            side = torch.cuda.Stream(self.device)
            main = torch.cuda.current_stream(self.device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                outs = walk.run(inputs)
            main.wait_stream(side)
            for t in outs:
                t.record_stream(main)
        else:
            outs = walk.run(inputs)
        plan = _Plan(walk.recorded if walk.host_reads == 0 else None,
                     walk.host_reads, walk.issues)
        if self._graphs and plan.tape is not None:
            self._capture(plan, inputs)
            outs = self._replay(plan, inputs)
        return outs, plan

    def _again(self, plan: _Plan, inputs):
        if plan.graph is not None:
            return self._replay(plan, inputs), 0
        walk = self._walk(plan.tape)
        return walk.run(inputs), walk.host_reads

    def _capture(self, plan: _Plan, inputs):
        plan.static_in = [t.clone() if isinstance(t, torch.Tensor) else t
                          for t in inputs]
        graph = torch.cuda.CUDAGraph()
        walk = self._walk(plan.tape)
        try:
            with _CAPTURE_LOCK, warnings.catch_warnings():
                # a signature that launches nothing (n = 0 with no store)
                # captures an empty graph, which replays as a no-op
                warnings.filterwarnings("ignore", "The CUDA Graph is empty")
                with torch.cuda.graph(graph,
                                      stream=_capture_stream(self.device),
                                      capture_error_mode="thread_local"):
                    plan.static_out = walk.run(plan.static_in)
        except Exception as e:   # noqa: BLE001 — any capture failure
            raise CompileError(f"{self.fn.name}: CUDA graph capture "
                               f"failed: {e}", kernel=self.fn.name,
                               target=getattr(self.target, "name",
                                              None)) from e
        if walk.host_reads:
            raise CompileError(f"{self.fn.name}: the capture read "
                               f"{walk.host_reads} scalars to the host",
                               kernel=self.fn.name)
        plan.graph = graph

    @staticmethod
    def _replay(plan: _Plan, inputs):
        for s, t in zip(plan.static_in, inputs):
            if isinstance(s, torch.Tensor):
                s.copy_(t)
        plan.graph.replay()
        return [t.clone() for t in plan.static_out]


_STREAMS: Dict[int, "torch.cuda.Stream"] = {}
# one capture at a time in the process (they share a capture stream);
# other threads' eager walks go on meanwhile: capture is thread-local
_CAPTURE_LOCK = threading.Lock()


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

    def issue(self, isa_op: str, *args):
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

    def _trip_count(self, ins: Loop, env) -> int:
        """The reference's closed form (``compile.py`` ``_trip_count``)
        over host integers."""
        cond = loop_condition(ins)
        if cond is None:
            raise CompileError(
                f"{self.fn.name}: loop condition is not of the affine "
                f"form `phi + c <op> bound` — compile needs a counted "
                f"loop (the interpreter still runs it)")
        phi, phi_off, op, bound = cond
        step = loop_affine(ins).get(phi)
        if step is None or step == 0:
            raise CompileError(
                f"{self.fn.name}: counter {phi.hint!r} has no constant "
                f"integer step — cannot derive a trip count")
        v0 = self.index(env[ins.init[ins.phis.index(phi)]]) + phi_off
        if bound.root is None:
            b = bound.off
        else:
            broot = env.get(bound.root)
            if broot is None:
                raise CompileError(f"loop bound {bound.root} is unbound")
            b = self.index(broot) + bound.off
        d = step
        if d < 0 and op in (">=", ">"):
            lo = b if op == ">=" else b + 1
            t = v0 - lo
            return max(0, (-1 if t < 0 else t // (-d)) + 1)
        if d < 0 and op == "!=":
            return max(0, (v0 - b) // (-d))
        if d > 0 and op in ("<", "<="):
            hi = b if op == "<" else b + 1
            return max(0, (hi - v0 + d - 1) // d)
        if d > 0 and op == "!=":
            return max(0, (b - v0) // d)
        raise CompileError(
            f"{self.fn.name}: loop `{phi.hint} {op} ...` with step {d} "
            f"has no closed-form trip count")

    def if_op(self, ins: IfOp, env):
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
                c = self.host(_truth(c))
            if not isinstance(c, torch.Tensor):
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
            env[ins.result] = (buf, off + self.index(env[ins.args[1]]))
        elif op == "ptrcast":
            env[ins.result] = env[ins.args[0]]
        elif op == "sload":
            buf, off = env[ins.args[0]]
            t = self.memory[buf]
            env[ins.result] = _scalar(t[isa.static_index(off, t.shape[0])])
        elif op == "sstore":
            buf, off = env[ins.args[0]]
            t = self.memory[buf]
            v = env[ins.args[1]]
            if _static(v):
                # the value as the lane type holds it (numpy conversion)
                v = np.asarray(v).astype(numpy_dtype(t.dtype)).item()
            else:
                v = isa.astype(v, t.dtype)
            self.memory[buf] = isa.store_scalar(t, off, v)
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

        out = self.issue(isa_op, *args)
        if kind in _STORES:
            self.memory[env[ins.args[0]][0]] = out
        elif kind == "reduce":
            env[ins.result] = _scalar(out)
        else:
            # NEON semantics fix the result register type statically
            if isinstance(out, torch.Tensor) and out.dtype != rty.dtype:
                out = isa.astype(out, rty.dtype)
            env[ins.result] = out


# ---------------------------------------------------------------------------
# device scalars: the interpreter's Python-number semantics on 0-d tensors
# ---------------------------------------------------------------------------

def _static(*xs) -> bool:
    return not any(isinstance(x, torch.Tensor) for x in xs)


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
