"""IR interpreter: the executable backend of the port frontend.

Two modes over the same typed SSA:

* **concrete** — runs the kernel on real tensors.  Every translated
  intrinsic issues through :func:`repro_torch.core.registry.dispatch`, so
  the cost-driven selector chooses each op's lowering under the active
  (or requested) target, and execution inside :func:`trace.count`
  accumulates the paper's dynamic instruction counts for free.  Buffers
  live on the machine's device (``device=None``: the card); every vector
  op runs there.
* **abstract** — runs only the *scalar* control flow concretely (loop
  trip counts, pointer walks) and replaces every vector issue with a
  selection-cache lookup (:meth:`registry._Registry.cost_of`), giving
  the estimated dynamic vector-instruction count and per-intrinsic
  tier choices without touching any data: registers and buffers are
  ``meta`` tensors.  This is what ``port.report`` sweeps across the
  rvv-64..1024 family.

Memory model: each pointer parameter names a 1-D buffer; a pointer value
is ``(buffer name, element offset)``; stores are functional updates of
the buffer table (single-writer buffers — the subset's kernels never
alias), so the caller's tensors never change.  Offsets are passed to
dispatch as 0-d numpy scalars so the selection cache keys on their
*type*, not each loop iteration's value.

Scalars that the kernel's control flow consumes are read back to the
host where the reference reads them: a scalar load (``sload``), a lane
extract (``get_lane``) and a horizontal reduction (``reduce``).  On the
card each is a synchronisation; :attr:`Machine.host_reads` counts them.
A broadcast load (``vld1_dup``) stays on the device.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core import isa
from ..core.registry import REGISTRY
from ..core.targets import resolve_device
from ..core.vtypes import numpy_dtype, torch_dtype
from . import faultinject as _fi
from .ir import (Block, IfOp, Instr, Loop, PtrType, ScalarType, TFunction,
                 Value, VecTupleType)
from .resilience import ExecError

__all__ = ["Machine", "ExecError"]

_MAX_ITERS = 10_000_000     # runaway-loop guard for malformed kernels


# abstract-mode stand-in for scalars produced by vector ops (vaddv,
# get_lane): consuming one in control flow is a subset violation anyway.
# The sentinel is a NaN *subclass* carrying the producing intrinsic and
# source line, so the ExecError raised when one reaches control flow can
# name the culprit instead of reporting an anonymous NaN.
class _UnknownScalar(float):
    __slots__ = ("origin",)

    def __new__(cls, origin=None):
        self = super().__new__(cls, float("nan"))
        self.origin = origin          # (intrinsic name, source line) | None
        return self


_UNKNOWN_SCALAR = _UnknownScalar()


def _unknown_like(*operands) -> "_UnknownScalar":
    """Propagate an unknown scalar, keeping the first operand's origin."""
    for x in operands:
        o = getattr(x, "origin", None)
        if o is not None:
            return _UnknownScalar(o)
    return _UNKNOWN_SCALAR


def _unknown_source(x) -> str:
    o = getattr(x, "origin", None)
    if o is None:
        return "a vector-produced scalar"
    name, line = o
    at = f" (line {line})" if line else ""
    return f"a scalar produced by vector intrinsic {name!r}{at}"


def _as_np_index(off: int):
    # 0-d numpy scalar: hashes into the selection cache as
    # ('#arr', (), 'int64') instead of a fresh key per offset value
    return np.int64(off)


def _meta(shape, dtype):
    return torch.empty(tuple(shape), dtype=torch_dtype(dtype),
                       device="meta")


class Machine:
    def __init__(self, fn: TFunction, *, policy: Optional[str] = None,
                 target=None, abstract: bool = False, device=None):
        self.fn = fn
        self.policy = policy
        self.target = target
        self.abstract = abstract
        # concrete runs build on the card unless told otherwise
        self.device = None if abstract else resolve_device(
            "cuda" if device is None else device)
        self.memory: Dict[str, Any] = {}
        # abstract-mode accounting: intrinsic name -> row
        self.stats: Dict[str, Dict[str, Any]] = {}
        self.scalar_instrs = 0
        # scalars read back to the host (a synchronisation on the card)
        self.host_reads = 0

    # -- public -----------------------------------------------------------
    def run(self, *args):
        if not self.abstract:
            _fi.fault_point("interp.run", kernel=self.fn.name)
        params = self.fn.params
        if len(args) != len(params):
            raise ExecError(f"{self.fn.name} takes {len(params)} args "
                            f"({', '.join(p.hint for p in params)}), "
                            f"got {len(args)}", kernel=self.fn.name)
        env: Dict[Value, Any] = {}
        for p, a in zip(params, args):
            if isinstance(p.type, PtrType):
                buf = (_meta(np.shape(a), _dtype_of(a)) if self.abstract
                       else self._tensor(a))
                if len(buf.shape) != 1:
                    raise ExecError(f"pointer param {p.hint!r} wants a "
                                    f"1-D buffer, got shape "
                                    f"{tuple(buf.shape)}")
                self.memory[p.hint] = buf
                env[p] = (p.hint, 0)
            elif isinstance(p.type, ScalarType):
                env[p] = a if isinstance(a, (int, float, bool)) else \
                    self._read(a) if isinstance(a, torch.Tensor) else \
                    np.asarray(a).item()
            else:
                env[p] = self._tensor(a)
        self.block(self.fn.body, env)
        outs = [self.memory[p.hint] for p in params
                if p.hint in self.fn.writes]
        if self.abstract:
            return self.report_rows()
        return outs[0] if len(outs) == 1 else tuple(outs)

    def report_rows(self) -> Dict[str, Any]:
        total = sum(r["instrs"] for r in self.stats.values())
        return {"total_instrs": int(total),
                "scalar_instrs": int(self.scalar_instrs),
                "per_intrinsic": dict(sorted(self.stats.items()))}

    # -- device plumbing ------------------------------------------------------
    def _tensor(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        return torch.as_tensor(np.asarray(a), device=self.device)

    def _read(self, t):
        """One scalar back to the host."""
        self.host_reads += 1
        return isa.host_value(t)

    # -- dispatch plumbing --------------------------------------------------
    def _dispatch(self, isa_op: str, *args):
        return REGISTRY.dispatch(isa_op, *args, policy=self.policy,
                                 target=self.target)

    def _charge(self, intrinsic: str, isa_op: str, width_bits: int, *args):
        tier, cost = REGISTRY.cost_of(isa_op, *args, policy=self.policy,
                                      target=self.target)
        row = self.stats.setdefault(intrinsic, {
            "isa_op": isa_op, "width_bits": width_bits, "issues": 0,
            "instrs": 0, "tier": tier, "cost_per_issue": int(cost or 0)})
        row["issues"] += 1
        row["instrs"] += int(cost or 0)
        row["tier"] = tier

    # -- block / region execution -------------------------------------------
    def block(self, b: Block, env: Dict[Value, Any]):
        for ins in b.instrs:
            if isinstance(ins, Loop):
                self.loop(ins, env)
            elif isinstance(ins, IfOp):
                self.if_op(ins, env)
            else:
                self.instr(ins, env)

    def loop(self, ins: Loop, env):
        carried = [env[v] for v in ins.init]
        iters = 0
        while True:
            env.update(zip(ins.phis, carried))
            self.block(ins.cond, env)
            cond = env[ins.cond_value]
            if isinstance(cond, float) and math.isnan(cond):
                raise ExecError(f"loop condition depends on "
                                f"{_unknown_source(cond)} (abstract mode "
                                f"cannot trace data-dependent trip counts)")
            if not cond:
                break
            self.block(ins.body, env)
            carried = [env[y] for y in ins.yields]
            iters += 1
            if iters > _MAX_ITERS:
                raise ExecError(f"loop exceeded {_MAX_ITERS} iterations")
        env.update(zip(ins.results, carried))

    def if_op(self, ins: IfOp, env):
        cond = env[ins.cond_value]
        if _is_nan(cond):
            raise ExecError(f"branch condition depends on "
                            f"{_unknown_source(cond)} (abstract mode "
                            f"cannot trace data-dependent control flow)")
        if cond:
            self.block(ins.then, env)
            vals = [env[y] for y in ins.then_yields]
        else:
            self.block(ins.els, env)
            vals = [env[y] for y in ins.els_yields]
        env.update(zip(ins.results, vals))

    # -- straight-line instructions ------------------------------------------
    def instr(self, ins: Instr, env):  # noqa: C901
        op = ins.op
        if op == "const":
            env[ins.result] = ins.attrs["value"]
        elif op == "sbin":
            self.scalar_instrs += 1
            a, b = env[ins.args[0]], env[ins.args[1]]
            # the unknown-scalar sentinel must survive every scalar op
            # (an int() coercion would crash or, worse, collapse it to a
            # concrete value and silently corrupt abstract estimates)
            env[ins.result] = (_unknown_like(a, b)
                               if _is_nan(a) or _is_nan(b)
                               else _sbin(ins.attrs["op"], a, b))
        elif op == "scmp":
            self.scalar_instrs += 1
            a, b = env[ins.args[0]], env[ins.args[1]]
            env[ins.result] = (_unknown_like(a, b)
                               if _is_nan(a) or _is_nan(b)
                               else _scmp(ins.attrs["op"], a, b))
        elif op == "sneg":
            env[ins.result] = -env[ins.args[0]]
        elif op == "snot":
            v = env[ins.args[0]]
            env[ins.result] = _unknown_like(v) if _is_nan(v) else not v
        elif op == "sinv":
            v = env[ins.args[0]]
            env[ins.result] = _unknown_like(v) if _is_nan(v) else ~int(v)
        elif op == "sselect":
            c, a, b = (env[v] for v in ins.args)
            env[ins.result] = _unknown_like(c) if _is_nan(c) else \
                (a if c else b)
        elif op == "scast":
            v = env[ins.args[0]]
            env[ins.result] = _unknown_like(v) if _is_nan(v) else \
                _scast(v, ins.result.type.dtype)
        elif op == "ptradd":
            buf, off = env[ins.args[0]]
            delta = env[ins.args[1]]
            if _is_nan(delta):
                raise ExecError(
                    f"pointer displacement depends on "
                    f"{_unknown_source(delta)} (abstract mode cannot "
                    f"trace data-dependent addressing)")
            env[ins.result] = (buf, off + int(delta))
        elif op == "ptrcast":
            env[ins.result] = env[ins.args[0]]
        elif op == "sload":
            buf, off = env[ins.args[0]]
            self.scalar_instrs += 1
            if self.abstract:
                env[ins.result] = _UNKNOWN_SCALAR
            else:
                t = self.memory[buf]
                env[ins.result] = self._read(
                    t[isa.static_index(off, t.shape[0])])
        elif op == "sstore":
            buf, off = env[ins.args[0]]
            self.scalar_instrs += 1
            if not self.abstract:
                t = self.memory[buf]
                # the value as the lane type holds it (numpy conversion)
                v = np.asarray(env[ins.args[1]]).astype(
                    numpy_dtype(t.dtype)).item()
                self.memory[buf] = isa.store_scalar(t, off, v)
        elif op == "intrin":
            self.intrin(ins, env)
        else:
            raise ExecError(f"unknown IR op {op!r}")

    # -- intrinsic issue -------------------------------------------------
    def intrin(self, ins: Instr, env):  # noqa: C901
        kind = ins.attrs["kind"]
        isa_op = ins.attrs["isa_op"]
        name = ins.attrs["intrinsic"]
        width = ins.attrs["width_bits"]
        rty = ins.result.type if ins.result is not None else None

        def abstract_reg(ty):
            # tuple-aware abstract values: a struct register's unknown is
            # a tuple of per-register unknowns, not a scalar stand-in
            if isinstance(ty, VecTupleType):
                return tuple(abstract_reg(e) for e in ty.elems)
            return _meta((ty.lanes,), ty.dtype)

        def reg(v):
            return abstract_reg(v.type) if self.abstract else env[v]

        # register-struct plumbing: pure SSA renaming, no vector issue,
        # no dispatch, no cost — a struct *is* its member registers
        if kind == "tuple_undef":
            env[ins.result] = tuple(
                abstract_reg(e) if self.abstract
                else isa.full((e.lanes,), 0, e.dtype, self.device)
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
            # register -> scalar move: executor-native, one scalar op
            self.scalar_instrs += 1
            if self.abstract:
                env[ins.result] = _UnknownScalar(
                    (name, ins.attrs.get("_line", 0)))
            else:
                vec, lane = env[ins.args[0]], int(env[ins.args[1]])
                env[ins.result] = self._read(
                    vec[isa.static_index(lane, vec.shape[0])])
            return

        # build the logical-ISA argument list per intrinsic family
        if kind == "vv":
            args = [reg(v) for v in ins.args]
        elif kind == "dup":
            x = env[ins.args[0]]
            x = numpy_dtype(rty.dtype).type(
                0 if self.abstract and _is_nan(x) else x)
            if not self.abstract:
                x = isa.lane_scalar(x.item(), rty.dtype, self.device)
            args = [x, (rty.lanes,)]
        elif kind == "load":
            buf, off = env[ins.args[0]]
            args = [self.memory[buf], _as_np_index(off), rty.lanes]
        elif kind == "load_dup":
            buf, off = env[ins.args[0]]
            if self.abstract:
                x = numpy_dtype(rty.dtype).type(0)
            else:
                # the one lane as a 0-d device tensor: no host read
                t = self.memory[buf]
                x = t[isa.static_index(off, t.shape[0])]
            self.scalar_instrs += 1          # the one-lane load
            args = [x, (rty.lanes,)]
        elif kind == "load_masked":
            buf, off = env[ins.args[0]]
            cnt = env[ins.args[1]]
            args = [self.memory[buf], _as_np_index(off), rty.lanes,
                    _as_np_index(cnt), ins.attrs.get("fill", 0)]
        elif kind == "load_group":
            buf, off = env[ins.args[0]]
            args = [self.memory[buf], _as_np_index(off),
                    ins.attrs["reps"], ins.attrs["groups"]]
        elif kind == "load_group_masked":
            buf, off = env[ins.args[0]]
            cnt = env[ins.args[1]]
            args = [self.memory[buf], _as_np_index(off),
                    ins.attrs["reps"], ins.attrs["groups"],
                    _as_np_index(cnt), ins.attrs.get("fill", 0)]
        elif kind == "fold":
            args = [reg(ins.args[0]), ins.attrs["factor"]]
        elif kind == "store":
            buf, off = env[ins.args[0]]
            args = [self.memory[buf], _as_np_index(off), reg(ins.args[1])]
        elif kind == "store_masked":
            buf, off = env[ins.args[0]]
            cnt = env[ins.args[2]]
            args = [self.memory[buf], _as_np_index(off), reg(ins.args[1]),
                    _as_np_index(cnt)]
        elif kind == "tile":
            args = [reg(ins.args[0]), ins.attrs["reps"]]
        elif kind == "shift":
            args = [reg(ins.args[0]), int(env[ins.args[1]])]
        elif kind == "ext":
            args = [reg(ins.args[0]), reg(ins.args[1]),
                    int(env[ins.args[2]])]
        elif kind == "reduce":
            args = [reg(ins.args[0])]
        elif kind in ("cvt", "reinterpret"):
            args = [reg(ins.args[0]), torch_dtype(rty.dtype)]
        elif kind == "vv_cvt":
            # widening arithmetic: (*regs, out dtype) — binary vmull/
            # vaddl/vsubl or ternary vmlal/vmlsl, like cvt with n regs
            args = [reg(v) for v in ins.args] + [torch_dtype(rty.dtype)]
        elif kind == "load2":
            buf, off = env[ins.args[0]]
            args = [self.memory[buf], _as_np_index(off), rty.lanes]
        elif kind == "load2_masked":
            buf, off = env[ins.args[0]]
            cnt = env[ins.args[1]]
            args = [self.memory[buf], _as_np_index(off), rty.lanes,
                    _as_np_index(cnt), ins.attrs.get("fill", 0)]
        elif kind == "store2":
            buf, off = env[ins.args[0]]
            args = [self.memory[buf], _as_np_index(off), *reg(ins.args[1])]
        elif kind == "store2_masked":
            buf, off = env[ins.args[0]]
            cnt = env[ins.args[2]]
            args = [self.memory[buf], _as_np_index(off), *reg(ins.args[1]),
                    _as_np_index(cnt)]
        else:
            raise ExecError(f"unknown intrinsic kind {kind!r}")

        if self.abstract:
            self._charge(name, isa_op, width, *args)
            if kind in ("store", "store_masked", "store2", "store2_masked"):
                return
            if kind == "reduce":
                env[ins.result] = _UnknownScalar(
                    (name, ins.attrs.get("_line", 0)))
            else:
                env[ins.result] = abstract_reg(rty)
            return

        out = self._dispatch(isa_op, *args)
        if kind in ("store", "store_masked", "store2", "store2_masked"):
            buf, _ = env[ins.args[0]]
            self.memory[buf] = out
        elif kind == "reduce":
            env[ins.result] = self._read(out)
        else:
            # NEON semantics fix the result register type statically
            if isinstance(out, torch.Tensor) and out.dtype != rty.dtype:
                out = isa.astype(out, rty.dtype)
            env[ins.result] = out


# ---------------------------------------------------------------------------
# scalar helpers
# ---------------------------------------------------------------------------

def _is_nan(x) -> bool:
    return isinstance(x, float) and math.isnan(x)


def _dtype_of(a):
    return getattr(a, "dtype", None) or np.asarray(a).dtype


def _sbin(op: str, a, b):
    if op == "+":
        return a + b
    if op == "-":
        return a - b
    if op == "*":
        return a * b
    if op == "/":
        if isinstance(a, int) and isinstance(b, int):
            return int(math.trunc(a / b))       # C integer division
        return a / b
    if op == "%":
        return math.fmod(a, b) if isinstance(a, float) or \
            isinstance(b, float) else int(math.fmod(a, b))
    if op == "<<":
        return int(a) << int(b)
    if op == ">>":
        return int(a) >> int(b)
    if op == "&":
        return int(a) & int(b)
    if op == "|":
        return int(a) | int(b)
    if op == "^":
        return int(a) ^ int(b)
    if op == "&&":
        return bool(a) and bool(b)
    if op == "||":
        return bool(a) or bool(b)
    raise ExecError(f"unknown scalar op {op!r}")


def _scmp(op: str, a, b) -> bool:
    return {"==": a == b, "!=": a != b, "<": a < b, ">": a > b,
            "<=": a <= b, ">=": a >= b}[op]


def _scast(v, dtype: str):
    if dtype.startswith("float"):
        return float(np.dtype(dtype).type(v))
    if dtype == "bool":
        return bool(v)
    return int(np.dtype(dtype).type(v))
