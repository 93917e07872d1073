"""AST -> typed SSA lowering.

Walks the parsed C (cparse AST) and produces an :class:`ir.TFunction`:

* every intrinsic call resolves through :mod:`repro_torch.port.intrinsics`
  and is type-checked against its Table-2 register signature;
* scalar control flow (strip-mine counters, pointer bumps) lowers to
  scalar instructions interpreted concretely at run time;
* loops become structured ``Loop`` regions with explicit loop-carried
  values — the SSA construction identifies the variables mutated in a
  loop body and threads them as phis;
* pointer provenance is tracked statically so the kernel knows which
  parameter buffers it writes (its outputs) and that it never stores
  through a ``const`` pointer.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Set, Tuple

from . import cparse as C
from .intrinsics import IntrinSpec, UnknownIntrinsic, resolve
from .ir import (Block, IfOp, Instr, IRType, Loop, PtrType, ScalarType,
                 TFunction, Value, VecTupleType, VecType,
                 is_vec_tuple_name, vec_tuple_type, vec_type)
from .resilience import LowerError

__all__ = ["lower_function", "LowerError"]


_CMP_OPS = {"==", "!=", "<", ">", "<=", ">="}


def _ctype_to_ir(t, where: str) -> IRType:
    if isinstance(t, C.Scalar):
        name = "int64" if t.name == "size_t" else t.name
        return ScalarType(name)
    if isinstance(t, C.Ptr):
        return PtrType(elem=t.elem.name, const=t.const)
    if isinstance(t, C.VecT):
        if is_vec_tuple_name(t.name):
            return vec_tuple_type(t.name)
        try:
            return vec_type(t.name)
        except KeyError:
            raise LowerError(f"{where}: {t.name!r} is not a Table-2 NEON "
                             f"register type")
    raise LowerError(f"{where}: unsupported type {t!r}")


def lower_function(fn: C.FuncDef, source: str = "",
                   filename: Optional[str] = None) -> TFunction:
    """Lower one parsed function to typed SSA.  Every rejection is a
    :class:`LowerError` carrying kernel/file provenance — a malformed
    AST must never escape as a raw ``AttributeError``/``KeyError``."""
    try:
        return _Lowerer(fn, source, filename).run()
    except LowerError as e:
        raise e.add_context(kernel=fn.name, file=filename)


class _Lowerer:
    def __init__(self, fn: C.FuncDef, source: str,
                 filename: Optional[str] = None):
        self.fn = fn
        self.source = source
        self.filename = filename or ""
        self._ids = itertools.count()
        self.blocks: List[Block] = []
        self.writes: List[str] = []
        # static provenance: pointer Value -> the param buffer it walks
        self.ptr_root: Dict[int, str] = {}

    # -- plumbing -------------------------------------------------------
    def val(self, ty: IRType, hint: str = "") -> Value:
        return Value(id=next(self._ids), type=ty, hint=hint)

    def emit(self, ins: Instr) -> Optional[Value]:
        self.blocks[-1].instrs.append(ins)
        return ins.result

    def root_of(self, v: Value) -> Optional[str]:
        return self.ptr_root.get(id(v))

    def set_root(self, v: Value, root: Optional[str]):
        if root is not None:
            self.ptr_root[id(v)] = root

    # -- entry ------------------------------------------------------------
    def run(self) -> TFunction:
        env: Dict[str, Value] = {}
        params = []
        for p in self.fn.params:
            ty = _ctype_to_ir(p.type, f"param {p.name!r}")
            v = self.val(ty, hint=p.name)
            if isinstance(ty, PtrType):
                self.set_root(v, p.name)
            env[p.name] = v
            params.append(v)
        body = Block()
        self.blocks.append(body)
        self.block_stmts(self.fn.body.stmts, env)
        self.blocks.pop()
        return TFunction(name=self.fn.name, params=params, body=body,
                         writes=self.writes, source=self.source,
                         filename=self.filename)

    # -- statements ---------------------------------------------------------
    def block_stmts(self, stmts, env: Dict[str, Value]):
        for s in stmts:
            self.stmt(s, env)

    def stmt(self, s, env):
        if isinstance(s, C.Block):
            self.block_stmts(s.stmts, env)
        elif isinstance(s, C.Decl):
            ty = _ctype_to_ir(s.type, f"decl {s.name!r}")
            if s.init is None:
                if isinstance(ty, ScalarType):
                    v = self.const(0, env)
                elif isinstance(ty, VecTupleType):
                    # `float32x4x2_t vo;` then per-member assignment —
                    # the NEON idiom for assembling a vst2 operand.  The
                    # undef is pure register naming (no issue, no cost).
                    v = self.emit(Instr(
                        "intrin", (), self.val(ty, hint=s.name),
                        attrs={"intrinsic": "tuple.undef",
                               "isa_op": "tuple_undef",
                               "kind": "tuple_undef", "width_bits": 0}))
                else:
                    raise LowerError(f"vector local {s.name!r} needs an "
                                     f"initializer")
            else:
                v = self.expr(s.init, env)
                self._check_decl(ty, v, s.name)
            env[s.name] = v
        elif isinstance(s, C.Assign):
            self.assign(s, env)
        elif isinstance(s, C.ExprStmt):
            self.expr(s.expr, env, allow_void=True)
        elif isinstance(s, C.For):
            inner = dict(env)
            shadow = None
            if s.init is not None:
                self.stmt(s.init, inner)
                if isinstance(s.init, C.Decl):
                    # a for-scope declaration shadows any outer binding
                    # of the same name for the loop's extent only
                    shadow = s.init.name
            body = C.Block(stmts=list(s.body.stmts) +
                           ([s.step] if s.step is not None else []))
            self.while_loop(s.cond or C.Num(1), body, inner)
            # for-scope locals stay local; carried vars wrote through env
            for k in env:
                if k != shadow:
                    env[k] = inner[k]
        elif isinstance(s, C.While):
            self.while_loop(s.cond, s.body, env)
        elif isinstance(s, C.If):
            self.if_stmt(s, env)
        elif isinstance(s, C.Return):
            if s.value is not None:
                raise LowerError("subset kernels are void: outputs go "
                                 "through pointer params")
        else:
            raise LowerError(f"unsupported statement {type(s).__name__}")

    def _check_decl(self, ty: IRType, v: Value, name: str):
        if isinstance(ty, VecType):
            if not isinstance(v.type, VecType) or v.type.name != ty.name:
                raise LowerError(
                    f"decl {name!r}: declared {ty} but initializer has "
                    f"type {v.type}")
        if isinstance(ty, VecTupleType) and v.type != ty:
            raise LowerError(
                f"decl {name!r}: declared {ty} but initializer has "
                f"type {v.type}")
        if isinstance(ty, PtrType) and not isinstance(v.type, PtrType):
            raise LowerError(f"decl {name!r}: pointer initializer expected")

    # -- assignment -----------------------------------------------------
    def assign(self, s: C.Assign, env):
        t = s.target
        if isinstance(t, C.Name):
            cur = env.get(t.id)
            if cur is None:
                raise LowerError(f"assignment to undeclared {t.id!r}")
            rhs = (self.expr(s.value, env) if s.op == ""
                   else self.binop(s.op, cur, self.expr(s.value, env)))
            if isinstance(cur.type, VecType) and \
                    (not isinstance(rhs.type, VecType) or
                     rhs.type.name != cur.type.name):
                raise LowerError(f"{t.id!r}: register type changes from "
                                 f"{cur.type} to {rhs.type}")
            if isinstance(cur.type, VecTupleType) and \
                    rhs.type != cur.type:
                raise LowerError(f"{t.id!r}: register struct type changes "
                                 f"from {cur.type} to {rhs.type}")
            env[t.id] = rhs
        elif isinstance(t, C.Un) and t.op == "*":
            ptr = self.expr(t.expr, env)
            self.store_scalar(ptr, s, env)
        elif isinstance(t, C.Index) and isinstance(t.base, C.Member):
            self.member_assign(t, s, env)
        elif isinstance(t, C.Index):
            base = self.expr(t.base, env)
            idx = self.expr(t.index, env)
            ptr = self.ptradd(base, idx)
            self.store_scalar(ptr, s, env)
        else:
            raise LowerError(f"unsupported assignment target "
                             f"{type(t).__name__}")

    def member_assign(self, t: C.Index, s: C.Assign, env):
        """``x.val[k] = reg`` — functional update of a register struct
        (SSA: a fresh tuple value rebinds the variable)."""
        mem = t.base
        if not isinstance(mem.base, C.Name):
            raise LowerError("struct member assignment must target a "
                             "named register struct")
        cur = env.get(mem.base.id)
        if cur is None:
            raise LowerError(f"assignment to undeclared {mem.base.id!r}")
        k = self._member_index(mem, t.index, cur)
        if s.op != "":
            raise LowerError(f"{mem.base.id!r}.val[{k}]: compound "
                             f"assignment on struct members is out of "
                             f"the subset")
        val = self.expr(s.value, env)
        want = cur.type.elems[k]
        if not isinstance(val.type, VecType) or val.type != want:
            raise LowerError(f"{mem.base.id!r}.val[{k}]: expected {want}, "
                             f"got {val.type}")
        out = self.emit(Instr(
            "intrin", (cur, val), self.val(cur.type, hint=mem.base.id),
            attrs={"intrinsic": "tuple.set", "isa_op": "tuple_set",
                   "kind": "tuple_set", "index": k, "width_bits": 0}))
        env[mem.base.id] = out

    def _member_index(self, mem: "C.Member", index, cur: Value) -> int:
        line = getattr(mem, "line", 0) or None
        if mem.name != "val":
            raise LowerError(f"unknown struct member .{mem.name} (NEON "
                             f"register structs expose only .val)",
                             line=line)
        if not isinstance(cur.type, VecTupleType):
            raise LowerError(f".val on non-struct value of type "
                             f"{cur.type}", line=line)
        if not isinstance(index, C.Num) or not isinstance(index.value, int):
            raise LowerError(".val[] index must be an integer literal",
                             line=line)
        k = index.value
        if not 0 <= k < len(cur.type.elems):
            raise LowerError(f".val[{k}] out of range for {cur.type}",
                             line=line)
        return k

    def store_scalar(self, ptr: Value, s: C.Assign, env):
        if not isinstance(ptr.type, PtrType):
            raise LowerError("scalar store through a non-pointer")
        if ptr.type.const:
            raise LowerError(f"store through const pointer "
                             f"({self.root_of(ptr) or '?'})")
        val = self.expr(s.value, env)
        if s.op != "":
            loaded = self.emit(Instr("sload", (ptr,),
                                     self.val(ScalarType(ptr.type.elem))))
            val = self.binop(s.op, loaded, val)
        self.emit(Instr("sstore", (ptr, val)))
        root = self.root_of(ptr)
        if root and root not in self.writes:
            self.writes.append(root)

    # -- loops ------------------------------------------------------------
    def while_loop(self, cond_expr, body: C.Block, env):
        carried = [n for n in _assigned_names(body.stmts)
                   if n in env]
        phis = [self.val(env[n].type, hint=n) for n in carried]
        for n, p in zip(carried, phis):
            self.set_root(p, self.root_of(env[n]))
        init = [env[n] for n in carried]

        cond_block = Block()
        self.blocks.append(cond_block)
        cond_env = dict(env)
        cond_env.update(zip(carried, phis))
        cond_value = self.expr(cond_expr, env=cond_env)
        self.blocks.pop()
        if not isinstance(cond_value.type, ScalarType):
            raise LowerError("loop condition must be scalar (data-"
                             "dependent vector control flow is out of "
                             "the subset)")

        body_block = Block()
        self.blocks.append(body_block)
        body_env = dict(env)
        body_env.update(zip(carried, phis))
        self.block_stmts(body.stmts, body_env)
        self.blocks.pop()
        yields = [body_env[n] for n in carried]
        for p, y in zip(phis, yields):
            if isinstance(p.type, VecType) != isinstance(y.type, VecType):
                raise LowerError(f"loop-carried {p.hint!r} changes kind")

        results = [self.val(p.type, hint=p.hint) for p in phis]
        for r, p in zip(results, phis):
            self.set_root(r, self.root_of(p))
        self.emit(Loop(op="loop", args=tuple(init), phis=phis,
                       init=init, cond=cond_block, cond_value=cond_value,
                       body=body_block, yields=yields, results=results))
        env.update(zip(carried, results))

    def if_stmt(self, s: C.If, env):
        cond = self.expr(s.cond, env)
        assigned: List[str] = [n for n in
                               _assigned_names(s.then.stmts +
                                               (s.els.stmts if s.els else []))
                               if n in env]
        then_block, then_env = Block(), dict(env)
        self.blocks.append(then_block)
        self.block_stmts(s.then.stmts, then_env)
        self.blocks.pop()
        els_block, els_env = Block(), dict(env)
        if s.els is not None:
            self.blocks.append(els_block)
            self.block_stmts(s.els.stmts, els_env)
            self.blocks.pop()
        results = [self.val(env[n].type, hint=n) for n in assigned]
        for r, n in zip(results, assigned):
            self.set_root(r, self.root_of(env[n]))
        self.emit(IfOp(op="if", args=(cond,), cond_value=cond,
                       then=then_block,
                       then_yields=[then_env[n] for n in assigned],
                       els=els_block,
                       els_yields=[els_env[n] for n in assigned],
                       results=results))
        env.update(zip(assigned, results))

    # -- expressions ------------------------------------------------------
    def const(self, value, env, hint: str = "") -> Value:
        ty = ScalarType("float64" if isinstance(value, float) else "int64")
        return self.emit(Instr("const", (), self.val(ty, hint),
                               attrs={"value": value}))

    def expr(self, e, env, allow_void: bool = False) -> Optional[Value]:
        if isinstance(e, C.Num):
            return self.const(e.value, env)
        if isinstance(e, C.Name):
            v = env.get(e.id)
            if v is None:
                raise LowerError(f"use of undeclared {e.id!r}")
            return v
        if isinstance(e, C.Call):
            return self.call(e, env, allow_void=allow_void)
        if isinstance(e, C.Un):
            return self.unary(e, env)
        if isinstance(e, C.Bin):
            return self.binop(e.op, self.expr(e.lhs, env),
                              self.expr(e.rhs, env))
        if isinstance(e, C.Cast):
            return self.cast(e, env)
        if isinstance(e, C.Index) and isinstance(e.base, C.Member):
            tup = self.expr(e.base.base, env)
            k = self._member_index(e.base, e.index, tup)
            return self.emit(Instr(
                "intrin", (tup,), self.val(tup.type.elems[k]),
                attrs={"intrinsic": "tuple.get", "isa_op": "tuple_get",
                       "kind": "tuple_get", "index": k, "width_bits": 0}))
        if isinstance(e, C.Member):
            raise LowerError(f".{e.name}: struct members are registers — "
                             f"index them (.val[0] / .val[1])")
        if isinstance(e, C.Index):
            base = self.expr(e.base, env)
            ptr = self.ptradd(base, self.expr(e.index, env))
            return self.emit(Instr("sload", (ptr,),
                                   self.val(ScalarType(ptr.type.elem))))
        if isinstance(e, C.Ternary):
            c = self.expr(e.cond, env)
            a = self.expr(e.then, env)
            b = self.expr(e.els, env)
            if isinstance(a.type, VecType) or isinstance(b.type, VecType):
                raise LowerError("vector ternary: use vbsl")
            return self.emit(Instr("sselect", (c, a, b),
                                   self.val(a.type)))
        raise LowerError(f"unsupported expression {type(e).__name__}")

    def unary(self, e: C.Un, env) -> Value:
        if e.op == "*":
            ptr = self.expr(e.expr, env)
            if not isinstance(ptr.type, PtrType):
                raise LowerError("deref of a non-pointer")
            return self.emit(Instr("sload", (ptr,),
                                   self.val(ScalarType(ptr.type.elem))))
        v = self.expr(e.expr, env)
        if isinstance(v.type, VecType):
            raise LowerError(f"C operator {e.op!r} on a NEON register: "
                             f"use an intrinsic")
        op = {"-": "sneg", "!": "snot", "~": "sinv"}[e.op]
        return self.emit(Instr(op, (v,), self.val(v.type)))

    def binop(self, op: str, lhs: Value, rhs: Value) -> Value:
        if isinstance(lhs.type, VecType) or isinstance(rhs.type, VecType):
            raise LowerError(f"C operator {op!r} on a NEON register: "
                             f"use an intrinsic")
        if isinstance(lhs.type, PtrType):
            if op not in ("+", "-"):
                raise LowerError(f"pointer arithmetic {op!r} unsupported")
            if op == "-" and isinstance(rhs.type, PtrType):
                raise LowerError("pointer difference is out of the subset")
            delta = rhs
            if op == "-":
                delta = self.emit(Instr("sneg", (rhs,), self.val(rhs.type)))
            return self.ptradd(lhs, delta)
        if isinstance(rhs.type, PtrType):
            if op != "+":
                raise LowerError(f"pointer arithmetic {op!r} unsupported")
            return self.ptradd(rhs, lhs)
        if op in _CMP_OPS:
            return self.emit(Instr("scmp", (lhs, rhs),
                                   self.val(ScalarType("bool")),
                                   attrs={"op": op}))
        ty = lhs.type if lhs.type.dtype.startswith("float") or \
            not rhs.type.dtype.startswith("float") else rhs.type
        return self.emit(Instr("sbin", (lhs, rhs), self.val(ty),
                               attrs={"op": op}))

    def ptradd(self, ptr: Value, delta: Value) -> Value:
        if not isinstance(ptr.type, PtrType):
            raise LowerError(f"indexing / pointer arithmetic on a "
                             f"non-pointer value of type {ptr.type}")
        out = self.emit(Instr("ptradd", (ptr, delta),
                              self.val(ptr.type, hint=ptr.hint)))
        self.set_root(out, self.root_of(ptr))
        return out

    def cast(self, e: C.Cast, env) -> Value:
        v = self.expr(e.expr, env)
        ty = _ctype_to_ir(e.type, "cast")
        if isinstance(ty, PtrType):
            if not isinstance(v.type, PtrType):
                raise LowerError("casting a non-pointer to a pointer")
            out = self.emit(Instr("ptrcast", (v,), self.val(ty)))
            self.set_root(out, self.root_of(v))
            return out
        if isinstance(ty, VecType):
            raise LowerError("register reinterpret casts: use a "
                             "vreinterpret intrinsic (out of subset)")
        return self.emit(Instr("scast", (v,), self.val(ty)))

    # -- intrinsic calls ----------------------------------------------------
    def call(self, e: C.Call, env, allow_void: bool = False) -> Optional[Value]:
        line = getattr(e, "line", 0) or None
        try:
            spec = resolve(e.name)
        except UnknownIntrinsic:
            raise LowerError(
                f"unknown intrinsic {e.name!r}: not in the supported NEON "
                f"surface (see repro_torch.port.intrinsics)",
                line=line, intrinsic=e.name)
        if len(e.args) != len(spec.arg_types):
            raise LowerError(f"{e.name}: expected {len(spec.arg_types)} "
                             f"args, got {len(e.args)}",
                             line=line, intrinsic=e.name)
        args = []
        for i, (want, ae) in enumerate(zip(spec.arg_types, e.args)):
            v = self.expr(ae, env)
            self._check_arg(spec, i, want, v)
            args.append(v)
        result = (self.val(spec.result_type)
                  if spec.result_type is not None else None)
        self.emit(Instr("intrin", tuple(args), result,
                        attrs={"intrinsic": spec.name,
                               "isa_op": spec.isa_op,
                               "kind": spec.kind,
                               "width_bits": spec.width_bits,
                               "_line": getattr(e, "line", 0)}))
        if spec.kind in ("store", "store2"):
            ptr = args[0]
            if ptr.type.const:
                raise LowerError(f"{spec.name}: store through const "
                                 f"pointer {self.root_of(ptr) or '?'}")
            root = self.root_of(ptr)
            if root and root not in self.writes:
                self.writes.append(root)
        if result is None and not allow_void:
            raise LowerError(f"{e.name} returns void; cannot use its value")
        return result

    def _check_arg(self, spec: IntrinSpec, i: int, want, v: Value):
        label = f"{spec.name} arg {i}"
        if want == "imm":
            if not isinstance(v.type, ScalarType):
                raise LowerError(f"{label}: immediate expected")
            return
        if isinstance(want, VecTupleType):
            if v.type != want:
                raise LowerError(f"{label}: expected {want}, got {v.type}")
            return
        if isinstance(want, VecType):
            if not isinstance(v.type, VecType) or v.type.name != want.name:
                raise LowerError(f"{label}: expected {want}, got {v.type}")
        elif isinstance(want, PtrType):
            if not isinstance(v.type, PtrType) or v.type.elem != want.elem:
                raise LowerError(f"{label}: expected {want}, got {v.type}")
        elif isinstance(want, ScalarType):
            if not isinstance(v.type, ScalarType):
                raise LowerError(f"{label}: scalar expected, got {v.type}")


# ---------------------------------------------------------------------------
# Loop-carried variable discovery
# ---------------------------------------------------------------------------

def _assigned_names(stmts) -> List[str]:
    """Names assigned in ``stmts`` whose binding lives *outside* this
    statement list, in first-write order — the loop-carried candidates.

    Scope-aware: a declaration (at this level, or a nested for-init)
    shadows the name for exactly its own subtree, so an inner
    redeclaration of an outer name never hides the outer variable's
    own updates from the carried set.
    """
    out: List[str] = []
    declared: Set[str] = set()

    def note(n: str):
        if n not in declared and n not in out:
            out.append(n)

    for s in stmts:
        if isinstance(s, C.Decl):
            declared.add(s.name)
        elif isinstance(s, C.Assign):
            if isinstance(s.target, C.Name):
                note(s.target.id)
            elif isinstance(s.target, C.Index) and \
                    isinstance(s.target.base, C.Member) and \
                    isinstance(s.target.base.base, C.Name):
                # x.val[k] = ... rebinds x (functional tuple update)
                note(s.target.base.base.id)
        elif isinstance(s, C.Block):
            for n in _assigned_names(s.stmts):
                note(n)
        elif isinstance(s, C.For):
            shadow: Set[str] = set()
            if isinstance(s.init, C.Decl):
                shadow.add(s.init.name)
            elif isinstance(s.init, C.Assign) and \
                    isinstance(s.init.target, C.Name):
                note(s.init.target.id)
            inner = _assigned_names(
                list(s.body.stmts) +
                ([s.step] if s.step is not None else []))
            for n in inner:
                if n not in shadow:
                    note(n)
        elif isinstance(s, C.While):
            for n in _assigned_names(s.body.stmts):
                note(n)
        elif isinstance(s, C.If):
            for n in _assigned_names(s.then.stmts):
                note(n)
            if s.els is not None:
                for n in _assigned_names(s.els.stmts):
                    note(n)
    return out
