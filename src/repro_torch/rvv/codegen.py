"""Real RVV intrinsic codegen from the port frontend's (re-tiled) IR.

The paper's deliverable is SIMDe *emitting RVV intrinsics* for NEON
sources.  Everything upstream of this module stops at cost-model
estimates: ``revec_instrs`` counts abstract micro-ops.  This walker
turns the typed SSA IR (``port/lower.py`` output, optionally re-tiled by
``port/revec.py`` — masked predicated tails, LMUL register groups,
segment loads, widening/narrowing families included) into:

* a **program tree** of scalar statements and RVV vector instructions
  that :mod:`repro_torch.rvv.sim` executes on NumPy state, counting *retired*
  instructions; and
* **compilable RVV intrinsic C** (``render_c``) — one translation unit
  per (kernel, target), with a real ``vsetvli`` per strip carrying the
  ``e<sew>,m<lmul>`` selection.

Codegen contract (DESIGN.md §12):

* **vsetvli placement** — one explicit ``vsetvl`` whenever the active
  element count changes: hoisted above a strip loop when the body's
  count is loop-invariant, per-site around predicated (masked-tail)
  accesses with the site's runtime count as AVL, restored to the strip
  count afterwards.  SEW/LMUL-only changes (widening chains) emit no C
  — the simulator charges the compiler-inserted ``vsetvli`` they imply.
* **register groups** — every IR register gets EMUL = the smallest
  power of two whose group holds its lanes (never fractional; a
  narrower value simply runs at ``vl`` < VLMAX, exactly SIMDe's
  fixed-width behavior on wide VLA machines).  Widening families write
  2x-EMUL destinations at the narrow SEW.
* **masks and tails** — predicated loads are tail-undisturbed merges
  into a ``vmv.v.x``-built fill register (the re-vectorizer's exact
  fill semantics); predicated stores simply run at ``vl = cnt``.
  Everything else is tail-agnostic, and the simulator fills agnostic
  tail lanes with an adversarial all-ones pattern.

Every emitted mnemonic must appear in :data:`repro_torch.core.isa.
RVV_MNEMONICS` — the per-op metadata table is the single source of
truth for the supported-instruction set.

The emitted C is byte for byte that of the JAX package's
``repro.rvv.codegen`` (its header names that module), so one set of
committed ``examples/rvv_emitted`` files serves both.  IR lane dtypes
here are torch dtypes; every dtype question goes through numpy
(:func:`_npdt`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from ..core import targets as _targets
from ..core.isa import RVV_MNEMONICS, rvv_mnemonics
from ..core.vtypes import numpy_dtype
from ..port.ir import (Block, IfOp, Instr, Loop, PtrType, ScalarType,
                       TFunction, Value, VecTupleType, VecType)

__all__ = ["CodegenError", "RvvProgram", "emit", "render_c",
           "SConst", "SBin", "SUn", "SSel", "SLoad", "SStore", "SPtrAdd",
           "SCopy", "While", "If", "VSetVL", "V"]


class CodegenError(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# Program nodes (consumed by render_c below and repro_torch.rvv.sim)
# ---------------------------------------------------------------------------
#
# Scalar statements are three-address over named variables — the IR is
# already SSA, so operands are always variable names (phis and branch
# results become the only mutable variables).  Vector instructions
# carry everything both consumers need: the mnemonic, typed operands,
# the operating SEW, the destination register-group EMUL (retired
# micro-op charge), and the originating intrinsic site for the
# executed-vs-estimated attribution.

@dataclasses.dataclass
class SConst:
    dst: str
    ctype: str
    value: Any


@dataclasses.dataclass
class SBin:
    dst: str
    ctype: str
    op: str                        # sbin ops (+ - * / ...) or scmp ops
    a: str
    b: str


@dataclasses.dataclass
class SUn:
    dst: str
    ctype: str
    op: str                        # "neg" | "not" | "inv" | "cast"
    a: str
    dtype: Optional[str] = None    # numpy dtype name for casts


@dataclasses.dataclass
class SSel:
    dst: str
    ctype: str
    c: str
    a: str
    b: str


@dataclasses.dataclass
class SLoad:
    dst: str
    ctype: str
    ptr: str
    dtype: str                     # element numpy dtype name


@dataclasses.dataclass
class SStore:
    ptr: str
    val: str
    dtype: str


@dataclasses.dataclass
class SPtrAdd:
    dst: str
    ctype: str                     # the pointer's C type
    base: str
    delta: str


@dataclasses.dataclass
class SCopy:
    dst: str
    src: str
    ctype: str
    declare: bool = True           # False: assignment to a pre-declared var


@dataclasses.dataclass
class PreDecl:
    var: str
    ctype: str


@dataclasses.dataclass
class While:
    cond_stmts: List[Any]
    cond: str
    body: List[Any]


@dataclasses.dataclass
class If:
    cond: str
    then: List[Any]
    els: List[Any]


@dataclasses.dataclass
class VSetVL:
    dst: str                       # the vl variable
    avl: Union[str, int]           # variable name or static count
    sew: int
    lmul: int                      # the requesting op's EMUL


@dataclasses.dataclass
class V:
    """One RVV vector instruction (or a free register-file rename)."""
    mnem: str                      # "vadd.vv", "vle", "vlseg", ...
    dst: Any                       # vreg | (vregs...) | scalar var | None
    srcs: Tuple[Any, ...]          # ("v",name) ("x",var) ("i",imm)
                                   # ("p",var) ("m",name) ("vt",names)
    dtype: str                     # dest element dtype (src for stores)
    sew: int                       # operating SEW in bits
    emul: int                      # dest register-group EMUL (uop charge)
    vl: Union[str, int]            # vl variable in scope (C rendering)
    dtype_src: Optional[str] = None   # source dtype when it differs
    policy: str = "ta"             # tail policy: "ta" | "tu"
    merge: Any = None              # maskedoff operand for tu forms
    vxrm: Optional[str] = None     # "rnu"|"rne"|"rdn"|"rod"
    seg: int = 0                   # segment arity (vlseg/vsseg)
    site: str = ""                 # originating intrinsic label
    free: bool = False             # retires nothing (vreinterpret, vget)


@dataclasses.dataclass
class RvvProgram:
    """Emitted unit: the program tree plus everything needed to run it
    (sim) or print it (render_c)."""
    fn_name: str
    target: Any                    # resolved Target
    params: List[Tuple[str, Any]]  # (name, IR type) in call order
    writes: List[str]
    body: List[Any]
    retiling: Any = None           # RetileResult when revec applied

    @property
    def c_name(self) -> str:
        return f"{self.fn_name}__{self.target.name.replace('-', '_')}"

    def render_c(self) -> str:
        return render_c(self)


# ---------------------------------------------------------------------------
# dtype helpers
# ---------------------------------------------------------------------------

_CTYPE = {"size_t": "size_t", "bool": "bool",
          "float32": "float", "float64": "double"}


def _npdt(dtype) -> np.dtype:
    """The numpy dtype of an IR lane dtype (a torch dtype, a numpy
    dtype or its name)."""
    try:
        return np.dtype(dtype)
    except TypeError:
        return numpy_dtype(dtype)


def _dtname(dtype) -> str:
    return _npdt(dtype).name


def _sew(dtype) -> int:
    return _npdt(dtype).itemsize * 8


def _sctype(dtype) -> str:
    name = _dtname(dtype)
    return _CTYPE.get(name, f"{name}_t")


def _dclass(dtype: str) -> str:
    k = _npdt(dtype).kind
    return {"f": "float", "u": "uint", "i": "int"}[k]


def _emul_for(lanes: int, dtype: str, vlen: int) -> int:
    """Smallest power-of-two register group holding ``lanes`` elements
    (min m1 — narrower values run at vl < VLMAX instead of fractional
    LMUL, SIMDe's fixed-width-on-VLA behavior)."""
    emul = 1
    while emul * vlen < lanes * _sew(dtype):
        emul *= 2
    if emul > 8:
        raise CodegenError(
            f"{lanes} lanes of {dtype} need LMUL={emul} > 8 on "
            f"vlen={vlen} (register group does not exist)")
    return emul




def _ctype(t) -> str:
    if isinstance(t, ScalarType):
        d = t.dtype
        if d in ("size_t", "bool"):
            return _CTYPE[d]
        return _sctype(d)
    if isinstance(t, PtrType):
        c = "const " if t.const else ""
        elem = _CTYPE.get(t.elem, f"{t.elem}_t")
        return f"{c}{elem} *"
    raise CodegenError(f"no scalar C type for {t}")


def _vctype(dtype: str, emul: int) -> str:
    k = _npdt(dtype).kind
    bits = _sew(dtype)
    base = {"f": f"float{bits}", "i": f"int{bits}", "u": f"uint{bits}"}[k]
    return f"v{base}m{emul}_t"


def _vt_suffix(dtype: str, emul: int) -> str:
    k = _npdt(dtype).kind
    bits = _sew(dtype)
    return {"f": f"f{bits}", "i": f"i{bits}", "u": f"u{bits}"}[k] + \
        f"m{emul}"


# ---------------------------------------------------------------------------
# The emitter
# ---------------------------------------------------------------------------

class _Emit:
    def __init__(self, fn: TFunction, target):
        self.fn = fn
        self.target = target
        self.vlen = target.vlen
        self.names: Dict[Value, Any] = {}
        self.n = 0
        self.nvl = 0
        # active vl state: (count, sew, emul, vl_var); count is an int
        # (static), a str (runtime cnt variable), or None (unknown)
        self.vl_state: Tuple[Any, int, int, Optional[str]] = \
            (None, 0, 0, None)
        # single-use vshr_n sites fused into a rounding vnclip
        self.defs: Dict[Value, Instr] = {}
        self.uses: Dict[Value, int] = {}
        self._index(fn.body)
        self.fused_shift: Dict[Value, Tuple[Value, Value]] = {}
        # loop-invariant group-broadcast gather indices, built once in
        # the program preamble and reused by every load site
        self.preamble: List[Any] = []
        self._gidx: Dict[Tuple[int, int, int], str] = {}

    # -- bookkeeping -------------------------------------------------------
    def _index(self, block: Block):
        for ins in block.instrs:
            if ins.result is not None:
                self.defs[ins.result] = ins
            for a in ins.args:
                self.uses[a] = self.uses.get(a, 0) + 1
            if isinstance(ins, Loop):
                for v in list(ins.init) + list(ins.yields):
                    self.uses[v] = self.uses.get(v, 0) + 1
                self._index(ins.cond)
                self._index(ins.body)
            elif isinstance(ins, IfOp):
                for v in list(ins.then_yields) + list(ins.els_yields):
                    self.uses[v] = self.uses.get(v, 0) + 1
                self._index(ins.then)
                self._index(ins.els)

    def fresh(self, prefix: str) -> str:
        self.n += 1
        return f"{prefix}{self.n}"

    def name_of(self, v: Value) -> Any:
        try:
            return self.names[v]
        except KeyError:
            raise CodegenError(f"use of value {v!r} before definition")

    def bind(self, v: Value) -> Any:
        if isinstance(v.type, VecTupleType):
            n = self.names[v] = tuple(self.fresh("v")
                                      for _ in v.type.elems)
        elif isinstance(v.type, VecType):
            n = self.names[v] = self.fresh("v")
        elif isinstance(v.type, PtrType):
            n = self.names[v] = self.fresh("p")
        else:
            n = self.names[v] = self.fresh("s")
        return n

    # -- vl management -----------------------------------------------------
    def ensure_vl(self, out: List[Any], count, sew: int, emul: int):
        """Emit a vsetvl if the active element count must change.
        SEW/LMUL-only switches stay implicit (the simulator charges
        them); the C never needs them because intrinsics carry vl."""
        cur = self.vl_state
        if cur[0] == count and cur[3] is not None:
            return
        var = f"vl{self.nvl}"
        self.nvl += 1
        out.append(VSetVL(var, count, sew, emul))
        self.vl_state = (count, sew, emul, var)

    @property
    def vl_var(self) -> str:
        if self.vl_state[3] is None:
            raise CodegenError("vector op emitted before any vsetvl")
        return self.vl_state[3]

    def _mnems(self, isa_op: str, dclass: str) -> Tuple[str, ...]:
        seq = rvv_mnemonics(isa_op, dclass)
        if seq is None:
            raise CodegenError(
                f"no RVV lowering registered for isa op {isa_op!r} "
                f"({dclass}); see repro_torch.core.isa.RVV_MNEMONICS")
        return seq

    def _v(self, out, mnem, dst, srcs, dtype, lanes, *, site,
           dtype_src=None, sew=None, vxrm=None, policy="ta", merge=None,
           seg=0, free=False, emul=None):
        emul = emul if emul is not None else \
            _emul_for(lanes, dtype, self.vlen)
        out.append(V(mnem=mnem, dst=dst, srcs=tuple(srcs),
                     dtype=_dtname(dtype),
                     sew=sew or _sew(dtype_src or dtype), emul=emul,
                     vl=self.vl_state[3] or 0,
                     dtype_src=(_dtname(dtype_src)
                                if dtype_src is not None else None),
                     policy=policy, merge=merge, vxrm=vxrm, seg=seg,
                     site=site, free=free))

    # -- region walking ----------------------------------------------------
    def block(self, b: Block, out: List[Any]):
        for ins in b.instrs:
            if isinstance(ins, Loop):
                self.loop(ins, out)
            elif isinstance(ins, IfOp):
                self.if_op(ins, out)
            else:
                self.instr(ins, out)

    def loop(self, ins: Loop, out: List[Any]):
        # phis become the only mutable variables: pre-declared, seeded
        # from init, re-assigned from yields at the end of the body
        for phi, init in zip(ins.phis, ins.init):
            var = self.bind(phi)
            ct = self._phi_ctype(phi)
            src = self.name_of(init)
            if isinstance(var, tuple):
                raise CodegenError("tuple-typed loop phi unsupported")
            out.append(SCopy(var, src, ct, declare=True))
        cond_stmts: List[Any] = []
        self.block(ins.cond, cond_stmts)
        cond_var = self.name_of(ins.cond_value)

        entry_state = self.vl_state
        body: List[Any] = []
        self.block(ins.body, body)
        for phi, y in zip(ins.phis, ins.yields):
            out_var = self.names[phi]
            body.append(SCopy(out_var, self.name_of(y),
                              self._phi_ctype(phi), declare=False))
        # hoist a loop-invariant leading vsetvl above the loop: the
        # "one vsetvli per strip" contract
        hoisted = None
        for i, st in enumerate(body):
            if isinstance(st, VSetVL):
                if isinstance(st.avl, int) and i == _first_vec(body):
                    hoisted = body.pop(i)
                break
            if _is_vec(st):
                break
        if hoisted is not None:
            out.append(hoisted)
            entry_state = (hoisted.avl, hoisted.sew, hoisted.lmul,
                           hoisted.dst)
        # iteration invariance: a body that drifts the element count
        # (vget_high narrowing, masked sites without restore) resets it
        if any(_is_vec(st) or isinstance(st, (While, If))
               for st in body) and self.vl_state != entry_state:
            if entry_state[3] is not None and \
                    isinstance(entry_state[0], int):
                var = f"vl{self.nvl}"
                self.nvl += 1
                body.append(VSetVL(var, entry_state[0], entry_state[1],
                                   entry_state[2]))
                self.vl_state = (entry_state[0], entry_state[1],
                                 entry_state[2], var)
            else:
                self.vl_state = (None, 0, 0, self.vl_state[3])
        out.append(While(cond_stmts, cond_var, body))
        for res, phi in zip(ins.results, ins.phis):
            var = self.bind(res)
            out.append(SCopy(var, self.names[phi],
                             self._phi_ctype(phi), declare=True))

    def _phi_ctype(self, phi: Value) -> str:
        if isinstance(phi.type, VecType):
            return _vctype(phi.type.dtype,
                           _emul_for(phi.type.lanes, phi.type.dtype,
                                     self.vlen))
        return _ctype(phi.type)

    def if_op(self, ins: IfOp, out: List[Any]):
        cond = self.name_of(ins.cond_value)
        res_vars = []
        for res in ins.results:
            var = self.bind(res)
            ct = self._phi_ctype(res)
            out.append(PreDecl(var, ct))
            res_vars.append((var, ct))
        saved = self.vl_state
        then: List[Any] = []
        self.block(ins.then, then)
        for (var, ct), y in zip(res_vars, ins.then_yields):
            then.append(SCopy(var, self.name_of(y), ct, declare=False))
        st_then = self.vl_state
        self.vl_state = saved
        els: List[Any] = []
        self.block(ins.els, els)
        for (var, ct), y in zip(res_vars, ins.els_yields):
            els.append(SCopy(var, self.name_of(y), ct, declare=False))
        if st_then != self.vl_state:
            self.vl_state = (None, 0, 0, self.vl_state[3])
        out.append(If(cond, then, els))

    # -- straight-line instructions ---------------------------------------
    def instr(self, ins: Instr, out: List[Any]):  # noqa: C901
        op = ins.op
        if op == "const":
            var = self.bind(ins.result)
            out.append(SConst(var, _ctype(ins.result.type),
                              ins.attrs["value"]))
        elif op == "sbin":
            var = self.bind(ins.result)
            out.append(SBin(var, _ctype(ins.result.type),
                            ins.attrs["op"], self.name_of(ins.args[0]),
                            self.name_of(ins.args[1])))
        elif op == "scmp":
            var = self.bind(ins.result)
            out.append(SBin(var, _ctype(ins.result.type),
                            ins.attrs["op"], self.name_of(ins.args[0]),
                            self.name_of(ins.args[1])))
        elif op == "sneg":
            var = self.bind(ins.result)
            out.append(SUn(var, _ctype(ins.result.type), "neg",
                           self.name_of(ins.args[0])))
        elif op == "snot":
            var = self.bind(ins.result)
            out.append(SUn(var, _ctype(ins.result.type), "not",
                           self.name_of(ins.args[0])))
        elif op == "sinv":
            var = self.bind(ins.result)
            out.append(SUn(var, _ctype(ins.result.type), "inv",
                           self.name_of(ins.args[0])))
        elif op == "sselect":
            var = self.bind(ins.result)
            out.append(SSel(var, _ctype(ins.result.type),
                            *(self.name_of(a) for a in ins.args)))
        elif op == "scast":
            var = self.bind(ins.result)
            out.append(SUn(var, _ctype(ins.result.type), "cast",
                           self.name_of(ins.args[0]),
                           dtype=_dtname(ins.result.type.dtype)))
        elif op == "ptradd":
            var = self.bind(ins.result)
            out.append(SPtrAdd(var, _ctype(ins.result.type),
                               self.name_of(ins.args[0]),
                               self.name_of(ins.args[1])))
        elif op == "ptrcast":
            self.names[ins.result] = self.name_of(ins.args[0])
        elif op == "sload":
            var = self.bind(ins.result)
            ptr = self.name_of(ins.args[0])
            out.append(SLoad(var, _ctype(ins.result.type), ptr,
                             _dtname(ins.args[0].type.elem)))
        elif op == "sstore":
            ptr = self.name_of(ins.args[0])
            out.append(SStore(ptr, self.name_of(ins.args[1]),
                              _dtname(ins.args[0].type.elem)))
        elif op == "intrin":
            self.intrin(ins, out)
        else:
            raise CodegenError(f"unknown IR op {op!r}")

    # -- intrinsic sites ---------------------------------------------------
    def intrin(self, ins: Instr, out: List[Any]):  # noqa: C901
        kind = ins.attrs["kind"]
        isa_op = ins.attrs["isa_op"]
        site = ins.attrs["intrinsic"]
        rty = ins.result.type if ins.result is not None else None

        # pure register-file renames
        if kind == "tuple_get":
            tup = self.name_of(ins.args[0])
            self.names[ins.result] = tup[ins.attrs["index"]]
            return
        if kind == "tuple_undef":
            self.names[ins.result] = tuple(None for _ in rty.elems)
            return
        if kind == "tuple_set":
            tup = list(self.name_of(ins.args[0]))
            tup[ins.attrs["index"]] = self.name_of(ins.args[1])
            self.names[ins.result] = tuple(tup)
            return

        if kind == "vv":
            self._emit_vv(ins, isa_op, site, out)
        elif kind == "dup":
            dt = rty.dtype
            self.ensure_vl(out, rty.lanes, _sew(dt),
                           _emul_for(rty.lanes, dt, self.vlen))
            dst = self.bind(ins.result)
            mnem, = self._mnems("vdup", _dclass(dt))
            self._v(out, mnem, dst, [("x", self.name_of(ins.args[0]))],
                    dt, rty.lanes, site=site)
        elif kind == "load_dup":
            dt = rty.dtype
            ptr = self.name_of(ins.args[0])
            sv = self.fresh("s")
            out.append(SLoad(sv, _sctype(dt), ptr, dt))
            self.ensure_vl(out, rty.lanes, _sew(dt),
                           _emul_for(rty.lanes, dt, self.vlen))
            dst = self.bind(ins.result)
            mnem, = self._mnems("vdup", _dclass(dt))
            self._v(out, mnem, dst, [("x", sv)], dt, rty.lanes,
                    site=site)
        elif kind == "load":
            dt = rty.dtype
            self.ensure_vl(out, rty.lanes, _sew(dt),
                           _emul_for(rty.lanes, dt, self.vlen))
            dst = self.bind(ins.result)
            self._v(out, "vle", dst,
                    [("p", self.name_of(ins.args[0]))], dt, rty.lanes,
                    site=site)
        elif kind == "load_group":
            self._emit_group_load(ins, site, out, masked=False)
        elif kind == "load_group_masked":
            self._emit_group_load(ins, site, out, masked=True)
        elif kind == "fold":
            self._emit_fold(ins, site, out)
        elif kind == "load_masked":
            self._emit_masked_load(ins, site, out)
        elif kind == "store":
            val = ins.args[1]
            dt = val.type.dtype
            self.ensure_vl(out, val.type.lanes, _sew(dt),
                           _emul_for(val.type.lanes, dt, self.vlen))
            self._v(out, "vse", None,
                    [("p", self.name_of(ins.args[0])),
                     ("v", self.name_of(val))], dt, val.type.lanes,
                    site=site)
        elif kind == "store_masked":
            val = ins.args[1]
            dt = val.type.dtype
            cnt = self.name_of(ins.args[2])
            sew = _sew(dt)
            emul = _emul_for(val.type.lanes, dt, self.vlen)
            self.ensure_vl(out, cnt, sew, emul)
            self._v(out, "vse", None,
                    [("p", self.name_of(ins.args[0])),
                     ("v", self.name_of(val))], dt, val.type.lanes,
                    site=site, emul=emul)
        elif kind == "load2":
            dt = rty.dtype
            n = len(rty.elems)
            self.ensure_vl(out, rty.lanes, _sew(dt),
                           _emul_for(rty.lanes, dt, self.vlen))
            dst = self.bind(ins.result)
            self._v(out, "vlseg", dst,
                    [("p", self.name_of(ins.args[0]))], dt, rty.lanes,
                    site=site, seg=n)
        elif kind == "load2_masked":
            self._emit_masked_segload(ins, site, out)
        elif kind == "store2":
            tup = ins.args[1]
            dt = tup.type.dtype
            n = len(tup.type.elems)
            self.ensure_vl(out, tup.type.lanes, _sew(dt),
                           _emul_for(tup.type.lanes, dt, self.vlen))
            self._v(out, "vsseg", None,
                    [("p", self.name_of(ins.args[0])),
                     ("vt", self.name_of(tup))], dt, tup.type.lanes,
                    site=site, seg=n)
        elif kind == "store2_masked":
            tup = ins.args[1]
            dt = tup.type.dtype
            n = len(tup.type.elems)
            cnt = self.name_of(ins.args[2])
            emul = _emul_for(tup.type.lanes, dt, self.vlen)
            self.ensure_vl(out, cnt, _sew(dt), emul)
            self._v(out, "vsseg", None,
                    [("p", self.name_of(ins.args[0])),
                     ("vt", self.name_of(tup))], dt, tup.type.lanes,
                    site=site, seg=n, emul=emul)
        elif kind == "tile":
            self._emit_tile(ins, site, out)
        elif kind == "shift":
            self._emit_shift(ins, isa_op, site, out)
        elif kind == "reduce":
            self._emit_reduce(ins, isa_op, site, out)
        elif kind == "cvt":
            self._emit_cvt(ins, isa_op, site, out)
        elif kind == "reinterpret":
            src = ins.args[0]
            dst = self.bind(ins.result)
            self._v(out, "vreinterpret", dst,
                    [("v", self.name_of(src))], rty.dtype, rty.lanes,
                    site=site, dtype_src=src.type.dtype, free=True)
        elif kind == "vv_cvt":
            self._emit_widening(ins, isa_op, site, out)
        elif kind == "get_lane":
            self._emit_get_lane(ins, site, out)
        else:
            raise CodegenError(f"unknown intrinsic kind {kind!r}")

    # -- families ---------------------------------------------------------
    def _emit_vv(self, ins, isa_op, site, out):  # noqa: C901
        rty = ins.result.type
        dt = rty.dtype
        dc = _dclass(dt)
        lanes = rty.lanes
        args = [self.name_of(a) for a in ins.args]

        if isa_op in ("vget_high", "vget_low"):
            src = ins.args[0]
            self.ensure_vl(out, lanes, _sew(dt),
                           _emul_for(lanes, dt, self.vlen))
            dst = self.bind(ins.result)
            mnem, = self._mnems(isa_op, dc)
            if isa_op == "vget_high":
                self._v(out, mnem, dst,
                        [("v", args[0]), ("i", src.type.lanes // 2)],
                        dt, lanes, site=site)
            else:
                self._v(out, mnem, dst, [("v", args[0])], dt, lanes,
                        site=site)
            return

        if isa_op == "vcombine":
            half = ins.args[0].type.lanes
            self.ensure_vl(out, lanes, _sew(dt),
                           _emul_for(lanes, dt, self.vlen))
            dst = self.bind(ins.result)
            mv, slide = self._mnems(isa_op, dc)
            t = self.fresh("v")
            self._v(out, mv, t, [("v", args[0])], dt, lanes, site=site)
            self._v(out, slide, dst,
                    [("v", t), ("v", args[1]), ("i", half)], dt, lanes,
                    site=site)
            return

        if isa_op in ("vceq", "vcgt", "vcge", "vclt", "vcle"):
            # Listing 6: vmv zeros + mask compare + merge all-ones.
            # vcgt(a,b) compares via the *less-than* mask with operands
            # swapped (vmslt b,a), matching the table's expansion.
            src_dt = ins.args[0].type.dtype
            self.ensure_vl(out, lanes, _sew(dt),
                           _emul_for(lanes, dt, self.vlen))
            dst = self.bind(ins.result)
            mv, cmp_m, merge = self._mnems(isa_op, _dclass(src_dt))
            zero = self.fresh("s")
            out.append(SConst(zero, _sctype(dt), 0))
            zreg = self.fresh("v")
            self._v(out, mv, zreg, [("x", zero)], dt, lanes, site=site)
            a, b = args[0], args[1]
            if isa_op in ("vcgt", "vcge"):
                a, b = b, a            # a>b  <=>  b<a
            m = self.fresh("m")
            self._v(out, cmp_m, m, [("v", a), ("v", b)], src_dt, lanes,
                    site=site)
            ones = self.fresh("s")
            out.append(SConst(ones, _sctype(dt), -1))
            self._v(out, merge, dst,
                    [("v", zreg), ("x", ones), ("m", m)], dt, lanes,
                    site=site)
            return

        if isa_op == "vbsl":
            sel_dt = ins.args[0].type.dtype
            self.ensure_vl(out, lanes, _sew(dt),
                           _emul_for(lanes, dt, self.vlen))
            dst = self.bind(ins.result)
            msne, merge = self._mnems(isa_op, dc)
            zero = self.fresh("s")
            out.append(SConst(zero, _sctype(sel_dt),
                              0))
            m = self.fresh("m")
            self._v(out, msne, m, [("v", args[0]), ("x", zero)], sel_dt,
                    lanes, site=site)
            self._v(out, merge, dst,
                    [("v", args[2]), ("v", args[1]), ("m", m)], dt,
                    lanes, site=site)
            return

        if isa_op == "vrbit":
            self.ensure_vl(out, lanes, _sew(dt),
                           _emul_for(lanes, dt, self.vlen))
            x = args[0]
            stages = ((1, 0x55), (2, 0x33), (4, 0x0F))
            for shamt, magic in stages:
                mvar = self.fresh("s")
                out.append(SConst(mvar, "uint8_t", magic))
                t1, t2 = self.fresh("v"), self.fresh("v")
                t1b, t2b = self.fresh("v"), self.fresh("v")
                nxt = self.fresh("v")
                self._v(out, "vsrl.vi", t1, [("v", x), ("i", shamt)],
                        dt, lanes, site=site)
                self._v(out, "vand.vx", t1b, [("v", t1), ("x", mvar)],
                        dt, lanes, site=site)
                self._v(out, "vand.vx", t2, [("v", x), ("x", mvar)],
                        dt, lanes, site=site)
                self._v(out, "vsll.vi", t2b, [("v", t2), ("i", shamt)],
                        dt, lanes, site=site)
                self._v(out, "vor.vv", nxt, [("v", t1b), ("v", t2b)],
                        dt, lanes, site=site)
                x = nxt
            self.names[ins.result] = x
            return

        if isa_op == "vrecpe":
            self.ensure_vl(out, lanes, _sew(dt),
                           _emul_for(lanes, dt, self.vlen))
            dst = self.bind(ins.result)
            mnem, = self._mnems(isa_op, dc)
            one = self.fresh("s")
            out.append(SConst(one, _sctype(dt), 1.0))
            self._v(out, mnem, dst, [("v", args[0]), ("x", one)], dt,
                    lanes, site=site)
            return
        if isa_op == "vrecps":
            self.ensure_vl(out, lanes, _sew(dt),
                           _emul_for(lanes, dt, self.vlen))
            dst = self.bind(ins.result)
            fmul, frsub = self._mnems(isa_op, dc)
            t = self.fresh("v")
            self._v(out, fmul, t, [("v", args[0]), ("v", args[1])], dt,
                    lanes, site=site)
            two = self.fresh("s")
            out.append(SConst(two, _sctype(dt), 2.0))
            self._v(out, frsub, dst, [("v", t), ("x", two)], dt, lanes,
                    site=site)
            return
        if isa_op == "vrsqrte":
            self.ensure_vl(out, lanes, _sew(dt),
                           _emul_for(lanes, dt, self.vlen))
            dst = self.bind(ins.result)
            fsqrt, frdiv = self._mnems(isa_op, dc)
            t = self.fresh("v")
            self._v(out, fsqrt, t, [("v", args[0])], dt, lanes,
                    site=site)
            one = self.fresh("s")
            out.append(SConst(one, _sctype(dt), 1.0))
            self._v(out, frdiv, dst, [("v", t), ("x", one)], dt, lanes,
                    site=site)
            return
        if isa_op == "vrsqrts":
            self.ensure_vl(out, lanes, _sew(dt),
                           _emul_for(lanes, dt, self.vlen))
            dst = self.bind(ins.result)
            fmul, frsub, fmulf = self._mnems(isa_op, dc)
            t, t2 = self.fresh("v"), self.fresh("v")
            self._v(out, fmul, t, [("v", args[0]), ("v", args[1])], dt,
                    lanes, site=site)
            three = self.fresh("s")
            out.append(SConst(three, _sctype(dt), 3.0))
            self._v(out, frsub, t2, [("v", t), ("x", three)], dt,
                    lanes, site=site)
            half = self.fresh("s")
            out.append(SConst(half, _sctype(dt), 0.5))
            self._v(out, fmulf, dst, [("v", t2), ("x", half)], dt,
                    lanes, site=site)
            return

        if isa_op in ("vmla", "vmls", "vfma"):
            self.ensure_vl(out, lanes, _sew(dt),
                           _emul_for(lanes, dt, self.vlen))
            dst = self.bind(ins.result)
            mnem, = self._mnems(isa_op, dc)
            self._v(out, mnem, dst,
                    [("v", args[0]), ("v", args[1]), ("v", args[2])],
                    dt, lanes, site=site)
            return

        # plain two-operand table ops (vadd/vmul/vmax/veor/vqadd/...)
        mnems = self._mnems(isa_op, dc)
        if len(mnems) != 1 or len(args) != 2:
            raise CodegenError(f"no emitter for vv op {isa_op!r}")
        self.ensure_vl(out, lanes, _sew(dt),
                       _emul_for(lanes, dt, self.vlen))
        dst = self.bind(ins.result)
        self._v(out, mnems[0], dst, [("v", args[0]), ("v", args[1])],
                dt, lanes, site=site)

    def _emit_masked_load(self, ins, site, out):
        rty = ins.result.type
        dt = rty.dtype
        sew = _sew(dt)
        emul = _emul_for(rty.lanes, dt, self.vlen)
        cnt = self.name_of(ins.args[1])
        fill = ins.attrs.get("fill", 0)
        # the fill register is built at the full register length, so
        # tail-undisturbed lanes beyond cnt read as the re-vectorizer's
        # fill value
        self.ensure_vl(out, rty.lanes, sew, emul)
        fv = self.fresh("s")
        out.append(SConst(fv, _sctype(dt), fill))
        freg = self.fresh("v")
        mv = "vfmv.v.f" if _npdt(dt).kind == "f" else "vmv.v.x"
        self._v(out, mv, freg, [("x", fv)], dt, rty.lanes, site=site)
        self.ensure_vl(out, cnt, sew, emul)
        dst = self.bind(ins.result)
        self._v(out, "vle", dst, [("p", self.name_of(ins.args[0]))],
                dt, rty.lanes, site=site, policy="tu", merge=freg,
                emul=emul)
        self.ensure_vl(out, rty.lanes, sew, emul)

    def _group_index(self, lanes: int, reps: int, dt) -> str:
        """The gather index for a group-broadcast load
        (idx = lane >> log2(reps)) is loop-invariant: build it once in
        the program preamble, memoized per (lanes, reps, sew)."""
        sew = _sew(dt)
        key = (lanes, reps, sew)
        reg = self._gidx.get(key)
        if reg is not None:
            return reg
        idt = f"uint{sew}"
        emul = _emul_for(lanes, dt, self.vlen)
        var = f"vl{self.nvl}"
        self.nvl += 1
        self.preamble.append(VSetVL(var, lanes, sew, emul))
        idx = self.fresh("v")
        self.preamble.append(V(mnem="vid.v", dst=idx, srcs=(),
                               dtype=idt, sew=sew, emul=emul, vl=var,
                               site="revec.group_index"))
        sh = self.fresh("s")
        self.preamble.append(SConst(sh, f"{idt}_t",
                                    reps.bit_length() - 1))
        reg = self.fresh("v")
        self.preamble.append(V(mnem="vsrl.vx", dst=reg,
                               srcs=(("v", idx), ("x", sh)),
                               dtype=idt, sew=sew, emul=emul, vl=var,
                               site="revec.group_index"))
        self._gidx[key] = reg
        return reg

    def _emit_group_load(self, ins, site, out, *, masked):
        """Widened walking broadcast (re-vectorized vld1_dup): load one
        element per widened group, then vrgather each group's scalar
        across its `reps` lanes via the preamble-hoisted index.  The
        masked form loads only the first `cnt` groups tail-undisturbed
        over a fill register, matching the narrow scalar-tail
        residue."""
        rty = ins.result.type
        dt = rty.dtype
        sew = _sew(dt)
        lanes = rty.lanes
        reps = ins.attrs["reps"]
        if reps & (reps - 1):
            raise CodegenError("group load reps must be a power of 2")
        groups = ins.attrs["groups"]
        emul = _emul_for(lanes, dt, self.vlen)
        idx = self._group_index(lanes, reps, dt)
        gv = self.fresh("v")
        if masked:
            fill = ins.attrs.get("fill", 0)
            self.ensure_vl(out, groups, sew, emul)
            fv = self.fresh("s")
            out.append(SConst(fv, _sctype(dt), fill))
            mv = "vfmv.v.f" if _npdt(dt).kind == "f" else "vmv.v.x"
            self._v(out, mv, gv, [("x", fv)], dt, groups, site=site,
                    emul=emul)
            self.ensure_vl(out, self.name_of(ins.args[1]), sew, emul)
            self._v(out, "vle", gv, [("p", self.name_of(ins.args[0]))],
                    dt, groups, site=site, policy="tu", merge=gv,
                    emul=emul)
        else:
            self.ensure_vl(out, groups, sew, emul)
            self._v(out, "vle", gv, [("p", self.name_of(ins.args[0]))],
                    dt, groups, site=site, emul=emul)
        self.ensure_vl(out, lanes, sew, emul)
        dst = self.bind(ins.result)
        self._v(out, "vrgather.vv", dst, [("v", gv), ("v", idx)], dt,
                lanes, site=site)

    def _emit_fold(self, ins, site, out):
        """Additive fold of a widened accumulator back to its narrow
        shape: log2(factor) halving slidedown+add steps.  Integer adds
        are modular, so the fold is bitwise-exact regardless of the
        summation order."""
        rty = ins.result.type
        dt = rty.dtype
        src = ins.args[0]
        cur_lanes = src.type.lanes
        if cur_lanes % rty.lanes or \
                (cur_lanes // rty.lanes) & (cur_lanes // rty.lanes - 1):
            raise CodegenError("fold factor must be a power of 2")
        cur = self.name_of(src)
        add = "vfadd.vv" if _npdt(dt).kind == "f" else "vadd.vv"
        while cur_lanes > rty.lanes:
            half = cur_lanes // 2
            src_emul = _emul_for(cur_lanes, dt, self.vlen)
            self.ensure_vl(out, half, _sew(dt), src_emul)
            tmp = self.fresh("v")
            self._v(out, "vslidedown.vx", tmp,
                    [("v", cur), ("i", half)], dt, half, site=site,
                    emul=src_emul)
            nxt = self.fresh("v")
            self._v(out, add, nxt, [("v", cur), ("v", tmp)], dt, half,
                    site=site)
            cur, cur_lanes = nxt, half
        self.names[ins.result] = cur

    def _emit_masked_segload(self, ins, site, out):
        rty = ins.result.type
        dt = rty.dtype
        n = len(rty.elems)
        sew = _sew(dt)
        emul = _emul_for(rty.lanes, dt, self.vlen)
        cnt = self.name_of(ins.args[1])
        fill = ins.attrs.get("fill", 0)
        self.ensure_vl(out, rty.lanes, sew, emul)
        fv = self.fresh("s")
        out.append(SConst(fv, _sctype(dt), fill))
        freg = self.fresh("v")
        mv = "vfmv.v.f" if _npdt(dt).kind == "f" else "vmv.v.x"
        self._v(out, mv, freg, [("x", fv)], dt, rty.lanes, site=site)
        self.ensure_vl(out, cnt, sew, emul)
        dst = self.bind(ins.result)
        self._v(out, "vlseg", dst,
                [("p", self.name_of(ins.args[0]))], dt, rty.lanes,
                site=site, seg=n, policy="tu",
                merge=tuple(freg for _ in range(n)), emul=emul)
        self.ensure_vl(out, rty.lanes, sew, emul)

    def _emit_tile(self, ins, site, out):
        rty = ins.result.type
        dt = rty.dtype
        src = ins.args[0]
        lanes = rty.lanes
        if src.type.lanes & (src.type.lanes - 1):
            raise CodegenError("vtile source lanes must be a power of 2")
        idt = f"uint{_sew(dt)}"
        self.ensure_vl(out, lanes, _sew(dt),
                       _emul_for(lanes, dt, self.vlen))
        vid, vand, vrg = self._mnems("vtile", _dclass(dt))
        idx, idx2 = self.fresh("v"), self.fresh("v")
        self._v(out, vid, idx, [], idt, lanes, site=site)
        mask = self.fresh("s")
        out.append(SConst(mask, f"{idt}_t", src.type.lanes - 1))
        self._v(out, vand, idx2, [("v", idx), ("x", mask)], idt, lanes,
                site=site)
        dst = self.bind(ins.result)
        self._v(out, vrg, dst,
                [("v", self.name_of(src)), ("v", idx2)], dt, lanes,
                site=site)

    def _emit_shift(self, ins, isa_op, site, out):
        rty = ins.result.type
        dt = rty.dtype
        # peephole: a single-use right shift feeding a saturating
        # narrow fuses into one rounding vnclip (RDN == C's arithmetic
        # shift); record and emit nothing here
        if isa_op == "vshr_n" and self.uses.get(ins.result, 0) == 1:
            user = _single_user(self.fn.body, ins.result)
            if user is not None and user.op == "intrin" and \
                    user.attrs["isa_op"] in ("vqmovn", "vqmovun"):
                self.fused_shift[ins.result] = (ins.args[0],
                                                ins.args[1])
                self.names[ins.result] = None     # must not be read
                return
        self.ensure_vl(out, rty.lanes, _sew(dt),
                       _emul_for(rty.lanes, dt, self.vlen))
        dst = self.bind(ins.result)
        mnem, = self._mnems(isa_op, _dclass(dt))
        self._v(out, mnem, dst,
                [("v", self.name_of(ins.args[0])),
                 ("x", self.name_of(ins.args[1]))], dt, rty.lanes,
                site=site)

    def _emit_reduce(self, ins, isa_op, site, out):
        src = ins.args[0]
        dt = src.type.dtype
        dc = _dclass(dt)
        lanes = src.type.lanes
        sew = _sew(dt)
        emul = _emul_for(lanes, dt, self.vlen)
        self.ensure_vl(out, lanes, sew, emul)
        v = self.name_of(src)
        dst = self.bind(ins.result)
        if isa_op == "vaddv":
            init_mv, red, readout = self._mnems(isa_op, dc)
            zero = self.fresh("s")
            out.append(SConst(zero, _sctype(dt), 0))
            scr = self.fresh("v")
            self._v(out, init_mv, scr, [("x", zero)], dt, lanes,
                    site=site, emul=1)
            rreg = self.fresh("v")
            self._v(out, red, rreg, [("v", v), ("v", scr)], dt, lanes,
                    site=site, emul=emul)
            self._v(out, readout, dst, [("v", rreg)], dt, lanes,
                    site=site, emul=1)
        elif isa_op in ("vmaxv", "vminv"):
            rd0, init_mv, red, readout = self._mnems(isa_op, dc)
            lane0 = self.fresh("s")
            self._v(out, rd0, lane0, [("v", v)], dt, lanes, site=site,
                    emul=1)
            scr = self.fresh("v")
            self._v(out, init_mv, scr, [("x", lane0)], dt, lanes,
                    site=site, emul=1)
            rreg = self.fresh("v")
            self._v(out, red, rreg, [("v", v), ("v", scr)], dt, lanes,
                    site=site, emul=emul)
            self._v(out, readout, dst, [("v", rreg)], dt, lanes,
                    site=site, emul=1)
        else:
            raise CodegenError(f"no emitter for reduction {isa_op!r}")

    def _emit_cvt(self, ins, isa_op, site, out):  # noqa: C901
        rty = ins.result.type
        src = ins.args[0]
        sdt, ddt = src.type.dtype, rty.dtype
        lanes = rty.lanes
        if isa_op == "vcvt":
            sk, dk = _npdt(sdt).kind, _npdt(ddt).kind
            key = {"fi": "f->i", "if": "i->f", "fu": "f->u",
                   "uf": "u->f"}.get(sk + dk)
            if key is None:
                raise CodegenError(f"vcvt {sdt}->{ddt} unsupported")
            mnem = RVV_MNEMONICS["vcvt"][key][0]
            self.ensure_vl(out, lanes, _sew(ddt),
                           _emul_for(lanes, ddt, self.vlen))
            dst = self.bind(ins.result)
            self._v(out, mnem, dst, [("v", self.name_of(src))], ddt,
                    lanes, site=site, dtype_src=sdt)
            return
        if isa_op == "vmovl":
            mnem, = self._mnems(isa_op, _dclass(sdt))
            self.ensure_vl(out, lanes, _sew(ddt),
                           _emul_for(lanes, ddt, self.vlen))
            dst = self.bind(ins.result)
            self._v(out, mnem, dst, [("v", self.name_of(src))], ddt,
                    lanes, site=site, dtype_src=sdt, sew=_sew(ddt))
            return
        if isa_op == "vmovn":
            mnem, = self._mnems(isa_op, _dclass(sdt))
            self.ensure_vl(out, lanes, _sew(ddt),
                           _emul_for(lanes, ddt, self.vlen))
            dst = self.bind(ins.result)
            self._v(out, mnem, dst,
                    [("v", self.name_of(src)), ("i", 0)], ddt, lanes,
                    site=site, dtype_src=sdt, sew=_sew(ddt))
            return
        if isa_op in ("vqmovn", "vqmovun"):
            fused = self.fused_shift.pop(src, None)
            wide, shamt = ((fused[0], fused[1]) if fused is not None
                           else (src, None))
            wdt = wide.type.dtype
            self.ensure_vl(out, lanes, _sew(ddt),
                           _emul_for(lanes, ddt, self.vlen))
            dst = self.bind(ins.result)
            key = f"vshr_n+{isa_op}" if fused is not None else isa_op
            wemul = _emul_for(lanes, wdt, self.vlen)
            if isa_op == "vqmovun":
                vmax, nclip = self._mnems(key, "int")
                zero = self.fresh("s")
                out.append(SConst(zero, _sctype(wdt), 0))
                t = self.fresh("v")
                self._v(out, vmax, t,
                        [("v", self.name_of(wide)), ("x", zero)], wdt,
                        lanes, site=site, emul=wemul)
                uwdt = f"uint{_sew(wdt)}"
                t2 = self.fresh("v")
                self._v(out, "vreinterpret", t2, [("v", t)], uwdt,
                        lanes, site=site, dtype_src=wdt, free=True,
                        emul=wemul)
                wname, wdt = t2, uwdt
            else:
                nclip, = self._mnems(key, _dclass(wdt))
                wname = self.name_of(wide)
            shift_src = (("x", self.name_of(shamt))
                         if fused is not None else ("i", 0))
            self._v(out, nclip, dst, [("v", wname), shift_src], ddt,
                    lanes, site=site, dtype_src=wdt, sew=_sew(ddt),
                    vxrm="rdn" if fused is not None else "rnu")
            return
        raise CodegenError(f"no emitter for cvt op {isa_op!r}")

    def _emit_widening(self, ins, isa_op, site, out):
        rty = ins.result.type
        ddt = rty.dtype
        lanes = rty.lanes
        narrow = ins.args[-1]          # last operand is always narrow
        ndt = narrow.type.dtype
        dc = _dclass(ndt)
        mnems = self._mnems(isa_op, dc)
        # widening ops run at the *narrow* SEW with a 2x-EMUL dest
        self.ensure_vl(out, lanes, _sew(ndt),
                       _emul_for(lanes, ndt, self.vlen))
        dst = self.bind(ins.result)
        args = [self.name_of(a) for a in ins.args]
        demul = _emul_for(lanes, ddt, self.vlen)
        if isa_op in ("vmull", "vaddl", "vsubl"):
            self._v(out, mnems[0], dst, [("v", args[0]), ("v", args[1])],
                    ddt, lanes, site=site, dtype_src=ndt,
                    sew=_sew(ndt), emul=demul)
        elif isa_op == "vmlal":
            self._v(out, mnems[0], dst,
                    [("v", args[0]), ("v", args[1]), ("v", args[2])],
                    ddt, lanes, site=site, dtype_src=ndt,
                    sew=_sew(ndt), emul=demul)
        elif isa_op == "vmlsl":
            wmul, vsub = mnems
            t = self.fresh("v")
            self._v(out, wmul, t, [("v", args[1]), ("v", args[2])],
                    ddt, lanes, site=site, dtype_src=ndt,
                    sew=_sew(ndt), emul=demul)
            self._v(out, vsub, dst, [("v", args[0]), ("v", t)], ddt,
                    lanes, site=site, emul=demul)
        else:
            raise CodegenError(f"no emitter for widening op {isa_op!r}")

    def _emit_get_lane(self, ins, site, out):
        src = ins.args[0]
        dt = src.type.dtype
        lanes = src.type.lanes
        self.ensure_vl(out, lanes, _sew(dt),
                       _emul_for(lanes, dt, self.vlen))
        slide, rd = self._mnems("vget_lane", _dclass(dt))
        t = self.fresh("v")
        self._v(out, slide, t,
                [("v", self.name_of(src)),
                 ("x", self.name_of(ins.args[1]))], dt, lanes,
                site=site)
        dst = self.bind(ins.result)
        self._v(out, rd, dst, [("v", t)], dt, lanes, site=site, emul=1)


def _is_vec(st) -> bool:
    return isinstance(st, (V, VSetVL))


def _first_vec(body) -> int:
    for i, st in enumerate(body):
        if _is_vec(st):
            return i
    return -1


def _single_user(block: Block, val: Value):
    """The one instruction consuming ``val`` (None when used by region
    plumbing — yields/phis — or more than once)."""
    found = []

    def walk(b: Block):
        for ins in b.instrs:
            if val in ins.args:
                found.append(ins)
            if isinstance(ins, Loop):
                walk(ins.cond)
                walk(ins.body)
            elif isinstance(ins, IfOp):
                walk(ins.then)
                walk(ins.els)

    walk(block)
    return found[0] if len(found) == 1 else None


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def emit(kernel, target=None, *, revec: bool = True,
         factor_cap=None, tail: str = "auto") -> RvvProgram:
    """Emit the RVV program for ``kernel`` (a PortedKernel or TFunction)
    on ``target``.  With ``revec=True`` (default) the IR is first
    re-tiled at the target's VLEN x LMUL, so the emitted ``vsetvli``
    carries the widened strip's real element count.  ``factor_cap`` and
    ``tail`` pass through to :func:`repro_torch.port.revec.retile` — the
    autotuner's knobs, so a tuned configuration can be fact-checked on
    the simulator before it is cached."""
    tgt = _targets.resolve_target(target)
    if not tgt.vla:
        raise CodegenError(f"RVV codegen needs an rvv target, "
                           f"not {tgt.name!r}")
    fn = kernel.fn if hasattr(kernel, "fn") else kernel
    retiling = None
    if revec:
        from ..port.revec import retile
        retiling = retile(fn, tgt, factor_cap=factor_cap, tail=tail)
        fn = retiling.fn
    em = _Emit(fn, tgt)
    body: List[Any] = []
    for p in fn.params:
        em.names[p] = p.hint
    em.block(fn.body, body)
    # loop-invariant material (group-broadcast gather indices) goes in
    # front of the walked body; it fills lazily during em.block
    return RvvProgram(fn_name=fn.name, target=tgt,
                      params=[(p.hint, p.type) for p in fn.params],
                      writes=list(fn.writes),
                      body=em.preamble + body,
                      retiling=retiling)


# ---------------------------------------------------------------------------
# C rendering
# ---------------------------------------------------------------------------

_CMP_OPS = {"==", "!=", "<", ">", "<=", ">="}


def _c_scalar_literal(value, ctype: str) -> str:
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, float) or ctype in ("float", "double"):
        v = float(value)
        if v != v:
            return "NAN"
        if v == float("inf"):
            return "INFINITY"
        if v == float("-inf"):
            return "-INFINITY"
        s = repr(v)
        return f"{s}f" if ctype == "float" else s
    return str(int(value))


_VCTYPE_RE = __import__("re").compile(
    r"^v(u?int|float)(\d+)m(\d+)_t$")


class _CWriter:
    def __init__(self, prog: RvvProgram):
        self.prog = prog
        self.lines: List[str] = []
        self.depth = 1
        self.declared = set()
        self.vtypes: Dict[str, Tuple[str, int]] = {}

    def w(self, s: str):
        self.lines.append("  " * self.depth + s)

    def decl(self, var: str, ctype: str) -> str:
        if var in self.declared:
            return var
        self.declared.add(var)
        m = _VCTYPE_RE.match(ctype)
        if m:
            kind = {"int": "int", "uint": "uint", "float": "float"}
            self.vtypes[var] = (f"{m.group(1)}{m.group(2)}",
                                int(m.group(3)))
        sep = "" if ctype.endswith("*") else " "
        return f"{ctype}{sep}{var}"

    def vv(self, name: str, st: "V", expected: Optional[int] = None) \
            -> str:
        """Spell a vector operand, bridging register-group width with a
        free vlmul_ext/trunc when the declared EMUL differs from what
        the instruction's intrinsic signature wants."""
        info = self.vtypes.get(name)
        if info is None:
            return name
        d_dt, d_em = info
        if expected is None:
            expected = max(1, st.emul * _sew(d_dt) // _sew(st.dtype))
        if d_em == expected or expected > 8:
            return name
        s = _vt_suffix(d_dt, d_em)
        t = _vt_suffix(d_dt, expected)
        op = "ext" if expected > d_em else "trunc"
        return f"__riscv_vlmul_{op}_v_{s}_{t}({name})"

    # -- vector intrinsic spelling ----------------------------------------
    def vop(self, st: V) -> str:  # noqa: C901
        sfx = _vt_suffix(st.dtype, st.emul)
        vl = st.vl
        args = []
        for idx, (k, val) in enumerate(st.srcs):
            if k == "v":
                # vred*.vs scalar operands are always an m1 group
                exp = 1 if (st.mnem.startswith(("vred", "vfred"))
                            and idx == 1) else None
                args.append(self.vv(val, st, exp))
            else:
                args.append(str(val))
        m = st.mnem
        if m == "vle":
            eew = _sew(st.dtype)
            tu = "_tu" if st.policy == "tu" else ""
            merge = (f"{self.vv(st.merge, st)}, "
                     if st.policy == "tu" else "")
            return (f"__riscv_vle{eew}_v_{sfx}{tu}({merge}{args[0]}, "
                    f"{vl})")
        if m == "vse":
            eew = _sew(st.dtype)
            return f"__riscv_vse{eew}_v_{sfx}({args[0]}, {args[1]}, {vl})"
        if m == "vlseg":
            eew = _sew(st.dtype)
            tu = "_tu" if st.policy == "tu" else ""
            merge = ""
            if st.policy == "tu":
                merge = f"{self.tuple_expr(st.merge, sfx, st.seg)}, "
            return (f"__riscv_vlseg{st.seg}e{eew}_v_{sfx}x{st.seg}"
                    f"{tu}({merge}{args[0]}, {vl})")
        if m == "vsseg":
            eew = _sew(st.dtype)
            tup = self.tuple_expr(st.srcs[1][1], sfx, st.seg)
            return (f"__riscv_vsseg{st.seg}e{eew}_v_{sfx}x{st.seg}"
                    f"({args[0]}, {tup}, {vl})")
        if m == "vreinterpret":
            ssfx = _vt_suffix(st.dtype_src, st.emul)
            return f"__riscv_vreinterpret_v_{ssfx}_{sfx}({args[0]})"
        base = m.replace(".", "_")
        if m in ("vmv.x.s", "vfmv.f.s"):
            ct = _CTYPE.get(st.dtype, f"{st.dtype}_t")
            tag = {"f": "f", "i": "i", "u": "u"}[_npdt(st.dtype).kind]
            return (f"__riscv_{base}_{sfx}_{tag}{_sew(st.dtype)}"
                    f"({args[0]})")
        if m in ("vmv.s.x", "vfmv.s.f"):
            return f"__riscv_{base}_{sfx}({args[0]}, {vl})"
        if m.startswith("vmfeq") or m.startswith("vmflt") or \
                m.startswith("vmfle") or m.startswith("vmseq") or \
                m.startswith("vmslt") or m.startswith("vmsle") or \
                m.startswith("vmsne"):
            mb = st.sew // st.emul
            ssfx = _vt_suffix(st.dtype, st.emul)
            return (f"__riscv_{base}_{ssfx}_b{mb}"
                    f"({', '.join(args)}, {vl})")
        if m.endswith(".vxm") or m.endswith(".vvm"):
            return f"__riscv_{base}_{sfx}({', '.join(args)}, {vl})"
        if m.startswith("vred") or m.startswith("vfred"):
            src_sfx = _vt_suffix(st.dtype,
                                 _emul_for_sfx(st, self.prog.target))
            return (f"__riscv_{base}_{src_sfx}_{_vt_suffix(st.dtype, 1)}"
                    f"({', '.join(args)}, {vl})")
        if m.startswith("vsext") or m.startswith("vzext"):
            return f"__riscv_{base}_{sfx}({args[0]}, {vl})"
        if m.startswith(("vnclip", "vnsrl", "vnsra")):
            rm = {"rnu": "__RISCV_VXRM_RNU", "rne": "__RISCV_VXRM_RNE",
                  "rdn": "__RISCV_VXRM_RDN", "rod": "__RISCV_VXRM_ROD"}
            extra = f", {rm[st.vxrm]}" if st.vxrm and \
                m.startswith("vnclip") else ""
            return (f"__riscv_{base}_{sfx}({', '.join(args)}{extra}, "
                    f"{vl})")
        if m.startswith("vfcvt"):
            return f"__riscv_{base}_{sfx}({args[0]}, {vl})"
        if m == "vid.v":
            return f"__riscv_vid_v_{sfx}({vl})"
        # generic .vv/.vx/.vi/.v forms
        return f"__riscv_{base}_{sfx}({', '.join(args)}, {vl})"

    def tuple_expr(self, names, sfx: str, seg: int) -> str:
        expr = f"__riscv_vundefined_{sfx}x{seg}()"
        for i, nm in enumerate(names):
            expr = (f"__riscv_vset_v_{sfx}_{sfx}x{seg}({expr}, {i}, "
                    f"{nm})")
        return expr

    # -- statements --------------------------------------------------------
    def stmt(self, st):  # noqa: C901
        if isinstance(st, SConst):
            self.w(f"{self.decl(st.dst, st.ctype)} = "
                   f"{_c_scalar_literal(st.value, st.ctype)};")
        elif isinstance(st, SBin):
            op = "%" if st.op == "%" else st.op
            self.w(f"{self.decl(st.dst, st.ctype)} = "
                   f"{st.a} {op} {st.b};")
        elif isinstance(st, SUn):
            expr = {"neg": f"-{st.a}", "not": f"!{st.a}",
                    "inv": f"~{st.a}",
                    "cast": f"({st.ctype}){st.a}"}[st.op]
            self.w(f"{self.decl(st.dst, st.ctype)} = {expr};")
        elif isinstance(st, SSel):
            self.w(f"{self.decl(st.dst, st.ctype)} = "
                   f"{st.c} ? {st.a} : {st.b};")
        elif isinstance(st, SLoad):
            self.w(f"{self.decl(st.dst, st.ctype)} = *{st.ptr};")
        elif isinstance(st, SStore):
            self.w(f"*{st.ptr} = {st.val};")
        elif isinstance(st, SPtrAdd):
            self.w(f"{self.decl(st.dst, st.ctype)} = "
                   f"{st.base} + {st.delta};")
        elif isinstance(st, SCopy):
            if st.declare and st.dst not in self.declared:
                self.w(f"{self.decl(st.dst, st.ctype)} = {st.src};")
            else:
                self.w(f"{st.dst} = {st.src};")
        elif isinstance(st, PreDecl):
            self.w(f"{self.decl(st.var, st.ctype)};")
        elif isinstance(st, While):
            self.w("for (;;) {")
            self.depth += 1
            for s in st.cond_stmts:
                self.stmt(s)
            self.w(f"if (!{st.cond}) break;")
            for s in st.body:
                self.stmt(s)
            self.depth -= 1
            self.w("}")
        elif isinstance(st, If):
            self.w(f"if ({st.cond}) {{")
            self.depth += 1
            for s in st.then:
                self.stmt(s)
            self.depth -= 1
            if st.els:
                self.w("} else {")
                self.depth += 1
                for s in st.els:
                    self.stmt(s)
                self.depth -= 1
            self.w("}")
        elif isinstance(st, VSetVL):
            self.w(f"{self.decl(st.dst, 'size_t')} = "
                   f"__riscv_vsetvl_e{st.sew}m{st.lmul}({st.avl});")
        elif isinstance(st, V):
            expr = self.vop(st)
            if st.dst is None:
                self.w(f"{expr};")
            elif isinstance(st.dst, tuple):
                sfx = _vt_suffix(st.dtype, st.emul)
                t = f"_t{len(self.declared)}"
                self.w(f"{_vctype(st.dtype, st.emul)}x{st.seg}_t "
                       f"{t} = {expr};")
                for i, nm in enumerate(st.dst):
                    self.w(f"{self.decl(nm, _vctype(st.dtype, st.emul))}"
                           f" = __riscv_vget_v_{sfx}x{st.seg}_{sfx}"
                           f"({t}, {i});")
            elif st.mnem in ("vmv.x.s", "vfmv.f.s"):
                ct = _CTYPE.get(st.dtype, f"{st.dtype}_t")
                self.w(f"{self.decl(st.dst, ct)} = {expr};")
            elif st.mnem.startswith("vm") and isinstance(st.dst, str) \
                    and st.dst.startswith("m"):
                mb = st.sew // st.emul
                self.w(f"{self.decl(st.dst, f'vbool{mb}_t')} = {expr};")
            else:
                self.w(f"{self.decl(st.dst, _vctype(st.dtype, st.emul))}"
                       f" = {expr};")
        else:
            raise CodegenError(f"unrenderable statement {st!r}")


def _emul_for_sfx(st: V, target) -> int:
    # reductions keep the source operand's register group
    return st.emul


def render_c(prog: RvvProgram) -> str:
    """Render one compilable RVV-intrinsic translation unit."""
    w = _CWriter(prog)
    params = []
    for name, t in prog.params:
        if isinstance(t, PtrType):
            params.append(f"{_ctype(t)}{name}")
        else:
            params.append(f"{_ctype(t)} {name}")
        w.declared.add(name)
    for st in prog.body:
        w.stmt(st)
    header = [
        f"/* {prog.fn_name} on {prog.target.name} "
        f"(VLEN={prog.target.vlen}, LMUL={prog.target.lmul})",
        " * Emitted by repro.rvv.codegen from the re-tiled port IR —",
        " * do not edit; regenerate via repro.rvv.emit().",
        " */",
        "#include <math.h>",
        "#include <riscv_vector.h>",
        "#include <stdbool.h>",
        "#include <stddef.h>",
        "#include <stdint.h>",
        "",
        f"void {prog.c_name}({', '.join(params)}) {{",
    ]
    return "\n".join(header + w.lines + ["}", ""])
