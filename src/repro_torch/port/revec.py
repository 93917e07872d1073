"""Strip-loop re-vectorization: re-tile NEON-granularity loops at the
target's VLEN x LMUL.

A kernel ported from NEON walks memory in fixed 128-bit strips — on a
1024-bit RVV machine it uses an eighth of every register, which is
exactly SIMDe's fixed-vlen limitation (and why BENCH_port.json's
rvv-128..1024 columns used to be identical).  This pass rewrites the
typed SSA IR so the strip consumes one whole register *group* per
iteration:

1. **match** — find top-level strip loops: a counted-down scalar phi
   (``for (; n >= K; n -= K)``) plus affine pointer walks with constant
   element strides and a straight-line vector body;
2. **legality** — every intrinsic in the body must be lane-scalable
   (lane-wise arithmetic, unit-stride memory, broadcasts, lane-local
   shuffles like vrbit/vrev64/vreinterpret); cross-lane structure
   (vget_high/low, vcombine, vext, vpadd, vzip) and in-body reductions
   veto the loop.  Loop-carried vector accumulators are re-tilable when
   their post-loop consumer is a horizontal reduction (vaddv needs a
   provably-zero init — summing a tiled init would multiply it; vmaxv /
   vminv are tile-idempotent);
3. **re-tile** — widen every register type by the target's
   :meth:`~repro_torch.core.targets.Target.retile_factor`, scale the counter
   step / compare bound / pointer-walk constants, and ``vtile``
   loop-invariant registers (vdup'd constants, per-channel vld1'd
   scale/bias vectors) so their lane pattern repeats across the widened
   group;
4. **predicated tail** — where legal, the remainder is subsumed by one
   masked strip iteration (``vsetvli`` semantics: ``vld1m``/``vst1m``
   carrying the active count; additive accumulators are zero-fill-safe,
   max/min accumulators get identity fills) and the scalar cleanup loop
   then runs zero iterations.  Where the masked form is not provably
   safe, a narrow epilogue loop at the original granularity is kept.

The matcher *assumes* the XNNPACK contract that a scalar tail loop
computes the per-element residual of the strip body (the corpus
differential tests check it empirically); everything else is proved
structurally.  The result is a plain :class:`~repro_torch.port.ir.TFunction`:
it interprets (concretely *and* abstractly — re-tiled dynamic
instruction estimates come for free) and compiles
(:mod:`repro_torch.port.compile`) like any ported kernel.
"""
from __future__ import annotations

import dataclasses
import itertools
from fractions import Fraction
from typing import Dict, List, Optional

import numpy as np

from ..core import targets as _targets
from ..core.vtypes import numpy_dtype
from .ir import (Block, IfOp, Instr, Loop, PtrType, ScalarType, TFunction,
                 Value, VecTupleType, VecType)

__all__ = ["retile", "RetileResult", "strip_loops", "StripInfo"]


# intrinsic isa ops whose semantics are unchanged by widening the
# register (lane-wise, or local to a fixed sub-group of lanes).  The
# width-changing families (vmull/vaddl/vsubl, vmovl, vmovn/vqmovn/
# vqmovun) and the struct accesses (vld2/vst2, tuple plumbing) are
# lane-GROUP-wise: element i of every result depends only on element
# group i of the inputs, so widening the whole group re-tiles them —
# the wide side of a vmull simply tracks the narrow side at 2x element
# width, and a vld2 de-interleaves a 2x-longer contiguous run.  See
# DESIGN.md §10 for the element-group legality argument.
_SCALABLE = {
    "vadd", "vsub", "vmul", "vmax", "vmin", "vand", "vorr", "veor",
    "vqadd", "vqsub", "vmla", "vmls", "vfma", "vabs", "vneg",
    "vrecpe", "vrecps", "vrsqrte", "vrsqrts",
    "vceq", "vcgt", "vcge", "vclt", "vcle", "vbsl",
    "vdup", "vld1", "vst1", "vcvt", "vshl_n", "vshr_n",
    "vrbit", "vrev64", "vreinterpret",
    "vmull", "vaddl", "vsubl", "vmlal", "vmlsl", "vmovl", "vmovn",
    "vqmovn", "vqmovun",
    "vld2", "vst2", "vld3", "vst3", "vld4", "vst4",
    "tuple_get", "tuple_set", "tuple_undef",
}
# post-loop reduction consumers a widened accumulator may flow into
_REDUCERS = {"vaddv", "vmaxv", "vminv"}


# ---------------------------------------------------------------------------
# Static affine analysis of loop phis
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Affine:
    """``root + off`` where root is a phi/outer Value (None = constant)."""
    root: Optional[Value]
    off: int


_OPAQUE = object()


def _sym_eval(block: Block, syms: Dict[Value, object]) -> None:
    """Symbolic scalar/pointer dataflow over ``block``: ``syms`` maps
    Value -> Affine | _OPAQUE; unseen argument values root themselves."""

    def get(v: Value):
        s = syms.get(v)
        return s if s is not None else Affine(v, 0)

    for ins in block.instrs:
        if isinstance(ins, (Loop, IfOp)):
            for r in ins.results:
                syms[r] = _OPAQUE
            continue
        if ins.result is None:
            continue
        if ins.op == "const":
            v = ins.attrs["value"]
            syms[ins.result] = (Affine(None, int(v))
                                if isinstance(v, int) else _OPAQUE)
        elif ins.op == "sbin" and ins.attrs["op"] in ("+", "-"):
            syms[ins.result] = _combine(get(ins.args[0]), get(ins.args[1]),
                                        ins.attrs["op"])
        elif ins.op == "ptradd":
            a, b = get(ins.args[0]), get(ins.args[1])
            if a is not _OPAQUE and b is not _OPAQUE and b.root is None:
                syms[ins.result] = Affine(a.root, a.off + b.off)
            else:
                syms[ins.result] = _OPAQUE
        else:
            syms[ins.result] = _OPAQUE


def _combine(a, b, op: str):
    if a is _OPAQUE or b is _OPAQUE:
        return _OPAQUE
    if op == "+":
        if a.root is not None and b.root is not None:
            return _OPAQUE
        return Affine(a.root if a.root is not None else b.root,
                      a.off + b.off)
    if b.root is None:                         # '-' only by a constant
        return Affine(a.root, a.off - b.off)
    return _OPAQUE


def loop_affine(loop: Loop) -> Dict[Value, Optional[int]]:
    """Per-phi constant step (``yield == phi + step``), or None."""
    syms: Dict[Value, object] = {p: Affine(p, 0) for p in loop.phis}
    _sym_eval(loop.body, syms)
    steps: Dict[Value, Optional[int]] = {}
    for p, y in zip(loop.phis, loop.yields):
        s = syms.get(y, Affine(y, 0))
        steps[p] = s.off if isinstance(s, Affine) and s.root is p else None
    return steps


def loop_condition(loop: Loop):
    """``(phi, phi_offset, cmp_op, bound: Affine)`` for a condition of
    the form ``phi + c <op> bound`` where bound contains no phi; None
    when the loop doesn't match."""
    syms: Dict[Value, object] = {p: Affine(p, 0) for p in loop.phis}
    _sym_eval(loop.cond, syms)
    cmp_ins = None
    for ins in loop.cond.instrs:
        if ins.result is loop.cond_value and ins.op == "scmp":
            cmp_ins = ins
    if cmp_ins is None:
        return None
    get = lambda v: syms.get(v, Affine(v, 0))  # noqa: E731
    lhs, rhs = get(cmp_ins.args[0]), get(cmp_ins.args[1])
    if lhs is _OPAQUE or rhs is _OPAQUE:
        return None
    op = cmp_ins.attrs["op"]
    phis = set(loop.phis)
    lhs_phi, rhs_phi = lhs.root in phis, rhs.root in phis
    if lhs_phi == rhs_phi:
        return None
    if rhs_phi:                                # normalize phi to the left
        lhs, rhs = rhs, lhs
        op = {"<": ">", ">": "<", "<=": ">=", ">=": "<=",
              "==": "==", "!=": "!="}[op]
    return lhs.root, lhs.off, op, rhs


# ---------------------------------------------------------------------------
# Strip-loop matching
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StripInfo:
    loop: Loop
    counter: Value                 # the down-counted scalar phi
    step: int                      # elements consumed per iteration (> 0)
    ptr_steps: Dict[Value, int]    # pointer phi -> element stride / iter
    vec_phis: List[Value]          # loop-carried vector accumulators
    scalable: bool                 # body is lane-scalable
    reasons: List[str]
    # structured veto records mirroring ``reasons`` (site, reason code,
    # detail, source line) — surfaced on RetileResult.vetoes
    veto_records: List[dict] = dataclasses.field(default_factory=list)
    # the block containing the loop (fn.body for top-level strips, an
    # outer loop's body for hoisted inner strips) — the scalar-tail
    # search and result rewiring are relative to this block
    block: Optional[Block] = None
    # matched via the nested-loop shape ``for (; n != 0; n -= k)``
    # (the XNNPACK microkernel inner-loop idiom) rather than the
    # guarded ``for (; n >= K; n -= K)`` strip shape
    cond_ne: bool = False


def strip_loops(fn: TFunction) -> List[StripInfo]:
    """Match every loop of ``fn`` against the strip pattern — top-level
    loops first, then inner loops hoisted out of outer bodies (the
    nested-microkernel shape; see DESIGN.md §14).  An inner strip's
    outer-loop phis are loop-invariant over the inner walk by SSA
    construction, which is what makes the hoist sound."""
    levels: List[List[StripInfo]] = []

    def walk(block: Block, depth: int):
        while len(levels) <= depth:
            levels.append([])
        for ins in block.instrs:
            if isinstance(ins, Loop):
                info = _match_strip(ins, block)
                if info is not None:
                    for r in info.veto_records:
                        r.setdefault("file", fn.filename)
                    levels[depth].append(info)
                walk(ins.body, depth + 1)
            elif isinstance(ins, IfOp):
                walk(ins.then, depth + 1)
                walk(ins.els, depth + 1)

    walk(fn.body, 0)
    return [s for level in levels for s in level]


def _veto_record(reason: str, detail: str, site="", line=0) -> dict:
    return {"site": site, "reason": reason, "detail": detail,
            "line": int(line)}


def _match_strip(loop: Loop, block: Block) -> Optional[StripInfo]:
    cond = loop_condition(loop)
    if cond is None:
        return None
    phi, phi_off, op, bound = cond
    if not isinstance(phi.type, ScalarType):
        return None
    steps = loop_affine(loop)
    step = steps.get(phi)
    if step is None or step >= 0:
        return None                            # not counted down
    # the canonical XNNPACK strip shape (for (; n >= K; n -= K)) or the
    # nested-microkernel count-to-zero shape (for (; n != 0; n -= k))
    k = -step
    if bound.root is not None or phi_off != 0:
        return None
    if op == ">=" and bound.off == k and k > 1:
        cond_ne = False
    elif op == "!=" and bound.off == 0 and k >= 1:
        cond_ne = True
    else:
        return None
    # a strip body drives at least one vector intrinsic — scalar
    # cleanup tails (for (; n != 0; n -= 1) over sload/sstore) are not
    # strip candidates, they are the residual the strip contract keeps
    if not _has_vector_body(loop.body):
        return None

    reasons: List[str] = []
    records: List[dict] = []
    ptr_steps: Dict[Value, int] = {}
    vec_phis: List[Value] = []
    for p in loop.phis:
        if p is phi:
            continue
        if isinstance(p.type, PtrType):
            d = steps.get(p)
            if d is None:
                reasons.append(f"pointer {p.hint!r} walk is not affine")
                records.append(_veto_record(
                    "non-affine-pointer",
                    f"pointer {p.hint!r} walk is not affine",
                    site=p.hint))
            else:
                ptr_steps[p] = d
        elif isinstance(p.type, VecType):
            vec_phis.append(p)
        elif steps.get(p) != 0:
            reasons.append(f"scalar carried value {p.hint!r} is not "
                           f"loop-invariant")
            records.append(_veto_record(
                "scalar-carried",
                f"scalar carried value {p.hint!r} is not loop-invariant",
                site=p.hint))

    scalable = _body_scalable(loop.body, reasons, records)
    return StripInfo(loop=loop, counter=phi, step=k, ptr_steps=ptr_steps,
                     vec_phis=vec_phis, scalable=scalable and not reasons,
                     reasons=reasons, veto_records=records, block=block,
                     cond_ne=cond_ne)


def _has_vector_body(body: Block) -> bool:
    for ins in body.instrs:
        if ins.op == "intrin":
            return True
        if isinstance(ins, Loop):
            if _has_vector_body(ins.body):
                return True
        elif isinstance(ins, IfOp):
            if _has_vector_body(ins.then) or _has_vector_body(ins.els):
                return True
    return False


def _body_scalable(body: Block, reasons: List[str],
                   records: List[dict]) -> bool:
    ok = True
    for ins in body.instrs:
        if isinstance(ins, (Loop, IfOp)):
            reasons.append("nested control flow inside the strip body")
            records.append(_veto_record(
                "nested-control-flow",
                "nested control flow inside the strip body"))
            ok = False
            continue
        if ins.op != "intrin":
            continue
        isa_op, kind = ins.attrs["isa_op"], ins.attrs["kind"]
        if kind in ("reduce", "get_lane"):
            msg = (f"{ins.attrs['intrinsic']}: in-body reduction"
                   f"/lane extract is width-dependent")
            reasons.append(msg)
            records.append(_veto_record(
                "in-body-reduction", msg, site=ins.attrs["intrinsic"],
                line=ins.attrs.get("_line", 0)))
            ok = False
        elif isa_op not in _SCALABLE:
            msg = (f"{ins.attrs['intrinsic']}: cross-lane "
                   f"structure does not widen")
            reasons.append(msg)
            records.append(_veto_record(
                "cross-lane", msg, site=ins.attrs["intrinsic"],
                line=ins.attrs.get("_line", 0)))
            ok = False
    return ok


# ---------------------------------------------------------------------------
# The re-tiling transform
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RetileResult:
    fn: TFunction
    target: str
    factor: int                    # widening applied (1 = unchanged)
    strips: int                    # strip loops found
    retiled: int                   # strip loops actually widened
    masked: int                    # widened strips with a predicated tail
    notes: List[str]
    # structured narrow-fallback records: {site, reason, detail, line,
    # file} — every strip that stayed narrow says *which* SSA site and
    # source location vetoed it (machine-checkable; notes stay the
    # human-readable rendering)
    vetoes: List[dict] = dataclasses.field(default_factory=list)
    # the tuning knobs this result was produced under (autotune search
    # space; defaults reproduce the historical untuned behavior)
    factor_cap: Optional[int] = None
    tail: str = "auto"

    @property
    def changed(self) -> bool:
        return self.retiled > 0

    @property
    def narrow_fallbacks(self) -> int:
        """Strip loops that stayed at NEON granularity."""
        return self.strips - self.retiled


TAIL_POLICIES = ("auto", "masked", "epilogue")


def retile(fn: TFunction, target, strict: bool = False, *,
           factor_cap: Optional[int] = None,
           tail: str = "auto") -> RetileResult:
    """Re-tile ``fn``'s strip loops at ``target``'s effective register
    width.  Always returns a function (the original body re-emitted
    unchanged when nothing is re-tilable) plus the decisions taken.

    ``strict=True`` turns a structural fallback into a
    :class:`~repro_torch.port.resilience.RevecVeto`: strips were found but
    none could be widened.  The default keeps the historical contract
    (narrow execution is a valid, conformant outcome — the degradation
    ladder records it instead of failing).

    ``factor_cap`` and ``tail`` are the autotuner's knobs (defaults
    reproduce the untuned behavior exactly):

    * ``factor_cap`` bounds the widening factor below the register
      group's natural headroom (a cap of 1 keeps every strip narrow) —
      a shorter re-tile trades peak width for less remainder work at
      small ``n``.
    * ``tail`` picks the remainder strategy: ``"auto"`` prefers a
      provable masked predicated tail and falls back, ``"masked"``
      requires one (strips without a provable plan stay narrow), and
      ``"epilogue"`` skips the mask and mops up with a narrow epilogue
      loop where legal.  All three are conformant; they differ only in
      how many instructions the remainder retires.
    """
    from . import faultinject as _fi
    from .resilience import RevecVeto
    _fi.fault_point("revec.retile", kernel=fn.name,
                    target=getattr(target, "name", None) or str(target))
    if tail not in TAIL_POLICIES:
        raise ValueError(f"tail must be one of {TAIL_POLICIES}, "
                         f"got {tail!r}")
    if factor_cap is not None and factor_cap < 1:
        raise ValueError(f"factor_cap must be >= 1, got {factor_cap}")
    tgt = _targets.get_target(target)
    res = _Retiler(fn, tgt, factor_cap=factor_cap, tail=tail).run()
    if strict and res.strips > 0 and res.retiled == 0:
        raise RevecVeto(
            f"no strip loop could be re-tiled at {tgt.name} "
            f"({'; '.join(res.notes) or 'no notes'})",
            kernel=fn.name, target=tgt.name)
    return res


class _Retiler:
    def __init__(self, fn: TFunction, tgt: _targets.Target, *,
                 factor_cap: Optional[int] = None, tail: str = "auto"):
        self.fn = fn
        self.tgt = tgt
        self.factor_cap = factor_cap
        self.tail = tail
        self.notes: List[str] = []
        self.vetoes: List[dict] = []
        self.vmap: Dict[int, Value] = {}       # id(old Value) -> new
        self.defs = _def_map(fn)
        self.strips = {id(s.loop): s for s in strip_loops(fn)}
        self.retiled = 0
        self.masked = 0
        self.factor_used = 1
        self._ids = itertools.count(_max_id(fn) + 1)
        # per-strip legality scratch (reset in retile_strip)
        self._group_loads: set = set()   # id(load_dup instr) -> vld1g
        self._fold_phis: set = set()     # id(vec phi) folded post-tail

    def val(self, ty, hint="") -> Value:
        return Value(id=next(self._ids), type=ty, hint=hint)

    def look(self, v: Value) -> Value:
        seen = 0
        while id(v) in self.vmap and seen < 64:
            v = self.vmap[id(v)]
            seen += 1
        return v

    def veto(self, reason: str, detail: str, site: str = "",
             line: int = 0) -> bool:
        """Record a narrow fallback: human note + structured record,
        both carrying source provenance (file:line) PortError-style."""
        loc = ""
        if self.fn.filename:
            loc = f"{self.fn.filename}:{line}: " if line \
                else f"{self.fn.filename}: "
        self.notes.append(loc + detail)
        self.vetoes.append({"site": site, "reason": reason,
                            "detail": detail, "line": int(line),
                            "file": self.fn.filename})
        return False

    @staticmethod
    def _site_tag(ins: Instr) -> str:
        """'vld1q_f32@%7' — the offending SSA site for veto messages."""
        name = ins.attrs.get("intrinsic", ins.op)
        v = ins.result if ins.result is not None else \
            (ins.args[0] if ins.args else None)
        return f"{name}@%{v.id}" if v is not None else name

    # -- entry ------------------------------------------------------------
    def run(self) -> RetileResult:
        body = Block()
        self.emit_block_into(self.fn.body, body, top=True)
        fn = TFunction(name=self.fn.name, params=self.fn.params, body=body,
                       writes=list(self.fn.writes), source=self.fn.source,
                       filename=self.fn.filename)
        return RetileResult(fn=fn, target=self.tgt.name,
                            factor=self.factor_used,
                            strips=len(self.strips), retiled=self.retiled,
                            masked=self.masked, notes=self.notes,
                            vetoes=self.vetoes,
                            factor_cap=self.factor_cap, tail=self.tail)

    # -- generic region copy ----------------------------------------------
    def emit_block_into(self, src: Block, dst: Block, top=False):
        # strips are looked up at every region depth: inner strip loops
        # (nested-microkernel shape) re-tile in place while their outer
        # loop is cloned around them
        for ins in src.instrs:
            strip = self.strips.get(id(ins))
            if strip is not None:
                if strip.scalable and self.retile_strip(strip, dst):
                    continue
                if not strip.scalable:
                    self.notes.append(
                        f"loop kept at {strip.step}-element strips: "
                        + "; ".join(strip.reasons))
                    self.vetoes.extend(strip.veto_records)
            dst.instrs.append(self.clone(ins))

    def clone(self, ins: Instr) -> Instr:
        if isinstance(ins, Loop):
            cond, body = Block(), Block()
            self.emit_block_into(ins.cond, cond)
            self.emit_block_into(ins.body, body)
            return Loop(op="loop",
                        args=tuple(self.look(a) for a in ins.args),
                        phis=[self.look(p) for p in ins.phis],
                        init=[self.look(i) for i in ins.init],
                        cond=cond, cond_value=self.look(ins.cond_value),
                        body=body,
                        yields=[self.look(y) for y in ins.yields],
                        results=[self.look(r) for r in ins.results])
        if isinstance(ins, IfOp):
            then, els = Block(), Block()
            self.emit_block_into(ins.then, then)
            self.emit_block_into(ins.els, els)
            return IfOp(op="if", args=tuple(self.look(a) for a in ins.args),
                        cond_value=self.look(ins.cond_value),
                        then=then,
                        then_yields=[self.look(y) for y in ins.then_yields],
                        els=els,
                        els_yields=[self.look(y) for y in ins.els_yields],
                        results=[self.look(r) for r in ins.results])
        return Instr(ins.op, tuple(self.look(a) for a in ins.args),
                     ins.result, dict(ins.attrs))

    # -- strip re-tiling ---------------------------------------------------
    def retile_strip(self, strip: StripInfo, dst: Block) -> bool:
        loop = strip.loop
        # lane-group-aware widening factor: fill the register group with
        # the *narrowest* register in the body (the one with the most
        # width headroom).  In a uniform-width body this is the old
        # tightest-register rule; in a width-changing body (vmull,
        # vqmovn) the narrow side re-tiles to VLEN x LMUL and the wide
        # side tracks the same element groups at 2x element width,
        # spilling into a double register group exactly like RVV's
        # widening ops write 2xLMUL destinations (the cost models charge
        # the extra register micro-ops, so the estimate stays honest).
        factor = None
        for ty in _body_vec_types(loop):
            f = self.tgt.retile_factor(ty.lanes, ty.dtype)
            factor = f if factor is None else max(factor, f)
        if factor and self.factor_cap is not None:
            # tuning knob: the autotuner may bound widening below the
            # register group's natural headroom (cap 1 == stay narrow)
            factor = min(factor, self.factor_cap)
        if not factor or factor <= 1:
            self.notes.append(
                f"strip at {strip.step} elems/iter: no width headroom "
                f"on {self.tgt.name}"
                + (f" (factor_cap={self.factor_cap})"
                   if self.factor_cap is not None else ""))
            return False
        self._group_loads = set()
        self._fold_phis = set()
        if any(isinstance(v.type, VecTupleType)
               for v in _outer_vec_uses(loop)):
            return self.veto(
                "tuple-invariant",
                "loop-invariant register struct used in the body cannot "
                "be tiled; kept narrow")
        # accumulators first: fold-phi classification feeds the
        # offset-class dataflow in check_memory_sites
        if not self.check_accumulators(strip):
            return False
        if not self.check_memory_sites(strip):
            return False

        plan = (self.plan_masked_tail(strip)
                if self.tail in ("auto", "masked") else None)
        if self.tail == "epilogue" and self._fold_phis:
            # a foldable accumulator's group fold only folds correctly
            # under a masked tail; without one the strip must not widen
            return self.veto(
                "tail-policy-epilogue",
                "epilogue tail policy forbids the masked tail a "
                "fold-accumulator strip requires; kept narrow")
        if self.tail == "masked" and plan is None:
            return self.veto(
                "tail-policy-masked",
                "masked tail policy requested but no provable masked "
                "tail plan exists; kept narrow")
        tail_exists = _tail_consumes(strip)
        if plan is None and self._fold_phis:
            return self.veto(
                "fold-needs-masked-tail",
                "accumulator group fold requires a provable masked "
                "tail; kept narrow")
        if plan is None and strip.vec_phis and not tail_exists:
            return self.veto(
                "no-tail-coverage",
                "accumulator strip without masked tail or scalar tail "
                "cannot cover the remainder; kept narrow")

        self.factor_used = max(self.factor_used, factor)
        self.retiled += 1
        saved = dict(self.vmap)
        tile_map: Dict[int, Value] = {}
        new_loop, result_map = self.widen_loop(strip, factor, dst,
                                               tile_map)
        if plan is not None:
            # masked predicated tail subsumes remainder (+ scalar tail)
            self.vmap = dict(saved)
            self.vmap.update(tile_map)
            result_map = self.emit_masked_tail(
                strip, new_loop, factor, plan, tail_exists, dst,
                result_map)
            self.masked += 1
        elif not strip.vec_phis:
            # narrow epilogue loop mops up sub-group strips
            self.vmap = dict(saved)
            result_map = self.emit_epilogue(strip, new_loop, dst)
        else:
            self.notes.append("sub-group remainder left to the scalar "
                              "tail (unmaskable accumulator)")
        self.vmap = dict(saved)
        self.vmap.update(result_map)
        return True

    # -- memory-site legality ----------------------------------------------
    def check_memory_sites(self, strip: StripInfo) -> bool:
        """Widening a strip batches ``factor`` consecutive iterations
        into one.  Per pointer root, the body's memory sites are
        (offset, count) pairs: the distinct pairs must tile the
        per-iteration walk ``[0, root_step)`` contiguously (a single
        site at offset 0 covering the whole walk is the unit-stride
        case; a 2x-unrolled body contributes two half-walk sites).
        Partial sites additionally carry an *offset class* —
        ``[off/root_step, (off+count)/root_step)`` — and a dataflow
        pass proves values never cross classes between their load and
        store sites (crossing would re-pair elements when the batch is
        widened).  Walking broadcast loads (``vld1_dup``; one fresh
        scalar per iteration) re-tile as group-broadcast ``vld1g``
        sites when the pointer walks exactly one element.  See
        DESIGN.md §14."""
        syms: Dict[Value, object] = {p: Affine(p, 0)
                                     for p in strip.loop.phis}
        _sym_eval(strip.loop.body, syms)
        phi_steps = strip.ptr_steps
        # pass 1: collect sites and partition each pointer root's walk
        sites: Dict[int, tuple] = {}   # id(ins) -> (root, off, consumed)
        by_root: Dict[int, list] = {}  # id(root) -> [(off, consumed)]
        roots: Dict[int, Value] = {}
        for ins in strip.loop.body.instrs:
            if ins.op in ("sload", "sstore"):
                # a scalar access through a walking pointer reads/writes
                # one element per *iteration*: the widened loop runs
                # 1/factor as many, so it would touch 1/factor of them
                a = syms.get(ins.args[0], Affine(ins.args[0], 0))
                if isinstance(a, Affine) and phi_steps.get(a.root):
                    return self.veto(
                        "walking-scalar-access",
                        f"scalar {ins.op} walks pointer "
                        f"{(a.root.hint or '?')!r} per iteration; "
                        f"kept narrow",
                        site=self._site_tag(ins),
                        line=ins.attrs.get("_line", 0))
                continue
            if ins.op != "intrin":
                continue
            kind = ins.attrs["kind"]
            if kind not in ("load", "store", "load_dup", "load2",
                            "store2"):
                continue
            name = ins.attrs["intrinsic"]
            line = ins.attrs.get("_line", 0)
            ptr = ins.args[0]
            a = syms.get(ptr, Affine(ptr, 0))
            root_step = (phi_steps.get(a.root)
                         if isinstance(a, Affine) else None)
            if kind == "load_dup":
                if not root_step:
                    continue                    # invariant broadcast
                # a walking broadcast load re-tiles as a group load
                # (factor fresh scalars, each still broadcast across
                # the original lanes) when it consumes exactly one
                # element per iteration from the front of the walk
                if a.off == 0 and root_step == 1:
                    self._group_loads.add(id(ins))
                    continue
                return self.veto(
                    "walking-broadcast-load",
                    f"{name}: per-iteration broadcast load walks "
                    f"the buffer; kept narrow",
                    site=self._site_tag(ins), line=line)
            # elements the site consumes per iteration: its lane count,
            # times the interleave degree for struct accesses (a vld2
            # of L-lane registers reads one contiguous run of 2L
            # elements and de-interleaves — the *element group* the
            # lane-group rule tracks)
            if kind == "load":
                consumed = ins.result.type.lanes
            elif kind == "store":
                consumed = ins.args[1].type.lanes
            elif kind == "load2":
                consumed = (len(ins.result.type.elems) *
                            ins.result.type.lanes)
            else:                                # store2 (segment)
                consumed = (len(ins.args[1].type.elems) *
                            ins.args[1].type.lanes)
            if not isinstance(a, Affine) or root_step is None:
                return self.veto(
                    "not-strip-rooted",
                    f"{name}: memory access is not rooted at a "
                    f"strip-walking pointer; kept narrow",
                    site=self._site_tag(ins), line=line)
            if a.off < 0 or root_step <= 0:
                return self.veto(
                    "non-contiguous-tiling",
                    f"{name}: access at offset {a.off} against a "
                    f"{root_step}-element walk does not tile "
                    f"contiguously; kept narrow",
                    site=self._site_tag(ins), line=line)
            sites[id(ins)] = (a.root, a.off, consumed, ins)
            roots[id(a.root)] = a.root
            by_root.setdefault(id(a.root), []).append((a.off, consumed))
        # each root's distinct (off, consumed) sites must tile
        # [0, root_step) contiguously
        for rid, pairs in by_root.items():
            root = roots[rid]
            root_step = phi_steps[root]
            uniq = sorted(set(pairs))
            pos = 0
            ok = True
            for off, consumed in uniq:
                if off != pos:
                    ok = False
                    break
                pos += consumed
            if not ok or pos != root_step:
                ins = next(i for _, (r, o, c, i) in sites.items()
                           if r is root)
                return self.veto(
                    "non-contiguous-tiling",
                    f"{ins.attrs['intrinsic']} "
                    f"({self._site_tag(ins)}): sites "
                    f"{uniq} against a {root_step}-element "
                    f"walk does not tile contiguously (unrolled "
                    f"strip?); kept narrow",
                    site=self._site_tag(ins),
                    line=ins.attrs.get("_line", 0))
        # pass 2: offset-class dataflow.  A partial site's class is the
        # rational span its offsets occupy within the walk; values from
        # one class must not meet another (the widened batch would
        # re-pair elements).  Accumulators feeding horizontal
        # reductions absorb any class (lane placement is summed away);
        # fold accumulators keep per-lane meaning, so they only admit
        # full-walk (class-free) operands.
        ACC = "acc"
        FOLD = "fold"
        classes: Dict[int, object] = {}
        for p in strip.vec_phis:
            classes[id(p)] = FOLD if id(p) in self._fold_phis else ACC

        def site_class(rid_ins):
            root, off, consumed, _ = sites[rid_ins]
            root_step = phi_steps[root]
            if consumed == root_step:
                return None
            return (Fraction(off, root_step),
                    Fraction(off + consumed, root_step))

        for ins in strip.loop.body.instrs:
            if ins.op != "intrin":
                continue
            kind = ins.attrs["kind"]
            if kind in ("load", "load2") and id(ins) in sites:
                classes[id(ins.result)] = site_class(id(ins))
                continue
            if kind in ("store", "store2") and id(ins) in sites:
                cls = site_class(id(ins))
                have = classes.get(id(ins.args[1]))
                if have is not None and have != cls:
                    return self.veto(
                        "offset-class-conflict",
                        f"{ins.attrs['intrinsic']} "
                        f"({self._site_tag(ins)}): stored value's "
                        f"offset class {have} does not match the "
                        f"site's {cls}; kept narrow",
                        site=self._site_tag(ins),
                        line=ins.attrs.get("_line", 0))
                continue
            if ins.result is None:
                continue
            cls = None
            for arg in ins.args:
                if not isinstance(arg.type, (VecType, VecTupleType)):
                    continue
                c = classes.get(id(arg))
                if c is None:
                    continue
                if c in (ACC, FOLD) or cls in (ACC, FOLD):
                    # an accumulator operand absorbs; a fold
                    # accumulator refuses classed operands
                    if FOLD in (c, cls) and not (
                            {c, cls} <= {ACC, FOLD, None}):
                        return self.veto(
                            "offset-class-conflict",
                            f"{ins.attrs['intrinsic']} "
                            f"({self._site_tag(ins)}): fold "
                            f"accumulator meets a partial-walk "
                            f"operand; kept narrow",
                            site=self._site_tag(ins),
                            line=ins.attrs.get("_line", 0))
                    cls = c if c in (ACC, FOLD) else cls
                elif cls is None:
                    cls = c
                elif cls != c:
                    return self.veto(
                        "offset-class-conflict",
                        f"{ins.attrs['intrinsic']} "
                        f"({self._site_tag(ins)}): operands from "
                        f"different offset classes {cls} vs {c}; "
                        f"kept narrow",
                        site=self._site_tag(ins),
                        line=ins.attrs.get("_line", 0))
            classes[id(ins.result)] = cls
        # yields back into fold/acc phis: a classed value yielded into
        # a fold phi re-pairs lanes — refuse
        for p, y in zip(strip.loop.phis, strip.loop.yields):
            if id(p) in self._fold_phis:
                c = classes.get(id(y))
                if c not in (None, ACC, FOLD):
                    return self.veto(
                        "offset-class-conflict",
                        f"accumulator {p.hint!r}: folded value is "
                        f"partial-walk classed; kept narrow",
                        site=p.hint)
        return True

    # -- accumulator legality ---------------------------------------------
    def check_accumulators(self, strip: StripInfo) -> bool:
        """A loop-carried vector accumulator is re-tilable two ways:
        its post-loop consumers are all horizontal reductions (the
        widened register reduces the same — vaddv needs a provably-zero
        init), or — the nested-microkernel shape — it is a provably
        zero-initialized *additive* chain, in which case the widened
        accumulator carries ``factor`` interleaved partial sums and a
        ``vfold`` after the predicated tail collapses them back to the
        narrow register its consumers expect (integer adds are modular,
        so the fold is bitwise exact)."""
        for phi, res, init in zip(strip.loop.phis, strip.loop.results,
                                  strip.loop.init):
            if phi not in strip.vec_phis:
                continue
            users = _users_of(self.fn, res)
            if users and all(
                    u.op == "intrin" and
                    u.attrs.get("isa_op") in _REDUCERS for u in users):
                ops = {u.attrs["isa_op"] for u in users}
                if "vaddv" in ops and not self._is_zero_vec(init):
                    return self.veto(
                        "nonzero-init",
                        f"accumulator {phi.hint!r}: vaddv over a tiled "
                        f"non-zero init would multiply it; kept narrow",
                        site=phi.hint)
                continue
            # non-reducer consumers: try the additive group fold
            idx = [i for i, p in enumerate(strip.loop.phis)
                   if p is phi][0]
            y = strip.loop.yields[idx]
            if users and self._is_zero_vec(init) \
                    and self._additive_chain(strip, phi, y):
                self._fold_phis.add(id(phi))
                continue
            if users and not self._is_zero_vec(init):
                return self.veto(
                    "nonzero-init",
                    f"accumulator {phi.hint!r}: group fold over a "
                    f"tiled non-zero init would multiply it; post-loop "
                    f"consumer is not a horizontal reduction; strip "
                    f"kept narrow", site=phi.hint)
            return self.veto(
                "accumulator-consumer",
                f"accumulator {phi.hint!r}: post-loop consumer is "
                f"not a horizontal reduction; strip kept narrow",
                site=phi.hint)
        return True

    def _additive_chain(self, strip: StripInfo, phi: Value,
                        y: Value) -> bool:
        """True when ``phi``'s in-body update is a pure additive chain
        (acc' = acc +/- f(...)): the accumulator value flows only
        through additive positions, each link used exactly once, ending
        at the yield — the shape under which summing the widened
        register's interleave groups equals the narrow accumulation."""
        body = strip.loop.body.instrs
        uses: Dict[int, List[Instr]] = {}
        for ins in body:
            for a in ins.args:
                uses.setdefault(id(a), []).append(ins)
        if uses.get(id(y)):
            return False                  # folded value also read raw
        cur = phi
        hops = 0
        while cur is not y and hops < 256:
            hops += 1
            us = uses.get(id(cur), [])
            if len(us) != 1 or us[0].op != "intrin" \
                    or us[0].result is None:
                return False
            ins = us[0]
            op = ins.attrs.get("isa_op")
            if op == "vadd":
                if not (ins.args[0] is cur or ins.args[1] is cur):
                    return False
            elif op in ("vsub", "vmla", "vmls", "vfma", "vmlal",
                        "vmlsl"):
                if ins.args[0] is not cur:
                    return False
            else:
                return False
            cur = ins.result
        return cur is y

    def _is_zero_vec(self, v: Value) -> bool:
        d = self.defs.get(id(v))
        if d is None or d.op != "intrin" or d.attrs.get("kind") != "dup":
            return False
        c = self.defs.get(id(d.args[0]))
        return c is not None and c.op == "const" and \
            float(c.attrs["value"]) == 0.0

    # -- masked-tail legality ----------------------------------------------
    def plan_masked_tail(self, strip: StripInfo):
        """Decide whether one predicated strip iteration can subsume the
        remainder.  Returns ({id(load instr): fill value}, site scales —
        see :meth:`_site_scales`) or None."""
        # the remaining count is in *counter* elements; each pointer may
        # advance an integer multiple of it per iteration (a cmul strip
        # counting complex pairs walks its float buffers 2 elems/pair),
        # so every site's active count is cnt scaled by its pointer's
        # per-counter-element stride — see _site_scales
        for p, d in strip.ptr_steps.items():
            if d <= 0 or d % strip.step != 0:
                self.veto(
                    "pointer-stride",
                    f"pointer {p.hint!r} advances {d}/iter against a "
                    f"{strip.step}-element counter; masked tail off",
                    site=p.hint)
                return None
        # per-site active counts must be whole lane counts for every
        # possible remainder.  Exact mode: every site's scale/div is an
        # integer (cnt * scale / div is whole for any cnt) — the tail
        # covers everything left, per-element.  Rounded mode: div only
        # divides scale * step (double-widening / interleave chains), so
        # the tail covers whole original strips (cnt rounded down to a
        # step multiple) and any sub-strip residue keeps the narrow
        # loop's own semantics (scalar tail, or contractually absent).
        # Offset sites keep div == 1 (their count subtracts off*factor,
        # which has no interleave correction).
        site_scales = self._site_scales(strip)
        exact = True
        for iid, (scale, div, off, ins) in site_scales.items():
            if off and div != 1:
                self.veto(
                    "interleave-remainder",
                    f"{ins.attrs['intrinsic']}: {div}-way interleaved "
                    f"site at offset {off} has no whole-lane active "
                    f"count; masked tail off",
                    site=self._site_tag(ins),
                    line=ins.attrs.get("_line", 0))
                return None
            if scale % div != 0:
                exact = False
                if (scale * strip.step) % div != 0:
                    self.veto(
                        "interleave-remainder",
                        f"{ins.attrs['intrinsic']}: {div}-way "
                        f"interleaved site at {scale} elems per "
                        f"counter element has no whole-lane active "
                        f"count; masked tail off",
                        site=self._site_tag(ins),
                        line=ins.attrs.get("_line", 0))
                    return None
        use_rounded = not exact
        # dataflow over the body: masked-off load lanes must stay
        # neutral through every accumulator update (zero through
        # multiplies into additive updates; identity fills for max/min)
        fills: Dict[int, object] = {}
        zeroish: Dict[int, bool] = {}
        use_count: Dict[int, int] = {}
        loads: Dict[int, Instr] = {}
        phi_ids = {id(p) for p in strip.vec_phis}
        preserved: Dict[int, int] = {}         # value id -> phi id
        for ins in strip.loop.body.instrs:
            for a in ins.args:
                use_count[id(a)] = use_count.get(id(a), 0) + 1
        for ins in strip.loop.body.instrs:
            if ins.op != "intrin":
                continue
            kind, isa_op = ins.attrs["kind"], ins.attrs["isa_op"]
            rid = id(ins.result) if ins.result is not None else None
            if kind == "load":
                loads[rid] = ins
                fills[id(ins)] = 0
                zeroish[rid] = True
                continue
            if kind == "load_dup" and id(ins) in self._group_loads:
                # masked group-broadcast load: inactive groups fill 0
                fills[id(ins)] = 0
                zeroish[rid] = True
                continue
            if kind == "load2":
                # struct loads zero-fill; their tuple results are not
                # tracked through the accumulator dataflow (a strip
                # folding vld2 lanes into a carried accumulator falls
                # back to the narrow epilogue)
                fills[id(ins)] = 0
                continue
            if rid is None:                    # store: lanes masked off
                continue

            def acc_of(v):
                if id(v) in phi_ids:
                    return id(v)
                return preserved.get(id(v))

            vec_args = [a for a in ins.args
                        if isinstance(a.type, VecType)]
            az = [zeroish.get(id(a), False) for a in vec_args]
            zeroish[rid] = False
            if isa_op in ("vmul", "vand", "vmull"):
                # (the widening multiply of a zero-filled operand is
                # zero at 2x element width the same way)
                zeroish[rid] = any(az)
            elif isa_op in ("vsub",):
                zeroish[rid] = all(az)
            elif isa_op == "vadd":
                zeroish[rid] = all(az)
                for x, y in ((ins.args[0], ins.args[1]),
                             (ins.args[1], ins.args[0])):
                    if acc_of(x) is not None and zeroish.get(id(y), False):
                        preserved[rid] = acc_of(x)
            elif isa_op in ("vfma", "vmla", "vmls", "vmlal", "vmlsl"):
                # the widening macc family preserves its accumulator the
                # same way: a zero-filled masked load makes the (widened)
                # product zero, so acc +/- 0 passes through
                acc = acc_of(ins.args[0])
                if acc is not None and any(
                        zeroish.get(id(a), False) for a in ins.args[1:]):
                    preserved[rid] = acc
            elif isa_op in ("vmax", "vmin"):
                for x, y in ((ins.args[0], ins.args[1]),
                             (ins.args[1], ins.args[0])):
                    if acc_of(x) is not None and id(y) in loads \
                            and use_count.get(id(y), 0) == 1:
                        ld = loads[id(y)]
                        fills[id(ld)] = _identity_fill(
                            ld.result.type, minimum=(isa_op == "vmax"))
                        preserved[rid] = acc_of(x)
        for phi, y in zip(strip.loop.phis, strip.loop.yields):
            if phi not in strip.vec_phis:
                continue
            if not (y is phi or preserved.get(id(y)) == id(phi)):
                self.veto(
                    "unneutral-tail-lanes",
                    f"accumulator {phi.hint!r}: masked-off tail lanes "
                    f"are not provably neutral; masked tail off",
                    site=phi.hint)
                return None
        return fills, site_scales, use_rounded

    def _site_scales(self, strip: StripInfo) -> Dict[int, tuple]:
        """Per memory site (keyed by id(instr)), (scale, div, off,
        instr): the site's pointer advances ``scale`` elements per
        counter element, the site packs ``div`` consecutive elements
        into each register lane (1 for unit-stride vld1/vst1, the
        segment arity n for de-interleaving vld<n>/vst<n>), and the
        site reads at affine element offset ``off`` into the walk.  A
        masked site's per-register active count is
        ``cnt * scale / div - off * factor``."""
        syms: Dict[Value, object] = {p: Affine(p, 0)
                                     for p in strip.loop.phis}
        _sym_eval(strip.loop.body, syms)
        out: Dict[int, tuple] = {}
        for ins in strip.loop.body.instrs:
            if ins.op != "intrin":
                continue
            kind = ins.attrs["kind"]
            if kind == "load_dup" and id(ins) in self._group_loads:
                out[id(ins)] = (1, 1, 0, ins)
                continue
            if kind not in ("load", "store", "load2", "store2"):
                continue
            a = syms.get(ins.args[0], Affine(ins.args[0], 0))
            d = (strip.ptr_steps.get(a.root)
                 if isinstance(a, Affine) else None)
            if d is None:
                continue           # unreachable after check_memory_sites
            if kind == "load2":
                div = len(ins.result.type.elems)
            elif kind == "store2":
                div = len(ins.args[1].type.elems)
            else:
                div = 1
            out[id(ins)] = (d // strip.step, div, a.off, ins)
        return out

    # -- widened main loop -------------------------------------------------
    def widen_loop(self, strip: StripInfo, factor: int, dst: Block,
                   tile_map: Dict[int, Value]):
        loop = strip.loop

        # widen loop-invariant vector registers used inside the body
        for v in _outer_vec_uses(loop):
            self.emit_tile(v, factor, dst, tile_map)

        new_phis, new_results, new_init = [], [], []
        result_map: Dict[int, Value] = {}
        for p, r, i in zip(loop.phis, loop.results, loop.init):
            if p in strip.vec_phis:
                wty = p.type.widened(factor)
                np_, nr = self.val(wty, p.hint), self.val(wty, r.hint)
                init_v = self.emit_tile(i, factor, dst, tile_map)
                self.vmap[id(p)] = np_
                result_map[id(r)] = nr
                new_phis.append(np_)
                new_results.append(nr)
                new_init.append(init_v)
            else:
                new_phis.append(p)
                new_results.append(r)
                new_init.append(self.look(i))

        cond = self.widen_block(loop.cond, strip, factor, is_cond=True)
        body = self.widen_block(loop.body, strip, factor)
        new = Loop(op="loop", args=tuple(new_init), phis=new_phis,
                   init=new_init, cond=cond,
                   cond_value=self.look(loop.cond_value), body=body,
                   yields=[self.look(y) for y in loop.yields],
                   results=new_results)
        dst.instrs.append(new)
        self.notes.append(
            f"strip re-tiled {strip.step} -> {strip.step * factor} "
            f"elems/iter on {self.tgt.name} ({factor}x)")
        return new, result_map

    def emit_tile(self, v: Value, factor: int, dst: Block,
                  tile_map: Dict[int, Value]) -> Value:
        if id(v) in tile_map:
            return tile_map[id(v)]
        wty = v.type.widened(factor)
        wide = self.val(wty, hint=(v.hint or "inv") + ".wide")
        dst.instrs.append(Instr(
            "intrin", (v,), wide,
            attrs={"intrinsic": f"revec.tile[{factor}x]",
                   "isa_op": "vtile", "kind": "tile", "reps": factor,
                   "width_bits": wty.bits}))
        tile_map[id(v)] = wide
        self.vmap[id(v)] = wide
        return wide

    def widen_block(self, src: Block, strip: StripInfo,
                    factor: int, is_cond: bool = False) -> Block:
        """Copy a strip cond/body block, widening vector values and
        scaling the counter/pointer-walk constants.  A count-to-zero
        condition (``n != 0``) guards a widened body only while a whole
        widened strip remains, so it is rewritten to
        ``n >= step * factor`` — the predicated tail (or epilogue)
        covers the residue exactly like the guarded ``>=`` shape."""
        scale = _scaled_consts(src, strip)
        out = Block()
        for ins in src.instrs:
            if is_cond and strip.cond_ne and ins.op == "scmp" \
                    and ins.result is strip.loop.cond_value:
                k = self.val(strip.counter.type, "k.wide")
                out.instrs.append(Instr(
                    "const", (), k,
                    attrs={"value": strip.step * factor}))
                nv = self.val(ins.result.type, ins.result.hint)
                self.vmap[id(ins.result)] = nv
                if len(ins.args) > 1 and ins.args[1] is strip.counter:
                    out.instrs.append(Instr(
                        "scmp", (k, self.look(ins.args[1])), nv,
                        attrs={"op": "<="}))
                else:
                    out.instrs.append(Instr(
                        "scmp", (self.look(ins.args[0]), k), nv,
                        attrs={"op": ">="}))
                continue
            if ins.op == "const" and id(ins) in scale:
                nv = self.val(ins.result.type, ins.result.hint)
                self.vmap[id(ins.result)] = nv
                out.instrs.append(Instr(
                    "const", (), nv,
                    attrs={"value": ins.attrs["value"] * factor}))
            elif ins.op == "intrin":
                if ins.attrs["kind"] == "load_dup" \
                        and id(ins) in self._group_loads:
                    out.instrs.append(self.widen_intrin(
                        ins, factor, override={
                            "kind": "load_group", "isa_op": "vld1g",
                            "intrinsic":
                                ins.attrs["intrinsic"] + "[group]",
                            "reps": ins.result.type.lanes,
                            "groups": factor}))
                else:
                    out.instrs.append(self.widen_intrin(ins, factor))
            else:
                out.instrs.append(self.remap_plain(ins))
        return out

    def remap_plain(self, ins: Instr) -> Instr:
        new_args = tuple(self.look(a) for a in ins.args)
        res = ins.result
        if res is not None:
            nr = self.val(res.type, res.hint)
            self.vmap[id(res)] = nr
            res = nr
        return Instr(ins.op, new_args, res, dict(ins.attrs))

    def widen_intrin(self, ins: Instr, factor: int,
                     override=None) -> Instr:
        new_args = tuple(self.look(a) for a in ins.args)
        res = ins.result
        attrs = dict(ins.attrs)
        attrs["width_bits"] = ins.attrs["width_bits"] * factor
        if override:
            attrs.update(override)
        if res is not None:
            nty = (res.type.widened(factor)
                   if isinstance(res.type, (VecType, VecTupleType))
                   else res.type)
            nr = self.val(nty, res.hint)
            self.vmap[id(res)] = nr
            res = nr
        return Instr("intrin", new_args, res, attrs)

    # -- predicated tail ----------------------------------------------------
    def emit_masked_tail(self, strip: StripInfo, new_loop: Loop,
                         factor: int, plan, tail_exists: bool,
                         dst: Block,
                         result_map: Dict[int, Value]) -> Dict[int, Value]:
        """One masked strip iteration over the remaining elements, then
        fold the consumed count out of the counter/pointers so any
        scalar tail loop runs zero iterations."""
        loop = strip.loop
        idx = {id(p): i for i, p in enumerate(loop.phis)}
        n_res = new_loop.results[idx[id(strip.counter)]]

        # active count: everything left when a scalar tail would have
        # finished the job; otherwise — or when a site's interleave
        # only divides whole strips (rounded mode) — only whole
        # original strips, leaving the sub-strip residue to the narrow
        # loop's own contract
        fills, site_scales, use_rounded = plan
        cty = strip.counter.type
        if tail_exists and not use_rounded:
            cnt = n_res
        else:
            k = self.val(cty, "k")
            dst.instrs.append(Instr("const", (), k,
                                    attrs={"value": strip.step}))
            rem = self.val(cty, "rem")
            dst.instrs.append(Instr("sbin", (n_res, k), rem,
                                    attrs={"op": "%"}))
            cnt = self.val(cty, "cnt")
            dst.instrs.append(Instr("sbin", (n_res, rem), cnt,
                                    attrs={"op": "-"}))

        # per-site active counts: a site whose pointer walks ``scale``
        # elements per counter element (packing ``div`` of them per
        # lane) at element offset ``off`` into the walk is live for
        # cnt * scale / div - off * factor lanes, clamped at zero —
        # offset sites go fully inactive when the remainder ends before
        # their slice of the widened batch.  scale/div reduces over the
        # gcd, so double-widening chains where div only divides the
        # product cnt*scale still emit exact integer arithmetic.
        # (1, 1, 0) sites reuse cnt directly, so unit-stride kernels
        # emit no extra scalars.
        zero_c: List[Value] = []

        def zero() -> Value:
            if not zero_c:
                z = self.val(cty, "zero")
                dst.instrs.append(Instr("const", (), z,
                                        attrs={"value": 0}))
                zero_c.append(z)
            return zero_c[0]

        cnt_cache: Dict[tuple, Value] = {(1, 1, 0): cnt}

        def site_cnt_of(s: int, d: int, off: int) -> Value:
            fr = Fraction(s, d)
            key = (fr.numerator, fr.denominator, off)
            if key in cnt_cache:
                return cnt_cache[key]
            v = cnt_cache.get((fr.numerator, fr.denominator, 0))
            if v is None:
                v = cnt
                if fr.numerator != 1:
                    m = self.val(cty, "m")
                    dst.instrs.append(Instr(
                        "const", (), m,
                        attrs={"value": fr.numerator}))
                    nv = self.val(cty, "cnt.scaled")
                    dst.instrs.append(Instr("sbin", (v, m), nv,
                                            attrs={"op": "*"}))
                    v = nv
                if fr.denominator != 1:
                    m = self.val(cty, "m")
                    dst.instrs.append(Instr(
                        "const", (), m,
                        attrs={"value": fr.denominator}))
                    nv = self.val(cty, "cnt.scaled")
                    dst.instrs.append(Instr("sbin", (v, m), nv,
                                            attrs={"op": "/"}))
                    v = nv
                cnt_cache[(fr.numerator, fr.denominator, 0)] = v
            if off:
                o = self.val(cty, "off.wide")
                dst.instrs.append(Instr(
                    "const", (), o, attrs={"value": off * factor}))
                nv = self.val(cty, "cnt.site")
                dst.instrs.append(Instr("sbin", (v, o), nv,
                                        attrs={"op": "-"}))
                neg = self.val(ScalarType("bool"), "cnt.neg")
                dst.instrs.append(Instr("scmp", (nv, zero()), neg,
                                        attrs={"op": "<"}))
                cl = self.val(cty, "cnt.clamped")
                dst.instrs.append(Instr(
                    "sselect", (neg, zero(), nv), cl))
                v = cl
            cnt_cache[key] = v
            return v

        def site_cnt(ins: Instr) -> Value:
            s, d, off, _ = site_scales.get(id(ins), (1, 1, 0, ins))
            return site_cnt_of(s, d, off)

        # bind phis to the widened loop's results and copy the body,
        # loads/stores becoming their predicated forms
        for p, r in zip(loop.phis, new_loop.results):
            self.vmap[id(p)] = r
        scale = _scaled_consts(loop.body, strip)
        for ins in loop.body.instrs:
            if ins.op == "const" and id(ins) in scale:
                nv = self.val(ins.result.type, ins.result.hint)
                self.vmap[id(ins.result)] = nv
                dst.instrs.append(Instr(
                    "const", (), nv,
                    attrs={"value": ins.attrs["value"] * factor}))
            elif ins.op == "intrin":
                kind = ins.attrs["kind"]
                if kind == "load":
                    out = self.widen_intrin(ins, factor, override={
                        "kind": "load_masked", "isa_op": "vld1m",
                        "intrinsic": ins.attrs["intrinsic"] + "[masked]",
                        "fill": fills.get(id(ins), 0)})
                    out.args = (out.args[0], site_cnt(ins))
                elif kind == "load_dup" and id(ins) in self._group_loads:
                    out = self.widen_intrin(ins, factor, override={
                        "kind": "load_group_masked", "isa_op": "vld1gm",
                        "intrinsic":
                            ins.attrs["intrinsic"] + "[group,masked]",
                        "reps": ins.result.type.lanes,
                        "groups": factor,
                        "fill": fills.get(id(ins), 0)})
                    out.args = (out.args[0], site_cnt(ins))
                elif kind == "store":
                    out = self.widen_intrin(ins, factor, override={
                        "kind": "store_masked", "isa_op": "vst1m",
                        "intrinsic": ins.attrs["intrinsic"] + "[masked]"})
                    out.args = (out.args[0], out.args[1], site_cnt(ins))
                elif kind == "load2":
                    seg = len(ins.result.type.elems)
                    out = self.widen_intrin(ins, factor, override={
                        "kind": "load2_masked", "isa_op": f"vld{seg}m",
                        "intrinsic": ins.attrs["intrinsic"] + "[masked]",
                        "fill": fills.get(id(ins), 0)})
                    out.args = (out.args[0], site_cnt(ins))
                elif kind == "store2":
                    seg = len(ins.args[1].type.elems)
                    out = self.widen_intrin(ins, factor, override={
                        "kind": "store2_masked", "isa_op": f"vst{seg}m",
                        "intrinsic": ins.attrs["intrinsic"] + "[masked]"})
                    out.args = (out.args[0], out.args[1], site_cnt(ins))
                else:
                    out = self.widen_intrin(ins, factor)
                dst.instrs.append(out)
            else:
                dst.instrs.append(self.remap_plain(ins))

        # downstream: counter loses cnt, pointers advance their scaled
        # counts, accumulators become their tail-updated values
        final: Dict[int, Value] = dict(result_map)
        left = self.val(strip.counter.type, "n.left")
        dst.instrs.append(Instr("sbin", (n_res, cnt), left,
                                attrs={"op": "-"}))
        for p, old_r in zip(loop.phis, loop.results):
            if p is strip.counter:
                final[id(old_r)] = left
            elif isinstance(p.type, PtrType):
                adv = self.val(p.type, p.hint)
                pd = strip.ptr_steps.get(p, strip.step)
                dst.instrs.append(Instr(
                    "ptradd",
                    (self.look(old_r),
                     site_cnt_of(pd // strip.step, 1, 0)),
                    adv))
                final[id(old_r)] = adv
            elif p in strip.vec_phis:
                y = loop.yields[idx[id(p)]]
                wide_y = self.look(y)
                if id(p) in self._fold_phis:
                    # collapse the widened additive accumulator's
                    # interleave groups back to the narrow register
                    # its (non-reduction) consumers expect
                    folded = self.val(p.type, (p.hint or "acc")
                                      + ".fold")
                    dst.instrs.append(Instr(
                        "intrin", (wide_y,), folded,
                        attrs={"intrinsic": f"revec.fold[{factor}x]",
                               "isa_op": "vfold", "kind": "fold",
                               "factor": factor,
                               "width_bits": wide_y.type.bits}))
                    final[id(old_r)] = folded
                else:
                    final[id(old_r)] = wide_y
        self.notes.append("remainder subsumed by one predicated strip "
                          "(vld1m/vst1m/vld2m/vst2m active count)")
        return final

    # -- narrow epilogue (masked tail not provable) -------------------------
    def emit_epilogue(self, strip: StripInfo, new_loop: Loop,
                      dst: Block) -> Dict[int, Value]:
        """Clone the *original* strip loop after the widened one: it
        consumes the remaining sub-group strips at NEON granularity and
        feeds the (kept) scalar tail.  Only for accumulator-free strips."""
        loop = strip.loop
        epi_init = [self.look(r) for r in new_loop.results]
        for p in loop.phis:
            self.vmap[id(p)] = self.val(p.type, p.hint)
        cond, body = Block(), Block()
        for ins in loop.cond.instrs:
            body_ins = self.remap_plain(ins) if ins.op != "intrin" \
                else self.widen_intrin(ins, 1)
            cond.instrs.append(body_ins)
        for ins in loop.body.instrs:
            body.instrs.append(self.remap_plain(ins) if ins.op != "intrin"
                               else self.widen_intrin(ins, 1))
        epi_results = [self.val(r.type, r.hint) for r in loop.results]
        epi = Loop(op="loop", args=tuple(epi_init),
                   phis=[self.look(p) for p in loop.phis],
                   init=epi_init, cond=cond,
                   cond_value=self.look(loop.cond_value), body=body,
                   yields=[self.look(y) for y in loop.yields],
                   results=epi_results)
        dst.instrs.append(epi)
        self.notes.append("narrow epilogue strip kept (masked tail not "
                          "provable)")
        return {id(r): nr for r, nr in zip(loop.results, epi_results)}


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _identity_fill(ty: VecType, minimum: bool):
    """Neutral element for a max (minimum=True fills -inf/INT_MIN) or
    min accumulator load."""
    dt = numpy_dtype(ty.dtype)
    if np.issubdtype(dt, np.floating):
        return float("-inf") if minimum else float("inf")
    info = np.iinfo(dt)
    return int(info.min) if minimum else int(info.max)


def _body_vec_types(loop: Loop) -> List[VecType]:
    tys, seen = [], set()

    def note(ty):
        if isinstance(ty, VecTupleType):
            for e in ty.elems:
                note(e)
            return
        if isinstance(ty, VecType) and ty.name not in seen:
            seen.add(ty.name)
            tys.append(ty)

    for p in loop.phis:
        note(p.type)
    for ins in loop.body.instrs:
        for a in ins.args:
            note(a.type)
        if ins.result is not None:
            note(ins.result.type)
    return tys


def _outer_vec_uses(loop: Loop) -> List[Value]:
    """Vector values defined outside the loop but read in its body."""
    defined = {id(p) for p in loop.phis}
    for ins in loop.body.instrs:
        if ins.result is not None:
            defined.add(id(ins.result))
    out, seen = [], set()
    for ins in loop.body.instrs:
        for a in ins.args:
            if isinstance(a.type, (VecType, VecTupleType)) and \
                    id(a) not in defined and id(a) not in seen:
                seen.add(id(a))
                out.append(a)
    return out


def _scaled_consts(block: Block, strip: StripInfo) -> set:
    """Const instrs whose value must scale with the widening factor:
    pointer-walk deltas, the counter step, and the compare bound."""
    consts: Dict[int, Instr] = {}
    for ins in block.instrs:
        if ins.op == "const":
            consts[id(ins.result)] = ins
    ptrish = {id(p) for p in strip.ptr_steps}
    out = set()
    for ins in block.instrs:
        if ins.op == "ptradd" and id(ins.args[0]) in ptrish:
            if id(ins.args[1]) in consts:
                out.add(id(consts[id(ins.args[1])]))
            if ins.result is not None:
                ptrish.add(id(ins.result))
        elif ins.op in ("sbin", "scmp"):
            if any(a is strip.counter for a in ins.args):
                for a in ins.args:
                    if id(a) in consts:
                        out.add(id(consts[id(a)]))
    return out


def _tail_consumes(strip: StripInfo) -> bool:
    """Is there a later loop in the strip's containing block seeded
    with this strip's counter result (the XNNPACK scalar-tail shape)?
    For hoisted inner strips the containing block is the outer loop's
    body, so a per-row cleanup loop is found the same way."""
    n_res = strip.loop.results[
        [i for i, p in enumerate(strip.loop.phis)
         if p is strip.counter][0]]
    block = strip.block
    if block is None:
        return False
    seen_strip = False
    for ins in block.instrs:
        if ins is strip.loop:
            seen_strip = True
            continue
        if seen_strip and isinstance(ins, Loop):
            if any(i is n_res for i in ins.init):
                return True
    return False


def _def_map(fn: TFunction) -> Dict[int, Instr]:
    defs: Dict[int, Instr] = {}

    def walk(block: Block):
        for ins in block.instrs:
            if ins.result is not None:
                defs[id(ins.result)] = ins
            if isinstance(ins, Loop):
                walk(ins.cond)
                walk(ins.body)
            elif isinstance(ins, IfOp):
                walk(ins.then)
                walk(ins.els)

    walk(fn.body)
    return defs


def _users_of(fn: TFunction, v: Value) -> List[Instr]:
    users: List[Instr] = []

    def walk(block: Block):
        for ins in block.instrs:
            if any(a is v for a in ins.args):
                if ins not in users:
                    users.append(ins)
            if isinstance(ins, Loop):
                if any(a is v for a in ins.init) or \
                        any(a is v for a in ins.yields):
                    if ins not in users:
                        users.append(ins)
                walk(ins.cond)
                walk(ins.body)
            elif isinstance(ins, IfOp):
                walk(ins.then)
                walk(ins.els)

    walk(fn.body)
    return users


def _max_id(fn: TFunction) -> int:
    top = max((p.id for p in fn.params), default=0)

    def walk(block: Block):
        nonlocal top
        for ins in block.instrs:
            for v in ins.args:
                top = max(top, v.id)
            if ins.result is not None:
                top = max(top, ins.result.id)
            if isinstance(ins, Loop):
                for v in ins.phis + ins.results:
                    top = max(top, v.id)
                walk(ins.cond)
                walk(ins.body)
            elif isinstance(ins, IfOp):
                for v in ins.results:
                    top = max(top, v.id)
                walk(ins.then)
                walk(ins.els)

    walk(fn.body)
    return top
