"""A small typed SSA IR for ported NEON kernels.

Values are immutable and single-assignment; control flow is *structured*
(scf-style loop/if regions with explicit loop-carried values) rather
than a CFG with phi nodes — the corpus subset has no irreducible flow,
and structured regions interpret directly.

The type system carries the paper's Table-2 NEON register types
(:data:`repro_torch.core.vtypes.NEON_TYPES`): every vector-valued instruction
knows the fixed-width logical register it manipulates, which is what the
``vlen >= width`` substitution rule consumes at translation time.

Instruction set:

  const            — literal scalar
  sbin/scmp/sneg…  — scalar arithmetic on loop counters and addresses
  scast            — scalar conversion
  sselect          — scalar ternary
  ptradd           — pointer displacement (element units)
  sload/sstore     — scalar memory access through a pointer
  intrin           — a translated NEON intrinsic: attrs carry the source
                     name, the target logical-ISA op, and the register
                     width; execution routes through registry.dispatch
  loop             — while-style region with loop-carried values
  if               — two-armed region yielding merged values
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Tuple, Union

from ..core.targets import itemsize
from ..core.vtypes import (LVec, NEON_TYPES, dtype_name, neon_lvec,
                           torch_dtype)

__all__ = [
    "VecType", "VecTupleType", "ScalarType", "PtrType", "IRType",
    "vec_type", "vec_tuple_type", "is_vec_tuple_name",
    "Value", "Instr", "Loop", "IfOp", "Block", "TFunction",
]


# ---------------------------------------------------------------------------
# Types
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class VecType:
    """A vector register type: a Table-2 NEON name, or a *widened*
    register produced by the re-vectorizer (``port.revec``), which
    re-tiles NEON-granularity strips at the target's VLEN x LMUL.

    NEON types (``wide_lanes is None``) read their lane layout from
    :data:`repro_torch.core.vtypes.NEON_TYPES`; widened types carry it
    explicitly (their names — 'float32x32' — are deliberately not valid
    Table-2 spellings, so they can never be confused for source types).
    """
    name: str                      # 'float32x4_t' | widened 'float32x32'
    wide_lanes: Optional[int] = None
    wide_dtype: Optional[str] = None

    @property
    def lvec(self) -> LVec:
        if self.wide_lanes is not None:
            return LVec((self.wide_lanes,), torch_dtype(self.wide_dtype))
        return neon_lvec(self.name)

    @property
    def lanes(self) -> int:
        if self.wide_lanes is not None:
            return self.wide_lanes
        return NEON_TYPES[self.name][0][0]

    @property
    def dtype(self):
        if self.wide_dtype is not None:
            return torch_dtype(self.wide_dtype)
        return NEON_TYPES[self.name][1]

    @property
    def bits(self) -> int:
        return self.lanes * itemsize(self.dtype) * 8

    @property
    def is_neon(self) -> bool:
        return self.wide_lanes is None

    def widened(self, factor: int) -> "VecType":
        """This register re-tiled ``factor`` x wider (factor 1 = self)."""
        if factor == 1:
            return self
        lanes = self.lanes * factor
        dt = dtype_name(self.dtype)
        return VecType(name=f"{dt}x{lanes}", wide_lanes=lanes,
                       wide_dtype=dt)

    def __str__(self):
        return self.name


@dataclasses.dataclass(frozen=True)
class VecTupleType:
    """A multi-register value: NEON's ``<elem>x<lanes>x2_t`` structs, as
    returned by the de-interleaving struct loads (``vld2``) and consumed
    by the interleaving stores (``vst2``).  The tuple is *not* one wide
    register — each element is its own logical register, and the
    re-vectorizer widens them per element group (every register of the
    tuple carries the same lane count, so one widening factor applies
    to all of them)."""
    elems: Tuple[VecType, ...]

    @property
    def lanes(self) -> int:
        """Lanes *per element register* (uniform across the tuple)."""
        return self.elems[0].lanes

    @property
    def dtype(self):
        return self.elems[0].dtype

    @property
    def bits(self) -> int:
        """Total bits across the registers the tuple occupies — its
        register-file footprint.  NOT the Table-2 substitution width:
        each member register maps individually (a vld2q of f32 is two
        Q registers, native wherever one Q register is), so
        ``intrinsics.resolve`` reports the per-register ``elems[0]
        .bits`` for the ``vlen >= width`` rule."""
        return sum(e.bits for e in self.elems)

    @property
    def is_neon(self) -> bool:
        return all(e.is_neon for e in self.elems)

    def widened(self, factor: int) -> "VecTupleType":
        if factor == 1:
            return self
        return VecTupleType(tuple(e.widened(factor) for e in self.elems))

    def __str__(self):
        e = self.elems[0]
        if e.is_neon:
            return e.name[:-2] + f"x{len(self.elems)}_t"
        return f"({', '.join(str(x) for x in self.elems)})"


@dataclasses.dataclass(frozen=True)
class ScalarType:
    dtype: str                     # 'float32', 'int64', 'bool', ...

    def __str__(self):
        return self.dtype


@dataclasses.dataclass(frozen=True)
class PtrType:
    elem: str                      # element dtype name
    const: bool = False

    def __str__(self):
        c = "const " if self.const else ""
        return f"{c}{self.elem}*"


IRType = Union[VecType, VecTupleType, ScalarType, PtrType]


def vec_type(name: str) -> VecType:
    if name not in NEON_TYPES:
        raise KeyError(f"not a Table-2 NEON register type: {name!r}")
    return VecType(name)


_TUPLE_RE = re.compile(r"^([a-z0-9]+x\d+)x(\d+)_t$")


def is_vec_tuple_name(name: str) -> bool:
    m = _TUPLE_RE.match(name)
    return bool(m) and f"{m.group(1)}_t" in NEON_TYPES and \
        m.group(2) in ("2", "3", "4")


def vec_tuple_type(name: str) -> VecTupleType:
    """'float32x4x3_t' -> VecTupleType of three float32x4_t registers."""
    m = _TUPLE_RE.match(name)
    if not m or f"{m.group(1)}_t" not in NEON_TYPES:
        raise KeyError(f"not a NEON multi-register struct type: {name!r}")
    if m.group(2) not in ("2", "3", "4"):
        raise KeyError(f"{name!r}: only 2/3/4-tuple register structs are "
                       f"in the subset (vld2/vld3/vld4)")
    return VecTupleType((VecType(f"{m.group(1)}_t"),) * int(m.group(2)))


# ---------------------------------------------------------------------------
# Values and instructions
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class Value:
    """An SSA value.  Identity (not id number) is the key — Values are
    compared by object identity so region rebuilds can't collide."""
    id: int
    type: IRType
    hint: str = ""

    def __str__(self):
        h = f".{self.hint}" if self.hint else ""
        return f"%{self.id}{h}"


@dataclasses.dataclass(eq=False)
class Instr:
    op: str
    args: Tuple[Value, ...]
    result: Optional[Value] = None
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(eq=False)
class Block:
    instrs: List[Instr] = dataclasses.field(default_factory=list)


@dataclasses.dataclass(eq=False)
class Loop(Instr):
    """While-style region.  ``phis`` are the loop-carried SSA values,
    visible to both the condition and body blocks; each iteration
    evaluates ``cond`` (producing ``cond_value``), runs ``body``, and
    re-binds the phis to ``yields``.  ``results`` are the phi values
    observable after exit."""
    phis: List[Value] = dataclasses.field(default_factory=list)
    init: List[Value] = dataclasses.field(default_factory=list)
    cond: Block = dataclasses.field(default_factory=Block)
    cond_value: Optional[Value] = None
    body: Block = dataclasses.field(default_factory=Block)
    yields: List[Value] = dataclasses.field(default_factory=list)
    results: List[Value] = dataclasses.field(default_factory=list)


@dataclasses.dataclass(eq=False)
class IfOp(Instr):
    cond_value: Optional[Value] = None
    then: Block = dataclasses.field(default_factory=Block)
    then_yields: List[Value] = dataclasses.field(default_factory=list)
    els: Block = dataclasses.field(default_factory=Block)
    els_yields: List[Value] = dataclasses.field(default_factory=list)
    results: List[Value] = dataclasses.field(default_factory=list)


@dataclasses.dataclass(eq=False)
class TFunction:
    """A typed, translated kernel: C params become SSA params; pointer
    params double as named memory buffers in the interpreter."""
    name: str
    params: List[Value]
    body: Block
    # pointer params written through vst1/sstore — the kernel's outputs
    writes: List[str] = dataclasses.field(default_factory=list)
    source: str = ""
    # source provenance (the .c file the kernel was lowered from, when
    # known) — veto/error messages render PortError-style file:line
    filename: str = ""

    # -- introspection ------------------------------------------------------
    def intrinsic_sites(self) -> List[Instr]:
        """Every 'intrin' instruction anywhere in the region tree."""
        out: List[Instr] = []

        def walk(block: Block):
            for ins in block.instrs:
                if ins.op == "intrin":
                    out.append(ins)
                if isinstance(ins, Loop):
                    walk(ins.cond)
                    walk(ins.body)
                elif isinstance(ins, IfOp):
                    walk(ins.then)
                    walk(ins.els)

        walk(self.body)
        return out

    def pretty(self) -> str:
        lines = [f"func @{self.name}(" +
                 ", ".join(f"{p}: {p.type}" for p in self.params) + ")"]

        def emit(block: Block, indent: int):
            pad = "  " * indent
            for ins in block.instrs:
                if isinstance(ins, Loop):
                    phis = ", ".join(f"{p} = {i}" for p, i in
                                     zip(ins.phis, ins.init))
                    lines.append(f"{pad}loop ({phis}) {{")
                    lines.append(f"{pad} cond:")
                    emit(ins.cond, indent + 1)
                    lines.append(f"{pad}  -> {ins.cond_value}")
                    lines.append(f"{pad} body:")
                    emit(ins.body, indent + 1)
                    ys = ", ".join(str(y) for y in ins.yields)
                    lines.append(f"{pad}  yield {ys}")
                    rs = ", ".join(str(r) for r in ins.results)
                    lines.append(f"{pad}}} -> {rs}")
                elif isinstance(ins, IfOp):
                    lines.append(f"{pad}if {ins.cond_value} {{")
                    emit(ins.then, indent + 1)
                    lines.append(f"{pad}}} else {{")
                    emit(ins.els, indent + 1)
                    rs = ", ".join(str(r) for r in ins.results)
                    lines.append(f"{pad}}} -> {rs}")
                else:
                    res = f"{ins.result} = " if ins.result else ""
                    args = ", ".join(str(a) for a in ins.args)
                    at = ""
                    if ins.attrs:
                        at = " {" + ", ".join(
                            f"{k}={v}" for k, v in sorted(ins.attrs.items())
                            if not k.startswith("_")) + "}"
                    lines.append(f"{pad}{res}{ins.op}({args}){at}")

        emit(self.body, 1)
        return "\n".join(lines)
