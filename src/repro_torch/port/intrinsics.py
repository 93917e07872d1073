"""The NEON intrinsic surface the port frontend understands.

``resolve(name)`` decodes a NEON intrinsic name (``vaddq_f32``,
``vld1q_dup_u8``, ``vget_high_f32``, ...) into an :class:`IntrinSpec`:
the logical-ISA op it translates to (:mod:`repro_torch.core.isa`), the typed
signature in Table-2 register types, and the fixed-width logical
register the ``vlen >= width`` substitution rule must check.  This is
the migration frontend's analogue of SIMDe's per-intrinsic conversion
entries — except the *implementation* is not chosen here: translation
emits a logical-ISA call and the cost-driven selector
(:mod:`repro_torch.core.registry`) picks the lowering per target.

The name grammar handled::

    v<base>[q]_<elem>             vaddq_f32, vqaddq_s8, vceq_u8 ...
    v<base>[q]_n_<elem>           vdupq_n_f32, vshrq_n_s32 ...
    vreinterpret[q]_<to>_<from>   register bit reinterpretation
    vld1[q]_<elem>                unit-stride load
    vld1[q]_dup_<elem>            load-one + broadcast
    vst1[q]_<elem>                unit-stride store
    vget_{high,low}_<elem>        Q -> D halves (paper Listing 5)
    vcombine_<elem>               D + D -> Q
    vext[q]_<elem>                register-pair extract
    v{addv,maxv,minv}[q]_<elem>   horizontal reductions
    vcvt[q]_<to>_<from>           lane-wise conversion
    vget[q]_lane_<elem>           lane extract to scalar
    v{mull,addl,subl}_<elem>      widening D x D -> Q arithmetic
    v{mlal,mlsl}_<elem>           widening multiply-accumulate into Q
    vmovl_<elem>                  widening move D -> Q
    v{movn,qmovn,qmovun}_<elem>   narrowing move Q -> D (q* saturate)
    vld2[q]_<elem>                de-interleaving 2-register struct load
    vst2[q]_<elem>                interleaving 2-register struct store
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional, Tuple

import numpy as np

from .ir import IRType, PtrType, ScalarType, VecTupleType, VecType
from .resilience import PortError

__all__ = ["IntrinSpec", "resolve", "UnknownIntrinsic"]


class UnknownIntrinsic(PortError, KeyError):
    """Intrinsic name outside the supported NEON surface."""
    default_stage = "lower"


@dataclasses.dataclass(frozen=True)
class IntrinSpec:
    name: str                       # source spelling
    isa_op: str                     # core.isa op it lowers to
    kind: str                       # executor strategy (see interp.py)
    arg_types: Tuple[object, ...]   # IRType | 'imm' per C argument
    result_type: Optional[IRType]   # None for stores
    width_bits: int                 # Table-2 logical register width


_ELEM = {"f16": "float16", "f32": "float32", "f64": "float64",
         "s8": "int8", "s16": "int16", "s32": "int32", "s64": "int64",
         "u8": "uint8", "u16": "uint16", "u32": "uint32", "u64": "uint64"}

# base -> isa op, for same-shape lane-wise families
_UNARY = {"abs": "vabs", "neg": "vneg", "recpe": "vrecpe",
          "rsqrte": "vrsqrte", "rev64": "vrev64", "rbit": "vrbit"}
_BINARY = {"add": "vadd", "sub": "vsub", "mul": "vmul", "max": "vmax",
           "min": "vmin", "and": "vand", "orr": "vorr", "eor": "veor",
           "recps": "vrecps", "rsqrts": "vrsqrts", "padd": "vpadd",
           "qadd": "vqadd", "qsub": "vqsub"}
_TERNARY = {"mla": "vmla", "mls": "vmls", "fma": "vfma"}
_CMP = {"ceq": "vceq", "cgt": "vcgt", "cge": "vcge",
        "clt": "vclt", "cle": "vcle"}
_REDUCE = {"addv": "vaddv", "maxv": "vmaxv", "minv": "vminv"}


def _ebits(dtype: str) -> int:
    return np.dtype(dtype).itemsize * 8


def _vt(dtype: str, q: bool) -> VecType:
    lanes = (128 if q else 64) // _ebits(dtype)
    return VecType(f"{dtype}x{lanes}_t")


def _double(dtype: str) -> str:
    """Element type at 2x the width ('int8' -> 'int16')."""
    return dtype.rstrip("0123456789") + str(2 * _ebits(dtype))


def _half(dtype: str) -> str:
    """Element type at half the width ('int16' -> 'int8')."""
    return dtype.rstrip("0123456789") + str(_ebits(dtype) // 2)


def resolve(name: str) -> IntrinSpec:
    spec = _resolve(name)
    if spec is None:
        raise UnknownIntrinsic(name)
    return spec


def _resolve(name: str) -> Optional[IntrinSpec]:  # noqa: C901
    if not name.startswith("v"):
        return None

    # vget_high_f32 / vget_low_f32 — Q register halves (Listing 5)
    m = re.match(r"^vget_(high|low)_([a-z0-9]+)$", name)
    if m and m.group(2) in _ELEM:
        dt = _ELEM[m.group(2)]
        q, d = _vt(dt, True), _vt(dt, False)
        return IntrinSpec(name, f"vget_{m.group(1)}", "vv", (q,), d, q.bits)

    # vcombine_f32 — D + D -> Q
    m = re.match(r"^vcombine_([a-z0-9]+)$", name)
    if m and m.group(1) in _ELEM:
        dt = _ELEM[m.group(1)]
        q, d = _vt(dt, True), _vt(dt, False)
        return IntrinSpec(name, "vcombine", "vv", (d, d), q, q.bits)

    # vget[q]_lane — lane extract to scalar (executor-native move)
    m = re.match(r"^vget(q?)_lane_([a-z0-9]+)$", name)
    if m and m.group(2) in _ELEM:
        dt = _ELEM[m.group(2)]
        v = _vt(dt, m.group(1) == "q")
        return IntrinSpec(name, "", "get_lane", (v, "imm"),
                          ScalarType(dt), v.bits)

    # vld1[q][_dup]
    m = re.match(r"^vld1(q?)(_dup)?_([a-z0-9]+)$", name)
    if m and m.group(3) in _ELEM:
        dt = _ELEM[m.group(3)]
        v = _vt(dt, m.group(1) == "q")
        kind = "load_dup" if m.group(2) else "load"
        return IntrinSpec(name, "vld1" if kind == "load" else "vdup",
                          kind, (PtrType(dt),), v, v.bits)

    # vst1[q]
    m = re.match(r"^vst1(q?)_([a-z0-9]+)$", name)
    if m and m.group(2) in _ELEM:
        dt = _ELEM[m.group(2)]
        v = _vt(dt, m.group(1) == "q")
        return IntrinSpec(name, "vst1", "store", (PtrType(dt), v),
                          None, v.bits)

    # vdup[q]_n / vmov[q]_n — scalar broadcast
    m = re.match(r"^v(?:dup|mov)(q?)_n_([a-z0-9]+)$", name)
    if m and m.group(2) in _ELEM:
        dt = _ELEM[m.group(2)]
        v = _vt(dt, m.group(1) == "q")
        return IntrinSpec(name, "vdup", "dup", (ScalarType(dt),), v, v.bits)

    # immediate shifts: vshl[q]_n / vshr[q]_n
    m = re.match(r"^v(shl|shr)(q?)_n_([a-z0-9]+)$", name)
    if m and m.group(3) in _ELEM:
        dt = _ELEM[m.group(3)]
        v = _vt(dt, m.group(2) == "q")
        return IntrinSpec(name, f"v{m.group(1)}_n", "shift", (v, "imm"),
                          v, v.bits)

    # vext[q]
    m = re.match(r"^vext(q?)_([a-z0-9]+)$", name)
    if m and m.group(2) in _ELEM:
        dt = _ELEM[m.group(2)]
        v = _vt(dt, m.group(1) == "q")
        return IntrinSpec(name, "vext", "ext", (v, v, "imm"), v, v.bits)

    # vreinterpret[q]_<to>_<from> — register bit reinterpretation: same
    # total bits, lanes re-divided by the destination element width
    m = re.match(r"^vreinterpret(q?)_([a-z0-9]+)_([a-z0-9]+)$", name)
    if m and m.group(2) in _ELEM and m.group(3) in _ELEM:
        to, frm = _ELEM[m.group(2)], _ELEM[m.group(3)]
        q = m.group(1) == "q"
        vin = _vt(frm, q)
        bits = 128 if q else 64
        vout = VecType(f"{to}x{bits // _ebits(to)}_t")
        return IntrinSpec(name, "vreinterpret", "reinterpret", (vin,),
                          vout, bits)

    # conversions: vcvt[q]_<to>_<from>
    m = re.match(r"^vcvt(q?)_([a-z0-9]+)_([a-z0-9]+)$", name)
    if m and m.group(2) in _ELEM and m.group(3) in _ELEM:
        to, frm = _ELEM[m.group(2)], _ELEM[m.group(3)]
        q = m.group(1) == "q"
        vin, vout = _vt(frm, q), _vt(to, q)
        if vin.lanes != vout.lanes:
            return None          # narrowing/widening cvt not in subset
        return IntrinSpec(name, "vcvt", "cvt", (vin,), vout, vout.bits)

    # horizontal reductions
    m = re.match(r"^v(addv|maxv|minv)(q?)_([a-z0-9]+)$", name)
    if m and m.group(3) in _ELEM:
        dt = _ELEM[m.group(3)]
        v = _vt(dt, m.group(2) == "q")
        return IntrinSpec(name, _REDUCE[m.group(1)], "reduce", (v,),
                          ScalarType(dt), v.bits)

    # widening arithmetic: v{mull,addl,subl}_<elem> — D x D -> Q at 2x
    # element width (Table 2's customized RVV conversions: vwmul/vwadd/
    # vwsub write a double-width register group in one instruction)
    m = re.match(r"^v(mull|addl|subl)_([a-z0-9]+)$", name)
    if m and m.group(2) in _ELEM and not m.group(2).startswith("f") \
            and _ebits(_ELEM[m.group(2)]) <= 32:
        dt = _ELEM[m.group(2)]
        d, q = _vt(dt, False), _vt(_double(dt), True)
        return IntrinSpec(name, f"v{m.group(1)}", "vv_cvt", (d, d), q,
                          q.bits)

    # widening multiply-accumulate: v{mlal,mlsl}_<elem> — Q acc +/-
    # D x D products at 2x element width (RVV vwmacc.vv: one widening
    # mul-acc writing the double-width accumulator group)
    m = re.match(r"^v(mlal|mlsl)_([a-z0-9]+)$", name)
    if m and m.group(2) in _ELEM and not m.group(2).startswith("f") \
            and _ebits(_ELEM[m.group(2)]) <= 32:
        dt = _ELEM[m.group(2)]
        d, q = _vt(dt, False), _vt(_double(dt), True)
        return IntrinSpec(name, f"v{m.group(1)}", "vv_cvt", (q, d, d), q,
                          q.bits)

    # vmovl_<elem> — widening move D -> Q (vsext/vzext)
    m = re.match(r"^vmovl_([a-z0-9]+)$", name)
    if m and m.group(1) in _ELEM and not m.group(1).startswith("f") \
            and _ebits(_ELEM[m.group(1)]) <= 32:
        dt = _ELEM[m.group(1)]
        d, q = _vt(dt, False), _vt(_double(dt), True)
        return IntrinSpec(name, "vmovl", "cvt", (d,), q, q.bits)

    # narrowing moves: v{movn,qmovn,qmovun}_<elem> — Q -> D at half the
    # element width (vncvt; the q-forms saturate like RVV vnclip[u]).
    # The suffix names the *source* type, NEON-style.
    m = re.match(r"^v(movn|qmovn|qmovun)_([a-z0-9]+)$", name)
    if m and m.group(2) in _ELEM and not m.group(2).startswith("f") \
            and _ebits(_ELEM[m.group(2)]) >= 16:
        dt = _ELEM[m.group(2)]
        if m.group(1) == "qmovun":
            if dt.startswith("u"):
                return None          # vqmovun narrows *signed* sources
            out = "u" + _half(dt)
        else:
            out = _half(dt)
        q, d = _vt(dt, True), _vt(out, False)
        return IntrinSpec(name, f"v{m.group(1)}", "cvt", (q,), d, q.bits)

    # vld2/vld3/vld4[q] — de-interleaving struct load (RVV
    # vlseg<n>e<eew>).  The Table-2 width is *per register*: the struct
    # occupies n registers, each of which must map (vld2q is native on
    # rvv-128).  The kind stays "load2" for every arity ("segment
    # load"); the member count travels in the tuple type and the isa_op.
    m = re.match(r"^vld([234])(q?)_([a-z0-9]+)$", name)
    if m and m.group(3) in _ELEM:
        n = int(m.group(1))
        dt = _ELEM[m.group(3)]
        v = _vt(dt, m.group(2) == "q")
        t = VecTupleType((v,) * n)
        return IntrinSpec(name, f"vld{n}", "load2", (PtrType(dt),), t,
                          v.bits)

    # vst2/vst3/vst4[q] — interleaving struct store (RVV vsseg<n>e<eew>)
    m = re.match(r"^vst([234])(q?)_([a-z0-9]+)$", name)
    if m and m.group(3) in _ELEM:
        n = int(m.group(1))
        dt = _ELEM[m.group(3)]
        v = _vt(dt, m.group(2) == "q")
        t = VecTupleType((v,) * n)
        return IntrinSpec(name, f"vst{n}", "store2", (PtrType(dt), t),
                          None, v.bits)

    # vbsl[q] — mask select: (umask, a, b)
    m = re.match(r"^vbsl(q?)_([a-z0-9]+)$", name)
    if m and m.group(2) in _ELEM:
        dt = _ELEM[m.group(2)]
        q = m.group(1) == "q"
        v = _vt(dt, q)
        mask = _vt(f"uint{_ebits(dt)}", q)
        return IntrinSpec(name, "vbsl", "vv", (mask, v, v), v, v.bits)

    # lane-wise families: v<base>[q]_<elem> (lazy base so the optional
    # q register marker is not swallowed by the base name)
    m = re.match(r"^v([a-z]+?)(q?)_([a-z0-9]+)$", name)
    if m and m.group(3) in _ELEM:
        base, q, dt = m.group(1), m.group(2) == "q", _ELEM[m.group(3)]
        v = _vt(dt, q)
        if base in _UNARY:
            return IntrinSpec(name, _UNARY[base], "vv", (v,), v, v.bits)
        if base in _BINARY:
            return IntrinSpec(name, _BINARY[base], "vv", (v, v), v, v.bits)
        if base in _TERNARY:
            return IntrinSpec(name, _TERNARY[base], "vv", (v, v, v),
                              v, v.bits)
        if base in _CMP:
            mask = _vt(f"uint{_ebits(dt)}", q)
            return IntrinSpec(name, _CMP[base], "vv", (v, v), mask, v.bits)
    return None
