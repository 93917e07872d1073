"""A minimal RVV instruction interpreter for emitted programs.

Executes the program tree produced by :mod:`repro_torch.rvv.codegen` on NumPy
state, modelling the architectural pieces a NumPy reference can't see:

* **CSR state** — ``vl``/``vtype`` are set by ``vsetvli`` and *used* by
  every vector instruction at execution time (not the vl the emitter
  thought was in scope), so vsetvli-placement bugs change results and
  get caught by the differential harness.  SEW-only switches inside a
  strip (widening chains) charge the compiler-inserted ``vsetvli`` they
  imply as ``implicit_vsetvli``.
* **tail policy** — tail-agnostic writes fill every lane past ``vl``
  with an adversarial all-ones bit pattern (NaN for floats), so any
  consumer that reads past ``vl`` diverges loudly; tail-undisturbed
  (``_tu``) writes keep the merge operand's lanes.
* **fixed-point rounding** — ``vxrm`` is a CSR: ``vnclip``/``vnclipu``
  round with the spec's roundoff_signed/unsigned before saturating, and
  each mode change retires one scalar CSR write.
* **retired-instruction counts** — every vector instruction retires
  exactly once regardless of LMUL; ``vuops`` additionally sums the
  EMUL-sized register-group passes, and per-site counts attribute
  retirements back to the originating NEON intrinsic for the
  ``executed`` column in :func:`repro_torch.port.report`.

Scalar statements reuse :mod:`repro_torch.port.interp`'s C-semantics helpers
(`_sbin`/`_scmp`/`_scast`) so address arithmetic is bit-identical to
the reference interpreter.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from ..port import faultinject as _fi
from ..port.interp import _sbin, _scast, _scmp
from ..port.ir import PtrType
from ..port.resilience import SimError
from .codegen import (If, PreDecl, RvvProgram, SBin, SConst, SCopy, SLoad,
                      SPtrAdd, SSel, SStore, SUn, V, VSetVL, While, _sew)

__all__ = ["SimError", "RvvSim", "run"]


_VXRM = {"rnu": 0, "rne": 1, "rdn": 2, "rod": 3}


def _roundoff(v: np.ndarray, d: int, mode: str) -> np.ndarray:
    """The spec's roundoff_{signed,unsigned}(v, d): ``(v >> d) + r``
    with the rounding increment r per vxrm (int64/uint64 working
    precision, d >= 0)."""
    if d == 0:
        return v
    shifted = v >> d
    lsb = (v >> (d - 1)) & 1                      # v[d-1]
    low = v & ((1 << (d - 1)) - 1)                # v[d-2:0] (0 if d==1)
    if mode == "rnu":
        r = lsb
    elif mode == "rne":
        r = lsb & (((low != 0) | ((shifted & 1) != 0))
                   .astype(v.dtype))
    elif mode == "rdn":
        r = 0
    elif mode == "rod":
        r = (~shifted & 1) & ((v & ((1 << d) - 1)) != 0) \
            .astype(v.dtype)
    else:
        raise SimError(f"bad vxrm mode {mode!r}")
    return shifted + r


def _garbage(n: int, dtype: str) -> np.ndarray:
    """Adversarial tail-agnostic fill: all-ones bits (NaN floats)."""
    dt = np.dtype(dtype)
    raw = np.full(n * dt.itemsize, 0xFF, dtype=np.uint8)
    return raw.view(dt).copy()


def _np_scalar(value, ctype: str):
    if ctype in ("float", "double"):
        return float(value)
    if ctype == "bool":
        return bool(value)
    return int(value)


class RvvSim:
    """Execute one emitted :class:`RvvProgram` on NumPy state."""

    def __init__(self, program: RvvProgram):
        self.prog = program
        self.vlen = program.target.vlen
        # CSR state
        self.vl = 0
        self.sew = 0
        self.vxrm = "rnu"
        self.vtype_valid = False
        # counters
        self.n_vector = 0
        self.n_vsetvli = 0
        self.n_implicit_vsetvli = 0
        self.n_scalar = 0
        self.n_vuops = 0
        self.per_site: Dict[str, int] = {}
        # machine state
        self.env: Dict[str, Any] = {}
        self.memory: Dict[str, np.ndarray] = {}

    # -- public API --------------------------------------------------------
    def run(self, *args):
        params = self.prog.params
        if len(args) != len(params):
            raise SimError(f"{self.prog.fn_name} takes {len(params)} "
                           f"arguments, got {len(args)}",
                           kernel=self.prog.fn_name)
        for (name, ty), a in zip(params, args):
            if isinstance(ty, PtrType):
                buf = np.asarray(a, dtype=ty.elem).copy()
                self.memory[name] = buf
                self.env[name] = (name, 0)
            else:
                self.env[name] = _np_scalar(
                    a, "float" if ty.dtype.startswith("float")
                    else "int")
        self._block(self.prog.body)
        outs = [self.memory[name] for name, ty in params
                if isinstance(ty, PtrType) and
                name in self.prog.writes]
        if len(outs) == 1:
            return outs[0]
        return tuple(outs)

    def counts(self) -> Dict[str, Any]:
        executed = (self.n_vector + self.n_vsetvli +
                    self.n_implicit_vsetvli)
        return {"executed": executed,
                "vector": self.n_vector,
                "vsetvli": self.n_vsetvli,
                "implicit_vsetvli": self.n_implicit_vsetvli,
                "scalar": self.n_scalar,
                "vuops": self.n_vuops,
                "per_site": dict(self.per_site)}

    # -- execution ---------------------------------------------------------
    def _block(self, stmts: List[Any]):
        for st in stmts:
            self._stmt(st)

    def _stmt(self, st):  # noqa: C901
        if isinstance(st, SConst):
            self.env[st.dst] = _np_scalar(st.value, st.ctype)
        elif isinstance(st, SBin):
            a, b = self.env[st.a], self.env[st.b]
            if st.op in ("==", "!=", "<", ">", "<=", ">="):
                self.env[st.dst] = _scmp(st.op, a, b)
            else:
                self.env[st.dst] = _sbin(st.op, a, b)
            self.n_scalar += 1
        elif isinstance(st, SUn):
            a = self.env[st.a]
            if st.op == "neg":
                self.env[st.dst] = -a
            elif st.op == "not":
                self.env[st.dst] = not a
            elif st.op == "inv":
                self.env[st.dst] = ~int(a)
            elif st.op == "cast":
                self.env[st.dst] = _scast(a, st.dtype)
            else:
                raise SimError(f"bad unary op {st.op!r}")
        elif isinstance(st, SSel):
            self.env[st.dst] = (self.env[st.a] if self.env[st.c]
                                else self.env[st.b])
        elif isinstance(st, SLoad):
            buf, off = self.env[st.ptr]
            mem = self.memory[buf]
            if not (0 <= off < len(mem)):
                raise SimError(f"scalar load out of bounds: "
                               f"{buf}[{off}]")
            v = mem[off]
            self.env[st.dst] = (float(v) if mem.dtype.kind == "f"
                                else int(v))
            self.n_scalar += 1
        elif isinstance(st, SStore):
            buf, off = self.env[st.ptr]
            mem = self.memory[buf]
            if not (0 <= off < len(mem)):
                raise SimError(f"scalar store out of bounds: "
                               f"{buf}[{off}]")
            mem[off] = np.asarray(self.env[st.val]).astype(mem.dtype)
            self.n_scalar += 1
        elif isinstance(st, SPtrAdd):
            buf, off = self.env[st.base]
            self.env[st.dst] = (buf, off + int(self.env[st.delta]))
        elif isinstance(st, SCopy):
            v = self.env[st.src]
            self.env[st.dst] = v.copy() if isinstance(v, np.ndarray) \
                else v
        elif isinstance(st, PreDecl):
            pass
        elif isinstance(st, While):
            while True:
                self._block(st.cond_stmts)
                if not self.env[st.cond]:
                    break
                self._block(st.body)
        elif isinstance(st, If):
            if self.env[st.cond]:
                self._block(st.then)
            else:
                self._block(st.els)
        elif isinstance(st, VSetVL):
            avl = st.avl if isinstance(st.avl, int) \
                else int(self.env[st.avl])
            vlmax = st.lmul * self.vlen // st.sew
            self.vl = min(avl, vlmax)
            self.sew = st.sew
            self.vtype_valid = True
            self.env[st.dst] = self.vl
            self.n_vsetvli += 1
        elif isinstance(st, V):
            # tail-agnostic garbage lanes (NaN/all-ones) legitimately
            # flow through arithmetic past vl — silence numpy's noise
            try:
                with np.errstate(all="ignore"):
                    self._vinstr(st)
            except SimError as e:
                raise e.add_context(mnemonic=st.mnem,
                                    site=st.site or None,
                                    kernel=self.prog.fn_name,
                                    target=self.prog.target.name)
        else:
            raise SimError(f"unknown statement {st!r}")

    # -- vector registers --------------------------------------------------
    def _vread(self, name: str, dtype: str, n: int) -> np.ndarray:
        arr = self.env.get(name)
        if arr is None:
            raise SimError(f"read of undefined vreg {name!r}")
        if not isinstance(arr, np.ndarray):
            raise SimError(f"{name!r} is not a vector register")
        if arr.dtype != np.dtype(dtype):
            # register-file reinterpret: same bits, new element view
            arr = arr.view(np.dtype(dtype))
        if len(arr) < n:
            arr = np.concatenate([arr, _garbage(n - len(arr), dtype)])
        return arr[:n]

    def _vwrite(self, st: V, name: str, data: np.ndarray,
                dtype: str):
        vlmax = st.emul * self.vlen // _sew(dtype)
        out = _garbage(vlmax, dtype)
        if st.policy == "tu":
            merge = st.merge
            if isinstance(merge, tuple):
                # handled by the caller for segment loads
                raise SimError("tuple merge reached _vwrite")
            if merge is not None:
                out = self._vread(merge, dtype, vlmax).copy()
        out[:len(data)] = data
        self.env[name] = out

    # -- vector execution --------------------------------------------------
    def _vinstr(self, st: V):  # noqa: C901
        if st.free:
            # register-file renames retire nothing
            if st.mnem == "vreinterpret":
                src = self.env[st.srcs[0][1]]
                self.env[st.dst] = src.view(np.dtype(st.dtype)).copy()
                return
            raise SimError(f"unknown free op {st.mnem!r}")

        if not self.vtype_valid:
            raise SimError(f"{st.mnem}: vector instruction before any "
                           f"vsetvli")
        # the compiler-inserted vsetvli implied by a SEW switch at
        # constant vl (widening chains); vl itself never changes here
        if st.sew != self.sew:
            self.sew = st.sew
            self.n_implicit_vsetvli += 1
        # the scalar-move ops touch only element 0 and are legal under
        # any vtype, so they skip the register-group length check
        lmul_agnostic = st.mnem in ("vmv.s.x", "vfmv.s.f", "vmv.x.s",
                                    "vfmv.f.s")
        if not lmul_agnostic and \
                self.vl * _sew(st.dtype) > st.emul * self.vlen:
            raise SimError(
                f"{st.mnem}: vl={self.vl} exceeds VLMAX for "
                f"e{_sew(st.dtype)}m{st.emul} at VLEN={self.vlen} "
                f"(codegen vsetvli placement bug)")
        if st.vxrm is not None and st.vxrm != self.vxrm:
            self.vxrm = st.vxrm
            self.n_scalar += 1          # csrwi vxrm
        vl = self.vl
        self.n_vector += 1
        self.n_vuops += st.emul
        if st.site:
            self.per_site[st.site] = self.per_site.get(st.site, 0) + 1

        m = st.mnem
        dt = np.dtype(st.dtype)
        sdt = np.dtype(st.dtype_src) if st.dtype_src else dt

        def vin(i, dtype=None, n=vl):
            kind, name = st.srcs[i]
            return self._vread(name, dtype or st.dtype, n)

        def x(i):
            return self.env[st.srcs[i][1]]

        # ---- memory ------------------------------------------------------
        if m in ("vle", "vse", "vlseg", "vsseg"):
            kind, pname = st.srcs[0]
            buf, off = self.env[pname]
            mem = self.memory[buf]
            seg = st.seg or 1
            need = seg * vl
            _fi.fault_point("sim.mem", mnemonic=m, site=st.site,
                            kernel=self.prog.fn_name)
            # vl == 0 performs no accesses and cannot fault (the
            # predicated tail parks fully-inactive offset sites past
            # the buffer end on purpose)
            if need and (off < 0 or off + need > len(mem)):
                raise SimError(f"{m}: access [{off}, {off + need}) "
                               f"outside {buf}[{len(mem)}]")
            if m == "vle":
                data = mem[off:off + vl].astype(dt, copy=True)
                self._vwrite(st, st.dst, data, st.dtype)
            elif m == "vse":
                v = self._vread(st.srcs[1][1], st.dtype, vl)
                mem[off:off + vl] = v
            elif m == "vlseg":
                data = mem[off:off + need]
                merges = (st.merge if st.policy == "tu"
                          else (None,) * seg)
                for i, nm in enumerate(st.dst):
                    lane = data[i::seg].astype(dt, copy=True)
                    sub = V(**{**dataclass_dict(st),
                               "policy": st.policy,
                               "merge": merges[i]})
                    self._vwrite(sub, nm, lane, st.dtype)
            else:  # vsseg
                names = st.srcs[1][1]
                for i, nm in enumerate(names):
                    mem[off + i:off + need:seg] = \
                        self._vread(nm, st.dtype, vl)
            return

        # ---- vsetvli-adjacent moves / broadcast --------------------------
        if m in ("vmv.v.x", "vfmv.v.f"):
            val = np.asarray(x(0)).astype(dt)
            self._vwrite(st, st.dst, np.full(vl, val, dtype=dt),
                         st.dtype)
            return
        if m == "vmv.v.v":
            self._vwrite(st, st.dst, vin(0).copy(), st.dtype)
            return
        if m in ("vmv.s.x", "vfmv.s.f"):
            out = _garbage(max(1, self.vlen // _sew(st.dtype)),
                           st.dtype)
            out[0] = np.asarray(x(0)).astype(dt)
            self.env[st.dst] = out
            return
        if m in ("vmv.x.s", "vfmv.f.s"):
            v = self._vread(st.srcs[0][1], st.dtype, 1)
            self.env[st.dst] = (float(v[0]) if dt.kind == "f"
                                else int(v[0]))
            return

        # ---- permutation -------------------------------------------------
        if m == "vid.v":
            self._vwrite(st, st.dst, np.arange(vl, dtype=dt),
                         st.dtype)
            return
        if m == "vrgather.vv":
            src = vin(0)
            idx = self._vread(st.srcs[1][1],
                              f"uint{_sew(st.dtype)}", vl)
            vlmax = st.emul * self.vlen // _sew(st.dtype)
            full = self._vread(st.srcs[0][1], st.dtype, vlmax)
            safe = np.where(idx < vlmax, idx, 0)
            out = np.where(idx < vlmax, full[safe],
                           np.zeros(1, dtype=dt))
            self._vwrite(st, st.dst, out.astype(dt), st.dtype)
            return
        if m == "vslidedown.vx":
            off = int(x(1)) if st.srcs[1][0] == "x" else \
                int(st.srcs[1][1])
            src = self._vread(st.srcs[0][1], st.dtype, vl + off)
            self._vwrite(st, st.dst, src[off:off + vl].copy(),
                         st.dtype)
            return
        if m == "vslideup.vx":
            off = int(st.srcs[2][1]) if st.srcs[2][0] == "i" else \
                int(x(2))
            dest = vin(0).copy()
            src = self._vread(st.srcs[1][1], st.dtype,
                              max(0, vl - off))
            dest[off:vl] = src[:vl - off]
            self._vwrite(st, st.dst, dest, st.dtype)
            return

        # ---- integer / float arithmetic ----------------------------------
        simple = {
            "vadd.vv": lambda a, b: a + b,
            "vsub.vv": lambda a, b: a - b,
            "vmul.vv": lambda a, b: a * b,
            "vand.vv": lambda a, b: a & b,
            "vor.vv": lambda a, b: a | b,
            "vxor.vv": lambda a, b: a ^ b,
            "vmax.vv": np.maximum, "vmaxu.vv": np.maximum,
            "vmin.vv": np.minimum, "vminu.vv": np.minimum,
            "vfadd.vv": lambda a, b: a + b,
            "vfsub.vv": lambda a, b: a - b,
            "vfmul.vv": lambda a, b: a * b,
            "vfmax.vv": np.maximum, "vfmin.vv": np.minimum,
        }
        if m in simple:
            self._vwrite(st, st.dst,
                         simple[m](vin(0), vin(1)).astype(dt),
                         st.dtype)
            return
        if m in ("vmax.vx", "vmin.vx"):
            fn = np.maximum if m == "vmax.vx" else np.minimum
            val = np.asarray(x(1)).astype(dt)
            self._vwrite(st, st.dst, fn(vin(0), val).astype(dt),
                         st.dtype)
            return
        if m in ("vand.vx", "vor.vx", "vxor.vx"):
            fn = {"vand.vx": np.bitwise_and, "vor.vx": np.bitwise_or,
                  "vxor.vx": np.bitwise_xor}[m]
            val = np.asarray(x(1)).astype(dt)
            self._vwrite(st, st.dst, fn(vin(0), val).astype(dt),
                         st.dtype)
            return
        if m in ("vsadd.vv", "vsaddu.vv", "vssub.vv", "vssubu.vv"):
            a = vin(0).astype(np.int64)
            b = vin(1).astype(np.int64)
            r = a + b if "add" in m else a - b
            info = np.iinfo(dt)
            self._vwrite(st, st.dst,
                         np.clip(r, info.min, info.max).astype(dt),
                         st.dtype)
            return
        if m in ("vmacc.vv", "vnmsac.vv"):
            acc, a, b = vin(0), vin(1), vin(2)
            r = acc + a * b if m == "vmacc.vv" else acc - a * b
            self._vwrite(st, st.dst, r.astype(dt), st.dtype)
            return
        if m in ("vfmacc.vv", "vfnmsac.vv"):
            acc = vin(0).astype(np.float64)
            a = vin(1).astype(np.float64)
            b = vin(2).astype(np.float64)
            r = acc + a * b if m == "vfmacc.vv" else acc - a * b
            self._vwrite(st, st.dst, r.astype(dt), st.dtype)
            return
        if m in ("vsll.vx", "vsll.vi", "vsrl.vx", "vsrl.vi",
                 "vsra.vx", "vsra.vi"):
            sh = int(st.srcs[1][1]) if st.srcs[1][0] == "i" \
                else int(x(1))
            v = vin(0)
            if m.startswith("vsll"):
                r = v << np.asarray(sh).astype(dt)
            else:
                # dtype signedness picks logical vs arithmetic
                r = v >> np.asarray(sh).astype(dt)
            self._vwrite(st, st.dst, r.astype(dt), st.dtype)
            return

        # ---- float special forms -----------------------------------------
        if m == "vfsqrt.v":
            self._vwrite(st, st.dst, np.sqrt(vin(0)).astype(dt),
                         st.dtype)
            return
        if m == "vfrdiv.vf":
            f = np.asarray(x(1)).astype(dt)
            self._vwrite(st, st.dst, (f / vin(0)).astype(dt),
                         st.dtype)
            return
        if m == "vfrsub.vf":
            f = np.asarray(x(1)).astype(dt)
            self._vwrite(st, st.dst, (f - vin(0)).astype(dt),
                         st.dtype)
            return
        if m == "vfmul.vf":
            f = np.asarray(x(1)).astype(dt)
            self._vwrite(st, st.dst, (vin(0) * f).astype(dt),
                         st.dtype)
            return

        # ---- compares and merges -----------------------------------------
        cmp_vv = {"vmseq.vv": np.equal, "vmsne.vv": np.not_equal,
                  "vmslt.vv": np.less, "vmsltu.vv": np.less,
                  "vmsle.vv": np.less_equal, "vmsleu.vv": np.less_equal,
                  "vmfeq.vv": np.equal, "vmflt.vv": np.less,
                  "vmfle.vv": np.less_equal}
        if m in cmp_vv:
            mask = cmp_vv[m](vin(0), vin(1))
            self.env[st.dst] = np.asarray(mask, dtype=bool)
            return
        if m == "vmsne.vx":
            val = np.asarray(x(1)).astype(dt)
            self.env[st.dst] = np.asarray(vin(0) != val, dtype=bool)
            return
        if m == "vmerge.vxm":
            mask = self._mask(st.srcs[2][1], vl)
            val = np.asarray(x(1)).astype(dt)
            self._vwrite(st, st.dst,
                         np.where(mask, val, vin(0)).astype(dt),
                         st.dtype)
            return
        if m == "vmerge.vvm":
            mask = self._mask(st.srcs[2][1], vl)
            self._vwrite(st, st.dst,
                         np.where(mask, vin(1), vin(0)).astype(dt),
                         st.dtype)
            return

        # ---- width changers ----------------------------------------------
        if m in ("vsext.vf2", "vzext.vf2"):
            src = self._vread(st.srcs[0][1], st.dtype_src, vl)
            self._vwrite(st, st.dst, src.astype(dt), st.dtype)
            return
        if m in ("vnsrl.wi", "vnsrl.wx", "vnsra.wi", "vnsra.wx"):
            sh = int(st.srcs[1][1]) if st.srcs[1][0] == "i" \
                else int(x(1))
            src = self._vread(st.srcs[0][1], st.dtype_src, vl)
            self._vwrite(st, st.dst, (src >> np.asarray(sh).astype(
                sdt)).astype(dt), st.dtype)
            return
        if m in ("vnclip.wi", "vnclip.wx", "vnclipu.wi",
                 "vnclipu.wx"):
            sh = int(st.srcs[1][1]) if st.srcs[1][0] == "i" \
                else int(x(1))
            src = self._vread(st.srcs[0][1], st.dtype_src, vl)
            wide = src.astype(np.uint64 if "u.w" in m else np.int64)
            r = _roundoff(wide, sh, self.vxrm)
            info = np.iinfo(dt)
            self._vwrite(st, st.dst,
                         np.clip(r, info.min, info.max).astype(dt),
                         st.dtype)
            return
        if m in ("vwmul.vv", "vwmulu.vv", "vwadd.vv", "vwaddu.vv",
                 "vwsub.vv", "vwsubu.vv"):
            a = self._vread(st.srcs[0][1], st.dtype_src, vl).astype(dt)
            b = self._vread(st.srcs[1][1], st.dtype_src, vl).astype(dt)
            if "mul" in m:
                r = a * b
            elif "add" in m:
                r = a + b
            else:
                r = a - b
            self._vwrite(st, st.dst, r.astype(dt), st.dtype)
            return
        if m in ("vwmacc.vv", "vwmaccu.vv"):
            acc = self._vread(st.srcs[0][1], st.dtype, vl)
            a = self._vread(st.srcs[1][1], st.dtype_src, vl).astype(dt)
            b = self._vread(st.srcs[2][1], st.dtype_src, vl).astype(dt)
            self._vwrite(st, st.dst, (acc + a * b).astype(dt),
                         st.dtype)
            return
        if m.startswith("vfcvt."):
            src = self._vread(st.srcs[0][1], st.dtype_src, vl)
            if "rtz" in m:
                r = np.trunc(src.astype(np.float64)).astype(dt)
            else:
                r = src.astype(dt)
            self._vwrite(st, st.dst, r, st.dtype)
            return

        # ---- reductions ---------------------------------------------------
        if m in ("vredsum.vs", "vredmax.vs", "vredmaxu.vs",
                 "vredmin.vs", "vredminu.vs"):
            v = vin(0)
            scr = self._vread(st.srcs[1][1], st.dtype, 1)
            if m == "vredsum.vs":
                acc = int(scr[0]) + int(np.sum(v.astype(np.int64)))
                res = np.asarray(acc).astype(dt)
            elif m in ("vredmax.vs", "vredmaxu.vs"):
                res = max(scr[0], v.max()) if vl else scr[0]
            else:
                res = min(scr[0], v.min()) if vl else scr[0]
            out = _garbage(max(1, self.vlen // _sew(st.dtype)),
                           st.dtype)
            out[0] = res
            self.env[st.dst] = out
            return
        if m in ("vfredosum.vs", "vfredmax.vs", "vfredmin.vs"):
            v = vin(0)
            scr = self._vread(st.srcs[1][1], st.dtype, 1)
            if m == "vfredosum.vs":
                acc = dt.type(scr[0])
                for e in v:                 # ordered sum: strict fp32
                    acc = dt.type(acc + e)
                res = acc
            elif m == "vfredmax.vs":
                res = max(scr[0], v.max()) if vl else scr[0]
            else:
                res = min(scr[0], v.min()) if vl else scr[0]
            out = _garbage(max(1, self.vlen // _sew(st.dtype)),
                           st.dtype)
            out[0] = res
            self.env[st.dst] = out
            return

        raise SimError(f"unimplemented RVV instruction {m!r} "
                       f"(not in the DESIGN.md §12 table?)")

    def _mask(self, name: str, vl: int) -> np.ndarray:
        arr = self.env.get(name)
        if not isinstance(arr, np.ndarray) or arr.dtype != np.bool_:
            raise SimError(f"{name!r} is not a mask register")
        if len(arr) < vl:
            arr = np.concatenate(
                [arr, np.zeros(vl - len(arr), dtype=bool)])
        return arr[:vl]


def dataclass_dict(st: V) -> Dict[str, Any]:
    import dataclasses as _dc
    return {f.name: getattr(st, f.name) for f in _dc.fields(st)}


def run(program: RvvProgram, *args,
        with_counts: bool = False):
    """Execute ``program`` on fresh state.  Returns the written
    buffer(s) exactly like ``Machine.run`` (bare array for a single
    written buffer, tuple otherwise); with ``with_counts=True`` returns
    ``(outputs, counts)``."""
    sim = RvvSim(program)
    out = sim.run(*args)
    if with_counts:
        return out, sim.counts()
    return out
