"""Migration reports: the paper's §4 per-intrinsic analysis tables as an
artifact.

``report(kernel, *example_args)`` sweeps the RVV width family and, for
each target, abstract-interprets the kernel to get

* the Table-2 substitution verdict per intrinsic (does the fixed-width
  register map natively, ``vlen >= width``?),
* the tier the cost-driven selector picks for each intrinsic's
  logical-ISA op and its per-issue/total dynamic instruction cost,
* whole-kernel estimated dynamic vector instructions, against the
  original-SIMDe ladder baseline (the ``use_policy('vector')`` cap).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

from ..core import targets as _targets

__all__ = ["report", "format_report", "PORT_SWEEP"]

# the paper's evaluation family, plus rvv-64 where Table 2's 'x' entries
# (Q-register intrinsics that cannot map) actually bite
PORT_SWEEP = ("rvv-64", "rvv-128", "rvv-256", "rvv-512", "rvv-1024")


def report(kernel, *example_args,
           sweep: Sequence[str] = PORT_SWEEP,
           policy: str = "pallas",
           baseline_policy: Optional[str] = "vector",
           compiled: bool = False,
           executed: bool = False,
           resilience: bool = False,
           device=None) -> Dict:
    """Per-intrinsic migration report for ``kernel`` on ``example_args``.

    ``kernel`` is a :class:`repro_torch.port.PortedKernel`; the example
    args fix buffer shapes and trip counts (instruction counts are
    dynamic, like the paper's Spike methodology).  The estimate,
    ``compiled`` and ``executed`` columns read only their shapes, dtypes
    and scalar values: the kernel runs abstractly or on the NumPy
    simulator, on no device.

    ``compiled=True`` adds the JIT backend's re-vectorization column:
    each target row gains ``revec`` — the strip loops re-tiled at that
    target's VLEN x LMUL (repro_torch.port.revec) and
    abstract-interpreted for the re-tiled dynamic instruction count.
    This is where the sweep finally *diverges* across the RVV family: the
    fixed-width port costs the same from rvv-128 to rvv-1024, the
    re-tiled one shrinks with the register.

    ``resilience=True`` adds the degradation-ladder column: each target
    row gains ``resilience`` — the kernel is actually executed down the
    ladder (:func:`repro_torch.port.resilience.run_resilient`, eager
    mode, on ``device``: default the card) and the row records which
    rung served the result, whether it degraded, and the per-rung
    attempt trail; a fully-failed ladder
    records the typed error instead of raising.  The ladder contract
    is that rungs only trade speed, never values, so the report's
    numbers stay comparable whatever rung answered.

    ``executed=True`` adds the instruction-level fact-check: the kernel
    is run through real RVV codegen (:mod:`repro_torch.rvv`) and the
    emitted instruction stream executes on the in-repo simulator, so each
    target row gains ``executed`` — *retired* dynamic instructions
    (vector + vsetvli), the LMUL-weighted ``vuops``, and a
    per-intrinsic comparison against the cost model's re-tiled
    estimate with divergences flagged.  Estimates charge LMUL micro-ops
    per grouped issue while the machine retires one instruction per
    mnemonic, so a flagged divergence is not an error — it is the gap
    the executed column exists to expose (e.g. ``vbsl`` estimates 3
    bitwise ops but retires a 2-instruction mask+merge).
    """
    fn = kernel.fn
    sites: Dict[str, Dict] = {}
    for ins in fn.intrinsic_sites():
        row = sites.setdefault(ins.attrs["intrinsic"], {
            "sites": 0, "isa_op": ins.attrs["isa_op"],
            "width_bits": ins.attrs["width_bits"]})
        row["sites"] += 1

    out = {
        "kernel": fn.name,
        "writes": list(fn.writes),
        "intrinsics": sites,
        "targets": {},
    }
    for tname in sweep:
        tgt = _targets.get_target(tname)
        est = kernel.estimate(*example_args, policy=policy, target=tgt)
        row = {
            "maps": {name: tgt.supports_width(meta["width_bits"])
                     for name, meta in sites.items()},
            "per_intrinsic": est["per_intrinsic"],
            "total_instrs": est["total_instrs"],
            "scalar_instrs": est["scalar_instrs"],
        }
        if baseline_policy is not None:
            base = kernel.estimate(*example_args, policy=baseline_policy,
                                   target=tgt)
            row["baseline_total_instrs"] = base["total_instrs"]
            row["speedup"] = round(
                base["total_instrs"] / max(1, est["total_instrs"]), 3)
        rv = None
        if compiled or executed:
            from .interp import Machine
            from .revec import retile
            res = retile(fn, tgt)
            rv = Machine(res.fn, policy=policy, target=tgt,
                         abstract=True).run(*example_args)
        if compiled:
            row["revec"] = {
                "factor": res.factor,
                "effective_vlen": tgt.effective_vlen,
                "retiled": res.retiled,
                "masked": res.masked,
                "strips": res.strips,
                "narrow_fallbacks": res.narrow_fallbacks,
                "vetoes": [{"site": v.get("site", ""),
                            "reason": v.get("reason", ""),
                            "line": v.get("line", 0)}
                           for v in res.vetoes],
                "total_instrs": rv["total_instrs"],
                "scalar_instrs": rv["scalar_instrs"],
                "speedup_vs_fixed": round(
                    est["total_instrs"] / max(1, rv["total_instrs"]), 3),
            }
        if resilience:
            from . import resilience as _resilience
            try:
                _, drec = _resilience.run_resilient(
                    kernel, *example_args, target=tgt, policy=policy,
                    jit=False, device=device)
                row["resilience"] = drec.to_dict()
            except _resilience.PortError as e:
                row["resilience"] = {
                    "kernel": fn.name, "target": tname,
                    "used": None, "degraded": False,
                    "error": str(e), "error_type": type(e).__name__,
                }
        if executed:
            from .. import rvv
            from ..core import trace as _trace
            prog = rvv.emit(kernel, tgt)
            _, counts = rvv.run(prog, *example_args, with_counts=True)
            per = {}
            calib = _trace.get_calibration()
            # join on the *union* of simulated sites and estimated
            # intrinsics: a vl=0 parked site still retires (the sim
            # counts per-site before dispatch, access-free)
            # and an estimate-only intrinsic shows executed=0 — neither
            # side of the join can silently drop a site and make the
            # kernel look cheaper than it retires.
            names = set(counts["per_site"]) | set(rv["per_intrinsic"])
            for name in sorted(names):
                retired = counts["per_site"].get(name, 0)
                est_row = rv["per_intrinsic"].get(name, {})
                estimate = est_row.get("instrs", 0)
                per[name] = {"executed": retired,
                             "revec_instrs": estimate,
                             "diverges": retired != estimate}
                if calib is not None:
                    # the measured-count term: what the installed
                    # calibration predicts this site retires
                    f = calib["factors"].get(est_row.get("isa_op", ""),
                                             calib["default"])
                    pred = int(round(estimate * f / max(1, tgt.lmul)))
                    per[name]["calibrated"] = pred
                    per[name]["diverges_calibrated"] = retired != pred
            row["executed"] = {
                "total": counts["executed"],
                "vector": counts["vector"],
                "vsetvli": (counts["vsetvli"] +
                            counts["implicit_vsetvli"]),
                "vuops": counts["vuops"],
                "per_intrinsic": per,
            }
        out["targets"][tname] = row
    return out


def format_report(rep: Dict) -> str:
    """Human-readable rendering of a :func:`report` dict."""
    lines = [f"# port.report — kernel {rep['kernel']!r} "
             f"(writes: {', '.join(rep['writes']) or '-'})"]
    tnames = list(rep["targets"])
    head = f"{'intrinsic':24s} {'isa op':10s} {'w':>4s}"
    for t in tnames:
        head += f" {t.replace('rvv-', 'v'):>10s}"
    lines.append(head)
    for name, meta in rep["intrinsics"].items():
        row = f"{name:24s} {meta['isa_op']:10s} {meta['width_bits']:>4d}"
        for t in tnames:
            tr = rep["targets"][t]
            per = tr["per_intrinsic"].get(name)
            if per is None:
                cell = "-"
            elif not tr["maps"][name]:
                cell = f"x/{per['tier'][:3]}"   # Table-2 'x': fell back
            else:
                cell = f"{per['tier'][:6]}:{per['instrs']}"
            row += f" {cell:>10s}"
        lines.append(row)
    total = f"{'TOTAL dynamic instrs':40s}"
    for t in tnames:
        total += f" {rep['targets'][t]['total_instrs']:>10d}"
    lines.append(total)
    if all("baseline_total_instrs" in rep["targets"][t] for t in tnames):
        base = f"{'baseline (vector cap)':40s}"
        spd = f"{'speedup':40s}"
        for t in tnames:
            base += f" {rep['targets'][t]['baseline_total_instrs']:>10d}"
            spd += f" {rep['targets'][t]['speedup']:>9.2f}x"
        lines.append(base)
        lines.append(spd)
    if all("revec" in rep["targets"][t] for t in tnames):
        rv = f"{'re-vectorized (VLENxLMUL re-tile)':40s}"
        fac = f"{'  retile factor / masked tails':40s}"
        fb = f"{'  strips retiled / narrow fallbacks':40s}"
        for t in tnames:
            r = rep["targets"][t]["revec"]
            rv += f" {r['total_instrs']:>10d}"
            fac += f" {str(r['factor']) + 'x/' + str(r['masked']):>10s}"
            fb += f" {str(r['retiled']) + '/' + str(r['narrow_fallbacks']):>10s}"
        lines.append(rv)
        lines.append(fac)
        lines.append(fb)
        # structured vetoes are mostly structural facts of the IR, so
        # render them once, deduplicated across the sweep
        seen = set()
        for t in tnames:
            for v in rep["targets"][t]["revec"]["vetoes"]:
                key = (v["site"], v["reason"], v["line"])
                if key in seen:
                    continue
                seen.add(key)
                where = f" (line {v['line']})" if v.get("line") else ""
                lines.append(f"  veto {v['site'] or '<loop>'}: "
                             f"{v['reason']}{where}")
    if all("resilience" in rep["targets"][t] for t in tnames):
        rz = f"{'resilience (ladder rung used)':40s}"
        for t in tnames:
            r = rep["targets"][t]["resilience"]
            short = {"compiled+revec": "c+revec", "compiled": "compiled",
                     "interp": "interp"}
            cell = (short.get(r["used"], r["used"]) if r["used"]
                    else f"ERR:{r.get('error_type', '?')[:6]}")
            if r.get("degraded"):
                cell += "!"
            rz += f" {cell:>10s}"
        lines.append(rz)
    if all("executed" in rep["targets"][t] for t in tnames):
        ex = f"{'executed (RVV sim, retired)':40s}"
        uo = f"{'  vuops / diverging intrinsics':40s}"
        for t in tnames:
            r = rep["targets"][t]["executed"]
            ndiv = sum(1 for p in r["per_intrinsic"].values()
                       if p["diverges"])
            ex += f" {r['total']:>10d}"
            uo += f" {str(r['vuops']) + '/' + str(ndiv):>10s}"
        lines.append(ex)
        lines.append(uo)
    return "\n".join(lines)
