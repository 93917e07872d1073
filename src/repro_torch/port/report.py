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

These are the estimate columns.  The reference's three further columns
need modules the port does not have yet, and ask for them by name:
``compiled`` the re-vectorizer (ROADMAP A.10c), ``resilience`` the
degradation ladder (A.10c) and ``executed`` the RVV code generator and
simulator (A.11).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

from ..core import targets as _targets

__all__ = ["report", "format_report", "PORT_SWEEP"]

# the paper's evaluation family, plus rvv-64 where Table 2's 'x' entries
# (Q-register intrinsics that cannot map) actually bite
PORT_SWEEP = ("rvv-64", "rvv-128", "rvv-256", "rvv-512", "rvv-1024")

# report column -> the ROADMAP item that ports what it needs
_NOT_PORTED = {"compiled": "A.10c (revec)",
               "resilience": "A.10c (run_resilient)",
               "executed": "A.11 (rvv codegen and simulator)"}


def report(kernel, *example_args,
           sweep: Sequence[str] = PORT_SWEEP,
           policy: str = "pallas",
           baseline_policy: Optional[str] = "vector",
           compiled: bool = False,
           executed: bool = False,
           resilience: bool = False) -> Dict:
    """Per-intrinsic migration report for ``kernel`` on ``example_args``.

    ``kernel`` is a :class:`repro_torch.port.PortedKernel`; the example
    args fix buffer shapes and trip counts (instruction counts are
    dynamic, like the paper's Spike methodology).  Only their shapes and
    dtypes are read: the kernel runs abstractly, on no device.

    ``compiled``, ``executed`` and ``resilience`` name the reference's
    re-vectorization, simulator and ladder columns; each raises
    NotImplementedError naming the ROADMAP item that brings it.
    """
    for column, wanted in (("compiled", compiled), ("executed", executed),
                           ("resilience", resilience)):
        if wanted:
            raise NotImplementedError(
                f"report column {column!r} needs ROADMAP "
                f"{_NOT_PORTED[column]}, not ported yet")
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
