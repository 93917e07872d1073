"""The port's RVV code generator and simulator (``repro_torch.rvv``) and
the report columns they and the re-vectorizer feed, against the JAX
package and the committed files:

* the emitted C of every corpus kernel is byte for byte the reference's
  ``repro.rvv.emit`` over rvv-64 .. rvv-1024 (and rvv-64-m2), and the
  committed ``examples/rvv_emitted/*.c``;
* the simulator's retired counts at n = 1024 (tail 1027) equal
  ``BENCH_rvv_sim.json`` (``executed``, ``vector``, ``vsetvli``,
  ``vuops``);
* five executors agree on ``test_port_compile.py``'s corpus targets
  (rvv-64, rvv-128, rvv-1024) at n = 64 (tail 67): the interpreter, the
  compiled and the compiled+revec kernel, the emitted program on the
  simulator and the harness's NumPy reference;
* ``report``'s ``revec`` column equals ``BENCH_port.json``'s
  ``revec_instrs``, ``retile_factor``, ``masked_tails``,
  ``narrow_fallbacks`` and ``vetoes`` over its sweep, and the
  ``retile_coverage`` built from it is the committed one; the
  ``compiled``/``executed`` columns equal the reference's report.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CORPUS = os.path.join(ROOT, "examples", "neon_corpus")
GOLDEN_DIR = os.path.join(ROOT, "examples", "rvv_emitted")
sys.path.insert(0, CORPUS)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import harness  # noqa: E402
import test_port_conformance as conf  # noqa: E402

from repro import port as jport  # noqa: E402
from repro import rvv as jrvv  # noqa: E402
from repro_torch import port, rvv  # noqa: E402
from repro_torch.core.targets import resolve_target  # noqa: E402
from repro_torch.port import faultinject as fi  # noqa: E402
from repro_torch.port import resilience as rz  # noqa: E402

BENCH_SIM = json.loads(open(os.path.join(ROOT, "BENCH_rvv_sim.json")).read())
BENCH_PORT = json.loads(open(os.path.join(ROOT, "BENCH_port.json")).read())
EMIT_TARGETS = ("rvv-64", "rvv-64-m2", "rvv-128", "rvv-256", "rvv-512",
                "rvv-1024")
CORPUS_TARGETS = ("rvv-64", "rvv-128", "rvv-1024")
KERNELS = sorted(c.kernel for c in harness.cases())


@pytest.fixture(scope="module")
def corpora():
    return jport.load_corpus(CORPUS), port.load_corpus(CORPUS)


def _tup(x):
    return x if isinstance(x, tuple) else (x,)


def _np(x):
    return tuple(t.numpy() if isinstance(t, torch.Tensor) else
                 np.asarray(t) for t in _tup(x))


def test_the_package_exports_the_reference_s_names():
    assert rvv.__all__ == jrvv.__all__


@pytest.mark.parametrize("kernel", KERNELS)
def test_emitted_c_is_the_reference_s(kernel, corpora):
    jk, tk = corpora
    for t in EMIT_TARGETS:
        got = rvv.emit(tk[kernel], t)
        want = jrvv.emit(jk[kernel], t)
        assert got.render_c() == want.render_c(), f"{kernel}/{t}"
        assert got.c_name == want.c_name
        assert got.retiling.factor == want.retiling.factor


@pytest.mark.parametrize("path", sorted(os.listdir(GOLDEN_DIR)))
def test_emitted_c_is_the_committed_file(path, corpora):
    _, tk = corpora
    name, rest = path.split("__")
    target = rest.removesuffix(".c").replace("rvv_", "rvv-")
    with open(os.path.join(GOLDEN_DIR, path)) as f:
        assert rvv.emit(tk[name], target).render_c() == f.read()


@pytest.mark.parametrize("kernel", KERNELS)
def test_retired_counts_are_the_committed_ones(kernel, corpora):
    _, tk = corpora
    cases = harness.cases(n=BENCH_SIM["n"], tail_n=BENCH_SIM["n"] + 3)
    order = [c.kernel for c in cases]
    case = cases[order.index(kernel)]
    args = case.make_args(np.random.default_rng(order.index(kernel)))
    want = case.reference(*args)
    committed = BENCH_SIM["kernels"][kernel]["targets"]
    for t in BENCH_SIM["sweep"]:
        got, counts = rvv.execute(rvv.emit(tk[kernel], t), *args)
        conf._assert_conforms(_np(got), want, case, f"{kernel}/{t}/sim")
        row = {"executed": counts["executed"], "vector": counts["vector"],
               "vsetvli": counts["vsetvli"] + counts["implicit_vsetvli"],
               "vuops": counts["vuops"]}
        assert row == committed[t], f"{kernel}/{t}"


@pytest.mark.parametrize("target", CORPUS_TARGETS)
@pytest.mark.parametrize("kernel", KERNELS)
def test_five_executors_agree(kernel, target, corpora):
    """interp == compiled == compiled+revec == simulator == NumPy."""
    _, tk = corpora
    case = {c.kernel: c for c in harness.cases(n=64, tail_n=67)}[kernel]
    args = case.make_args(np.random.default_rng(KERNELS.index(kernel)))
    want = case.reference(*args)
    k = tk[kernel]
    outs = {
        "interp": k(*args, target=target, device="cpu"),
        "compiled": k.compile(target=target, device="cpu")(*args),
        "compiled+revec": k.compile(target=target, revec=True,
                                    device="cpu")(*args),
        "sim": rvv.execute(rvv.emit(k, target), *args)[0],
    }
    for name, got in outs.items():
        conf._assert_conforms(_np(got), want, case,
                              f"{kernel}/{target}/{name}")
    for g, i in zip(_np(outs["compiled"]), _np(outs["interp"])):
        assert np.array_equal(g.view(np.uint8), i.view(np.uint8))


def test_the_simulator_is_numpy_only(corpora):
    _, tk = corpora
    case = harness.cases(n=16, tail_n=16)[0]
    args = case.make_args(np.random.default_rng(0))
    out, _ = rvv.execute(rvv.emit(tk[case.kernel], "rvv-256"), *args)
    for o in _tup(out):
        assert isinstance(o, np.ndarray)


def test_codegen_refuses_a_fixed_tile_target(corpora):
    _, tk = corpora
    with pytest.raises(rvv.CodegenError, match="h100"):
        rvv.emit(tk["xnn_f32_vadd_ukernel"], "h100")


def test_the_simulator_memory_seam_fires(corpora):
    _, tk = corpora
    case = {c.kernel: c for c in harness.cases(n=16, tail_n=16)}[
        "xnn_f32_vadd_ukernel"]
    args = case.make_args(np.random.default_rng(0))
    prog = rvv.emit(tk[case.kernel], "rvv-128")
    with fi.injected("sim.mem", error=rz.SimError, times=1) as plan:
        with pytest.raises(port.SimError) as ei:
            rvv.run(prog, *args)
    assert plan.fired == 1
    assert isinstance(ei.value, port.PortError)
    assert ei.value.provenance.get("mnemonic")


def test_simulator_state_errors_are_typed():
    from repro_torch.rvv.codegen import RvvProgram, V, VSetVL
    st = V(mnem="vadd.vv", dst="v1", srcs=(("v", "v0"), ("v", "v0")),
           dtype="int32", sew=32, emul=1, vl="vl0")
    prog = RvvProgram(fn_name="t", target=resolve_target("rvv-128"),
                      params=[], writes=[], body=[st])
    with pytest.raises(rvv.SimError, match="before any vsetvli"):
        rvv.RvvSim(prog).run()
    body = [VSetVL("vl0", 10**9, 16, 2)]
    sim = rvv.RvvSim(RvvProgram(fn_name="t",
                                target=resolve_target("rvv-256"),
                                params=[], writes=[], body=body))
    sim.run()
    assert sim.vl == 2 * 256 // 16 and sim.counts()["vsetvli"] == 1


# ---------------------------------------------------------------------------
# the report's columns
# ---------------------------------------------------------------------------

def _report_args(kernel):
    cases = harness.cases(n=64)
    i = [c.kernel for c in cases].index(kernel)
    return cases[i].make_args(np.random.default_rng(i))


@pytest.fixture(scope="module")
def revec_rows(corpora):
    _, tk = corpora
    return {k: port.report(tk[k], *_report_args(k),
                           sweep=BENCH_PORT["sweep"], compiled=True)
            for k in KERNELS}


@pytest.mark.parametrize("kernel", KERNELS)
def test_revec_column_is_the_committed_one(kernel, revec_rows):
    committed = BENCH_PORT["kernels"][kernel]["targets"]
    for t, row in revec_rows[kernel]["targets"].items():
        r, c = row["revec"], committed[t]
        assert (r["total_instrs"], r["factor"], r["masked"],
                r["narrow_fallbacks"], r["vetoes"], r["retiled"],
                r["strips"]) == \
            (c["revec_instrs"], c["retile_factor"], c["masked_tails"],
             c["narrow_fallbacks"], c["vetoes"], c["retiled_strips"],
             c["strips"]), f"{kernel}/{t}"


def test_retile_coverage_is_the_committed_one(revec_rows):
    """benchmarks/port_suite.py's ``retile_coverage`` over the revec
    column: narrow fallbacks only for rowscale, fold_halves and
    qs8_gemm_mx8."""
    target = "rvv-1024"
    rows = {k: r["targets"][target]["revec"] for k, r in revec_rows.items()}
    retiled = sorted(k for k, r in rows.items() if r["factor"] > 1)
    coverage = {"target": target, "retiled_kernels": len(retiled),
                "total_kernels": len(rows), "retiled": retiled,
                "narrow_fallbacks": {k: r["narrow_fallbacks"]
                                     for k, r in sorted(rows.items())
                                     if r["narrow_fallbacks"]}}
    assert coverage == BENCH_PORT["retile_coverage"]
    assert sorted(coverage["narrow_fallbacks"]) == [
        "f32_rowscale_ukernel", "fold_halves_f32", "qs8_gemm_mx8_ukernel"]


@pytest.mark.parametrize("kernel", KERNELS)
def test_compiled_and_executed_columns_are_the_reference_s(kernel, corpora):
    jk, tk = corpora
    args = _report_args(kernel)
    sweep = ("rvv-128", "rvv-1024")
    got = port.report(tk[kernel], *args, sweep=sweep, compiled=True,
                      executed=True)
    want = jport.report(jk[kernel], *args, sweep=sweep, compiled=True,
                        executed=True)
    assert got == want
    assert port.format_report(got) == jport.format_report(want)
