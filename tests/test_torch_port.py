"""The NEON-migration frontend ``repro_torch.port`` against the JAX
package's ``repro.port`` on the 24-kernel corpus of ``examples/neon_corpus``:

* parsing and lowering give the reference's IR text letter for letter
  (``pretty()``), and the reference's error types and provenance;
* the concrete interpreter, on the CPU, conforms to the harness's NumPy
  reference over rvv-64..1024 and under h100 at the tail lengths of
  ``tests/test_port_conformance.py`` (its ULP budgets; the strip step read
  off the JAX kernel by ``revec.strip_loops``), and equals the JAX
  interpreter bitwise at rvv-128 on two lengths (the rsqrt kernel within
  2 ULP: ROADMAP C.16);
* the migration report's estimate columns equal the JAX report's and the
  committed ``BENCH_port.json`` over its 6-target sweep, and counting a
  run under ``trace.count`` gives the same totals.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CORPUS = os.path.join(ROOT, "examples", "neon_corpus")
sys.path.insert(0, CORPUS)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
import harness  # noqa: E402
import test_port_conformance as conf  # noqa: E402

from repro import port as jport  # noqa: E402
from repro.port import revec  # noqa: E402
from repro_torch import port  # noqa: E402
from repro_torch.core import trace  # noqa: E402
from repro_torch.port import faultinject, resilience  # noqa: E402

BENCH = json.loads(open(os.path.join(ROOT, "BENCH_port.json")).read())
CASES = {c.kernel: c for c in harness.cases()}
KERNELS = sorted(CASES)
CONF_TARGETS = ("rvv-64", "rvv-128", "rvv-256", "rvv-512", "rvv-1024",
                "h100")


@pytest.fixture(scope="module")
def corpora():
    return jport.load_corpus(CORPUS), port.load_corpus(CORPUS)


def _np(x):
    if isinstance(x, tuple):
        return tuple(_np(v) for v in x)
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_the_corpus_is_the_reference_s(corpora):
    jk, tk = corpora
    assert sorted(jk) == sorted(tk) == KERNELS and len(KERNELS) == 24
    for name in KERNELS:
        assert tk[name].fn.writes == jk[name].fn.writes
        assert tk[name].param_names == jk[name].param_names


@pytest.mark.parametrize("kernel", KERNELS)
def test_pretty_is_the_reference_s(kernel, corpora):
    jk, tk = corpora
    assert tk[kernel].pretty() == jk[kernel].pretty()
    for tgt in ("rvv-64", "rvv-128"):
        assert tk[kernel].substitution(tgt) == jk[kernel].substitution(tgt)


# sources the reference rejects (tests/test_port.py, tests/test_resilience.py)
BAD = [
    ("garbage", "void f( {"),
    ("parse-line", "void k(int n, float *a) {\n    float x = ;\n}\n"),
    ("lexer", "void k() {\n  int x = 1 @ 2;\n}"),
    ("eof", "void k(int n, float *a) {\n    for (int i = 0; i < n"),
    ("unknown", "#include <arm_neon.h>\nvoid k(int n, float *a) {\n"
                "    float32x4_t v = vfrobnicateq_f32(a);\n}\n"),
    ("tuple-index", "#include <arm_neon.h>\nvoid k(float *a) {\n"
                    "    float32x4x2_t t = vld2q_f32(a);\n"
                    "    float32x4_t x = t.val[7];\n}\n"),
    ("tuple-elem", "void f(size_t n, const float* a, float* y) {\n"
                   "  float32x4x2_t v = vld2q_f32(a);\n"
                   "  float32x4x2_t w;\n  w.val[0] = v.val[0];\n"
                   "  vst2q_f32(y, w.val[0]);\n}\n"),
    ("type", "void f(const float* a) {\n  float32x2_t d = vld1_f32(a);\n"
             "  float32x4_t q = vaddq_f32(d, d);\n}\n"),
    ("c-operator", "void f(const float* a, float* y) {\n"
                   "  float32x4_t v = vld1q_f32(a);\n  v = v + v;\n"
                   "  vst1q_f32(y, v);\n}\n"),
    ("const-store", "void f(const float* a) {\n"
                    "  float32x4_t v = vld1q_f32(a);\n"
                    "  vst1q_f32(a, v);\n}\n"),
    ("nonpointer-index", "void k(int n, float *a) {\n    float x = n[3];\n}\n"),
    ("two-functions", "void f(float* a) {}\nvoid g(float* a) {}\n"),
]


@pytest.mark.parametrize("label,src", BAD, ids=[b[0] for b in BAD])
def test_rejections_match_the_reference(label, src):
    errs = []
    for pkg in (jport, port):
        with pytest.raises(pkg.PortError) as ei:
            pkg.compile_kernel(src, filename=f"{label}.c")
        errs.append(ei.value)
    je, te = errs
    assert type(te).__name__ == type(je).__name__
    assert isinstance(te, SyntaxError) == isinstance(je, SyntaxError)
    assert isinstance(te, TypeError) == isinstance(je, TypeError)
    assert te.provenance == je.provenance
    assert str(te) == str(je).replace("repro.port", "repro_torch.port")


def _strip(jk, kernel):
    strips = revec.strip_loops(jk[kernel].fn)
    return strips[0].step if strips else 8


def test_chip_smoke_reads_the_strip_step_as_the_reference(corpora):
    jk, tk = corpora
    for kernel in KERNELS:
        assert chip_smoke.strip_step(tk[kernel].fn) == _strip(jk, kernel), \
            kernel


@pytest.mark.parametrize("target", CONF_TARGETS)
@pytest.mark.parametrize("kernel", KERNELS)
def test_interp_conforms_to_the_harness(kernel, target, corpora):
    jk, tk = corpora
    for i, n in enumerate(conf._lengths(kernel, target, _strip(jk, kernel))):
        case = conf._case_for(kernel, n)
        args = conf._args_for(case, seed=1000 + i)
        keep = [a.copy() for a in args if isinstance(a, np.ndarray)]
        got = tk[kernel](*args, target=target, device="cpu")
        for t in got if isinstance(got, tuple) else (got,):
            assert t.device.type == "cpu"
        conf._assert_conforms(_np(got), case.reference(*args), case,
                              f"{kernel}/{target}/n={n}/torch-interp")
        # functional stores: the caller's buffers are untouched
        for a, k in zip([a for a in args if isinstance(a, np.ndarray)],
                        keep):
            np.testing.assert_array_equal(a, k)


# kernels that issue vrsqrte: torch's rsqrt and XLA's may round a lane
# one ULP apart (tests/test_torch_isa.py), which the Newton steps carry
# to the output; every other kernel must agree bitwise
ROUNDS_APART = {"xnn_f32_vrsqrt_ukernel": 2}


@pytest.mark.parametrize("kernel", KERNELS)
def test_interp_equals_the_reference_interp(kernel, corpora):
    jk, tk = corpora
    step = _strip(jk, kernel)
    for n in (step + 1, 3 * step + 2):
        case = conf._case_for(kernel, n)
        args = conf._args_for(case, seed=7)
        want = _np(jk[kernel](*args, target="rvv-128"))
        got = _np(tk[kernel](*args, target="rvv-128", device="cpu"))
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert g.dtype == w.dtype and g.shape == w.shape
            if kernel in ROUNDS_APART:
                gap = chip_smoke.ulp_gap(g, w)
                assert gap <= ROUNDS_APART[kernel], f"{kernel}/n={n}: {gap}"
            else:
                assert np.array_equal(g.view(np.uint8), w.view(np.uint8)), \
                    f"{kernel}/n={n}"


@pytest.mark.parametrize("kernel", KERNELS)
def test_report_equals_the_reference_and_the_committed_file(kernel,
                                                            corpora):
    jk, tk = corpora
    i = [c.kernel for c in harness.cases(n=64)].index(kernel)
    args = harness.cases(n=64)[i].make_args(np.random.default_rng(i))
    got = port.report(tk[kernel], *args, sweep=BENCH["sweep"])
    want = jport.report(jk[kernel], *args, sweep=BENCH["sweep"])
    assert got == want
    committed = BENCH["kernels"][kernel]["targets"]
    for t, row in got["targets"].items():
        c = committed[t]
        assert (row["total_instrs"], row["scalar_instrs"],
                row["baseline_total_instrs"], row["speedup"]) == \
            (c["total_instrs"], c["scalar_instrs"], c["baseline_instrs"],
             c["speedup"]), f"{kernel}/{t}"
    assert port.format_report(got) == jport.format_report(want)
    # a run counted under trace.count retires what the estimate charges
    with trace.count() as counted:
        tk[kernel](*args, target="rvv-128", device="cpu")
    assert counted["total"] == committed["rvv-128"]["total_instrs"]


def test_report_columns_not_ported_say_which_item():
    """Every report column is ported now (the re-vectorizer and ladder of
    ROADMAP A.10c, the simulator of A.11): each one the reference names
    is there, the ladder's on the device asked for."""
    k = port.compile_file(os.path.join(CORPUS, "vadd.c"))
    jk = jport.compile_file(os.path.join(CORPUS, "vadd.c"))
    args = CASES["xnn_f32_vadd_ukernel"].make_args(np.random.default_rng(0))
    for column, key in (("compiled", "revec"), ("executed", "executed"),
                        ("resilience", "resilience")):
        kw = {column: True, "sweep": ("rvv-128",)}
        got = port.report(k, *args, device="cpu", **kw)
        want = jport.report(jk, *args, **kw)
        g, w = got["targets"]["rvv-128"], want["targets"]["rvv-128"]
        if column == "resilience":
            assert (g[key]["used"], g[key]["degraded"]) == \
                (w[key]["used"], w[key]["degraded"]) == \
                ("compiled+revec", False)
        else:
            assert g[key] == w[key]
        assert port.format_report(got).splitlines()[-1].split()[:2] == \
            jport.format_report(want).splitlines()[-1].split()[:2]


def test_default_device_is_the_card():
    k = port.compile_file(os.path.join(CORPUS, "vadd.c"))
    args = CASES["xnn_f32_vadd_ukernel"].make_args(np.random.default_rng(0))
    if torch.cuda.is_available():
        assert k(*args).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            k(*args)


def test_host_reads_are_counted_where_the_reference_reads():
    """vdot reads its reduced sum back once, then one scalar load per
    operand and tail element; its stores and broadcast loads stay put."""
    k = port.compile_file(os.path.join(CORPUS, "vdot.c"))
    case = CASES["xnn_f32_vdot_ukernel"]
    args = case.make_args(np.random.default_rng(0))
    m = port.Machine(k.fn, policy="pallas", target="rvv-128", device="cpu")
    m.run(*args)
    tail = args[0] % 4
    assert m.host_reads == 1 + 2 * tail
    q = port.compile_file(os.path.join(CORPUS, "qs8gemm.c"))
    gemm_args = CASES["qs8_gemm_mx8_ukernel"].make_args(
        np.random.default_rng(0))
    m = port.Machine(q.fn, policy="pallas", target="h100", device="cpu")
    m.run(*gemm_args)
    assert m.host_reads == 0


def test_interp_seam_fires_in_the_port():
    k = port.compile_file(os.path.join(CORPUS, "vadd.c"))
    args = CASES["xnn_f32_vadd_ukernel"].make_args(np.random.default_rng(0))
    with faultinject.injected("interp.run",
                              error=resilience.ExecError("boom")) as plan:
        with pytest.raises(port.ExecError, match="boom") as ei:
            k(*args, device="cpu")
    assert plan.fired == 1
    assert ei.value.kernel == "xnn_f32_vadd_ukernel"
    k(*args, device="cpu")            # disarmed again
    # the compiled-kernel cache's chaos helper works on the port's LRU
    with faultinject.eviction_storm():
        assert port.compiled_cache_info()["capacity"] == 1
    assert port.compiled_cache_info()["capacity"] == 256


def test_resilience_records_and_breaker_are_the_reference_s():
    from repro.port import resilience as jres
    assert resilience.RUNGS == jres.RUNGS
    b = resilience.CircuitBreaker(threshold=2)
    key = ("k", "rvv-128", "interp")
    assert not b.failure(key) and b.failure(key) and b.is_open(key)
    b.success(key)
    assert not b.is_open(key)
    rec = resilience.DegradationRecord("k", "rvv-128", "compiled",
                                       used="interp")
    assert rec.degraded and rec.to_dict()["degraded"]
    err = resilience.wrap_error(ValueError("x"), stage="execute",
                                kernel="k", target="h100")
    jerr = jres.wrap_error(ValueError("x"), stage="execute", kernel="k",
                           target="h100")
    assert type(err).__name__ == type(jerr).__name__
    assert str(err) == str(jerr)
