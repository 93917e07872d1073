"""The port's JIT backend (``repro_torch.port.compile``, ``CompiledKernel``,
its LRU and ``run_resilient``) against the JAX package's ``repro.port``,
on the CPU (the CUDA graph it captures on the card is held in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``):

* every corpus kernel at n = 64 (tail 67) on ``test_port_compile.py``'s
  targets (rvv-64, rvv-128, rvv-1024), compiled and compiled+revec: equal
  to the port's interpreter of the same IR and to the reference's
  ``compile`` under the reference's own compiled-versus-interpreter gate
  (integers bitwise, floats rtol 2e-6 / atol 2e-7), and conforming to the
  harness's NumPy reference (tests/test_port_conformance.py's budgets);
* ``CompileError`` exactly where the reference raises (the data-dependent
  loop of ``test_port_compile.py``, a counter without a constant step, a
  wrong argument count), and the same values where it compiles — also
  for a branch on a device scalar (both arms run and merge) and for a
  data-derived offset (read to the host, counted);
* the compiled-kernel LRU: counters, eviction, corruption recovery and
  the device in its key;
* ``run_resilient``'s records against the reference's under the same
  ``faultinject`` plans, with each rung's values bitwise.
"""
import os
import sys
import zlib

import numpy as np
import pytest
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CORPUS = os.path.join(ROOT, "examples", "neon_corpus")
sys.path.insert(0, CORPUS)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import harness  # noqa: E402
import test_port_conformance as conf  # noqa: E402
from test_torch_revec import SOURCES  # noqa: E402

from repro import port as jport  # noqa: E402
from repro.port import faultinject as jfi  # noqa: E402
from repro.port import resilience as jrz  # noqa: E402
from repro_torch import port  # noqa: E402
from repro_torch.core import use_target  # noqa: E402
from repro_torch.port import compile as tcompile  # noqa: E402
from repro_torch.port import faultinject as fi  # noqa: E402
from repro_torch.port import resilience as rz  # noqa: E402

# tests/test_port_compile.py's corpus targets
CORPUS_TARGETS = ("rvv-64", "rvv-128", "rvv-1024")
CASES = {c.kernel: c for c in harness.cases(n=64, tail_n=67)}
KERNELS = sorted(CASES)


@pytest.fixture(scope="module")
def corpora():
    return jport.load_corpus(CORPUS), port.load_corpus(CORPUS)


@pytest.fixture(autouse=True)
def _clean_slate():
    for mod in (fi, jfi):
        mod.disarm_all()
    for mod in (rz, jrz):
        mod.reset_resilience()
    port.compiled_cache_clear()
    jport.compiled_cache_clear()
    yield
    for mod in (fi, jfi):
        mod.disarm_all()
    for mod in (rz, jrz):
        mod.reset_resilience()


def _tup(x):
    return x if isinstance(x, tuple) else (x,)


def _np(x):
    return tuple(t.numpy() if isinstance(t, torch.Tensor) else
                 np.asarray(t) for t in _tup(x))


def _gate(got, want, label):
    """The reference's compiled-versus-interpreter gate
    (tests/test_port_compile.py:63-69)."""
    got, want = _np(got), _np(want)
    assert len(got) == len(want), label
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, label
        if g.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w, err_msg=label)
        else:
            np.testing.assert_allclose(g, w, rtol=2e-6, atol=2e-7,
                                       err_msg=label)


def _bitwise(got, want, label):
    got, want = _np(got), _np(want)
    assert len(got) == len(want), label
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, label
        assert np.array_equal(g.view(np.uint8), w.view(np.uint8)), label


@pytest.mark.parametrize("target", CORPUS_TARGETS)
@pytest.mark.parametrize("kernel", KERNELS)
def test_compiled_matches_the_reference_and_the_interpreter(kernel, target,
                                                            corpora):
    jk, tk = corpora
    case = CASES[kernel]
    args = case.make_args(np.random.default_rng(
        zlib.crc32(f"{kernel}:{target}".encode())))
    for revec in (False, True):
        label = f"{kernel}/{target}/revec={revec}"
        ck = tk[kernel].compile(target=target, revec=revec, device="cpu")
        assert ck.device == torch.device("cpu")
        got = ck(*args)
        for t in _tup(got):
            assert t.device.type == "cpu", label
        assert ck.last_call == {"captured": False, "host_reads": 0,
                                "issues": ck.last_call["issues"]}, label
        # the port's interpreter on the same (re-tiled) IR: the same
        # lowerings issue, so even the floats agree bitwise
        interp = port.Machine(ck.fn, policy="pallas", target=target,
                              device="cpu").run(*args)
        _bitwise(got, interp, label + "/interp")
        if not revec:
            _bitwise(got, tk[kernel](*args, target=target, device="cpu"),
                     label + "/PortedKernel")
        want = jk[kernel].compile(target=target, revec=revec)(*args)
        _gate(got, want, label + "/reference compile")
        conf._assert_conforms(_np(got), case.reference(*args), case,
                              label + "/harness")
        # a second call walks the recorded lowerings: the same bits
        _bitwise(ck(*args), got, label + "/second call")


@pytest.mark.parametrize("n", [1, 3, 5, 31, 33, 48, 67])
def test_odd_lengths_tail_kernel(n, corpora):
    jk, tk = corpora
    rng = np.random.default_rng(n)
    a = rng.uniform(-1, 1, n).astype(np.float32)
    b = rng.uniform(-1, 1, n).astype(np.float32)
    args = (n, a, b, np.zeros(n, np.float32))
    for target in ("rvv-128", "rvv-1024"):
        got = tk["xnn_f32_vadd_ukernel"].compile(
            target=target, revec=True, device="cpu")(*args)
        np.testing.assert_allclose(got.numpy(), a + b, rtol=1e-6)
        _gate(got, jk["xnn_f32_vadd_ukernel"].compile(
            target=target, revec=True)(*args), f"vadd/{target}/n={n}")


@pytest.mark.parametrize("kernel,xs", [
    ("xnn_f32_vtanh_ukernel", (4, 20, 35, 52)),
    ("xnn_f32_vdot_ukernel", (1, 7, 33, 67)),
    ("reduce_max_f32", (5, 31, 67)),
])
def test_revec_tails_match_the_reference(kernel, xs, corpora):
    """No-tail, additive-accumulator and max-accumulator masked tails of
    ``test_port_compile.py``, on rvv-1024."""
    jk, tk = corpora
    for n in xs:
        rng = np.random.default_rng(n)
        if kernel == "xnn_f32_vtanh_ukernel":
            args = (n, rng.uniform(-6, 6, n).astype(np.float32),
                    np.full(n, 7.0, np.float32))
        elif kernel == "xnn_f32_vdot_ukernel":
            args = (n, rng.uniform(-1, 1, n).astype(np.float32),
                    rng.uniform(-1, 1, n).astype(np.float32),
                    np.zeros(1, np.float32))
        else:
            args = (n, -np.abs(rng.uniform(1, 9, n)).astype(np.float32),
                    np.zeros(1, np.float32))
        got = tk[kernel].compile(target="rvv-1024", revec=True,
                                 device="cpu")(*args)
        want = jk[kernel].compile(target="rvv-1024", revec=True)(*args)
        _gate(got, want, f"{kernel}/n={n}")
        if kernel == "xnn_f32_vtanh_ukernel":
            m = (n // 4) * 4
            assert (got.numpy()[m:] == 7.0).all()
        if kernel == "reduce_max_f32":
            assert got.numpy()[0] == args[1].max()


# hand-written kernels: the strip shapes of test_port_compile.py plus
# scalar control the corpus does not reach
EDGES = {
    "upcount": """
    void f(size_t n, const float* x, float* y) {
      for (size_t i = 0; i < n; i += 1) {
        y[i] = x[i] > 0.0f ? x[i] : 0.0f;
      }
    }
    """,
    # a branch on a reduced sum: both arms run and merge on the device
    "branch": """
    void f(size_t n, const float* x, float* y) {
      float s = vaddvq_f32(vld1q_f32(x));
      if (s > 0.0f) {
        *y = s;
      } else {
        *y = -s * 2.0f;
      }
    }
    """,
    # a branch that writes a buffer and a register in one arm only
    "branch_vec": """
    void f(size_t n, const float* x, float* y) {
      float32x4_t v = vld1q_f32(x);
      float s = vgetq_lane_f32(v, 1);
      float32x4_t w = vdupq_n_f32(0.0f);
      if (s > 0.5f) {
        w = vaddq_f32(v, v);
        vst1q_f32(y + 4, w);
      }
      vst1q_f32(y, w);
    }
    """,
    # a select on a device scalar, then integer and float arithmetic
    "ternary": """
    void f(size_t n, const float* x, float* y) {
      float s = vaddvq_f32(vld1q_f32(x));
      int32_t q = s > 1.0f ? 3 : 7;
      float t = (float)(q * 2 + 1) / 3.0f;
      *y = t;
    }
    """,
}
# data that reaches an offset: read to the host and counted
GATHER = """
void f(size_t n, const int32_t* idx, const float* x, float* y) {
  int32_t k = vgetq_lane_s32(vld1q_s32(idx), 0);
  *y = *(x + k);
}
"""
# no closed-form trip count: CompileError in both packages
REFUSED = {
    "data_dependent": """
    void f(size_t n, const float* x, float* y) {
      float s = vaddvq_f32(vld1q_f32(x));
      while (s > 0.5f) {
        s = s - 1.0f;
        vst1q_f32(y, vld1q_f32(x));
      }
    }
    """,
    "halving": """
    void f(size_t n, const float* x, float* y) {
      for (; n != 0; n = n / 2) {
        *y = *x;
      }
    }
    """,
}


def _edge_args(name, seed):
    rng = np.random.default_rng(seed)
    if name in SOURCES:
        n = 26 if name in ("add2x", "addswap", "dot2x") else 32
        x = rng.uniform(-1, 1, n + 8).astype(np.float32)
        w = rng.uniform(1, 2, n + 8).astype(np.float32)
        out = np.zeros(1 if name in ("biased_dot", "dot2x") else n + 8,
                       np.float32)
        if name == "dot2x":
            return (n, x, out)
        return (n, x, w, out)
    x = rng.uniform(-1, 1, 8).astype(np.float32)
    return (5, x, np.full(8, -3.0, np.float32))


@pytest.mark.parametrize("name", sorted(SOURCES) + sorted(EDGES))
def test_hand_written_kernels_compile_as_the_reference(name):
    src = {**SOURCES, **EDGES}[name]
    jk, tk = jport.compile_kernel(src), port.compile_kernel(src)
    for seed in range(4):
        args = _edge_args(name, seed)
        for target in ("rvv-128", "rvv-1024"):
            for revec in (False, True):
                label = f"{name}/{seed}/{target}/revec={revec}"
                ck = tk.compile(target=target, revec=revec, device="cpu")
                got = ck(*args)
                assert ck.last_call["host_reads"] == 0, label
                _gate(got, jk.compile(target=target, revec=revec)(*args),
                      label)
                _bitwise(got, port.Machine(
                    ck.fn, policy="pallas", target=target,
                    device="cpu").run(*args), label + "/interp")


def test_data_reaching_an_offset_is_read_to_the_host():
    jk, tk = jport.compile_kernel(GATHER), port.compile_kernel(GATHER)
    x = np.arange(8, dtype=np.float32)
    ck = tk.compile(target="rvv-128", device="cpu")
    for k in (2, 5, 0):
        args = (4, np.array([k, 0, 0, 0], np.int32), x,
                np.zeros(1, np.float32))
        got = ck(*args)
        assert got.numpy()[0] == k
        assert ck.last_call["host_reads"] == 1
        assert not ck.last_call["captured"]
        _gate(got, jk.compile(target="rvv-128")(*args), f"gather/{k}")


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_compile_error_where_the_reference_raises(name):
    jk = jport.compile_kernel(REFUSED[name])
    tk = port.compile_kernel(REFUSED[name])
    args = (4, np.ones(4, np.float32), np.zeros(4, np.float32))
    with pytest.raises(jport.CompileError) as want:
        jk.compile(target="rvv-128", jit=False)(*args)
    with pytest.raises(port.CompileError) as got:
        tk.compile(target="rvv-128", jit=False, device="cpu")(*args)
    assert str(got.value) == str(want.value)
    # the interpreter still runs what it can (it has no trip count to
    # derive): the halving loop runs; the data-dependent one too
    tk(*args, target="rvv-128", device="cpu")


def test_wrong_argument_count_is_a_compile_error(corpora):
    jk, tk = corpora
    k = "xnn_f32_vadd_ukernel"
    with pytest.raises(jport.CompileError) as want:
        jk[k].compile(target="rvv-128", jit=False)(4)
    with pytest.raises(port.CompileError) as got:
        tk[k].compile(target="rvv-128", device="cpu")(4)
    assert str(got.value) == str(want.value)


def test_a_trip_count_from_a_tensor_argument_is_one_host_read(corpora):
    _, tk = corpora
    case = CASES["xnn_f32_vadd_ukernel"]
    args = case.make_args(np.random.default_rng(0))
    ck = tk[case.kernel].compile(target="rvv-128", device="cpu")
    want = ck(*args)
    got = ck(torch.tensor(args[0]), *args[1:])
    _bitwise(got, want, "tensor n")
    assert ck.last_call["host_reads"] == 1


def test_walks_use_the_recorded_lowerings(corpora, monkeypatch):
    """After the first call of a signature, no registry lookup runs."""
    from repro_torch.core.registry import REGISTRY
    _, tk = corpora
    case = CASES["xnn_f32_vtanh_ukernel"]
    args = case.make_args(np.random.default_rng(0))
    ck = tk[case.kernel].compile(target="rvv-128", device="cpu")
    before = REGISTRY.cache_info()["lookups"]
    first = ck(*args)
    assert REGISTRY.cache_info()["lookups"] - before == \
        ck.last_call["issues"] > 0
    before = REGISTRY.cache_info()["lookups"]
    _bitwise(ck(*args), first, "second call")
    assert REGISTRY.cache_info()["lookups"] == before
    # another signature (n) selects afresh
    other = harness.cases(n=16, tail_n=16)
    args16 = [c for c in other if c.kernel == case.kernel][0].make_args(
        np.random.default_rng(0))
    ck(*args16)
    assert REGISTRY.cache_info()["lookups"] > before


def test_signatures_are_bounded(corpora, monkeypatch):
    _, tk = corpora
    monkeypatch.setattr(tcompile, "SIGNATURES", 2)
    ck = tk["xnn_f32_vadd_ukernel"].compile(target="rvv-128", device="cpu")
    for n in (3, 5, 7, 9):
        ck(n, np.ones(n, np.float32), np.ones(n, np.float32),
           np.zeros(n, np.float32))
    assert len(ck._call._plans) == 2


def test_compile_seams_fire_in_the_port(corpora):
    _, tk = corpora
    case = CASES["xnn_f32_vadd_ukernel"]
    args = case.make_args(np.random.default_rng(0))
    with fi.injected("compile.trace",
                     error=rz.CompileError("boom")) as plan:
        with pytest.raises(port.CompileError, match="boom"):
            tk[case.kernel].compile(target="rvv-128", device="cpu")
    assert plan.fired == 1
    ck = tk[case.kernel].compile(target="rvv-128", device="cpu")
    with fi.injected("compile.run", error=rz.ExecError("bang")) as plan:
        with pytest.raises(port.ExecError, match="bang"):
            ck(*args)
    assert plan.fired == 1
    ck(*args)


@pytest.fixture
def tuned_cache(tmp_path):
    """A process-wide autotune cache in a file of its own, dropped after
    the test with no calibration left installed."""
    from repro_torch.port import autotune
    autotune.uninstall()
    yield autotune.set_cache_path(str(tmp_path / "autotune.json"))
    autotune.reset_cache()
    autotune.uninstall()


def test_tuned_compile_applies_a_cached_decision(corpora, tuned_cache):
    _, tk = corpora
    case = CASES["xnn_f32_vadd_ukernel"]
    k = tk[case.kernel]
    d = tuned_cache.tune_or_get(k, case.make_args(
        np.random.default_rng(0)), "rvv-128")
    assert (d.lmul, d.tail) != (1, "auto")       # the tuner moved a knob
    ck = k.compile(target="rvv-128", revec=True, tuned=True, device="cpu")
    assert ck.target.lmul == d.lmul and ck.target.name == \
        f"rvv-128-m{d.lmul}"
    assert ck.tail == d.tail and ck.factor_cap == d.factor_cap
    # an explicit knob overrides the cached one
    assert k.compile(target="rvv-128", revec=True, tuned=True,
                     tail="masked", device="cpu").tail == "masked"


def test_tuned_compile_is_static_on_h100_and_without_revec(corpora,
                                                           tuned_cache):
    _, tk = corpora
    case = CASES["xnn_f32_vadd_ukernel"]
    k = tk[case.kernel]
    tuned_cache.tune_or_get(k, case.make_args(np.random.default_rng(0)),
                            "rvv-128")
    for kw in ({"target": "h100", "revec": True},
               {"target": "rvv-128", "revec": False}):
        tuned = k.compile(tuned=True, device="cpu", **kw)
        assert tuned is k.compile(tuned=False, device="cpu", **kw), kw
    assert tuned_cache.stats()["hits"] == 0       # never looked up


@pytest.mark.parametrize("name", ["xnn_f32_vadd_ukernel", "bitreverse_u8",
                                  "qs8_vmlal_dot_ukernel",
                                  "xnn_f32_vdot_ukernel"])
def test_tuned_compile_gives_the_static_outputs(corpora, tuned_cache, name):
    _, tk = corpora
    case = CASES[name]
    k = tk[name]
    args = case.make_args(np.random.default_rng(0))
    for target in ("rvv-128", "rvv-1024"):
        tuned_cache.tune_or_get(k, args, target)
        static = k.compile(target=target, revec=True, device="cpu")
        tuned = k.compile(target=target, revec=True, tuned=True,
                          device="cpu")
        _gate(tuned(*args), static(*args), f"{name}/{target}")


def test_compile_target_none_resolves_ambient(corpora):
    _, tk = corpora
    k = tk["xnn_f32_vadd_ukernel"]
    with use_target("rvv-1024"):
        c_1024 = k.compile(revec=True, device="cpu")
    with use_target("rvv-128"):
        c_128 = k.compile(revec=True, device="cpu")
    assert c_1024 is not c_128
    assert c_1024.target.name == "rvv-1024"
    assert c_1024.retiling.factor == 8 and c_128.retiling.factor == 1


def test_default_device_is_the_card(corpora):
    _, tk = corpora
    k = tk["xnn_f32_vadd_ukernel"]
    if torch.cuda.is_available():
        assert k.compile(target="rvv-128").device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        k.compile(target="rvv-128")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcompile.compile_fn(k.fn, target="rvv-128")


# ---------------------------------------------------------------------------
# the compiled-kernel LRU
# ---------------------------------------------------------------------------

def test_cache_hits_misses_and_variants(corpora):
    _, tk = corpora
    k = tk["xnn_f32_vmul_ukernel"]
    c1 = k.compile(target="rvv-1024", revec=True, device="cpu")
    c2 = k.compile(target="rvv-1024", revec=True, device="cpu")
    assert c1 is c2
    assert c1 is not k.compile(target="rvv-1024", revec=False,
                               device="cpu")
    assert c1 is not k.compile(target="rvv-1024", revec=True, jit=False,
                               device="cpu")
    assert c1 is not k.compile(target="rvv-1024", revec=True, tail="masked",
                               device="cpu")
    info = port.compiled_cache_info()
    assert (info["hits"], info["misses"], info["size"]) == (1, 4, 4)
    assert info["capacity"] == 256 == jport.compiled_cache_info()["capacity"]
    port.compiled_cache_clear()
    assert port.compiled_cache_info()["size"] == 0


def test_cache_eviction_and_capacity(corpora):
    _, tk = corpora
    k = tk["xnn_f32_vadd_ukernel"]
    args = CASES[k.name].make_args(np.random.default_rng(0))
    port.set_compiled_cache_capacity(2)
    try:
        held = [k.compile(target=t, device="cpu")
                for t in ("rvv-64", "rvv-128", "rvv-256")]
        info = port.compiled_cache_info()
        assert info["size"] == 2 and info["evictions"] == 1
        # an evicted kernel still runs for its holder
        held[0](*args)
        assert k.compile(target="rvv-64", device="cpu") is not held[0]
        with pytest.raises(ValueError):
            port.set_compiled_cache_capacity(0)
        with fi.eviction_storm(1):
            assert port.compiled_cache_info()["capacity"] == 1
            k.compile(target="rvv-512", device="cpu")
            assert port.compiled_cache_info()["size"] == 1
        assert port.compiled_cache_info()["capacity"] == 2
    finally:
        port.set_compiled_cache_capacity(256)


def test_cache_corruption_is_recompiled_not_served(corpora):
    _, tk = corpora
    k = tk["xnn_f32_vadd_ukernel"]
    args = CASES[k.name].make_args(np.random.default_rng(0))
    good = k.compile(target="rvv-128", revec=True, device="cpu")
    want = good(*args)
    # a lone entry: its callable is broken in place
    assert fi.corrupt_cache_entry(k.name)
    again = k.compile(target="rvv-128", revec=True, device="cpu")
    assert again is not good
    assert port.compiled_cache_info()["corruptions"] == 1
    _bitwise(again(*args), want, "recompiled")
    # two entries: their payloads swap keys
    k.compile(target="rvv-1024", revec=True, device="cpu")
    assert len(fi.corrupt_cache_entry(k.name)) == 2
    a = k.compile(target="rvv-128", revec=True, device="cpu")
    b = k.compile(target="rvv-1024", revec=True, device="cpu")
    assert a.target.name == "rvv-128" and b.target.name == "rvv-1024"
    assert port.compiled_cache_info()["corruptions"] == 3


def test_cache_key_holds_the_device(corpora):
    """An entry built for one device never serves another: the hit is
    validated against the key's device like any other field."""
    _, tk = corpora
    k = tk["xnn_f32_vadd_ukernel"]
    cpu = k.compile(target="rvv-128", device="cpu")
    assert k.compile(target="rvv-128", device=torch.device("cpu")) is cpu
    key = next(iter(port._COMPILED_CACHE._cache))
    assert key[-1] == torch.device("cpu")
    cpu.device = torch.device("meta")       # as if built for another
    fresh = k.compile(target="rvv-128", device="cpu")
    assert fresh is not cpu and fresh.device == torch.device("cpu")
    assert port.compiled_cache_info()["corruptions"] == 1


# ---------------------------------------------------------------------------
# run_resilient against the reference under the same plans
# ---------------------------------------------------------------------------

LADDER_CASES = {c.kernel: c for c in harness.cases(n=8, tail_n=8)}
PLANS = {
    "clean": [],
    "revec_veto": [("revec.retile", "RevecVeto", None)],
    "compile_fails": [("compile.trace", "CompileError", None)],
    "runtime_fault": [("compile.run", "ExecError", None)],
    "transient": [("compile.trace", "CompileTimeout", 1)],
    "exhausted": [("compile.trace", "CompileError", None),
                  ("interp.run", "ExecError", None)],
}


def _ladder(pkg_port, pkg_fi, pkg_rz, k, args, plan, **kw):
    import contextlib
    with contextlib.ExitStack() as stack:
        for seam, err, times in plan:
            stack.enter_context(pkg_fi.injected(
                seam, error=getattr(pkg_rz, err), times=times))
        try:
            out, rec = pkg_rz.run_resilient(k, *args, target="rvv-128",
                                            jit=False, **kw)
        except pkg_rz.LadderExhausted as e:
            return None, ("exhausted", [(a.rung, a.error_type)
                                        for a in e.attempts])
    d = rec.to_dict()
    trail = [(a["rung"], a["ok"], a["skipped"], a["error_type"],
              a["retries"]) for a in d["attempts"]]
    return out, (d["used"], d["degraded"], d["requested"], trail)


@pytest.mark.parametrize("kernel", sorted(LADDER_CASES))
def test_run_resilient_records_are_the_reference_s(kernel, corpora):
    jk, tk = corpora
    args = conf._args_for(LADDER_CASES[kernel], seed=0)
    rungs = {"compiled+revec": tk[kernel].compile(
        target="rvv-128", revec=True, jit=False, device="cpu")(*args),
        "compiled": tk[kernel].compile(target="rvv-128", jit=False,
                                       device="cpu")(*args),
        "interp": tk[kernel](*args, target="rvv-128", device="cpu")}
    for name, plan in PLANS.items():
        for mod in (rz, jrz):
            mod.reset_resilience()
        port.compiled_cache_clear()
        jport.compiled_cache_clear()
        got, grec = _ladder(port, fi, rz, tk[kernel], args, plan,
                            device="cpu")
        want, wrec = _ladder(jport, jfi, jrz, jk[kernel], args, plan)
        assert grec == wrec, f"{kernel}/{name}"
        if got is None:
            continue
        _bitwise(got, rungs[grec[0]], f"{kernel}/{name}/{grec[0]}")
        _gate(got, want, f"{kernel}/{name}/reference")
        assert rz.resilience_stats()["runs"] == \
            jrz.resilience_stats()["runs"] == 1


def test_method_and_breaker_are_the_reference_s(corpora):
    jk, tk = corpora
    kernel = "xnn_f32_vadd_ukernel"
    args = conf._args_for(LADDER_CASES[kernel], seed=0)
    out, rec = tk[kernel].run_resilient(*args, target="rvv-128",
                                        device="cpu")
    assert rec.used == "compiled+revec" and not rec.degraded
    assert out.device.type == "cpu"
    brk = rz.breaker()
    with fi.injected("compile.trace", error=rz.CompileError,
                     times=None) as plan:
        for _ in range(brk.threshold):
            _, rec = tk[kernel].run_resilient(*args, target="rvv-128",
                                              jit=False, device="cpu")
            assert rec.used == "interp"
        fired = plan.fired
        _, rec = tk[kernel].run_resilient(*args, target="rvv-128",
                                          jit=False, device="cpu")
        assert plan.fired == fired
        assert [a.skipped for a in rec.attempts] == [True, True, False]
        assert rec.attempts[0].error_type == "CircuitOpen"
    with pytest.raises(rz.DeadlineExceeded):
        tk[kernel].run_resilient(*args, target="rvv-128", jit=False,
                                 deadline_s=0.0, device="cpu")
    assert rz.resilience_stats()["deadline_misses"] == 1
