"""The port's serving tier for migrated kernels
(``repro_torch.serve.PortEngine``) and the batched walk under it
(``repro_torch.port.compile.BatchedFn``), on the CPU, against the JAX
package's ``repro.serve.PortEngine``:

* every test of ``tests/test_serve_port.py`` and of
  ``tests/test_resilience.py::TestEngineChaos`` on the port, the
  ``engine.batch`` fault seam included;
* ``BENCH_serve_port.json``'s deterministic columns from
  ``benchmarks/serve_port_suite.py``'s sequence of engines: for each
  bucket policy the programs demanded against their bound, the buckets,
  the inert rows and the padding overhead, and the compile cache's
  counters (its ``reqs_per_s`` and ``*_ms`` columns are host times of the
  JAX package and are not compared);
* one mixed slate of all 24 corpus kernels at n in {0, 1, strip - 1,
  strip + 1, 100} under rvv-128 and rvv-1024 with revec, each result
  equal to the reference engine's and to a direct port call (integers
  bitwise, floats within tests/test_port_conformance.py's budgets), with
  no row falling back;
* the batched walk itself: every isa lowering on leading batch axes,
  every memory lowering's batched form row by row against the unbatched
  lowering (host and per-row offsets and counts, inactive rows), the loop
  envelope (vadd's tail is bounded by 3 in a bucket of 64, though the
  closed form at n = 64 gives 0), one plan a bucket whatever the rows'
  lengths, the tier of every site equal to a row's, the hand-written
  kernels of test_torch_compile.py (branches and selects on device data)
  row by row, a non-counter scalar that steers a loop, and loaded data
  that steers a loop (a typed CompileError; the engine serves those rows
  one at a time).

The graph capture itself runs only on the card (``chip_smoke.py``'s
``port_serve`` phase).
"""
import dataclasses
import json
import os
import sys
import zlib

import numpy as np
import pytest
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CORPUS = os.path.join(ROOT, "examples", "neon_corpus")
sys.path.insert(0, CORPUS)
sys.path.insert(0, ROOT)

import harness  # noqa: E402
from chip_smoke import DT, conform_ulp, isa_cases, padded, strip_step  # noqa: E402

from repro import port as jport  # noqa: E402
from repro.port import faultinject as jfi  # noqa: E402
from repro.port import resilience as jrz  # noqa: E402
from repro.serve import PortEngine as JEngine  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro_torch import port  # noqa: E402
from repro_torch.core import isa, targets  # noqa: E402
from repro_torch.core.registry import REGISTRY  # noqa: E402
from repro_torch.core.targets import resolve_target  # noqa: E402
from repro_torch.core.vtypes import torch_dtype  # noqa: E402
from repro_torch.port import compile as tcompile  # noqa: E402
from repro_torch.port import faultinject as fi  # noqa: E402
from repro_torch.port import resilience as rz  # noqa: E402
from repro_torch.serve import BucketPolicy, PortEngine, Request  # noqa: E402

SERVE = {"xnn_f32_vadd_ukernel": "vadd.c",
         "xnn_f32_vdot_ukernel": "vdot.c",
         "qs8_vmlal_dot_ukernel": "vmlal_dot.c"}
with open(os.path.join(ROOT, "BENCH_serve_port.json")) as _f:
    BENCH = json.load(_f)


@pytest.fixture(autouse=True)
def _clean_slate():
    for mod in (fi, jfi):
        mod.disarm_all()
    for mod in (rz, jrz):
        mod.reset_resilience()
    yield
    for mod in (fi, jfi):
        mod.disarm_all()
    for mod in (rz, jrz):
        mod.reset_resilience()


@pytest.fixture(scope="module")
def kernels():
    return {name: port.compile_file(os.path.join(CORPUS, f), name=name)
            for name, f in SERVE.items()}


@pytest.fixture(scope="module")
def corpora():
    return jport.load_corpus(CORPUS), port.load_corpus(CORPUS)


def _engine(**kw):
    return PortEngine(device="cpu", **kw)


def _direct(req, target=None):
    t = req.target if req.target is not None else target
    return req.kernel.compile(target=t, revec=True, device="cpu")(*req.args)


def _requests(kernels, rng, ns, target=None):
    """tests/test_serve_port.py's request maker."""
    reqs = []
    for kname, n in ns:
        if kname == "qs8_vmlal_dot_ukernel":
            a = rng.integers(-2, 3, n).astype(np.int8)
            b = rng.integers(-2, 3, n).astype(np.int8)
            out = np.zeros(1, np.int16)
        else:
            a = rng.standard_normal(n).astype(np.float32)
            b = rng.standard_normal(n).astype(np.float32)
            out = np.zeros(1 if kname == "xnn_f32_vdot_ukernel" else n,
                           np.float32)
        reqs.append(Request(kernels[kname], (n, a, b, out), target=target))
    return reqs


def _bitwise(got, want, what):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w), what


# ---------------------------------------------------------------------------
# engine correctness (test_serve_port.py)
# ---------------------------------------------------------------------------

def test_submit_matches_direct_calls(kernels):
    rng = np.random.default_rng(0)
    ns = [("xnn_f32_vadd_ukernel", n) for n in (1, 3, 4, 5, 63, 64, 65)]
    ns += [("xnn_f32_vdot_ukernel", n) for n in (2, 7, 33)]
    ns += [("qs8_vmlal_dot_ukernel", n) for n in (1, 8, 40)]
    reqs = _requests(kernels, rng, ns)
    eng = _engine(target="rvv-128", max_batch=8)
    results = eng.submit(reqs)
    assert len(results) == len(reqs)
    for req, got in zip(reqs, results):
        want = req.kernel.compile(target="rvv-128", device="cpu")(*req.args)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_mixed_target_fleet_routes_per_request(kernels):
    rng = np.random.default_rng(1)
    wide = _requests(kernels, rng, [("xnn_f32_vadd_ukernel", 40)] * 3,
                     target="rvv-1024")
    narrow = _requests(kernels, rng, [("xnn_f32_vadd_ukernel", 40)] * 3,
                       target="rvv-128")
    eng = _engine(target="rvv-128", max_batch=4)
    interleaved = [wide[0], narrow[0], wide[1], narrow[1], wide[2],
                   narrow[2]]
    results = eng.submit(interleaved)
    for req, got in zip(interleaved, results):
        want = req.kernel.compile(target=req.target,
                                  device="cpu")(*req.args)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)
    st = eng.stats()
    assert st["batches"] == 2
    assert st["inert_rows"] == 2


def test_oversize_buffer_promotes_bucket(kernels):
    k = kernels["xnn_f32_vadd_ukernel"]
    a = np.arange(200, dtype=np.float32)
    b = np.ones(200, np.float32)
    y = np.full(200, -7.0, np.float32)
    eng = _engine(target="rvv-128", max_batch=2)
    got = eng.submit([Request(k, (4, a, b, y))])[0]
    want = k.compile(target="rvv-128", device="cpu")(4, a, b, y)
    assert got.shape == (200,)
    np.testing.assert_allclose(got.numpy(), want.numpy())


def test_chunking_splits_groups_at_max_batch(kernels):
    rng = np.random.default_rng(2)
    reqs = _requests(kernels, rng, [("xnn_f32_vdot_ukernel", 17)] * 5)
    eng = _engine(target="rvv-128", max_batch=2)
    results = eng.submit(reqs)
    st = eng.stats()
    assert st["batches"] == 3 and st["inert_rows"] == 1
    for req, got in zip(reqs, results):
        want = req.kernel.compile(target="rvv-128", device="cpu")(*req.args)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_bad_arity_raises(kernels):
    eng = _engine(target="rvv-128")
    with pytest.raises(ValueError, match="takes 4 args"):
        eng.submit([Request(kernels["xnn_f32_vadd_ukernel"], (4,))])


def test_results_are_tensors_on_the_engine_s_device(kernels):
    """Each result is its row of a column the program returned, on the
    engine's device; buffers handed in as tensors are served too."""
    rng = np.random.default_rng(4)
    host = _requests(kernels, rng, [("xnn_f32_vadd_ukernel", 9),
                                    ("xnn_f32_vadd_ukernel", 30)])
    tens = [Request(r.kernel, (r.args[0],) + tuple(
        torch.from_numpy(a.copy()) for a in r.args[1:])) for r in host]
    eng = _engine(target="rvv-128", max_batch=4)
    for a, b in zip(eng.submit(host), eng.submit(tens)):
        assert a.device.type == "cpu" and a._base is not None
        _bitwise(a, b, "tensor requests")


def test_engine_needs_the_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        PortEngine(target="rvv-128")


# ---------------------------------------------------------------------------
# bucketing + the program bound
# ---------------------------------------------------------------------------

def test_bucket_policy_geometry():
    fine = BucketPolicy.preset("fine")
    coarse = BucketPolicy.preset("coarse")
    assert [fine.bucket(n) for n in (0, 1, 64, 65, 128, 129)] == \
        [64, 64, 64, 128, 128, 256]
    assert [coarse.bucket(n) for n in (1, 64, 65, 256, 257)] == \
        [64, 64, 256, 256, 1024]
    with pytest.raises(KeyError, match="unknown bucket policy"):
        BucketPolicy.preset("nope")


def test_batch_programs_bounded_by_buckets(kernels):
    rng = np.random.default_rng(3)
    eng = _engine(target="rvv-128", max_batch=4, bucket_policy="fine")
    names = ("xnn_f32_vadd_ukernel", "qs8_vmlal_dot_ukernel")
    for tgt in ("rvv-128", "rvv-1024"):
        for _ in range(2):
            ns = [(nm, int(rng.integers(8, 60))) for nm in names]
            ns += [(nm, int(rng.integers(70, 120))) for nm in names]
            eng.submit(_requests(kernels, rng, ns, target=tgt))
    st = eng.stats()
    assert st["batch_programs"] <= 2 * 2 * 2, st
    before = st["batch_programs"]
    ns = [(nm, int(rng.integers(8, 60))) for nm in names]
    eng.submit(_requests(kernels, rng, ns, target="rvv-128"))
    assert eng.stats()["batch_programs"] == before


def test_warmup_populates_compile_cache(kernels):
    eng = _engine(target="rvv-128")
    before = port.compiled_cache_info()
    stats = eng.warmup(kernels, targets=["rvv-128", "rvv-1024"])
    assert stats == {"kernels": 3, "targets": 2, "compiles": 6}
    after = port.compiled_cache_info()
    eng.warmup(kernels, targets=["rvv-128", "rvv-1024"])
    again = port.compiled_cache_info()
    assert again["misses"] == after["misses"]
    assert again["hits"] >= after["hits"] + 6
    assert after["misses"] >= before["misses"]


# ---------------------------------------------------------------------------
# the process-wide CompiledKernel cache, as the engine uses it
# ---------------------------------------------------------------------------

def test_compile_cache_keys_on_resolved_target(kernels):
    k = kernels["xnn_f32_vadd_ukernel"]
    with targets.use_target("rvv-128"):
        narrow = k.compile(device="cpu")
    with targets.use_target("rvv-1024"):
        wide = k.compile(device="cpu")
    assert narrow is not wide
    assert narrow.target.name == "rvv-128" and wide.target.name == "rvv-1024"
    assert k.compile(target="rvv-128", device="cpu") is narrow


def test_compile_cache_keys_on_target_value(kernels):
    k = kernels["xnn_f32_vadd_ukernel"]
    registered = k.compile(target="rvv-128", device="cpu")
    adhoc = dataclasses.replace(targets.get_target("rvv-128"), vlen=256)
    compiled = k.compile(target=adhoc, device="cpu")
    assert compiled is not registered and compiled.target.vlen == 256
    assert k.compile(target=adhoc, device="cpu") is compiled


def test_compile_cache_bounded_eviction(kernels):
    k = kernels["xnn_f32_vdot_ukernel"]
    info = port.compiled_cache_info()
    try:
        port.set_compiled_cache_capacity(2)
        c64 = k.compile(target="rvv-64", device="cpu")
        k.compile(target="rvv-256", device="cpu")
        k.compile(target="rvv-512", device="cpu")
        info2 = port.compiled_cache_info()
        assert info2["capacity"] == 2 and info2["size"] == 2
        assert info2["evictions"] >= 1
        again = k.compile(target="rvv-64", device="cpu")
        assert again is not c64
        a = np.ones(5, np.float32)
        _bitwise(c64(5, a, a, np.zeros(1, np.float32)),
                 again(5, a, a, np.zeros(1, np.float32)), "evicted")
    finally:
        port.set_compiled_cache_capacity(
            max(info["capacity"],
                port._CompiledKernelCache.DEFAULT_CAPACITY))
    with pytest.raises(ValueError, match="capacity must be >= 1"):
        port.set_compiled_cache_capacity(0)


def test_compile_cache_info_counts(kernels):
    port.compiled_cache_clear()
    k = kernels["qs8_vmlal_dot_ukernel"]
    assert port.compiled_cache_info()["size"] == 0
    k.compile(target="rvv-128", device="cpu")
    k.compile(target="rvv-128", device="cpu")
    info = port.compiled_cache_info()
    assert info["misses"] == 1 and info["hits"] == 1 and info["size"] == 1


# ---------------------------------------------------------------------------
# BENCH_serve_port.json: benchmarks/serve_port_suite.py's engines
# ---------------------------------------------------------------------------

def _suite_requests(kernel, count, n_range, rng, target=None):
    """serve_port_suite._make_requests, draw for draw."""
    reqs = []
    for _ in range(count):
        n = int(rng.integers(*n_range))
        if kernel.name == "qs8_vmlal_dot_ukernel":
            a = rng.integers(-2, 3, n).astype(np.int8)
            b = rng.integers(-2, 3, n).astype(np.int8)
            out = np.zeros(1, np.int16)
        elif kernel.name == "xnn_f32_vdot_ukernel":
            a = rng.standard_normal(n).astype(np.float32)
            b = rng.standard_normal(n).astype(np.float32)
            out = np.zeros(1, np.float32)
        else:
            a = rng.standard_normal(n).astype(np.float32)
            b = rng.standard_normal(n).astype(np.float32)
            out = np.zeros(n, np.float32)
        reqs.append(Request(kernel, (n, a, b, out), target=target))
    return reqs


def test_bench_serve_port_deterministic_columns(kernels):
    short, long_ = (20, 61), (70, 121)
    port.compiled_cache_clear()
    # the batch sweep: one engine per kernel x target x batch
    for kernel in kernels.values():
        for tgt in BENCH["targets"]:
            for B in BENCH["batch_sizes"]:
                rng = np.random.default_rng(0)
                eng = _engine(target=tgt, max_batch=B,
                              bucket_policy="fine")
                eng.submit(_suite_requests(kernel, B, short, rng))
    # the policy sweep: mixed lengths, a compile then a timed submit
    for pol in BENCH["policies"]:
        policy = BucketPolicy.preset(pol)
        eng = _engine(max_batch=32, bucket_policy=pol)
        rng = np.random.default_rng(1)
        sigs = set()
        for kname, kernel in kernels.items():
            for tgt in BENCH["targets"]:
                reqs = (_suite_requests(kernel, 16, short, rng, tgt)
                        + _suite_requests(kernel, 16, long_, rng, tgt))
                sigs |= {(kname, tgt, policy.bucket(int(r.args[0])))
                         for r in reqs}
                eng.submit(reqs)
                eng.submit(reqs)
        st = eng.stats()
        want = BENCH["engines"][pol]
        assert st["batch_programs"] == want["batch_programs"] == \
            len(sigs) == want["program_bound"]
        assert sorted({b for _, _, b in sigs}) == want["buckets"]
        assert st["inert_rows"] == want["inert_rows"]
        assert round(st["pad_overhead"], 3) == want["pad_overhead"]
        assert st["resilience"]["batch_faults"] == 0
    info = port.compiled_cache_info()
    assert {k: info[k] for k in ("hits", "misses", "size")} == \
        {k: BENCH["compile_cache"][k] for k in ("hits", "misses", "size")}


# ---------------------------------------------------------------------------
# the 24-kernel mixed slate, against the reference engine and direct calls
# ---------------------------------------------------------------------------

def _slate(tk, jk):
    out = []
    for name in sorted(tk):
        step = strip_step(tk[name].fn)
        for n in sorted({0, 1, step - 1, step + 1, 100}):
            case = {c.kernel: c for c in harness.cases(n=n, tail_n=n)}[name]
            args = padded(case.make_args(np.random.default_rng(
                zlib.crc32(name.encode()) + n)))
            out.append((case, Request(tk[name], args),
                        JRequest(jk[name], args)))
    return out


@pytest.mark.parametrize("target", ["rvv-128", "rvv-1024"])
def test_corpus_slate_matches_reference_engine_and_direct_calls(corpora,
                                                                target):
    jk, tk = corpora
    slate = _slate(tk, jk)
    eng = _engine(target=target, max_batch=8)
    got = eng.submit([r for _, r, _ in slate])
    want = JEngine(target=target, max_batch=8).submit(
        [j for _, _, j in slate])
    for (case, req, _), g, w in zip(slate, got, want):
        g = g if isinstance(g, tuple) else (g,)
        w = w if isinstance(w, tuple) else (w,)
        conform_ulp([t.numpy() for t in g], [np.asarray(x) for x in w],
                    case)
        d = _direct(req, target)
        conform_ulp([t.numpy() for t in g],
                    [t.numpy() for t in (d if isinstance(d, tuple)
                                         else (d,))], case)
    r = eng.stats()["resilience"]
    assert r["batch_faults"] == 0 and r["row_fallbacks"] == 0
    assert r["program_fallbacks"] == 0


# ---------------------------------------------------------------------------
# engine chaos (test_resilience.py::TestEngineChaos), the engine.batch seam
# ---------------------------------------------------------------------------

def _chaos_req(corpus, name, n, seed=0, deadline_s=None):
    case = {c.kernel: c for c in harness.cases(n=n, tail_n=n)}[name]
    return Request(corpus[name], case.make_args(np.random.default_rng(seed)),
                   deadline_s=deadline_s)


def _interp(req):
    return req.kernel(*req.args, target="rvv-128", device="cpu")


class TestEngineChaos:

    def test_poisoned_kernel_spares_batch_mates(self, corpora):
        _, tk = corpora
        eng = _engine(target="rvv-128", max_batch=4)
        a = [_chaos_req(tk, "xnn_f32_vadd_ukernel", n, seed=n)
             for n in (8, 16)]
        b = [_chaos_req(tk, "xnn_f32_vmul_ukernel", n, seed=n)
             for n in (8, 16)]
        ref = [_interp(r) for r in a + b]
        with fi.injected(
                "engine.batch", error=rz.ExecError, times=None,
                where=lambda c: c["kernel"] == "xnn_f32_vadd_ukernel") as p:
            res = eng.submit(a + b)
        assert p.fired == 1
        for got, want in zip(res, ref):
            _bitwise(got, want, "engine poisoned-A")
        st = eng.stats()["resilience"]
        assert st["batch_faults"] >= 1
        assert st["row_fallbacks"] == len(a)
        assert st["errors_returned"] == 0

    def test_exhausted_row_is_typed_not_fatal(self, corpora):
        _, tk = corpora
        eng = _engine(target="rvv-128", max_batch=4)
        bad = _chaos_req(tk, "xnn_f32_vadd_ukernel", 8)
        good = _chaos_req(tk, "xnn_f32_vmul_ukernel", 8)
        want = _interp(good)
        port.compiled_cache_clear()
        poisoned = lambda c: c.get("kernel") == "xnn_f32_vadd_ukernel"  # noqa: E731
        with fi.injected("engine.batch", error=rz.ExecError,
                         times=None, where=poisoned), \
             fi.injected("compile.trace", error=rz.CompileError,
                         times=None, where=poisoned), \
             fi.injected("interp.run", error=rz.ExecError,
                         times=None, where=poisoned):
            res = eng.submit([bad, good])
        assert isinstance(res[0], rz.LadderExhausted)
        assert res[0].kernel == "xnn_f32_vadd_ukernel"
        _bitwise(res[1], want, "engine healthy-B")
        assert eng.stats()["resilience"]["errors_returned"] == 1

    def test_on_error_raise_mode(self, corpora):
        _, tk = corpora
        eng = _engine(target="rvv-128", on_error="raise")
        req = _chaos_req(tk, "xnn_f32_vadd_ukernel", 8, deadline_s=0.0)
        with pytest.raises(rz.DeadlineExceeded):
            eng.submit([req])

    def test_deadline_resolves_typed_without_stalling(self, corpora):
        _, tk = corpora
        eng = _engine(target="rvv-128", max_batch=4)
        live = _chaos_req(tk, "xnn_f32_vadd_ukernel", 8)
        dead = _chaos_req(tk, "xnn_f32_vadd_ukernel", 16, deadline_s=0.0)
        want = _interp(live)
        res = eng.submit([live, dead])
        _bitwise(res[0], want, "engine live-row")
        assert isinstance(res[1], rz.DeadlineExceeded)
        assert eng.stats()["resilience"]["deadline_misses"] == 1

    def test_breaker_quarantines_batched_compile(self, corpora):
        _, tk = corpora
        eng = _engine(target="rvv-128", max_batch=4)
        brk = rz.breaker()
        req = _chaos_req(tk, "xnn_f32_vdot_ukernel", 8)
        want = _interp(req)
        port.compiled_cache_clear()
        tgt = resolve_target("rvv-128")
        with fi.injected("engine.batch", error=rz.CompileError,
                         times=None):
            for _ in range(brk.threshold):
                with fi.injected("compile.trace", error=rz.CompileError,
                                 times=None, where=lambda c: True):
                    res = eng.submit([req])
                    assert isinstance(res[0], rz.PortError) or \
                        torch.equal(res[0], want)
        assert any(k[0] == "xnn_f32_vdot_ukernel" and k[1] == tgt.name
                   for k in brk.open_keys())

    def test_program_falls_back_to_narrow_rung(self, corpora):
        _, tk = corpora
        eng = _engine(target="rvv-128", max_batch=4)
        reqs = [_chaos_req(tk, "xnn_f32_vclamp_ukernel", n, seed=n)
                for n in (8, 16, 24)]
        ref = [_interp(r) for r in reqs]
        port.compiled_cache_clear()
        with fi.injected("revec.retile", error=rz.RevecVeto, times=None):
            res = eng.submit(reqs)
        for got, want in zip(res, ref):
            _bitwise(got, want, "engine narrow-fallback")
        st = eng.stats()["resilience"]
        assert st["program_fallbacks"] == 1
        assert st["batch_faults"] == 0

    def test_chaos_matches_the_reference_engine(self, corpora):
        """The same plan on both engines: the same resilience counters
        and the same values."""
        jk, tk = corpora
        counters = []
        for pkg, corpus, mod, eng in (
                ("port", tk, fi, _engine(target="rvv-128", max_batch=4)),
                ("ref", jk, jfi, JEngine(target="rvv-128", max_batch=4))):
            reqs = [_chaos_req(corpus, k, n, seed=n) for k, n in (
                ("xnn_f32_vadd_ukernel", 8), ("xnn_f32_vmul_ukernel", 8),
                ("xnn_f32_vadd_ukernel", 16))]
            if pkg == "ref":
                reqs = [JRequest(r.kernel, r.args) for r in reqs]
            with mod.injected(
                    "engine.batch", error=(rz if pkg == "port" else jrz)
                    .ExecError, times=None,
                    where=lambda c: c["kernel"] == "xnn_f32_vadd_ukernel"):
                res = eng.submit(reqs)
            r = eng.stats()["resilience"]
            counters.append(({k: r[k] for k in (
                "batch_faults", "row_fallbacks", "errors_returned",
                "deadline_misses", "program_fallbacks")},
                [np.asarray(x.numpy() if isinstance(x, torch.Tensor)
                            else x) for x in res]))
        assert counters[0][0] == counters[1][0]
        for g, w in zip(counters[0][1], counters[1][1]):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the batched walk
# ---------------------------------------------------------------------------

_MEMORY_OPS = {op for op in isa.__all__ if op.startswith(("vld", "vst"))}
_NON_MEMORY = [(op, t) for op in isa.__all__ if op not in _MEMORY_OPS
               and op != "vdup" for t in REGISTRY.tiers_of(op)]
# float lowerings whose CPU kernels may round a lane differently when the
# tensor is longer (a vectorized body against its scalar remainder)
_BATCH_ULP = {"vrsqrte": 1, "vaddv": 2, "vfold": 2}


def _t(a):
    if isinstance(a, DT):
        return torch_dtype(str(a))
    if isinstance(a, np.ndarray):
        return torch.from_numpy(a.copy())
    return a


@pytest.mark.parametrize("op,tier", _NON_MEMORY,
                         ids=[f"{o}-{t}" for o, t in _NON_MEMORY])
def test_lowering_on_a_leading_batch_axis(op, tier):
    """Row r of a lowering on (B, lanes) registers is the lowering on row
    r: the batched walk calls the unbatched lowerings."""
    from chip_smoke import ulp_gap
    fn = REGISTRY.lowering(op, tier).fn
    for label, args in isa_cases(op):
        rows = [[_t(np.roll(a, r)) if isinstance(a, np.ndarray) else _t(a)
                 for a in args] for r in range(3)]
        batched = [torch.stack([row[i] for row in rows])
                   if isinstance(a, torch.Tensor) else a
                   for i, a in enumerate(rows[0])]
        got = fn(*batched)
        got = got if isinstance(got, tuple) else (got,)
        for r, row in enumerate(rows):
            want = fn(*row)
            want = want if isinstance(want, tuple) else (want,)
            for g, w in zip(got, want, strict=True):
                g = g[r]
                assert g.shape == w.shape and g.dtype == w.dtype, label
                if w.is_floating_point():
                    gap = ulp_gap(g.numpy(), w.numpy())
                    assert gap <= _BATCH_ULP.get(op, 0), (label, gap)
                else:
                    assert torch.equal(g, w), label


@pytest.mark.parametrize("op,tier", sorted(isa.BATCHED_MEMORY),
                         ids=[f"{o}-{t}" for o, t in
                              sorted(isa.BATCHED_MEMORY)])
def test_batched_memory_form_is_the_lowering_row_by_row(op, tier):
    fn = REGISTRY.lowering(op, tier).fn
    bfn = isa.BATCHED_MEMORY[(op, tier)]
    seg = int(op[3]) if op[3] in "234" else 1
    masked = op.endswith("m")
    group = op.startswith("vld1g")
    store = op.startswith("vst")
    rng = np.random.default_rng(zlib.crc32(f"{op}{tier}".encode()))
    B = 4
    for n, lanes in ((16, 4), (8, 4), (3, 4), (37, 8)):
        for _ in range(4):
            buf = torch.from_numpy(
                rng.integers(-100, 100, (B, n)).astype(np.int16))
            offs = rng.integers(-2 * n, 2 * n, B)
            cnts = rng.integers(-2, lanes + 3, B)
            act = torch.from_numpy(rng.random(B) < 0.7)
            vals = [torch.from_numpy(rng.integers(
                -100, 100, (B, lanes)).astype(np.int16))
                for _ in range(seg)]
            for per_row in (False, True):
                off = torch.from_numpy(offs) if per_row else int(offs[0])
                cnt = torch.from_numpy(cnts) if per_row else int(cnts[0])
                ro = offs if per_row else [int(offs[0])] * B
                rc = cnts if per_row else [int(cnts[0])] * B

                def row_rest(r):
                    c = (np.int64(rc[r]),)
                    if group:
                        return (2, lanes // 2) + (c + (7,) if masked else ())
                    if store:
                        return tuple(v[r] for v in vals) + \
                            (c if masked else ())
                    return (lanes,) + (c + (7,) if masked else ())

                if group:
                    rest = (2, lanes // 2) + ((cnt, 7) if masked else ())
                elif store:
                    rest = tuple(vals) + ((cnt,) if masked else ())
                else:
                    rest = (lanes,) + ((cnt, 7) if masked else ())
                for active in ((None, act) if store else (None,)):
                    kw = {"active": active} if store else {}
                    got = bfn(buf, off, *rest, **kw)
                    got = got if isinstance(got, tuple) else (got,)
                    for r in range(B):
                        if active is not None and not bool(active[r]):
                            want = (buf[r],)
                        else:
                            want = fn(buf[r], np.int64(ro[r]), *row_rest(r))
                            want = want if isinstance(want, tuple) \
                                else (want,)
                        for g, w in zip(got, want, strict=True):
                            assert torch.equal(g[r], w), (n, lanes, ro[r],
                                                          rc[r], per_row)


def test_batched_scalar_load_and_store():
    rng = np.random.default_rng(7)
    buf = torch.from_numpy(rng.integers(-50, 50, (5, 6)).astype(np.int32))
    offs = np.array([-7, -6, -1, 5, 9])
    act = torch.tensor([True, True, False, True, True])
    vals = torch.from_numpy(rng.integers(-50, 50, 5).astype(np.int32))
    for off in (torch.from_numpy(offs), -2, 3, 11):
        got = isa.batched_index(buf, off)
        stored = isa.batched_store_scalar(buf, off, vals, act)
        for r in range(5):
            o = int(off[r]) if isinstance(off, torch.Tensor) else off
            assert got[r] == buf[r][isa.static_index(o, 6)]
            want = isa.store_scalar(buf[r], o, vals[r]) if act[r] \
                else buf[r]
            assert torch.equal(stored[r], want)


def test_envelope_bounds_every_length_in_the_bucket(kernels):
    """vadd's scalar tail runs n % 4 times: at n = 64 the closed form
    gives 0, but a bucket of 64 must unroll it 3 times."""
    fn = kernels["xnn_f32_vadd_ukernel"].fn
    steering = set()
    trips = tcompile.envelope(fn, {0: range(0, 65)}, steering)
    assert steering == {0}
    assert sorted(trips.values()) == [3, 16]
    steering = set()
    assert sorted(tcompile.envelope(fn, {0: (64,)}, steering).values()) \
        == [0, 16]


def test_one_plan_a_bucket_whatever_the_lengths(kernels):
    k = kernels["xnn_f32_vadd_ukernel"]
    bf = k.compile(target="rvv-128", revec=True, device="cpu").batched()
    rng = np.random.default_rng(5)
    for _ in range(3):
        ns = rng.permutation(np.arange(20, 64))[:32]
        a = torch.from_numpy(rng.standard_normal((32, 64)).astype(np.float32))
        b = torch.from_numpy(rng.standard_normal((32, 64)).astype(np.float32))
        y = torch.zeros(32, 64)
        out = bf(ns, a, b, y, bounds={0: 64})[0]
        assert len(bf._plans) == 1
        direct = k.compile(target="rvv-128", revec=True, device="cpu")
        for r in (0, 7, 31):
            _bitwise(out[r], direct(int(ns[r]), a[r], b[r], y[r]), "row")


def test_a_non_counter_scalar_that_steers_a_loop(corpora):
    """f32_rowscale's counter is m (the engine's shape model); its n
    steers the inner loops, so the graph key holds n's values."""
    _, tk = corpora
    k = tk["f32_rowscale_ukernel"]
    reqs = []
    for m, n in ((1, 5), (2, 5), (3, 5), (2, 9)):
        rng = np.random.default_rng(m * 10 + n)
        x = rng.standard_normal(m * n).astype(np.float32)
        s = rng.standard_normal(m).astype(np.float32)
        reqs.append(Request(k, (m, n, x, s, np.zeros(m * n, np.float32))))
    eng = _engine(target="rvv-128", max_batch=4)
    for req, got in zip(reqs, eng.submit(reqs)):
        _bitwise(got, _direct(req, "rvv-128"), f"rowscale {req.args[:2]}")
    prog = next(iter(eng._programs.values()))
    assert prog._steering == {0, 1}
    assert eng.stats()["resilience"]["batch_faults"] == 0


STEERED = """
void f(size_t n, const int32_t* cnt, const float* x, float* y) {
  size_t m = (size_t) vgetq_lane_s32(vld1q_s32(cnt), 0);
  for (; m != 0; m -= 1) {
    *y = *x + 1.0f;
    x += 1; y += 1;
  }
}
"""


def test_loaded_data_that_steers_a_loop_does_not_batch():
    k = port.compile_kernel(STEERED)
    rows = [(4, np.array([m, 0, 0, 0], np.int32),
             np.arange(8, dtype=np.float32), np.zeros(8, np.float32))
            for m in (2, 5)]
    bf = k.compile(target="rvv-128", device="cpu").batched()
    cols = [np.array([4, 4])] + [torch.from_numpy(np.stack(
        [r[i] for r in rows])) for i in (1, 2, 3)]
    with pytest.raises(port.CompileError, match="does not batch"):
        bf(*cols)
    eng = _engine(target="rvv-128", max_batch=4)
    res = eng.submit([Request(k, r) for r in rows])
    for r, got in zip(rows, res):
        _bitwise(got, k.compile(target="rvv-128", device="cpu")(*r),
                 "steered")
    st = eng.stats()["resilience"]
    assert st["batch_faults"] == 1 and st["row_fallbacks"] == 2


def _columns(fn, rows):
    """Rows of one kernel's args as the batched walk takes them: each
    buffer zero-padded to the longest row, scalars as host vectors."""
    cols, padded_rows = [], [list(r) for r in rows]
    for i, p in enumerate(fn.params):
        if type(p.type).__name__ != "PtrType":
            cols.append(np.asarray([r[i] for r in rows]))
            continue
        L = max(len(r[i]) for r in rows)
        col = np.zeros((len(rows), L), np.asarray(rows[0][i]).dtype)
        for j, r in enumerate(rows):
            col[j, :len(r[i])] = r[i]
            padded_rows[j][i] = col[j].copy()
        cols.append(torch.from_numpy(col))
    return cols, padded_rows


@pytest.mark.parametrize("name", ["biased_dot", "add2x", "addswap",
                                  "dot2x", "upcount", "branch",
                                  "branch_vec", "ternary"])
def test_hand_written_kernels_batch_row_by_row(name):
    """The strip shapes and the scalar control of test_torch_compile.py's
    hand-written kernels (branches on device data, a select, an upward
    counter) through the batched walk: each row is the direct compiled
    call on that row's padded buffers, bitwise."""
    from test_torch_compile import EDGES, _edge_args
    from test_torch_revec import SOURCES
    k = port.compile_kernel({**SOURCES, **EDGES}[name])
    rows = []
    for seed in range(5):
        args = list(_edge_args(name, seed))
        if name in EDGES:
            args[0] = seed + 1          # ragged counts where n steers
        rows.append(tuple(args))
    for target in ("rvv-128", "rvv-1024"):
        for revec in (False, True):
            ck = k.compile(target=target, revec=revec, device="cpu")
            cols, padded_rows = _columns(k.fn, rows)
            outs = ck.batched()(*cols)
            for r, args in enumerate(padded_rows):
                want = ck(*args)
                want = want if isinstance(want, tuple) else (want,)
                for o, w in zip(outs, want, strict=True):
                    assert torch.equal(o[r], w), (name, target, revec, r)


@pytest.mark.parametrize("name", ["xnn_f32_vadd_ukernel", "bitreverse_u8",
                                  "qs8_vmlal_dot_ukernel",
                                  "u8_rgbx_deinterleave_ukernel"])
def test_batched_lowerings_are_the_row_s(corpora, name):
    """Selection runs on the per-row shapes: each intrinsic site of the
    batched walk takes the tier an unbatched compile of a row takes."""
    _, tk = corpora
    case = {c.kernel: c for c in harness.cases(n=40, tail_n=43)}[name]
    args = case.make_args(np.random.default_rng(0))
    for target in ("rvv-128", "rvv-1024", "h100"):
        ck = tk[name].compile(target=target, revec=True, device="cpu")
        ck(*args)
        plan = next(iter(ck._call._plans.values()))
        row = {(low.op, low.tier) for low in plan.tape}
        cols, _ = _columns(ck.fn, [args, args])
        bf = ck.batched()
        bf(*cols)
        sites = next(iter(bf._plans.values())).sites.values()
        assert {(low.op, low.tier) for low in sites} == row, target
