"""The port's autotuner (``repro_torch.port.autotune``) against the JAX
package's ``repro.port.autotune``, on the CPU.

* Every test of ``tests/test_autotune.py`` on the port: the calibration
  fit and its install into the port's registry, the register-pressure
  LMUL model, the knob search, ``compile(tuned=True)``, decisions that
  survive a fresh process, IR fingerprints, corrupt caches that degrade
  to static costs, atomic recovery, and single-flight tuning.
* ``BENCH_autotune.json``'s deterministic parts: the calibration factors
  and ``fitted_on``, and every tuning decision (lmul, factor cap, tail,
  static and tuned retired counts) of the 24 corpus kernels at rvv-128
  and rvv-1024 with ``tune_n`` 256.  Its ``wall*`` columns are host times
  of the JAX package on a CPU and are not compared.
* The cache file: keys equal to the reference's for every corpus kernel,
  a file the reference wrote read by the port, and the port's own
  variable ``REPRO_TORCH_AUTOTUNE_CACHE`` (it never writes the file that
  ``REPRO_AUTOTUNE_CACHE`` names).
* ``tests/test_cost_calibration.py``'s customized-tier models on the
  port (the elementwise four are in ``test_torch_trace.py``).

Both packages install process-wide calibrations; every test starts and
ends with both uninstalled, so no calibrated registry leaks into another
test of the same worker.
"""
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(ROOT, "examples", "neon_corpus")
sys.path.insert(0, CORPUS)

import harness  # noqa: E402

from repro import port as jport  # noqa: E402
from repro.port import autotune as jautotune  # noqa: E402
from repro_torch import port, rvv  # noqa: E402
from repro_torch.core import targets, trace, use_target  # noqa: E402
from repro_torch.core.registry import REGISTRY  # noqa: E402
from repro_torch.port import autotune  # noqa: E402
from repro_torch.port.resilience import CacheCorruption, PortError  # noqa: E402

CASES = {c.kernel: c for c in harness.cases(n=64, tail_n=67)}
with open(os.path.join(ROOT, "BENCH_autotune.json")) as _f:
    BENCH = json.load(_f)


@pytest.fixture(autouse=True)
def _isolate_process_state():
    for mod in (autotune, jautotune):
        mod.reset_cache()
        mod.uninstall()
    yield
    for mod in (autotune, jautotune):
        mod.reset_cache()
        mod.uninstall()


def _kernel(name, pkg=port):
    case = CASES[name]
    return pkg.compile_file(os.path.join(CORPUS, case.file),
                            name=case.kernel)


def _args(name, seed=0):
    return CASES[name].make_args(np.random.default_rng(seed))


def _items(names, seed=0):
    return [(_kernel(n), _args(n, seed)) for n in names]


def _out(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# BENCH_autotune.json: the deterministic columns
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bench_run():
    """benchmarks/autotune_suite.py's calibrate + tune sweep on the port
    (tune_n 256, tail 259, seed 0 + i), in memory."""
    n, tail = BENCH["tune_n"], 259
    items = []
    for i, case in enumerate(harness.cases(n=n, tail_n=tail)):
        items.append((case, port.compile_file(
            os.path.join(CORPUS, case.file), name=case.kernel),
            case.make_args(np.random.default_rng(i))))
    cal = autotune.calibrate([(k, a) for _, k, a in items])
    cache = autotune.AutotuneCache(None)
    cache.set_calibration(cal)
    tuning = {t: {} for t in BENCH["targets"]}
    for case, k, args in items:
        for t in BENCH["targets"]:
            tuning[t][case.kernel] = cache.tune_or_get(k, args, t,
                                                       calibration=cal)
    return cal, tuning


def test_bench_calibration_is_the_committed_one(bench_run):
    cal, _ = bench_run
    assert {k: round(v, 4) for k, v in sorted(cal.factors.items())} == \
        BENCH["calibration"]["factors"]
    assert list(cal.fitted_on) == BENCH["calibration"]["fitted_on"]


@pytest.mark.parametrize("target", ["rvv-128", "rvv-1024"])
def test_bench_tuning_decisions_are_the_committed_ones(bench_run, target):
    _, tuning = bench_run
    rows = BENCH["tuning"][target]
    assert sorted(tuning[target]) == sorted(rows) and len(rows) == 24
    for name, d in tuning[target].items():
        want = rows[name]
        got = {"lmul": d.lmul, "factor_cap": d.factor_cap, "tail": d.tail,
               "static_retired": d.static, "tuned_retired": d.measured}
        assert got == {k: want[k] for k in got}, name
        assert (round(d.improvement, 3) if d.improvement else 1.0) == \
            want["retired_improvement"], name


# ---------------------------------------------------------------------------
# calibration (test_autotune.py)
# ---------------------------------------------------------------------------

def test_calibration_fit_install_uninstall():
    cal = autotune.calibrate(_items(["xnn_f32_vadd_ukernel",
                                     "xnn_f32_vmul_ukernel"]))
    assert cal.factors, "no factors fit"
    assert cal.fitted_on == autotune.CALIBRATION_TARGETS
    for op, f in cal.factors.items():
        assert f > 0, (op, f)
        assert cal.samples[op]["estimated"] > 0
    per = {"site": {"isa_op": next(iter(cal.factors)), "instrs": 80}}
    assert autotune.CalibrationModel.predict(cal, per, 4) * 4 == \
        pytest.approx(autotune.CalibrationModel.predict(cal, per, 1))
    # the same fit as the reference's on the same inputs
    jcal = jautotune.calibrate(
        [(_kernel(n, jport), _args(n)) for n in ("xnn_f32_vadd_ukernel",
                                                 "xnn_f32_vmul_ukernel")])
    assert cal.factors == jcal.factors and cal.samples == jcal.samples
    cal.install()
    try:
        got = trace.get_calibration()
        assert got is not None and got["factors"] == cal.factors
    finally:
        autotune.uninstall()
    assert trace.get_calibration() is None


def test_calibration_survives_cache_roundtrip(tmp_path):
    cal = autotune.calibrate(_items(["xnn_f32_vadd_ukernel"]))
    path = str(tmp_path / "at.json")
    autotune.AutotuneCache(path).set_calibration(cal)
    back = autotune.AutotuneCache(path, strict=True).calibration
    assert back is not None
    assert back.factors == cal.factors
    assert back.samples == cal.samples


# ---------------------------------------------------------------------------
# register-pressure LMUL model
# ---------------------------------------------------------------------------

def test_admissible_lmuls_respects_widening_emul_cap():
    assert autotune.admissible_lmuls(
        _kernel("xnn_f32_vadd_ukernel"), "rvv-128") == (1, 2, 4, 8)
    wide = _kernel("qs8_vaddl_requant_ukernel")
    assert autotune.width_scale(wide.fn) >= 2
    adm = autotune.admissible_lmuls(wide, "rvv-128")
    assert 8 not in adm and adm, adm
    assert targets.get_target("tpu-v5e").admissible_lmuls() == (1,)


@pytest.mark.parametrize("name", sorted(CASES))
def test_pressure_model_matches_the_reference(name):
    k, jk = _kernel(name), _kernel(name, jport)
    assert autotune.width_scale(k.fn) == jautotune.width_scale(jk.fn)
    assert autotune.live_vec_values(k.fn) == \
        jautotune.live_vec_values(jk.fn)
    for t in ("rvv-128", "rvv-1024"):
        assert autotune.admissible_lmuls(k, t) == \
            jautotune.admissible_lmuls(jk, t)


# ---------------------------------------------------------------------------
# the knob search
# ---------------------------------------------------------------------------

def test_tune_beats_static_and_conforms():
    name = "xnn_f32_vadd_ukernel"
    k, args = _kernel(name), _args(name)
    d = autotune.tune(k, args, "rvv-128")
    assert d.lmul in autotune.admissible_lmuls(k, "rvv-128")
    assert d.static is not None and d.measured is not None
    assert d.measured < d.static
    assert d.improvement > 1.0
    assert d.to_dict() == jautotune.tune(_kernel(name, jport), args,
                                         "rvv-128").to_dict()
    tgt = targets.with_lmul(targets.get_target("rvv-128"), d.lmul)
    out, _ = rvv.run(rvv.emit(k, tgt, factor_cap=d.factor_cap,
                              tail=d.tail), *args, with_counts=True)
    np.testing.assert_allclose(np.asarray(out),
                               CASES[name].reference(*args),
                               rtol=1e-5, atol=1e-6)


def test_tune_rejects_non_rvv_target():
    with pytest.raises(ValueError):
        autotune.tune(_kernel("xnn_f32_vadd_ukernel"),
                      _args("xnn_f32_vadd_ukernel"), "tpu-v5e")
    with pytest.raises(ValueError):
        autotune.tune(_kernel("xnn_f32_vadd_ukernel"),
                      _args("xnn_f32_vadd_ukernel"), "h100")


def test_tuned_decision_never_worse_than_static():
    name = "fold_halves_f32"
    k, args = _kernel(name), _args(name)
    d = autotune.tune(k, args, "rvv-128")
    assert d.measured <= d.static


def test_tuned_compile_applies_cached_decision(tmp_path):
    name = "xnn_f32_vadd_ukernel"
    k, args = _kernel(name), _args(name)
    cache = autotune.set_cache_path(str(tmp_path / "at.json"))
    d = cache.tune_or_get(k, args, "rvv-128")
    tuned = k.compile(target="rvv-128", revec=True, jit=False,
                      tuned=True, device="cpu")
    assert tuned.target.lmul == d.lmul
    assert tuned.tail == d.tail
    np.testing.assert_allclose(_out(tuned(*args)),
                               CASES[name].reference(*args),
                               rtol=1e-5, atol=1e-6)
    other = _kernel("xnn_f32_vmul_ukernel")
    plain = other.compile(target="rvv-128", revec=True, jit=False,
                          tuned=True, device="cpu")
    assert plain.target.lmul == targets.get_target("rvv-128").lmul


# ---------------------------------------------------------------------------
# persistence, and the cache file the two packages share a format for
# ---------------------------------------------------------------------------

def test_decisions_survive_fresh_process(tmp_path):
    name = "xnn_f32_vadd_ukernel"
    k, args = _kernel(name), _args(name)
    path = str(tmp_path / "autotune.json")
    d = autotune.AutotuneCache(path).tune_or_get(k, args, "rvv-128")
    prog = f"""
import json, os
from repro_torch import port
from repro_torch.port import autotune
k = port.compile_file(os.path.join({CORPUS!r}, "vadd.c"),
                      name="xnn_f32_vadd_ukernel")
c = autotune.AutotuneCache({path!r}, strict=True)
assert c.load_error is None
d = c.get(k, "rvv-128")
assert d is not None, "decision lost across process restart"
print(json.dumps(d.to_dict()))
"""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", prog], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1]) == d.to_dict()


@pytest.mark.parametrize("target", ["rvv-128", "rvv-1024", "rvv-128-m4"])
def test_cache_keys_are_the_reference_s(target):
    for name in sorted(CASES):
        k, jk = _kernel(name), _kernel(name, jport)
        assert autotune.AutotuneCache.key(k, target) == \
            jautotune.AutotuneCache.key(jk, target)


def test_port_reads_the_reference_s_cache_file(tmp_path):
    path = str(tmp_path / "shared.json")
    jcache = jautotune.AutotuneCache(path)
    want = {}
    for name in ("xnn_f32_vadd_ukernel", "bitreverse_u8"):
        want[name] = jcache.tune_or_get(_kernel(name, jport), _args(name),
                                        "rvv-128")
    got = autotune.AutotuneCache(path, strict=True)
    assert got.load_error is None
    for name, d in want.items():
        assert got.get(_kernel(name), "rvv-128").to_dict() == d.to_dict()
    autotune.set_cache_path(path)
    tuned = _kernel("bitreverse_u8").compile(
        target="rvv-128", revec=True, tuned=True, device="cpu")
    assert tuned.target.lmul == want["bitreverse_u8"].lmul
    assert tuned.tail == want["bitreverse_u8"].tail


def test_port_keeps_its_own_cache_variable(tmp_path, monkeypatch):
    theirs = tmp_path / "reference.json"
    mine = tmp_path / "port.json"
    monkeypatch.setenv(jautotune.CACHE_ENV, str(theirs))
    monkeypatch.delenv(autotune.CACHE_ENV, raising=False)
    assert autotune.CACHE_ENV == "REPRO_TORCH_AUTOTUNE_CACHE"
    assert autotune.cache().path is None            # memory only
    name = "xnn_f32_vadd_ukernel"
    autotune.cache().tune_or_get(_kernel(name), _args(name), "rvv-128")
    assert not theirs.exists()
    autotune.reset_cache()
    monkeypatch.setenv(autotune.CACHE_ENV, str(mine))
    autotune.cache().tune_or_get(_kernel(name), _args(name), "rvv-128")
    assert mine.exists() and not theirs.exists()


def test_ir_fingerprint_orphans_stale_decisions(tmp_path):
    name = "xnn_f32_vadd_ukernel"
    k = _kernel(name)
    cache = autotune.AutotuneCache(str(tmp_path / "at.json"))
    cache.put(k, "rvv-128", autotune.TunedDecision(lmul=8))
    assert cache.get(k, "rvv-128") is not None
    with open(os.path.join(CORPUS, "vadd.c")) as f:
        src = f.read()
    edited = src.replace("vaddq_f32(va, vb)", "vaddq_f32(vb, va)")
    assert edited != src
    other = port.compile_kernel(edited, name=name)
    assert cache.get(other, "rvv-128") is None


# ---------------------------------------------------------------------------
# corruption: typed failure, static degradation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("payload", [
    "not json at all {{{",
    '{"version": 999, "entries": {}}',
    '{"version": 1, "entries": {"k": {"lmul": 16}}}',
    "",
], ids=["garbage", "wrong-version", "bad-lmul", "truncated-empty"])
def test_corrupt_cache_degrades_to_static(tmp_path, payload):
    path = str(tmp_path / "bad.json")
    with open(path, "w") as f:
        f.write(payload)
    c = autotune.AutotuneCache(path)
    assert isinstance(c.load_error, CacheCorruption)
    assert isinstance(c.load_error, PortError)
    assert c.stats()["load_error"]
    assert c.get(_kernel("xnn_f32_vadd_ukernel"), "rvv-128") is None
    with pytest.raises(CacheCorruption):
        autotune.AutotuneCache(path, strict=True)


def test_corrupt_cache_never_breaks_tuned_compile(tmp_path):
    path = str(tmp_path / "bad.json")
    with open(path, "w") as f:
        f.write('{"version":')
    autotune.set_cache_path(path)
    name = "xnn_f32_vadd_ukernel"
    k, args = _kernel(name), _args(name)
    tuned = k.compile(target="rvv-128", revec=True, jit=False,
                      tuned=True, device="cpu")
    assert tuned.target.lmul == targets.get_target("rvv-128").lmul
    np.testing.assert_allclose(_out(tuned(*args)),
                               CASES[name].reference(*args),
                               rtol=1e-5, atol=1e-6)


def test_recovery_overwrites_corrupt_file(tmp_path):
    path = str(tmp_path / "bad.json")
    with open(path, "w") as f:
        f.write("garbage")
    c = autotune.AutotuneCache(path)
    assert c.load_error is not None
    c.put(_kernel("xnn_f32_vadd_ukernel"), "rvv-128",
          autotune.TunedDecision(lmul=4))
    healed = autotune.AutotuneCache(path, strict=True)
    assert healed.load_error is None
    assert len(healed._entries) == 1


# ---------------------------------------------------------------------------
# concurrency: single-flight tuning, thread-safe warmup
# ---------------------------------------------------------------------------

def test_tune_or_get_is_single_flight(tmp_path, monkeypatch):
    name = "xnn_f32_vadd_ukernel"
    k, args = _kernel(name), _args(name)
    cache = autotune.AutotuneCache(str(tmp_path / "at.json"))
    calls = []
    gate = threading.Event()
    real_tune = autotune.tune

    def slow_tune(*a, **kw):
        calls.append(threading.get_ident())
        gate.wait(timeout=30)
        return real_tune(*a, **kw)

    monkeypatch.setattr(autotune, "tune", slow_tune)
    results, errors = [], []

    def worker():
        try:
            results.append(cache.tune_or_get(k, args, "rvv-128"))
        except Exception as e:           # noqa: BLE001 — test harness
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    while not calls:
        pass
    gate.set()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    assert len(calls) == 1
    assert len(results) == 8 and all(r == results[0] for r in results)
    assert cache.stats()["inflight"] == 0


def test_concurrent_tuned_warmup(tmp_path):
    from repro_torch.serve import PortEngine
    names = ["xnn_f32_vadd_ukernel", "xnn_f32_vmul_ukernel"]
    cache = autotune.set_cache_path(str(tmp_path / "at.json"))
    for n in names:
        cache.tune_or_get(_kernel(n), _args(n), "rvv-128")
    corpus = {n: _kernel(n) for n in names}
    errors = []

    def worker():
        try:
            PortEngine(target="rvv-128", tuned=True,
                       device="cpu").warmup(corpus)
        except Exception as e:           # noqa: BLE001 — test harness
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors, errors
    d = cache.get(_kernel(names[0]), "rvv-128")
    tuned = _kernel(names[0]).compile(target="rvv-128", revec=True,
                                      jit=False, tuned=True, device="cpu")
    assert tuned.target.lmul == d.lmul


# ---------------------------------------------------------------------------
# tests/test_cost_calibration.py's customized-tier models on the port
# ---------------------------------------------------------------------------

def test_vrbit_customized_model_exact():
    low = REGISTRY.lowering("vrbit", "pallas")
    x = torch.zeros((512,), dtype=torch.uint8)
    with use_target("rvv-512"):
        vregs = x.numel() // trace.vreg_for(x.dtype)
        traced = trace.fx_vector_instrs(low.fn, x, scalarize=False,
                                        union_overhead=False)
        declared = int(low.cost(x))
    assert traced == declared == 15 * vregs


def test_vceq_customized_model_calibrated():
    low = REGISTRY.lowering("vceq", "pallas")
    x = torch.zeros((512,), dtype=torch.int32)
    with use_target("rvv-512"):
        vregs = x.numel() // trace.vreg_for(x.dtype)
        traced = trace.fx_vector_instrs(low.fn, x, x, scalarize=False,
                                        union_overhead=False)
        declared = int(low.cost(x, x))
    assert declared == 3 * vregs
    assert 0.5 <= traced / declared <= 2.0
