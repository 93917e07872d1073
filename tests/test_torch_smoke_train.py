"""``chip_smoke.py``'s training-phase helpers, on the CPU.

The card runs ``train_phase`` (zamba2-1.2b at full width and depth),
``train_grad_phase``, ``train_archs_phase``, ``train_resume_phase`` and
``guard_phase``.  Here: the exact launch counts ``train_want`` gates a
train step on, held to the Function calls (and ssd's launches a call) of
a reduced zamba2 step under the kernel tier; the graph walk that finds
the Functions; the one-pattern-unit cut of every served arch; the
per-leaf gradient gate, the float64 witness of Mamba2's A_log and its
gate, the float32 gate and the bf16 step-0 gate against each of
``tools/train_grad_probe.py``'s planted faults; the train step's
span markers and the reading of each kernel under its span; and the
three phases that need no CUDA event,
run whole on the reduced configs (``get_config`` swapped for the test)
under ``policy="pallas"``: the gradient gate, every arch's train step
with granite's and deepseek's routing pinned across remat's recompute,
and checkpoint and restart.
"""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
import repro_torch.configs as configs  # noqa: E402
from repro_torch.configs import ARCH_NAMES, get_config  # noqa: E402
from repro_torch.core import use_policy  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.kernels import elementwise as ew  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import gemm as gemm_mod  # noqa: E402
from repro_torch.kernels import ssd as ssd_mod  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.train import loop  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture
def reduced(monkeypatch):
    """get_config returns each arch reduced, for the phases' own
    get_config calls."""
    full = configs.get_config
    monkeypatch.setattr(configs, "get_config",
                        lambda name: full(name).reduced())


def _counting(monkeypatch):
    """Count the calls of each kernel entry (on the card, one call is one
    launch; ssd's is ``ssd.launches(s)``)."""
    calls = {}
    for mod, name in ((gemm_mod, "gemm"), (ew, "vtanh"), (ew, "vsigmoid"),
                      (fa, "flash_attention"), (ssd_mod, "ssd")):
        entry = getattr(mod, name)

        def counted(*a, _entry=entry, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _entry(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    return calls


@pytest.mark.parametrize("seq,accum", [(64, 1), (300, 2)])
def test_train_want_counts_a_steps_kernel_calls(monkeypatch, seq, accum):
    """A reduced zamba2 step under the kernel tier calls each kernel
    entry as often as train_want's launches say: the forward, remat's
    recompute, and gemm's two backward products."""
    cfg = get_config("zamba2-1.2b").reduced().replace(dtype="float32")
    params = loop.trainable(M.init(cfg, torch.Generator().manual_seed(0),
                                   CPU))
    opt = loop.adamw.init(params)
    calls = _counting(monkeypatch)
    batch = SyntheticLM(cfg.vocab_size, seq, 2).batch(0, device=CPU)
    with use_policy("pallas"):
        loop.make_train_step(cfg, loop.TrainConfig(accum=accum))(
            params, opt, None, batch)
    want = cs.train_want(cfg, seq, accum)
    assert calls["gemm"] == want["gemm"] > 0
    assert calls["vtanh"] == want["vtanh"] > 0
    assert calls["flash_attention"] == want["flash_attention"] > 0
    assert calls["ssd"] * ssd_mod.launches(seq) == want["ssd"] > 0
    assert "vsigmoid" not in calls and want["vsigmoid"] == 0


def test_graph_functions_finds_the_kernels_functions():
    cfg = get_config("zamba2-1.2b").reduced().replace(dtype="float32")
    params = loop.trainable(M.init(cfg, torch.Generator().manual_seed(0),
                                   CPU))
    batch = SyntheticLM(cfg.vocab_size, 16, 2).batch(0, device=CPU)
    with use_policy("pallas"):
        loss, _ = loop.loss_fn(params, cfg, batch)
    names = cs.graph_functions(loss.grad_fn)
    assert {"GemmFnBackward", "VtanhFnBackward", "FlashAttentionFnBackward",
            "SsdFnBackward"} <= names
    with use_policy("vector"):
        loss, _ = loop.loss_fn(params, cfg, batch)
    assert not any(n.endswith("FnBackward")
                   for n in cs.graph_functions(loss.grad_fn))


# arch -> layers of its prefix and one pattern unit
UNIT = {"zamba2-1.2b": 6, "granite-moe-1b-a400m": 1,
        "deepseek-v2-lite-16b": 2, "minicpm3-4b": 1, "gemma2-2b": 2,
        "gemma3-1b": 6, "whisper-tiny": 1}


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_one_unit_keeps_the_prefix_and_one_unit(arch):
    full = get_config(arch)
    cfg = cs.one_unit(full)
    prefix, unit, reps, rem = cfg.pattern_unit()
    assert cfg.n_layers == UNIT[arch] == len(prefix) + len(unit)
    assert (reps, rem) == (1, [])
    assert cfg.layer_pattern() == full.layer_pattern()[:cfg.n_layers]
    assert cfg.n_enc_layers == full.n_enc_layers
    assert cfg.d_model == full.d_model


def test_held_grads_gates_each_leaf():
    w = [torch.tensor([1.0, -2.0, 0.0]), torch.tensor([1e-3, 0.0])]
    names = ["a", "b"]
    got = cs.held_grads([x * (1 + 1e-5) for x in w], w, names, 2e-4, "t")
    # each leaf's error over its own max |g|
    assert got["a"] == pytest.approx(1e-5, rel=1e-2) and \
        got["b"] == pytest.approx(1e-5, rel=1e-2)
    with pytest.raises(AssertionError, match="b's gradient differs"):
        cs.held_grads([w[0], w[1] * 1.01], w, names, 2e-4, "t")
    cs.held_grads([w[0], w[1] * 1.01], w, names, 2e-4, "t", gate=False)
    with pytest.raises(AssertionError, match="zero where"):
        cs.held_grads([w[0], torch.zeros(2)], w, names, 2e-4, "t")
    cs.held_grads([w[0], torch.zeros(2)], w, names, 2e-4, "t", gate=False)
    with pytest.raises(AssertionError, match="not finite"):
        cs.held_grads([w[0], w[1] / 0], w, names, 2e-4, "t", gate=False)
    with pytest.raises(AssertionError, match="no gradient"):
        cs.held_grads([w[0], None], w, names, 2e-4, "t")


def test_port_kernel_ms_groups_the_profile_by_op():
    got = cs.port_kernel_ms({
        "void (anonymous namespace)::mma::mma_kernel<true>(CU": 2.0,
        "void ssd_state_kernel<bf16>": 1.0, "ssd_out_kernel": 0.5,
        "void vtanh_kernel<bf16>": 0.25,
        "void at::native::vectorized_elementwise_kernel": 9.0})
    assert got == {"gemm": 2.0, "vtanh": 0.25, "vsigmoid": 0.0,
                   "flash_attention": 0.0, "ssd": 1.5}


def test_train_grad_phase_runs_reduced(reduced):
    with use_policy("pallas"):
        out = cs.train_grad_phase(CPU)
    f32 = out["float32"]
    assert f32["failures"] == [] and f32["max_gated"] <= 2e-4
    # reduced zamba2: 47 leaves, four of them Mamba2 A_log
    assert f32["leaves"] == 47 and len(f32["a_log_witness"]) == 4
    assert "failures" not in out["bfloat16"]


def test_train_archs_phase_runs_reduced(reduced, monkeypatch):
    """Every other served arch's train step, each leaf within LM_TOL's
    float32 2e-4 of the vector tier's, the MoE archs' routing pinned."""
    monkeypatch.setattr(cs, "TRAIN_ARCH_TRAFFIC", dict(batch=2, seq=64))
    with use_policy("pallas"):
        rows = cs.train_archs_phase(CPU)
    assert set(rows) == set(cs.TRAIN_ARCHS)
    for arch, row in rows.items():
        assert row["max_rel_leaf_err"] <= 2e-4, arch
        assert "GemmFnBackward" in row["functions"], arch
        assert (row["aux"] > 0) == (row["router_calls"] > 0), arch
    assert rows["granite-moe-1b-a400m"]["router_calls"] > 0
    assert "VsigmoidFnBackward" in rows["minicpm3-4b"]["functions"]


def test_train_resume_phase_runs_reduced(reduced, monkeypatch):
    """A restart from the checkpoint before the injected failure, the
    params restored bitwise, the losses those of an uninterrupted run."""
    monkeypatch.setattr(cs, "TRAIN_RESUME", dict(
        batch=2, seq=64, steps=6, ckpt_every=2, fail_at=4))
    with use_policy("pallas"):
        rec = cs.train_resume_phase(CPU)
    assert rec["restarts"] == 1 and rec["latest_step"] == 5
    assert rec["params_restored_bitwise"] and rec["max_rel_loss_gap"] <= 1e-6
    assert {s for s, _ in rec["losses"]} == set(range(6))
    assert rec["saves"] and all(sv["bytes"] > 0 for sv in rec["saves"])


def test_held_grads_exempts_only_from_the_tolerance():
    w = [torch.tensor([1.0, -2.0]), torch.tensor([1e-3, 0.5])]
    got = cs.held_grads([w[0], w[1] * 1.01], w, ["a", "b"], 2e-4, "t",
                        exempt=["b"])
    assert got["b"] == pytest.approx(1e-2, rel=1e-3)
    with pytest.raises(AssertionError, match="zero where"):
        cs.held_grads([w[0], torch.zeros(2)], w, ["a", "b"], 2e-4, "t",
                      exempt=["b"])


def test_witnessed_holds_the_kernel_tier_to_the_float64_gradient():
    exact = {"x": torch.tensor([1.0, -2.0], dtype=torch.float64)}
    near = {"x": torch.tensor([1.0, -2.0004])}
    far = {"x": torch.tensor([1.0, -2.0012])}
    rows, bad = cs.witnessed(near, far, exact, 2e-4, "t")
    assert rows["x"] == {"kernel": pytest.approx(2e-4, rel=1e-3),
                         "vector": pytest.approx(6e-4, rel=1e-3)}
    assert bad == []
    # further than the vector tier by more than the tolerance
    _, bad = cs.witnessed(far, near, exact, 2e-4, "t")
    assert bad and "x's gradient" in bad[0]


def test_float64_grads_runs_the_vector_tier_in_float64_alone():
    """No op of the witness's run gives a float32 or bf16 tensor (but the
    params' own detach), and its gradients sit within float32 rounding of
    the vector tier's."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Narrow(TorchDispatchMode):
        seen = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for o in out if isinstance(out, (tuple, list)) else [out]:
                if isinstance(o, torch.Tensor) and o.dtype in (
                        torch.float32, torch.bfloat16):
                    self.seen.add(str(func))
            return out
    cfg = get_config("zamba2-1.2b").reduced().replace(dtype="float32")
    params = loop.trainable(M.init(cfg, torch.Generator().manual_seed(0),
                                   CPU))
    batch = SyntheticLM(cfg.vocab_size, 32, 2).batch(0, device=CPU)
    names = cs.leaf_names(params)
    with Narrow() as mode:
        exact = cs.float64_grads(cfg, params, batch, names)
    assert mode.seen == {"aten.detach.default"}
    _, _, plain = cs.grads_of(cfg, params, batch, "vector")
    for name, g in zip(names, plain):
        assert exact[name].dtype == torch.float64
        scale = float(exact[name].abs().max())
        assert float((g.double() - exact[name]).abs().max()) <= 1e-5 * scale
    # the modules' torch is theirs again
    assert cs.np is not None and all(
        __import__(m, fromlist=["_"]).torch is torch for m in cs.TWIN_MODULES)


def _probe():
    sys.path.insert(0, str(cs.ROOT / "tools"))
    import train_grad_probe
    return train_grad_probe


@pytest.mark.parametrize("fault", [None, *_probe().FAULTS])
def test_grad_gate_fails_each_planted_fault(fault):
    """The float32 gate on a reduced zamba2 passes sound and fails each of
    the probe's planted faults (gemm's operands rounded to bf16, ssd's dt
    gradient dropped, its D gradient 1.5x)."""
    cfg = get_config("zamba2-1.2b").reduced().replace(dtype="float32")
    params = loop.trainable(M.init(cfg, torch.Generator().manual_seed(0),
                                   CPU))
    batch = SyntheticLM(cfg.vocab_size, 64, 2).batch(0, device=CPU)
    names = cs.leaf_names(params)
    vector = cs.grads_of(cfg, params, batch, "vector")[::2]
    exact = cs.float64_grads(cfg, params, batch, cs.a_log_leaves(names))
    restore = _probe().planted(fault) if fault else None
    try:
        with use_policy("pallas"):
            kernel = cs.grads_of(cfg, params, batch, "pallas")[::2]
    finally:
        if restore:
            setattr(*restore)
    record, failures = cs.grad_gate(kernel, vector, exact, names, "t")
    assert bool(failures) == (fault is not None), record
    assert set(record["a_log_witness"]) == set(cs.a_log_leaves(names))


@pytest.mark.parametrize("fault", [None, "ssd_no_dt", "ssd_dD_x1.5"])
def test_step0_gate_fails_each_planted_fault(fault):
    """The bf16 step-0 gate on a reduced zamba2 step (8 rows: the kernel
    tier in the step's two microbatches, the vector tier two rows at a
    time) passes sound and fails a small leaf's gradient dropped (dt_bias)
    or scaled (D), which move the loss and the global norm too little."""
    cfg = get_config("zamba2-1.2b").reduced()
    params = loop.trainable(M.init(cfg, torch.Generator().manual_seed(0),
                                   CPU))
    batch = SyntheticLM(cfg.vocab_size, 64, cs.TRAIN["batch"]).batch(
        0, device=CPU)
    vector = cs.mean_grads(cfg, params, batch, cs.TRAIN["batch"] // 2,
                           "vector")
    restore = _probe().planted(fault) if fault else None
    try:
        with use_policy("pallas"):
            kernel = cs.mean_grads(cfg, params, batch, cs.TRAIN["accum"],
                                   "pallas")
    finally:
        if restore:
            setattr(*restore)
    record, failures = cs.step0_gate(kernel, vector, cs.leaf_names(params),
                                     "t")
    assert bool(failures) == (fault is not None), record
    assert record["leaves"] == 47
    # the loss and the global norm alone pass every one of them
    assert max(record["rel_gap"].values()) < cs.TRAIN_TOL
    # the step's own reported loss and norm are held too
    off = {"loss": record["vector_loss"] * 1.05,
           "grad_norm": record["vector_grad_norm"]}
    _, failures = cs.step0_gate(kernel, vector, cs.leaf_names(params), "t",
                                reported=off)
    assert any("step_loss" in f for f in failures)


def test_mean_grads_is_the_train_steps_gradient():
    """mean_grads in two blocks of rows equals the mean of the blocks'
    gradients, and (float32) the gradient of the whole batch at once."""
    cfg = get_config("zamba2-1.2b").reduced().replace(dtype="float32")
    params = loop.trainable(M.init(cfg, torch.Generator().manual_seed(0),
                                   CPU))
    batch = SyntheticLM(cfg.vocab_size, 32, 4).batch(0, device=CPU)
    loss, grads = cs.mean_grads(cfg, params, batch, 2, "vector")
    whole, _, want = cs.grads_of(cfg, params, batch, "vector")
    assert loss == pytest.approx(whole, rel=1e-6)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-7)


def test_span_kernel_ms_reads_each_kernel_under_its_innermost_range():
    """Each kernel is read under the innermost span open at it, the
    marker kernels matched to the marks in order: a block in the forward
    is the forward's, one in the backward (inside gemm's backward, where
    remat unpacks its saved tensors) the recompute's; split into the
    port's kernels and torch's; a marker missing from the profile
    raises."""
    from types import SimpleNamespace as NS

    clock = [0.0]

    def ev(name, us, device="DeviceType.CUDA"):
        start = clock[0]
        clock[0] += us + 1.0
        return NS(name=name, device_type=device,
                  time_range=NS(start=start, elapsed_us=lambda: us))

    def mark():
        return ev("spin_kernel(long)", 1.0)
    marks = [("forward", True), ("block", True), ("block", False),
             ("forward", False), ("gemm_backward", True), ("block", True),
             ("block", False), ("gemm_backward", False)]
    events = [mark(), ev("indexSelect", 500.0), mark(),
              ev("mma::mma_kernel<true>", 2000.0), mark(), mark(),
              ev("vectorized_elementwise", 125.0),
              ev("cudaLaunchKernel", 7.0, device="DeviceType.CPU"),
              mark(), mark(), ev("ssd_state_kernel", 1000.0),
              ev("elementwise", 250.0), mark(),
              ev("bfloat16_copy_kernel", 750.0), mark()]
    events = events[::-1]        # the profile's order is not the device's
    got = cs.span_kernel_ms(events, marks)
    assert got["forward"] == {"port": 2.0, "torch": 0.5}
    assert got["recompute"] == {"port": 1.0, "torch": 0.25}
    assert got["gemm_backward"] == {"port": 0.0, "torch": 0.75}
    assert got["other"] == {"port": 0.0, "torch": 0.125}
    assert got["update"] == got["ssd_backward"] == {"port": 0.0,
                                                    "torch": 0.0}
    assert "block" not in got
    with pytest.raises(AssertionError, match="marker kernels"):
        cs.span_kernel_ms(events[1:], marks)


def test_marks_swapped_marks_the_train_spans_and_restores_them():
    """The train step's markers go around module functions and the
    Functions' backward alike, and come off again."""
    import importlib
    before = {}
    for _, mod, attr in cs.TRAIN_SPANS:
        owner = importlib.import_module(mod)
        if "." in attr:
            cls, attr = attr.split(".")
            owner = getattr(owner, cls)
        before[(owner, attr)] = owner.__dict__[attr]
    saved = cs.marks_swapped([])
    try:
        assert all(owner.__dict__[attr] is not held
                   for (owner, attr), held in before.items())
        assert isinstance(gemm_mod.GemmFn.__dict__["backward"],
                          staticmethod)
    finally:
        for owner, attr, held in saved:
            setattr(owner, attr, held)
    assert all(owner.__dict__[attr] is held
               for (owner, attr), held in before.items())
