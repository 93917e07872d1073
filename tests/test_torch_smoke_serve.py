"""``chip_smoke.py``'s serving-phase helpers, on the CPU.

The card runs ``serve_arch`` for zamba2-1.2b, granite-moe-1b-a400m,
deepseek-v2-lite-16b, minicpm3-4b, gemma2-2b, gemma3-1b and whisper-tiny,
and again for the gemmas at prompts longer than their windows
(``SERVE_WINDOW``; ``tools/serve_gap_probe.py`` also for the held
mamba2-1.3b and pixtral-12b); what it gates on is made here from the configs alone: the
ops each arch's layers reach (``serve_ops``: the ``local``, ``enc`` and
``dec`` kinds attend), the tier each must run (``serve_tier``: MLA's
split-dim attention on the vector tier) and the exact launches of the LM
kernels in one ``Engine.generate`` of 32 tokens after 512-token prompts
(``serve_want``: whisper's encoder and cross-attention as flash launches,
at prefill and at every decode step).  The router probe that pins granite's vector run to
the kernel run's routing (``route_probe``), the flip count beside it
(``route_flips``), and the block probe that starts each block of a bf16
vector run from the kernel run's input (``block_probe``, with the
per-block measure ``stream_gaps``) run here on the reduced models, MLA's
``moe_dense``, ``moe`` and ``attn`` blocks among them, as does the
profiler span swap (``spans_swapped``).
"""
import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config, mamba2_1p3b, \
    pixtral_12b  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as MoE  # noqa: E402

# arch -> (ops, {ssd, flash, decode launches}) at 4 x 512 + 32 tokens
WANT = {"zamba2-1.2b": (("gemm", "vtanh", "attention", "decode_attention",
                         "ssd"), (76, 6, 186)),
        "mamba2-1.3b": (("gemm", "ssd"), (96, 0, 0)),
        "granite-moe-1b-a400m": (("gemm", "vsigmoid", "attention",
                                  "decode_attention"), (0, 24, 744)),
        # MLA: no flash (split head dims) and no decode launch (the
        # absorbed decode dispatches no attention op)
        "deepseek-v2-lite-16b": (("gemm", "vsigmoid", "attention"),
                                 (0, 0, 0)),
        "minicpm3-4b": (("gemm", "vsigmoid", "attention"), (0, 0, 0)),
        "gemma2-2b": (("gemm", "vtanh", "attention", "decode_attention"),
                      (0, 26, 806)),
        "gemma3-1b": (("gemm", "vtanh", "attention", "decode_attention"),
                      (0, 26, 806)),
        # 4 encoder + 4 self + 4 cross launches in the prefill, then 4
        # cross launches (flash) and 4 self (decode) a step
        "whisper-tiny": (("gemm", "vtanh", "attention", "decode_attention"),
                         (0, 136, 124)),
        "pixtral-12b": (("gemm", "vsigmoid", "attention",
                         "decode_attention"), (0, 40, 1240))}


# held: get_config refuses them (ROADMAP C.22, C.23); the gap probe
# serves them on the card
HELD = {m.CONFIG.name: m.CONFIG for m in (mamba2_1p3b, pixtral_12b)}


def _config(arch):
    """A held arch's config from its module, else ``get_config``'s."""
    return HELD[arch] if arch in HELD else get_config(arch)


@pytest.mark.parametrize("arch", sorted(WANT))
def test_serve_ops_and_launch_counts(arch):
    cfg = _config(arch)
    ops_, (ssd, flash, decode) = WANT[arch]
    assert cs.SERVE == dict(batch=4, prompt=512, gen=32)
    assert cs.serve_ops(cfg) == ops_
    assert cs.serve_want(cfg, cs.SERVE["prompt"], cs.SERVE["gen"]) == {
        "ssd": ssd, "flash_attention": flash, "decode_attention": decode}
    assert (arch in cs.SERVE_ARCHS) == (arch not in HELD)


@pytest.mark.parametrize("arch", sorted(WANT))
def test_serve_tier_leaves_split_dim_attention_to_the_vector_tier(arch):
    cfg = _config(arch)
    tiers = {op: cs.serve_tier(cfg, op) for op in cs.serve_ops(cfg)}
    mla = cfg.attn_kind == "mla"
    assert tiers == {op: "vector" if mla and op == "attention" else "pallas"
                     for op in WANT[arch][0]}
    assert mla == (arch in ("deepseek-v2-lite-16b", "minicpm3-4b"))


def _granite(seed=0):
    cfg = get_config("granite-moe-1b-a400m").reduced().replace(
        dtype="float32")
    params = M.init(cfg, torch.Generator().manual_seed(seed), "cpu")
    return cfg, params


def test_route_probe_records_and_pins():
    cfg, params = _granite()
    p = params["unit"][0][0]["ffn"]
    xt = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (24, cfg.d_model)).astype(np.float32))
    probe, calls = cs.route_probe(MoE)
    gates, idx, aux = probe(p, xt, cfg)
    want = MoE._route(p, xt, cfg)
    for got, w in zip((gates, idx, aux), want):
        assert torch.equal(got, w)
    assert len(calls) == 1 and torch.equal(calls[0]["idx"], idx)
    probs = calls[0]["probs"]
    torch.testing.assert_close(probs.sum(-1), torch.ones(24))
    # pinned: another router routes by the recorded indices, with gates
    # from its own probabilities
    other = dict(p, router=p["router"].flip(-1))
    pin, pinned_calls = cs.route_probe(MoE, pinned=calls)
    g2, idx2, _ = pin(other, xt, cfg)
    assert torch.equal(idx2, idx)
    own = pinned_calls[0]["probs"].gather(1, idx)
    torch.testing.assert_close(g2, own / own.sum(-1, keepdim=True))
    assert not torch.equal(pinned_calls[0]["idx"], idx)  # its own top-k


def test_pinned_forward_reproduces_the_recorded_run():
    """A whole prefill through the probe, then again pinned to itself:
    the same logits, 0 flips and a 0 probability gap, one router call a
    layer."""
    cfg, params = _granite(1)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        2, cfg.vocab_size, (2, 10)))
    route = MoE._route
    runs = []
    try:
        for pinned in (None, "first"):
            probe, calls = cs.route_probe(
                MoE, pinned=runs[0][1] if pinned else None)
            MoE._route = probe
            logits, _, _ = M.forward(params, cfg, {"tokens": tokens},
                                  mode="train")
            MoE._route = route
            runs.append((logits, calls))
    finally:
        MoE._route = route
    assert torch.equal(runs[0][0], runs[1][0])
    got = cs.route_flips(runs[0][1], runs[1][1], cfg.top_k, "self")
    assert got["router_calls"] == cfg.n_layers
    assert got["tokens_routed"] == cfg.n_layers * 20
    assert got["flips"] == 0 and got["max_router_prob_gap"] == 0.0


def _call(probs, idx):
    return {"probs": torch.tensor(probs, dtype=torch.float32),
            "idx": torch.tensor(idx)}


def test_route_flips_accepts_a_near_tie_and_refuses_a_clear_margin():
    near = [_call([[0.40001, 0.39999, 0.2]], [[0]])], \
        [_call([[0.39999, 0.40001, 0.2]], [[1]])]
    got = cs.route_flips(*near, 1, "near")
    assert got["flips"] == 1 and got["max_flip_margin_over_gap"] <= 1.0
    # a flip across a clear margin with the same probabilities is no
    # rounding: the routing does not follow the router
    clear = [_call([[0.5, 0.3, 0.2]], [[0]])], \
        [_call([[0.5, 0.3, 0.2]], [[1]])]
    with pytest.raises(AssertionError, match="margin exceeds"):
        cs.route_flips(*clear, 1, "clear")
    with pytest.raises(AssertionError, match="router calls"):
        cs.route_flips(near[0] * 2, near[1], 1, "count")


def test_block_probe_pins_each_block_to_the_recorded_stream():
    """mamba2 reduced: a run records every block's input and output; a
    second run with one block's output projection scaled by 1.01, its
    blocks fed the first run's stream, differs at that block alone, and
    ``stream_gaps`` names it, reads the fault's 1% of the block's update
    (and raises below it)."""
    from repro_torch.models import blocks as B
    cfg = _config("mamba2-1.3b").reduced().replace(dtype="float32")
    params = M.init(cfg, torch.Generator().manual_seed(3), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        2, cfg.vocab_size, (2, 12)))
    apply = B.block_apply
    probe, calls = cs.block_probe(B)
    pin, pinned = cs.block_probe(B, pinned=calls)
    other = {**params, "unit": [list(u) for u in params["unit"]]}
    mamba = dict(other["unit"][0][2]["mamba"])
    mamba["w_out"] = mamba["w_out"] * 1.01
    other["unit"][0][2] = {**other["unit"][0][2], "mamba": mamba}
    try:
        B.block_apply = probe
        M.forward(params, cfg, {"tokens": tokens}, mode="train")
        B.block_apply = pin
        M.forward(other, cfg, {"tokens": tokens}, mode="train")
    finally:
        B.block_apply = apply
    assert len(calls) == len(pinned) == cfg.n_layers
    for i, (a, b) in enumerate(zip(calls, pinned)):
        assert b["x"] is a["x"]
        assert torch.equal(a["y"], b["y"]) == (i != 2)
    got = cs.stream_gaps(calls, pinned, 3e-2, "w_out")
    assert got["block_calls"] == cfg.n_layers
    assert got["worst_block_call"] == 2
    assert got["max_rel_block_err"] == pytest.approx(0.01, rel=1e-3)
    with pytest.raises(AssertionError, match="block call 2"):
        cs.stream_gaps(calls, pinned, got["max_rel_block_err"] / 2, "tight")


def test_stream_gaps_allows_one_rounding_step_of_the_output():
    """A block whose output sits on a residual 32 times its update: a
    bf16 output one rounding step (0.5 at 64) away from the other run's is
    no gap; two steps are one step over, a quarter of the update's max of
    2; float32's step there is 2^-16 of bf16's."""
    x = torch.full((2, 4), 64.0, dtype=torch.bfloat16)
    y = x + torch.tensor([[1.0, 2.0, 0.5, 0.0]] * 2, dtype=torch.bfloat16)
    step = cs.rounding_step(y)
    assert torch.equal(step, torch.full((2, 4), 0.5))
    assert torch.equal(cs.rounding_step(y.float()),
                       torch.full((2, 4), 2.0 ** -17))
    for n, want in ((1, 0.0), (2, 0.25)):
        other = [{"x": x, "y": y + n * step.to(torch.bfloat16)}]
        got = cs.stream_gaps([{"x": x, "y": y}], other, 1.0, "steps")
        assert got["max_rel_block_err"] == want
    with pytest.raises(AssertionError, match="update's max"):
        cs.stream_gaps([{"x": x, "y": y}], other, 0.2, "steps")


def test_teacher_logits_reproduce_the_engines_greedy_tokens():
    """granite reduced: the teacher-forced run over an Engine's own greedy
    tokens gives those tokens back as its argmax, over the vocabulary,
    calls the swapped-in router once a layer and step, and puts the
    package's functions back."""
    from repro_torch.models import blocks as B
    from repro_torch.serve.engine import Engine
    cfg, params = _granite(2)
    prompts = np.random.default_rng(2).integers(2, cfg.vocab_size, (2, 8))
    tokens = Engine(cfg, params, 2, 13, device="cpu").generate(prompts, 5)
    route, apply = MoE._route, B.block_apply
    probe, calls = cs.route_probe(MoE)
    got = cs.teacher_logits(cfg, params, prompts, tokens, 13,
                            torch.device("cpu"), "vector", route=probe)
    assert got.shape == (5, 2, cfg.vocab_size) and got.dtype == torch.float32
    assert torch.equal(got.argmax(-1).T, torch.from_numpy(tokens).long())
    assert len(calls) == cfg.n_layers * 5
    assert MoE._route is route and B.block_apply is apply


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "minicpm3-4b"])
def test_mla_teacher_runs_probe_every_block_and_router(arch):
    """The serving check's runs on an MLA arch, reduced, in float32: the
    kernel tiers' plain versions against the vector tier, the vector run
    routed by the kernel run's indices (deepseek) and each vector block
    fed the kernel block's input: every block call recorded (deepseek's
    ``moe_dense`` layer and its ``moe`` layers, minicpm3's ``attn``
    layers), every router call pinned, and the gaps within the gates."""
    from repro_torch.models import blocks as B
    from repro_torch.serve.engine import Engine
    cfg = get_config(arch).reduced().replace(dtype="float32")
    params = M.init(cfg, torch.Generator().manual_seed(4), "cpu")
    prompts = np.random.default_rng(4).integers(2, cfg.vocab_size, (2, 8))
    tokens = Engine(cfg, params, 2, 13, device="cpu").generate(prompts, 5)
    kinds = []
    apply = B.block_apply

    def seen(kind, *a):
        kinds.append(kind)
        return apply(kind, *a)
    moe = bool(cfg.n_experts)
    route, calls = cs.route_probe(MoE) if moe else (None, None)
    B.block_apply = seen            # the probe calls what it finds
    try:
        block, kblocks = cs.block_probe(B)
    finally:
        B.block_apply = apply
    run = functools.partial(cs.teacher_logits, cfg, params, prompts, tokens,
                            13, torch.device("cpu"))
    kern = run("pallas", route, block)
    assert kinds == cfg.layer_pattern() * 5
    assert ("moe_dense" in kinds) == moe and ("attn" in kinds) != moe
    pin = cs.route_probe(MoE, pinned=calls) if moe else (None, None)
    plain = run("vector", pin[0])
    held = cs.held_logits(kern, plain, cs.E2E_F32_TOL, "float32")
    assert held["greedy_agree"] == 1.0
    pin_block, vblocks = cs.block_probe(B, pinned=kblocks)
    run("vector", cs.route_probe(MoE, pinned=calls)[0] if moe else None,
        pin_block)
    gaps = cs.stream_gaps(kblocks, vblocks, cs.E2E_TOL, "float32")
    assert gaps["block_calls"] == cfg.n_layers * 5
    if moe:
        assert len(calls) == len(pin[1]) == (cfg.n_layers - 1) * 5
        flips = cs.route_flips(calls, pin[1], cfg.top_k, "float32")
        assert flips["router_calls"] == len(calls)


def test_spans_swapped_ranges_the_mla_functions_and_restores_them():
    """The profiler spans wrap prefill attention and MLA's absorbed decode
    in a range named after each (the CPU profiler sees them), and put the
    package's functions back."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    from repro_torch.models import attention as A
    cfg = get_config("minicpm3-4b").reduced().replace(dtype="float32")
    params = M.init(cfg, torch.Generator().manual_seed(5), "cpu")
    prompts = torch.from_numpy(np.random.default_rng(5).integers(
        2, cfg.vocab_size, (2, 6)))
    originals = (ops.attention, A._mla_absorbed)
    saved = cs.spans_swapped()
    try:
        assert (ops.attention, A._mla_absorbed) != originals
        assert [(m.__name__, a) for m, a, _ in saved] == [
            (mod, attr) for _, mod, attr in cs.SPANS]
        cache = M.init_cache(cfg, 2, 8, "cpu")
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _, cache, _ = M.forward(params, cfg, {"tokens": prompts},
                                    mode="prefill", cache=cache)
            M.forward(params, cfg, {"tokens": prompts[:, :1]},
                      mode="decode", cache=cache,
                      lengths=torch.full((2,), 6, dtype=torch.int32))
    finally:
        for m, attr, fn in saved:
            setattr(m, attr, fn)
    assert (ops.attention, A._mla_absorbed) == originals
    counts = {ev.key: ev.count for ev in prof.key_averages()}
    assert counts["attention"] == counts["mla_absorbed"] == cfg.n_layers


def test_window_traffic_outruns_the_windows_and_its_launch_counts():
    """``serve_window``: gemma3's 1024-token prompts are twice its 512
    window, gemma2's 4160 tokens pass its 4096 (and its vector tier's
    chunked attention, Sq x Sk > 2048^2); every layer attends, so one
    flash launch a layer and one decode launch a layer and later step."""
    got = {}
    for arch, traffic in cs.SERVE_WINDOW:
        cfg = get_config(arch)
        assert traffic["prompt"] > cfg.window
        got[arch] = cs.serve_want(cfg, traffic["prompt"], traffic["gen"])
    assert got == {"gemma3-1b": {"ssd": 0, "flash_attention": 26,
                                 "decode_attention": 26 * 31},
                   "gemma2-2b": {"ssd": 0, "flash_attention": 26,
                                 "decode_attention": 26 * 7}}
    assert dict(cs.SERVE_WINDOW)["gemma2-2b"]["prompt"] ** 2 > 2048 ** 2


def test_layer_labels_count_within_each_ctx():
    """A label per block call: its kind and its index among the calls made
    with one ctx, so that whisper's encoder and decoder stacks, and each
    forward, count from 0."""
    label = cs.layer_labels()
    enc, dec, step = object(), object(), object()
    got = [label(k, c) for k, c in (("enc", enc), ("enc", enc),
                                    ("dec", dec), ("dec", dec),
                                    ("dec", step), ("dec", step))]
    assert got == ["enc.0", "enc.1", "dec.0", "dec.1", "dec.0", "dec.1"]


def test_whisper_teacher_runs_pin_the_encoder_memory():
    """whisper reduced in float32 with its stub frames: the kernel tiers'
    plain versions against the vector tier, teacher forced.  Every block
    call is recorded (2 encoder blocks and 4 decoder blocks in the
    prefill, 4 decoder blocks a step), each ``dec`` call of the prefill
    with the encoder output it read; the pinned vector run reads the
    kernel run's encoder output there (the same tensor), and its gaps
    are within the gates."""
    from repro_torch.data.pipeline import extra_inputs
    from repro_torch.models import blocks as B
    from repro_torch.serve.engine import Engine
    cfg = get_config("whisper-tiny").reduced().replace(dtype="float32")
    params = M.init(cfg, torch.Generator().manual_seed(6), "cpu")
    prompts = np.random.default_rng(6).integers(2, cfg.vocab_size, (2, 8))
    extra = extra_inputs(cfg, 2, 0, "cpu")
    tokens = Engine(cfg, params, 2, 13, device="cpu").generate(prompts, 5,
                                                                 extra)
    run = functools.partial(cs.teacher_logits, cfg, params, prompts, tokens,
                            13, torch.device("cpu"), extra=extra)
    block, kblocks = cs.block_probe(B)
    kern = run("pallas", None, block)
    assert torch.equal(kern.argmax(-1).T, torch.from_numpy(tokens).long())
    layers = [c["layer"] for c in kblocks]
    assert layers == ["enc.0", "enc.1", "dec.0", "dec.1", "dec.2",
                      "dec.3"] + ["dec.0", "dec.1", "dec.2", "dec.3"] * 4
    mems = [c["memory"] for c in kblocks]
    assert all(m is not None and m.shape == (2, 8, cfg.d_model)
               for m in mems[2:6])
    assert all(m is mems[2] for m in mems[2:6])
    assert all(m is None for m in mems[:2] + mems[6:])
    plain = run("vector")
    held = cs.held_logits(kern, plain, cs.E2E_F32_TOL, "float32")
    assert held["greedy_agree"] == 1.0
    pin_block, vblocks = cs.block_probe(B, pinned=kblocks)
    run("vector", None, pin_block)
    assert [c["layer"] for c in vblocks] == layers
    for k, v in zip(kblocks, vblocks):
        assert v["x"] is k["x"] and v["memory"] is k["memory"]
    gaps = cs.stream_gaps(kblocks, vblocks, cs.E2E_TOL, "float32")
    assert gaps["block_calls"] == 6 + 4 * 4


def test_gap_probe_plants_its_fault_in_the_labelled_decoder_layer():
    """``tools/serve_gap_probe.py``'s control on whisper reduced (float32,
    both runs on the vector tier, so every correct block agrees exactly):
    the update of decoder layer 2 scaled by 1.05 at every step, found by
    its per-layer reading (0.05 / 1.05 of the faulted update) and by no
    other layer, the encoder's included."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    import serve_gap_probe as gp
    from repro_torch.data.pipeline import extra_inputs
    from repro_torch.models import blocks as B
    from repro_torch.serve.engine import Engine
    cfg = get_config("whisper-tiny").reduced().replace(dtype="float32")
    params = M.init(cfg, torch.Generator().manual_seed(7), "cpu")
    prompts = np.random.default_rng(7).integers(2, cfg.vocab_size, (2, 8))
    extra = extra_inputs(cfg, 2, 0, "cpu")
    tokens = Engine(cfg, params, 2, 13, device="cpu").generate(prompts, 4,
                                                                 extra)
    run = functools.partial(cs.teacher_logits, cfg, params, prompts, tokens,
                            13, torch.device("cpu"), extra=extra)
    apply = B.block_apply
    B.block_apply = gp.faulty(apply, "dec.2", "scale")
    try:
        cblock, cblocks = cs.block_probe(B)
    finally:
        B.block_apply = apply
    run("vector", None, cblock)
    pin, vblocks = cs.block_probe(B, pinned=cblocks)
    run("vector", None, pin)
    stats = gp.block_stats(cblocks, vblocks)
    assert stats["worst_layer"] == "dec.2"
    by_layer = stats["update_by_layer"]
    assert set(by_layer) == {"enc.0", "enc.1", "dec.0", "dec.1", "dec.2",
                             "dec.3"}
    assert by_layer["dec.2"] == pytest.approx(0.05 / 1.05, rel=1e-3)
    assert all(v == 0.0 for k, v in by_layer.items() if k != "dec.2")
