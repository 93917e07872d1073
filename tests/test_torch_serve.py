"""The port's serving path (configs, models, Engine) against the JAX
reference, on the CPU.

Each ported arch ``reduced()`` in float32 (zamba2-1.2b: 4 layers, GQA
4/2 heads, ssm chunk 32; mamba2-1.3b: 4 Mamba2 layers, g 1, ssm chunk 32;
granite-moe-1b-a400m: 4 ``moe`` layers, GQA 4/2 heads, 8 experts top-2;
deepseek-v2-lite-16b: a ``moe_dense`` layer then 3 ``moe`` layers, MLA
with no q-lora, 8 experts top-2 and 2 shared; minicpm3-4b: 4 ``attn``
layers, MLA with q-lora 32, tied and scaled embeddings; gemma2-2b and
gemma3-1b: ``local`` and ``attn`` layers, window 16, softcaps or qk-norm,
sandwich norms; whisper-tiny: 4 ``dec`` layers and a 2-layer encoder over
8 stub frames; pixtral-12b: 4 ``attn`` layers after 4 stub patches), the
frames and patches from each package's ``extra_inputs``:
the reference's params, carried across by ``models/convert.py``, go
through the reference's Engine and the port's.  Prefill logits and every
teacher-forced decode step's logits agree within the reference's fp32
kernel TOL of 2e-4, and the greedy tokens are equal over 8 steps.  The
port runs its vector tier and its kernel tiers (their plain versions
here): under the rvv-128 cost target, where ssd keeps the vector tier by
the reference's counts, and under h100, where every op of the arch's
path takes its kernel tier but MLA's attention, whose split head dims
the fused kernel does not take (the reference's rule), and which keeps
the vector tier under every target.

The full-width parameter tree of each ported arch equals the
reference's in every shape and dtype, mamba2-1.3b's and pixtral-12b's
among them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import pipeline as JP
from repro.models import model as JM
from repro.serve import engine as JE
from repro_torch.configs import ARCH_NAMES, all_configs, get_config
from repro_torch.core import trace, use_policy
from repro_torch.data import pipeline as P
from repro_torch.launch import serve as launch_serve
from repro_torch.models import blocks, convert
from repro_torch.models import model as M
from repro_torch.serve import engine as E

TOL = dict(rtol=2e-4, atol=2e-4)
BATCH, PROMPT, STEPS, MAX_SEQ = 2, 12, 8, 24


def _cfgs(name):
    return (jget_config(name).reduced().replace(dtype="float32"),
            get_config(name).reduced().replace(dtype="float32"))


def _p_off(cfg):
    """The positions a vlm's patches take before the tokens."""
    return cfg.n_patches if cfg.family == "vlm" else 0


def _reference_run(name):
    """The reference Engine's greedy tokens, and its teacher-forced
    logits on those tokens (prefill, then STEPS - 1 decode steps)."""
    jcfg, cfg = _cfgs(name)
    jparams = JM.init(jcfg, jax.random.PRNGKey(0))
    prompts = np.random.default_rng(0).integers(
        2, jcfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    extra = JP.extra_inputs(jcfg, BATCH, 0)
    tokens = JE.Engine(jcfg, jparams, max_batch=BATCH,
                       max_seq=MAX_SEQ).generate(jnp.asarray(prompts), STEPS,
                                                 extra)
    prefill = jax.jit(JE.make_prefill_step(jcfg))
    step = jax.jit(JE.make_serve_step(jcfg))
    p_off = _p_off(jcfg)
    cache = JM.init_cache(jcfg, BATCH, MAX_SEQ + p_off)
    logits, cache = prefill(jparams, cache, {"tokens": jnp.asarray(prompts),
                                             **extra})
    out = [np.asarray(logits)]
    lens = jnp.full((BATCH,), PROMPT + p_off, jnp.int32)
    for i in range(STEPS - 1):
        logits, cache = step(jparams, cache, jnp.asarray(tokens[:, i:i + 1]),
                             lens)
        lens = lens + 1
        out.append(np.asarray(logits))
    params = convert.from_jax(jax.tree.map(np.asarray, jparams), cfg,
                              device="cpu")
    return cfg, params, prompts, np.asarray(tokens), out


# the ops on each arch's serving path
ARCH_OPS = {"zamba2-1.2b": {"gemm", "vtanh", "attention",
                            "decode_attention", "ssd"},
            "mamba2-1.3b": {"gemm", "ssd"},
            "granite-moe-1b-a400m": {"gemm", "vsigmoid", "attention",
                                     "decode_attention"},
            # MLA: split-dim attention in prefill, the absorbed decode
            # in plain products (no decode_attention)
            "deepseek-v2-lite-16b": {"gemm", "vsigmoid", "attention"},
            "minicpm3-4b": {"gemm", "vsigmoid", "attention"},
            # gelu through vtanh (gemma2's final softcap too); whisper's
            # cross-attention is an attention call in every mode
            "gemma2-2b": {"gemm", "vtanh", "attention", "decode_attention"},
            "gemma3-1b": {"gemm", "vtanh", "attention", "decode_attention"},
            "whisper-tiny": {"gemm", "vtanh", "attention",
                             "decode_attention"},
            "pixtral-12b": {"gemm", "vsigmoid", "attention",
                            "decode_attention"},
            "mistral-large-123b": {"gemm", "vsigmoid", "attention",
                                   "decode_attention"}}
# tier -> (policy, target)
TIERS = {"vector": ("vector", None), "pallas": ("pallas", "rvv-128"),
         "h100": ("pallas", "h100")}


@pytest.fixture(scope="module", params=sorted(ARCH_OPS))
def reference(request):
    return request.param, _reference_run(request.param)


def _port_logits(cfg, params, prompts, tokens, target=None):
    prefill = E.make_prefill_step(cfg, target)
    step = E.make_serve_step(cfg, target)
    p_off = _p_off(cfg)
    cache = M.init_cache(cfg, BATCH, MAX_SEQ + p_off, "cpu")
    logits, cache = prefill(params, cache,
                            {"tokens": torch.from_numpy(prompts).long(),
                             **P.extra_inputs(cfg, BATCH, 0, "cpu")})
    out = [logits.numpy()]
    lens = torch.full((BATCH,), PROMPT + p_off, dtype=torch.int32)
    for i in range(STEPS - 1):
        logits, cache = step(params, cache,
                             torch.from_numpy(tokens[:, i:i + 1]).long(),
                             lens)
        lens = lens + 1
        out.append(logits.numpy())
    return out


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_engine_matches_reference(reference, tier):
    name, (cfg, params, prompts, want_tokens, want_logits) = reference
    policy, target = TIERS[tier]
    with use_policy(policy), trace.count() as c:
        got = _port_logits(cfg, params, prompts, want_tokens, target)
        eng = E.Engine(cfg, params, max_batch=BATCH, max_seq=MAX_SEQ,
                       target=target, device="cpu")
        tokens = eng.generate(prompts, STEPS,
                              P.extra_inputs(cfg, BATCH, 0, "cpu"))
    assert len(got) == len(want_logits) == STEPS
    vocab = -(-cfg.vocab_size // 256) * 256
    for g, w in zip(got, want_logits):
        assert g.shape == w.shape == (BATCH, vocab) and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, **TOL)
    np.testing.assert_array_equal(tokens, want_tokens)
    assert tokens.dtype == np.int32 and tokens.shape == (BATCH, STEPS)
    ran = {op for op, _ in c["per_op"]}
    kernel = {op for op, t in c["per_op"] if t == "pallas"}
    assert ran == ARCH_OPS[name]
    # MLA's attention has split head dims: the vector tier under every
    # target, by the reference's rule
    split = {"attention"} if cfg.attn_kind == "mla" else set()
    if tier == "vector":
        assert kernel == set()
    elif tier == "pallas":
        # under the RVV model ssd keeps its vector tier; the kernel tiers
        # carry the rest
        assert kernel == ARCH_OPS[name] - {"ssd"} - split
    else:
        assert c["per_op"].keys() == {(op, "vector" if op in split
                                       else "pallas") for op in ran}


def test_decode_past_max_seq_is_refused_where_the_reference_drops_it():
    """ROADMAP C.11, both packages pinned: 2 prompts of 12 tokens and
    max_seq 16.  The reference's Engine returns all 10 tokens of
    ``generate(..., 10)`` (its cache writes at slots 16..20 are dropped);
    the port's raises ValueError naming max_seq before any decode step.
    ``generate(..., 5)`` writes positions up to 12 + 5 - 1 = 16 - 1 and
    gives the reference's tokens."""
    jcfg, cfg = _cfgs("zamba2-1.2b")
    jparams = JM.init(jcfg, jax.random.PRNGKey(0))
    params = convert.from_jax(jax.tree.map(np.asarray, jparams), cfg,
                              device="cpu")
    prompts = np.random.default_rng(1).integers(
        2, jcfg.vocab_size, (2, 12)).astype(np.int32)

    def jax_engine():
        return JE.Engine(jcfg, jparams, max_batch=2, max_seq=16)

    def port_engine():
        return E.Engine(cfg, params, max_batch=2, max_seq=16, device="cpu")

    dropped = np.asarray(jax_engine().generate(jnp.asarray(prompts), 10))
    assert dropped.shape == (2, 10)
    eng, steps = port_engine(), []
    step = eng._step
    eng._step = lambda *a: steps.append(a) or step(*a)
    with pytest.raises(ValueError, match="max_seq 16"):
        eng.generate(prompts, 10)
    assert steps == [] and eng.position == 12
    want = np.asarray(jax_engine().generate(jnp.asarray(prompts), 5))
    eng = port_engine()
    np.testing.assert_array_equal(eng.generate(prompts, 5), want)
    assert eng.position == 16


def test_decode_past_max_seq_is_refused_for_an_mla_cache():
    """C.11 with MLA's compressed cache (deepseek reduced): the refusal
    comes before any decode step and the cache is left as the prefill
    wrote it; within max_seq the tokens are the reference's."""
    jcfg, cfg = _cfgs("deepseek-v2-lite-16b")
    jparams = JM.init(jcfg, jax.random.PRNGKey(0))
    params = convert.from_jax(jax.tree.map(np.asarray, jparams), cfg,
                              device="cpu")
    prompts = np.random.default_rng(1).integers(
        2, jcfg.vocab_size, (2, 12)).astype(np.int32)
    eng = E.Engine(cfg, params, max_batch=2, max_seq=16, device="cpu")
    first = eng.prefill(prompts)
    before = {k: v.clone() for k, v in eng.cache["prefix"][0].items()}
    assert set(before) == {"c_kv", "k_rope"}
    with pytest.raises(ValueError, match="max_seq 16"):
        eng.decode(first, 5)
    assert eng.position == 12
    for k, v in eng.cache["prefix"][0].items():
        assert torch.equal(v, before[k])
    want = np.asarray(JE.Engine(jcfg, jparams, max_batch=2, max_seq=16)
                      .generate(jnp.asarray(prompts), 5))
    eng = E.Engine(cfg, params, max_batch=2, max_seq=16, device="cpu")
    np.testing.assert_array_equal(eng.generate(prompts, 5), want)
    assert eng.position == 16


def _uncounted(cfg):
    """Elements of the parameter tree that ``param_counts()`` (the
    reference's estimate, copied as it is) leaves out: the norms (a
    layernorm's bias, gemma's sandwich norms, the q/k norms, MLA's kv and
    q norms too), the conv biases, the padded vocabulary rows (of the
    untied head too), whisper's whole encoder and, in zamba2's shared
    block, the down projection of the gated MLP (ROADMAP C.10)."""
    d = cfg.d_model
    norm = 2 * d if cfg.norm == "layernorm" else d
    conv_b = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    tblock = 2 * norm                                   # ln1, ln2
    if cfg.sandwich_norm:
        tblock += 2 * norm                              # ln1p, ln2p
    if cfg.qk_norm:
        tblock += 2 * cfg.head_dim                      # qn, kn
    if cfg.attn_kind == "mla":
        tblock += cfg.kv_lora_rank + cfg.q_lora_rank    # kv_norm, q_norm
    per_kind = {"mamba": d + cfg.d_inner + conv_b,      # ln, gn, conv_b
                "moe": tblock, "moe_dense": tblock, "attn": tblock,
                "local": tblock, "dec": 3 * norm}       # ln1, lnx, ln2
    per_kind["mamba_shared"] = per_kind["mamba"]
    out = sum(per_kind[k] for k in cfg.layer_pattern()) + norm
    heads = 1 if cfg.tie_embeddings else 2
    out += (-(-cfg.vocab_size // 256) * 256 - cfg.vocab_size) * d * heads
    if cfg.shared_attn_every:
        out += 2 * (2 * d) + cfg.d_ff * d
    if cfg.n_enc_layers:
        hd = cfg.head_dim
        attn = d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) + \
            cfg.n_heads * hd * d
        mlp = d * cfg.d_ff * (3 if cfg.gated_mlp else 2)
        out += cfg.n_enc_layers * (attn + mlp + 2 * norm) + norm
    return out


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                         f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _leaves(v, f"{path}/{i}")]
    return [(path, tree)]


# the reference's eval_shape counts of each full-width tree
FULL_WIDTH = {"zamba2-1.2b": 1_190_425_216, "mamba2-1.3b": 1_344_052_224,
              "granite-moe-1b-a400m": 1_334_887_424,
              "deepseek-v2-lite-16b": 15_706_484_224,
              "minicpm3-4b": 4_073_937_408,
              "gemma2-2b": 2_614_341_888, "gemma3-1b": 999_885_952,
              "whisper-tiny": 36_487_680, "pixtral-12b": 12_247_782_400}


@pytest.mark.parametrize("name", sorted(FULL_WIDTH))
def test_full_width_parameter_tree_equals_reference(name):
    jcfg, cfg = jget_config(name), get_config(name)
    jtree = jax.eval_shape(lambda k: JM.init(jcfg, k), jax.random.PRNGKey(0))
    params = M.init(cfg, None, device="meta")
    _, unit, reps, _ = cfg.pattern_unit()
    want = {}
    for path, leaf in _leaves(jax.tree.map(lambda a: a, jtree)):
        dtype = str(leaf.dtype)
        if path.startswith("/unit/"):         # stacked: one entry per repeat
            j, rest = path[len("/unit/"):].split("/", 1)
            for r in range(reps):
                want[f"/unit/{j}/{r}/{rest}"] = (tuple(leaf.shape[1:]),
                                                 dtype)
        elif path.startswith("/enc/"):        # stacked: one per layer
            for r in range(cfg.n_enc_layers):
                want[f"/enc/{r}/{path[len('/enc/'):]}"] = (
                    tuple(leaf.shape[1:]), dtype)
        else:
            want[path] = (tuple(leaf.shape), dtype)
    got = {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for p, t in _leaves(params)}
    assert got == want
    assert all(t.device.type == "meta" for _, t in _leaves(params))
    count = M.count_params(params)
    assert count == sum(int(np.prod(s)) for s, _ in want.values())
    assert cfg.param_counts() == jcfg.param_counts()
    assert count == cfg.param_counts()[0] + _uncounted(cfg)
    assert count == FULL_WIDTH[name]


def test_convert_carries_bfloat16():
    a = jnp.asarray(np.linspace(-3, 3, 12, dtype=np.float32)
                    .reshape(3, 4)).astype(jnp.bfloat16)
    t = convert.tensor(np.asarray(a), device="cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(a.astype(jnp.float32)))


def test_convert_defaults_to_the_card():
    """Like every entry point of the port, the weight carrier builds on
    the card unless told otherwise; without one it raises with
    ``resolve_device``'s message."""
    from repro_torch.core.targets import resolve_device
    a = np.ones((2, 3), np.float32)
    tree = {"embed": a}
    cfg = get_config("zamba2-1.2b").reduced()
    _, unit, _, _ = cfg.pattern_unit()
    tree["unit"] = [{"w": np.ones((cfg.pattern_unit()[2], 2), np.float32)}
                    for _ in unit]
    if torch.cuda.is_available():
        assert convert.tensor(a).device.type == "cuda"
        assert convert.from_jax(tree, cfg)["embed"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError) as want:
        resolve_device("cuda")
    for build in (lambda: convert.tensor(a),
                  lambda: convert.from_jax(tree, cfg)):
        with pytest.raises(RuntimeError) as got:
            build()
        assert str(got.value) == str(want.value)
    assert convert.tensor(a, device="cpu").device.type == "cpu"


def test_all_configs_are_the_references():
    """``configs.all_configs``: every arch's config by name, field for
    field the reference's."""
    from repro.configs import all_configs as jall_configs
    got, want = all_configs(), jall_configs()
    assert set(got) == set(want) == set(ARCH_NAMES)
    for name, cfg in got.items():
        assert vars(cfg) == vars(want[name]), name
        assert cfg is get_config(name)


def test_unported_archs_and_kinds_name_their_roadmap_item():
    assert set(ARCH_NAMES) == set(ARCH_OPS)
    for name in ARCH_NAMES:
        assert get_config(name).name == name
    # served and trained since their per-block bf16 gate (ROADMAP C.22,
    # C.23): their configs are the reference's, field for field
    for name in ("mamba2-1.3b", "pixtral-12b"):
        assert vars(get_config(name)) == vars(jget_config(name))
    # mistral is ported with models/sharding.py (ROADMAP A.9.6)
    assert get_config("mistral-large-123b").fsdp
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    # every block kind of the reference is ported: local, enc and dec too
    for name, kind in (("gemma2-2b", "local"), ("gemma3-1b", "local"),
                       ("whisper-tiny", "enc"), ("whisper-tiny", "dec")):
        cfg = get_config(name).reduced()
        assert kind in cfg.layer_pattern() or kind == "enc"
        assert "attn" in blocks.block_init(kind, None, cfg,
                                           torch.device("meta"))
    cfg = get_config("zamba2-1.2b").reduced()
    for fn in (lambda: blocks.block_init("no-such-kind", None, cfg,
                                         torch.device("meta")),
               lambda: blocks.block_cache_init("no-such-kind", cfg, 1, 8,
                                               torch.device("meta")),
               lambda: blocks.block_apply("no-such-kind", None, None, None,
                                          None)):
        with pytest.raises(ValueError):
            fn()
    # the attn and moe_dense kinds, and a transformer block with MLA
    # attention, are ported
    for kind in ("attn", "moe_dense"):
        assert "attn" in blocks.block_init(kind, None, cfg,
                                           torch.device("meta"))
    mla = get_config("granite-moe-1b-a400m").reduced().replace(
        attn_kind="mla", kv_lora_rank=32, qk_rope_dim=8, qk_nope_dim=16,
        v_head_dim=16)
    assert "w_dkv" in blocks.block_init("moe", None, mla,
                                        torch.device("meta"))["attn"]


def test_engine_defaults_to_the_card():
    cfg = get_config("zamba2-1.2b").reduced().replace(dtype="float32")
    params = M.init(cfg, torch.Generator().manual_seed(0), "cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default is usable here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        E.Engine(cfg, params, max_batch=1, max_seq=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.init(cfg, None)


def test_temperature_sampling_is_seeded_by_lengths():
    cfg = get_config("zamba2-1.2b").reduced().replace(dtype="float32")
    params = M.init(cfg, torch.Generator().manual_seed(1), "cpu")
    prompts = np.random.default_rng(2).integers(2, 256, (2, 6))
    runs = [E.Engine(cfg, params, max_batch=2, max_seq=12, temperature=0.8,
                     device="cpu").generate(prompts, 4) for _ in range(2)]
    np.testing.assert_array_equal(*runs)
    assert ((runs[0] >= 0) & (runs[0] < cfg.vocab_size)).all()


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "granite-moe-1b-a400m",
                                  "deepseek-v2-lite-16b", "minicpm3-4b",
                                  "gemma2-2b", "gemma3-1b",
                                  "whisper-tiny"])
def test_launcher_serves_reduced_on_cpu(capsys, arch):
    out = launch_serve.main(["--arch", arch, "--reduced",
                             "--device", "cpu", "--batch", "2",
                             "--prompt-len", "6", "--gen", "3"])
    assert out.shape == (2, 3)
    assert "generated (2, 3) on cpu" in capsys.readouterr().out
