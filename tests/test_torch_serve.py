"""The port's serving path (configs, models, Engine) against the JAX
reference, on the CPU.

zamba2-1.2b ``reduced()`` in float32 (4 layers, GQA 4/2 heads, ssm chunk
32): the reference's params, carried across by ``models/convert.py``, go
through the reference's Engine and the port's.  Prefill logits and every
teacher-forced decode step's logits agree within the reference's fp32
kernel TOL of 2e-4 (measured: under 1e-6), and the greedy tokens are
equal over 8 steps.  The port runs both its vector tier and, under the
rvv-128 cost target, its kernel tiers (their plain versions here).

The full-width parameter tree of the port equals the reference's in
every shape and dtype.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import model as JM
from repro.serve import engine as JE
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.core import trace, use_policy
from repro_torch.launch import serve as launch_serve
from repro_torch.models import blocks, convert
from repro_torch.models import model as M
from repro_torch.serve import engine as E

TOL = dict(rtol=2e-4, atol=2e-4)
BATCH, PROMPT, STEPS, MAX_SEQ = 2, 12, 8, 24


def _cfgs(name):
    return (jget_config(name).reduced().replace(dtype="float32"),
            get_config(name).reduced().replace(dtype="float32"))


def _reference_run(name):
    """The reference Engine's greedy tokens, and its teacher-forced
    logits on those tokens (prefill, then STEPS - 1 decode steps)."""
    jcfg, cfg = _cfgs(name)
    jparams = JM.init(jcfg, jax.random.PRNGKey(0))
    prompts = np.random.default_rng(0).integers(
        2, jcfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    tokens = JE.Engine(jcfg, jparams, max_batch=BATCH,
                       max_seq=MAX_SEQ).generate(jnp.asarray(prompts), STEPS)
    prefill = jax.jit(JE.make_prefill_step(jcfg))
    step = jax.jit(JE.make_serve_step(jcfg))
    cache = JM.init_cache(jcfg, BATCH, MAX_SEQ)
    logits, cache = prefill(jparams, cache, {"tokens": jnp.asarray(prompts)})
    out = [np.asarray(logits)]
    lens = jnp.full((BATCH,), PROMPT, jnp.int32)
    for i in range(STEPS - 1):
        logits, cache = step(jparams, cache, jnp.asarray(tokens[:, i:i + 1]),
                             lens)
        lens = lens + 1
        out.append(np.asarray(logits))
    params = convert.from_jax(jax.tree.map(np.asarray, jparams), cfg,
                              device="cpu")
    return cfg, params, prompts, np.asarray(tokens), out


@pytest.fixture(scope="module")
def zamba():
    return _reference_run("zamba2-1.2b")


def _port_logits(cfg, params, prompts, tokens, target=None):
    prefill = E.make_prefill_step(cfg, target)
    step = E.make_serve_step(cfg, target)
    cache = M.init_cache(cfg, BATCH, MAX_SEQ, "cpu")
    logits, cache = prefill(params, cache,
                            {"tokens": torch.from_numpy(prompts).long()})
    out = [logits.numpy()]
    lens = torch.full((BATCH,), PROMPT, dtype=torch.int32)
    for i in range(STEPS - 1):
        logits, cache = step(params, cache,
                             torch.from_numpy(tokens[:, i:i + 1]).long(),
                             lens)
        lens = lens + 1
        out.append(logits.numpy())
    return out


@pytest.mark.parametrize("tier", ["vector", "pallas"])
def test_zamba2_engine_matches_reference(zamba, tier):
    cfg, params, prompts, want_tokens, want_logits = zamba
    target = "rvv-128" if tier == "pallas" else None
    with use_policy(tier), trace.count() as c:
        got = _port_logits(cfg, params, prompts, want_tokens, target)
        eng = E.Engine(cfg, params, max_batch=BATCH, max_seq=MAX_SEQ,
                       target=target, device="cpu")
        tokens = eng.generate(prompts, STEPS)
    assert len(got) == len(want_logits) == STEPS
    for g, w in zip(got, want_logits):
        assert g.shape == w.shape == (BATCH, 256) and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, **TOL)
    np.testing.assert_array_equal(tokens, want_tokens)
    assert tokens.dtype == np.int32 and tokens.shape == (BATCH, STEPS)
    if tier == "pallas":
        # under the RVV model the kernel tiers carry both attentions
        assert c["per_op"][("attention", "pallas")] > 0
        assert c["per_op"][("decode_attention", "pallas")] > 0


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


def _uncounted(cfg):
    """Elements of the parameter tree that ``param_counts()`` (the
    reference's estimate, copied as it is) leaves out: the norms, the conv
    biases, the padded vocabulary rows and, in zamba2's shared block, the
    down projection of the gated MLP (ROADMAP C.10)."""
    d, n_mamba = cfg.d_model, cfg.n_layers
    conv_b = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    out = n_mamba * (d + cfg.d_inner + conv_b) + d
    out += (-(-cfg.vocab_size // 256) * 256 - cfg.vocab_size) * d
    if cfg.shared_attn_every:
        out += 2 * (2 * d) + cfg.d_ff * d
    return out


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                         f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _leaves(v, f"{path}/{i}")]
    return [(path, tree)]


def test_full_width_parameter_tree_equals_reference():
    name = "zamba2-1.2b"
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
    assert count == 1_190_425_216


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


def test_unported_archs_and_kinds_name_their_roadmap_item():
    assert set(ARCH_NAMES) == {"zamba2-1.2b"}
    for name in ("mamba2-1.3b", "gemma2-2b", "whisper-tiny",
                 "deepseek-v2-lite-16b"):
        with pytest.raises(NotImplementedError, match="ROADMAP A.9"):
            get_config(name)
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    cfg = get_config("zamba2-1.2b").reduced()
    for kind in ("attn", "moe", "dec"):
        with pytest.raises(NotImplementedError, match="ROADMAP A.9"):
            blocks.block_init(kind, None, cfg, torch.device("meta"))


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


def test_launcher_serves_reduced_on_cpu(capsys):
    out = launch_serve.main(["--arch", "zamba2-1.2b", "--reduced",
                             "--device", "cpu", "--batch", "2",
                             "--prompt-len", "6", "--gen", "3"])
    assert out.shape == (2, 3)
    assert "generated (2, 3) on cpu" in capsys.readouterr().out
