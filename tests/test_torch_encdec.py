"""The port's encoder-decoder path (whisper) against the JAX reference, on
the CPU: ``sinusoidal_positions``, ``gqa_apply``'s cross-attention
branch, the ``enc`` and ``dec`` blocks, the encoder, and whisper-tiny
``reduced()`` (d 64, 4 decoder and 2 encoder layers, 4/2 heads at
head_dim 16, 8 frames, layernorm, plain gelu MLP, no rope) served through
``Engine.generate`` with the stub frames of ``data/pipeline.py``.

The same numpy-made inputs and the reference's params (carried across by
``models/convert.py``, which unstacks the reference's encoder) go through
both packages; outputs, cache contents and logits within the reference's
kernel TOL (float32 2e-4, bf16 3e-2); greedy tokens equal over 8 steps in
float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import pipeline as JP
from repro.models import attention as JA
from repro.models import blocks as JB
from repro.models import layers as JL
from repro.models import model as JM
from repro.serve import engine as JE
from repro_torch.configs import get_config, pixtral_12b
from repro_torch.core import trace, use_policy
from repro_torch.data import pipeline as P
from repro_torch.models import attention as A
from repro_torch.models import blocks as B
from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.serve import engine as E

TOL = {"float32": 2e-4, "bfloat16": 3e-2}
BATCH, PROMPT, STEPS, MAX_SEQ = 2, 12, 8, 24
ARCH = "whisper-tiny"


def _port_config(name):
    """The port's config of ``name``; pixtral-12b's from its module, which
    ``get_config`` refuses (ROADMAP C.23)."""
    if name == pixtral_12b.CONFIG.name:
        return pixtral_12b.CONFIG
    return get_config(name)


def _cfgs(arch=ARCH, dtype="float32"):
    return (jget_config(arch).reduced().replace(dtype=dtype),
            _port_config(arch).reduced().replace(dtype=dtype))


def _params(jparams):
    return convert._map(jax.tree.map(np.asarray, jparams),
                        lambda a: convert.tensor(a, "cpu"))


def _arr(shape, seed, dtype):
    """A numpy-made array in ``dtype``: the reference's and the port's,
    bitwise equal."""
    x = np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    return jx, convert.tensor(np.asarray(jx), "cpu")


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, dtype):
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


def _pos(s):
    pos = np.tile(np.arange(s, dtype=np.int32), (BATCH, 1))
    return jnp.asarray(pos), torch.from_numpy(pos)


@pytest.mark.parametrize("d", [64, 384, 7])
def test_sinusoidal_positions_match_reference(d):
    """Whisper's positions at decoder and encoder lengths (1500 frames)
    and past the 448-token horizon, float32, within the fp32 TOL (an angle
    near 1500 carries float32's 1.2e-4 spacing into sin and cos); d odd as
    well."""
    pos = np.array([[0, 1, 2, 447, 448, 1499], [5, 511, 543, 1024, 3, 0]],
                   np.int32)
    want = np.asarray(JL.sinusoidal_positions(jnp.asarray(pos), d))
    got = L.sinusoidal_positions(torch.from_numpy(pos), d)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got, want, "float32")


# (arch, what its config adds to the cross-attention branch)
CROSS = [("whisper-tiny", "no rope, layernorm"),
         ("gemma3-1b", "qk-norm on q alone"),
         ("gemma2-2b", "softcap")]


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("arch,what", CROSS, ids=[c[0] for c in CROSS])
def test_cross_attention_matches_reference(arch, what, dtype):
    """``gqa_apply(memory=(k, v))``: q from x, k and v as given (no k norm,
    no rope), non-causal over 8 frames, in every mode; the cache comes
    back as it came and is not written."""
    jcfg, cfg = _cfgs(arch, dtype)
    jp = JA.gqa_init(jax.random.PRNGKey(2), jcfg)
    p = _params(jp)
    kv = (BATCH, 8, cfg.n_kv_heads, cfg.head_dim)
    jk, k = _arr(kv, 1, dtype)
    jv, v = _arr(kv, 2, dtype)
    cache = {"k": torch.zeros(1), "v": torch.zeros(1)}
    for s, mode in ((PROMPT, "train"), (PROMPT, "prefill"), (1, "decode")):
        jx, x = _arr((BATCH, s, cfg.d_model), 3 + s, dtype)
        jpos, pos = _pos(s)
        jy, _ = JA.gqa_apply(jp, jx, jcfg, positions=jpos, mode=mode,
                             memory=(jk, jv))
        with trace.count() as counted:
            y, got = A.gqa_apply(p, x, cfg, positions=pos, mode=mode,
                                 cache=cache, memory=(k, v))
        assert got is cache and torch.equal(cache["k"], torch.zeros(1))
        assert {op for op, _ in counted["per_op"]} == {"gemm", "attention"}
        _close(y, jy, dtype)


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_enc_block_matches_reference(dtype):
    """The ``enc`` kind: layernorms, non-causal self-attention over the
    frames (no cache), the plain gelu MLP."""
    jcfg, cfg = _cfgs(dtype=dtype)
    jp = JB.block_init("enc", jax.random.PRNGKey(4), jcfg)
    p = _params(jp)
    meta = B.block_init("enc", None, cfg, torch.device("meta"))
    assert _shapes(meta) == _shapes(p)
    assert set(p["ln1"]) == {"w", "b"} and "wg" not in p["mlp"]
    assert B.block_cache_init("enc", cfg, BATCH, MAX_SEQ, "cpu") is None
    jx, x = _arr((BATCH, cfg.n_frames, cfg.d_model), 5, dtype)
    jpos, pos = _pos(cfg.n_frames)
    for mode in ("train", "prefill"):
        jy, _, _ = JB.block_apply("enc", jp, jx, None,
                                  JB.Ctx(cfg=jcfg, mode=mode, positions=jpos))
        y, cache, _ = B.block_apply("enc", p, x, None,
                                 B.Ctx(cfg=cfg, mode=mode, positions=pos))
        assert cache is None
        _close(y, jy, dtype)


def _shapes(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{path}/{k}"))
        return out
    return {path: (tuple(tree.shape), tree.dtype)}


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_dec_block_matches_reference(dtype):
    """The ``dec`` kind: a prefill computes the cross k and v from
    ``ctx.memory`` and writes them into the cache beside the self cache;
    the decode steps (one of them ragged) read them from the cache, with
    no memory given."""
    jcfg, cfg = _cfgs(dtype=dtype)
    jp = JB.block_init("dec", jax.random.PRNGKey(6), jcfg)
    p = _params(jp)
    assert _shapes(B.block_init("dec", None, cfg, torch.device("meta"))) \
        == _shapes(p)
    jcache = JB.block_cache_init("dec", jcfg, BATCH, MAX_SEQ)
    cache = B.block_cache_init("dec", cfg, BATCH, MAX_SEQ, "cpu")
    assert set(cache) == {"self", "xk", "xv"}
    assert cache["xk"].shape == (BATCH, cfg.n_frames, cfg.n_kv_heads,
                                 cfg.head_dim)
    jmem, mem = _arr((BATCH, cfg.n_frames, cfg.d_model), 7, dtype)
    jx, x = _arr((BATCH, PROMPT, cfg.d_model), 8, dtype)
    jpos, pos = _pos(PROMPT)
    jy, jcache, _ = JB.block_apply("dec", jp, jx, jcache, JB.Ctx(
        cfg=jcfg, mode="prefill", positions=jpos, memory=jmem))
    y, got, _ = B.block_apply("dec", p, x, cache, B.Ctx(
        cfg=cfg, mode="prefill", positions=pos, memory=mem))
    assert got is cache
    _close(y, jy, dtype)
    for lens in ((12, 12), (13, 13), (14, 13)):
        jx, x = _arr((BATCH, 1, cfg.d_model), 20 + lens[1], dtype)
        ln = np.asarray(lens, np.int32)
        jy, jcache, _ = JB.block_apply("dec", jp, jx, jcache, JB.Ctx(
            cfg=jcfg, mode="decode", positions=jnp.asarray(ln[:, None]),
            lengths=jnp.asarray(ln)))
        with trace.count() as counted:
            y, cache, _ = B.block_apply("dec", p, x, cache, B.Ctx(
                cfg=cfg, mode="decode", positions=torch.from_numpy(
                    ln[:, None]), lengths=torch.from_numpy(ln)))
        # the cross-attention at decode is one attention call (q of one
        # row against the frames), the self-attention a decode call
        assert counted["per_op"].keys() >= {("attention", "vector"),
                                            ("decode_attention", "vector")}
        _close(y, jy, dtype)
    for name in ("xk", "xv"):
        _close(cache[name], jcache[name], dtype)
    for name in ("k", "v"):
        _close(cache["self"][name], jcache["self"][name], dtype)


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_encoder_matches_reference(dtype):
    """``model._encode``: the frames in the model's dtype, sinusoidal
    positions added in float32, the encoder blocks, the final layernorm."""
    jcfg, cfg = _cfgs(dtype=dtype)
    jparams = JM.init(jcfg, jax.random.PRNGKey(0))
    params = convert.from_jax(jax.tree.map(np.asarray, jparams), cfg,
                              device="cpu")
    assert len(params["enc"]) == cfg.n_enc_layers == 2
    jf, f = _arr((BATCH, cfg.n_frames, cfg.d_model), 9, "float32")
    want = JM._encode(jparams, jcfg, jf)
    got = M._encode(params, cfg, f)
    assert got.dtype == L.dtype_of(cfg)
    _close(got, want, dtype)


def test_extra_inputs_are_the_reference_draws():
    """Frames for an encoder-decoder (seed), patches for a vlm (seed + 1),
    nothing else; float32, equal to the reference's element for element."""
    for arch in ("whisper-tiny", "pixtral-12b", "gemma2-2b"):
        jcfg, cfg = _cfgs(arch)
        want = JP.extra_inputs(jcfg, 3, seed=5)
        got = P.extra_inputs(cfg, 3, seed=5, device="cpu")
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            P.extra_inputs(get_config(ARCH).reduced(), 1)


def _teacher(jcfg, jparams, prompts, tokens, extra):
    """The reference's prefill and STEPS - 1 decode steps' logits on the
    given tokens."""
    prefill = jax.jit(JE.make_prefill_step(jcfg))
    step = jax.jit(JE.make_serve_step(jcfg))
    p_off = jcfg.n_patches if jcfg.family == "vlm" else 0
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
    return out


def _port_teacher(cfg, params, prompts, tokens, extra):
    eng = E.Engine(cfg, params, max_batch=BATCH, max_seq=MAX_SEQ,
                   device="cpu")
    step = E.make_serve_step(cfg)
    logits, eng.cache = E.make_prefill_step(cfg)(
        params, eng.cache, {"tokens": torch.from_numpy(prompts).long(),
                            **extra})
    out = [logits.numpy()]
    lens = torch.full((BATCH,), PROMPT + eng.p_off, dtype=torch.int32)
    for i in range(STEPS - 1):
        logits, eng.cache = step(params, eng.cache,
                                 torch.from_numpy(tokens[:, i:i + 1]).long(),
                                 lens)
        lens = lens + 1
        out.append(logits.numpy())
    return out


def served(arch, policy, target):
    """The reference Engine's greedy tokens over STEPS after a prompt of
    PROMPT tokens and its ``extra``, its teacher-forced logits, and the
    port's of both under ``policy`` and ``target``, with what the port's
    ops ran on."""
    jcfg, cfg = _cfgs(arch)
    jparams = JM.init(jcfg, jax.random.PRNGKey(0))
    params = convert.from_jax(jax.tree.map(np.asarray, jparams), cfg,
                              device="cpu")
    prompts = np.random.default_rng(0).integers(
        2, jcfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    jextra = JP.extra_inputs(jcfg, BATCH, 0)
    extra = P.extra_inputs(cfg, BATCH, 0, device="cpu")
    want_tokens = np.asarray(JE.Engine(jcfg, jparams, max_batch=BATCH,
                                       max_seq=MAX_SEQ).generate(
        jnp.asarray(prompts), STEPS, jextra))
    want = _teacher(jcfg, jparams, prompts, want_tokens, jextra)
    with use_policy(policy), trace.count() as counted:
        got = _port_teacher(cfg, params, prompts, want_tokens, extra)
        tokens = E.Engine(cfg, params, max_batch=BATCH, max_seq=MAX_SEQ,
                          target=target, device="cpu").generate(
            prompts, STEPS, extra)
    return cfg, want_tokens, want, tokens, got, counted


@pytest.mark.parametrize("tier", ["vector", "h100"])
def test_whisper_engine_with_frames_matches_reference(tier):
    """whisper reduced through ``Engine.generate(prompts, 8, extra)``: the
    encoder runs once in the prefill, the decoder's cross k/v come from
    the cache at every step; the logits at each step within TOL and the
    greedy tokens equal.  Under h100 every call takes its kernel tier
    (its plain version here), the cross-attention of each decode step
    among them."""
    policy, target = ("vector", None) if tier == "vector" \
        else ("pallas", "h100")
    cfg, want_tokens, want, tokens, got, counted = served(ARCH, policy,
                                                          target)
    vocab = -(-cfg.vocab_size // 256) * 256
    assert len(got) == len(want) == STEPS
    for g, w in zip(got, want):
        assert g.shape == w.shape == (BATCH, vocab) and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, **dict(rtol=TOL["float32"],
                                                atol=TOL["float32"]))
    np.testing.assert_array_equal(tokens, want_tokens)
    ran = {op for op, _ in counted["per_op"]}
    assert ran == {"gemm", "vtanh", "attention", "decode_attention"}
    if tier == "h100":
        assert counted["per_op"].keys() == {(op, "pallas") for op in ran}


def test_whisper_from_jax_unstacks_the_encoder():
    """The reference's ``enc`` tree is stacked on a leading axis of
    ``n_enc_layers``; ``from_jax`` gives a list of that many block
    dictionaries, each leaf the reference's slice, and refuses a tree
    whose axis is another length."""
    jcfg, cfg = _cfgs()
    jtree = jax.tree.map(np.asarray, JM.init(jcfg, jax.random.PRNGKey(1)))
    params = convert.from_jax(jtree, cfg, device="cpu")
    for i, layer in enumerate(params["enc"]):
        np.testing.assert_array_equal(layer["attn"]["wq"].numpy(),
                                      jtree["enc"]["attn"]["wq"][i])
        np.testing.assert_array_equal(layer["ln1"]["b"].numpy(),
                                      jtree["enc"]["ln1"]["b"][i])
    assert set(params["enc_norm"]) == {"w", "b"}
    with pytest.raises(ValueError, match="enc: leading axis 2"):
        convert.from_jax(jtree, cfg.replace(n_enc_layers=3), device="cpu")
