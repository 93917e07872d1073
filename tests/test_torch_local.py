"""The port's ``local`` transformer block and ``gqa_apply`` over a sliding
window against the JAX reference, on the CPU.

gemma2-2b ``reduced()`` (window 16, GQA 4/2 at head_dim 16, attention
softcap 50, final softcap 30, sandwich norms, gelu) and gemma3-1b
``reduced()`` (window 16, qk-norm, sandwich norms).  The same numpy-made
inputs and the reference's params go through both packages: a prefill
shorter than the window (the cache written in order) and one longer than
it (the ring prefill keeps the last 16 positions, slot = position % 16),
then decode steps that run the ring across its wrap (slot 15 back to 0)
and a ragged step; the outputs and the cache contents held within the
reference's kernel TOL (float32 2e-4, bf16 3e-2).  The reference's
attention runs its vector tier here, as the port's does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as JA
from repro.models import blocks as JB
from repro_torch.configs import get_config
from repro_torch.core import trace
from repro_torch.models import attention as A
from repro_torch.models import blocks as B
from repro_torch.models import convert

TOL = {"float32": 2e-4, "bfloat16": 3e-2}
ARCHS = ("gemma2-2b", "gemma3-1b")
BATCH, S_MAX = 2, 40
# prompts shorter and longer than the 16-slot ring
PROMPTS = (12, 20)


def _cfgs(arch, dtype="float32"):
    return (jget_config(arch).reduced().replace(dtype=dtype),
            get_config(arch).reduced().replace(dtype=dtype))


def _params(jparams):
    return convert._map(jax.tree.map(np.asarray, jparams),
                        lambda a: convert.tensor(a, "cpu"))


def _x(cfg, s, seed):
    x = np.random.default_rng(seed).standard_normal(
        (BATCH, s, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(cfg.dtype)
    return jx, convert.tensor(np.asarray(jx), "cpu")


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, dtype):
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


def _decode_lens(prompt):
    """Each decode step's lengths: from the prompt's end past position 32
    (the ring's second wrap), then a ragged step, row 1 one position
    back."""
    lens = [(p, p) for p in range(prompt, 34)]
    return lens + [(34, 33)]


def _kw(lens):
    lens = np.asarray(lens, np.int32)
    return (dict(positions=jnp.asarray(lens[:, None]),
                 lengths=jnp.asarray(lens)),
            dict(positions=torch.from_numpy(lens[:, None]),
                 lengths=torch.from_numpy(lens)))


def _prefill_pos(s):
    pos = np.tile(np.arange(s, dtype=np.int32), (BATCH, 1))
    return jnp.asarray(pos), torch.from_numpy(pos)


def test_reduced_configs_keep_the_features():
    g2, g3 = (get_config(a).reduced() for a in ARCHS)
    assert g2.window == g3.window == 16
    assert g2.softcap == 50.0 and g2.final_softcap == 30.0
    assert g3.qk_norm and g3.softcap is None
    assert g2.sandwich_norm and g3.sandwich_norm
    assert "local" in g2.layer_pattern() and "local" in g3.layer_pattern()
    for arch in ARCHS:
        assert vars(get_config(arch)) == vars(jget_config(arch))


@pytest.mark.parametrize("prompt", PROMPTS)
@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("arch", ARCHS)
def test_gqa_apply_over_a_window_matches_reference(arch, dtype, prompt):
    """``gqa_apply`` with the window: the ring cache (16 of 40 slots), the
    prefill's windowed attention, decode across the ring's wrap with
    ``valid = min(lengths + 1, slots)`` and no window passed to the decode
    kernel, as the reference does."""
    jcfg, cfg = _cfgs(arch, dtype)
    w = cfg.window
    jp = JA.gqa_init(jax.random.PRNGKey(1), jcfg)
    p = _params(jp)
    jcache = JA.gqa_cache_init(jcfg, BATCH, S_MAX, w)
    cache = A.gqa_cache_init(cfg, BATCH, S_MAX, "cpu", w)
    assert cache["k"].shape == (BATCH, w, cfg.n_kv_heads, cfg.head_dim)
    jx, x = _x(jcfg, prompt, 0)
    jpos, pos = _prefill_pos(prompt)
    jy, jcache = JA.gqa_apply(jp, jx, jcfg, positions=jpos, mode="prefill",
                              cache=jcache, window=w)
    y, got = A.gqa_apply(p, x, cfg, positions=pos, mode="prefill",
                         cache=cache, window=w)
    assert got is cache
    _close(y, jy, dtype)
    for name in ("k", "v"):
        _close(cache[name], jcache[name], dtype)
    for step, lens in enumerate(_decode_lens(prompt)):
        jx, x = _x(jcfg, 1, 10 + step)
        jkw, kw = _kw(lens)
        jy, jcache = JA.gqa_apply(jp, jx, jcfg, mode="decode", cache=jcache,
                                  window=w, **jkw)
        with trace.count() as counted:
            y, cache = A.gqa_apply(p, x, cfg, mode="decode", cache=cache,
                                   window=w, **kw)
        assert {op for op, _ in counted["per_op"]} == {"gemm",
                                                       "decode_attention"}
        _close(y, jy, dtype)
        for name in ("k", "v"):
            _close(cache[name], jcache[name], dtype)


def test_decode_over_the_ring_passes_no_window(monkeypatch):
    """The decode attention over the ring gets ``valid = min(lengths + 1,
    slots)`` and no window: a window given there would mask by slot index,
    not by position."""
    from repro_torch.kernels import ops
    _, cfg = _cfgs("gemma3-1b")
    p = A.gqa_init(torch.Generator().manual_seed(0), cfg,
                   torch.device("cpu"))
    cache = A.gqa_cache_init(cfg, BATCH, S_MAX, "cpu", cfg.window)
    seen = []
    decode = ops.decode_attention

    def spy(q, k, v, lengths, **kw):
        seen.append((lengths.clone(), kw))
        return decode(q, k, v, lengths, **kw)
    monkeypatch.setattr(ops, "decode_attention", spy)
    x = torch.randn(BATCH, 1, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    lens = torch.tensor([3, 30], dtype=torch.int32)
    A.gqa_apply(p, x, cfg, positions=lens[:, None], mode="decode",
                cache=cache, lengths=lens, window=cfg.window)
    (valid, kw), = seen
    assert valid.tolist() == [4, 16]
    assert "window" not in kw or kw["window"] is None


@pytest.mark.parametrize("prompt", PROMPTS)
@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("arch", ARCHS)
def test_local_block_matches_reference(arch, dtype, prompt):
    """``block_init`` / ``block_cache_init`` / ``block_apply`` of the
    ``local`` kind: the tree (sandwich norms, gemma3's q/k norms), the
    ring cache, a prefill and the decode steps across the wrap, outputs
    and cache contents."""
    jcfg, cfg = _cfgs(arch, dtype)
    jp = JB.block_init("local", jax.random.PRNGKey(4), jcfg)
    p = _params(jp)
    meta = B.block_init("local", None, cfg, torch.device("meta"))
    assert {k: (tuple(v.shape), v.dtype) for k, v in _flat(meta).items()} \
        == {k: (tuple(v.shape), v.dtype) for k, v in _flat(p).items()}
    assert {"ln1p", "ln2p"} <= set(p)
    assert ("qn" in p["attn"]) == cfg.qk_norm
    jcache = JB.block_cache_init("local", jcfg, BATCH, S_MAX)
    cache = B.block_cache_init("local", cfg, BATCH, S_MAX, "cpu")
    assert cache["k"].shape[1] == cfg.window
    jx, x = _x(jcfg, prompt, 5)
    jpos, pos = _prefill_pos(prompt)
    jy, jcache, _ = JB.block_apply("local", jp, jx, jcache,
                                   JB.Ctx(cfg=jcfg, mode="prefill",
                                          positions=jpos))
    y, cache = B.block_apply("local", p, x, cache,
                             B.Ctx(cfg=cfg, mode="prefill", positions=pos))
    _close(y, jy, dtype)
    for step, lens in enumerate(_decode_lens(prompt)):
        jx, x = _x(jcfg, 1, 20 + step)
        jkw, kw = _kw(lens)
        jy, jcache, _ = JB.block_apply("local", jp, jx, jcache,
                                       JB.Ctx(cfg=jcfg, mode="decode", **jkw))
        y, cache = B.block_apply("local", p, x, cache,
                                 B.Ctx(cfg=cfg, mode="decode", **kw))
        _close(y, jy, dtype)
    for name in ("k", "v"):
        _close(cache[name], jcache[name], dtype)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}"))
        return out
    return {path: tree}


@pytest.mark.parametrize("arch", ARCHS)
def test_local_block_in_train_mode_matches_reference(arch):
    """No cache: the windowed attention alone over 40 positions, 24 of
    them beyond the window."""
    jcfg, cfg = _cfgs(arch)
    jp = JB.block_init("local", jax.random.PRNGKey(6), jcfg)
    jx, x = _x(jcfg, S_MAX, 7)
    jpos, pos = _prefill_pos(S_MAX)
    jy, _, _ = JB.block_apply("local", jp, jx, None,
                              JB.Ctx(cfg=jcfg, mode="train", positions=jpos))
    y, cache = B.block_apply("local", _params(jp), x, None,
                             B.Ctx(cfg=cfg, mode="train", positions=pos))
    assert cache is None
    _close(y, jy, "float32")


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_local_cache_is_the_window(arch):
    """At full width the ``local`` layers' cache is a ring of ``window``
    slots (gemma2 4096, gemma3 512) where the serving cache is longer, and
    the global ``attn`` layers' the whole length; both as the
    reference's."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    for s_max in (544, 4168):
        for kind in ("local", "attn"):
            got = B.block_cache_init(kind, cfg, 4, s_max,
                                     torch.device("meta"))
            want = jax.eval_shape(
                lambda k=kind: JB.block_cache_init(k, jcfg, 4, s_max))
            assert {n: tuple(t.shape) for n, t in got.items()} == \
                {n: tuple(t.shape) for n, t in want.items()}
            slots = min(cfg.window, s_max) if kind == "local" else s_max
            assert got["k"].shape == (4, slots, cfg.n_kv_heads,
                                      cfg.head_dim)
