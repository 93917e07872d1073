"""The port's MLA attention (``models/attention.py`` ``mla_*``) and the
``attn``, ``moe_dense`` and MLA ``moe`` transformer blocks against the
JAX reference, on the CPU.

Both branches of ``q_lora_rank``: deepseek-v2-lite-16b ``reduced()``
(no q-lora; d 64, 4 heads, kv_lora 32, rope 8, nope 16, v 16) and
minicpm3-4b ``reduced()`` (q_lora 32, the same head dims).  The same
numpy-made inputs and the reference's params go through both packages:
a prefill of 12 positions into a 16-slot cache, then 3 decode steps in
the reference's absorbed form (one of them at ragged lengths), the
outputs and the cache contents held within the reference's kernel TOL
(float32 2e-4, bf16 3e-2).  The reference runs its attention on the
vector tier here, as it does for MLA's split head dims everywhere.
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
ARCHS = ("deepseek-v2-lite-16b", "minicpm3-4b")
BATCH, PROMPT, S_MAX = 2, 12, 16
# the decode steps' lengths: two in step, then row 1 back at position 13
# (its slot rewritten), as a ragged batch
DECODE_LENS = ((12, 12), (13, 13), (14, 13))


def _cfgs(arch, dtype="float32"):
    return (jget_config(arch).reduced().replace(dtype=dtype),
            get_config(arch).reduced().replace(dtype=dtype))


def _params(jparams):
    return convert._map(jax.tree.map(np.asarray, jparams),
                        lambda a: convert.tensor(a, "cpu"))


def _x(cfg, s, seed):
    """(B, S, d) inputs in the config's dtype: the reference's array and
    the port's tensor, bitwise equal."""
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


def _positions(lens):
    lens = np.asarray(lens, np.int32)
    return (dict(positions=jnp.asarray(lens[:, None]),
                 lengths=jnp.asarray(lens)),
            dict(positions=torch.from_numpy(lens[:, None]),
                 lengths=torch.from_numpy(lens)))


def _tree(t):
    if isinstance(t, dict):
        return {k: _tree(v) for k, v in t.items()}
    return (tuple(t.shape), str(t.dtype).replace("torch.", ""))


@pytest.mark.parametrize("arch", ARCHS)
def test_mla_init_tree_matches_reference(arch):
    """Full width: the same keys, shapes and dtypes (w_dq, q_norm, w_uq
    for minicpm3's q-lora; wq for deepseek)."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    jtree = jax.eval_shape(lambda k: JA.mla_init(k, jcfg),
                           jax.random.PRNGKey(0))
    want = _tree(jax.tree.map(lambda a: a, jtree))
    got = _tree(A.mla_init(None, cfg, torch.device("meta")))
    assert got == want
    assert ("wq" in got) == (not cfg.q_lora_rank)
    cache = A.mla_cache_init(cfg, 4, 544, torch.device("meta"))
    jcache = jax.eval_shape(lambda: JA.mla_cache_init(jcfg, 4, 544))
    assert _tree(cache) == _tree(jax.tree.map(lambda a: a, jcache))
    assert cache["c_kv"].shape == (4, 544, cfg.kv_lora_rank)


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("arch", ARCHS)
def test_mla_apply_matches_reference(arch, dtype):
    """Prefill (split-dim attention on the vector tier), then the absorbed
    decode over the compressed cache, written in place."""
    jcfg, cfg = _cfgs(arch, dtype)
    jp = JA.mla_init(jax.random.PRNGKey(1), jcfg)
    p = _params(jp)
    jcache = JA.mla_cache_init(jcfg, BATCH, S_MAX)
    cache = A.mla_cache_init(cfg, BATCH, S_MAX, "cpu")
    jx, x = _x(jcfg, PROMPT, 0)
    pos = np.tile(np.arange(PROMPT, dtype=np.int32), (BATCH, 1))
    jy, jcache = JA.mla_apply(jp, jx, jcfg, positions=jnp.asarray(pos),
                              mode="prefill", cache=jcache)
    with trace.count() as counted:
        y, got_cache = A.mla_apply(p, x, cfg,
                                   positions=torch.from_numpy(pos),
                                   mode="prefill", cache=cache)
    assert got_cache is cache                    # written in place
    assert ("attention", "vector") in counted["per_op"]
    _close(y, jy, dtype)
    for name in ("c_kv", "k_rope"):
        _close(cache[name], jcache[name], dtype)
    for step, lens in enumerate(DECODE_LENS):
        jx, x = _x(jcfg, 1, 10 + step)
        jkw, kw = _positions(lens)
        jy, jcache = JA.mla_apply(jp, jx, jcfg, mode="decode", cache=jcache,
                                  **jkw)
        with trace.count() as counted:
            y, cache = A.mla_apply(p, x, cfg, mode="decode", cache=cache,
                                   **kw)
        # the absorbed decode dispatches no attention op
        assert {op for op, _ in counted["per_op"]} == {"gemm"}
        assert y.shape == (BATCH, 1, cfg.d_model) and y.dtype == x.dtype
        _close(y, jy, dtype)
        for name in ("c_kv", "k_rope"):
            _close(cache[name], jcache[name], dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_mla_train_mode_matches_reference(arch):
    """No cache: the prefill's attention alone."""
    jcfg, cfg = _cfgs(arch)
    jp = JA.mla_init(jax.random.PRNGKey(2), jcfg)
    jx, x = _x(jcfg, PROMPT, 3)
    pos = np.tile(np.arange(PROMPT, dtype=np.int32), (BATCH, 1))
    jy, _ = JA.mla_apply(jp, jx, jcfg, positions=jnp.asarray(pos),
                         mode="train")
    y, cache = A.mla_apply(_params(jp), x, cfg,
                           positions=torch.from_numpy(pos), mode="train")
    assert cache is None
    _close(y, jy, "float32")


# (label, arch, kind): minicpm3's dense block; deepseek's dense first
# layer and its MoE layers (both MLA); a GQA attn block (granite's
# attention with a dense FFN)
BLOCKS = [("minicpm3_attn", "minicpm3-4b", "attn"),
          ("deepseek_moe_dense", "deepseek-v2-lite-16b", "moe_dense"),
          ("deepseek_moe", "deepseek-v2-lite-16b", "moe"),
          ("gqa_attn", "granite-moe-1b-a400m", "attn")]


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("label,arch,kind", BLOCKS,
                         ids=[b[0] for b in BLOCKS])
def test_block_matches_reference(label, arch, kind, dtype):
    """``block_init`` / ``block_cache_init`` / ``block_apply`` of the kind
    against the reference's on its params: the tree, then a prefill and
    the decode steps, outputs and cache contents."""
    jcfg, cfg = _cfgs(arch, dtype)
    jp = JB.block_init(kind, jax.random.PRNGKey(4), jcfg)
    p = _params(jp)
    meta = B.block_init(kind, None, cfg, torch.device("meta"))
    assert _tree(meta) == _tree(p)
    if kind == "moe_dense":
        assert p["ffn"]["wu"].shape == (cfg.d_model, cfg.d_ff_dense)
    jcache = JB.block_cache_init(kind, jcfg, BATCH, S_MAX)
    cache = B.block_cache_init(kind, cfg, BATCH, S_MAX, "cpu")
    assert set(cache) == ({"c_kv", "k_rope"} if cfg.attn_kind == "mla"
                          else {"k", "v"})
    jx, x = _x(jcfg, PROMPT, 5)
    pos = np.tile(np.arange(PROMPT, dtype=np.int32), (BATCH, 1))
    jctx = JB.Ctx(cfg=jcfg, mode="prefill", positions=jnp.asarray(pos))
    ctx = B.Ctx(cfg=cfg, mode="prefill", positions=torch.from_numpy(pos))
    jy, jcache, _ = JB.block_apply(kind, jp, jx, jcache, jctx)
    y, cache = B.block_apply(kind, p, x, cache, ctx)
    _close(y, jy, dtype)
    for step, lens in enumerate(DECODE_LENS):
        jx, x = _x(jcfg, 1, 20 + step)
        jkw, kw = _positions(lens)
        jctx = JB.Ctx(cfg=jcfg, mode="decode", **jkw)
        ctx = B.Ctx(cfg=cfg, mode="decode", **kw)
        jy, jcache, _ = JB.block_apply(kind, jp, jx, jcache, jctx)
        y, cache = B.block_apply(kind, p, x, cache, ctx)
        _close(y, jy, dtype)
    for name in cache:
        _close(cache[name], jcache[name], dtype)
