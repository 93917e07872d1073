"""The port's MoE (``models/moe.py``) and transformer block against the
JAX reference, on the CPU.

Two routings: granite-moe-1b-a400m ``reduced()`` (8 experts, top-2, d 64,
d_expert 32) and a narrow config at granite's own routing (32 experts,
top-8).  The same numpy-made inputs and the reference's params go
through both packages, in float32 (held to 2e-4) and bf16 (3e-2, the
reference's kernel TOLs).  ``_dispatch_compute`` is fed the reference's
own (gates, idx), so that a near-tie in the router cannot hide in the
comparison; ``moe_apply`` is then checked whole.  A low capacity factor
drops choices, and the port keeps exactly the reference's; two shared
experts take deepseek's branch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import blocks as JB
from repro.models import moe as JMoE
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.models import blocks as B
from repro_torch.models import convert
from repro_torch.models import moe as MoE

TOL = {"float32": 2e-4, "bfloat16": 3e-2}
ARCH = "granite-moe-1b-a400m"
# label -> config changes on top of reduced()
ROUTINGS = {"reduced": {}, "granite_routing": dict(n_experts=32, top_k=8)}


def _cfgs(routing="reduced", dtype="float32", **kw):
    kw = {**ROUTINGS[routing], "dtype": dtype, **kw}
    return (jget_config(ARCH).reduced().replace(**kw),
            get_config(ARCH).reduced().replace(**kw))


def _params(jparams):
    return convert._map(jax.tree.map(np.asarray, jparams),
                        lambda a: convert.tensor(a, "cpu"))


def _x(cfg, b=2, s=24, seed=0):
    """(B, S, d) inputs in the config's dtype: the reference's array and
    the port's tensor, bitwise equal."""
    x = np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(cfg.dtype)
    return jx, convert.tensor(np.asarray(jx), "cpu")


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, dtype):
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


def _setup(routing, dtype, **kw):
    jcfg, cfg = _cfgs(routing, dtype, **kw)
    jp = JMoE.moe_init(jax.random.PRNGKey(1), jcfg)
    jx, x = _x(jcfg)
    return jcfg, cfg, jp, _params(jp), jx, x


CASES = [(r, dt) for r in ROUTINGS for dt in TOL]


@pytest.mark.parametrize("routing", sorted(ROUTINGS))
def test_capacity_matches_reference(routing):
    jcfg, cfg = _cfgs(routing)
    for t in (1, 4, 7, 24, 100, 511, 2048, 4096):
        assert MoE.capacity(cfg, t) == JMoE.capacity(jcfg, t)
    # granite at serving size: a 4 x 512 prefill and a 4-token decode step
    full = get_config(ARCH)
    assert (MoE.capacity(full, 2048), MoE.capacity(full, 4)) == (640, 8)


def test_init_tree_matches_reference():
    """moe_init's leaves (with two shared experts too) have the
    reference's shapes and dtypes: the router float32, the experts
    stacked (E, d, f) in the model's dtype."""
    for kw in ({}, {"n_shared_experts": 2}):
        jcfg, cfg = _cfgs("granite_routing", "bfloat16", **kw)
        want = jax.eval_shape(lambda k: JMoE.moe_init(k, jcfg),
                              jax.random.PRNGKey(0))
        got = MoE.moe_init(None, cfg, torch.device("meta"))
        flat = jax.tree_util.tree_flatten_with_path(want)[0]
        assert len(flat) == len(tree.leaves(got))
        for path, leaf in flat:
            t = got
            for key in path:
                t = t[key.key]
            assert tuple(t.shape) == tuple(leaf.shape)
            assert str(t.dtype)[6:] == str(leaf.dtype)


@pytest.mark.parametrize("routing,dtype", CASES)
def test_route_matches_reference(routing, dtype):
    jcfg, cfg, jp, p, jx, x = _setup(routing, dtype)
    xt, jxt = x.reshape(-1, cfg.d_model), jx.reshape(-1, jcfg.d_model)
    gates, idx, aux = MoE._route(p, xt, cfg)
    jgates, jidx, jaux = JMoE._route(jp, jxt, jcfg)
    assert gates.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(gates.numpy(), np.asarray(jgates),
                               rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("routing,dtype", CASES)
def test_dispatch_compute_matches_reference(routing, dtype):
    """Fed the reference's own (gates, idx), at the capacity the no-mesh
    branch takes and over a slice of the experts (the expert-parallel
    rank's view: choices on other experts contribute 0)."""
    jcfg, cfg, jp, p, jx, x = _setup(routing, dtype)
    jxt = jx.reshape(-1, jcfg.d_model)
    xt = x.reshape(-1, cfg.d_model)
    jgates, jidx, _ = JMoE._route(jp, jxt, jcfg)
    gates, idx = torch.from_numpy(np.array(jgates)), \
        torch.from_numpy(np.array(jidx))
    cap = JMoE.capacity(jcfg, xt.shape[0])
    e = cfg.n_experts
    for e_lo, e_local in ((0, e), (e // 4, e // 2)):
        jp_l = {k: v[e_lo:e_lo + e_local] for k, v in jp.items()
                if k.startswith("we_")}
        p_l = {k: v[e_lo:e_lo + e_local] for k, v in p.items()
               if k.startswith("we_")}
        want = JMoE._dispatch_compute(jp_l, jxt, jgates, jidx, jcfg, cap,
                                      e_lo, e_local)
        got = MoE._dispatch_compute(p_l, xt, gates, idx, cfg, cap, e_lo,
                                    e_local)
        assert got.dtype == xt.dtype and got.shape == xt.shape
        _close(got, want, dtype)


@pytest.mark.parametrize("routing,dtype", CASES)
def test_moe_apply_matches_reference(routing, dtype):
    jcfg, cfg, jp, p, jx, x = _setup(routing, dtype)
    jy, jaux = JMoE.moe_apply(jp, jx, jcfg)
    y, aux = MoE.moe_apply(p, x, cfg)
    assert y.shape == x.shape and y.dtype == x.dtype
    assert bool(y.float().isfinite().all())
    _close(y, jy, dtype)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def _reference_keep(jp, jxt, jidx, jcfg, cap):
    """The reference's keep mask (T, k), read off its own dispatch: with
    the gates one-hot on choice j, a token's output row is non-zero
    exactly where choice j was kept (the expert weights are random)."""
    t, k = jidx.shape
    keep = np.zeros((t, k), bool)
    for j in range(k):
        gates = jnp.zeros((t, k), jnp.float32).at[:, j].set(1.0)
        y = JMoE._dispatch_compute(jp, jxt, gates, jidx, jcfg, cap, 0,
                                   jcfg.n_experts)
        keep[:, j] = np.abs(np.asarray(y.astype(jnp.float32))).max(-1) > 0
    return keep


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_dropped_choices_match_reference(dtype):
    """capacity_factor 0.25 at granite's routing: 48 tokens x 8 choices
    over 32 experts, capacity 8; the port keeps exactly the reference's
    choices (each within its expert's first 8, in token order), and
    moe_apply agrees with some choices dropped."""
    jcfg, cfg, jp, p, jx, x = _setup("granite_routing", dtype,
                                     capacity_factor=0.25)
    jxt, xt = jx.reshape(-1, jcfg.d_model), x.reshape(-1, cfg.d_model)
    _, jidx, _ = JMoE._route(jp, jxt, jcfg)
    cap = JMoE.capacity(jcfg, xt.shape[0])
    assert cap == MoE.capacity(cfg, xt.shape[0]) == 8
    want = _reference_keep(jp, jxt, jidx, jcfg, cap)
    idx = torch.from_numpy(np.array(jidx))
    _, pos, keep = MoE._slots(idx, cap, 0, cfg.n_experts)
    keep = keep.reshape(want.shape).numpy()
    assert 0 < (~want).sum() < want.size        # some, not all, dropped
    np.testing.assert_array_equal(keep, want)
    assert (pos.numpy()[~keep.reshape(-1)] == cap).all()
    # per expert, the kept choices are its first `cap` in token order
    flat = np.asarray(jidx).reshape(-1)
    for ex in range(cfg.n_experts):
        mine = np.flatnonzero(flat == ex)
        np.testing.assert_array_equal(keep.reshape(-1)[mine],
                                      np.arange(mine.size) < cap)
    jy, _ = JMoE.moe_apply(jp, jx, jcfg)
    y, _ = MoE.moe_apply(p, x, cfg)
    _close(y, jy, dtype)


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_shared_experts_match_reference(dtype):
    """deepseek's branch: two shared experts (a gated MLP of width
    2 x d_expert) added to the routed output."""
    jcfg, cfg, jp, p, jx, x = _setup("granite_routing", dtype,
                                     n_shared_experts=2)
    assert p["shared"]["wu"].shape == (cfg.d_model, 2 * cfg.d_expert)
    jy, _ = JMoE.moe_apply(jp, jx, jcfg)
    y, _ = MoE.moe_apply(p, x, cfg)
    _close(y, jy, dtype)


# (label, ffn, config changes, window): granite's moe block; a dense FFN
# with gemma's sandwich norms, a window of 8 and a softcap
TBLOCKS = [("moe", "moe", {}, None),
           ("dense_sandwich_window", "dense",
            dict(sandwich_norm=True, softcap=30.0, window=8), 8)]


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("label,ffn,kw,window", TBLOCKS,
                         ids=[t[0] for t in TBLOCKS])
def test_tblock_matches_reference(label, ffn, kw, window, dtype):
    """The transformer block in prefill (12 positions into a 16-slot
    cache, or an 8-slot ring under the window) and then 3 decode steps,
    against the reference's ``_tblock_apply`` on the same params, cache
    and inputs."""
    jcfg, cfg = _cfgs("reduced", dtype, **kw)
    jp = JB._tblock_init(jax.random.PRNGKey(2), jcfg, ffn=ffn)
    p = _params(jp)
    b, s, s_max = 2, 12, 16
    jcache = JB._tblock_cache(jcfg, b, s_max, window=window)
    cache = B._tblock_cache(cfg, b, s_max, "cpu", window=window)
    jx, x = _x(jcfg, b, s, seed=3)
    pos = np.tile(np.arange(s), (b, 1))
    jctx = JB.Ctx(cfg=jcfg, mode="prefill", positions=jnp.asarray(pos))
    ctx = B.Ctx(cfg=cfg, mode="prefill", positions=torch.from_numpy(pos))
    jy, jcache, jaux = JB._tblock_apply(jp, jx, jcache, jctx, ffn=ffn,
                                        window=window)
    y, cache, aux = B._tblock_apply(p, x, cache, ctx, ffn=ffn, window=window)
    _close(y, jy, dtype)
    # the load-balance loss comes back, the reference's (0 for a dense FFN)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    for step in range(3):
        jx, x = _x(jcfg, b, 1, seed=4 + step)
        lens = np.full((b,), s + step, np.int32)
        jctx = JB.Ctx(cfg=jcfg, mode="decode",
                      positions=jnp.asarray(lens[:, None]),
                      lengths=jnp.asarray(lens))
        ctx = B.Ctx(cfg=cfg, mode="decode",
                    positions=torch.from_numpy(lens[:, None]),
                    lengths=torch.from_numpy(lens))
        jy, jcache, _ = JB._tblock_apply(jp, jx, jcache, jctx, ffn=ffn,
                                         window=window)
        y, cache, _ = B._tblock_apply(p, x, cache, ctx, ffn=ffn,
                                      window=window)
        _close(y, jy, dtype)
    for name in ("k", "v"):
        _close(cache[name], jcache[name], dtype)
