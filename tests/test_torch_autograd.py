"""Gradients through the kernel tier, on the CPU.

Each of the five autograd Functions of the train path (gemm, vtanh,
vsigmoid, flash_attention, ssd) under ``policy="pallas"``, where the
kernel entry runs its plain version on CPU tensors, against
``torch.autograd`` through the op's vector tier, within the op's TOL
(fp32 2e-4, bf16 3e-2; the elementwise ops' kernel TOL); gemm's clamp
mask; the Function in the graph; the dispatch selection unchanged by
``requires_grad``; remat's recompute under the forward's policy and
target on another thread; and every param leaf of every served arch
(reduced) given a gradient by a loss.backward() on the kernel tier equal
to the vector tier's, non-zero wherever that one is.  The guard that
refuses a raw kernel launch autograd cannot see needs the card
(``cuda``-marked).
"""
import threading

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.core import current_target, use_policy, use_target
from repro_torch.core.registry import REGISTRY
from repro_torch.data import pipeline as P
from repro_torch.kernels import elementwise as ew
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gemm as gemm_mod
from repro_torch.kernels import ops
from repro_torch.kernels import ssd as ssd_mod
from repro_torch.models import blocks as B
from repro_torch.models import model as M
from repro_torch.train import loop

TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}
EW_TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}
DTYPES = [torch.float32, torch.bfloat16]


def _t(shape, seed, dtype=torch.float32, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape) * scale
    return torch.from_numpy(x.astype(np.float32)).to(dtype) \
        .requires_grad_(True)


def _grads(fn, inputs, seed, policy):
    """fn(*inputs) under ``policy`` and the gradients of <y, w> for a
    seeded w, one per input that requires grad."""
    xs = [x.detach().clone().requires_grad_(x.requires_grad)
          if isinstance(x, torch.Tensor) else x for x in inputs]
    with use_policy(policy):
        y = fn(*xs)
    w = _t(y.shape, seed).detach().to(y.dtype)
    want = [x for x in xs if isinstance(x, torch.Tensor) and x.requires_grad]
    return y, torch.autograd.grad(y, want, w)


def _close(got, want, tol):
    scale = max(1.0, float(want.float().abs().max()))
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=tol, atol=tol * scale)


def _check(fn, inputs, tol, seed=99, fn_name=None):
    y, got = _grads(fn, inputs, seed, "pallas")
    if fn_name is not None:
        assert type(y.grad_fn).__name__ == fn_name
    _, want = _grads(fn, inputs, seed, "vector")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g is not None and g.dtype == w.dtype and g.shape == w.shape
        _close(g, w, tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bias", [False, True])
def test_gemm_gradients(dtype, bias):
    a, b = _t((37, 24), 0, dtype), _t((24, 19), 1, dtype, 24 ** -0.5)
    c = _t((19,), 2, dtype) if bias else None
    _check(lambda a, b, c: ops.gemm(a, b, c), (a, b, c), TOL[dtype],
           fn_name="GemmFnBackward")


def test_gemm_clamp_zeroes_the_gradient_where_the_bound_is_hit():
    a, b = _t((16, 8), 3), _t((8, 12), 4)
    c = _t((12,), 5)
    with use_policy("pallas"):
        y = ops.gemm(a, b, c, -0.5, 0.5)
    (y * _t(y.shape, 6).detach()).sum().backward()
    hit = (y <= -0.5) | (y >= 0.5)
    assert 0 < int(hit.sum()) < y.numel()
    y2 = ((a @ b + c) * _t(y.shape, 6).detach()
          * (~hit).float()).sum()
    ga, gb, gc = torch.autograd.grad(y2, (a, b, c))
    for got, want in ((a.grad, ga), (b.grad, gb), (c.grad, gc)):
        _close(got, want, 2e-4)
    # and the vector tier's clamp agrees
    _check(lambda a, b, c: ops.gemm(a, b, c, -0.5, 0.5), (a, b, c), 2e-4)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", ["vtanh", "vsigmoid"])
def test_elementwise_gradients(op, dtype):
    x = _t((3, 5, 67), 7, dtype, 3.0)
    _check(getattr(ops, op), (x,), EW_TOL[dtype],
           fn_name=f"{op.capitalize()}FnBackward")


ATTN_CASES = {
    "causal_gqa": ((2, 40, 4, 16), (2, 40, 2, 16), dict(causal=True)),
    "window_softcap": ((2, 33, 4, 16), (2, 33, 4, 16),
                       dict(causal=True, window=8, softcap=20.0)),
    "noncausal_cross": ((2, 5, 4, 16), (2, 9, 2, 16), dict(causal=False)),
    # Sq x Sk past 2048^2: the vector tier's chunked attention
    "chunked": ((1, 2064, 2, 8), (1, 2064, 1, 8), dict(causal=True)),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_attention_gradients(case, dtype):
    qs, ks, kw = ATTN_CASES[case]
    q, k, v = _t(qs, 10, dtype), _t(ks, 11, dtype), _t(ks, 12, dtype)
    _check(lambda q, k, v: ops.attention(q, k, v, **kw), (q, k, v),
           TOL[dtype], fn_name="FlashAttentionFnBackward")


def test_flash_backward_recomputes_a_row_at_a_time(monkeypatch):
    """The backward's batch cut into GRAD_ROWS runs gives the gradient of
    the whole batch."""
    q, k, v = _t((3, 20, 2, 8), 13), _t((3, 20, 2, 8), 14), \
        _t((3, 20, 2, 8), 15)
    fn = (lambda q, k, v: ops.attention(q, k, v))
    _, whole = _grads(fn, (q, k, v), 1, "vector")
    monkeypatch.setattr(fa, "GRAD_ROWS", 2)
    _, rows = _grads(fn, (q, k, v), 1, "pallas")
    for g, w in zip(rows, whole):
        _close(g, w, 1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s,D", [(100, True), (300, True), (300, False)])
def test_ssd_gradients(s, D, dtype):
    b, h, p, g, n = 2, 4, 8, 2, 16
    x = _t((b, s, h, p), 20, dtype)
    dt = torch.nn.functional.softplus(_t((b, s, h), 21)).detach() \
        .requires_grad_(True)
    A = (-torch.exp(_t((h,), 22) * 0.5)).detach().requires_grad_(True)
    Bm, Cm = _t((b, s, g, n), 23, dtype), _t((b, s, g, n), 24, dtype)
    Dv = _t((h,), 25) if D else None
    _check(lambda *a: ops.ssd(*a), (x, dt, A, Bm, Cm, Dv), TOL[dtype],
           fn_name="SsdFnBackward")


def test_a_call_without_grad_takes_the_bare_kernel():
    """Serving is unchanged: with no input requiring grad, or under
    no_grad, the kernel tier returns the entry's output, no Function."""
    a, b = _t((8, 8), 30).detach(), _t((8, 8), 31).detach()
    with use_policy("pallas"):
        assert ops.gemm(a, b).grad_fn is None
        with torch.no_grad():
            assert ops.gemm(a.requires_grad_(True), b).grad_fn is None


@pytest.mark.parametrize("op,args", [
    ("gemm", lambda g: (_t((64, 32), 0, g), _t((32, 48), 1, g), None,
                        float("-inf"), float("inf"))),
    ("vtanh", lambda g: (_t((4, 64, 128), 0, g),)),
    ("attention", lambda g: (_t((2, 64, 4, 16), 0, g),
                             _t((2, 64, 4, 16), 1, g),
                             _t((2, 64, 4, 16), 2, g),
                             True, None, None, None)),
    ("ssd", lambda g: (_t((2, 64, 4, 8), 0, g), _t((2, 64, 4), 1),
                       _t((4,), 2), _t((2, 64, 2, 16), 3, g),
                       _t((2, 64, 2, 16), 4, g), None)),
])
def test_selection_ignores_requires_grad(op, args):
    """The same tier and cost with and without requires_grad: the
    registry's key and costs read shapes and dtypes only."""
    for dtype in DTYPES:
        with_grad = args(dtype)
        without = tuple(a.detach() if isinstance(a, torch.Tensor) else a
                        for a in with_grad)
        for target in ("h100", "rvv-128", "tpu-v5e"):
            got = [REGISTRY.explain(op, *a, policy="pallas", target=target)
                   for a in (with_grad, without)]
            assert got[0]["chosen"] == got[1]["chosen"]
            assert got[0]["chosen_cost"] == got[1]["chosen_cost"]


def test_remat_recomputes_under_the_forward_scope():
    """The recompute of a checkpointed block runs on whatever thread runs
    the backward (autograd's own, on the card); it re-enters the policy
    and target of the forward."""
    cfg = get_config("gemma2-2b").reduced().replace(dtype="float32")
    assert cfg.remat
    params = loop.trainable(M.init(cfg, torch.Generator().manual_seed(0),
                                   "cpu"))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        2, cfg.vocab_size, (2, 8)))
    seen, apply = [], B.block_apply

    def probe(*a):
        seen.append((REGISTRY.policy, current_target().name,
                     torch.is_grad_enabled()))
        return apply(*a)
    B.block_apply = probe
    try:
        with use_policy("pallas"), use_target("rvv-128"):
            logits, _, _ = M.forward(params, cfg, {"tokens": tokens},
                                     mode="train")
        assert len(seen) == cfg.n_layers
        err = []
        t = threading.Thread(target=lambda: err.append(
            logits.float().sum().backward()))
        t.start()
        t.join(timeout=300)
        assert not t.is_alive()
    finally:
        B.block_apply = apply
    assert err == [None]
    assert len(seen) == 2 * cfg.n_layers
    assert set(seen) == {("pallas", "rvv-128", True)}
    assert all(p.grad is not None for p in tree.leaves(params))


def _arch_grads(arch, policy):
    cfg = get_config(arch).reduced().replace(dtype="float32")
    params = loop.trainable(M.init(cfg, torch.Generator().manual_seed(1),
                                   "cpu"))
    batch = {**P.SyntheticLM(cfg.vocab_size, 16, 2).batch(0, device="cpu"),
             **P.extra_inputs(cfg, 2, device="cpu")}
    with use_policy(policy):
        loss, _ = loop.loss_fn(params, cfg, batch)
        loss.backward()
    return float(loss.detach()), [p.grad for p in tree.leaves(params)]


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_every_leaf_gets_the_vector_tiers_gradient(arch):
    """loss.backward() on the kernel tier (h100 takes it for every op it
    is valid for) and on the vector tier, from the same params: every
    leaf's gradient present, within the fp32 TOL of the vector tier's,
    and non-zero wherever that one is (an expert no token reached is zero
    in both)."""
    kl, kg = _arch_grads(arch, "pallas")
    vl, vg = _arch_grads(arch, "vector")
    np.testing.assert_allclose(kl, vl, rtol=2e-4)
    assert len(kg) == len(vg)
    for g, w in zip(kg, vg):
        assert g is not None and w is not None
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= 2e-4 * max(scale, 1e-30)
        assert not bool(((w != 0) & (g == 0)).any())


@pytest.mark.parametrize("op", ["gemm", "vsigmoid"])
def test_the_reference_cannot_differentiate_its_kernel_tier(op):
    """ROADMAP C.26: ``jax.grad`` through the reference's kernel tier
    (Pallas, interpret mode on the CPU) raises, so the reference trains
    only on its vector tier; the port's kernel tier gives the vector
    tier's gradient (the port's terms of the same call)."""
    import jax
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    rng = np.random.default_rng(40)
    a = rng.standard_normal((16, 32)).astype(np.float32)
    b = rng.standard_normal((32, 24)).astype(np.float32)
    if op == "gemm":
        jfn = (lambda x, policy: jops.gemm(x, jnp.asarray(b),
                                           policy=policy).sum())
        fn = (lambda x: ops.gemm(x, torch.from_numpy(b)))
    else:
        jfn = (lambda x, policy: jops.vsigmoid(x, policy=policy).sum())
        fn = ops.vsigmoid
    with pytest.raises((AssertionError, ValueError)):
        jax.grad(jfn)(jnp.asarray(a), "pallas")
    want = np.asarray(jax.grad(jfn)(jnp.asarray(a), "vector"))
    x = torch.from_numpy(a).requires_grad_(True)
    with use_policy("pallas"):
        y = fn(x)
    assert type(y.grad_fn).__name__.endswith("FnBackward")
    (g,) = torch.autograd.grad(y.sum(), x)
    np.testing.assert_allclose(g.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(),
                    reason="needs an NVIDIA GPU")
def test_a_raw_kernel_call_that_needs_grad_raises():
    """Each of the thirteen entries, called on a CUDA tensor that requires
    grad with grad mode on, raises before it launches; under no_grad it
    launches."""
    dev = torch.device("cuda")
    x = torch.randn(4, 8, 8, 16, device=dev, requires_grad=True)
    w2 = torch.randn(16, 16, device=dev)
    calls = {
        "gemm": lambda: gemm_mod.gemm(x.reshape(-1, 16), w2),
        "vtanh": lambda: ew.vtanh(x), "vsigmoid": lambda: ew.vsigmoid(x),
        "vsqrt": lambda: ew.vsqrt(x), "vrelu": lambda: ew.vrelu(x),
        "flash_attention": lambda: fa.flash_attention(x, x, x),
        "ssd": lambda: ssd_mod.ssd(
            x.reshape(4, 8, 8, 16), torch.rand(4, 8, 8, device=dev),
            -torch.rand(8, device=dev), x[..., :2, :], x[..., :2, :]),
    }
    before = {k: v for m in (gemm_mod, ew, fa, ssd_mod)
              for k, v in m.LAUNCHES.items()}
    for op, call in calls.items():
        with pytest.raises(RuntimeError, match=op):
            call()
    after = {k: v for m in (gemm_mod, ew, fa, ssd_mod)
             for k, v in m.LAUNCHES.items()}
    assert after == before
    with torch.no_grad():
        assert calls["vtanh"]().grad_fn is None
