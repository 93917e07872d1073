"""The port's training path against the JAX reference, on the CPU.

``data/pipeline.SyntheticLM`` rows bitwise the reference's; ``optim/
adamw`` (init, the schedule over steps 0..300, update) on seeded trees,
fp32 within 1e-6 and bf16 params bitwise; ``optim/compression`` int8
payloads bitwise, scales within 1e-7; ``kernels/ref.softmax_xent``
within 1e-6 over a padded vocab; ``train/loop.make_train_step`` against
``jax.jit(make_train_step)`` from the same state (carried across by
``models/convert.from_jax``) for every served arch reduced, in float32
and under both packages' CPU policy (the vector tier): the loss within
1e-5 relative and the params within the reference's own accumulation
tolerances (rtol 1e-4, atol 1e-5) after one and after three steps, the
MoE archs' aux loss non-zero; accum 1 equal to accum 2; ``train()``
lowering the loss over 20 steps.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import pipeline as JP
from repro.kernels import ref as jref
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.optim import compression as jcompression
from repro.train import loop as jloop
from repro_torch import tree
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.data import pipeline as P
from repro_torch.kernels import ref
from repro_torch.models import convert
from repro_torch.models import model as M
from repro_torch.optim import adamw, compression
from repro_torch.train import loop

BATCH, SEQ, ACCUM = 4, 32, 2


def _cfgs(arch, dtype="float32"):
    return (jget_config(arch).reduced().replace(dtype=dtype),
            get_config(arch).reduced().replace(dtype=dtype))


def _init(cfg, seed=0):
    return M.init(cfg, torch.Generator().manual_seed(seed), "cpu")


def _np(t):
    """A tensor (bf16 through its bits) or a jax array as numpy."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy()
        return t.numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


# ---------------------------------------------------------------------------
# SyntheticLM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seq,batch,seed,step", [
    (1000, 64, 8, 1, 5), (32_000, 512, 2, 0, 0), (256, 33, 3, 7, 11)])
def test_synthetic_rows_are_the_reference_rows(vocab, seq, batch, seed, step):
    want = JP.SyntheticLM(vocab, seq, batch, seed=seed).batch(step)
    got = P.SyntheticLM(vocab, seq, batch, seed=seed).batch(step,
                                                           device="cpu")
    for k in ("tokens", "targets"):
        assert got[k].dtype == torch.int64
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_array_equal(got["tokens"][:, 1:].numpy(),
                                  got["targets"][:, :-1].numpy())


def test_synthetic_host_shards_tile_the_batch():
    d = P.SyntheticLM(1000, 64, 8, seed=1)
    full = d.batch(5, device="cpu", dtype=torch.int32)
    assert full["tokens"].dtype == torch.int32
    parts = [d.host_batch(5, h, 2, device="cpu", dtype=torch.int32)
             for h in range(2)]
    want = JP.SyntheticLM(1000, 64, 8, seed=1).host_batch(5, 1, 2)
    np.testing.assert_array_equal(parts[1]["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    np.testing.assert_array_equal(
        torch.cat([p["tokens"] for p in parts]).numpy(),
        full["tokens"].numpy())


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _tree(seed, dtype, scale=1.0):
    """A nested dict/list tree of numpy-made arrays in ``dtype``: the
    reference's (jax) and the port's (torch), bitwise equal."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (33, 17), "b": [(5,), (4, 3, 2)], "c": {"d": (64,)}}

    def make(shape):
        x = (rng.standard_normal(shape) * scale).astype(np.float32)
        jx = jnp.asarray(x).astype(dtype)
        return jx, convert.tensor(np.asarray(jx), "cpu")
    pairs = jax.tree.map(make, shapes, is_leaf=lambda s: isinstance(s, tuple))
    j = jax.tree.map(lambda p: p[0], pairs,
                     is_leaf=lambda s: isinstance(s, tuple))
    t = jax.tree.map(lambda p: p[1], pairs,
                     is_leaf=lambda s: isinstance(s, tuple))
    return j, t


def test_schedule_matches_reference_over_300_steps():
    cfg = adamw.AdamWConfig(warmup_steps=20, total_steps=250)
    jcfg = jadamw.AdamWConfig(warmup_steps=20, total_steps=250)
    steps = np.arange(301, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda s: jadamw.schedule(jcfg, s))(
        jnp.asarray(steps)))
    got = np.array([float(adamw.schedule(cfg, torch.tensor(s)))
                    for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_matches_reference(dtype):
    jp, p = _tree(0, dtype)
    jo, o = jadamw.init(jp), adamw.init(p)
    assert o["step"].dtype == torch.int32 and int(o["step"]) == 0
    for k in ("m", "v", "master"):
        for a, b in zip(tree.leaves(o[k]), jax.tree.leaves(jo[k])):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the masters are copies: an update of one leaves the params as they are
    before = [x.clone() for x in tree.leaves(p)]
    for w in tree.leaves(o["master"]):
        w.add_(1.0)
    for a, b in zip(tree.leaves(p), before):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_update_matches_reference(dtype):
    """Three updates with seeded gradients, the clip active on the second
    (its gradients scaled past grad_clip): moments and masters within
    1e-6, bf16 params bitwise, the params the same leaf tensors."""
    cfg = adamw.AdamWConfig(warmup_steps=2, total_steps=10, lr=1e-2)
    jcfg = jadamw.AdamWConfig(warmup_steps=2, total_steps=10, lr=1e-2)
    jp, p = _tree(0, dtype)
    for x in tree.leaves(p):
        x.requires_grad_(True)
    ids = [id(x) for x in tree.leaves(p)]
    jo, o = jadamw.init(jp), adamw.init(p)
    for i in range(3):
        jg, g = _tree(10 + i, "float32", scale=20.0 if i == 1 else 0.05)
        jp, jo, jm = jadamw.update(jg, jo, jp, jcfg)
        p, o, m = adamw.update(g, o, p, cfg)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        assert int(o["step"]) == int(jo["step"]) == i + 1
        for k in ("m", "v", "master"):
            for a, b in zip(tree.leaves(o[k]), jax.tree.leaves(jo[k])):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-6, atol=1e-7)
        for a, b in zip(tree.leaves(p), jax.tree.leaves(jp)):
            assert a.requires_grad and str(a.dtype)[6:] == dtype
            if dtype == "bfloat16":
                np.testing.assert_array_equal(_np(a), _np(b))
            else:
                np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6,
                                           atol=1e-7)
    assert [id(x) for x in tree.leaves(p)] == ids


# ---------------------------------------------------------------------------
# compression, softmax_xent
# ---------------------------------------------------------------------------

def test_compression_payloads_are_bitwise():
    """Two steps of compress with error feedback: the int8 payloads equal
    the reference's bit for bit, the scales and carried errors within
    1e-7, and decompress + error gives back the input."""
    jg, g = _tree(3, "float32", scale=1e-3)
    jerr, err = jcompression.err_init(jg), compression.err_init(g)
    for step in range(2):
        jpacked, jerr = jcompression.compress(jg, jerr)
        packed, new_err = compression.compress(g, err)
        for a, b in zip(tree.leaves(packed["q"]),
                        jax.tree.leaves(jpacked["q"])):
            assert a.dtype == torch.int8
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(tree.leaves(packed["scale"]),
                        jax.tree.leaves(jpacked["scale"])):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-7)
        for a, b in zip(tree.leaves(new_err), jax.tree.leaves(jerr)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-7 * float(np.abs(b).max()))
        deq = compression.decompress(packed)
        for d, e, x, e0 in zip(tree.leaves(deq), tree.leaves(new_err),
                               tree.leaves(g), tree.leaves(err)):
            np.testing.assert_allclose((d + e).numpy(), (x + e0).numpy(),
                                       rtol=1e-6, atol=1e-9)
        err = new_err


def test_softmax_xent_matches_reference_over_the_padded_vocab():
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((3, 7, 512)) * 4).astype(np.float32)
    logits[..., 500:] = -1e30             # head_apply's padded columns
    labels = rng.integers(0, 500, (3, 7)).astype(np.int32)
    for dt in (jnp.float32, jnp.bfloat16):
        jl = jnp.asarray(logits).astype(dt)
        want = np.asarray(jref.softmax_xent(jl, jnp.asarray(labels)))
        got = ref.softmax_xent(convert.tensor(np.asarray(jl), "cpu"),
                               torch.from_numpy(labels))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the train step against the reference's, every served arch
# ---------------------------------------------------------------------------

def _batches(jcfg, cfg, steps):
    jd = JP.SyntheticLM(jcfg.vocab_size, SEQ, BATCH)
    d = P.SyntheticLM(cfg.vocab_size, SEQ, BATCH)
    jx, x = JP.extra_inputs(jcfg, BATCH), P.extra_inputs(cfg, BATCH,
                                                         device="cpu")
    return [({**jd.batch(s), **jx}, {**d.batch(s, device="cpu"), **x})
            for s in range(steps)]


@functools.cache
def _trajectory(arch):
    """Three steps of both packages' train step (accum 2) from the
    reference's init carried across: per step the metrics, and the
    reference's params (in the port's layout) and the port's after it."""
    jcfg, cfg = _cfgs(arch)
    jp = JM.init(jcfg, jax.random.PRNGKey(0))
    jo = jadamw.init(jp)
    p = loop.trainable(convert.from_jax(jax.tree.map(np.asarray, jp), cfg,
                                        device="cpu"))
    o = convert.from_jax(jax.tree.map(np.asarray, jo), cfg, device="cpu")
    jstep = jax.jit(jloop.make_train_step(jcfg,
                                          jloop.TrainConfig(accum=ACCUM)))
    step = loop.make_train_step(cfg, loop.TrainConfig(accum=ACCUM))
    out = []
    for jb, b in _batches(jcfg, cfg, 3):
        jp, jo, _, jm = jstep(jp, jo, None, jb)
        p, o, _, m = step(p, o, None, b)
        out.append({"want": {k: float(v) for k, v in jm.items()},
                    "got": {k: float(v) for k, v in m.items()},
                    "want_params": convert.from_jax(
                        jax.tree.map(np.asarray, jp), cfg, device="cpu"),
                    "params": [x.detach().clone() for x in tree.leaves(p)]})
    return out


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_train_step_matches_reference(arch, steps):
    run = _trajectory(arch)[steps - 1]
    got, want = run["got"], run["want"]
    for k in ("loss", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=0,
                                   err_msg=k)
    moe = get_config(arch).n_experts > 0
    assert (got["aux"] > 0) == moe
    leaves = tree.leaves(run["want_params"])
    assert len(leaves) == len(run["params"])
    for a, b in zip(run["params"], leaves):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_loss_is_mean_xent_plus_a_hundredth_of_aux():
    """granite reduced: loss_fn's value is its mean xent + 0.01 aux, the
    reference's fixed coefficient (TrainConfig.aux_coef is not read:
    ROADMAP C.27), and the aux is non-zero."""
    jcfg, cfg = _cfgs("granite-moe-1b-a400m")
    jp = JM.init(jcfg, jax.random.PRNGKey(0))
    p = convert.from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    jb, b = _batches(jcfg, cfg, 1)[0]
    loss, (xent, aux) = loop.loss_fn(p, cfg, b)
    jloss, (jxent, jaux) = jloop.loss_fn(jp, jcfg, jb)
    assert float(aux) > 0
    assert float(loss) == pytest.approx(float(xent) + 0.01 * float(aux),
                                        rel=1e-6)
    np.testing.assert_allclose([float(loss), float(xent), float(aux)],
                               [float(jloss), float(jxent), float(jaux)],
                               rtol=1e-5)


def test_grad_accum_equivalent():
    """accum 2 matches accum 1 on the same global batch (fp32)."""
    _, cfg = _cfgs("gemma2-2b")
    batch = P.SyntheticLM(cfg.vocab_size, SEQ, BATCH).batch(0, device="cpu")
    outs = []
    for accum in (1, 2):
        p = loop.trainable(_init(cfg))
        o = adamw.init(p)
        step = loop.make_train_step(cfg, loop.TrainConfig(accum=accum))
        p, _, _, m = step(p, o, None, batch)
        outs.append(([x.detach() for x in tree.leaves(p)], float(m["loss"])))
    np.testing.assert_allclose(outs[0][1], outs[1][1], rtol=1e-5)
    for a, b in zip(outs[0][0], outs[1][0]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_every_leaf_gets_a_gradient():
    """A param that autograd cannot reach makes the step raise, where a
    kernel output without a grad_fn would otherwise drop its gradient."""
    _, cfg = _cfgs("gemma2-2b")
    p = loop.trainable(_init(cfg))
    p["orphan"] = torch.zeros(3, requires_grad=True)
    batch = P.SyntheticLM(cfg.vocab_size, SEQ, BATCH).batch(0, device="cpu")
    step = loop.make_train_step(cfg, loop.TrainConfig())
    with pytest.raises(RuntimeError, match="not have been used"):
        step(p, adamw.init(p), None, batch)


def test_loss_decreases():
    _, cfg = _cfgs("gemma2-2b", "bfloat16")
    res = loop.train(cfg, steps=20, batch_size=4, seq_len=32,
                     log_every=1000, device="cpu")
    losses = [h["loss"] for h in res["history"]]
    assert [h["step"] for h in res["history"]] == list(range(20))
    assert losses[-1] < losses[0]
    assert all(x.requires_grad for x in tree.leaves(res["params"]))


def test_compressed_training_still_learns():
    _, cfg = _cfgs("gemma2-2b", "bfloat16")
    res = loop.train(cfg, steps=15, batch_size=4, seq_len=32,
                     tcfg=loop.TrainConfig(compress_grads=True),
                     log_every=1000, device="cpu")
    losses = [h["loss"] for h in res["history"]]
    assert losses[-1] < losses[0]


def test_launcher_trains_and_refuses_a_coordinator(capsys):
    from repro_torch.launch import train as launch
    launch.main(["--arch", "gemma2-2b", "--reduced", "--device", "cpu",
                 "--steps", "3", "--batch", "2", "--seq", "16",
                 "--accum", "2"])
    out = capsys.readouterr().out
    assert out.startswith("done: step 2 loss ")
    assert "restarts 0 stragglers 0" in out
    with pytest.raises(NotImplementedError, match="A.13"):
        launch.main(["--arch", "gemma2-2b", "--reduced", "--device", "cpu",
                     "--coordinator", "localhost:1234", "--num-hosts", "2"])
