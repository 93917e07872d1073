"""int8 gradient compression over the ranks of a mesh, against the JAX
package's.

* ``compressed_psum`` on 8 gloo ranks against the reference's
  ``shard_map`` of its ``compressed_psum`` on an Auto mesh of 8 forced
  host devices (ROADMAP C.2), bitwise, on the reference test's input and
  on normals.
* ``compress_sharded`` on a (2, 2) mesh, fed each leaf's pieces of the
  same numpy gradient as the reference's ``compress`` of whole leaves
  (cut over 'data', 'model', both, unevenly down to an empty piece, or
  not at all), two steps with the error carried: q, scale and the error
  bitwise.  The control scales each piece by its own max and is caught.
* gemma2-2b ``reduced()`` float32, 2 layers, mesh (2, 1) (ZeRO-1 slices
  the error state), two steps of ``make_sharded_train_step`` with
  ``compress_grads`` against the reference's on 2 forced host devices:
  each step's loss and the final params within 2e-4; step 0's scales
  within 1e-5 of ``compress`` of the reference's gradient and its q
  within one step, the elements off by one counted (at most 1e-3 of
  them); the error after two steps within one scale step.  A per-shard
  scale fails the scale gate.
* mistral-large-123b ``reduced()`` float32, 2 layers of one pattern unit,
  which the reference stacks into one leaf a name and so scales by one
  max: ``make_train_step`` with ``compress_grads`` against the
  reference's, the carried error equal but where q is one step off (at
  most 1e-3 of the elements); a scale a layer (no ``stack_groups``)
  misses it.
"""
import json
import os
import pickle
import subprocess
import sys
import tempfile

import jax
import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import mesh as LM
from repro_torch.models import convert
from repro_torch.models import sharding as Sh
from repro_torch.optim import compression
from repro_torch.train import loop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-4
SCALE_TOL = 1e-5
FLIP_SHARE = 1e-3
TRAFFIC = dict(seq=16, batch=4)

REFERENCE = r"""
import json, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import AxisType, PartitionSpec as P
from repro.configs import get_config
from repro.data.pipeline import SyntheticLM
from repro.models import model as M, sharding as Sh
from repro.optim import adamw, compression
from repro.train import loop
traffic, path = json.loads(sys.argv[1])
inputs = np.load(path + ".inputs.npz")
mesh = jax.make_mesh((8,), ("pod",), axis_types=(AxisType.Auto,))
psum = []
for x in (inputs["a"], inputs["b"]):
    f = shard_map(lambda v: compression.compressed_psum(v[0], "pod")[None],
                  mesh=mesh, in_specs=P("pod", None),
                  out_specs=P("pod", None))
    psum.append(np.asarray(f(jnp.asarray(np.asarray(x, np.float32)))))
cfg = get_config("gemma2-2b").reduced().replace(dtype="float32", n_layers=2)
p0 = jax.tree.map(np.asarray, M.init(cfg, jax.random.PRNGKey(0)))
with open(path + ".params", "wb") as f:
    pickle.dump(p0, f)
print("params-ready", flush=True)
mesh = jax.make_mesh((2, 1), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
data = SyntheticLM(cfg.vocab_size, traffic["seq"], traffic["batch"])
batches = [data.batch(s) for s in range(2)]
params = jax.tree.map(jnp.asarray, p0)
psds = jax.eval_shape(lambda: params)
bsds = jax.eval_shape(lambda: batches[0])
tcfg = loop.TrainConfig(compress_grads=True)
step = loop.make_sharded_train_step(cfg, tcfg, mesh, psds, bsds)
with mesh:
    grad = jax.jit(jax.grad(lambda q, b: loop.loss_fn(q, cfg, b)[0]))
    with Sh.active_mesh(mesh):
        g0 = grad(params, batches[0])
    packed, _ = compression.compress(g0)
    p, o = jax.tree.map(jnp.array, params), adamw.init(params)
    e = compression.err_init(params)
    metrics = []
    for b in batches:
        p, o, e, m = step(p, o, e, b)
        metrics.append({k: float(v) for k, v in m.items()})
with open(path, "wb") as f:
    pickle.dump({"psum": psum, "metrics": metrics,
                 "params": jax.tree.map(np.asarray, p),
                 "err": jax.tree.map(np.asarray, e),
                 "q0": jax.tree.map(np.asarray, packed["q"]),
                 "scale0": [float(x) for x in
                            jax.tree.leaves(packed["scale"])]}, f)
"""


def _config():
    return get_config("gemma2-2b").reduced().replace(dtype="float32",
                                                     n_layers=2)


def _psum_inputs():
    rng = np.random.default_rng(0)
    return [np.arange(8 * 16, dtype=np.float32).reshape(8, 16) / 37.0,
            rng.standard_normal((8, 1000)).astype(np.float32)]


def _psum_rank(rank, world, inputs):
    mesh = LM.make_mesh((world,), ("pod",), "cpu")
    return [compression.compressed_psum(torch.from_numpy(x[rank]), mesh,
                                        "pod").numpy() for x in inputs]


def _step_rank(rank, world, init, per_shard):
    """Two compressed sharded steps of gemma2 on (2, 1) from the
    reference's init: the metrics, the params and error gathered whole,
    step 0's q and scales gathered whole (the packed payload recorded
    as ``compress_sharded`` returns it)."""
    torch.set_num_threads(1)
    if per_shard:
        compression._all_max = lambda x, mesh, axes: x
    cfg = _config()
    mesh = LM.make_mesh((2, 1), ("data", "model"), "cpu")
    full = convert.from_jax(init, cfg, device="cpu")
    like = tree.map(lambda x: x.to("meta"), full)
    local = loop.trainable(Sh.shard_params(full, mesh, cfg))
    data = SyntheticLM(cfg.vocab_size, TRAFFIC["seq"], TRAFFIC["batch"])
    batches = [data.batch(s, device="cpu") for s in range(2)]
    bsds = {k: v.to("meta") for k, v in batches[0].items()}
    tcfg = loop.TrainConfig(compress_grads=True)
    step = loop.make_sharded_train_step(cfg, tcfg, mesh, like, bsds)
    opt = loop.sharded_opt_init(local, cfg, mesh, like)
    err = loop.sharded_err_init(local, cfg, mesh, like)
    seen, inner = [], compression.compress_sharded

    def recorded(*a):
        out = inner(*a)
        seen.append(out[0])
        return out
    compression.compress_sharded = recorded
    metrics = []
    for b in batches:
        local, opt, err, m = step(local, opt, err, b)
        metrics.append({k: float(v) for k, v in m.items()})
    ospecs = tree.leaves(Sh.opt_pspecs(like, cfg, mesh))
    shapes = [x.shape for x in tree.leaves(like)]

    def whole(pieces):
        return [Sh.gather(x.to(torch.float32), s, mesh, n).numpy()
                for x, s, n in zip(pieces, ospecs, shapes)]
    out = {"metrics": metrics,
           "params": [x.numpy() for x in tree.leaves(
               Sh.gather_params(local, mesh, cfg, like))],
           "err": whole(tree.leaves(err)),
           "q0": whole(seen[0]["q"]),
           "scale0": [float(s) for s in seen[0]["scale"]]}
    return out if rank == 0 else None


@pytest.fixture(scope="module")
def runs():
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    inputs = _psum_inputs()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "reference.pkl")
        np.savez(path + ".inputs.npz", a=inputs[0], b=inputs[1])
        proc = subprocess.Popen(
            [sys.executable, "-c", REFERENCE, json.dumps([TRAFFIC, path])],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        try:
            line = proc.stdout.readline()
            assert line.strip() == "params-ready", proc.stderr.read()[-3000:]
            with open(path + ".params", "rb") as f:
                init = pickle.load(f)
            port = {"psum": LM.run_ranks(_psum_rank, 8, inputs,
                                         timeout=120),
                    "step": LM.run_ranks(_step_rank, 2, init, False,
                                         timeout=150)[0],
                    "control": LM.run_ranks(_step_rank, 2, init, True,
                                            timeout=150)[0]}
            _, err = proc.communicate(timeout=200)
        finally:
            proc.kill()
        assert proc.returncode == 0, err[-3000:]
        with open(path, "rb") as f:
            ref = pickle.load(f)
    # gemma2 reduced is one pattern unit: the reference's stacked leaves
    # are the port's, one a layer, in the same order
    cfg = _config()
    for k in ("params", "err", "q0"):
        ref[k] = [x.numpy().astype(np.float32) for x in tree.leaves(
            convert.from_jax(ref[k], cfg, device="cpu"))]
    return ref, port


def test_compressed_psum_is_bitwise_the_references(runs):
    ref, port = runs
    for i, want in enumerate(ref["psum"]):
        for rank, got in enumerate(port["psum"]):
            assert got[i].dtype == np.float32
            assert np.array_equal(got[i], want[rank]), (i, rank)
    # the reference test's bound: within range / 64 of the mean
    x = _psum_inputs()[0]
    assert np.abs(port["psum"][0][0] - x.mean(0)).max() <= \
        np.abs(x.mean(0)).max() / 64


# (shape, spec) of each leaf on the (2, 2) mesh
LEAVES = (((7, 5), Sh.P("data", "model")),
          ((6,), Sh.P("model")),
          ((4, 9), Sh.P(None, ("data", "model"))),    # 3, 3, 3, 0
          ((3, 3), Sh.P()),
          ((2, 8), Sh.P("data")))


def _sharded_rank(rank, world, grads, per_shard):
    mesh = LM.make_mesh((2, 2), ("data", "model"), "cpu")
    specs = [s for _, s in LEAVES]
    axes = [() if per_shard else
            tuple(a for e in s for a in Sh.axes_of(e)) for s in specs]
    err = [Sh.local_shard(torch.zeros(shape), s, mesh)
           for shape, s in LEAVES]
    out = []
    for step in grads:
        pieces = [Sh.local_shard(torch.from_numpy(g), s, mesh)
                  for g, s in zip(step, specs)]
        packed, err = compression.compress_sharded(pieces, err, mesh, axes)
        out.append({
            "q": [Sh.gather(q.to(torch.int32), s, mesh, shape).numpy()
                  for q, (shape, s) in zip(packed["q"], LEAVES)],
            "scale": [float(x) for x in packed["scale"]],
            "err": [Sh.gather(e, s, mesh, shape).numpy()
                    for e, (shape, s) in zip(err, LEAVES)]})
    return out


@pytest.mark.parametrize("per_shard", [False, True],
                         ids=["global_scale", "per_shard_control"])
def test_mesh_compress_is_bitwise_the_references_whole_leaf(per_shard):
    import jax.numpy as jnp
    from repro.optim import compression as ref_compression
    rng = np.random.default_rng(1)
    grads = [[(rng.standard_normal(shape) * (i + 1)).astype(np.float32)
              for i, (shape, _) in enumerate(LEAVES)] for _ in range(2)]
    ranks = LM.run_ranks(_sharded_rank, 4, grads, per_shard, timeout=60)
    err = None
    mismatched = set()
    for s, step in enumerate(grads):
        packed, err = ref_compression.compress(
            [jnp.asarray(g) for g in step], err)
        for i in range(len(LEAVES)):
            want = (np.asarray(packed["q"][i], np.int32),
                    float(packed["scale"][i]), np.asarray(err[i]))
            for r in ranks:
                got = r[s]
                same = (np.array_equal(got["q"][i], want[0]),
                        got["scale"][i] == want[1],
                        np.array_equal(got["err"][i], want[2]))
                if not per_shard:
                    assert all(same), (s, i, same)
                elif not all(same):
                    mismatched.add(i)
        if per_shard:
            break
    if per_shard:
        # every leaf whose pieces are cut scales by its own piece's max
        assert mismatched == {0, 1, 2, 4}, mismatched


def test_compressed_sharded_step_matches_the_reference(runs):
    ref, port = runs
    got = port["step"]
    for s in range(2):
        for k in ("loss", "grad_norm", "lr"):
            w, g = ref["metrics"][s][k], got["metrics"][s][k]
            assert abs(g - w) <= TOL * abs(w), (s, k, g, w)
    for i, (g, w) in enumerate(zip(got["params"], ref["params"])):
        assert np.abs(g - w).max() <= TOL * max(np.abs(w).max(), 1e-30), i
    flips = total = 0
    for i, (q, w, s, sw) in enumerate(zip(got["q0"], ref["q0"],
                                          got["scale0"], ref["scale0"])):
        assert abs(s - float(sw)) <= SCALE_TOL * float(sw), (i, s, sw)
        assert np.abs(q - w).max() <= 1, i
        flips += int((q != w).sum())
        total += q.size
    assert flips <= FLIP_SHARE * total, (flips, total)
    for i, (e, w, s) in enumerate(zip(got["err"], ref["err"],
                                      got["scale0"])):
        assert np.abs(e - w).max() <= 1.01 * s, i


def test_per_shard_scale_fails_the_scale_gate(runs):
    ref, port = runs
    off = [i for i, (s, w) in enumerate(zip(port["control"]["scale0"],
                                            ref["scale0"]))
           if abs(s - float(w)) > SCALE_TOL * float(w)]
    assert off, "a per-shard scale passed the scale gate"


def _stacked_errs(jerr, cfg):
    return [x.numpy() for x in tree.leaves(convert.from_jax(
        jax.tree.map(np.asarray, jerr), cfg, device="cpu"))]


def _off_share(got, want):
    """The share of elements whose carried error is off by more than a
    quarter step (half the leaf's largest |error|, which is half a
    step): where q differs."""
    off = total = 0
    for g, w in zip(got, want):
        off += int((np.abs(g - w) > 0.5 * np.abs(w).max()).sum())
        total += w.size
    return off / total


@pytest.mark.parametrize("per_layer", [False, True],
                         ids=["stack_groups", "per_layer_control"])
def test_stacked_layers_share_the_references_scale(monkeypatch, per_layer):
    from repro.data.pipeline import SyntheticLM as JSyntheticLM
    from repro.models import model as JM
    from repro.optim import adamw as jadamw
    from repro.optim import compression as jcompression
    from repro.train import loop as jloop
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    cfg = get_config("mistral-large-123b").reduced().replace(
        dtype="float32", n_layers=2)
    assert cfg.pattern_unit()[2] == 2          # one leaf a name, stacked
    jp = JM.init(cfg, jax.random.PRNGKey(0))
    batch = JSyntheticLM(cfg.vocab_size, 16, 4).batch(0)
    tc = jloop.TrainConfig(compress_grads=True)
    _, _, jerr, jm = jax.jit(jloop.make_train_step(cfg, tc))(
        jp, jadamw.init(jp), jcompression.err_init(jp), batch)
    if per_layer:
        monkeypatch.setattr(M, "stack_groups",
                            lambda p: list(range(len(tree.leaves(p)))))
    params = loop.trainable(convert.from_jax(
        jax.tree.map(np.asarray, jp), cfg, device="cpu"))
    step = loop.make_train_step(cfg, loop.TrainConfig(compress_grads=True))
    _, _, err, m = step(params, adamw.init(params),
                        compression.err_init(params),
                        {k: torch.from_numpy(np.array(v))
                         for k, v in batch.items()})
    assert abs(float(m["loss"]) - float(jm["loss"])) <= \
        TOL * abs(float(jm["loss"]))
    share = _off_share([x.numpy() for x in tree.leaves(err)],
                       _stacked_errs(jerr, cfg))
    if per_layer:
        assert share > 0.05, share
    else:
        assert share <= FLIP_SHARE, share
