"""``train/pipeline.py`` against the JAX package's ``pipeline``.

S = 4 stages of ``tanh(x @ w)``, M = 8 microbatches of (2, 16), the
weights and inputs drawn with numpy: the port on 4 gloo ranks of a
'pipe' mesh (``launch.mesh.make_mesh``) against the reference's
``pipeline`` on an Auto mesh of 4 forced host devices (ROADMAP C.2),
within the 1e-5 its own test asserts, every rank returning the outputs;
and bitwise against the four stages applied in turn on one rank.

The backward (ROADMAP C.36): S = 2 and 4 stages, M = 4 microbatches, the
loss ``y.sum()`` in float32; every rank's gradient of each stage's
weights and of ``x_mb`` against the reference's ``jax.grad`` through its
``pipeline`` on S forced host devices and against ``torch.autograd.grad``
of the stages applied in turn, within 1e-5.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch import mesh as LM
from repro_torch.train.pipeline import bubble_fraction, pipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, M, MB, D = 4, 8, 2, 16

REFERENCE = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.train.pipeline import pipeline
ws, x = (np.asarray(a, np.float32) for a in json.loads(sys.argv[1]))
mesh = jax.make_mesh((ws.shape[0],), ("pipe",),
                     axis_types=(AxisType.Auto,))
f = jax.jit(lambda w, v: pipeline(lambda a, b: jnp.tanh(b @ a), w, v, mesh))
with mesh:
    print(json.dumps(np.asarray(f(ws, x)).tolist()))
"""


def _inputs():
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((S, D, D)) * 0.3).astype(np.float32)
    x = rng.standard_normal((M, MB, D)).astype(np.float32)
    return ws, x


def _stage(w, v):
    return torch.tanh(v @ w)


def _ranks(rank, world, ws, x):
    torch.set_num_threads(1)
    mesh = LM.make_mesh((world,), ("pipe",), "cpu")
    return pipeline(_stage, torch.from_numpy(ws), torch.from_numpy(x),
                    mesh).numpy()


def test_pipeline_matches_the_reference_and_the_stages_in_turn():
    ws, x = _inputs()
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={S}"}
    proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE,
         json.dumps([ws.tolist(), x.tolist()])],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        got = LM.run_ranks(_ranks, S, ws, x, timeout=60)
        out, err = proc.communicate(timeout=300)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-3000:]
    want = np.asarray(json.loads(out.strip().splitlines()[-1]), np.float32)
    seq = torch.from_numpy(x)
    for i in range(S):
        seq = _stage(torch.from_numpy(ws[i]), seq)
    for y in got:
        assert y.shape == (M, MB, D)
        assert float(np.abs(y - want).max()) < 1e-5
        assert np.array_equal(y, seq.numpy())


def test_bubble_fraction():
    assert bubble_fraction(8, 4) == 3 / 11
    assert bubble_fraction(1, 1) == 0.0


def _one_stage(rank, world, x):
    mesh = LM.make_mesh((1, world), ("pipe", "data"), "cpu")
    y = pipeline(lambda w, v: v * w, torch.tensor([2.0]),
                 torch.from_numpy(x), mesh)
    return np.array_equal(y.numpy(), 2 * x)


def test_a_pipe_axis_of_one_stage_runs_the_stage_alone():
    """A 'pipe' axis of size 1 beside another axis: no hop, the stage's
    outputs as they are, on every rank."""
    assert all(LM.run_ranks(_one_stage, 2, _inputs()[1], timeout=60))


GRAD_STAGES, GRAD_M = (2, 4), 4

GRAD_REFERENCE = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.train.pipeline import pipeline
out = {}
for s, ws, x in json.loads(sys.argv[1]):
    ws, x = np.asarray(ws, np.float32), np.asarray(x, np.float32)
    mesh = jax.make_mesh((s,), ("pipe",), axis_types=(AxisType.Auto,),
                         devices=jax.devices()[:s])
    loss = lambda w, v: pipeline(lambda a, b: jnp.tanh(b @ a), w, v,
                                 mesh).sum()
    with mesh:
        gw, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(ws, x)
    out[s] = [np.asarray(gw).tolist(), np.asarray(gx).tolist()]
print(json.dumps(out))
"""


def _grad_inputs(s):
    rng = np.random.default_rng(s)
    ws = (rng.standard_normal((s, D, D)) * 0.3).astype(np.float32)
    x = rng.standard_normal((GRAD_M, MB, D)).astype(np.float32)
    return ws, x


def _grad_ranks(rank, world, ws, x):
    """This rank's gradient of the stacked weights and of x_mb through
    ``pipeline`` under the loss ``y.sum()``."""
    torch.set_num_threads(1)
    mesh = LM.make_mesh((world,), ("pipe",), "cpu")
    w = torch.from_numpy(ws).requires_grad_(True)
    v = torch.from_numpy(x).requires_grad_(True)
    y = pipeline(_stage, w, v, mesh)
    gw, gv = torch.autograd.grad(y.sum(), (w, v))
    return gw.numpy(), gv.numpy()


@pytest.fixture(scope="module")
def grad_reference():
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count="
                        f"{max(GRAD_STAGES)}"}
    cases = [[s, *(a.tolist() for a in _grad_inputs(s))]
             for s in GRAD_STAGES]
    proc = subprocess.Popen([sys.executable, "-c", GRAD_REFERENCE,
                             json.dumps(cases)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    got = []

    def result():
        if not got:
            out, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, err[-3000:]
            got.append(json.loads(out.strip().splitlines()[-1]))
        return got[0]
    yield result
    proc.kill()
    proc.communicate()


@pytest.mark.parametrize("s", GRAD_STAGES)
def test_pipeline_gradient_matches_the_reference_and_the_stages_in_turn(
        grad_reference, s):
    """C.36: every rank's gradient of each stage's weights and of x_mb,
    stage 0's included on the ranks whose stage never reads x_mb, equals
    the reference's ``jax.grad`` and the stages' in turn within 1e-5."""
    ws, x = _grad_inputs(s)
    got = LM.run_ranks(_grad_ranks, s, ws, x, timeout=60)
    w = torch.from_numpy(ws).requires_grad_(True)
    v = torch.from_numpy(x).requires_grad_(True)
    seq = v
    for i in range(s):
        seq = _stage(w[i], seq)
    seq_w, seq_x = (g.numpy() for g in torch.autograd.grad(seq.sum(),
                                                            (w, v)))
    ref_w, ref_x = (np.asarray(a, np.float32)
                    for a in grad_reference()[str(s)])
    assert float(np.abs(ref_w - seq_w).max()) < 1e-5
    assert float(np.abs(ref_x - seq_x).max()) < 1e-5
    for gw, gx in got:
        assert gw.shape == ws.shape and gx.shape == x.shape
        for i in range(s):
            assert float(np.abs(gw[i]).max()) > 0, i
            assert float(np.abs(gw[i] - ref_w[i]).max()) < 1e-5, i
            assert float(np.abs(gw[i] - seq_w[i]).max()) < 1e-5, i
        assert float(np.abs(gx - ref_x).max()) < 1e-5
        assert float(np.abs(gx - seq_x).max()) < 1e-5
