"""``train/pipeline.py`` against the JAX package's ``pipeline``.

S = 4 stages of ``tanh(x @ w)``, M = 8 microbatches of (2, 16), the
weights and inputs drawn with numpy: the port on 4 gloo ranks of a
'pipe' mesh (``launch.mesh.make_mesh``) against the reference's
``pipeline`` on an Auto mesh of 4 forced host devices (ROADMAP C.2),
within the 1e-5 its own test asserts, every rank returning the outputs;
and bitwise against the four stages applied in turn on one rank.
"""
import json
import os
import subprocess
import sys

import numpy as np
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
