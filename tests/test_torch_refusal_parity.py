"""``sharding.check_mesh`` refuses what the JAX package refuses, and
nothing else (ROADMAP A.9.11, closed).

One subprocess of the reference, on 16 forced host devices, builds its
``train.loop.make_sharded_train_step`` for each case (``cfg.reduced()``,
float32, 2 layers, 4 rows of 16 tokens, an Auto-typed mesh on the first
devices) and lowers it on shape-only arguments.  A 'model' axis of 16
divides the padded vocabulary (256 rows), so that what the reference
refuses is the leaf the case is about:

* the FFN's columns (``d_ff``, ``d_ff_dense``, the shared experts'
  width): its ``jit`` needs the FFN's ``wg`` / ``wu`` / ``wd`` cut to
  divide by 'model';
* ``n_experts``: its ``moe_apply`` hands the expert stacks to a
  ``shard_map`` that splits them over 'model' (its ``wg`` argument);
* ``ssm_heads``: its ``jit`` needs the mamba block's ``w_in`` cut to
  divide by 'model'.

Each refusal is the port's too, its message naming the same width.  SSM
heads that straddle SSM groups (6 heads in 3 groups on (1, 2) and
(2, 2), 12 in 3 on (1, 4)) lower in the reference and pass
``check_mesh``; ``test_torch_sharded_train.py``, ``test_torch_tp_kinds.py``
and ``test_torch_serve_sharded.py`` hold the port's runs of them to the
reference's.
"""
import json
import os
import re
import subprocess
import sys

import pytest

from repro_torch.configs import get_config
from repro_torch.models import sharding as Sh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (arch, mesh, overrides, the width check_mesh names, the leaf the
# reference's error names)
REFUSED = (
    ("gemma2-2b", (1, 16), {"d_ff": 120}, "d_ff",
     r"\['ffn'\]\['w[gud]'\]"),
    ("deepseek-v2-lite-16b", (1, 16), {"n_experts": 16, "d_ff_dense": 120},
     "d_ff_dense", r"\['prefix'\]\[0\]\['ffn'\]\['w[gud]'\]"),
    ("deepseek-v2-lite-16b", (1, 16), {"n_experts": 16, "d_expert": 36},
     "shared d_ff", r"\['ffn'\]\['shared'\]\['w[gud]'\]"),
    ("granite-moe-1b-a400m", (1, 16), {}, "n_experts",
     r"shard_map .*parameter 'wg'"),
    ("zamba2-1.2b", (1, 16), {}, "ssm_heads", r"\['mamba'\]\['w_in'\]"),
)
STRADDLED = (("zamba2-1.2b", (1, 2), {"d_model": 48, "ssm_groups": 3}),
             ("zamba2-1.2b", (1, 4), {"d_model": 96, "ssm_groups": 3}),
             ("mamba2-1.3b", (1, 2), {"d_model": 48, "ssm_groups": 3}),
             ("mamba2-1.3b", (2, 2), {"d_model": 48, "ssm_groups": 3}))

REFERENCE = r"""
import json, sys
import jax
from jax.sharding import AxisType
from repro.configs import get_config
from repro.data.pipeline import SyntheticLM, extra_inputs
from repro.models import model as M
from repro.optim import adamw
from repro.train import loop
out = []
for arch, shape, over in json.loads(sys.argv[1]):
    cfg = get_config(arch).reduced().replace(dtype="float32", n_layers=2,
                                             **over)
    mesh = jax.make_mesh(tuple(shape), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:shape[0] * shape[1]])
    init = lambda: M.init(cfg, jax.random.PRNGKey(0))
    psds = jax.eval_shape(init)
    osds = jax.eval_shape(lambda: adamw.init(init()))
    bsds = jax.eval_shape(lambda: {**SyntheticLM(cfg.vocab_size, 16,
                                                 4).batch(0),
                                   **extra_inputs(cfg, 4)})
    try:
        step = loop.make_sharded_train_step(cfg, loop.TrainConfig(), mesh,
                                            psds, bsds)
        with mesh:
            step.lower(psds, osds, None, bsds)
        out.append({"lowered": True})
    except Exception as e:
        out.append({"lowered": False, "error": type(e).__name__,
                    "message": str(e)})
print(json.dumps(out))
"""


def _config(arch, over):
    return get_config(arch).reduced().replace(dtype="float32", n_layers=2,
                                              **over)


@pytest.fixture(scope="module")
def reference():
    """The reference's outcome of every case, REFUSED's then STRADDLED's."""
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=16"}
    cases = [c[:3] for c in REFUSED] + list(STRADDLED)
    proc = subprocess.run([sys.executable, "-c", REFERENCE,
                           json.dumps(cases)], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    return out[:len(REFUSED)], out[len(REFUSED):]


@pytest.mark.parametrize("case", range(len(REFUSED)),
                         ids=[c[3].replace(" ", "_") for c in REFUSED])
def test_each_refusal_is_the_references_own(reference, case):
    arch, shape, over, width, leaf = REFUSED[case]
    got = reference[0][case]
    assert not got["lowered"], (arch, shape, over)
    assert got["error"] == "ValueError", got
    assert "divisible" in got["message"], got["message"][:600]
    assert re.search(leaf, got["message"], re.S), got["message"][:600]
    with pytest.raises(NotImplementedError,
                       match=rf"{width} \d+ \(its .*the JAX package refuses "
                             r"the same mesh \(ROADMAP A.9.11, closed\)"):
        Sh.check_mesh(_config(arch, over), Sh.Mesh(shape, ("data", "model")))


@pytest.mark.parametrize("case", range(len(STRADDLED)),
                         ids=[f"{c[0]}-{c[1][0]}x{c[1][1]}"
                              for c in STRADDLED])
def test_the_reference_runs_what_straddles_and_so_does_the_port(reference,
                                                                case):
    arch, shape, over = STRADDLED[case]
    assert reference[1][case]["lowered"], reference[1][case]
    cfg = _config(arch, over)
    Sh.check_mesh(cfg, Sh.Mesh(shape, ("data", "model")))
    assert Sh.straddles(cfg.ssm_heads, cfg.ssm_groups, shape[1])
