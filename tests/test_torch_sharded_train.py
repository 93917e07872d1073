"""``train.loop.make_sharded_train_step`` against the JAX package's.

Each case is float32 at ``cfg.reduced()`` widths, 2 layers, 4 rows of 16
tokens (``SyntheticLM`` steps 0 and 1): the reference's
``make_sharded_train_step`` on as many forced host devices as the mesh
has (an Auto mesh, ROADMAP C.2) in a subprocess, the port's on as many
gloo CPU ranks (``launch.mesh.run_ranks``), both from the reference's
``init`` (carried across by ``models/convert.py``).  Held: the loss of
both steps, their aux and ``grad_norm`` within 2e-4 relative, and each
leaf's gradient at step 0, gathered to its full shape, within 2e-4 of
its max |g| from ``jax.grad(loss_fn)`` under the same mesh.  A control
drops the backward all-reduce of the copy into the model region: the
replicated leaves' gradients come out partial and fail that gate.

SSM heads that straddle SSM groups (ROADMAP A.9.11): zamba2 and mamba2
with ``d_model`` 48 and 3 groups, 6 heads of 2 a group, on (1, 2) and
(2, 2), each rank's 3 heads reading groups 0, 0, 1 and 1, 2, 2; no
public config straddles, so these run at reduced widths.  Their
control reads each rank's groups with the ``h // g`` repeat of a rank
that holds whole groups (rounded up, cut to its heads), and must fail.
"""
import contextlib
import json
import os
import pickle
import subprocess
import sys
import tempfile

from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLM, extra_inputs
from repro_torch.launch import mesh as LM
from repro_torch.models import convert
from repro_torch.models import model as M
from repro_torch.models import sharding as Sh
from repro_torch.models import ssm
from repro_torch.train import loop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (arch, mesh): data-parallel, tensor- and expert-parallel, FSDP + ZeRO-1;
# a model of mamba blocks alone, and a vlm's patch prefix (with FSDP) on
# 'model' and on 'data' too, which cuts a batch that carries patches;
# SSM heads across SSM groups (arch, mesh, overrides)
STRADDLE = {"d_model": 48, "ssm_groups": 3}
CASES = (("gemma2-2b", (2, 1)), ("gemma2-2b", (1, 2)),
         ("mistral-large-123b", (2, 1)),
         ("granite-moe-1b-a400m", (1, 2)), ("granite-moe-1b-a400m", (2, 2)),
         ("mamba2-1.3b", (1, 2)), ("pixtral-12b", (1, 2)),
         ("pixtral-12b", (2, 2)), ("zamba2-1.2b", (1, 2), STRADDLE),
         ("mamba2-1.3b", (2, 2), STRADDLE))
TRAFFIC = dict(seq=16, batch=4)
TOL = 2e-4
# the reference's data-parallel step on gemma2 (ROADMAP A.13's probe)
GEMMA2_DP_LOSS = 5.518292

REFERENCE = r"""
import json, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.data.pipeline import SyntheticLM, extra_inputs
from repro.models import model as M, sharding as Sh
from repro.optim import adamw
from repro.train import loop
cases, traffic, path = json.loads(sys.argv[1])
cfgs = [get_config(c[0]).reduced().replace(dtype="float32", n_layers=2,
                                          **(c[2] if len(c) > 2 else {}))
        for c in cases]
inits = [jax.tree.map(np.asarray, M.init(c, jax.random.PRNGKey(0)))
         for c in cfgs]
with open(path + ".params", "wb") as f:
    pickle.dump(inits, f)
print("params-ready", flush=True)
out = []
for (arch, shape, *_), cfg, p0 in zip(cases, cfgs, inits):
    mesh = jax.make_mesh(tuple(shape), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    data = SyntheticLM(cfg.vocab_size, traffic["seq"], traffic["batch"])
    extra = extra_inputs(cfg, traffic["batch"])
    batches = [{**data.batch(s), **extra} for s in range(2)]
    params = jax.tree.map(jnp.asarray, p0)
    opt = jax.tree.map(jnp.array, adamw.init(params))
    psds = jax.eval_shape(lambda: params)
    bsds = jax.eval_shape(lambda: batches[0])
    step = loop.make_sharded_train_step(cfg, loop.TrainConfig(), mesh,
                                        psds, bsds)
    metrics = []
    with mesh:
        p, o = jax.tree.map(jnp.array, params), opt
        for b in batches:
            p, o, _, m = step(p, o, None, b)
            metrics.append({k: float(v) for k, v in m.items()})
        sp = NamedSharding(mesh, Sh.activation_spec(mesh, cfg)) \
            if cfg.use_sp else None
        pspecs = Sh.ns(mesh, Sh.param_pspecs(psds, cfg, mesh))
        bspec = Sh.ns(mesh, jax.tree.map(lambda _: Sh.token_spec(mesh),
                                         bsds))
        grad = jax.jit(jax.grad(
            lambda q, b: loop.loss_fn(q, cfg, b, sp)[0]),
            in_shardings=(pspecs, bspec))
        with Sh.active_mesh(mesh):
            g = grad(params, batches[0])
    out.append({"metrics": metrics,
                "grads": jax.tree.map(np.asarray, g)})
with open(path, "wb") as f:
    pickle.dump(out, f)
"""


def _config(arch, **over):
    """The case's config: ``arch`` reduced, float32, 2 layers, with
    ``over`` (a case's third entry) replaced."""
    return get_config(arch).reduced().replace(dtype="float32", n_layers=2,
                                              **over)


def _no_copy_reduce(ctx, g):
    return g, None


def _port(rank, world, cases, inits, control=False, controls=()):
    """Each case of ``world`` ranks: (step-0 gradient gathered to full
    shapes, the two steps' metrics), from rank 0.  ``control`` True drops
    the copy's backward all-reduce.  Each (case index, fault) of
    ``controls`` whose case has ``world`` ranks runs that case again
    after the others, inside the context manager ``fault()`` (which
    plants a fault), keyed ("control", index).  One thread a rank: the
    ranks share the host's cores with the reference's subprocesses."""
    torch.set_num_threads(1)
    if control:
        Sh._Copy.backward = staticmethod(_no_copy_reduce)
    out = []
    for case, init in zip(cases, inits):
        if _world(case) == world:
            out.append({"case": _key(case), **_port_case(case, init)})
    for j, fault in controls:
        if _world(cases[j]) == world:
            with fault():
                out.append({"case": ("control", j),
                            **_port_case(cases[j], inits[j])})
    return out if rank == 0 else None


def _world(case):
    return case[1][0] * case[1][1]


def _port_case(case, init):
    """One case's step-0 gradient (gathered to full shapes) and metrics."""
    arch, shape, *over = case
    cfg = _config(arch, **(over[0] if over else {}))
    mesh = LM.make_mesh(shape, ("data", "model"), "cpu")
    full = convert.from_jax(init, cfg, device="cpu")
    like = tree.map(lambda x: x.to("meta"), full)
    local = loop.trainable(Sh.shard_params(full, mesh, cfg))
    data = SyntheticLM(cfg.vocab_size, TRAFFIC["seq"], TRAFFIC["batch"])
    extra = extra_inputs(cfg, TRAFFIC["batch"], device="cpu")
    batches = [{**data.batch(s, device="cpu"), **extra} for s in range(2)]
    bsds = {k: v.to("meta") for k, v in batches[0].items()}
    tcfg = loop.TrainConfig()
    grads_fn = loop.make_sharded_grads(cfg, tcfg, mesh, like, bsds)
    _, _, g = grads_fn(local, batches[0])
    g = tree.leaves(Sh.gather_params(tree.unflatten(local, g), mesh, cfg,
                                     like))
    opt = loop.sharded_opt_init(local, cfg, mesh, like)
    step = loop.make_sharded_train_step(cfg, tcfg, mesh, like, bsds)
    metrics = []
    for b in batches:
        local, opt, _, m = step(local, opt, None, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "grads": [x.numpy() for x in g]}


def _key(case):
    """A case's key among the port's runs: (arch, mesh), and its
    overrides' names where it has any."""
    arch, shape, *over = case
    return (arch, tuple(shape)) + tuple(sorted(over[0])) if over else \
        (arch, tuple(shape))


def run_cases(cases, controls=()):
    """(reference runs, port runs by case, inits) of ``cases``: the
    reference's subprocesses (one for every three cases, at most three;
    case i in process i % their count; as many forced host devices as
    the largest mesh has, at least 4) write their inits first, and the
    port's ranks run on them while they step; each (case index, fault)
    of ``controls`` runs that case again under the fault, in the same
    ranks, its run keyed ("control", index) (``_port``)."""
    # (LLVM's optimisation off: the reference compiles a step and a
    # gradient a case and runs each on 4 rows of 16 tokens)
    devices = max([4] + [_world(c) for c in cases])
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={devices} "
                        "--xla_backend_optimization_level=0"}
    procs = min(3, -(-len(cases) // 3))
    parts = [list(range(i, len(cases), procs)) for i in range(procs)]
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f"reference{i}.pkl") for i in range(procs)]
        running = [subprocess.Popen(
            [sys.executable, "-c", REFERENCE,
             json.dumps([[cases[j] for j in part], TRAFFIC, path])],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for part, path in zip(parts, paths)]
        inits, ref = [None] * len(cases), [None] * len(cases)
        try:
            for proc, part, path in zip(running, parts, paths):
                line = proc.stdout.readline()
                assert line.strip() == "params-ready", \
                    proc.stderr.read()[-3000:]
                with open(path + ".params", "rb") as f:
                    for j, init in zip(part, pickle.load(f)):
                        inits[j] = init
            port = {}
            for world in sorted({_world(c) for c in cases}):
                for row in LM.run_ranks(_port, world, cases, inits, False,
                                        controls, timeout=150)[0]:
                    port[row["case"]] = row
            for proc, part, path in zip(running, parts, paths):
                _, err = proc.communicate(timeout=200)
                assert proc.returncode == 0, err[-3000:]
                with open(path, "rb") as f:
                    for j, r in zip(part, pickle.load(f)):
                        ref[j] = r
        finally:
            for proc in running:
                proc.kill()
    # the reference's gradient unstacked into the port's leaves
    for (arch, _, *over), r in zip(cases, ref):
        r["grads"] = [x.numpy() for x in tree.leaves(convert.from_jax(
            r["grads"], _config(arch, **(over[0] if over else {})),
            device="cpu"))]
    return ref, port, inits


def _repeated_groups(lo, hi, glo, ghi, per, device):
    """The control's ``ssm.head_groups``: the rank's groups each
    repeated h // g times (rounded up) in order, cut to its h heads, as
    a rank that holds whole groups reads them."""
    h, g = hi - lo, ghi - glo
    return torch.arange(h, device=device) // -(-h // g)


@contextlib.contextmanager
def groups_repeated():
    with mock.patch.object(ssm, "head_groups", _repeated_groups):
        yield


CONTROLS = ((CASES.index(("zamba2-1.2b", (1, 2), STRADDLE)),
             groups_repeated),)


@pytest.fixture(scope="module")
def runs():
    return run_cases(CASES, controls=CONTROLS)


def _rel(a, b):
    return abs(a - b) / abs(b)


def check_case(want, got, arch, shape):
    """Two steps' metrics within ``TOL`` relative and step 0's gradient
    leaf by leaf within ``TOL`` of its max |g|."""
    for s in range(2):
        for k in ("loss", "aux", "grad_norm", "lr"):
            w, g = want["metrics"][s][k], got["metrics"][s][k]
            if w == 0:
                assert g == 0, (s, k)
            else:
                assert _rel(g, w) <= TOL, (s, k, g, w)
    # an MoE's load-balance loss, and none without experts
    assert (want["metrics"][0]["aux"] > 0) == bool(get_config(arch).n_experts)
    assert len(got["grads"]) == len(want["grads"])
    for i, (g, w) in enumerate(zip(got["grads"], want["grads"])):
        assert g.shape == w.shape, i
        scale = float(np.abs(w).max())
        assert float(np.abs(g - w).max()) <= TOL * max(scale, 1e-30), \
            (arch, shape, i)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_sharded_step_matches_the_reference(runs, case):
    ref, port, _ = runs
    arch, shape = CASES[case][:2]
    check_case(ref[case], port[_key(CASES[case])], arch, shape)


def test_gemma2_data_parallel_reads_the_probes_loss(runs):
    ref, port, _ = runs
    case = CASES.index(("gemma2-2b", (2, 1)))
    assert ref[case]["metrics"][0]["loss"] == pytest.approx(GEMMA2_DP_LOSS,
                                                            abs=1e-6)
    assert port[("gemma2-2b", (2, 1))]["metrics"][0]["loss"] == \
        pytest.approx(GEMMA2_DP_LOSS, rel=TOL)


def test_dropping_the_copys_reduce_fails_the_gate(runs):
    """The control: granite on (1, 2) with the copy into the model
    region reduced by nothing backward.  The router's and the norms'
    gradients sum only one rank's experts and heads, and fail."""
    ref, _, inits = runs
    case = CASES.index(("granite-moe-1b-a400m", (1, 2)))
    got = LM.run_ranks(_port, 2, CASES[case:case + 1],
                       inits[case:case + 1], True, timeout=100)[0][0]
    names = [tree_path for tree_path, _ in
             tree.paths(M.init(_config("granite-moe-1b-a400m"), None,
                               torch.device("meta")))]
    failed = set()
    for name, g, w in zip(names, got["grads"], ref[case]["grads"]):
        scale = float(np.abs(w).max())
        if float(np.abs(g - w).max()) > TOL * max(scale, 1e-30):
            failed.add(name[-1] if name[-1] != "w" else name[-2])
    assert "router" in failed and {"ln1", "ln2"} & failed, failed


def test_repeating_groups_h_over_g_fails_the_gate(runs):
    """The control: zamba2 with 6 SSM heads in 3 groups on (1, 2), each
    rank's 3 heads reading its 2 groups as 0, 0, 1 (the ``h // g``
    repeat, rounded up).  Rank 1's heads 3, 4, 5 read groups 1, 2, 2, so
    its head 4 reads the wrong group, and the mamba blocks' gradients
    miss the gate."""
    ref, port, _ = runs
    case = CONTROLS[0][0]
    with pytest.raises(AssertionError):
        check_case(ref[case], port[("control", case)], *CASES[case][:2])
