"""``launch/dryrun.py`` against the JAX package's dry run.

The reference's numbers come from one subprocess with 512 forced host
devices and Auto meshes (ROADMAP C.2): the compiled
``argument_size_in_bytes`` (and ``hlo_analysis``' flops) of its small cell (``tests/test_distribution
.py``: gemma2-2b reduced on (4, 2), 8 x 32 tokens, accum 2), and at the
production meshes the bytes of ``NamedSharding(mesh, spec).shard_shape``
over ``param_pspecs``, ``opt_pspecs``, the batch's spec and
``cache_pspecs``.  The port's cells are traced on stand-ins on torch's
fake process group (no tensor allocated).  Its cache holds other bytes
than ``cache_pspecs`` where the layouts differ (ROADMAP C.33, C.34),
and those leaves are held to their own rule.
"""
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from repro_torch import tree
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as LM
from repro_torch.models import model as M
from repro_torch.models import sharding as Sh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (arch, shape, multi-pod), cut to one pattern unit; mamba2's and
# pixtral's on (16, 16)
CELLS = [(a, s, m) for a in ("zamba2-1.2b", "mistral-large-123b")
         for s in ("train_4k", "decode_32k") for m in (False, True)] + \
    [(a, s, False) for a in ("mamba2-1.3b", "pixtral-12b")
     for s in ("train_4k", "decode_32k")]
# the small cells compiled by the reference and traced here (gemma2-2b
# reduced, 8 x 32 tokens, accum 2): the reference's own small cell, and
# its 4 heads made 6 (over 2 kv heads) on (1, 4), heads 2 / 2 / 2 / 0
SMALL = (("small", (4, 2), {}),
         ("uneven", (1, 4), {"n_heads": 6, "n_kv_heads": 2}))
# traced whole here; zamba2's and mamba2's train_4k (~40 s a mesh on the
# stand-ins, their ssd gradients through the vector tier) are built and
# their arguments held, and traced by the dry run's command
TRACED = [c for c in CELLS if c[:2] not in (("zamba2-1.2b", "train_4k"),
                                            ("mamba2-1.3b", "train_4k"))]

REFERENCE = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import SHAPES, get_config
from repro.models import model as M, sharding as Sh
from repro.optim import adamw
from repro.train.loop import TrainConfig, make_train_step
cells, SMALL = json.loads(sys.argv[1])

def auto_mesh(shape, axes):
    return jax.make_mesh(tuple(shape), tuple(axes),
                         axis_types=(AxisType.Auto,) * len(axes))

def shard_bytes(t, specs, mesh, by_name=None):
    leaves = jax.tree_util.tree_flatten_with_path(t)[0]
    sp = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    total = 0
    for (path, x), s in zip(leaves, sp):
        n = int(np.prod(NamedSharding(mesh, s).shard_shape(x.shape))) * \
            x.dtype.itemsize
        total += n
        if by_name is not None:
            name = [k.key for k in path if hasattr(k, "key")][-1]
            by_name[name] = by_name.get(name, 0) + n
    return total

out = {}
from repro.launch import hlo_analysis
for key, shape, over in SMALL:
    mesh = auto_mesh(shape, ("data", "model"))
    cfg = get_config("gemma2-2b").reduced().replace(**over)
    params_sds = jax.eval_shape(lambda: M.init(cfg, jax.random.PRNGKey(0)))
    pspecs = Sh.param_pspecs(params_sds, cfg, mesh)
    opt_sds = jax.eval_shape(adamw.init, params_sds)
    ospecs = {"m": Sh.opt_pspecs(params_sds, cfg, mesh),
              "v": Sh.opt_pspecs(params_sds, cfg, mesh),
              "master": Sh.opt_pspecs(params_sds, cfg, mesh), "step": P()}
    batch = {"tokens": jax.ShapeDtypeStruct((8, 32), jnp.int32),
             "targets": jax.ShapeDtypeStruct((8, 32), jnp.int32)}
    bspec = {k: Sh.fit_spec(P(("data",), None), (8, 32), mesh)
             for k in batch}
    step = make_train_step(cfg, TrainConfig(accum=2), mesh)
    fn = lambda p, o, b: step(p, o, None, b)[:2]
    jfn = jax.jit(fn, in_shardings=(Sh.ns(mesh, pspecs),
                                    Sh.ns(mesh, ospecs), Sh.ns(mesh, bspec)),
                  out_shardings=(Sh.ns(mesh, pspecs), Sh.ns(mesh, ospecs)))
    with mesh:
        compiled = jfn.lower(params_sds, opt_sds, batch).compile()
    memory = compiled.memory_analysis()
    analysis = hlo_analysis.analyze(compiled.as_text())
    out[key] = int(memory.argument_size_in_bytes)
    out[key + "_temp"] = int(memory.temp_size_in_bytes)
    out[key + "_flops"] = analysis["flops"]
    out[key + "_collectives"] = analysis["collectives"]
for arch, shape_name, multi in cells:
    cfg = get_config(arch)
    prefix, unit, _, _ = cfg.pattern_unit()
    cfg = cfg.replace(n_layers=len(prefix) + len(unit))
    shape = SHAPES[shape_name]
    mesh = auto_mesh((2, 16, 16) if multi else (16, 16),
                     ("pod", "data", "model") if multi else
                     ("data", "model"))
    b, s = shape.global_batch, shape.seq_len
    p = jax.eval_shape(lambda: M.init(cfg, jax.random.PRNGKey(0)))
    rec = {"params": shard_bytes(p, Sh.param_pspecs(p, cfg, mesh), mesh)}
    bsds = {"tokens": jax.ShapeDtypeStruct(
        (b, 1 if shape.kind == "decode" else s), jnp.int32)}
    if shape.kind == "train":
        bsds["targets"] = jax.ShapeDtypeStruct((b, s), jnp.int32)
        o = jax.eval_shape(adamw.init, p)
        os_ = Sh.opt_pspecs(p, cfg, mesh)
        rec["opt"] = shard_bytes(o, {"m": os_, "v": os_, "master": os_,
                                     "step": P()}, mesh)
    else:
        p_off = cfg.n_patches if cfg.family == "vlm" else 0
        c = jax.eval_shape(lambda: M.init_cache(cfg, b, s + p_off))
        rec["cache_by_name"] = {}
        rec["cache"] = shard_bytes(c, Sh.cache_pspecs(c, mesh), mesh,
                                   rec["cache_by_name"])
    if cfg.family == "vlm" and shape.kind != "decode":
        bsds["patches"] = jax.ShapeDtypeStruct((b, cfg.n_patches,
                                                cfg.d_model), jnp.float32)
    rec["batch"] = shard_bytes(bsds, {k: Sh.fit_spec(
        P(Sh.batch_axes(mesh), *([None] * (len(v.shape) - 1))), v.shape,
        mesh) for k, v in bsds.items()}, mesh)
    out["/".join([arch, shape_name, str(multi)])] = rec
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    """-> the reference's numbers, read once its subprocess is done (it
    runs while the port's cells are traced)."""
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=512 "
                        "--xla_backend_optimization_level=0"}
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE,
                             json.dumps([CELLS, SMALL])], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    got = []

    def result():
        if not got:
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-3000:]
            got.append(json.loads(out.strip().splitlines()[-1]))
        return got[0]
    yield result
    proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def cells(reference):
    """The port's records of CELLS (and its argument bytes by part),
    traced while the reference's subprocess runs."""
    out = {}
    for arch, shape, multi in CELLS:
        name, dims, axes = dryrun.mesh_of(multi)
        status, _, cfg = dryrun.cell_status(arch, shape, dims, axes, 1)
        assert status == "ok", (arch, shape, name)
        kind, specs, accum, cache_len = dryrun.cell_inputs(cfg, shape)
        with dryrun.fake_ranks(math.prod(dims)):
            mesh = LM.make_mesh(dims, axes, "cpu")
            if (arch, shape, multi) in TRACED:
                rec, parts = dryrun.trace_cell(cfg, kind, specs, mesh,
                                               accum, cache_len)
            else:
                args, _, _ = dryrun.build_cell(cfg, kind, specs, mesh,
                                               accum, cache_len)
                rec, parts = None, {k: dryrun.tensor_bytes(v)
                                    for k, v in args.items()}
            by_name = {}
            if kind != "train":
                cache = M.init_cache(cfg, specs["tokens"][0][0], cache_len,
                                     "meta", mesh=mesh)
                for path, x in tree.paths(cache):
                    n = [k for k in path if isinstance(k, str)][-1]
                    by_name[n] = by_name.get(n, 0) + \
                        x.numel() * x.element_size()
        out["/".join([arch, shape, str(multi)])] = (rec, parts, by_name)
    return out


def test_small_cell_argument_bytes_equal_the_compiled_reference(
        reference):
    """The reference's small cell, the port's trace of it on 8 fake
    ranks: ok, and its arguments the compiled step's bytes."""
    cfg = get_config("gemma2-2b").reduced()
    specs = {k: ((8, 32), torch.int32) for k in ("tokens", "targets")}
    with dryrun.fake_ranks(8):
        mesh = LM.make_mesh((4, 2), ("data", "model"), "cpu")
        Sh.check_mesh(cfg, mesh)
        rec, parts = dryrun.trace_cell(cfg, "train", specs, mesh, accum=2)
    assert rec["launches"]["gemm"] > 0
    assert rec["collectives"]["all-reduce"] > 0
    assert sum(parts.values()) == reference()["small"]
    # the flops are new, not held: the port counts the elementwise
    # kernels' operations and a causal flash's visible pairs only, the
    # reference's analyzer its dots; together they agree within 10%
    # (1.0249 when written)
    assert 0.9 <= rec["flops"] / reference()["small_flops"] <= 1.1


# ROADMAP A.13c: each collective kind's bytes a rank a step, the port's
# over the reference's (``hlo_analysis`` of the compiled step), and the
# port's peak over the reference's temp + argument bytes
# (``memory_analysis``), each (lo, hi); the reference's collective-permute
# bytes as a share of its collective bytes (the port makes none).  Read
# when written: small 1.278 / 0.596 / 1.070, permutes 4.3%; uneven 0.522 /
# 0.667 / 1.006, permutes 11.4%.
RATIOS = {"small": {"all-reduce": (1.2, 1.35), "all-gather": (0.55, 0.65),
                    "peak": (1.0, 1.12), "permute share": (0.03, 0.06)},
          "uneven": {"all-reduce": (0.45, 0.6), "all-gather": (0.6, 0.72),
                     "peak": (0.95, 1.06), "permute share": (0.09, 0.14)}}


@pytest.mark.parametrize("key,shape,over", SMALL, ids=[c[0] for c in SMALL])
def test_small_cells_collectives_and_peak_held_to_the_compiled_reference(
        reference, key, shape, over):
    """A.13c: the port's trace of rank 0 of the small cells, its
    collectives by kind and its peak held to the compiled reference's
    within ``RATIOS``.  The causes of the gaps, as far as they are known:

    * GSPMD picks and places its collectives itself: it moves operands
      between devices with collective-permutes, which the port never
      makes, and sums and gathers other tensors than the port's
      Megatron-style pairs (the copy into the model region all-reduces
      its gradient, ``linear_rp`` its partial products): the small
      cell's all-reduce 1.28x and all-gather 0.60x of the reference's;
    * W.16, sequence parallelism's reduce-scatter done as an all-reduce
      and a cut, is not in these cells (gemma2 runs without it);
    * heads that 'model' does not divide: the reference's all-reduce and
      collective-permute bytes grow to 6.8x and 15.5x the small cell's
      (on 4 'model' ranks and no data axis), where the port gathers
      ``wq`` and ``wo`` over 'model' (``sharding.heads_of``: an
      all-gather forward, an all-reduce of their gradient backward) and
      moves about half the reference's bytes;
    * the peak: the port's eager ops hold intermediates that XLA's
      fusion never keeps, against temp + arguments, which leave out what
      XLA aliases."""
    cfg = get_config("gemma2-2b").reduced().replace(**over)
    specs = {k: ((8, 32), torch.int32) for k in ("tokens", "targets")}
    with dryrun.fake_ranks(math.prod(shape)):
        mesh = LM.make_mesh(shape, ("data", "model"), "cpu")
        rec, parts = dryrun.trace_cell(cfg, "train", specs, mesh, accum=2)
    ref = reference()
    assert sum(parts.values()) == ref[key]
    want = ref[key + "_collectives"]
    got = rec["collectives"]
    assert set(got) <= {"all-reduce", "all-gather"}, got
    bounds = RATIOS[key]
    for kind in ("all-reduce", "all-gather"):
        lo, hi = bounds[kind]
        assert lo <= got[kind] / want[kind] <= hi, (kind, got, want)
    lo, hi = bounds["permute share"]
    share = want["collective-permute"] / sum(want.values())
    assert lo <= share <= hi, want
    lo, hi = bounds["peak"]
    peak = rec["peak_bytes"] / (ref[key + "_temp"] + ref[key])
    assert lo <= peak <= hi, (rec["peak_bytes"], ref[key + "_temp"])


@pytest.mark.parametrize("cell", CELLS, ids=["-".join(map(str, c))
                                              for c in CELLS])
def test_production_cells_argument_bytes(reference, cells, cell):
    """zamba2 and mistral at full width, one pattern unit, on (16, 16)
    and (2, 16, 16), mamba2 and pixtral on (16, 16): ok, with the
    reference's shard bytes of params, optimizer and batch, and of the
    cache but the leaves whose layout differs: mistral's and pixtral's 8
    kv heads below a 16-way 'model' (C.33) and the Mamba2 conv history of
    zamba2 and mamba2 (C.34), each held to the port's rule."""
    ref = reference()["/".join(map(str, cell))]
    rec, parts, by_name = cells["/".join(map(str, cell))]
    if rec is not None:
        assert rec["launches"] and rec["flops"] > 0 and rec["peak_bytes"]
    for part in ("params", "opt", "batch"):
        assert parts.get(part) == ref.get(part), part
    if "cache" in ref:
        want = dict(ref["cache_by_name"])
        arch = cell[0]
        cfg = get_config(arch)
        if arch in ("mistral-large-123b", "pixtral-12b"):
            # one kv head of 128 a rank against 128 / 16 of all 8 heads
            for k in ("k", "v"):
                want[k] = want[k] * 16 // cfg.n_kv_heads
        else:
            conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
            mine = cfg.d_inner // 16 + 2 * cfg.ssm_state
            want["conv"] = want["conv"] * mine // conv_dim
        assert by_name == want
        assert parts["cache"] == sum(want.values())


def test_status_grid():
    """The 80 cells of the reference's matrix: 64 ok (minicpm3, gemma2,
    gemma3 and whisper among them since A.9.10, mamba2 and pixtral since
    their serving gate, C.22 and C.23), the full-attention archs skipped
    at long_500k, none refused or held."""
    from repro_torch.configs import SHAPES
    grid = {}
    for multi in (False, True):
        _, dims, axes = dryrun.mesh_of(multi)
        for arch in ARCH_NAMES:
            for shape in SHAPES:
                status, reason, _ = dryrun.cell_status(arch, shape, dims,
                                                       axes)
                grid[(arch, shape, multi)] = status
                if status == "skipped":
                    assert reason == dryrun.SKIP_REASON
    assert len(grid) == 80
    ok = {(a, s) for (a, s, _), v in grid.items() if v == "ok"}
    ssm = ("zamba2-1.2b", "mamba2-1.3b")
    assert ok == {(a, s) for a in ARCH_NAMES for s in SHAPES
                  if not (s == "long_500k" and a not in ssm)}
    counts = {v: sum(x == v for x in grid.values())
              for v in set(grid.values())}
    assert counts == {"ok": 64, "skipped": 16}
    for arch in ("minicpm3-4b", "gemma2-2b", "gemma3-1b", "whisper-tiny",
                 "pixtral-12b"):
        for (a, s, _), v in grid.items():
            if a == arch:
                assert v == ("skipped" if s == "long_500k" else "ok")
    assert {v for (a, _, _), v in grid.items() if a == "mamba2-1.3b"} == \
        {"ok"}
