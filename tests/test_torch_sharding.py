"""models/sharding.py and launch/mesh.py against the JAX package's.

The reference's specs come from a subprocess with 512 forced host
devices (its meshes built with ``axis_types=Auto``, not through
``repro.launch.mesh``: ROADMAP C.2), its shapes from ``jax.eval_shape``;
the port's from ``meta`` tensors and a shape-only mesh.  The reference
stacks a repeated unit (and whisper's encoder) on a leading axis the port
does not have, so its spec of such a leaf is the port's of each layer
with that unsharded leading entry first.  Shard and gather run on gloo
CPU ranks (``launch.mesh.run_ranks``).
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.launch import mesh as LM
from repro_torch.models import model as M
from repro_torch.models import sharding as Sh
from repro_torch.train import loop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("zamba2-1.2b", "mamba2-1.3b", "granite-moe-1b-a400m",
         "deepseek-v2-lite-16b", "minicpm3-4b", "gemma2-2b", "gemma3-1b",
         "whisper-tiny", "pixtral-12b", "mistral-large-123b")
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
CACHE = dict(batch=32, s_max=64)
STACKED = ("unit", "enc")

REFERENCE = r"""
import json, sys
import jax
from jax.sharding import AxisType
from repro.configs import base, get_config
from repro.models import model as M, sharding as Sh
archs, meshes, cache = json.loads(sys.argv[1])

def keyed(specs):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    out = []
    for path, s in flat:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        out.append([keys, [list(e) if isinstance(e, tuple) else e
                           for e in s]])
    return out

out = {}
for name in archs:
    cfg = get_config(name)
    p = jax.eval_shape(lambda: M.init(cfg, jax.random.PRNGKey(0)))
    c = jax.eval_shape(lambda: M.init_cache(cfg, cache["batch"],
                                            cache["s_max"]))
    for label, (shape, axes) in meshes.items():
        mesh = jax.make_mesh(tuple(shape), tuple(axes),
                             axis_types=(AxisType.Auto,) * len(axes))
        out[name + "/" + label] = {
            "param": keyed(Sh.param_pspecs(p, cfg, mesh)),
            "opt": keyed(Sh.opt_pspecs(p, cfg, mesh)),
            "cache": keyed(Sh.cache_pspecs(c, mesh))}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=512"}
    out = subprocess.run(
        [sys.executable, "-c", REFERENCE,
         json.dumps([ARCHS, MESHES, CACHE])],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _json(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _port_specs(specs):
    """(key path, spec) pairs of a port spec tree, each layer of a
    stacked part keyed as the reference's stacked leaf."""
    out = {}
    for path, spec in tree.paths(specs):
        key = list(path)
        if key[0] in STACKED:
            # unit/j/r/... -> unit/j/...; enc/r/... -> enc/...
            del key[2 if key[0] == "unit" else 1]
        out.setdefault(json.dumps(key), set()).add(json.dumps(
            [None] + _json(spec) if path[0] in STACKED else _json(spec)))
    return out


def _trimmed(spec):
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_the_reference(reference, arch):
    """param_pspecs, opt_pspecs and cache_pspecs of the full-size tree on
    (1, 1), (2, 2), (16, 16) and (2, 16, 16) equal the reference's, leaf
    for leaf (every layer of a stacked unit the reference's spec)."""
    cfg = get_config(arch)
    meta = torch.device("meta")
    params = M.init(cfg, None, meta)
    cache = M.init_cache(cfg, CACHE["batch"], CACHE["s_max"], meta)
    for label, (shape, axes) in MESHES.items():
        mesh = Sh.Mesh(shape, axes)
        want = reference[f"{arch}/{label}"]
        for kind, got in (("param", Sh.param_pspecs(params, cfg, mesh)),
                          ("opt", Sh.opt_pspecs(params, cfg, mesh)),
                          ("cache", Sh.cache_pspecs(cache, mesh))):
            port = _port_specs(got)
            ref = {json.dumps(k): s for k, s in want[kind]}
            assert set(port) == set(ref), (arch, label, kind)
            for key, specs in port.items():
                # every layer of a stacked part gets the same spec, the
                # reference's with its leading unsharded entry
                stacked = json.loads(key)[0] in STACKED
                got_specs = {json.dumps(_trimmed(json.loads(s)))
                             for s in specs}
                want_spec = ref[key]
                if stacked:
                    assert not want_spec or want_spec[0] is None
                assert got_specs == {json.dumps(_trimmed(want_spec))}, \
                    (arch, label, kind, key)


def test_fit_spec_by_hand():
    mesh = Sh.Mesh((2, 16, 16), ("pod", "data", "model"))
    # 8 kv heads x 128 on a 16-way model axis still fit the flat dim
    assert Sh.fit_spec(Sh.P("data", "model"), (12288, 1024), mesh) == \
        Sh.P("data", "model")
    # an axis larger than its dim is dropped, trailing Nones trimmed
    assert Sh.fit_spec(Sh.P("model", None), (8, 4), mesh) == Sh.P()
    assert Sh.fit_spec(Sh.P(None, "model"), (8, 8), mesh) == Sh.P()
    # a tuple entry is the product of its axes
    assert Sh.fit_spec(Sh.P(("pod", "data"), None), (32, 4), mesh) == \
        Sh.P(("pod", "data"))
    assert Sh.fit_spec(Sh.P(("pod", "data"), None), (31, 4), mesh) == \
        Sh.P()
    # a spec longer than the shape loses its extra entries
    assert Sh.fit_spec(Sh.P(None, None, "model"), (64, 64), mesh) == Sh.P()
    assert Sh.batch_axes(mesh) == ("pod", "data")
    assert Sh.batch_spec(mesh) == Sh.P(("pod", "data"))
    assert Sh.token_spec(mesh) == Sh.P(("pod", "data"), None)
    # a one-name tuple is the name, as PartitionSpec has it
    assert Sh.P(("data",), None) == Sh.P("data", None)
    # the DTensor placements of a spec tree: one a mesh axis
    from torch.distributed.tensor import Replicate, Shard
    got = Sh.ns(mesh, {"w": Sh.P(("pod", "data"), "model"), "b": Sh.P()})
    assert got == {"w": (Shard(0), Shard(0), Shard(1)),
                   "b": (Replicate(), Replicate(), Replicate())}
    cfg = get_config("mistral-large-123b")
    assert Sh.activation_spec(mesh, cfg) == \
        Sh.P(("pod", "data"), "model", None)
    assert Sh.chunk_range(49155, 1, 2) == (24578, 49155)
    assert Sh.chunk_range(3, 3, 4) == (3, 3)        # an empty last chunk


def test_production_meshes_have_the_references_axes():
    """``test_distribution.py::test_multipod_mesh_axes``'s axes, on a
    512-rank process group of torch's fake backend (no collective runs)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", rank=0, world_size=512,
                            store=FakeStore())
    try:
        with pytest.raises(ValueError, match="needs 256 ranks"):
            LM.make_mesh((16, 16), ("data", "model"), "cpu")
        m2 = LM.make_production_mesh(multi_pod=True, device_type="cpu")
        assert (list(m2.axis_names), list(m2.devices_shape)) == \
            (["pod", "data", "model"], [2, 16, 16])
        assert m2.coordinate() == {"pod": 0, "data": 0, "model": 0}
        host = LM.make_host_mesh("cpu")
        assert host.shape == {"data": 512, "model": 1}
    finally:
        dist.destroy_process_group()
    dist.init_process_group("fake", rank=0, world_size=256,
                            store=FakeStore())
    try:
        m1 = LM.make_production_mesh(device_type="cpu")
        assert (list(m1.axis_names), list(m1.devices_shape)) == \
            (["data", "model"], [16, 16])
    finally:
        dist.destroy_process_group()


ROUNDTRIP = (("granite-moe-1b-a400m", (1, 3)),   # vocab 256 over 3: uneven
             ("mistral-large-123b", (3, 1)),     # FSDP, d 64 over 3
             ("gemma2-2b", (2, 2)))


def _roundtrip(rank, world, cases):
    out = []
    for arch, shape in cases:
        if shape[0] * shape[1] != world:
            continue
        cfg = get_config(arch).reduced().replace(dtype="float32")
        mesh = LM.make_mesh(shape, ("data", "model"), "cpu")
        params = M.init(cfg, torch.Generator().manual_seed(3), "cpu")
        local = Sh.shard_params(params, mesh, cfg)
        back = Sh.gather_params(local, mesh, cfg, params)
        specs = tree.leaves(Sh.param_pspecs(params, cfg, mesh))
        uneven = sum(
            any(p.shape[d] % Sh.axes_size(mesh, e)
                for d, e in enumerate(s) if e is not None)
            for p, s in zip(tree.leaves(params), specs))
        cut = sum(x.numel() < p.numel() for x, p in
                  zip(tree.leaves(local), tree.leaves(params)))
        same = all(torch.equal(a, b) for a, b in
                   zip(tree.leaves(back), tree.leaves(params)))
        out.append({"arch": arch, "shape": shape, "same": same,
                    "uneven": uneven, "cut": cut})
    return out


@pytest.mark.parametrize("world", [3, 4])
def test_shard_then_gather_is_the_identity(world):
    """Every rank's shard gathered back is the whole tree bitwise, on
    meshes that cut a dim unevenly (granite's padded vocab 256 over 3
    'model' ranks, mistral's FSDP widths over 3 'data' ranks) and on
    (2, 2)."""
    rows = [r for rank in LM.run_ranks(_roundtrip, world, ROUNDTRIP,
                                       timeout=100)
            for r in rank]
    want = [c for c in ROUNDTRIP if c[1][0] * c[1][1] == world]
    assert len(rows) == world * len(want)
    for row in rows:
        assert row["same"] and row["cut"] > 0, row
    if world == 3:
        assert all(r["uneven"] > 0 for r in rows)


def test_refusals_name_their_roadmap_item():
    """What the JAX package refuses is refused before it runs, each
    message saying why the reference refuses it and naming its ROADMAP
    ID (shape-only meshes suffice): a 'model' axis that does not split
    the FFN columns, experts or SSM heads into whole ones a rank (A.9.11,
    closed; ``test_torch_refusal_parity.py`` holds each to the
    reference's own refusal).  Attention heads split unevenly, as GSPMD
    cuts them (A.9.10, no longer refused: whisper's 6 over 4, minicpm3's
    40 over 16, heads across kv heads), a rank's SSM heads across SSM
    groups are served (A.9.11), and every block kind splits over 'model'
    (A.9.8)."""
    tp = Sh.Mesh((1, 2), ("data", "model"))
    cases = [
        # granite's 32 experts do not split over 3 (its heads would now)
        ("granite-moe-1b-a400m", Sh.Mesh((1, 3), ("data", "model")),
         "n_experts"),
        # zamba2's 64 SSM heads over 128 ranks
        ("zamba2-1.2b", Sh.Mesh((1, 128), ("data", "model")), "ssm_heads"),
        # mistral's FFN width, 28672 columns, over 3
        ("mistral-large-123b", Sh.Mesh((1, 3), ("data", "model")), "d_ff"),
    ]
    why = {"n_experts": "shard_map splits the expert stacks",
           "ssm_heads": "w_in cut to divide", "d_ff": "wg / wu / wd cut"}
    for arch, mesh, width in cases:
        with pytest.raises(NotImplementedError,
                           match=f"{width} .*{why[width]}.*the JAX package "
                                 r"refuses the same mesh \(ROADMAP A.9.11, "
                                 r"closed\)"):
            Sh.check_mesh(get_config(arch), mesh)
    # attention heads that 'model' does not divide (A.9.10): whisper's 6
    # over 4, minicpm3's 40 over 16, gemma2's 8 and gemma3's 4 over 16,
    # and 12 heads over 4 ranks, each rank's 3 across two of 6 kv heads
    for arch, shape in (("whisper-tiny", (1, 4)), ("minicpm3-4b", (1, 16)),
                        ("gemma2-2b", (16, 16)), ("gemma3-1b", (16, 16))):
        Sh.check_mesh(get_config(arch), Sh.Mesh(shape, ("data", "model")))
    Sh.check_mesh(get_config("gemma2-2b").replace(n_heads=12, n_kv_heads=6),
                  Sh.Mesh((1, 4), ("data", "model")))
    # SSM heads and their groups: 8 heads in 4 groups on 4 ranks (a
    # group a rank) is served, and so are 6 heads in 3 groups on 2 ranks
    # and 12 in 3 on 4 (a rank's heads across groups, A.9.11), as the
    # reference runs them
    ssm = get_config("zamba2-1.2b").reduced()
    Sh.check_mesh(ssm.replace(ssm_groups=4), Sh.Mesh((1, 4),
                                                     ("data", "model")))
    Sh.check_mesh(ssm.replace(d_model=48, ssm_groups=3), tp)
    assert Sh.straddles(6, 3, 2)
    Sh.check_mesh(ssm.replace(d_model=96, ssm_groups=3),
                  Sh.Mesh((1, 4), ("data", "model")))
    assert Sh.straddles(12, 3, 4)
    # the kinds A.9.8 lifted, and the production meshes of every arch
    # whose widths 16 'model' ranks divide (mistral's 8 kv heads among
    # them)
    for arch in ("zamba2-1.2b", "deepseek-v2-lite-16b", "minicpm3-4b",
                 "whisper-tiny", "gemma3-1b"):
        Sh.check_mesh(get_config(arch), tp)
    Sh.check_mesh(get_config("mamba2-1.3b"), tp)
    for shape, axes in (((16, 16), ("data", "model")),
                        ((2, 16, 16), ("pod", "data", "model"))):
        for arch in ("mistral-large-123b", "zamba2-1.2b"):
            Sh.check_mesh(get_config(arch), Sh.Mesh(shape, axes))
    # SP through moe blocks (A.9.8)
    Sh.check_mesh(get_config("granite-moe-1b-a400m").replace(use_sp=True),
                  tp)
    # data-parallel meshes are served for every arch; TP for GQA blocks,
    # on an FSDP config too, with sequence parallelism where the config
    # asks for it (mistral; pixtral's FSDP; A.9.7, no longer refused)
    for arch in ("zamba2-1.2b", "deepseek-v2-lite-16b", "whisper-tiny",
                 "mistral-large-123b"):
        Sh.check_mesh(get_config(arch), Sh.Mesh((4, 1), ("data", "model")))
    for arch in ("granite-moe-1b-a400m", "gemma2-2b", "mistral-large-123b"):
        Sh.check_mesh(get_config(arch), tp)
    Sh.check_mesh(get_config("pixtral-12b"), tp)
    # int8 compression on a mesh (A.13.1, no longer refused): the step
    # builds, its error state laid out as the optimizer state
    cfg = get_config("gemma2-2b").reduced()
    like = M.init(cfg, None, torch.device("meta"))
    batch = {"tokens": torch.empty((4, 8), device="meta")}
    step = loop.make_sharded_train_step(
        cfg, loop.TrainConfig(compress_grads=True),
        Sh.Mesh((2, 1), ("data", "model")), like, batch)
    assert callable(step)
    with pytest.raises(ValueError, match="do not split"):
        loop.make_sharded_train_step(
            cfg, loop.TrainConfig(accum=3),
            Sh.Mesh((2, 1), ("data", "model")), like, batch)
    # sequence parallelism over a 'model' axis of 2 (A.9.7, no longer
    # refused) cuts the stream to this rank's chunk (rank 0 of a fake
    # 2-rank group: the first half); over 1 it is the identity
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    x = torch.arange(64.0).reshape(2, 8, 4)
    dist.init_process_group("fake", rank=0, world_size=2, store=FakeStore())
    try:
        with Sh.active_mesh(LM.make_mesh((1, 2), ("data", "model"), "cpu")):
            chunk = Sh.constrain(x, "batch", "model", None)
            assert torch.equal(chunk, x[:, :4])
            assert Sh.current_state()[2] == 8
            assert Sh.constrain(chunk, "batch", "model", None) is chunk
        assert Sh.current_state() == (None, {}, None)
    finally:
        dist.destroy_process_group()
    with Sh.active_mesh(Sh.Mesh((2, 1), ("data", "model"))):
        assert Sh.constrain(x, "batch", "model", None) is x


# (config overrides, 'model' ranks) -> each rank's q heads and the kv
# heads its cache holds
UNEVEN = (("whisper-tiny", {}, 4, [2, 2, 2, 0], [2, 2, 2, 0]),
          ("minicpm3-4b", {}, 16, [3] * 13 + [1, 0, 0], None),
          ("gemma2-2b", {}, 16, [1] * 8 + [0] * 8, [1] * 8 + [0] * 8),
          ("gemma3-1b", {}, 8, [1] * 4 + [0] * 4, [1] * 4 + [0] * 4),
          ("gemma2-2b", {"n_heads": 6, "n_kv_heads": 2}, 4, [2, 2, 2, 0],
           [1, 2, 1, 0]),
          # heads that straddle kv heads unevenly: one kv head a q head
          ("gemma2-2b", {"n_heads": 12, "n_kv_heads": 6}, 4, [3] * 4,
           [3] * 4))


@pytest.mark.parametrize("arch,over,m,heads,kv", UNEVEN,
                         ids=[f"{u[0]}-{u[2]}-{u[1].get('n_heads', '')}"
                              for u in UNEVEN])
def test_uneven_heads_model_range_and_cache_shard_shape(arch, over, m,
                                                         heads, kv):
    """A.9.10: each rank of a (1, m) mesh (rank r of a fake process
    group) holds heads as ``chunk_range`` cuts an uneven dim, ceil-sized
    chunks with the last ranks short or empty (rank 0 the largest), and
    its k and v cache holds the kv heads those heads read, none on a rank
    without heads (an MLA cache is whole on every rank)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    cfg = get_config(arch).replace(**over)
    cache = M.init_cache(cfg, 4, 32, "meta")
    got_heads, got_kv = [], []
    for r in range(m):
        dist.init_process_group("fake", rank=r, world_size=m,
                                store=FakeStore())
        try:
            mesh = LM.make_mesh((1, m), ("data", "model"), "cpu")
            with Sh.active_mesh(mesh):
                lo, hi = Sh.model_range(cfg.n_heads)
            got_heads.append(hi - lo)
            for path, x in tree.paths(cache):
                if path[-1] == "k":
                    shape = Sh.cache_shard_shape(path, x.shape, cfg, mesh)
                    got_kv.append(shape[2])
                    break
                if path[-1] == "c_kv":
                    assert Sh.cache_shard_shape(path, x.shape, cfg,
                                                mesh) == x.shape
                    break
        finally:
            dist.destroy_process_group()
    assert got_heads == heads and sum(heads) == cfg.n_heads
    assert got_kv == (kv or [])


def _dtensor_refused(rank, world):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.kernels import gemm
    dmesh = init_device_mesh("cpu", (1,))
    a = distribute_tensor(torch.ones(4, 4), dmesh, [Replicate()])
    try:
        _build.route("gemm", a, a)
    except TypeError as e:
        msg = str(e)
    else:
        msg = None
    try:
        gemm.gemm(a, a)
    except TypeError as e:
        return msg, str(e)
    return msg, None


def test_route_refuses_a_dtensor():
    msg, via_kernel = LM.run_ranks(_dtensor_refused, 1, timeout=60)[0]
    assert msg is not None and "DTensor" in msg and "to_local" in msg
    assert via_kernel is not None and "DTensor" in via_kernel


def test_run_ranks_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        LM.run_ranks(_fail_on_one, 2, timeout=60)


def _fail_on_one(rank, world):
    if rank == 1:
        raise ValueError("planted")
    return rank
