"""Prefill and decode on a mesh (``serve.engine.make_prefill_step`` /
``make_serve_step`` with ``mesh``) against the JAX package's steps under
GSPMD, as its dry run lowers them.

Each case is float32 at ``cfg.reduced()`` widths: a prefill of 4 rows of
24 tokens (and whisper's stub frames, or pixtral's stub patches before
them) into a 32-position cache (and the patches'), then 4 decode steps
fed the same tokens on both sides.  The reference jits its
steps with the params sharded by ``param_pspecs``, the cache by
``cache_pspecs`` and the rows by ``batch_spec``, under ``active_mesh``,
on as many forced host devices
as the mesh has (an Auto mesh, ROADMAP C.2), in a subprocess; the port
runs each rank's step on as many gloo CPU ranks
(``launch.mesh.run_ranks``) from the reference's ``init`` (carried across
by ``models/convert.py``).  Held: each rank's logits and its part of
every cache leaf within 2e-4 of max|.| of the reference's at the same
place.  The cache layouts that differ from ``cache_pspecs`` (ROADMAP
C.33-C.35) are pinned by their bytes a rank.  Two cases split the heads
unevenly (A.9.10): gemma2 with 6 heads over 2 kv heads, and whisper with
6 heads over 2 kv heads, on (1, 4): heads 2 / 2 / 2 / 0, the last rank
holding no heads and no cache of k and v.  Where heads straddle kv heads
unevenly (12 over 6 on (1, 4): rank 0's heads 0, 1, 2 read kv heads 0,
0, 1), a rank's cache holds one kv head a q head, which
``cache_pspecs``' cut of 6 kv heads over 4 ranks does not give; those
cases are held to the port's single rank instead, the logits within
2e-4 and each rank's cache equal to the single rank's heads read.  SSM
heads that straddle SSM groups (zamba2 with ``d_model`` 48 and 3
groups on (1, 2): each rank's 3 heads read two of the groups, ROADMAP
A.9.11) are held to the reference: each rank's conv history keeps its
heads' and groups' channels (C.34) and its state its heads (C.35), the
shapes ``sharding.cache_shard_shape`` gives.
"""
import json
import os
import pickle
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.launch import mesh as LM
from repro_torch.models import convert
from repro_torch.models import model as M
from repro_torch.models import sharding as Sh
from repro_torch.serve import engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (arch, mesh, config overrides): SSM state and conv history (zamba2, and
# mamba2's mamba blocks alone); a vlm's patch prefix on 'model' and on
# 'data' (pixtral: its cache holds the patches' positions too);
# per-data-shard capacity with experts over 'model'; one kv head below
# 'model'; FSDP; heads that 'model' does not divide (GQA, and whisper's
# encoder, decoder and cross-attention; its kv heads below 'model', so
# that the reference's cache divides the mesh); SSM heads across SSM
# groups
UNEVEN = {"n_heads": 6, "n_kv_heads": 2}
STRADDLE = {"d_model": 48, "ssm_groups": 3}
CASES = (("zamba2-1.2b", (1, 2), {}), ("granite-moe-1b-a400m", (2, 2), {}),
         ("gemma3-1b", (1, 2), {}), ("mistral-large-123b", (2, 2), {}),
         ("gemma2-2b", (1, 4), UNEVEN), ("whisper-tiny", (1, 4), UNEVEN),
         ("mamba2-1.3b", (1, 2), {}), ("pixtral-12b", (1, 2), {}),
         ("pixtral-12b", (2, 2), {}), ("zamba2-1.2b", (1, 2), STRADDLE))
TRAFFIC = dict(batch=4, prompt=24, max_seq=32, steps=4)
TOL = 2e-4

REFERENCE = r"""
import json, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, PartitionSpec as P
from repro.configs import get_config
from repro.data.pipeline import extra_inputs
from repro.models import model as M, sharding as Sh
from repro.serve.engine import make_prefill_step, make_serve_step
cases, traffic, path = json.loads(sys.argv[1])
out = []
for arch, shape, over in cases:
    cfg = get_config(arch).reduced().replace(dtype="float32", **over)
    params = M.init(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    b, s = traffic["batch"], traffic["prompt"]
    prompts = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    extra = {k: np.asarray(v) for k, v in extra_inputs(cfg, b).items()}
    feed = rng.integers(0, cfg.vocab_size,
                        (traffic["steps"], b, 1)).astype(np.int32)
    mesh = jax.make_mesh(tuple(shape), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    p_off = cfg.n_patches if cfg.family == "vlm" else 0
    cache = M.init_cache(cfg, b, traffic["max_seq"] + p_off)
    pspecs = Sh.ns(mesh, Sh.param_pspecs(params, cfg, mesh))
    cspecs = Sh.ns(mesh, Sh.cache_pspecs(cache, mesh))
    rows = Sh.ns(mesh, Sh.token_spec(mesh))
    lens = Sh.ns(mesh, Sh.batch_spec(mesh))
    prefill, step = make_prefill_step(cfg), make_serve_step(cfg)

    def pf(p, c, batch):
        with Sh.active_mesh(mesh):
            return prefill(p, c, batch)

    def st(p, c, t, l):
        with Sh.active_mesh(mesh):
            return step(p, c, t, l)
    batch = {"tokens": rows, **{k: rows for k in extra}}
    pf = jax.jit(pf, in_shardings=(pspecs, cspecs, batch),
                 out_shardings=(None, cspecs))
    st = jax.jit(st, in_shardings=(pspecs, cspecs, rows, lens),
                 out_shardings=(None, cspecs))
    with mesh:
        logits, cache = pf(params, cache, {"tokens": jnp.asarray(prompts),
                                           **extra})
        runs = [np.asarray(logits)]
        for i in range(traffic["steps"]):
            lengths = jnp.full((b,), s + p_off + i, jnp.int32)
            logits, cache = st(params, cache, jnp.asarray(feed[i]), lengths)
            runs.append(np.asarray(logits))
    out.append({"params": jax.tree.map(np.asarray, params),
                "prompts": prompts, "extra": extra, "feed": feed,
                "logits": runs,
                "cache": jax.tree.map(np.asarray, cache)})
with open(path, "wb") as f:
    pickle.dump(out, f)
"""


def _config(arch, over=None):
    return get_config(arch).reduced().replace(dtype="float32",
                                              **(over or {}))


def _port(rank, world, cases, refs):
    """Each case of ``world`` ranks: this rank's logits of every step and
    its cache leaves, with its coordinate."""
    torch.set_num_threads(1)
    out = []
    for case, ((arch, shape, over), ref) in enumerate(zip(cases, refs)):
        if shape[0] * shape[1] != world:
            continue
        cfg = _config(arch, over)
        p_off = cfg.n_patches if cfg.family == "vlm" else 0
        mesh = LM.make_mesh(shape, ("data", "model"), "cpu")
        full = convert.from_jax(ref["params"], cfg, device="cpu")
        like = tree.map(lambda x: x.to("meta"), full)
        local = Sh.shard_params(full, mesh, cfg)
        cache = M.init_cache(cfg, TRAFFIC["batch"],
                             TRAFFIC["max_seq"] + p_off, "cpu", mesh=mesh)
        prefill = engine.make_prefill_step(cfg, mesh=mesh, params_sds=like)
        step = engine.make_serve_step(cfg, mesh=mesh, params_sds=like)
        rows = lambda a: Sh.local_rows(torch.as_tensor(a), mesh)  # noqa
        with torch.no_grad():
            logits, cache = prefill(local, cache, {
                "tokens": rows(ref["prompts"]),
                **{k: rows(v) for k, v in ref["extra"].items()}})
            runs = [logits]
            for i in range(TRAFFIC["steps"]):
                lengths = torch.full((TRAFFIC["batch"],),
                                     TRAFFIC["prompt"] + p_off + i,
                                     dtype=torch.int32)
                logits, cache = step(local, cache, rows(ref["feed"][i]),
                                     Sh.local_rows(lengths, mesh))
                runs.append(logits)
        out.append({"case": case, "coord": mesh.coordinate(),
                    "logits": [x.numpy() for x in runs],
                    "cache": [(p, x.numpy()) for p, x in tree.paths(cache)],
                    "shard_shapes": [Sh.cache_shard_shape(
                        p, x.shape, cfg, mesh) for p, x in tree.paths(
                            M.init_cache(cfg, TRAFFIC["batch"],
                                         TRAFFIC["max_seq"] + p_off,
                                         "meta"))]})
    return out


@pytest.fixture(scope="module")
def runs():
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4 "
                        "--xla_backend_optimization_level=0"}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "reference.pkl")
        proc = subprocess.run(
            [sys.executable, "-c", REFERENCE,
             json.dumps([CASES, TRAFFIC, path])],
            env=env, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        with open(path, "rb") as f:
            refs = pickle.load(f)
    port = {}
    for world in sorted({s[0] * s[1] for _, s, _ in CASES}):
        for rank_out in LM.run_ranks(_port, world, CASES, refs,
                                     timeout=600):
            for r in rank_out:
                port.setdefault(r["case"], []).append(r)
    return refs, port


def _part(path, full, cfg, coord, mesh_shape):
    """The part of the reference's full cache leaf ``full`` that the rank
    at ``coord`` holds (``sharding.cache_shard_shape``'s layout)."""
    name = [k for k in path if isinstance(k, str)][-1]
    d, m = mesh_shape
    rows = full.shape[0] // d
    x = full[coord["data"] * rows:(coord["data"] + 1) * rows]
    r = coord["model"]
    if m == 1:
        return x
    if name in ("k", "v", "xk", "xv"):
        lo, hi = Sh.groups_read(*Sh.chunk_range(cfg.n_heads, r, m),
                                cfg.n_heads, x.shape[2])
        return x[:, :, lo:hi]
    if name == "state":
        return x[:, r * x.shape[1] // m:(r + 1) * x.shape[1] // m]
    if name == "conv":
        sh, g, n, p = (cfg.ssm_heads, cfg.ssm_groups, cfg.ssm_state,
                       cfg.ssm_headdim)
        di = cfg.d_inner
        lo, hi = r * sh // m, (r + 1) * sh // m
        glo, ghi = Sh.groups_read(lo, hi, sh, g)
        ch = np.concatenate([np.arange(lo * p, hi * p),
                             np.arange(di + glo * n, di + ghi * n),
                             np.arange(di + (g + glo) * n,
                                       di + (g + ghi) * n)])
        return x[:, :, ch]
    return x


def _ref_leaf(cache, path):
    """The reference's leaf at the port's ``path``: a stacked unit's
    leaf at the repeat's index."""
    if path[0] == "unit":
        node = cache["unit"][path[1]]
        for k in path[3:]:
            node = node[k]
        return node[path[2]]
    node = cache
    for k in path:
        node = node[k]
    return node


@pytest.mark.parametrize("arch,shape,over", CASES,
                         ids=[f"{a}-{s[0]}x{s[1]}" for a, s, _ in CASES])
def test_mesh_serving_matches_the_reference(runs, arch, shape, over):
    refs, port = runs
    case = CASES.index((arch, shape, over))
    ref = refs[case]
    cfg = _config(arch, over)
    ranks = port[case]
    assert len(ranks) == shape[0] * shape[1]
    b = TRAFFIC["batch"] // shape[0]
    for r in ranks:
        # the cache the rank holds has cache_shard_shape's shapes
        assert [x.shape for _, x in r["cache"]] == r["shard_shapes"], arch
        lo = r["coord"]["data"] * b
        for want, got in zip(ref["logits"], r["logits"]):
            want = want[lo:lo + b]
            err = np.max(np.abs(got - want)) / np.max(np.abs(want))
            assert err <= TOL, (arch, r["coord"], err)
        for path, got in r["cache"]:
            want = _part(path, _ref_leaf(ref["cache"], path), cfg,
                         r["coord"], shape)
            assert got.shape == want.shape, (arch, path)
            if want.size == 0:        # a rank without heads: no k and v
                continue
            scale = max(np.max(np.abs(want)), 1e-30)
            assert np.max(np.abs(got - want)) / scale <= TOL, (arch, path)


def _bytes_a_rank(cfg, shape, batch=4, s_max=64):
    """(port's, cache_pspecs') cache bytes of rank 0 by leaf name, on a
    fake process group of as many ranks."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", rank=0, world_size=shape[0] * shape[1],
                            store=FakeStore())
    try:
        mesh = LM.make_mesh(shape, ("data", "model"), "cpu")
        full = M.init_cache(cfg, batch, s_max, "meta")
        local = M.init_cache(cfg, batch, s_max, "meta", mesh=mesh)
        specs = tree.leaves(Sh.cache_pspecs(full, mesh))
        port, ref = {}, {}
        for (path, x), y, spec in zip(tree.paths(full), tree.leaves(local),
                                      specs):
            name = [k for k in path if isinstance(k, str)][-1]
            part = [n if i >= len(spec) or spec[i] is None
                    else -(-n // Sh.axes_size(mesh, spec[i]))
                    for i, n in enumerate(x.shape)]
            port[name] = port.get(name, 0) + y.numel() * y.element_size()
            ref[name] = ref.get(name, 0) + int(np.prod(part)) * \
                x.element_size()
    finally:
        dist.destroy_process_group()
    return port, ref


def test_cache_layouts_pinned_by_their_bytes():
    """C.33: one kv head below 'model' (gemma3 on (1, 2)): the rank holds
    the whole head its q heads read, twice ``cache_pspecs``' half of its
    head dim.  C.34: the conv history holds the rank's channels, not all
    of them.  C.35: the SSM state, cut along heads, holds the bytes of
    ``cache_pspecs``' cut along p.  Elsewhere the bytes agree."""
    port, ref = _bytes_a_rank(_config("gemma3-1b"), (1, 2))
    assert port["k"] == 2 * ref["k"] and port["v"] == 2 * ref["v"]
    cfg = _config("zamba2-1.2b")
    port, ref = _bytes_a_rank(cfg, (1, 2))
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    mine = cfg.d_inner // 2 + 2 * cfg.ssm_state     # 4 heads read 1 group
    assert port["conv"] * conv_dim == ref["conv"] * mine
    assert port["state"] == ref["state"]
    assert (port["k"], port["v"]) == (ref["k"], ref["v"])
    for arch, shape in (("granite-moe-1b-a400m", (2, 2)),
                        ("mistral-large-123b", (2, 2)),
                        ("deepseek-v2-lite-16b", (1, 2))):
        assert _bytes_a_rank(_config(arch), shape)[0] == \
            _bytes_a_rank(_config(arch), shape)[1], arch


# heads that straddle kv heads unevenly (A.9.10): gemma2 and whisper (its
# cross-attention's xk and xv too) with 12 heads over 6 kv heads on (1, 4)
STRADDLED = (("gemma2-2b", (1, 4), {"n_heads": 12, "n_kv_heads": 6}),
             ("whisper-tiny", (1, 4), {"n_heads": 12, "n_kv_heads": 6}))


def _serve(cfg, mesh):
    """Prefill and ``TRAFFIC["steps"]`` decode steps of ``cfg`` on this
    rank of ``mesh`` (None: one rank), params from seed 0 and tokens from
    numpy's; -> (each step's logits, the cache's (path, leaf) pairs)."""
    b = TRAFFIC["batch"]
    full = M.init(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (b, TRAFFIC["prompt"])).astype(np.int32))
    feed = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (TRAFFIC["steps"], b, 1)).astype(np.int32))
    extra = {}
    if cfg.family == "encdec":
        from repro_torch.data.pipeline import extra_inputs
        extra = extra_inputs(cfg, b, device="cpu")
    params, like, rows = full, None, (lambda a: a)
    if mesh is not None:
        like = tree.map(lambda x: x.to("meta"), full)
        params = Sh.shard_params(full, mesh, cfg)
        rows = lambda a: Sh.local_rows(a, mesh)  # noqa: E731
    cache = M.init_cache(cfg, b, TRAFFIC["max_seq"], "cpu", mesh=mesh)
    prefill = engine.make_prefill_step(cfg, mesh=mesh, params_sds=like)
    step = engine.make_serve_step(cfg, mesh=mesh, params_sds=like)
    with torch.no_grad():
        logits, cache = prefill(params, cache, {
            "tokens": rows(prompts),
            **{k: rows(v) for k, v in extra.items()}})
        runs = [logits.numpy()]
        for i in range(TRAFFIC["steps"]):
            lengths = torch.full((b,), TRAFFIC["prompt"] + i,
                                 dtype=torch.int32)
            logits, cache = step(params, cache, rows(feed[i]),
                                 rows(lengths))
            runs.append(logits.numpy())
    return runs, [(p, x.numpy()) for p, x in tree.paths(cache)]


def _straddled(rank, world, cases):
    torch.set_num_threads(1)
    out = []
    for arch, shape, over in cases:
        mesh = LM.make_mesh(shape, ("data", "model"), "cpu")
        out.append((mesh.coordinate(), *_serve(_config(arch, over), mesh)))
    return out


@pytest.fixture(scope="module")
def straddled():
    return LM.run_ranks(_straddled, 4, STRADDLED, timeout=600)


@pytest.mark.parametrize("case", range(len(STRADDLED)),
                         ids=[c[0] for c in STRADDLED])
def test_straddled_heads_serve_as_the_single_rank(straddled, case):
    arch, shape, over = STRADDLED[case]
    cfg = _config(arch, over)
    logits, cache = _serve(cfg, None)
    n, hkv = cfg.n_heads, cfg.n_kv_heads
    for r, rank in enumerate(straddled):
        coord, got_logits, got_cache = rank[case]
        for want, got in zip(logits, got_logits):
            err = np.max(np.abs(got - want)) / np.max(np.abs(want))
            assert err <= TOL, (arch, coord, err)
        lo, hi = Sh.chunk_range(n, coord["model"], shape[1])
        assert hi - lo == 3
        for (path, want), (_, got) in zip(cache, got_cache):
            name = [k for k in path if isinstance(k, str)][-1]
            if name in ("k", "v", "xk", "xv"):
                # one kv head a q head: head j reads j // (n / hkv)
                want = want[:, :, np.arange(lo, hi) // (n // hkv)]
            assert got.shape == want.shape, (arch, path)
            scale = max(np.max(np.abs(want)), 1e-30)
            assert np.max(np.abs(got - want)) / scale <= TOL, (arch, path)
