"""Multi-pod dry run: trace one rank's step of every (arch x shape x mesh)
cell, without a card and without allocating a tensor.

The JAX package's ``launch/dryrun.py`` lowers and compiles each cell's
step on 512 forced host devices and reads XLA's memory and cost analyses.
Here each cell brings up torch's ``fake`` process group at the mesh's
256 or 512 ranks, builds the production mesh over it and runs rank 0's
step on stand-ins (``meta`` tensors inside ``kernels._build.
stand_in_card``: the shapes of the card's tensors, no data) under the
``h100`` target and the kernel policy, so each op takes the tier the card
would run and each hand kernel's launch is recorded rather than made:

  * train: ``train.loop.make_sharded_train_step`` (ZeRO-1, FSDP where the
    config says so, the cell's ``accum_for`` microbatches, remat);
  * prefill / decode: ``serve.engine.make_prefill_step`` /
    ``make_serve_step`` on the mesh, one new token against a ``seq_len``
    cache for decode.

``launch/graph_analysis.py`` counts what the rank dispatches.  A cell is
``ok``; ``skipped`` with the reference's reason; ``refused`` with
``sharding.check_mesh``'s message (the reference refuses the same
mesh: ROADMAP A.9.11, closed); or ``error`` with
its trace.  ``argument_bytes`` are the rank's params, optimizer slices, rows
of the batch and part of the cache (``model.init_cache`` with the mesh);
``make_sharded_train_step`` takes the global batch and reads its rows of
it.  ``fits`` holds ``peak_bytes`` to one NVIDIA H100 80GB HBM3.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch zamba2-1.2b \\
      --shape train_4k --mesh single          # one cell
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --out build/dryrun.json                 # the full matrix
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

import torch

from .. import tree
from ..configs import ARCH_NAMES, SHAPES, get_config
from ..core import use_policy, use_target
from ..kernels import _build
from ..models import model as M
from ..models import sharding as Sh
from ..serve.engine import make_prefill_step, make_serve_step
from ..train import loop
from . import graph_analysis
from . import mesh as LM

CARD_BYTES = 80 * 10 ** 9          # one NVIDIA H100 80GB HBM3
SKIP_REASON = "full-attention arch at 500k cache (DESIGN.md)"


def accum_for(cfg, shape) -> int:
    """The reference's microbatches of a cell (its memory-fit knob)."""
    if shape.kind != "train":
        return 1
    if cfg.d_model >= 12_000:
        a = 4 if cfg.use_sp else 16
    elif cfg.d_model >= 5_000:
        a = 8
    elif cfg.d_model >= 2_000:
        a = 4
    else:
        a = 2
    if cfg.vocab_size >= 100_000:
        a = max(a, 8)   # big-vocab logits dominate activation memory
    return a


def input_specs(cfg, shape_name):
    """(shape, {input name: (shape, dtype)}) of every model input of the
    cell, the global batch."""
    shape = SHAPES[shape_name]
    b, s = shape.global_batch, shape.seq_len
    specs = {"tokens": ((b, s if shape.kind != "decode" else 1),
                        torch.int32)}
    if shape.kind == "train":
        specs["targets"] = ((b, s), torch.int32)
    if cfg.family == "encdec" and shape.kind != "decode":
        specs["frames"] = ((b, cfg.n_frames, cfg.d_model), torch.float32)
    if cfg.family == "vlm" and shape.kind != "decode":
        specs["patches"] = ((b, cfg.n_patches, cfg.d_model), torch.float32)
    return shape, specs


def cut_depth(cfg, units):
    """``cfg`` with its prefix, ``units`` repeats of its pattern unit and
    its remainder (``units`` None: as it is)."""
    if units is None:
        return cfg
    prefix, unit, _, _ = cfg.pattern_unit()
    return cfg.replace(n_layers=len(prefix) + units * len(unit))


@contextlib.contextmanager
def fake_ranks(world, rank=0):
    """torch's ``fake`` process group of ``world`` ranks, this process
    ``rank`` (no collective moves data)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", rank=rank, world_size=world,
                            store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def tensor_bytes(tr) -> int:
    """Bytes of the tensors in the tree ``tr``."""
    return sum(x.numel() * x.element_size() for x in tree.leaves(tr)
               if isinstance(x, torch.Tensor))


def build_cell(cfg, kind, specs, mesh, accum=1, cache_len=None):
    """(arguments by part, the global batch, the step on them) of this
    process's rank of ``mesh`` (rank 0 in the dry run's cells): a
    ``kind`` step (train, prefill or decode) of ``cfg`` on the global
    batch of ``specs`` ({name: (shape, dtype)}), ``accum`` microbatches
    in train, a cache of ``cache_len`` positions in serving; stand-ins
    on ``meta``, nothing allocated."""
    meta = torch.device("meta")
    batch = {k: torch.empty(s, dtype=dt, device=meta)
             for k, (s, dt) in specs.items()}
    rows = {k: Sh.local_rows(v, mesh) for k, v in batch.items()}
    params_sds = M.init(cfg, None, meta)
    params = Sh.shard_params(params_sds, mesh, cfg)
    args = {"params": params, "batch": rows}
    if kind == "train":
        tcfg = loop.TrainConfig(accum=accum)
        loop.trainable(params)
        args["opt"] = loop.sharded_opt_init(params, cfg, mesh, params_sds)
        step = loop.make_sharded_train_step(cfg, tcfg, mesh, params_sds,
                                            batch)
        return args, batch, lambda: step(params, args["opt"], None, batch)
    args["cache"] = M.init_cache(cfg, specs["tokens"][0][0], cache_len,
                                 meta, mesh=mesh)
    if kind == "prefill":
        step = make_prefill_step(cfg, mesh=mesh, params_sds=params_sds)
        return args, batch, lambda: step(params, args["cache"], rows)
    lengths = torch.empty((rows["tokens"].shape[0],), dtype=torch.int32,
                          device=meta)
    step = make_serve_step(cfg, mesh=mesh, params_sds=params_sds)
    return args, batch, lambda: step(params, args["cache"], rows["tokens"],
                                     lengths)


def cell_inputs(cfg, shape_name):
    """(kind, input specs, accum, cache length) of a production cell."""
    shape, specs = input_specs(cfg, shape_name)
    p_off = cfg.n_patches if cfg.family == "vlm" else 0
    return shape.kind, specs, accum_for(cfg, shape), shape.seq_len + p_off


def trace_cell(cfg, kind, specs, mesh, accum=1, cache_len=None):
    """This rank's step (:func:`build_cell`) run on stand-ins under the
    ``h100`` target and the kernel policy and counted
    (``graph_analysis.Counter``) -> (its record, argument bytes by
    part)."""
    args, batch, run = build_cell(cfg, kind, specs, mesh, accum, cache_len)
    grad = torch.enable_grad() if kind == "train" else torch.no_grad()
    with _build.stand_in_card(), use_policy("pallas"), use_target("h100"), \
            grad, graph_analysis.Counter() as counter:
        # (the train step takes the global batch; serving, the rows)
        counter.track(args, batch if kind == "train" else None)
        run()
    return counter.result(), {k: tensor_bytes(v) for k, v in args.items()}


def mesh_of(multi_pod, mesh_shape=None):
    """(mesh name, shape, axes) of a cell."""
    if mesh_shape is not None:
        return (f"pod{mesh_shape[0]}x{mesh_shape[1]}", tuple(mesh_shape),
                ("data", "model"))
    if multi_pod:
        return "pod2x16x16", (2, 16, 16), ("pod", "data", "model")
    return "pod16x16", (16, 16), ("data", "model")


def cell_status(arch, shape_name, dims, axes, units=None):
    """(status, reason, config) of a cell before any trace: skipped,
    refused, or ok to trace (reason None)."""
    cfg = get_config(arch)
    if shape_name in cfg.skip_shapes:
        return "skipped", SKIP_REASON, cfg
    cfg = cut_depth(cfg, units)
    try:
        Sh.check_mesh(cfg, Sh.Mesh(dims, axes))
    except NotImplementedError as e:
        return "refused", str(e), cfg
    return "ok", None, cfg


def run_cell(arch, shape_name, *, multi_pod, mesh_shape=None, units=None):
    """The cell's record (one JSON line of the dry run)."""
    mesh_name, dims, axes = mesh_of(multi_pod, mesh_shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    status, reason, cfg = cell_status(arch, shape_name, dims, axes, units)
    if status != "ok":
        return {**rec, "status": status, "reason": reason}
    kind, specs, accum, cache_len = cell_inputs(cfg, shape_name)
    t0 = time.perf_counter()
    try:
        with fake_ranks(math.prod(dims)):
            out, parts = trace_cell(cfg, kind, specs,
                                    LM.make_mesh(dims, axes, "cpu"), accum,
                                    cache_len)
    except Exception as e:  # noqa: BLE001
        return {**rec, "status": "error", "error": f"{type(e).__name__}: "
                f"{e}", "trace": traceback.format_exc()[-2000:]}
    total, active = cfg.param_counts()
    return {**rec, "status": "ok", "n_devices": math.prod(dims),
            "n_layers": cfg.n_layers,
            **({"accum": accum} if kind == "train" else {}), **out,
            "argument_bytes": sum(parts.values()), "argument_parts": parts,
            "fits": out["peak_bytes"] <= CARD_BYTES,
            "trace_s": time.perf_counter() - t0,
            "params_total": total, "params_active": active}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--mesh-shape", default=None,
                    help="a (data, model) remap of the ranks, e.g. '64,4'")
    ap.add_argument("--units", type=int, default=None,
                    help="cut each arch to its prefix and this many "
                         "pattern units (default: full depth)")
    args = ap.parse_args(argv)
    mesh_shape = tuple(int(x) for x in args.mesh_shape.split(",")) \
        if args.mesh_shape else None
    archs = ARCH_NAMES if args.all or not args.arch else (args.arch,)
    shapes = tuple(SHAPES) if args.all or not args.shape else (args.shape,)
    meshes = {"single": (False,), "multi": (True,),
              "both": (False, True)}[args.mesh]

    results = []
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results
            if r["status"] in ("ok", "skipped")}
    for multi in meshes:
        mesh_name = "pod2x16x16" if multi else "pod16x16"
        for arch in archs:
            for shape in shapes:
                if (arch, shape, mesh_name) in done:
                    continue
                rec = run_cell(arch, shape, multi_pod=multi,
                               mesh_shape=mesh_shape, units=args.units)
                results = [r for r in results if
                           (r["arch"], r["shape"], r["mesh"]) !=
                           (arch, shape, rec["mesh"])] + [rec]
                print(json.dumps({k: v for k, v in rec.items()
                                  if k != "trace"}), flush=True)
                if args.out:
                    os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                                exist_ok=True)
                    with open(args.out, "w") as f:
                        json.dump(results, f, indent=1)
    counts = {s: sum(r["status"] == s for r in results)
              for s in ("ok", "skipped", "refused", "error")}
    print("# dry-run: " + ", ".join(f"{v} {k}" for k, v in counts.items()))
    return 0 if counts["error"] == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
