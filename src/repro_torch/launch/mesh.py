"""Meshes of ranks over the live process group, and a launcher that
spawns the ranks of one host.

The JAX package's ``launch/mesh.py`` builds ``jax.make_mesh`` meshes;
here each function builds a ``models.sharding.Mesh`` around a
``torch.distributed.device_mesh.DeviceMesh`` over the process group that
is already up (``torch.distributed.init_process_group``), with the same
shapes and axis names.  The device type is ``"cuda"`` unless the caller
asks for ``"cpu"``.  ``sharding.Mesh(shape, axes)`` with no process
group is the shape-only mesh the spec functions also take.

:func:`run_ranks` starts the ranks of a mesh on this host, each in its
own process in a gloo group (gloo carries CUDA tensors by staging them
through the host, so several ranks may share one card, which NCCL
refuses), with a timeout on every collective and on the whole run.
"""
from __future__ import annotations

import datetime
import math
import pickle
import socket
import time
import traceback

from ..models.sharding import Mesh


def make_mesh(shape, axes, device_type: str = "cuda") -> Mesh:
    """A mesh of ``shape`` over ``axes``, rank r at r's row-major place,
    over the live process group (whose world size must be the product of
    ``shape``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a live process group "
                           "(torch.distributed.init_process_group)")
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"mesh {shape} over {axes} needs "
                         f"{math.prod(shape)} ranks, the world has "
                         f"{dist.get_world_size()}")
    import torch
    ranks = torch.arange(math.prod(shape)).reshape(shape)
    return Mesh(shape, axes, DeviceMesh(device_type, ranks,
                                        mesh_dim_names=axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> Mesh:
    """(16,16) data x model single pod; (2,16,16) pod x data x model."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_host_mesh(device_type: str = "cuda") -> Mesh:
    """Every rank of the process group as a (world, 1) data x model
    mesh."""
    import torch.distributed as dist
    return make_mesh((dist.get_world_size(), 1), ("data", "model"),
                     device_type)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, port, timeout, results, args):
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout))
    try:
        # pickled here, so that tensors travel as bytes rather than as
        # shared memory this process takes with it when it exits
        results.put((rank, None, pickle.dumps(fn(rank, world, *args))))
    except BaseException:
        results.put((rank, traceback.format_exc(), None))
        raise
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, *args, timeout: float = 600.0):
    """``fn(rank, world, *args)`` in ``world`` spawned processes of this
    host, each in one gloo process group over a free localhost port; ->
    their return values (picklable, host objects), in rank order.
    Raises with the rank's traceback if a rank raises or exits non-zero,
    and kills every rank if the run outlasts ``timeout`` seconds (each
    collective also gives up after it)."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, port, timeout, results, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    got, failure = {}, None
    try:
        while len(got) < world and failure is None:
            if not results.empty():
                rank, err, value = results.get()
                if err is not None:
                    failure = f"rank {rank} of {world} failed:\n{err}"
                else:
                    got[rank] = pickle.loads(value)
                continue
            dead = [p for p in procs if p.exitcode not in (None, 0)]
            if dead and results.empty():
                failure = (f"rank {procs.index(dead[0])} of {world} exited "
                           f"with code {dead[0].exitcode}")
            elif time.monotonic() > deadline:
                failure = f"{world} ranks outlasted {timeout} s"
            else:
                time.sleep(0.02)
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic())
                   if failure is None else 5.0)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if failure is None:
        bad = [(r, p.exitcode) for r, p in enumerate(procs)
               if p.exitcode != 0]
        if bad:
            failure = f"ranks (rank, exit code) {bad} of {world} failed"
    if failure is not None:
        raise RuntimeError(failure)
    return [got[r] for r in range(world)]
