"""GPipe-style pipeline parallelism over a 'pipe' mesh axis.

The JAX package's ``train/pipeline.py`` in torch, explicit SPMD over the
ranks of a mesh (``launch/mesh.py``): each rank of the ``axis`` runs its
own stage, and microbatches stream through a loop of M + S - 1 ticks
whose inter-stage hop is a point-to-point send from stage i to stage
i + 1 over the axis's group (the reference's ``ppermute``), with the
classic bubble fraction (S - 1) / (M + S - 1).

At tick t stage i works on microbatch t - i: stage 0 reads it from
``x_mb``, the others take what stage i - 1 sent at tick t - 1.  A stage
with no microbatch at a tick (the bubble) computes nothing and sends
nothing, where the reference's stages compute on zeros or on a repeated
last microbatch and drop the result; the outputs are the same.  Each
tick's sends and receives are posted together
(``torch.distributed.batch_isend_irecv``), so no order of stages can
deadlock.  gloo's point-to-point ops take host tensors only, so on gloo
a CUDA tensor is staged through pinned host buffers: copied out before
its send, copied in after its receive.  The last stage's outputs are
summed over the axis, zeros elsewhere, as the reference's ``psum``, so
every rank returns them.

``pipeline(stage_fn, stage_params, x, mesh)`` is schedule-only: it makes
no assumption about what a stage computes.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .. import tree
from ..models import sharding as Sh


def _staged(x, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _hop(out, recv_like, idx, group, send, recv):
    """Post this tick's send of ``out`` to stage idx + 1 (where ``send``)
    and receive from stage idx - 1 (where ``recv``), wait for both; ->
    the received tensor (None where nothing was received)."""
    ops, got = [], None
    stage = _staged(recv_like, group)
    if send:
        buf = out.detach().to("cpu").pin_memory() if stage else \
            out.detach().contiguous()
        ops.append(dist.P2POp(dist.isend, buf,
                              dist.get_global_rank(group, idx + 1), group))
    if recv:
        got = torch.empty(recv_like.shape, dtype=recv_like.dtype,
                          pin_memory=True) if stage else \
            torch.empty_like(recv_like)
        ops.append(dist.P2POp(dist.irecv, got,
                              dist.get_global_rank(group, idx - 1), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if got is not None and stage:
        got = got.to(recv_like.device)
    return got


def pipeline(stage_fn, stage_params, x_mb, mesh, *, axis: str = "pipe"):
    """Run microbatches through pipeline stages.

    stage_fn: (params_one_stage, x_mb) -> y_mb (same shape and dtype)
    stage_params: tree stacked on a leading (S,) stage axis (every rank
        passes the whole stack and runs its own stage's slice)
    x_mb: (M, mb, ...) microbatches, the same on every rank
    mesh: a mesh (``launch.mesh.make_mesh``) containing ``axis`` with S
        ranks

    Returns (M, mb, ...) outputs (stage S-1's results, on every rank).
    """
    s = mesh.shape[axis]
    m = x_mb.shape[0]
    idx = mesh.coordinate()[axis]
    group = mesh.group(axis)
    params_one = tree.map(lambda a: a[idx], stage_params)
    outs = torch.zeros_like(x_mb)
    carry = None
    for t in range(m + s - 1):
        live = 0 <= t - idx < m
        out = None
        if live:
            inp = x_mb[t - idx] if idx == 0 else carry
            out = stage_fn(params_one, inp)
            if idx == s - 1:
                outs[t - idx] = out
        # stage idx - 1 sent at this tick if it was live
        carry = _hop(out, x_mb[0], idx, group,
                     send=live and idx < s - 1,
                     recv=idx > 0 and 0 <= t - (idx - 1) < m)
    # only the last stage produced real outputs; every rank gets them
    return Sh.all_reduce(outs, mesh, (axis,))


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)
