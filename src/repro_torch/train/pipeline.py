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

The loop is differentiable, as the reference's ``shard_map`` loop is:
each hop is an autograd Function (:class:`_Hop`) whose backward sends
the received tensor's gradient back to stage i - 1 and receives the
gradient of what it sent from stage i + 1, each message tagged by its
microbatch, so that sends and receives pair up in whatever order
autograd runs the hops.  The final sum passes its cotangent through as
it is on each rank (the reference's replicated output), and the
gradients of ``x_mb`` and of the stacked params come out whole on every
rank, summed over the axis once every hop's exchange is done.

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


def _exchange(group, send=None, to=None, like=None, frm=None, tags=(0, 0)):
    """Post the send of ``send`` to stage ``to`` (where given) and a
    receive shaped as ``like`` from stage ``frm`` (where given) together,
    tagged ``tags`` (send, receive), and wait for both; -> the received
    tensor, or None."""
    ops, got = [], None
    ref = send if send is not None else like
    stage = ref is not None and _staged(ref, group)
    if send is not None:
        buf = send.detach().to("cpu").pin_memory() if stage else \
            send.detach().contiguous()
        ops.append(dist.P2POp(dist.isend, buf,
                              dist.get_global_rank(group, to), group,
                              tag=tags[0]))
    if like is not None:
        got = torch.empty(like.shape, dtype=like.dtype,
                          pin_memory=True) if stage else \
            torch.empty_like(like)
        ops.append(dist.P2POp(dist.irecv, got,
                              dist.get_global_rank(group, frm), group,
                              tag=tags[1]))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if got is not None and stage:
        got = got.to(like.device)
    return got


class _Hop(torch.autograd.Function):
    """Stage ``idx``'s hop at the tick where it works on microbatch ``j``,
    each message tagged by the microbatch it carries: forward, ``out``
    (microbatch j) sent to stage idx + 1 where ``send``, and microbatch
    j + 1, shaped as ``like``, received from stage idx - 1 where
    ``recv``; backward, the received tensor's gradient sent back to
    idx - 1 and ``out``'s received from idx + 1.  -> (the received
    tensor, empty where nothing was received; a zero scalar).  The scalar
    joins the stage's output, so that every hop takes part in the
    backward exchange even where this stage never reads what it sent;
    ``anchor`` (a scalar that requires grad where the call is
    differentiated) puts every hop in the graph."""

    @staticmethod
    def forward(ctx, out, like, anchor, idx, group, j, send, recv):
        ctx.args = (idx, group, j, recv)
        ctx.like = like if send else None
        got = _exchange(group, out if send else None, idx + 1,
                        like if recv else None, idx - 1, (j, j + 1))
        if got is None:
            got = like.new_empty((0,))
        return got, anchor.new_zeros(())

    @staticmethod
    def backward(ctx, g_got, g_token):
        idx, group, j, recv = ctx.args
        g_out = _exchange(group, g_got if recv else None, idx - 1,
                          ctx.like, idx + 1, (j + 1, j))
        return g_out, None, None, None, None, None, None, None


class _Sum(torch.autograd.Function):
    """The last stage's outputs on every rank: the sum over ``axis``
    forward (zeros elsewhere), and backward the cotangent as it is on each
    rank, as the reference's replicated output has it."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return Sh.all_reduce(x.contiguous().clone(), mesh, (axis,))

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Enter(torch.autograd.Function):
    """The call's inputs as every stage's graph reads them: forward, a
    zero scalar (the hops' ``anchor``) and the inputs as they are;
    backward, each input's gradient summed over ``axis`` (``x_mb``'s is
    stage 0's, a stacked leaf's each stage's slice), so that every rank
    holds the whole of it.  Every hop reads the anchor, so these sums run
    after every hop's exchange, in one order on every rank."""

    @staticmethod
    def forward(ctx, mesh, axis, *xs):
        ctx.mesh, ctx.axis = mesh, axis
        return (xs[0].new_zeros(()),) + tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, g_anchor, *gs):
        return (None, None) + tuple(
            Sh.all_reduce(g.contiguous().clone(), ctx.mesh, (ctx.axis,))
            if need else None
            for g, need in zip(gs, ctx.needs_input_grad[2:]))


def pipeline(stage_fn, stage_params, x_mb, mesh, *, axis: str = "pipe"):
    """Run microbatches through pipeline stages.

    stage_fn: (params_one_stage, x_mb) -> y_mb (same shape and dtype)
    stage_params: tree stacked on a leading (S,) stage axis (every rank
        passes the whole stack and runs its own stage's slice)
    x_mb: (M, mb, ...) microbatches, the same on every rank
    mesh: a mesh (``launch.mesh.make_mesh``) containing ``axis`` with S
        ranks

    Returns (M, mb, ...) outputs (stage S-1's results, on every rank).
    Differentiable: the gradients of ``stage_params`` and ``x_mb`` are
    whole on every rank.
    """
    s = mesh.shape[axis]
    m = x_mb.shape[0]
    idx = mesh.coordinate()[axis]
    group = mesh.group(axis)
    leaves = tree.leaves(stage_params)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in leaves + [x_mb]):
        anchor, xs, *leaves = _Enter.apply(mesh, axis, x_mb, *leaves)
    else:
        anchor, xs = x_mb.new_zeros(()), x_mb
    params_one = tree.map(lambda a: a[idx],
                          tree.unflatten(stage_params, leaves))
    outs = [torch.zeros_like(x_mb[0])] * m
    carry, tokens = None, anchor.new_zeros(())
    for t in range(m + s - 1):
        j = t - idx                  # this stage's microbatch at tick t
        live = 0 <= j < m
        out = None
        if live:
            out = stage_fn(params_one, xs[j] if idx == 0 else carry)
            if idx == s - 1:
                outs[j] = out
        # stage idx - 1 sends microbatch j + 1 at this tick if it is live
        carry, token = _Hop.apply(out, x_mb[0], anchor, idx, group, j,
                                  live and idx < s - 1,
                                  idx > 0 and 0 <= j + 1 < m)
        tokens = tokens + token
    # only the last stage produced real outputs; every rank gets them
    return _Sum.apply(torch.stack(outs) + tokens, mesh, axis)


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)
