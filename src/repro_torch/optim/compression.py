"""Gradient compression: int8 quantization with error feedback, in torch.

The JAX package's ``compress`` / ``decompress`` / ``err_init`` step for
step: each leaf (plus its carried error) is scaled by max|x| / 127,
rounded half to even (``torch.round``, as ``jnp.round``), clipped to
[-127, 127] and stored as int8; the rounding error is carried into the
next step.  The int8 payloads are bitwise the reference's.  The
reference stacks the repeats of a pattern unit's layer into one leaf,
and so scales them by one max; the port holds one leaf a layer, so the
train steps pass ``groups`` (``models.model.stack_groups``): the leaves
of one reference leaf share its scale.

Two collectives over the ranks of a mesh (``models/sharding.py``):

  * :func:`compress_sharded` — ``compress`` of a gradient held as each
    rank's pieces (the sharded step's ZeRO-1 slices): the max |x| of
    each leaf is all-reduced (MAX) over the axes that cut its piece, so
    every rank scales by the whole leaf's max, as the reference's
    ``compress`` does under GSPMD; q, scale and the new error are then
    bitwise the reference's on the rank's piece.
  * :func:`compressed_psum` — the reference's quantize -> int32 sum ->
    dequantize over one mesh axis: a shared scale (all-reduce MAX), the
    int32 values summed (all-reduce SUM), divided by the group's size.

Both run over any process group; on gloo a CUDA tensor's collective is
staged through the host by the backend itself.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .. import tree
from ..models import sharding as Sh


def _scale(m):
    """The int8 scale of a leaf whose max |x| is ``m``."""
    return torch.clamp(m, min=1e-12) / 127.0


def _quantize(xf, scale):
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, xf - q.to(torch.float32) * scale


def _amax(xf):
    """max |xf|; 0 for an empty tensor."""
    return torch.max(torch.abs(xf)) if xf.numel() else \
        torch.zeros((), dtype=torch.float32, device=xf.device)


def _compress(xfs, maxes, groups, template):
    """The payload of each leaf ``xfs[i]`` scaled by the max of
    ``maxes`` over its group (each leaf its own where ``groups`` is
    None)."""
    if groups is not None:
        top = {}
        for k, m in zip(groups, maxes):
            top[k] = torch.maximum(top[k], m) if k in top else m
        maxes = [top[k] for k in groups]
    qs, scales, errs = [], [], []
    for xf, m in zip(xfs, maxes):
        scale = _scale(m)
        q, err = _quantize(xf, scale)
        qs.append(q)
        scales.append(scale)
        errs.append(err)
    return ({"q": tree.unflatten(template, qs),
             "scale": tree.unflatten(template, scales)},
            tree.unflatten(template, errs))


def compress(grads, err_state=None, groups=None):
    """-> ({"q": int8 tree, "scale": fp32 scalar tree}, new error tree).
    ``groups``: a key a leaf, in leaf order; leaves with one key share
    one scale (their joint max); None, a scale a leaf."""
    leaves = tree.leaves(grads)
    errs = tree.leaves(err_state) if err_state is not None else \
        [None] * len(leaves)
    xfs = [g.to(torch.float32) + (e if e is not None else 0.0)
           for g, e in zip(leaves, errs)]
    return _compress(xfs, [_amax(xf) for xf in xfs], groups, grads)


def decompress(packed):
    return tree.map(lambda q, s: q.to(torch.float32) * s, packed["q"],
                    packed["scale"])


def err_init(grads_like):
    return tree.map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_like)


def _all_max(x, mesh, axes):
    for a in axes:
        if mesh.shape.get(a, 1) > 1:
            dist.all_reduce(x, op=dist.ReduceOp.MAX, group=mesh.group(a))
    return x


def compress_sharded(grads, err_state, mesh, axes, groups=None):
    """``compress`` of a gradient of which each rank holds a piece of
    every leaf: ``grads`` and ``err_state`` this rank's pieces (lists in
    leaf order), ``axes[i]`` the mesh axes that cut leaf i's piece,
    ``groups`` as ``compress``'s.  Each leaf's max |g + err| is taken
    over every piece (all-reduce MAX over ``axes[i]``; an empty piece
    gives 0); -> (packed, new errors) as ``compress``'s, of this rank's
    pieces.  Every rank of the mesh calls it."""
    xfs = [g.to(torch.float32) + e for g, e in zip(grads, err_state)]
    maxes = [_all_max(_amax(xf), mesh, ax) for xf, ax in zip(xfs, axes)]
    return _compress(xfs, maxes, groups, list(grads))


def compressed_psum(x, mesh, axis: str):
    """The mean of ``x`` over the ranks of ``mesh``'s ``axis``, moved as
    int8 values: a shared scale max |x| / 127 (all-reduce MAX), each
    rank's x / scale rounded and clipped to [-127, 127] in int32, summed
    (all-reduce SUM; int32 holds the sum up to 2^24 ranks), times the
    scale over the group's size, in the reference's order of operations
    (``(total * scale) / n``), so bitwise its ``compressed_psum``.
    Every rank of the axis calls it."""
    xf = x.to(torch.float32)
    scale = _all_max(_scale(torch.max(torch.abs(xf))), mesh, (axis,))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int32)
    Sh.all_reduce(q, mesh, (axis,))
    n = float(mesh.shape[axis])
    return q.to(torch.float32) * scale / n
