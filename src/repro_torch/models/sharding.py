"""Parameter/activation sharding rules (TP / EP / FSDP / SP), and the
collectives that carry them out in an explicit-SPMD step.

The JAX package's ``models/sharding.py`` in torch.  Megatron-style
pairing: column-parallel projections shard their output dim on 'model';
the following row-parallel projection shards its input dim on 'model',
so each block pays one reduce.  MoE expert stacks ride 'model' with
their leading E axis (expert parallelism).  When ``cfg.fsdp`` the other
matrix dim additionally shards over 'data' (a per-layer all-gather).
The port's params hold one dictionary a layer (no stacked scan axis), so
a spec here is the reference's spec of the same leaf without its
leading unsharded entry.

Specs are :class:`P`, a tuple with ``PartitionSpec``'s entries (an axis
name, a tuple of names, or None per dim), and the spec functions are
shape-only: they take a :class:`Mesh` with no process group and run on
``meta`` tensors.

Under a mesh every rank holds plain local tensors, cut from the full
ones by :func:`shard_params` (unevenly where a dim does not divide, as
GSPMD cuts: ceil-sized chunks, the last ones short or empty).  The model
calls the collectives where the reference's ``shard_map`` or GSPMD puts
them (``layers``, ``attention``, ``moe``, ``model``), through autograd
Functions in conjugate pairs: :func:`enter_model` is the identity
forward and an all-reduce over 'model' backward (every replicated input
of a local computation passes through it), :func:`leave_model` an
all-reduce forward and the identity backward.  No DTensor and no
``torch.compile`` is on this path; the hand kernels see local shards.

Sequence parallelism (a ``use_sp`` config on a 'model' axis above 1),
Megatron's explicit form of the reference's ``P(batch, "model", None)``
stream constraint: :func:`constrain` cuts the residual stream to this
rank's chunk of the sequence (backward, the chunks' gradients
all-gathered), and the stream stays cut until :func:`gather_stream`
gathers it before the head.  In between the norms run on the chunk,
:func:`enter_model` all-gathers the chunks over 'model' (backward, the
partial gradients summed and cut: a reduce-scatter) and
:func:`leave_model` sums the partials and keeps this rank's chunk (a
reduce-scatter, done as an all-reduce and a cut; backward, an
all-gather).

A replicated leaf whose use on a rank covers only its share of the work
has its partial gradient summed over 'model' once, here, by one rule
read from the stream's state: a block entered while the stream is cut
passes every leaf 'model' does not cut through :func:`layer_params`
(each rank's gradient is its chunk's), and while the stream is whole a
leaf used on the rank's heads passes through :func:`model_leaf`.

Every block kind splits over 'model' (the rank's heads,
:func:`model_range`, and the kv heads or SSM groups they read,
:func:`groups_read`): a replicated leaf used on the rank's heads passes
through :func:`model_leaf` (above), a statistic over all the heads
through :func:`sum_over_model`, and a leaf whose stored contiguous cut
does not line up with the rank's heads (the mamba block's ``w_in`` and
conv, a kv head split over ranks, an attention leaf of heads that
'model' does not divide: :func:`heads_of`) is gathered over 'model' in
the step (:func:`gather_model` with ``reduce_grad``) while its stored
layout stays the reference's.  Attention heads split unevenly as GSPMD
cuts them, ceil-sized chunks with the last ranks short or empty (ROADMAP
A.9.10); a rank with no heads launches no attention kernel and takes
part in every collective of the block.  Heads that straddle their
groups unevenly (:func:`straddles`) get one group a head.
:func:`check_mesh` refuses the splits the reference refuses (ROADMAP
A.9.11, closed).
"""
from __future__ import annotations

import contextlib
import functools
import math
import threading
from typing import Dict, Optional

import torch
import torch.distributed as dist

from .. import tree

_TLS = threading.local()


class P(tuple):
    """A partition spec: one entry a dim, each an axis name, a tuple of
    axis names (the dim cut over their product, the first the major) or
    None; trailing dims unsharded.  A one-name tuple is that name, as
    ``PartitionSpec`` has it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self):
        return "P" + tuple.__repr__(self)


class Mesh:
    """Named axes and their sizes, row-major over the ranks (rank r sits
    at ``np.unravel_index(r, shape)``, as ``jax.make_mesh`` places its
    devices).  With ``device_mesh`` (a ``DeviceMesh`` over the live
    process group, ``launch/mesh.py``) it also knows this rank's
    coordinate and a process group per axis; without one it is
    shape-only, which is all the spec functions need."""

    def __init__(self, shape, axis_names, device_mesh=None):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} against axes "
                             f"{tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.devices_shape = tuple(int(n) for n in shape)
        self.shape = dict(zip(self.axis_names, self.devices_shape))
        self.device_mesh = device_mesh
        self._coord = None

    def __repr__(self):
        return f"Mesh({self.shape})"

    def coordinate(self) -> Dict[str, int]:
        """This rank's index along each axis."""
        if self.device_mesh is None:
            raise RuntimeError("a shape-only mesh has no ranks; build it "
                               "with launch.mesh.make_mesh")
        if self._coord is None:
            self._coord = dict(zip(self.axis_names,
                                   self.device_mesh.get_coordinate()))
        return self._coord

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)


# ---------------------------------------------------------------------------
# the mesh in force while a step traces its forward
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def active_mesh(mesh, full_shapes=None):
    """Set the mesh the model's collectives and :func:`constrain` use,
    for this thread.  ``full_shapes`` maps ``id`` of each local param
    shard to its full shape (what :func:`layer_params` reads)."""
    with resumed((mesh, full_shapes or {}, None)):
        yield


@contextlib.contextmanager
def resumed(state):
    """Re-enter a :func:`current_state` (on autograd's thread, for the
    recompute of a remat'd block)."""
    prev = current_state()
    _TLS.state = state
    try:
        yield
    finally:
        _TLS.state = prev


def current_state():
    """(mesh, full shapes, stream length) in force on this thread;
    (None, {}, None) without.  The stream length is the sequence length
    of a residual stream cut over 'model' (sequence parallelism), None
    while the stream is whole."""
    return getattr(_TLS, "state", (None, {}, None))


def current_mesh() -> Optional[Mesh]:
    return current_state()[0]


def axes_of(entry) -> tuple:
    """The mesh axes a spec entry names (none for None)."""
    return () if entry is None else \
        (entry if isinstance(entry, tuple) else (entry,))


def axes_size(mesh, entry) -> int:
    """The product of the sizes of ``entry``'s axes."""
    return math.prod(mesh.shape[a] for a in axes_of(entry))


def fit_spec(spec, shape, mesh) -> P:
    """Drop axes whose size exceeds the dim (e.g. 8 kv heads on a 16-way
    'model' axis) — the sharding analogue of the paper's validity rule."""
    out = []
    for i, entry in enumerate(spec):
        if entry is not None and (i >= len(shape) or
                                  shape[i] < axes_size(mesh, entry)):
            out.append(None)
        else:
            out.append(entry)
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def constrain(x, *spec):
    """The reference's ``with_sharding_constraint`` of the residual
    stream against the active mesh (a no-op without one).  ``"batch"``
    entries expand to the mesh's non-model axes; axes that do not fit
    the dim are dropped.  The batch axes are already local (each rank
    holds its rows), so a spec that cuts nothing else is the identity.
    One that cuts the sequence (dim 1) over 'model' (sequence
    parallelism) cuts the stream to this rank's chunk, and the stream
    stays cut (the identity here) until :func:`gather_stream`; any other
    cut is refused (the reference's ``activation_spec`` makes none)."""
    mesh, shapes, seq = current_state()
    if mesh is None or seq is not None:
        return x
    ba = batch_axes(mesh)
    fitted = fit_spec(P(*(ba if s == "batch" else s for s in spec)),
                      x.shape, mesh)
    cuts = [(d, e) for d, e in enumerate(fitted)
            if d > 0 and e is not None and axes_size(mesh, e) > 1]
    if not cuts:
        return x
    if cuts != [(1, "model")]:
        raise NotImplementedError(
            f"a {fitted} activation constraint cuts {cuts}: only the "
            "sequence over 'model' is ported")
    _TLS.state = (mesh, shapes, x.shape[1])
    return _Slice.apply(x, 1, mesh, "model")


def gather_stream(x):
    """The whole residual stream from this rank's chunk of a
    sequence-parallel one (all-gathered over 'model'; backward, this
    rank's chunk of the gradient, whole on every rank past the head's
    :func:`enter_model`), and the stream whole from here on.  The
    identity where the stream is whole."""
    mesh, shapes, seq = current_state()
    if seq is None:
        return x
    _TLS.state = (mesh, shapes, None)
    return _Gather.apply(x, 1, mesh, "model", seq, False)


# ---------------------------------------------------------------------------
# the rules: parameter leaf name -> spec
# ---------------------------------------------------------------------------

def _rules(fsdp_axis):
    f = fsdp_axis
    col = (2, lambda: P(f, "model"))      # (d_in, d_out-model)
    row = (2, lambda: P("model", f))      # (d_in-model, d_out)
    return {
        # embeddings / head
        "emb": (2, lambda: P("model", f)),       # vocab-parallel
        "head": (2, lambda: P(f, "model")),
        # attention
        "wq": col, "wk": col, "wv": col, "wo": row,
        "w_uq": col, "w_uk": col, "w_uv": col,
        "w_dq": (2, lambda: P(f, None)), "w_dkv": (2, lambda: P(f, None)),
        # mlp
        "wg": col, "wu": col, "wd": row,
        # moe experts: leading E axis = expert parallelism
        "router": (2, lambda: P(None, None)),
        # mamba
        "w_in": col, "w_out": row,
        "conv_w": (2, lambda: P(None, "model")),
        "conv_b": (1, lambda: P("model")),
        "A_log": (1, lambda: P(None)), "D": (1, lambda: P(None)),
        "dt_bias": (1, lambda: P(None)),
        # norms
        "w": (1, lambda: P(None)), "b": (1, lambda: P(None)),
    }


_MOE_RULES = {
    # (E, d, f) / (E, f, d) expert stacks — expert axis = EP over 'model'
    "we_g": lambda f: P("model", f, None),
    "we_u": lambda f: P("model", f, None),
    "we_d": lambda f: P("model", None, f),
}


def _leaf_spec(path, leaf, cfg, fsdp_axis) -> P:
    """The rule's spec of the leaf at ``path`` (a key path of
    ``tree.paths``; its last dict key names the leaf), unfitted."""
    names = [k for k in path if isinstance(k, str)]
    name = names[-1] if names else ""
    if name in _MOE_RULES:
        base, rank = _MOE_RULES[name](fsdp_axis), 3
    else:
        rules = _rules(fsdp_axis)
        if name not in rules:
            return P()
        rank, make = rules[name]
        base = make()
    extra = leaf.ndim - rank
    if extra < 0:
        return P()
    return P(*([None] * extra + list(base)))


def _specs(params, cfg, fsdp_axis, mesh):
    def spec(path, leaf):
        s = _leaf_spec(path, leaf, cfg, fsdp_axis)
        return fit_spec(s, leaf.shape, mesh) if mesh is not None else s
    return tree.unflatten(params, [spec(p, x) for p, x in
                                   tree.paths(params)])


def param_pspecs(params, cfg, mesh=None):
    """Tree of :class:`P` matching ``params`` (meta tensors will do)."""
    return _specs(params, cfg, "data" if cfg.fsdp else None, mesh)


def opt_pspecs(params, cfg, mesh=None):
    """Optimizer-state specs: ZeRO-1 — always FSDP-shard moments."""
    return _specs(params, cfg, "data", mesh)


def batch_axes(mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a != "model")


def batch_spec(mesh) -> P:
    return P(batch_axes(mesh))


def token_spec(mesh) -> P:
    return P(batch_axes(mesh), None)


def activation_spec(mesh, cfg) -> P:
    """Residual-stream constraint; SP shards sequence over 'model'."""
    if cfg.use_sp:
        return P(batch_axes(mesh), "model", None)
    return P(batch_axes(mesh), None, None)


def cache_pspecs(cache, mesh):
    """KV/state caches: batch over data axes, heads over 'model'.

    When the kv-head count is smaller than the 'model' axis the head dim
    is sharded instead (GSPMD psums the contraction) — the validity-rule
    fallback again.  The port's caches hold one entry a layer, so no
    leaf carries the reference's stacked leading axis.
    """
    ba = batch_axes(mesh)
    msize = axes_size(mesh, "model")

    def spec(leaf):
        shape = leaf.shape
        if len(shape) == 4:   # (B, S, Hkv, hd) kv | (B, H, p, n) ssm state
            s = P(ba, None, "model", None) if shape[2] >= msize else \
                P(ba, None, None, "model")
        elif len(shape) == 3:  # (B, S, C) mla / conv history caches
            s = P(ba, None, None)
        else:
            s = P(ba)
        return fit_spec(s, shape, mesh)

    return tree.map(spec, cache)


def local_rows(x, mesh):
    """This rank's rows of ``x`` (a global batch, rows first), cut over
    the batch axes as ``batch_spec`` cuts them, whole where they do not
    fit the rows (``fit_spec``: a batch of one on every rank)."""
    return local_shard(x, fit_spec(batch_spec(mesh), x.shape, mesh), mesh)


def cache_shard_shape(path, shape, cfg, mesh) -> tuple:
    """The shape of this rank's part of the cache leaf at ``path`` (a key
    path of ``tree.paths``) of full ``shape``, as the model's serving
    steps on the rank read and write it: its rows (:func:`local_rows`)
    and, under a 'model' split, what its computation writes.

      * k, v (and the cross-attention's xk, xv) ``(B, S, Hkv, hd)``: the
        kv heads this rank's q heads (:func:`model_range`) read
        (``attention.kv_proj``): its ``Hkv / model`` where 'model' divides
        them, as ``cache_pspecs`` cuts them; else the groups its heads
        read, whole, where ``cache_pspecs`` cuts the head dim (ROADMAP
        C.33), one a q head where the heads straddle groups unevenly
        (:func:`straddles`), and none on a rank that holds no heads;
      * the SSM state ``(B, H, p, n)``: its ``H / model`` heads, where
        ``cache_pspecs`` cuts ``p`` (the same bytes; C.35);
      * the conv history ``(B, K-1, C)``: the channels of its heads and
        their groups, where ``cache_pspecs`` keeps all of them (C.34);
      * MLA's ``c_kv`` and ``k_rope``: whole, as ``cache_pspecs`` has
        them (the latent is computed before the model region).
    """
    names = [k for k in path if isinstance(k, str)]
    name = names[-1] if names else ""
    out = list(shape)
    rows = fit_spec(batch_spec(mesh), shape, mesh)
    lo, hi = chunk_range(shape[0],
                         *chunk_index(mesh, rows[0] if rows else None))
    out[0] = hi - lo
    m = mesh.shape.get("model", 1)
    if m == 1:
        return tuple(out)
    r = mesh.coordinate()["model"]
    if name in ("k", "v", "xk", "xv"):
        lo, hi = chunk_range(cfg.n_heads, r, m)
        glo, ghi = groups_read(lo, hi, cfg.n_heads, shape[2])
        out[2] = hi - lo if straddles(cfg.n_heads, shape[2], m) else \
            ghi - glo
    elif name == "state":
        out[1] = shape[1] // m
    elif name == "conv":
        sh, g, n, p = (cfg.ssm_heads, cfg.ssm_groups, cfg.ssm_state,
                       cfg.ssm_headdim)
        glo, ghi = groups_read(r * (sh // m), (r + 1) * (sh // m), sh, g)
        out[2] = (sh // m) * p + 2 * (ghi - glo) * n
    return tuple(out)


def ns(mesh, tree_of_specs):
    """Spec tree -> tree of DTensor placements, one a mesh axis
    (``Shard(d)`` where the axis cuts dim d, else ``Replicate()``), for
    code that hands the same layout to ``torch.distributed.tensor``; the
    train step itself holds plain local tensors."""
    from torch.distributed.tensor import Replicate, Shard

    def place(spec):
        out = [Replicate() for _ in mesh.axis_names]
        for d, entry in enumerate(spec):
            for a in axes_of(entry):
                out[mesh.axis_names.index(a)] = Shard(d)
        return tuple(out)

    return tree.map(place, tree_of_specs)


# ---------------------------------------------------------------------------
# local shards
# ---------------------------------------------------------------------------

def chunk_index(mesh, entry):
    """(this rank's chunk index along ``entry``'s axes, their product)."""
    coord, idx, n = mesh.coordinate(), 0, 1
    for a in axes_of(entry):
        idx, n = idx * mesh.shape[a] + coord[a], n * mesh.shape[a]
    return idx, n


def chunk_range(length, idx, n):
    """[lo, hi) of chunk ``idx`` of ``n`` along a dim of ``length``:
    ceil-sized chunks, the last ones short or empty."""
    size = -(-length // n)
    lo = min(idx * size, length)
    return lo, min(lo + size, length)


def local_shard(x, spec, mesh):
    """This rank's piece of the full tensor ``x`` under ``spec``."""
    for d, entry in enumerate(spec):
        if entry is not None:
            lo, hi = chunk_range(x.shape[d], *chunk_index(mesh, entry))
            x = x.narrow(d, lo, hi - lo)
    return x


def shard_params(params, mesh, cfg):
    """Each leaf's local shard under ``param_pspecs``, a plain tensor (a
    contiguous copy, requiring grad where the leaf did)."""
    specs = tree.leaves(param_pspecs(params, cfg, mesh))
    out = [local_shard(x.detach(), s, mesh).contiguous().clone()
           .requires_grad_(x.requires_grad)
           for x, s in zip(tree.leaves(params), specs)]
    return tree.unflatten(params, out)


def _pad_to(x, dim, size):
    if x.shape[dim] == size:
        return x.contiguous()
    pad = list(x.shape)
    pad[dim] = size - x.shape[dim]
    return torch.cat([x, x.new_zeros(pad)], dim)


def gather_dim(x, dim, mesh, entry, length):
    """The full dim ``dim`` (``length`` long) from each rank's chunk of
    it along ``entry``'s axes: every chunk padded to the ceil size, one
    all-gather an axis from the minor up, then cut to ``length``."""
    axes = axes_of(entry)
    x = _pad_to(x, dim, -(-length // axes_size(mesh, entry)))
    for a in reversed(axes):
        if mesh.shape[a] > 1:
            parts = [torch.empty_like(x) for _ in range(mesh.shape[a])]
            dist.all_gather(parts, x, group=mesh.group(a))
            x = torch.cat(parts, dim)
    return x.narrow(dim, 0, length)


def gather(x, spec, mesh, shape):
    """The full tensor of ``shape`` from this rank's shard ``x`` under
    ``spec`` (every rank of the mesh calls it)."""
    for d, entry in enumerate(spec):
        if entry is not None:
            x = gather_dim(x, d, mesh, entry, shape[d])
    return x


def gather_params(local, mesh, cfg, like):
    """The inverse of :func:`shard_params`: the full tree from each
    rank's shards, the full shapes read from ``like`` (the params or
    meta stand-ins of them)."""
    specs = tree.leaves(param_pspecs(like, cfg, mesh))
    out = [gather(x.detach(), s, mesh, full.shape)
           for x, s, full in zip(tree.leaves(local), specs,
                                 tree.leaves(like))]
    return tree.unflatten(like, out)


# ---------------------------------------------------------------------------
# collectives with autograd: the conjugate pairs
# ---------------------------------------------------------------------------

def all_reduce(x, mesh, axes):
    """Sum ``x`` in place over each of ``axes`` of size > 1."""
    for a in axes:
        if mesh.shape.get(a, 1) > 1:
            dist.all_reduce(x, group=mesh.group(a))
    return x


class _Copy(torch.autograd.Function):
    """Into the model region: identity forward, all-reduce over 'model'
    backward (each rank's local computation gave part of the gradient)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.mesh, ("model",)), \
            None


class _Reduce(torch.autograd.Function):
    """Out of the model region: all-reduce over 'model' forward, identity
    backward (the gradient of a replicated output is whole on each
    rank)."""

    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x.contiguous().clone(), mesh, ("model",))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumAcross(torch.autograd.Function):
    """A sum over ranks that each feed their own loss: all-reduce forward
    and backward (each rank's loss reads every rank's input)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return all_reduce(x.contiguous().clone(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.mesh, ctx.axes), \
            None, None


class _Gather(torch.autograd.Function):
    """All-gather of dim ``dim`` over ``entry``'s axes.  Backward, this
    rank's chunk of the gradient: summed over those axes first (in
    float32) where ``reduce_grad`` (an FSDP weight, used by every data
    rank on its own rows), taken as it is where every rank holds the
    same gradient (logits gathered over 'model' under a replicated
    loss)."""

    @staticmethod
    def forward(ctx, x, dim, mesh, entry, length, reduce_grad):
        ctx.args = (dim, mesh, entry, x.shape[dim], reduce_grad)
        return gather_dim(x, dim, mesh, entry, length)

    @staticmethod
    def backward(ctx, g):
        dim, mesh, entry, size, reduce_grad = ctx.args
        if reduce_grad:
            g = all_reduce(g.to(torch.float32, copy=True), mesh,
                           axes_of(entry)).to(g.dtype)
        lo, _ = chunk_range(g.shape[dim], *chunk_index(mesh, entry))
        return g.narrow(dim, lo, size), None, None, None, None, None


class _Slice(torch.autograd.Function):
    """This rank's chunk of dim ``dim`` over ``entry``'s axes of a tensor
    whole on every rank of them.  Backward, the chunks' gradients
    all-gathered: each rank's loss reads its own chunk, and the whole
    tensor's gradient is every chunk's."""

    @staticmethod
    def forward(ctx, x, dim, mesh, entry):
        ctx.args = (dim, mesh, entry, x.shape[dim])
        lo, hi = chunk_range(x.shape[dim], *chunk_index(mesh, entry))
        return x.narrow(dim, lo, hi - lo).clone(
            memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        dim, mesh, entry, length = ctx.args
        return gather_dim(g.contiguous(), dim, mesh, entry, length), \
            None, None, None


def model_split():
    """(this rank's index along 'model', the axis size) under the active
    mesh; (0, 1) without one."""
    mesh = current_mesh()
    if mesh is None or mesh.shape.get("model", 1) == 1:
        return 0, 1
    return mesh.coordinate()["model"], mesh.shape["model"]


def batch_split(mesh) -> int:
    """Ranks the batch rows are spread over (the product of the batch
    axes); 1 without a mesh."""
    return 1 if mesh is None else axes_size(mesh, batch_axes(mesh))


def enter_model(x, whole=False):
    """``x`` (replicated over 'model') into a model-parallel region; from
    a sequence-parallel stream, its chunks all-gathered over 'model'
    (unless ``whole``: ``x`` is whole on every rank there too, as
    whisper's encoder output is)."""
    mesh, _, seq = current_state()
    if x is None or model_split()[1] == 1:
        return x
    if seq is not None and not whole:
        return _Gather.apply(x, 1, mesh, "model", seq, True)
    return _Copy.apply(x, mesh)


def model_leaf(w):
    """A replicated leaf ``w`` used on this rank's share of a
    model-parallel region (its heads, its channels): the identity
    forward, and backward the partial gradient summed over 'model', so
    that every rank holds the whole one.  Where the stream is cut its
    block's :func:`layer_params` sums it instead (the rank's share is
    then also its chunk's), and here it is the identity both ways."""
    mesh, _, seq = current_state()
    if model_split()[1] == 1 or seq is not None:
        return w
    return _Copy.apply(w, mesh)


def model_range(n):
    """[lo, hi) of this rank's share of ``n`` heads along 'model', cut as
    :func:`chunk_range` cuts an uneven dim (GSPMD's cut: ceil-sized
    chunks, the last ranks short or empty, rank 0 the largest); all ``n``
    without a split."""
    r, m = model_split()
    return chunk_range(n, r, m)


def groups_read(lo, hi, n, n_of):
    """[lo, hi) of the ``n_of`` groups (kv heads, SSM groups) that heads
    [lo, hi) of ``n`` read: head j reads group j // (n / n_of); none for
    no heads."""
    per = n // n_of
    if hi <= lo:
        return (min(lo // per, n_of),) * 2
    return lo // per, (hi - 1) // per + 1


@functools.cache
def heads_aligned(n, width, m):
    """Whether every one of ``m`` 'model' ranks' stored chunk of a
    head-major dim of ``n`` heads of ``width`` is its heads' span
    (:func:`model_range`), as it is where 'model' divides the heads."""
    return all(chunk_range(n * width, r, m) ==
               tuple(x * width for x in chunk_range(n, r, m))
               for r in range(m))


@functools.cache
def straddles(n, n_of, m):
    """Whether some one of ``m`` 'model' ranks' share of ``n`` heads
    reads its ``n_of`` groups (:func:`groups_read`) out of the kernels'
    order, in which head i of h reads group i // (h / g) (the attention
    kernels' kv heads, ssd's SSM groups): its heads straddle groups
    unevenly (12 heads over 6 kv heads on 4 ranks: rank 0's heads 0, 1,
    2 read kv heads 0, 0, 1; 6 SSM heads in 3 groups on 2 ranks: rank
    0's read groups 0, 0, 1).  Every rank then gives each head its own
    copy of its group."""
    per = n // n_of
    for r in range(m):
        lo, hi = chunk_range(n, r, m)
        glo, ghi = groups_read(lo, hi, n, n_of)
        h, g = hi - lo, ghi - glo
        if g and (h % g or any((j - lo) // (h // g) != j // per - glo
                               for j in range(lo, hi))):
            return True
    return False


def heads_of(w, dim, n, width):
    """This rank's heads' span of dim ``dim`` of ``w``, the rank's stored
    chunk of a head-major dim of ``n`` heads of ``width`` (``wq``'s
    columns, ``wo``'s rows): the chunk as it is where the cut lines up
    with every rank's heads (:func:`heads_aligned`), else the leaf
    gathered over 'model' (backward, the gradient summed and this rank's
    chunk kept) and the heads' span of it."""
    _, m = model_split()
    if m == 1 or heads_aligned(n, width, m):
        return w
    lo, hi = model_range(n)
    full = gather_model(w, dim, n * width, True)
    return full.narrow(dim % w.ndim, lo * width, (hi - lo) * width)


def sum_over_model(x):
    """The sum over 'model' of each rank's partial ``x`` (its heads'
    share of a statistic every rank's loss reads), differentiable both
    ways: the all-reduce forward and backward."""
    if model_split()[1] == 1:
        return x
    return _SumAcross.apply(x, current_mesh(), ("model",))


def stream_mean(x):
    """The mean of ``x`` over its rows (tokens of the residual stream):
    under sequence parallelism over every 'model' rank's chunk, the sums
    and the row counts all-reduced forward and passed through backward
    (each rank's loss is the whole one, and each rank's rows are its
    own)."""
    mesh, _, seq = current_state()
    if seq is None:
        return x.mean(0)
    tot = _Reduce.apply(torch.cat([x.sum(0), x.new_full((1,), x.shape[0])]),
                        mesh)
    return tot[:-1] / tot[-1]


def stream_cut(x):
    """``x``, whole along the sequence (dim 1), cut as the residual
    stream is: this rank's chunk where it is sequence-parallel (backward,
    the chunks' gradients all-gathered), else ``x``."""
    mesh, _, seq = current_state()
    if seq is None:
        return x
    return _Slice.apply(x, 1, mesh, "model")


def stream_gather(x):
    """The whole sequence (dim 1) of ``x`` from every 'model' rank's chunk
    of a sequence-parallel stream, with no gradient (router indices);
    ``x`` where the stream is whole."""
    mesh, _, seq = current_state()
    if seq is None:
        return x
    return gather_dim(x.contiguous(), 1, mesh, "model", seq)


def leave_model(x):
    """The sum over 'model' of each rank's partial ``x``; into a
    sequence-parallel stream, this rank's chunk of the sum."""
    if model_split()[1] == 1:
        return x
    mesh, _, seq = current_state()
    x = _Reduce.apply(x, mesh)
    return x if seq is None else _Slice.apply(x, 1, mesh, "model")


def gather_model(x, dim, length, reduce_grad=False):
    """The full dim ``dim`` of ``x`` from each 'model' rank's chunk.
    Backward, this rank's chunk of the gradient, summed over 'model'
    first where ``reduce_grad`` (each rank used the whole tensor its own
    way: a weight, or kv columns its q heads read), else as it is (every
    rank holds the same gradient: logits under a replicated loss)."""
    if model_split()[1] == 1:
        return x
    return _Gather.apply(x, dim % x.ndim, current_mesh(), "model", length,
                         reduce_grad)


def sum_over_batch(x):
    """The sum of ``x`` over the batch axes' ranks, differentiable."""
    mesh = current_mesh()
    if batch_split(mesh) == 1:
        return x
    return _SumAcross.apply(x, mesh, batch_axes(mesh))


def layer_params(ps, cfg):
    """``ps`` (one layer's leaves, or the embedding's or a norm's) as the
    rank's computation uses them, once a call.  FSDP: each leaf
    all-gathered over 'data' to its TP-only shard (backward, the
    gradient summed over 'data' and this rank's chunk kept).  Where the
    stream is cut over 'model' (sequence parallelism), each leaf 'model'
    does not cut through :func:`_Copy` (backward, this rank's chunk's
    gradient summed over 'model').  A no-op without a mesh, or without
    both.  The leaves' full shapes are the ones :func:`active_mesh` was
    given."""
    mesh, shapes, seq = current_state()
    if mesh is None or not (cfg.fsdp or seq is not None):
        return ps
    out = []
    for path, x in tree.paths(ps):
        shape = shapes.get(id(x))
        if shape is None:
            raise RuntimeError(f"{'/'.join(map(str, path))}: a leaf "
                               "whose full shape the active mesh was not "
                               "given")
        tp = fit_spec(_leaf_spec(path, x, cfg, None), shape, mesh)
        if cfg.fsdp:
            fsdp = fit_spec(_leaf_spec(path, x, cfg, "data"), shape, mesh)
            for d, entry in enumerate(fsdp):
                if entry != (tp[d] if d < len(tp) else None):
                    x = _Gather.apply(x, d, mesh, entry, shape[d], True)
        if seq is not None and "model" not in {a for e in tp
                                               for a in axes_of(e)}:
            x = _Copy.apply(x, mesh)
        out.append(x)
    return tree.unflatten(ps, out)


def check_mesh(cfg, mesh):
    """Refuse a mesh the JAX package refuses too: a 'model' split (> 1
    rank) that does not divide an FFN's columns (``d_ff``, ``d_ff_dense``,
    the shared experts' width), ``n_experts`` or ``ssm_heads``.  The
    reference's ``jit`` needs each dim its ``in_shardings`` cut over
    'model' to divide by it: the FFN's ``wg``, ``wu`` and ``wd``, and
    the mamba block's ``w_in``, conv and ``w_out`` (which 'model'
    divides only where it divides the heads); its ``moe_apply`` passes
    the expert stacks to a ``shard_map`` that splits them over 'model'.
    Attention heads and kv heads of every kind split unevenly, as GSPMD
    cuts them (A.9.10), SSM heads that straddle SSM groups are served
    (each head its own copy of its group), and every mesh with one
    'model' rank is served.  ROADMAP A.9.11, closed: the port refuses
    what the reference refuses, and nothing else."""
    m = mesh.shape.get("model", 1)
    if m == 1:
        return
    kinds = set(cfg.layer_pattern()) | ({"enc"} if cfg.n_enc_layers
                                        else set())
    ffn = "its jit needs the FFN's wg / wu / wd cut to divide by 'model'"
    widths = {}
    if kinds & {"attn", "local", "enc", "dec", "mamba_shared"}:
        widths["d_ff"] = (cfg.d_ff, ffn)
    if "moe_dense" in kinds:
        widths["d_ff_dense"] = (cfg.d_ff_dense or cfg.d_ff, ffn)
    if "moe" in kinds:
        widths["n_experts"] = (cfg.n_experts, "its moe shard_map splits "
                               "the expert stacks over 'model'")
        widths["shared d_ff"] = (cfg.n_shared_experts * cfg.d_expert, ffn)
    if kinds & {"mamba", "mamba_shared"}:
        widths["ssm_heads"] = (cfg.ssm_heads, "its jit needs the mamba "
                               "block's w_in cut to divide by 'model'")
    odd = [f"{k} {v} ({why})" for k, (v, why) in widths.items() if v % m]
    if odd:
        raise NotImplementedError(
            f"{cfg.name}: a 'model' axis of {m} does not divide "
            f"{'; '.join(odd)}; the JAX package refuses the same mesh "
            "(ROADMAP A.9.11, closed)")
