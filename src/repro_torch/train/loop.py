"""Training: the step on one device, the sharded step, and the
supervised training loop.

The JAX package's ``train/loop.py`` in torch.  ``make_train_step`` builds
(params, opt_state, err_state, batch) -> (params, opt_state, err_state,
metrics): the batch's rows are cut into ``accum`` contiguous
microbatches (``x.reshape(accum, B // accum, ...)[i]``), each one's
gradient is taken by ``torch.autograd.grad`` and summed in fp32, the
mean is optionally int8-compressed with error feedback, and
``adamw.update`` applies it in place.  Every param leaf must get a
gradient: one that autograd cannot reach raises, where a kernel without
an autograd Function would otherwise leave it silently out.  ``train``
wires the synthetic data, the checkpointer, the watchdog and the
supervisor around the step.

``make_sharded_train_step`` is the same step on every rank of a mesh
(``launch/mesh.py``), explicit SPMD over plain local tensors
(``models/sharding.py``): each rank holds its ``param_pspecs`` shard of
every leaf and its ZeRO-1 slice (``opt_pspecs``) of the optimizer state
(and of the compression error, with ``compress_grads``), takes its rows
of each microbatch (``token_spec``), runs the forward and backward under
``active_mesh`` (the model's collectives; an FSDP config's per-layer
gathers; a ``use_sp`` config's sequence-parallel stream), takes the mean
of the gradients over the batch axes, cuts it to its ZeRO-1 slice,
compresses that slice against the whole leaf's int8 scale where
``compress_grads`` says so (``compression.compress_sharded``), takes the
global norm over every slice (each replicated slice counted once), does
the AdamW update on its slice and all-gathers the new params back to its
shards.  The pipeline schedule over a 'pipe' axis is
``train/pipeline.py``.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, Optional

import torch

from .. import tree
from ..checkpoint import checkpointer as ckpt
from ..core.targets import resolve_device
from ..data.pipeline import SyntheticLM, extra_inputs
from ..kernels import ref
from ..models import model as M
from ..models import sharding as Sh
from ..optim import adamw, compression
from ..runtime.fault_tolerance import FailureInjector, Supervisor, Watchdog

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    accum: int = 1                    # gradient-accumulation microbatches
    # the MoE load-balance coefficient; as in the reference, loss_fn uses
    # 0.01 whatever this says (ROADMAP C.27)
    aux_coef: float = 0.01
    compress_grads: bool = False      # int8 error-feedback compression
    optim: adamw.AdamWConfig = dataclasses.field(
        default_factory=adamw.AdamWConfig)


def loss_fn(params, cfg, batch, sp_spec=None):
    """-> (mean xent + 0.01 aux, (mean xent, aux)), over the padded vocab."""
    logits, _, aux = M.forward(params, cfg, batch, mode="train",
                               sp_spec=sp_spec)
    xent = ref.softmax_xent(logits, batch["targets"]).mean()
    return xent + 0.01 * aux, (xent, aux)


def trainable(params):
    """``params`` with every leaf set to require grad (in place)."""
    for p in tree.leaves(params):
        p.requires_grad_(True)
    return params


def make_train_step(cfg, tcfg: TrainConfig):
    """(params, opt_state, err_state, batch) -> (params, opt_state,
    err_state, metrics); params and opt_state updated in place, metrics
    {"loss", "aux", "grad_norm", "lr"} as device scalars."""

    def step(params, opt_state, err_state, batch):
        accum = tcfg.accum
        leaves = tree.leaves(params)
        gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in leaves]
        lsum = asum = 0.0
        for i in range(accum):
            micro = {k: v.reshape(accum, v.shape[0] // accum,
                                  *v.shape[1:])[i]
                     for k, v in batch.items()}
            with torch.enable_grad():
                loss, (xent, aux) = loss_fn(params, cfg, micro)
                grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                for s, g in zip(gsum, grads):
                    s.add_(g.to(torch.float32))
                lsum = lsum + xent.detach()
                asum = asum + aux.detach()
            del loss, grads
        with torch.no_grad():
            for s in gsum:
                s.div_(accum)
        grads = tree.unflatten(params, gsum)
        del gsum
        if tcfg.compress_grads:
            packed, err_state = compression.compress(
                grads, err_state, M.stack_groups(params))
            grads = compression.decompress(packed)
        params, opt_state, om = adamw.update(grads, opt_state, params,
                                             tcfg.optim)
        metrics = {"loss": lsum / accum, "aux": asum / accum, **om}
        return params, opt_state, err_state, metrics

    return step


class _Layout:
    """What a sharded step knows of each param leaf, in leaf order: its
    full shape, its ``param_pspecs`` spec (the rank's shard), its
    ``opt_pspecs`` spec (the rank's ZeRO-1 slice of that shard) and its
    ``model.stack_groups`` key."""

    def __init__(self, cfg, mesh, params_sds):
        self.mesh = mesh
        self.shapes = [tuple(x.shape) for x in tree.leaves(params_sds)]
        self.pspecs = tree.leaves(Sh.param_pspecs(params_sds, cfg, mesh))
        self.ospecs = tree.leaves(Sh.opt_pspecs(params_sds, cfg, mesh))
        self.groups = M.stack_groups(params_sds)

    def zero1_dims(self, i):
        """(dim, entry) where leaf i's optimizer slice cuts its shard."""
        ps, os_ = self.pspecs[i], self.ospecs[i]
        out = []
        for d, entry in enumerate(os_):
            have = ps[d] if d < len(ps) else None
            if entry != have and Sh.axes_size(self.mesh, entry) > 1:
                if have is not None:
                    raise ValueError(f"leaf {i}: optimizer spec {os_} is not "
                                     f"a cut of its param spec {ps}")
                out.append((d, entry))
        return out

    def cut_axes(self, i):
        """The mesh axes (of size > 1) that cut leaf i's ZeRO-1 slice: its
        param spec's and its ZeRO-1 cut's; the slice is replicated over
        the others."""
        entries = list(self.pspecs[i]) + [e for _, e in self.zero1_dims(i)]
        return tuple(a for e in entries for a in Sh.axes_of(e)
                     if self.mesh.shape[a] > 1)

    def slices(self, leaves):
        """Views of each local shard in ``leaves`` cut to the rank's ZeRO-1
        slice."""
        out = []
        for i, x in enumerate(leaves):
            for d, entry in self.zero1_dims(i):
                lo, hi = Sh.chunk_range(x.shape[d],
                                        *Sh.chunk_index(self.mesh, entry))
                x = x.narrow(d, lo, hi - lo)
            out.append(x)
        return out


def _check_sharded(cfg, tcfg, mesh, batch_sds):
    Sh.check_mesh(cfg, mesh)
    rows = tcfg.accum * Sh.batch_split(mesh)
    for k, v in batch_sds.items():
        if v.shape[0] % rows:
            raise ValueError(f"batch[{k!r}]: {v.shape[0]} rows do not split "
                             f"into {tcfg.accum} microbatches over "
                             f"{Sh.batch_split(mesh)} data ranks")


def make_sharded_grads(cfg, tcfg: TrainConfig, mesh, params_sds, batch_sds):
    """(params, batch) -> (loss, aux, grads): the sharded step's mean
    gradient before its update, float32, one tensor a leaf of this
    rank's shards (in leaf order), the mean xent over the global batch
    and the aux loss.  ``batch`` is the global batch, on every rank."""
    _check_sharded(cfg, tcfg, mesh, batch_sds)
    lay = _Layout(cfg, mesh, params_sds)
    ba, n_b = Sh.batch_axes(mesh), Sh.batch_split(mesh)
    rows = Sh.token_spec(mesh)
    sp_spec = Sh.activation_spec(mesh, cfg) if cfg.use_sp else None

    def grads_fn(params, batch):
        accum = tcfg.accum
        leaves = tree.leaves(params)
        full = {id(x): shape for x, shape in zip(leaves, lay.shapes)}
        gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in leaves]
        lsum = asum = 0.0
        for i in range(accum):
            # microbatch i's global rows, then this rank's rows of them
            micro = {k: Sh.local_shard(
                v.reshape(accum, v.shape[0] // accum, *v.shape[1:])[i],
                rows, mesh) for k, v in batch.items()}
            with Sh.active_mesh(mesh, full), torch.enable_grad():
                loss, (xent, aux) = loss_fn(params, cfg, micro, sp_spec)
                grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                for s, g in zip(gsum, grads):
                    s.add_(g.to(torch.float32))
                lsum = lsum + xent.detach()
                asum = asum + aux.detach()
            del loss, grads
        with torch.no_grad():
            for s, spec in zip(gsum, lay.pspecs):
                # the leaves cut over a batch axis (FSDP) had their
                # gradient summed over it by the gather's backward
                cut = {a for e in spec for a in Sh.axes_of(e)}
                Sh.all_reduce(s, mesh, [a for a in ba if a not in cut])
                s.div_(accum * n_b)
            loss = Sh.all_reduce(torch.as_tensor(lsum, dtype=torch.float32,
                                                 device=gsum[0].device)
                                 .clone(), mesh, ba) / (accum * n_b)
        return loss, asum / accum, gsum

    grads_fn.layout = lay
    return grads_fn


def sharded_global_norm(slices, layout):
    """The global norm of a gradient held as each rank's ZeRO-1 slices
    (``layout.slices``): the squares summed over the local slices,
    all-reduced over the axes that cut them, each replicated slice
    counted once."""
    mesh, by_axes = layout.mesh, {}
    for i, g in enumerate(slices):
        axes = layout.cut_axes(i)
        sq = torch.sum(torch.square(g.to(torch.float32)))
        by_axes[axes] = by_axes[axes] + sq if axes in by_axes else sq
    total = sum(Sh.all_reduce(sq, mesh, axes)
                for axes, sq in by_axes.items())
    return torch.sqrt(total)


def _own_slices(params, cfg, mesh, params_sds):
    """This rank's ZeRO-1 slices of its shards ``params``, detached."""
    lay = _Layout(cfg, mesh, params_sds)
    return tree.unflatten(params, lay.slices(
        [p.detach() for p in tree.leaves(params)]))


def sharded_opt_init(params, cfg, mesh, params_sds):
    """``adamw.init`` of this rank's ZeRO-1 slices of its shards
    ``params``."""
    return adamw.init(_own_slices(params, cfg, mesh, params_sds))


def sharded_err_init(params, cfg, mesh, params_sds):
    """``compression.err_init`` of this rank's ZeRO-1 slices of its shards
    ``params``: the error state of ``compress_grads``, laid out as the
    optimizer state is."""
    return compression.err_init(_own_slices(params, cfg, mesh, params_sds))


@torch.no_grad()
def sharded_update(grads, opt_state, params, layout, optim, err_state=None):
    """``adamw.update`` of a sharded step: ``grads`` (``make_sharded_grads``'
    mean gradient, this rank's shards in leaf order) cut to this rank's
    ZeRO-1 slices, int8-compressed with error feedback against each whole
    leaf's scale where ``err_state`` (``sharded_err_init``'s) is given,
    clipped by their global norm over every slice, applied to the slices
    of ``opt_state`` and ``params`` in place, then the other ranks'
    slices all-gathered back into each param shard.  -> (params,
    opt_state, err_state, metrics)."""
    leaves = tree.leaves(params)
    views = layout.slices(leaves)
    gs = layout.slices(grads)
    if err_state is not None:
        packed, errs = compression.compress_sharded(
            gs, tree.leaves(err_state), layout.mesh,
            [layout.cut_axes(i) for i in range(len(gs))], layout.groups)
        gs = tree.leaves(compression.decompress(packed))
        err_state = tree.unflatten(err_state, errs)
    gnorm = sharded_global_norm(gs, layout)
    _, opt_state, om = adamw.update(
        tree.unflatten(params, gs), opt_state,
        tree.unflatten(params, views), optim, gnorm=gnorm)
    # each rank updated its slice in place; the others' slices come back
    # by an all-gather over the axes that cut them
    for i, (p, v) in enumerate(zip(leaves, views)):
        dims = layout.zero1_dims(i)
        if dims:
            for d, entry in dims:
                v = Sh.gather_dim(v, d, layout.mesh, entry, p.shape[d])
            p.copy_(v)
    return params, opt_state, err_state, om


def make_sharded_train_step(cfg, tcfg: TrainConfig, mesh, params_sds,
                            batch_sds):
    """(params, opt_state, err_state, batch) -> (params, opt_state,
    err_state, metrics) on each rank of ``mesh``: params this rank's
    shards (``sharding.shard_params``), opt_state its ZeRO-1 slices
    (``sharded_opt_init``), err_state its slices of the compression error
    (``sharded_err_init``) with ``compress_grads``, else None, all updated
    in place; batch the global batch.  ``params_sds`` gives the full
    shapes (meta tensors will do).  The step is ``make_sharded_grads``
    then ``sharded_update``.  Refuses, naming the ROADMAP item, what it
    cannot run (``sharding.check_mesh``)."""
    grads_fn = make_sharded_grads(cfg, tcfg, mesh, params_sds, batch_sds)

    def step(params, opt_state, err_state, batch):
        loss, aux, grads = grads_fn(params, batch)
        params, opt_state, err_state, om = sharded_update(
            grads, opt_state, params, grads_fn.layout, tcfg.optim,
            err_state if tcfg.compress_grads else None)
        metrics = {"loss": loss, "aux": aux, **om}
        return params, opt_state, err_state, metrics

    return step


def train(cfg, *, steps: int, batch_size: int = 8, seq_len: int = 128,
          tcfg: Optional[TrainConfig] = None, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 50, seed: int = 0,
          injector: Optional[FailureInjector] = None,
          log_every: int = 10, device=None) -> Dict[str, Any]:
    """Single-host training driver with checkpoint/restart + watchdog, on
    ``device`` (default: the card), the params drawn from a
    ``torch.Generator`` seeded with ``seed``."""
    tcfg = tcfg or TrainConfig()
    device = resolve_device("cuda" if device is None else device)
    data = SyntheticLM(cfg.vocab_size, seq_len, batch_size, seed=seed)
    extra = extra_inputs(cfg, batch_size, seed, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = trainable(M.init(cfg, gen, device))
    state = {"params": params, "opt": adamw.init(params),
             "err": compression.err_init(params) if tcfg.compress_grads
             else None}
    del params
    step_fn = make_train_step(cfg, tcfg)

    saver = ckpt.AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    watchdog = Watchdog()
    history = []

    def resume_step() -> int:
        if ckpt_dir:
            s = ckpt.latest_step(ckpt_dir)
            return 0 if s is None else s + 1
        return 0

    def body(start: int) -> int:
        if start > 0:
            loaded = ckpt.restore(ckpt_dir, start - 1,
                                  {"params": state["params"],
                                   "opt": state["opt"]})
            state["params"] = trainable(loaded["params"])
            state["opt"] = loaded["opt"]
            log.info("resumed from step %d", start - 1)
        for s in range(start, steps):
            if injector is not None:
                injector.maybe_fail(s)
            batch = {**data.batch(s, device=device), **extra}
            watchdog.start()
            state["params"], state["opt"], state["err"], m = step_fn(
                state["params"], state["opt"], state["err"], batch)
            # one read of the device a step, as jax.device_get(m)
            m = dict(zip(m, torch.stack(list(m.values())).tolist()))
            watchdog.stop(s)
            history.append({"step": s, **m})
            if s % log_every == 0:
                log.info("step %d loss %.4f", s, m["loss"])
            if saver and (s % ckpt_every == 0 or s == steps - 1):
                saver.save(s, {"params": state["params"], "opt": state["opt"]})
        if saver:
            saver.wait()
        return steps - 1

    sup = Supervisor()
    sup.run(body, resume_step)
    return {"history": history, "watchdog": watchdog.incidents,
            "restarts": sup.restarts, "params": state["params"]}
