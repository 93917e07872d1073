"""Training on one device: the step and the supervised driver.

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

The sharded step (``make_sharded_train_step``) and the pipeline
schedule (``train/pipeline.py``) wait for the port's distribution
(ROADMAP A.13).
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


def loss_fn(params, cfg, batch):
    """-> (mean xent + 0.01 aux, (mean xent, aux)), over the padded vocab."""
    logits, _, aux = M.forward(params, cfg, batch, mode="train")
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
            packed, err_state = compression.compress(grads, err_state)
            grads = compression.decompress(packed)
        params, opt_state, om = adamw.update(grads, opt_state, params,
                                             tcfg.optim)
        metrics = {"loss": lsum / accum, "aux": asum / accum, **om}
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
