"""AdamW with fp32 master weights and a cosine schedule, in torch.

The JAX package's ``optim/adamw.py`` step for step: the moments and the
master copy are fp32 whatever the params' dtype; ``schedule`` reads the
step before its increment and the bias correction the step after it;
the gradients are clipped by min(1, grad_clip / (norm + 1e-9)); the new
params are the new masters cast to each param's dtype (round to nearest
even, as JAX's cast).  ``update`` works under ``torch.no_grad`` and in
place: the params stay the same leaf tensors (requiring grad where they
did), the state's tensors are overwritten.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from .. import tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def init(params) -> Dict[str, Any]:
    """fp32 zero moments, fp32 masters and an int32 step 0, each on its
    param's device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    first = tree.leaves(params)[0]
    return {
        "m": tree.map(zeros, params),
        "v": tree.map(zeros, params),
        "master": tree.map(
            lambda p: p.detach().to(torch.float32, copy=True), params),
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
    }


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac`` of ``lr``."""
    step = step.to(torch.float32)
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(np.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)


def global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree.leaves(grads)))


@torch.no_grad()
def update(grads, state, params, cfg: AdamWConfig):
    """Returns (params, state, metrics); params and state updated in
    place, metrics {"grad_norm", "lr"} as device scalars."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, state["step"])
    stepf = step.to(torch.float32)
    b1c = 1 - cfg.b1 ** stepf
    b2c = 1 - cfg.b2 ** stepf
    for g, m, v, w, p in zip(tree.leaves(grads), tree.leaves(state["m"]),
                             tree.leaves(state["v"]),
                             tree.leaves(state["master"]),
                             tree.leaves(params)):
        g = g.to(torch.float32) * clip
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g))
        mh = m / b1c
        vh = v / b2c
        w.copy_(w - lr * (mh / (torch.sqrt(vh) + cfg.eps) +
                          cfg.weight_decay * w))
        p.copy_(w.to(p.dtype))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
