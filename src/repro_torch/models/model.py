"""Model assembly: the pattern-unit LM of the reference, in torch.

Layers are grouped by the config's periodic pattern into (prefix,
unit x repeats, remainder).  The reference stacks the repeated unit and
runs it under ``lax.scan``; here ``params["unit"][j]`` is a list of the
``repeats`` parameter dictionaries of unit position j, and forward loops
over the repeats.

API (functions of a parameter dictionary):
  init(cfg, gen, device)                        -> params
  init_cache(cfg, batch, s_max, device)         -> cache
  forward(params, cfg, batch, mode, ...)        -> (logits, cache)
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..core.targets import resolve_device
from . import blocks as B
from . import layers as L


def _device(device) -> torch.device:
    return resolve_device("cuda" if device is None else device)


def init(cfg, gen: Optional[torch.Generator], device=None) -> Dict[str, Any]:
    """Random params with the reference's scales, drawn from ``gen`` (a
    generator on ``device``; unused on ``meta``).  ``device`` None is the
    card."""
    device = _device(device)
    prefix, unit, reps, rem = cfg.pattern_unit()
    params: Dict[str, Any] = {"embed": L.embed_init(gen, cfg, device)}
    params["final_norm"] = L.norm_init(cfg.d_model, cfg.norm, device)
    params["prefix"] = [B.block_init(k, gen, cfg, device) for k in prefix]
    params["unit"] = [[B.block_init(kind, gen, cfg, device)
                       for _ in range(reps)] for kind in unit]
    params["rem"] = [B.block_init(k, gen, cfg, device) for k in rem]
    if cfg.shared_attn_every:
        params["shared"] = B.shared_block_init(gen, cfg, device)
    return params


def init_cache(cfg, batch: int, s_max: int, device=None):
    device = _device(device)
    prefix, unit, reps, rem = cfg.pattern_unit()
    return {
        "prefix": [B.block_cache_init(k, cfg, batch, s_max, device)
                   for k in prefix],
        "unit": [[B.block_cache_init(kind, cfg, batch, s_max, device)
                  for _ in range(reps)] for kind in unit],
        "rem": [B.block_cache_init(k, cfg, batch, s_max, device)
                for k in rem],
    }


def forward(params, cfg, batch, *, mode: str, cache=None,
            lengths: Optional[torch.Tensor] = None, target=None):
    """Returns (logits, new_cache).

    ``target`` pins every attention/ssd lowering selection in this
    forward to an explicit machine model.
    """
    prefix, unit, reps, rem = cfg.pattern_unit()
    tokens = batch["tokens"]
    x = L.embed_apply(params["embed"], tokens, cfg)
    if mode == "decode":
        positions = lengths[:, None]
    else:
        positions = torch.arange(x.shape[1], device=x.device) \
            .expand(x.shape[:2])
    ctx = B.Ctx(cfg=cfg, mode=mode, positions=positions, lengths=lengths,
                emb0=x if cfg.shared_attn_every else None,
                shared=params.get("shared"), target=target)
    new_cache = {"prefix": [], "unit": [[] for _ in unit], "rem": []}

    def cached(part, *idx):
        if cache is None:
            return None
        c = cache[part]
        for i in idx:
            c = c[i]
        return c

    for i, kind in enumerate(prefix):
        x, c = B.block_apply(kind, params["prefix"][i], x,
                             cached("prefix", i), ctx)
        new_cache["prefix"].append(c)
    for r in range(reps):
        for j, kind in enumerate(unit):
            x, c = B.block_apply(kind, params["unit"][j][r], x,
                                 cached("unit", j, r), ctx)
            new_cache["unit"][j].append(c)
    for i, kind in enumerate(rem):
        x, c = B.block_apply(kind, params["rem"][i], x, cached("rem", i),
                             ctx)
        new_cache["rem"].append(c)

    x = L.norm_apply(params["final_norm"], x, cfg.norm)
    logits = L.head_apply(params["embed"], x, cfg)
    return logits, (new_cache if cache is not None else None)


def count_params(params) -> int:
    """Elements in a parameter tree (dicts and lists of tensors)."""
    if isinstance(params, torch.Tensor):
        return params.numel()
    items = params.values() if isinstance(params, dict) else params
    return sum(count_params(p) for p in items)
