"""Model assembly: the pattern-unit LM of the reference, in torch.

Layers are grouped by the config's periodic pattern into (prefix,
unit x repeats, remainder).  The reference stacks the repeated unit and
runs it under ``lax.scan``; here ``params["unit"][j]`` is a list of the
``repeats`` parameter dictionaries of unit position j, and forward loops
over the repeats.  An encoder-decoder (whisper) also has ``params["enc"]``,
a list of its ``n_enc_layers`` encoder blocks, run over the batch's
``frames`` in every mode but decode; a vlm (pixtral) prepends the batch's
``patches`` to the token embeddings outside decode and keeps the logits
of the token positions.

API (functions of a parameter dictionary):
  init(cfg, gen, device)                        -> params
  init_cache(cfg, batch, s_max, device)         -> cache
  forward(params, cfg, batch, mode, ...)        -> (logits, cache, aux)

In train mode with ``cfg.remat`` and grad mode on, each block runs under
``torch.utils.checkpoint`` (non-reentrant, recomputed whole in the
backward), the counterpart of the reference's ``jax.checkpoint`` of its
scanned unit and encoder layer; ``aux`` sums the MoE blocks'
load-balance losses, as the reference's forward does.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.utils.checkpoint as tc

from ..core import registry
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
    if cfg.family == "encdec":
        params["enc"] = [B.block_init("enc", gen, cfg, device)
                         for _ in range(cfg.n_enc_layers)]
        params["enc_norm"] = L.norm_init(cfg.d_model, cfg.norm, device)
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


def _with_positions(x, positions, cfg):
    """x + whisper's sinusoidal position embeddings, summed in float32."""
    pos_emb = L.sinusoidal_positions(positions, cfg.d_model)
    return (x.to(torch.float32) + pos_emb).to(x.dtype)


def _embed_inputs(params, cfg, batch, mode, lengths):
    """-> (x, positions): the tokens' embeddings (a vlm's patches before
    them outside decode), whisper's positions added."""
    x = L.embed_apply(params["embed"], batch["tokens"], cfg)
    if cfg.family == "vlm" and mode != "decode":
        x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
    if mode == "decode":
        positions = lengths[:, None]
    else:
        positions = torch.arange(x.shape[1], device=x.device) \
            .expand(x.shape[:2])
    if cfg.name.startswith("whisper"):
        x = _with_positions(x, positions, cfg)
    return x, positions


def _blocks(cfg, mode):
    """``B.block_apply``, under ``torch.utils.checkpoint`` where the
    forward is remat'd: train mode, ``cfg.remat`` and grad mode on.  The
    recompute runs on autograd's thread, so it re-enters this thread's
    policy and target; early stopping is off, so it reruns the whole block
    and each kernel launches exactly twice a step."""
    if not (cfg.remat and mode == "train" and torch.is_grad_enabled()):
        return B.block_apply
    scope = registry.current_scope()

    def run(*a):
        with registry.use_scope(scope):
            return B.block_apply(*a)

    def apply(*a):
        with tc.set_checkpoint_early_stop(False):
            return tc.checkpoint(run, *a, use_reentrant=False,
                                 preserve_rng_state=False)
    return apply


def _encode(params, cfg, frames, target=None):
    """The whisper encoder over stub frame embeddings (B, F, d)."""
    x = frames.to(L.dtype_of(cfg))
    pos = torch.arange(x.shape[1], device=x.device).expand(x.shape[:2])
    x = _with_positions(x, pos, cfg)
    ctx = B.Ctx(cfg=cfg, mode="train", positions=pos, target=target)
    block = _blocks(cfg, "train")
    for p in params["enc"]:
        x, _, _ = block("enc", p, x, None, ctx)
    return L.norm_apply(params["enc_norm"], x, cfg.norm)


def forward(params, cfg, batch, *, mode: str, cache=None,
            lengths: Optional[torch.Tensor] = None, target=None):
    """Returns (logits, new_cache, aux): aux the MoE blocks' summed
    load-balance loss, a float32 scalar (0 where there is none).

    ``batch`` holds ``tokens``, and ``frames`` (encdec) or ``patches``
    (vlm) outside decode.  ``target`` pins every attention/ssd lowering
    selection in this forward to an explicit machine model.
    """
    prefix, unit, reps, rem = cfg.pattern_unit()
    x, positions = _embed_inputs(params, cfg, batch, mode, lengths)
    memory = None
    if cfg.family == "encdec" and mode != "decode":
        memory = _encode(params, cfg, batch["frames"], target=target)
    ctx = B.Ctx(cfg=cfg, mode=mode, positions=positions, lengths=lengths,
                memory=memory, emb0=x if cfg.shared_attn_every else None,
                shared=params.get("shared"), target=target)
    new_cache = {"prefix": [], "unit": [[] for _ in unit], "rem": []}
    block = _blocks(cfg, mode)
    aux = 0.0

    def cached(part, *idx):
        if cache is None:
            return None
        c = cache[part]
        for i in idx:
            c = c[i]
        return c

    for i, kind in enumerate(prefix):
        x, c, a = block(kind, params["prefix"][i], x, cached("prefix", i),
                        ctx)
        new_cache["prefix"].append(c)
        aux = aux + a
    for r in range(reps):
        for j, kind in enumerate(unit):
            x, c, a = block(kind, params["unit"][j][r], x,
                            cached("unit", j, r), ctx)
            new_cache["unit"][j].append(c)
            aux = aux + a
    for i, kind in enumerate(rem):
        x, c, a = block(kind, params["rem"][i], x, cached("rem", i), ctx)
        new_cache["rem"].append(c)
        aux = aux + a
    if not isinstance(aux, torch.Tensor):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)

    x = L.norm_apply(params["final_norm"], x, cfg.norm)
    if cfg.family == "vlm" and mode != "decode":
        x = x[:, -batch["tokens"].shape[1]:]     # the token positions
    logits = L.head_apply(params["embed"], x, cfg)
    return logits, (new_cache if cache is not None else None), aux


def count_params(params) -> int:
    """Elements in a parameter tree (dicts and lists of tensors)."""
    if isinstance(params, torch.Tensor):
        return params.numel()
    items = params.values() if isinstance(params, dict) else params
    return sum(count_params(p) for p in items)
