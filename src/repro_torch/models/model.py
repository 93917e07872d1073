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
  init_cache(cfg, batch, s_max, device, mesh)   -> cache
  forward(params, cfg, batch, mode, ...)        -> (logits, cache, aux)

In train mode with ``cfg.remat`` and grad mode on, each block runs under
``torch.utils.checkpoint`` (non-reentrant, recomputed whole in the
backward), the counterpart of the reference's ``jax.checkpoint`` of its
scanned unit and encoder layer; ``aux`` sums the MoE blocks'
load-balance losses, as the reference's forward does.

Under an active mesh (``models/sharding.py``; the sharded train step)
the params are this rank's shards, which each block (and the
embedding, zamba2's shared block, the final norm) takes through
``sharding.layer_params`` on entry (inside remat, so that the recompute
takes them again): all-gathered over 'data' where the config is FSDP,
and summed over 'model' backward where the stream is cut.  ``sp_spec``
constrains the residual stream before each block of the pattern unit,
as the reference's scan body does: on a 'model' axis above 1 the first
constraint cuts it to this rank's chunk of the sequence, and it is
gathered whole after the final norm, before the head
(``sharding.gather_stream``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.utils.checkpoint as tc

from .. import tree
from ..core import registry
from ..core.targets import resolve_device
from . import blocks as B
from . import layers as L
from . import sharding as Sh


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


def init_cache(cfg, batch: int, s_max: int, device=None, mesh=None):
    """Zero caches for ``batch`` rows of ``s_max`` positions; with
    ``mesh`` this rank's part of them (``sharding.cache_shard_shape``),
    which the serving steps on the rank read and write."""
    device = _device(device)
    if mesh is not None:
        full = init_cache(cfg, batch, s_max, "meta")
        return tree.unflatten(full, [
            torch.zeros(Sh.cache_shard_shape(path, x.shape, cfg, mesh),
                        dtype=x.dtype, device=device)
            for path, x in tree.paths(full)])
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


def _apply(kind, params, x, cache, ctx):
    """``B.block_apply`` on the block's params as this rank uses them
    (``sharding.layer_params``; a no-op without a mesh)."""
    return B.block_apply(kind, Sh.layer_params(params, ctx.cfg), x,
                         cache, ctx)


def _blocks(cfg, mode):
    """``_apply``, under ``torch.utils.checkpoint`` where the forward is
    remat'd: train mode, ``cfg.remat`` and grad mode on.  The recompute
    runs on autograd's thread, so it re-enters this thread's policy,
    target and mesh; early stopping is off, so it reruns the whole block
    and each kernel launches exactly twice a step."""
    if not (cfg.remat and mode == "train" and torch.is_grad_enabled()):
        return _apply
    scope = registry.current_scope()

    def apply(*a):
        # the mesh state as this block sees it (a sequence-parallel
        # stream is cut from the first block on)
        state = Sh.current_state()

        def run(*b):
            with registry.use_scope(scope), Sh.resumed(state):
                return _apply(*b)
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
            lengths: Optional[torch.Tensor] = None, sp_spec=None,
            target=None, last_only=False):
    """Returns (logits, new_cache, aux): aux the MoE blocks' summed
    load-balance loss, a float32 scalar (0 where there is none).

    ``batch`` holds ``tokens``, and ``frames`` (encdec) or ``patches``
    (vlm) outside decode.  ``sp_spec`` (a ``sharding.P``) constrains the
    residual stream before each block under a mesh.  ``target`` pins
    every attention/ssd lowering selection in this forward to an
    explicit machine model.  ``last_only`` runs the head on the last
    position alone (a prefill step's output): logits (B, 1, V).
    """
    prefix, unit, reps, rem = cfg.pattern_unit()
    params = {**params,
              "embed": Sh.layer_params(params["embed"], cfg)}
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
            if sp_spec is not None:
                x = Sh.constrain(x, *sp_spec)
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

    x = Sh.gather_stream(L.norm_apply(
        Sh.layer_params(params["final_norm"], cfg), x, cfg.norm))
    if cfg.family == "vlm" and mode != "decode":
        x = x[:, -batch["tokens"].shape[1]:]     # the token positions
    if last_only:
        x = x[:, -1:]
    logits = L.head_apply(params["embed"], x, cfg)
    return logits, (new_cache if cache is not None else None), aux


def stack_groups(params):
    """A key a leaf of ``params``, in leaf order: the leaves that the
    reference's params stack into one (a pattern unit's layer over its
    repeats, the encoder's layers) share their key, each other leaf has
    its own.  What a whole-leaf statistic of the reference (int8
    compression's scale) is taken over."""
    keys = []
    for path, _ in tree.paths(params):
        if path[0] == "unit":
            path = ("unit", path[1]) + path[3:]
        elif path[0] == "enc":
            path = ("enc",) + path[2:]
        keys.append(path)
    return keys


def count_params(params) -> int:
    """Elements in a parameter tree (dicts and lists of tensors)."""
    if isinstance(params, torch.Tensor):
        return params.numel()
    items = params.values() if isinstance(params, dict) else params
    return sum(count_params(p) for p in items)
