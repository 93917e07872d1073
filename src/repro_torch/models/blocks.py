"""Layer blocks: one (init, cache_init, apply) triple per layer kind.

Kinds, all of the reference's: ``mamba`` and ``mamba_shared`` (a Mamba2
layer followed by zamba2's shared attention+MLP block); the transformer
blocks ``attn`` (a dense FFN), ``local`` (the same over a sliding window
of ``cfg.window`` positions, its cache a ring of that many slots),
``moe`` (an MoE FFN) and ``moe_dense`` (deepseek's first layers: a dense
FFN of width ``d_ff_dense``), each with GQA or MLA attention as the
config's ``attn_kind`` says; whisper's ``enc`` (non-causal self-attention,
no cache) and ``dec`` (causal self-attention, then cross-attention over
the encoder's output, whose k and v the cache keeps from the prefill).
Blocks are functions of (params, x, cache, ctx), where ctx carries the
mode, positions, lengths, the encoder's output and the zamba2
shared-block closure, and return (x, cache, aux) as the reference's do.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from . import attention as A
from . import layers as L
from . import moe as M
from . import ssm as S


@dataclasses.dataclass
class Ctx:
    cfg: Any
    mode: str                      # train | prefill | decode
    positions: torch.Tensor        # (B, S)
    lengths: Optional[torch.Tensor] = None   # (B,) decode valid lengths
    memory: Any = None             # whisper: encoder output (B, F, d)
    emb0: Any = None               # zamba2: initial embedding stream
    shared: Any = None             # zamba2: shared block params
    target: Any = None             # explicit lowering target; None = ambient


# ---------------------------------------------------------------------------
# transformer block (attn/local x dense/moe ffn)
# ---------------------------------------------------------------------------

def _tblock_init(gen, cfg, device, *, ffn: str, d_ff=None):
    attn_init = A.mla_init if cfg.attn_kind == "mla" else A.gqa_init
    p = {
        "ln1": L.norm_init(cfg.d_model, cfg.norm, device),
        "attn": attn_init(gen, cfg, device),
        "ln2": L.norm_init(cfg.d_model, cfg.norm, device),
    }
    if cfg.sandwich_norm:
        p["ln1p"] = L.norm_init(cfg.d_model, cfg.norm, device)
        p["ln2p"] = L.norm_init(cfg.d_model, cfg.norm, device)
    if ffn == "moe":
        p["ffn"] = M.moe_init(gen, cfg, device)
    else:
        p["ffn"] = L.mlp_init(gen, cfg, device, d_ff=d_ff or cfg.d_ff)
    return p


def _tblock_cache(cfg, batch, s_max, device, *, window=None):
    if cfg.attn_kind == "mla":
        return A.mla_cache_init(cfg, batch, s_max, device)
    return A.gqa_cache_init(cfg, batch, s_max, device, window)


def _tblock_apply(params, x, cache, ctx: Ctx, *, ffn: str, window=None):
    """-> (x, cache, aux): aux is the MoE's load-balance loss, 0.0 for a
    dense FFN."""
    cfg = ctx.cfg
    h = L.norm_apply(params["ln1"], x, cfg.norm)
    attn = dict(positions=ctx.positions, mode=ctx.mode, cache=cache,
                lengths=ctx.lengths, target=ctx.target)
    if cfg.attn_kind == "mla":
        h, cache = A.mla_apply(params["attn"], h, cfg, **attn)
    else:
        h, cache = A.gqa_apply(params["attn"], h, cfg, window=window, **attn)
    if cfg.sandwich_norm:
        h = L.norm_apply(params["ln1p"], h, cfg.norm)
    x = x + h
    h = L.norm_apply(params["ln2"], x, cfg.norm)
    aux = 0.0
    if ffn == "moe":
        h, aux = M.moe_apply(params["ffn"], h, cfg)
    else:
        h = L.mlp_apply(params["ffn"], h, cfg)
    if cfg.sandwich_norm:
        h = L.norm_apply(params["ln2p"], h, cfg.norm)
    return x + h, cache, aux


# ---------------------------------------------------------------------------
# mamba (+ shared attention) blocks
# ---------------------------------------------------------------------------

def _mamba_init(gen, cfg, device):
    return {"ln": L.norm_init(cfg.d_model, cfg.norm, device),
            "mamba": S.mamba_init(gen, cfg, device)}


def _mamba_apply(params, x, cache, ctx: Ctx):
    h = L.norm_apply(params["ln"], x, ctx.cfg.norm)
    h, cache = S.mamba_apply(params["mamba"], h, ctx.cfg, mode=ctx.mode,
                             cache=cache, target=ctx.target)
    return x + h, cache, 0.0


def shared_block_init(gen, cfg, device):
    """zamba2 shared attention+MLP block over concat width 2d."""
    d2 = 2 * cfg.d_model
    return {
        "ln1": L.norm_init(d2, cfg.norm, device),
        "attn": A.gqa_init(gen, cfg, device, d_in=d2),
        "ln2": L.norm_init(d2, cfg.norm, device),
        "mlp": L.mlp_init(gen, cfg, device, d_in=d2, d_ff=cfg.d_ff,
                          d_out=cfg.d_model),
    }


def _shared_apply(shared, x, cache, ctx: Ctx):
    cfg = ctx.cfg
    cat = torch.cat([x, ctx.emb0], dim=-1)
    h = L.norm_apply(shared["ln1"], cat, cfg.norm)
    h, cache = A.gqa_apply(shared["attn"], h, cfg, positions=ctx.positions,
                           mode=ctx.mode, cache=cache, lengths=ctx.lengths,
                           target=ctx.target)
    x = x + h
    m = L.mlp_apply(shared["mlp"],
                    L.norm_apply(shared["ln2"], cat, cfg.norm), cfg)
    return x + m, cache


def _mamba_shared_apply(params, x, cache, ctx: Ctx):
    mc = None if cache is None else cache["mamba"]
    ac = None if cache is None else cache["attn"]
    x, mcache, _ = _mamba_apply(params, x, mc, ctx)
    x, acache = _shared_apply(ctx.shared, x, ac, ctx)
    if cache is None:
        return x, None, 0.0
    return x, {"mamba": mcache, "attn": acache}, 0.0


# ---------------------------------------------------------------------------
# whisper encoder / decoder blocks
# ---------------------------------------------------------------------------

def _enc_init(gen, cfg, device):
    return {"ln1": L.norm_init(cfg.d_model, cfg.norm, device),
            "attn": A.gqa_init(gen, cfg, device),
            "ln2": L.norm_init(cfg.d_model, cfg.norm, device),
            "mlp": L.mlp_init(gen, cfg, device)}


def _enc_apply(params, x, cache, ctx: Ctx):
    cfg = ctx.cfg
    h = L.norm_apply(params["ln1"], x, cfg.norm)
    h, _ = A.gqa_apply(params["attn"], h, cfg, positions=ctx.positions,
                       mode="train", causal=False, target=ctx.target)
    x = x + h
    h = L.norm_apply(params["ln2"], x, cfg.norm)
    return x + L.mlp_apply(params["mlp"], h, cfg), cache, 0.0


def _dec_init(gen, cfg, device):
    return {"ln1": L.norm_init(cfg.d_model, cfg.norm, device),
            "attn": A.gqa_init(gen, cfg, device),
            "lnx": L.norm_init(cfg.d_model, cfg.norm, device),
            "xattn": A.gqa_init(gen, cfg, device),
            "ln2": L.norm_init(cfg.d_model, cfg.norm, device),
            "mlp": L.mlp_init(gen, cfg, device)}


def _dec_cache(cfg, batch, s_max, device):
    shape = (batch, cfg.n_frames, cfg.n_kv_heads, cfg.head_dim)
    dt = L.dtype_of(cfg)
    return {"self": A.gqa_cache_init(cfg, batch, s_max, device),
            "xk": torch.zeros(shape, dtype=dt, device=device),
            "xv": torch.zeros(shape, dtype=dt, device=device)}


def _dec_apply(params, x, cache, ctx: Ctx):
    """Self-attention, cross-attention over the encoder's output, MLP.  A
    prefill writes the cross k and v into the cache, a decode step reads
    them from it (``ctx.memory`` is None there)."""
    cfg = ctx.cfg
    b = x.shape[0]
    h = L.norm_apply(params["ln1"], x, cfg.norm)
    h, _ = A.gqa_apply(params["attn"], h, cfg, positions=ctx.positions,
                       mode=ctx.mode,
                       cache=None if cache is None else cache["self"],
                       lengths=ctx.lengths, target=ctx.target)
    x = x + h
    h = L.norm_apply(params["lnx"], x, cfg.norm)
    if ctx.mode == "decode":
        xk, xv = cache["xk"], cache["xv"]
    else:
        mem = ctx.memory
        f = mem.shape[1]
        xk = L.linear(params["xattn"]["wk"], mem).reshape(
            b, f, cfg.n_kv_heads, cfg.head_dim)
        xv = L.linear(params["xattn"]["wv"], mem).reshape(
            b, f, cfg.n_kv_heads, cfg.head_dim)
        if cache is not None:
            cache["xk"].copy_(xk)
            cache["xv"].copy_(xv)
    h, _ = A.gqa_apply(params["xattn"], h, cfg, positions=ctx.positions,
                       mode="train", memory=(xk, xv), target=ctx.target)
    x = x + h
    h = L.norm_apply(params["ln2"], x, cfg.norm)
    return x + L.mlp_apply(params["mlp"], h, cfg), cache, 0.0


# ---------------------------------------------------------------------------
# kind registry
# ---------------------------------------------------------------------------

def block_init(kind, gen, cfg, device):
    if kind in ("attn", "local"):
        return _tblock_init(gen, cfg, device, ffn="dense")
    if kind == "moe":
        return _tblock_init(gen, cfg, device, ffn="moe")
    if kind == "moe_dense":
        return _tblock_init(gen, cfg, device, ffn="dense",
                            d_ff=cfg.d_ff_dense or cfg.d_ff)
    if kind in ("mamba", "mamba_shared"):
        return _mamba_init(gen, cfg, device)
    if kind == "enc":
        return _enc_init(gen, cfg, device)
    if kind == "dec":
        return _dec_init(gen, cfg, device)
    raise ValueError(kind)


def block_cache_init(kind, cfg, batch, s_max, device):
    if kind == "local":
        return _tblock_cache(cfg, batch, s_max, device, window=cfg.window)
    if kind in ("attn", "moe", "moe_dense"):
        return _tblock_cache(cfg, batch, s_max, device)
    if kind == "mamba":
        return S.mamba_cache_init(cfg, batch, device)
    if kind == "mamba_shared":
        return {"mamba": S.mamba_cache_init(cfg, batch, device),
                "attn": A.gqa_cache_init(cfg, batch, s_max, device)}
    if kind == "dec":
        return _dec_cache(cfg, batch, s_max, device)
    if kind == "enc":
        return None
    raise ValueError(kind)


def block_apply(kind, params, x, cache, ctx: Ctx):
    """-> (x, cache, aux): aux is an MoE block's load-balance loss (a
    float32 scalar), 0.0 for every other block."""
    if kind in ("attn", "moe_dense"):
        return _tblock_apply(params, x, cache, ctx, ffn="dense")
    if kind == "local":
        return _tblock_apply(params, x, cache, ctx, ffn="dense",
                             window=ctx.cfg.window)
    if kind == "moe":
        return _tblock_apply(params, x, cache, ctx, ffn="moe")
    if kind == "mamba":
        return _mamba_apply(params, x, cache, ctx)
    if kind == "mamba_shared":
        return _mamba_shared_apply(params, x, cache, ctx)
    if kind == "enc":
        return _enc_apply(params, x, cache, ctx)
    if kind == "dec":
        return _dec_apply(params, x, cache, ctx)
    raise ValueError(kind)
