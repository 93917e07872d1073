"""Primitive layers: params as dictionaries of tensors, pure functions.

All heavy compute routes through :mod:`repro_torch.kernels.ops` so the
lowering ladder applies model-wide.  Norm and softmax math stays fp32;
weights and activations take the config's dtype.  The inits draw from an
explicit ``torch.Generator`` on the device the params are made on (on
``meta`` nothing is drawn), with the reference's scales.

Under an active mesh (``models/sharding.py``) with a 'model' axis of
more than one rank the weights are local shards: the MLP's and the
head's column-parallel products run on the rank's columns of a
replicated input (``sharding.enter_model``), ``linear_rp`` reduces the
row-parallel partials over 'model', the embedding looks up the rank's
vocab rows and reduces, and the head's logits are gathered over 'model'.
Under sequence parallelism the MLP's input is gathered from the
stream's chunks and ``linear_rp`` reduce-scatters back into them.
Without a mesh each is the plain layer.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..kernels import ops
from . import sharding as Sh


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def normal(gen, shape, scale, dtype, device):
    """``scale`` x standard normals of ``shape``, drawn in fp32 and cast
    to ``dtype``; an uninitialized tensor on ``meta``."""
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    out = torch.randn(shape, generator=gen, device=device,
                      dtype=torch.float32)
    return out.mul_(scale).to(dtype)


def dense_init(gen, d_in, d_out, dtype, device, scale=None):
    scale = scale if scale is not None else d_in ** -0.5
    return normal(gen, (d_in, d_out), scale, dtype, device)


def linear(w, x):
    """x:(..., d_in) @ w:(d_in, d_out) — dispatched through the gemm op."""
    lead = x.shape[:-1]
    out = ops.gemm(x.reshape(math.prod(lead), x.shape[-1]), w)
    return out.reshape(*lead, w.shape[-1])


def linear_rp(w, x, cfg):
    """Row-parallel linear: the local product of this rank's rows of
    ``w`` with its columns of ``x``, summed over 'model' (into a
    sequence-parallel stream: this rank's chunk of the sum).  The sum's
    dtype mirrors the reference's.  Its ``shard_map`` branch (bf16, no
    FSDP, the dims divide, which the sharded step requires) psums the
    partials in the product's dtype, bf16.  On an FSDP config it falls
    back to ``linear`` and GSPMD places the sum: the reference's sharded
    step of mistral-large-123b (``reduced()``, bf16, mesh (2, 2), forced
    host devices) compiles it to an all-reduce over 'model' of the dot's
    float32 output, cast to bf16 after the sum.  So on an FSDP config the
    partials are summed in float32 and cast once; the port's bf16 gemm
    rounds each partial to bf16 first, where the reference's is the
    float32 accumulator.  A float32 model sums in float32 either way.
    Without a mesh it is :func:`linear`."""
    y = linear(w, x)
    if cfg.fsdp and Sh.model_split()[1] > 1:
        return Sh.leave_model(y.to(torch.float32)).to(y.dtype)
    return Sh.leave_model(y)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm_init(d, kind, device):
    w = torch.ones((d,), dtype=torch.float32, device=device)
    if kind == "layernorm":
        return {"w": w, "b": torch.zeros((d,), dtype=torch.float32,
                                         device=device)}
    return {"w": w}


def norm_apply(params, x, kind="rmsnorm", eps=1e-6):
    xf = x.to(torch.float32)
    if kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + eps) * params["w"] + params["b"]
    else:
        ms = xf.square().mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * params["w"]
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# activations (through the lowering ladder)
# ---------------------------------------------------------------------------

# sqrt(2/pi) rounded to float32 first, as the reference's constant is
_GELU_C = float(np.float32(np.sqrt(2.0 / np.pi)))


def act_apply(x, kind):
    if kind == "silu":
        return x * ops.vsigmoid(x)
    if kind == "gelu":
        # tanh-approx gelu built from the vtanh lowering
        xf = x.to(torch.float32)
        inner = (_GELU_C * (xf + 0.044715 * (xf * xf * xf))).to(x.dtype)
        return (0.5 * xf * (1.0 + ops.vtanh(inner).to(torch.float32))) \
            .to(x.dtype)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_apply(x, positions, theta):
    """x:(B, S, H, D) rotate with half-split RoPE at ``positions``:(B, S)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs        # (B,S,half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def sinusoidal_positions(positions, d):
    """Whisper-style absolute sinusoidal embeddings, float32.
    positions:(B, S) -> (B, S, d)."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=positions.device)
                      / max(1, half - 1))
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# MLP (gated or plain)
# ---------------------------------------------------------------------------

def mlp_init(gen, cfg, device, d_in=None, d_ff=None, d_out=None):
    d = d_in or cfg.d_model
    f = d_ff or cfg.d_ff
    o = d_out or cfg.d_model
    dt = dtype_of(cfg)
    p = {"wu": dense_init(gen, d, f, dt, device),
         "wd": dense_init(gen, f, o, dt, device)}
    if cfg.gated_mlp:
        p["wg"] = dense_init(gen, d, f, dt, device)
    return p


def mlp_apply(params, x, cfg):
    x = Sh.enter_model(x)
    up = linear(params["wu"], x)
    if cfg.gated_mlp:
        h = act_apply(linear(params["wg"], x), cfg.act) * up
    else:
        h = act_apply(up, cfg.act)
    return linear_rp(params["wd"], h, cfg)


# ---------------------------------------------------------------------------
# embeddings / lm head
# ---------------------------------------------------------------------------

def padded_vocab(cfg) -> int:
    """Megatron-style vocab padding so TP always divides the vocab dim."""
    return -(-cfg.vocab_size // 256) * 256


def embed_init(gen, cfg, device):
    dt = dtype_of(cfg)
    vp = padded_vocab(cfg)
    p = {"emb": normal(gen, (vp, cfg.d_model), 0.02, dt, device)}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, cfg.d_model, vp, dt, device)
    return p


def embed_apply(params, tokens, cfg):
    """The rows of ``tokens``; vocab-parallel under a 'model' split: this
    rank's rows looked up (zeros for the others' tokens), then summed
    over 'model'."""
    r, n = Sh.model_split()
    if n == 1:
        x = params["emb"][tokens]
    else:
        emb = params["emb"]
        lo, hi = Sh.chunk_range(padded_vocab(cfg), r, n)
        mine = (tokens >= lo) & (tokens < hi)
        local = torch.where(mine, tokens - lo, 0)
        x = Sh.leave_model(emb[local] * mine[..., None].to(emb.dtype))
    if cfg.scale_embeddings:
        x = (x.to(torch.float32) * math.sqrt(cfg.d_model)).to(x.dtype)
    return x


def head_apply(params, x, cfg):
    # the tied head is one plain matrix product, as the reference leaves
    # its einsum to XLA; under a 'model' split each rank makes its vocab
    # columns and they are gathered
    x = Sh.enter_model(x)
    logits = linear(params["head"], x) if not cfg.tie_embeddings else \
        torch.matmul(x, params["emb"].t())
    logits = Sh.gather_model(logits, -1, padded_vocab(cfg))
    if cfg.final_softcap is not None:
        lf = logits.to(torch.float32) / cfg.final_softcap
        logits = (cfg.final_softcap *
                  ops.vtanh(lf).to(torch.float32)).to(x.dtype)
    vp = padded_vocab(cfg)
    if vp != cfg.vocab_size:  # mask padded vocab rows out of the softmax
        pad = torch.arange(vp, device=x.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    return logits
