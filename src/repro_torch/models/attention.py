"""GQA attention (+ sliding window / softcap / qk-norm) with train,
prefill and decode cache handling.

Cache layout (static shapes; ``lengths`` tracks the valid prefix):
  global : k, v (B, S_max, Hkv, hd)
  local  : ring buffer of ``window`` slots (slot = pos % window); softmax
           is permutation-invariant over kv, so slot order is irrelevant
           once keys carry RoPE.

The reference returns a new cache; here prefill and decode write the
caller's cache tensors in place (no copy of the cache per step) and
return the same dictionary.  MLA and the cross-attention branch wait for
later slices (ROADMAP A.9).
"""
from __future__ import annotations

import torch

from ..kernels import ops
from . import layers as L


def gqa_init(gen, cfg, device, d_in=None):
    d = d_in or cfg.d_model
    dt = L.dtype_of(cfg)
    hd, h, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": L.dense_init(gen, d, h * hd, dt, device),
        "wk": L.dense_init(gen, d, hkv * hd, dt, device),
        "wv": L.dense_init(gen, d, hkv * hd, dt, device),
        "wo": L.dense_init(gen, h * hd, cfg.d_model, dt, device),
    }
    if cfg.qk_norm:
        p["qn"] = L.norm_init(hd, "rmsnorm", device)
        p["kn"] = L.norm_init(hd, "rmsnorm", device)
    return p


def gqa_cache_init(cfg, batch, s_max, device, window=None, dtype=None):
    dt = dtype or L.dtype_of(cfg)
    slots = min(window, s_max) if window else s_max
    shape = (batch, slots, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def gqa_apply(params, x, cfg, *, positions, mode, cache=None, lengths=None,
              window=None, causal=True, target=None):
    """x:(B,S,d).  mode in train|prefill|decode.  ``target`` pins the
    attention lowering selection to an explicit machine model."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = L.linear(params["wq"], x).reshape(b, s, h, hd)
    k = L.linear(params["wk"], x).reshape(b, s, hkv, hd)
    v = L.linear(params["wv"], x).reshape(b, s, hkv, hd)
    if cfg.qk_norm:
        q = L.norm_apply(params["qn"], q)
        k = L.norm_apply(params["kn"], k)
    if cfg.rope_theta:
        q = L.rope_apply(q, positions, cfg.rope_theta)
        k = L.rope_apply(k, positions, cfg.rope_theta)

    if mode == "train":
        out = ops.attention(q, k, v, causal=causal, window=window,
                            softcap=cfg.softcap, target=target)
        return L.linear_rp(params["wo"], out.reshape(b, s, h * hd), cfg), \
            cache

    if mode == "prefill":
        slots = cache["k"].shape[1]
        if window and slots < s:  # ring: keep the last ``window`` positions
            ppos = torch.arange(s - slots, s, device=x.device)
            cache["k"][:, ppos % slots] = k[:, s - slots:]
            cache["v"][:, ppos % slots] = v[:, s - slots:]
        else:
            cache["k"][:, :s] = k
            cache["v"][:, :s] = v
        out = ops.attention(q, k, v, causal=True, window=window,
                            softcap=cfg.softcap, target=target)
        return L.linear_rp(params["wo"], out.reshape(b, s, h * hd), cfg), \
            cache

    # decode: s == 1, write at pos = lengths (per row), attend valid prefix
    slots = cache["k"].shape[1]
    slot = (lengths % slots) if window else lengths
    bidx = torch.arange(b, device=x.device)
    cache["k"][bidx, slot] = k[:, 0]
    cache["v"][bidx, slot] = v[:, 0]
    valid = torch.clamp(lengths + 1, max=slots)
    out = ops.decode_attention(q, cache["k"], cache["v"], valid,
                               softcap=cfg.softcap, target=target)
    return L.linear_rp(params["wo"], out.reshape(b, s, h * hd), cfg), cache
