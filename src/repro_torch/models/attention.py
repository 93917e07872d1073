"""Attention blocks: GQA (+ sliding window / softcap / qk-norm), MLA and
cross-attention, with train, prefill and decode cache handling.

Cache layouts (static shapes; ``lengths`` tracks the valid prefix):
  gqa global : k, v (B, S_max, Hkv, hd)
  gqa local  : ring buffer of ``window`` slots (slot = pos % window);
               softmax is permutation-invariant over kv, so slot order is
               irrelevant once keys carry RoPE.
  mla        : c_kv (B, S_max, kv_lora), k_rope (B, S_max, rope_dim) —
               decode uses the *absorbed* form (q into W_uk, out through
               W_uv) so the compressed cache is attended directly.

The reference returns a new cache; here prefill and decode write the
caller's cache tensors in place (no copy of the cache per step) and
return the same dictionary.  MLA's prefill attention has split head dims
(q/k wider than v), which the fused kernel does not take: it runs on the
vector tier by the reference's own rule (``ops._attn_supports``), and its
absorbed decode is plain products, as the reference's is.
Cross-attention (``memory``: whisper's decoder) attends the encoder's k
and v, non-causal and without rope, in every mode; its caller keeps them.

Under a 'model' split (``models/sharding.py``) each rank holds its
chunk of the q heads (``sharding.model_range``: ceil-sized, the last
ranks short or empty where 'model' does not divide them, GSPMD's cut):
the replicated input enters the model region once (a sequence-parallel
stream's chunks are gathered there), attention runs on the rank's heads
over the whole sequence and ``linear_rp`` sums the output projection's
partials.  ``wq``'s columns and ``wo``'s rows are the stored chunk where
it lines up with every rank's heads, else the leaf gathered over 'model'
and the heads' span taken (``sharding.heads_of``).  Where 'model' gives
each rank whole kv heads, ``wk`` and ``wv`` hold them; otherwise
(:func:`kv_proj`) each rank's k and v columns are gathered over 'model'
and the kv heads its q heads read are kept, each q head given its own
where a rank's heads straddle kv heads unevenly (the cache then holds
one a q head, read in place).  A rank without heads
runs every product and collective of the block on empty heads, and no
attention kernel.  The qk-norm weights pass through
``sharding.model_leaf``.  MLA's down-projections and their norms run
replicated on every rank (on the stream's chunk under sequence
parallelism); its latent ``c_kv``, its shared ``k_rope`` and the q input
of its column-parallel up-projection enter the model region, and its
heads are the rank's ``w_uq``/``wq``, ``w_uk``, ``w_uv`` columns and
``wo`` rows, as ``heads_of`` gives them.
"""
from __future__ import annotations

import math

import torch

from ..kernels import ops
from . import layers as L
from . import sharding as Sh


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


def _norm_leaf(p, x):
    """The per-head RMSNorm of ``x`` by a replicated weight applied to this
    rank's heads (``sharding.model_leaf``)."""
    return L.norm_apply({"w": Sh.model_leaf(p["w"])}, x)


def kv_proj(w, x, cfg):
    """``x`` @ ``w`` as (B, S, Hkv, hd): the kv heads that this rank's
    q heads read, in the attention kernels' order.  Without a 'model'
    split, or where it gives each rank whole kv heads, those are ``w``'s
    columns.  Otherwise (fewer kv heads than ranks, or heads 'model' does
    not divide) ``w``'s contiguous cut is not the rank's kv heads: its
    columns' products are gathered over 'model' (backward, summed and
    this rank's chunk kept), and the rank's q heads
    (``sharding.model_range``) keep the kv heads they read, head j
    reading j // (n_heads / n_kv_heads), none on a rank without heads;
    where some rank's heads straddle kv heads unevenly
    (``sharding.straddles``), each q head its own, so that Hkv is the
    rank's q heads (the kernels read them, and the cache holds them, as
    multi-head attention)."""
    hd, n, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    b, s = x.shape[:2]
    _, m = Sh.model_split()
    if hkv % m == 0:
        return L.linear(w, x).reshape(b, s, w.shape[-1] // hd, hd)
    y = Sh.gather_model(L.linear(w, x), -1, hkv * hd, True)
    y = y.reshape(b, s, hkv, hd)
    lo, hi = Sh.model_range(n)
    if Sh.straddles(n, hkv, m):
        index = torch.arange(lo, hi, device=y.device) // (n // hkv)
        return y.index_select(2, index)
    glo, ghi = Sh.groups_read(lo, hi, n, hkv)
    return y[:, :, glo:ghi].contiguous()


def gqa_apply(params, x, cfg, *, positions, mode, cache=None, lengths=None,
              window=None, memory=None, causal=True, target=None):
    """x:(B,S,d).  mode in train|prefill|decode.  ``memory``: the (k, v)
    of a cross-attention, each (B, F, Hkv, hd); the cache is then returned
    as it came.  ``target`` pins the attention lowering selection to an
    explicit machine model."""
    hd = cfg.head_dim
    # this rank's heads: all of them without a 'model' split, else its
    # chunk of them, which may be short or empty; wq's columns and wo's
    # rows for them
    lo, hi = Sh.model_range(cfg.n_heads)
    h = hi - lo
    wq = Sh.heads_of(params["wq"], -1, cfg.n_heads, hd)
    wo = Sh.heads_of(params["wo"], 0, cfg.n_heads, hd)
    # (a sequence-parallel stream's chunks gathered whole)
    x = Sh.enter_model(x)
    b, s, _ = x.shape
    q = L.linear(wq, x).reshape(b, s, h, hd)
    if memory is None:
        k = kv_proj(params["wk"], x, cfg)
        v = kv_proj(params["wv"], x, cfg)
    else:
        k, v = memory
    if cfg.qk_norm:
        q = _norm_leaf(params["qn"], q)
        if memory is None:
            k = _norm_leaf(params["kn"], k)
    if cfg.rope_theta and memory is None:
        q = L.rope_apply(q, positions, cfg.rope_theta)
        k = L.rope_apply(k, positions, cfg.rope_theta)

    if memory is not None:
        out = ops.attention(q, k, v, causal=False, softcap=cfg.softcap,
                            target=target)
        return L.linear_rp(wo, out.reshape(b, s, h * hd), cfg), cache

    if mode == "train":
        out = ops.attention(q, k, v, causal=causal, window=window,
                            softcap=cfg.softcap, target=target)
        return L.linear_rp(wo, out.reshape(b, s, h * hd), cfg), cache

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
        return L.linear_rp(wo, out.reshape(b, s, h * hd), cfg), cache

    # decode: s == 1, write at pos = lengths (per row), attend valid prefix
    slots = cache["k"].shape[1]
    slot = (lengths % slots) if window else lengths
    bidx = torch.arange(b, device=x.device)
    cache["k"][bidx, slot] = k[:, 0]
    cache["v"][bidx, slot] = v[:, 0]
    valid = torch.clamp(lengths + 1, max=slots)
    out = ops.decode_attention(q, cache["k"], cache["v"], valid,
                               softcap=cfg.softcap, target=target)
    return L.linear_rp(wo, out.reshape(b, s, h * hd), cfg), cache


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention)
# ---------------------------------------------------------------------------

def mla_init(gen, cfg, device, d_in=None):
    d = d_in or cfg.d_model
    dt = L.dtype_of(cfg)
    h = cfg.n_heads
    r, nd, vd = cfg.qk_rope_dim, cfg.qk_nope_dim, cfg.v_head_dim
    p = {
        "w_dkv": L.dense_init(gen, d, cfg.kv_lora_rank + r, dt, device),
        "kv_norm": L.norm_init(cfg.kv_lora_rank, "rmsnorm", device),
        "w_uk": L.dense_init(gen, cfg.kv_lora_rank, h * nd, dt, device),
        "w_uv": L.dense_init(gen, cfg.kv_lora_rank, h * vd, dt, device),
        "wo": L.dense_init(gen, h * vd, cfg.d_model, dt, device),
    }
    if cfg.q_lora_rank:
        p["w_dq"] = L.dense_init(gen, d, cfg.q_lora_rank, dt, device)
        p["q_norm"] = L.norm_init(cfg.q_lora_rank, "rmsnorm", device)
        p["w_uq"] = L.dense_init(gen, cfg.q_lora_rank, h * (nd + r), dt,
                                 device)
    else:
        p["wq"] = L.dense_init(gen, d, h * (nd + r), dt, device)
    return p


def mla_cache_init(cfg, batch, s_max, device, dtype=None):
    dt = dtype or L.dtype_of(cfg)
    return {"c_kv": torch.zeros((batch, s_max, cfg.kv_lora_rank), dtype=dt,
                                device=device),
            "k_rope": torch.zeros((batch, s_max, cfg.qk_rope_dim), dtype=dt,
                                  device=device)}


def _mla_q(params, x, cfg, positions):
    """(q_nope, q_rope) of this rank's heads; the q input enters the model
    region at the column-parallel up-projection (or ``wq``)."""
    r, nd = cfg.qk_rope_dim, cfg.qk_nope_dim
    if cfg.q_lora_rank:
        cq = L.norm_apply(params["q_norm"], L.linear(params["w_dq"], x))
        w, x = params["w_uq"], cq
    else:
        w = params["wq"]
    q = L.linear(Sh.heads_of(w, -1, cfg.n_heads, nd + r), Sh.enter_model(x))
    b, s = q.shape[:2]
    q = q.reshape(b, s, q.shape[-1] // (nd + r), nd + r)
    q_nope, q_rope = q[..., :nd], q[..., nd:]
    q_rope = L.rope_apply(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def _mla_ckv(params, x, cfg, positions):
    """(c_kv, k_rope) from the replicated down-projection, entered into
    the model region (whole along the sequence) before the rope."""
    dkv = L.linear(params["w_dkv"], x)
    c_kv = Sh.enter_model(L.norm_apply(params["kv_norm"],
                                       dkv[..., :cfg.kv_lora_rank]))
    k_rope = Sh.enter_model(dkv[..., cfg.kv_lora_rank:])
    k_rope = L.rope_apply(k_rope[:, :, None, :], positions,
                          cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


def mla_apply(params, x, cfg, *, positions, mode, cache=None, lengths=None,
              target=None):
    """x:(B,S,d).  mode in train|prefill|decode.  MLA takes no window (the
    reference ignores one; no MLA config has one)."""
    r, nd, vd = cfg.qk_rope_dim, cfg.qk_nope_dim, cfg.v_head_dim
    # this rank's heads (all of them without a 'model' split) and its
    # w_uk / w_uv columns and wo rows for them
    lo, hi = Sh.model_range(cfg.n_heads)
    h = hi - lo
    params = {**params, "w_uk": Sh.heads_of(params["w_uk"], -1, cfg.n_heads,
                                            nd),
              "w_uv": Sh.heads_of(params["w_uv"], -1, cfg.n_heads, vd),
              "wo": Sh.heads_of(params["wo"], 0, cfg.n_heads, vd)}
    scale = 1.0 / math.sqrt(nd + r)
    q_nope, q_rope = _mla_q(params, x, cfg, positions)
    b, s = q_nope.shape[:2]

    if mode in ("train", "prefill"):
        c_kv, k_rope = _mla_ckv(params, x, cfg, positions)
        k_nope = L.linear(params["w_uk"], c_kv).reshape(b, s, h, nd)
        v = L.linear(params["w_uv"], c_kv).reshape(b, s, h, vd)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, r)],
                      dim=-1)
        out = ops.attention(q, k, v, causal=True, scale=scale,
                            target=target)
        if mode == "prefill":
            cache["c_kv"][:, :s] = c_kv
            cache["k_rope"][:, :s] = k_rope
        return L.linear_rp(params["wo"], out.reshape(b, s, h * vd), cfg), \
            cache

    # decode: absorbed attention over the compressed cache
    c_kv_new, k_rope_new = _mla_ckv(params, x, cfg, positions)
    bidx = torch.arange(b, device=x.device)
    cache["c_kv"][bidx, lengths] = c_kv_new[:, 0]
    cache["k_rope"][bidx, lengths] = k_rope_new[:, 0]
    out = _mla_absorbed(params, q_nope, q_rope, cache, lengths, cfg, scale)
    out = out.to(x.dtype).reshape(b, s, h * vd)
    return L.linear_rp(params["wo"], out, cfg), cache


def _mla_absorbed(params, q_nope, q_rope, cache, lengths, cfg, scale):
    """The absorbed decode attention, in float32: q into W_uk, the
    compressed cache attended up to each row's ``lengths`` (inclusive),
    out through W_uv -> (B, 1, H, v_head_dim)."""
    nd, vd = cfg.qk_nope_dim, cfg.v_head_dim
    h = q_nope.shape[2]
    c_kv = cache["c_kv"].to(torch.float32)
    k_rope = cache["k_rope"].to(torch.float32)
    w_uk = params["w_uk"].reshape(cfg.kv_lora_rank, h, nd)
    # absorb: q_eff[h] = q_nope[h] @ W_uk[:, h, :].T  -> kv_lora dims
    q_eff = torch.einsum("bqhn,rhn->bqhr", q_nope.to(torch.float32),
                         w_uk.to(torch.float32))
    logits = (torch.einsum("bqhr,bkr->bhqk", q_eff, c_kv) +
              torch.einsum("bqhr,bkr->bhqk", q_rope.to(torch.float32),
                           k_rope)) * scale
    kpos = torch.arange(c_kv.shape[1], device=c_kv.device)
    logits = torch.where(kpos[None, None, None, :]
                         <= lengths[:, None, None, None], logits, -1e30)
    p_attn = torch.softmax(logits, dim=-1)
    ctx = torch.einsum("bhqk,bkr->bqhr", p_attn, c_kv)
    w_uv = params["w_uv"].reshape(cfg.kv_lora_rank, h, vd)
    return torch.einsum("bqhr,rhv->bqhv", ctx, w_uv.to(torch.float32))
