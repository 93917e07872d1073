"""Mamba2 block (SSD core through the kernel ladder) + recurrent decode.

Train and prefill run the chunked SSD lowering (``kernels/ssd.py``
customized, ``ref.ssd`` vector tier).  Decode keeps {conv window,
(h, p, n) SSM state} as the cache and applies the recurrence in closed
form, in plain tensor code, as the prefill's final state is.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops
from . import layers as L


def mamba_init(gen, cfg, device):
    dt = L.dtype_of(cfg)
    d, di = cfg.d_model, cfg.d_inner
    g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * g * n
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w_in": L.dense_init(gen, d, 2 * di + 2 * g * n + h, dt, device),
        "conv_w": L.normal(gen, (cfg.ssm_conv, conv_dim), 0.2, dt, device),
        "conv_b": torch.zeros((conv_dim,), dtype=dt, device=device),
        "A_log": torch.log(torch.arange(1, h + 1, **f32)),
        "D": torch.ones((h,), **f32),
        "dt_bias": torch.zeros((h,), **f32),
        "gn": L.norm_init(di, "rmsnorm", device),
        "w_out": L.dense_init(gen, di, d, dt, device),
    }


def mamba_cache_init(cfg, batch, device, dtype=None):
    dt = dtype or L.dtype_of(cfg)
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dt,
                            device=device),
        "state": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_headdim,
                              cfg.ssm_state), dtype=torch.float32,
                             device=device),
    }


def _split(zxbcdt, cfg):
    di, g, n = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * g * n]
    dt = zxbcdt[..., di + di + 2 * g * n:]
    return z, xbc, dt


def _causal_conv(xbc, w, b, history=None):
    """Depthwise causal conv width K via shifted adds.  xbc:(B,S,C)."""
    bsz, s, c = xbc.shape
    k = w.shape[0]
    if history is None:
        history = torch.zeros((bsz, k - 1, c), dtype=xbc.dtype,
                              device=xbc.device)
    padded = torch.cat([history, xbc], dim=1)                 # (B, S+K-1, C)
    out = torch.zeros((bsz, s, c), dtype=torch.float32, device=xbc.device)
    for i in range(k):
        out = out + padded[:, i:i + s].to(torch.float32) * \
            w[i].to(torch.float32)
    out = out + b.to(torch.float32)
    new_hist = padded[:, -(k - 1):] if k > 1 else history
    return out.to(xbc.dtype), new_hist


def _silu(t):
    tf = t.to(torch.float32)
    return (tf * torch.sigmoid(tf)).to(t.dtype)


def mamba_apply(params, x, cfg, *, mode, cache=None, target=None):
    """x:(B, S, d) -> (y, cache).  ``target`` pins the ssd lowering
    selection to an explicit machine model."""
    bsz, s, d = x.shape
    di, g, n, h, p = (cfg.d_inner, cfg.ssm_groups, cfg.ssm_state,
                      cfg.ssm_heads, cfg.ssm_headdim)
    rep = h // g
    zxbcdt = L.linear(params["w_in"], x)
    z, xbc, dt_raw = _split(zxbcdt, cfg)
    A = -torch.exp(params["A_log"])
    dt = F.softplus(dt_raw.to(torch.float32) + params["dt_bias"])

    if mode == "decode":
        # recurrent step (s == 1)
        xbc_conv, hist = _causal_conv(xbc, params["conv_w"],
                                      params["conv_b"], history=cache["conv"])
        xbc_conv = _silu(xbc_conv)
        xs = xbc_conv[..., :di].reshape(bsz, 1, h, p)
        B = xbc_conv[..., di:di + g * n].reshape(bsz, 1, g, n)
        C = xbc_conv[..., di + g * n:].reshape(bsz, 1, g, n)
        Bh = torch.repeat_interleave(B, rep, dim=2)[:, 0].to(torch.float32)
        Ch = torch.repeat_interleave(C, rep, dim=2)[:, 0].to(torch.float32)
        dt0 = dt[:, 0]                                            # (B,h)
        x0 = xs[:, 0].to(torch.float32)
        dA = torch.exp(dt0 * A[None, :])
        state = cache["state"] * dA[..., None, None] + \
            (dt0[..., None] * x0)[..., None] * Bh[:, :, None, :]
        y = torch.einsum("bhpn,bhn->bhp", state, Ch) + \
            params["D"][None, :, None] * x0
        y = y.reshape(bsz, 1, di).to(x.dtype)
        cache = {"conv": hist, "state": state}
    else:
        xbc_conv, hist = _causal_conv(xbc, params["conv_w"],
                                      params["conv_b"])
        xbc_conv = _silu(xbc_conv)
        xs = xbc_conv[..., :di].reshape(bsz, s, h, p)
        B = xbc_conv[..., di:di + g * n].reshape(bsz, s, g, n)
        C = xbc_conv[..., di + g * n:].reshape(bsz, s, g, n)
        y = ops.ssd(xs, dt, A, B, C, params["D"], chunk=cfg.ssm_chunk,
                    target=target)
        y = y.reshape(bsz, s, di)
        if mode == "prefill":
            # closed-form final state for the decode cache:
            # S_final = sum_j exp(la_S - la_j) dt_j x_j (x) B_j
            Bh = torch.repeat_interleave(B, rep, dim=2).to(torch.float32)
            la = torch.cumsum(dt * A[None, None, :], dim=1)        # (B,s,h)
            wj = torch.exp(la[:, -1:, :] - la) * dt
            state = torch.einsum("bshp,bshn->bhpn",
                                 xs.to(torch.float32) * wj[..., None], Bh)
            cache = {"conv": hist, "state": state}

    gated = (y.to(torch.float32) * torch.sigmoid(z.to(torch.float32))) \
        .to(x.dtype)
    y = L.norm_apply(params["gn"], gated)
    return L.linear_rp(params["w_out"], y, cfg), cache

