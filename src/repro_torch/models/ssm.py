"""Mamba2 block (SSD core through the kernel ladder) + recurrent decode.

Train and prefill run the chunked SSD lowering (``kernels/ssd.py``
customized, ``ref.ssd`` vector tier).  Decode keeps {conv window,
(h, p, n) SSM state} as the cache and applies the recurrence in closed
form, in plain tensor code, as the prefill's final state is.

Under a 'model' split (``models/sharding.py``) each rank runs its share
of the SSM heads, ``ssm_heads / model`` of them, and the groups they
read (head j reads group j // (ssm_heads / ssm_groups)).  Where some
rank's heads straddle groups unevenly (``sharding.straddles``: 6 heads
in 3 groups on 2 ranks, rank 0's heads 0, 1, 2 reading groups 0, 0, 1),
every rank's B and C are gathered to one group a head (backward, each
head's gradient summed onto its group), and ssd and the state run with
as many groups as heads.  ``w_in``'s and the conv's stored shards are
contiguous cuts across the ``[z | x | B | C | dt]`` sections, so the
block gathers ``w_in``, ``conv_w`` and ``conv_b`` whole over 'model'
once a call (backward, the gradient summed over 'model' and this rank's
chunk kept) and takes this rank's columns of them: one gemm of the
rank's width and no activation gather.  ``A_log``, ``D``, ``dt_bias``
and the gated norm's weight are replicated and sliced to the rank's
heads after ``sharding.model_leaf`` (backward, the sliced gradients
summed over 'model').  The gated norm's sum of squares over all of
``d_inner`` is summed over 'model' (``sharding.sum_over_model``,
float32), ssd runs on the local heads and groups, and ``w_out``'s
head-aligned row cut sums through ``linear_rp``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops
from . import layers as L
from . import sharding as Sh


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


def _split(zxbcdt, di, g, n):
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * g * n]
    dt = zxbcdt[..., di + di + 2 * g * n:]
    return z, xbc, dt


def _span(lo, hi, device):
    return torch.arange(lo, hi, device=device)


def head_groups(lo, hi, glo, ghi, per, device):
    """The group of each of heads [lo, hi), as an index into the groups
    [glo, ghi) they read: head j reads group j // ``per``."""
    return torch.arange(lo, hi, device=device) // per - glo


def _local(params, cfg):
    """(this rank's weights, d_inner, groups, heads, group of each head):
    the params and the config's widths without a 'model' split; under
    one, the rank's heads [lo, hi) and the groups [glo, ghi) they read,
    with ``w_in``'s and the conv's columns for them out of the gathered
    leaves and the replicated leaves sliced to them.  The last is None
    but where the rank's heads straddle groups (``sharding.straddles``):
    then each local head's index into the rank's groups
    (:func:`head_groups`)."""
    di, g, n, h, p = (cfg.d_inner, cfg.ssm_groups, cfg.ssm_state,
                      cfg.ssm_heads, cfg.ssm_headdim)
    _, m = Sh.model_split()
    if m == 1:
        return params, di, g, h, None
    lo, hi = Sh.model_range(h)
    glo, ghi = Sh.groups_read(lo, hi, h, g)
    dev = params["w_in"].device
    # the conv's channels [x | B | C], then w_in's [z | xBC | dt]
    ch = torch.cat([_span(lo * p, hi * p, dev),
                    _span(di + glo * n, di + ghi * n, dev),
                    _span(di + (g + glo) * n, di + (g + ghi) * n, dev)])
    cols = torch.cat([_span(lo * p, hi * p, dev), di + ch,
                      _span(2 * di + 2 * g * n + lo, 2 * di + 2 * g * n + hi,
                            dev)])
    conv_dim = di + 2 * g * n
    w_in = Sh.gather_model(params["w_in"], -1, conv_dim + di + h, True)
    local = {
        "w_in": w_in.index_select(1, cols),
        "conv_w": Sh.gather_model(params["conv_w"], -1, conv_dim, True)
        .index_select(1, ch),
        "conv_b": Sh.gather_model(params["conv_b"], 0, conv_dim, True)
        .index_select(0, ch),
        "gn": {"w": Sh.model_leaf(params["gn"]["w"])[lo * p:hi * p]},
        "w_out": params["w_out"],
    }
    for k in ("A_log", "D", "dt_bias"):
        local[k] = Sh.model_leaf(params[k])[lo:hi]
    index = head_groups(lo, hi, glo, ghi, h // g, dev) \
        if Sh.straddles(h, g, m) else None
    return local, (hi - lo) * p, ghi - glo, hi - lo, index


def _gated_norm(w, gated, di, eps=1e-6):
    """The RMSNorm of ``gated`` over all ``di`` channels of d_inner, this
    rank holding its heads' channels: the float32 sum of squares summed
    over 'model'."""
    xf = gated.to(torch.float32)
    ms = Sh.sum_over_model(xf.square().sum(-1, keepdim=True)) / di
    return (xf * torch.rsqrt(ms + eps) * w).to(gated.dtype)


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


def _per_head(t, index):
    """``t`` (B, S, groups, n) as one group a head, (B, S, heads, n), where
    ``index`` gives each head's group (backward, the heads' gradients
    summed onto their group); ``t`` where it is None."""
    return t if index is None else t.index_select(2, index)


def _silu(t):
    tf = t.to(torch.float32)
    return (tf * torch.sigmoid(tf)).to(t.dtype)


def mamba_apply(params, x, cfg, *, mode, cache=None, target=None):
    """x:(B, S, d) -> (y, cache).  ``target`` pins the ssd lowering
    selection to an explicit machine model."""
    # (a sequence-parallel stream's chunks gathered whole)
    x = Sh.enter_model(x)
    bsz, s, d = x.shape
    n, p = cfg.ssm_state, cfg.ssm_headdim
    params, di, g, h, index = _local(params, cfg)
    # heads a group as ssd and the state read B and C: one where they
    # come one group a head
    rep = h // g if index is None else 1
    zxbcdt = L.linear(params["w_in"], x)
    z, xbc, dt_raw = _split(zxbcdt, di, g, n)
    A = -torch.exp(params["A_log"])
    dt = F.softplus(dt_raw.to(torch.float32) + params["dt_bias"])

    if mode == "decode":
        # recurrent step (s == 1)
        xbc_conv, hist = _causal_conv(xbc, params["conv_w"],
                                      params["conv_b"], history=cache["conv"])
        xbc_conv = _silu(xbc_conv)
        xs = xbc_conv[..., :di].reshape(bsz, 1, h, p)
        B = _per_head(xbc_conv[..., di:di + g * n].reshape(bsz, 1, g, n),
                      index)
        C = _per_head(xbc_conv[..., di + g * n:].reshape(bsz, 1, g, n),
                      index)
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
        B = _per_head(xbc_conv[..., di:di + g * n].reshape(bsz, s, g, n),
                      index)
        C = _per_head(xbc_conv[..., di + g * n:].reshape(bsz, s, g, n),
                      index)
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
    y = _gated_norm(params["gn"]["w"], gated, cfg.d_inner)
    return L.linear_rp(params["w_out"], y, cfg), cache

