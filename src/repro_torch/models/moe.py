"""Mixture-of-Experts with capacity-bounded dispatch.

Dispatch is one-hot/cumsum based (no data-dependent shapes), as the
reference's:
  1. router top-k per token (fp32), the k gates renormalised,
  2. position-in-expert via exclusive cumsum over the (T*k, E) one-hot,
  3. scatter into an (E, C, d) buffer; a choice past its expert's
     capacity C is dropped,
  4. per-expert gated MLP as batched (E, C, d) x (E, d, f) products,
  5. gather back and combine with the gate weights.

The reference drops a choice with ``.at[...].set(mode="drop")`` at the
out-of-range slot C and reads it back with ``mode="fill"``.  On the card
an out-of-range ``index_put`` is a device-side assert that leaves the
CUDA context unusable, so here the buffer has a spare row C that takes
the dropped choices (zeros), is cut off before the expert products and
comes back as a zero row for the gather.  The expert products are plain
batched matrix products, as the reference leaves its einsums to XLA
outside any Pallas kernel; the experts' activation goes through
:func:`layers.act_apply` (``ops.vsigmoid`` for silu).

Under an active mesh (``models/sharding.py``) the reference's
``shard_map`` branch: each rank dispatches its own rows' tokens (the
capacity taken per data shard, ``t // n_b`` of the reference's global
``t``) to its ``e_local`` experts, from ``r * e_local`` on its 'model'
index r, and one all-reduce over 'model' combines the partial outputs.
The tokens and gates enter the model region through
``sharding.enter_model``, so that the router's gradient sums every
rank's experts.  The router itself sees the global batch in the
reference (GSPMD): its load-balance statistics are summed over the
batch axes' ranks before the aux loss is formed.  Under sequence
parallelism each rank routes its chunk of the stream (its router
gradient its chunk's, summed over 'model' by the block's
``sharding.layer_params``), the
statistics are summed over the chunks too, and the tokens, gates and
indices are gathered along the sequence before they are flattened, so
that each rank dispatches its data shard's whole sequences with the
reference's capacity and slot order; the combine reduce-scatters back
into the chunk.
"""
from __future__ import annotations

import torch

from ..core.vtypes import round_up
from . import layers as L
from . import sharding as Sh


def moe_init(gen, cfg, device):
    dt = L.dtype_of(cfg)
    d, f, e = cfg.d_model, cfg.d_expert, cfg.n_experts
    p = {
        "router": L.normal(gen, (d, e), 0.02, torch.float32, device),
        "we_g": L.normal(gen, (e, d, f), d ** -0.5, dt, device),
        "we_u": L.normal(gen, (e, d, f), d ** -0.5, dt, device),
        "we_d": L.normal(gen, (e, f, d), f ** -0.5, dt, device),
    }
    if cfg.n_shared_experts:
        p["shared"] = L.mlp_init(gen, cfg, device,
                                 d_ff=cfg.n_shared_experts * cfg.d_expert)
    return p


def capacity(cfg, n_tokens: int) -> int:
    c = int(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, round_up(c, 8))


def _route(params, xt, cfg):
    """Router: (gates, idx, aux) in fp32.  xt:(T, d)."""
    e, k = cfg.n_experts, cfg.top_k
    logits = xt.to(torch.float32) @ params["router"]              # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)                     # (T, k)
    gates = gates / gates.sum(dim=-1, keepdim=True)
    # (over a sequence-parallel stream's every chunk)
    me = Sh.stream_mean(probs)
    ce = Sh.stream_mean(torch.nn.functional.one_hot(idx[:, 0], e)
                        .to(torch.float32))
    # the means over every rank's rows (no-ops without a mesh)
    n_b = Sh.batch_split(Sh.current_mesh())
    me = Sh.sum_over_batch(me) / n_b
    ce = Sh.sum_over_batch(ce) / n_b
    aux = e * torch.sum(me * ce)                # Switch-style load balance
    return gates, idx, aux


def _slots(idx, cap, e_lo, e_local):
    """Each (token, choice)'s expert among [e_lo, e_lo+e_local) (0 where
    it is another's), its row in that expert's buffer (the spare row
    ``cap`` where it is dropped) and whether it is kept: flattened token
    by token, (T*k,) each."""
    e_flat = idx.reshape(-1).long() - e_lo
    mine = (e_flat >= 0) & (e_flat < e_local)
    e_loc = torch.where(mine, e_flat, 0)
    # the one-hot expert-major, (E, T*k), so that the cumsum runs along
    # its contiguous axis: on the card the scan along the outer axis of a
    # (T*k, E) one-hot took 2.8 ms a layer at T*k = 16384
    experts = torch.arange(e_local, device=idx.device)[:, None]
    onehot = ((experts == e_loc) & mine).to(torch.int32)
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot  # exclusive
    pos_flat = pos.gather(0, e_loc[None, :])[0]
    keep = mine & (pos_flat < cap)
    return e_loc, torch.where(keep, pos_flat, cap).long(), keep


def _dispatch_compute(params, xt, gates, idx, cfg, cap, e_lo, e_local):
    """Capacity dispatch + expert MLP for experts [e_lo, e_lo+e_local).

    Returns the (T, d) output; choices that land on other experts, or past
    an expert's capacity, contribute 0.
    """
    t, d = xt.shape
    k = cfg.top_k
    e_loc, pos_flat, keep = _slots(idx, cap, e_lo, e_local)
    x_rep = torch.repeat_interleave(xt, k, dim=0)                 # (T*k, d)
    buf = torch.zeros((e_local, cap + 1, d), dtype=xt.dtype,
                      device=xt.device)
    buf[e_loc, pos_flat] = torch.where(keep[:, None], x_rep, 0)
    buf = buf[:, :cap]

    h_g = torch.bmm(buf, params["we_g"])
    h_u = torch.bmm(buf, params["we_u"])
    h = L.act_apply(h_g, cfg.act) * h_u
    y_buf = torch.bmm(h, params["we_d"])
    y_buf = torch.cat([y_buf, y_buf.new_zeros((e_local, 1, d))], dim=1)

    y_flat = y_buf[e_loc, pos_flat]
    w = (gates.reshape(-1) * keep.to(torch.float32)).to(xt.dtype)
    return (y_flat * w[:, None]).reshape(t, k, d).sum(dim=1)


def moe_apply(params, x, cfg):
    """x:(B, S, d) -> (y, aux_loss); under a mesh x is this rank's rows
    (under sequence parallelism, its chunk of their sequence) and the
    expert weights its 'model' shard."""
    b, s, d = x.shape
    gates, idx, aux = _route(params, x.reshape(b * s, d), cfg)
    k = idx.shape[-1]
    r, n_m = Sh.model_split()
    e_local = cfg.n_experts // n_m
    # the rows' whole sequences (a sequence-parallel stream's chunks
    # gathered before flattening, so that the tokens and their capacity
    # slots come in the reference's order)
    xs = Sh.enter_model(x)
    t = b * xs.shape[1]
    gates = Sh.enter_model(gates.reshape(b, s, k)).reshape(t, k)
    idx = Sh.stream_gather(idx.reshape(b, s, k)).reshape(t, k)
    y = _dispatch_compute(params, xs.reshape(t, d), gates, idx, cfg,
                          capacity(cfg, t), r * e_local, e_local)
    y = Sh.leave_model(y.reshape(b, -1, d))
    if cfg.n_shared_experts:
        y = y + L.mlp_apply(params["shared"], x, cfg)
    return y, aux
