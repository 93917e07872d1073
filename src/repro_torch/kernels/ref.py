"""Plain torch oracles — the paper's "original SIMDe" tier.

Each function is the straightforward whole-tensor translation a generic
portability layer produces: op-by-op, no fusion, fp32 math.  They serve
two roles:

  1. correctness oracle for the customized kernels,
  2. the *baseline* side of the paper's Figure-2 comparison (the
     registry's vector tier costs them by walking their aten graphs).

Layouts are the reference's: NHWC activations, HWIO conv weights,
(Kh, Kw, C) depthwise weights, (H, W, C) ibilinear images, (B, S, H, D)
attention operands, (b, s, h, p) SSD inputs.  The torch calls that want
NCHW / OIHW get permuted views.  The reference's ``lax.scan`` loops
(chunked attention, the SSD scans) are Python loops here.

The cost walk must give the reference's numbers (``BENCH_xnnpack.json``)
from these graphs — equal numbers, not equal graphs.  Two oracles are
written so that their aten graphs hold the nodes jnp's lowering emits:

  * ``argmaxpool``: jnp lowers each strided window slice
    ``x[:, i::sh, j::sw]`` to a gather with its own index arithmetic
    (an iota, a multiply and an add per axis, and the concatenation of
    the index pair).  Torch strided slicing is a free view, so the
    oracle builds the same indices with ``arange``/``mul``/``add``/
    ``cat`` and gathers with them; the values are those of the slices.
  * ``ibilinear``: jnp's ``img[iy, ix]`` wraps negative indices (``lt``,
    ``add``, ``select_n`` per index array) and concatenates the index
    pair before its gather; ``aten.index`` does neither, so ``_take``
    writes them out.  Both are harmless to the result for in-range
    indices.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# 1. gemm — XNNPACK f32-gemm with minmax (bias + clamp) epilogue
# ---------------------------------------------------------------------------

def gemm(a, b, bias=None, clamp_min=float("-inf"), clamp_max=float("inf")):
    """C = clamp(A @ B + bias).  a:(M,K) b:(K,N) bias:(N,)."""
    out = a.to(torch.float32) @ b.to(torch.float32)
    if bias is not None:
        out = out + bias.to(torch.float32)
    # two-sided, as jnp.clip: max then min, a NaN passes through
    out = torch.clamp(out, clamp_min, clamp_max)
    return out.to(a.dtype)


# ---------------------------------------------------------------------------
# 2. conv_hwc — direct conv, NHWC input, HWIO weights, VALID padding
# ---------------------------------------------------------------------------

def conv_hwc(x, w, bias=None, stride=(1, 1)):
    """x:(N,H,W,Ci) w:(Kh,Kw,Ci,Co) -> (N,Ho,Wo,Co)."""
    out = F.conv2d(x.to(torch.float32).permute(0, 3, 1, 2),
                   w.to(torch.float32).permute(3, 2, 0, 1),
                   stride=tuple(stride)).permute(0, 2, 3, 1)
    # the bias is a separate add, as in the reference (not conv2d's own
    # bias): the unfused byte count reads and writes the output again
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# 3. dwconv — depthwise conv, per-channel kernels, VALID padding
# ---------------------------------------------------------------------------

def dwconv(x, w, bias=None, stride=(1, 1)):
    """x:(N,H,W,C) w:(Kh,Kw,C) -> (N,Ho,Wo,C)."""
    kh, kw, c = w.shape
    out = F.conv2d(x.to(torch.float32).permute(0, 3, 1, 2),
                   w.to(torch.float32).reshape(kh, kw, 1, c)
                   .permute(3, 2, 0, 1),
                   stride=tuple(stride), groups=c).permute(0, 2, 3, 1)
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# 4/5. maxpool / argmaxpool
# ---------------------------------------------------------------------------

def maxpool(x, window=(2, 2), stride=None):
    """x:(N,H,W,C), VALID padding; NaN propagates."""
    stride = stride or window
    return F.max_pool2d(x.permute(0, 3, 1, 2), tuple(window),
                        tuple(stride)).permute(0, 2, 3, 1)


def argmaxpool(x, window=(2, 2), stride=None):
    """Returns (max, flat-window-index-of-max).  x:(N,H,W,C)."""
    stride = stride or window
    n, h, w, c = x.shape
    kh, kw = window
    sh, sw = stride
    oh = (h - kh) // sh + 1
    ow = (w - kw) // sw + 1
    cols = []
    for i in range(kh):
        for j in range(kw):
            # the window slice x[:, i::sh, j::sw] as jnp gathers it
            rows = torch.arange(oh, dtype=torch.int32, device=x.device) \
                * sh + i
            cs = torch.arange(ow, dtype=torch.int32, device=x.device) \
                * sw + j
            idx = torch.cat([rows[:, None, None].expand(oh, ow, 1),
                             cs[None, :, None].expand(oh, ow, 1)], dim=-1)
            cols.append(x[:, idx[..., 0], idx[..., 1], :])
    stack = torch.stack(cols, dim=-1)         # (N,oh,ow,C,kh*kw)
    idx = torch.argmax(stack, dim=-1)
    mx = torch.amax(stack, dim=-1)
    return mx, idx.to(torch.int32)


# ---------------------------------------------------------------------------
# 6-9. elementwise: vrelu (clamp), vsqrt, vtanh, vsigmoid
# ---------------------------------------------------------------------------

def vrelu(x, clamp_min=0.0, clamp_max=float("inf")):
    """XNNPACK vrelu is a minmax clamp."""
    return torch.clamp(x, clamp_min, clamp_max)


def vsqrt(x):
    return torch.sqrt(x.to(torch.float32)).to(x.dtype)


def vtanh(x):
    return torch.tanh(x.to(torch.float32)).to(x.dtype)


def vsigmoid(x):
    return torch.sigmoid(x.to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# 10. ibilinear — bilinear interpolation with precomputed corners+weights
# ---------------------------------------------------------------------------

def _take(img, iy, ix):
    """``img[iy, ix]`` as jnp lowers it: negative indices wrap, the index
    pair is concatenated, then one gather."""
    h, w = img.shape[:2]
    iy = torch.where(iy < 0, iy + h, iy)
    ix = torch.where(ix < 0, ix + w, ix)
    idx = torch.cat([iy[:, None], ix[:, None]], dim=1)
    return img[idx[:, 0], idx[:, 1]]


def ibilinear(img, iy, ix, wy, wx):
    """XNNPACK-style ibilinear.

    img:(H,W,C); iy,ix:(P,) int32 top-left corner per output pixel;
    wy,wx:(P,) fractional weights.  Returns (P,C).
    """
    tl = _take(img, iy, ix).to(torch.float32)
    tr = _take(img, iy, ix + 1).to(torch.float32)
    bl = _take(img, iy + 1, ix).to(torch.float32)
    br = _take(img, iy + 1, ix + 1).to(torch.float32)
    wy = wy[:, None].to(torch.float32)
    wx = wx[:, None].to(torch.float32)
    top = tl * (1 - wx) + tr * wx
    bot = bl * (1 - wx) + br * wx
    return (top * (1 - wy) + bot * wy).to(img.dtype)


# ---------------------------------------------------------------------------
# LM hot spots: attention, decode attention, Mamba2 SSD
# ---------------------------------------------------------------------------

NEG = -1e30


def attention(q, k, v, *, causal=True, window=None, softcap=None, scale=None,
              kv_len_valid=None):
    """Reference multi-head attention.

    q:(B,Sq,H,D) k,v:(B,Sk,Hkv,D) with H a multiple of Hkv (GQA).
    window: sliding-window size (None = full); softcap: gemma2 logit cap.
    kv_len_valid: mask out kv positions >= this (decode with static cache).
    """
    b, sq, h, d = q.shape
    _, sk, hkv, _ = k.shape
    dv = v.shape[-1]                 # value head dim may differ (MLA)
    group = h // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qf = q.to(torch.float32).reshape(b, sq, hkv, group, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf,
                          k.to(torch.float32)) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    mask = _attn_mask(sq, sk, causal, window, q.device)
    if kv_len_valid is not None:
        mask = mask & (torch.arange(sk, device=q.device)[None, :]
                       < kv_len_valid)
    logits = torch.where(mask, logits, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)  # fully-masked rows
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(torch.float32))
    return out.reshape(b, sq, h, dv).to(q.dtype)


def _attn_mask(sq, sk, causal, window, device):
    """(sq, sk) bool mask; query i sits at absolute position i + sk - sq."""
    qpos = torch.arange(sq, device=device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (qpos >= kpos)
    if window is not None:
        mask = mask & (qpos - kpos < window)
    return mask


def attention_chunked(q, k, v, *, causal=True, window=None, softcap=None,
                      scale=None, q_chunk=512):
    """Online-softmax attention over q chunks (the reference's lax.scan
    becomes a Python loop): never materializes the whole (Sq, Sk) logits.
    The vector-tier lowering for long sequences."""
    b, sq, h, d = q.shape
    _, sk, hkv, _ = k.shape
    dv = v.shape[-1]
    group = h // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qc = min(q_chunk, sq)
    pad = (-sq) % qc
    qp = F.pad(q, (0, 0, 0, 0, 0, pad)) if pad else q
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    kpos = torch.arange(sk, device=q.device)[None, :]
    outs = []
    # split, not slices: autograd then joins the chunks' gradients once,
    # where a slice's backward fills a whole zero tensor for each chunk
    for ci, qchunk in enumerate(qp.split(qc, dim=1)):
        qf = qchunk.to(torch.float32).reshape(b, qc, hkv, group, d)
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale
        if softcap is not None:
            logits = softcap * torch.tanh(logits / softcap)
        qpos = (ci * qc + torch.arange(qc, device=q.device)
                + (sk - sq))[:, None]
        mask = torch.ones((qc, sk), dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (qpos >= kpos)
        if window is not None:
            mask = mask & (qpos - kpos < window)
        logits = torch.where(mask, logits, NEG)
        m = torch.amax(logits, dim=-1, keepdim=True)
        p = torch.where(mask, torch.exp(logits - m), 0.0)
        l = torch.sum(p, dim=-1, keepdim=True)
        o = torch.einsum("bhgqk,bkhd->bqhgd", p / torch.clamp(l, min=1e-30),
                         vf)
        outs.append(o.reshape(b, qc, h, dv))
    return torch.cat(outs, dim=1)[:, :sq].to(q.dtype)


def decode_attention(q, k, v, lengths, window=None, softcap=None,
                     scale=None):
    """One query per row against a static cache, masked to each row's
    valid prefix ``lengths`` and, with a window, to its last ``window``
    positions.  q:(B,1,H,D) k,v:(B,S,Hkv,D) lengths:(B,) -> (B,1,H,D)."""
    b, one, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    group = h // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qf = q.to(torch.float32).reshape(b, one, hkv, group, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf,
                          k.to(torch.float32)) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = kpos < lengths[:, None]
    if window is not None:
        mask = mask & (kpos >= lengths[:, None] - window)
    logits = torch.where(mask[:, None, None, None, :], logits, NEG)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(torch.float32))
    return out.reshape(b, one, h, d).to(q.dtype)


def ssd(x, dt, A, B, C, D=None, *, chunk=64):
    """Mamba2 SSD (state-space duality) reference — sequential scan.

    x:(b,s,h,p) dt:(b,s,h) A:(h,) B,C:(b,s,g,n) with h % g == 0.
    Returns y:(b,s,h,p).  Discretization: dA = exp(dt*A), dB = dt*B.
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    Bh = torch.repeat_interleave(B, rep, dim=2).to(torch.float32)
    Ch = torch.repeat_interleave(C, rep, dim=2).to(torch.float32)
    xf = x.to(torch.float32)
    dtf = dt.to(torch.float32)
    dA = torch.exp(dtf * A[None, None, :])                # (b,s,h)
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        state = state * dA[:, t, :, None, None] + \
            (dtf[:, t, :, None] * xf[:, t])[..., None] * Bh[:, t, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Ch[:, t]))
    y = torch.stack(ys, dim=1)                            # (b,s,h,p)
    if D is not None:
        y = y + D[None, None, :, None] * xf
    return y.to(x.dtype)


def ssd_chunked(x, dt, A, B, C, D=None, *, chunk=128):
    """Chunked SSD in torch (a loop over chunks) — the block decomposition
    of kernels/ssd.py without the on-chip state.  Matches :func:`ssd` to
    fp tolerance.  The decay is masked before ``exp`` (the reference
    multiplies exp(la_i - la_j) by the causal mask, where an overflowed
    exp times 0 gives NaN)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    L = min(chunk, s)
    pad = (-s) % L
    xf = F.pad(x.to(torch.float32), (0, 0, 0, 0, 0, pad))
    dtf = F.pad(dt.to(torch.float32), (0, 0, 0, pad))
    Bh = F.pad(torch.repeat_interleave(B, rep, dim=2).to(torch.float32),
               (0, 0, 0, 0, 0, pad))
    Ch = F.pad(torch.repeat_interleave(C, rep, dim=2).to(torch.float32),
               (0, 0, 0, 0, 0, pad))
    nch = (s + pad) // L
    # (nch, b, h, L, ...) chunk-major layout
    xs = xf.reshape(b, nch, L, h, p).permute(1, 0, 3, 2, 4)
    dts = dtf.reshape(b, nch, L, h).permute(1, 0, 3, 2)
    Bs = Bh.reshape(b, nch, L, h, n).permute(1, 0, 3, 2, 4)
    Cs = Ch.reshape(b, nch, L, h, n).permute(1, 0, 3, 2, 4)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=x.device))
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    # unbind, not indexing, for the backward's sake (as in
    # attention_chunked)
    for xc, dtc, Bc, Cc in zip(xs.unbind(0), dts.unbind(0), Bs.unbind(0),
                               Cs.unbind(0)):               # (b,h,L,*)
        la = torch.cumsum(dtc * A[None, :, None], dim=-1)  # (b,h,L)
        y_inter = torch.exp(la)[..., None] * torch.einsum(
            "bhln,bhpn->bhlp", Cc, state)
        diff = torch.where(causal, la[..., :, None] - la[..., None, :], 0.0)
        w = torch.where(causal, torch.exp(diff), 0.0) * dtc[..., None, :]
        gmat = torch.einsum("bhln,bhmn->bhlm", Cc, Bc)
        ys.append(y_inter + torch.einsum("bhlm,bhmp->bhlp", gmat * w, xc))
        wj = torch.exp(la[..., -1:] - la) * dtc            # (b,h,L)
        state = torch.exp(la[..., -1])[..., None, None] * state + \
            torch.einsum("bhlp,bhln->bhpn", xc * wj[..., None], Bc)
    y = torch.stack(ys, dim=0).permute(1, 0, 3, 2, 4) \
        .reshape(b, nch * L, h, p)[:, :s]
    if D is not None:
        y = y + D[None, None, :, None] * x.to(torch.float32)
    return y.to(x.dtype)


def softmax_xent(logits, labels):
    """Cross-entropy over the vocab axis, fp32: logsumexp of the logits
    minus the label's logit.  It runs over every column given, the padded
    vocab's too (``head_apply`` fills those with -1e30, which add nothing
    to the sum)."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    return lse - ll
