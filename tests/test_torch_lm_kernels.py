"""The port's attention, decode-attention and SSD lowerings against the
JAX reference, on the CPU.

On the CPU each kernel wrapper runs its plain version (and counts no
launch); it is held against the reference's Pallas kernel in interpret
mode, as ``tests/test_kernels.py`` runs it.  The port's oracles are held
against the reference's, and the port's ``ops.*`` against the
reference's ``ops.*``.  The same numpy-made inputs go to both.
Tolerance: the reference's kernel TOL, fp32 rtol = atol = 2e-4 (the
order of the sums differs).

The reference's attention and decode cost/supports lambdas cannot take
the arguments ``dispatch`` passes positionally (ROADMAP C.7); the port's
can, and give the reference kernel's counts.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core import use_target as juse_target
from repro.core.registry import REGISTRY as JREG
from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import ssd as jssd
from repro_torch.core import targets, trace, use_policy, use_target
from repro_torch.core.registry import REGISTRY
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd as tssd

TOL = dict(rtol=2e-4, atol=2e-4)


def _f(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _np(y):
    return y.float().numpy() if isinstance(y, torch.Tensor) \
        else np.asarray(y.astype(jnp.float32))


def _close(got, want):
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def _bhsd(a):
    """(B,S,H,D) numpy -> the reference kernel's (B,H,S,D)."""
    return jnp.asarray(a.transpose(0, 2, 1, 3))


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

# (B, Sq, Sk, H, Hkv, D, causal, window, softcap)
FLASH = [(1, 40, 40, 4, 2, 16, True, None, None),
         (2, 33, 33, 4, 4, 8, True, 9, None),
         (1, 24, 24, 2, 1, 16, True, None, 20.0),
         (1, 30, 30, 4, 2, 16, False, None, None),
         (2, 12, 40, 4, 2, 16, True, None, None),     # Sq < Sk
         (1, 20, 50, 6, 2, 24, True, 11, 5.0)]        # all at once


def _attn_inputs(case, seed):
    b, sq, sk, h, hkv, d = case[:6]
    rng = np.random.default_rng(seed)
    return _f(rng, (b, sq, h, d)), _f(rng, (b, sk, hkv, d)), \
        _f(rng, (b, sk, hkv, d))


@pytest.mark.parametrize("case", FLASH, ids=str)
def test_flash_plain_matches_interpret_kernel(case):
    causal, window, softcap = case[6:]
    q, k, v = _attn_inputs(case, sum(case[:6]))
    want = jfa.flash_attention(_bhsd(q), _bhsd(k), _bhsd(v), causal=causal,
                               window=window, softcap=softcap, bq=16, bk=16,
                               interpret=True).transpose(0, 2, 1, 3)
    before = dict(fa.LAUNCHES)
    t = torch.from_numpy
    got = fa.flash_attention(t(q), t(k), t(v), causal, window, softcap)
    assert fa.LAUNCHES == before          # the CPU runs no kernel
    assert got.shape == q.shape and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("case", [FLASH[0], FLASH[4], FLASH[5]], ids=str)
def test_attention_oracles_match_reference(case):
    causal, window, softcap = case[6:]
    q, k, v = _attn_inputs(case, 7 + sum(case[:6]))
    kw = dict(causal=causal, window=window, softcap=softcap)
    j = [jnp.asarray(a) for a in (q, k, v)]
    t = [torch.from_numpy(a) for a in (q, k, v)]
    _close(ref.attention(*t, **kw), jref.attention(*j, **kw))
    _close(ref.attention_chunked(*t, q_chunk=16, **kw),
           jref.attention_chunked(*j, q_chunk=16, **kw))


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

# (B, S, H, Hkv, D, lengths, window, softcap)
DECODE = [(3, 40, 4, 2, 16, (1, 17, 40), None, None),
          (4, 48, 4, 4, 8, (0, 5, 30, 48), 8, None),
          (2, 64, 6, 2, 24, (64, 33), 16, 10.0)]


def _dec_inputs(case):
    b, s, h, hkv, d = case[:5]
    rng = np.random.default_rng(b * s + d)
    return (_f(rng, (b, 1, h, d)), _f(rng, (b, s, hkv, d)),
            _f(rng, (b, s, hkv, d)), np.asarray(case[5], np.int32))


@pytest.mark.parametrize("case", DECODE, ids=str)
def test_decode_plain_matches_interpret_kernel(case):
    window, softcap = case[6:]
    q, k, v, lens = _dec_inputs(case)
    want = jfa.decode_attention(_bhsd(q), _bhsd(k), _bhsd(v),
                                jnp.asarray(lens), window=window,
                                softcap=softcap, bk=16,
                                interpret=True).transpose(0, 2, 1, 3)
    t = torch.from_numpy
    got = fa.decode_attention(t(q), t(k), t(v), t(lens), window, softcap)
    _close(got, want)
    if 0 in lens:                         # nothing valid: the output is 0
        assert not got[list(lens).index(0)].any()


# (b, h, s, d): zamba2's decode step, a long cache with few rows, tiny,
# short rows, wide rows, many rows over a huge cache, one slot, no slot
PLAN = [(4, 32, 544, 128), (4, 32, 4096, 128), (2, 8, 4096, 128),
        (1, 1, 10, 128), (3, 2, 256, 16), (4, 8, 200, 256),
        (64, 32, 100000, 128), (1, 1, 16961, 128), (1, 1, 1, 1),
        (1, 1, 0, 16)]


@pytest.mark.parametrize("b,h,s,d", PLAN, ids=str)
def test_decode_plan_slices_cover_s_once(b, h, s, d):
    """The decode kernel's splits [i*ks, min(s, (i+1)*ks)) are non-empty,
    disjoint and cover [0, s), and at least the least length unless there
    is one; where s allows ``DEC_BLOCKS`` / (b h) splits of the least
    length, the even cut gives b * h * splits within a factor least /
    (least + 1) of ``DEC_BLOCKS``.  zamba2's decode step gets at least
    264 blocks."""
    splits, ks = fa.decode_plan(b, h, s, d)
    covered = np.zeros(s, np.int64)
    for i in range(splits):
        lo, hi = i * ks, min(s, (i + 1) * ks)
        assert hi > lo or s == 0
        covered[lo:hi] += 1
    assert (covered == 1).all() and splits * ks >= s
    least = max(fa.DEC_MIN_SLICE, -(-fa.DEC_MIN_ELEMS // d))
    assert splits == 1 or ks >= least
    if s >= least * -(-fa.DEC_BLOCKS // (b * h)):
        assert b * h * splits * (least + 1) >= fa.DEC_BLOCKS * least
    if (b, h, s, d) == (4, 32, 544, 128):
        assert b * h * splits >= 264


def _split_merge(q, k, v, lens, window, softcap):
    """The decode kernel's rule, in torch: the slots cut by
    ``decode_plan``, each split clipped to its row's valid range [max(0,
    len - window), len) and reduced to (m, l, acc) (an empty one to
    (-1e30, 0, 0)), the splits merged in split order, the sum divided by
    the weight sum, or by 1 where that is 0."""
    b, _, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    splits, ks = fa.decode_plan(b, h, s, d)
    out = torch.zeros_like(q)
    for bb in range(b):
        hi = min(max(int(lens[bb]), 0), s)
        lo = max(0, hi - window) if window is not None else 0
        for hh in range(h):
            kh = hh // (h // hkv)
            parts = []
            for i in range(splits):
                r_lo, r_hi = max(lo, i * ks), min(hi, (i + 1) * ks)
                if r_lo >= r_hi:
                    parts.append((torch.tensor(-1e30), torch.tensor(0.0),
                                  torch.zeros(d)))
                    continue
                x = k[bb, r_lo:r_hi, kh] @ q[bb, 0, hh] * d ** -0.5
                if softcap is not None:
                    x = softcap * torch.tanh(x / softcap)
                m = x.max()
                p = torch.exp(x - m)
                parts.append((m, p.sum(), p @ v[bb, r_lo:r_hi, kh]))
            mx = max(m for m, _, _ in parts)
            lsum = sum(l * torch.exp(m - mx) for m, l, _ in parts)
            acc = sum(a * torch.exp(m - mx) for m, _, a in parts)
            out[bb, 0, hh] = acc / (lsum if lsum != 0 else 1.0)
    return out


# (B, S, H, Hkv, D, lengths, window, softcap): lengths 0, 1 and S; a window
# that leaves two of four splits empty (GQA); GQA with softcap; D 16
SPLIT = [(3, 256, 2, 2, 128, (0, 1, 256), None, None),
         (2, 256, 2, 1, 128, (256, 200), 40, None),
         (2, 320, 4, 2, 128, (320, 77), None, 20.0),
         (2, 1024, 2, 1, 16, (1024, 600), None, None)]


@pytest.mark.parametrize("case", SPLIT, ids=str)
def test_decode_split_merge_matches_interpret_kernel(case):
    """The split-and-merge rule of the decode kernel against the JAX
    decode_attention in interpret mode, fp32 within 2e-4, on plans of
    more than one split."""
    b, s, h, hkv, d = case[:5]
    window, softcap = case[6:]
    assert fa.decode_plan(b, h, s, d)[0] > 1
    rng = np.random.default_rng(b * s + d)
    q, k, v = (_f(rng, (b, 1, h, d)), _f(rng, (b, s, hkv, d)),
               _f(rng, (b, s, hkv, d)))
    lens = np.asarray(case[5], np.int32)
    want = jfa.decode_attention(_bhsd(q), _bhsd(k), _bhsd(v),
                                jnp.asarray(lens), window=window,
                                softcap=softcap, bk=128,
                                interpret=True).transpose(0, 2, 1, 3)
    t = torch.from_numpy
    got = _split_merge(t(q), t(k), t(v), lens, window, softcap)
    _close(got, want)
    if 0 in lens:                         # nothing valid: the output is 0
        assert not got[list(lens).index(0)].any()


@pytest.mark.parametrize("case", DECODE, ids=str)
def test_decode_oracle_matches_reference(case):
    window, softcap = case[6:]
    q, k, v, lens = _dec_inputs(case)
    keep = lens > 0   # a row with no valid key: the oracles' uniform mean
    want = jops._dec_ref(*(jnp.asarray(a) for a in (q, k, v, lens)),
                         window, softcap, None)
    t = torch.from_numpy
    got = ref.decode_attention(t(q), t(k), t(v), t(lens), window, softcap)
    _close(got[t(keep)], np.asarray(want)[keep])


# ---------------------------------------------------------------------------
# ssd
# ---------------------------------------------------------------------------

# (b, s, h, p, g, n, chunk): on the chunk, off it, s < 8, one group
SSD = [(2, 64, 4, 16, 2, 32, 32), (2, 100, 4, 16, 2, 32, 32),
       (1, 37, 4, 8, 4, 16, 64), (2, 5, 2, 8, 1, 8, 128),
       (1, 130, 6, 8, 2, 8, 128)]


def _ssd_inputs(case):
    b, s, h, p, g, n = case[:6]
    rng = np.random.default_rng(sum(case))
    x = _f(rng, (b, s, h, p))
    dt = np.log1p(np.exp(_f(rng, (b, s, h)) - 1.0)).astype(np.float32)
    A = -np.exp(_f(rng, (h,), 0.5))
    return (x, dt, A, _f(rng, (b, s, g, n), 0.5), _f(rng, (b, s, g, n), 0.5),
            _f(rng, (h,), 0.1))


@pytest.mark.parametrize("case", SSD, ids=str)
def test_ssd_plain_matches_interpret_kernel(case):
    args = _ssd_inputs(case)
    chunk = case[6]
    want = jssd.ssd(*(jnp.asarray(a) for a in args), chunk=chunk,
                    interpret=True)
    got = tssd.ssd(*(torch.from_numpy(a) for a in args), chunk=chunk)
    assert tssd.LAUNCHES == {"ssd": 0}
    _close(got, want)


@pytest.mark.parametrize("case", [SSD[1], SSD[3], SSD[4]], ids=str)
def test_ssd_oracles_match_reference(case):
    args = _ssd_inputs(case)
    j = [jnp.asarray(a) for a in args]
    t = [torch.from_numpy(a) for a in args]
    want = jref.ssd(*j)
    _close(ref.ssd(*t), want)
    got = ref.ssd_chunked(*t, chunk=case[6])
    _close(got, want)
    # the reference's chunked oracle overflows exp(la_i - la_j) above the
    # diagonal on long chunks (NaN there, ROADMAP C.9); it agrees wherever
    # it is finite
    wc = np.asarray(jref.ssd_chunked(*j, chunk=case[6]))
    fin = np.isfinite(wc)
    np.testing.assert_allclose(_np(got)[fin], wc[fin], **TOL)


def test_ssd_chunked_masks_the_decay_before_exp():
    """Fast decays over a long chunk overflow exp(la_i - la_j) for i < j;
    the port masks first and stays finite, equal to the sequential
    scan."""
    b, s, h, p, g, n = 1, 64, 2, 4, 1, 4
    rng = np.random.default_rng(3)
    x, B, C = _f(rng, (b, s, h, p)), _f(rng, (b, s, g, n)), \
        _f(rng, (b, s, g, n))
    dt = np.full((b, s, h), 2.0, np.float32)
    A = np.array([-1.0, -60.0], np.float32)
    t = [torch.from_numpy(a) for a in (x, dt, A, B, C)]
    got = ref.ssd_chunked(*t, chunk=64)
    assert bool(torch.isfinite(got).all())
    _close(got, ref.ssd(*t))
    _close(tssd.ssd_plain(*t), ref.ssd(*t))


def test_ssd_kernel_shapes():
    """The kernels' chunks of KL rows: one launch for one chunk, two (state
    pass, output pass) beyond; zamba2's p = n = 64 fits a block's shared
    memory in both dtypes, p above 128 does not run the kernel tier."""
    assert [tssd.launches(s) for s in (1, tssd.KL, tssd.KL + 1, 512)] == \
        [1, 1, 2, 2]
    assert tssd.chunks(512) == 512 // tssd.KL
    budget = targets.get_target("h100").vmem_bytes
    for dtype in (torch.float32, torch.bfloat16):
        assert tssd.smem_bytes(64, 64, dtype) <= budget
    f32, bf = torch.float32, torch.bfloat16
    x = torch.empty((1, 8, 2, 136), dtype=bf, device="meta")
    B = torch.empty((1, 8, 1, 16), dtype=bf, device="meta")
    dt = torch.empty((1, 8, 2), dtype=f32, device="meta")
    A = torch.empty((2,), dtype=f32, device="meta")
    assert not tssd.supports(x, dt, A, B, B)
    assert tssd.supports(x[..., :128], dt, A, B, B)


# The CUDA kernels' decomposition (csrc/ssd.cu), mirrored in torch ops:
# chunks of tssd.KL rows; the state pass's dS_c = (w * x)^T B and the chain
# S_{c+1} = exp(la_L) S_c + dS_c in chunk order; the output pass's
# exp(la_i) C_i S_c^T + ((C B^T) * decay) x with the decay masked before
# exp.  Every fp32 operand the kernels split is split the same way into
# two bf16 terms, hi = bf16(v) and lo = bf16(v - hi), and each product
# takes the term pairs whose order sums to at most one; the products are
# taken in float64, so the mirror differs from the kernels only by their
# fp32 sums.  Log-decays are in log2 units, decays exp2, as there.

LOG2E = 1.4426950408889634


def _split(v, terms=2):
    """v as its bf16 terms (fp32 tensors): (hi,) or (hi, lo)."""
    hi = v.to(torch.bfloat16).float()
    return (hi,) if terms == 1 else (hi, (v - hi).to(torch.bfloat16).float())


def _products(eq, a_terms, b_terms):
    """sum over term pairs (i, j), i + j <= 1, of einsum(eq, a_i, b_j),
    in float64, rounded to fp32."""
    out = 0.0
    for i, a in enumerate(a_terms):
        for j, b in enumerate(b_terms):
            if i + j <= 1:
                out = out + torch.einsum(eq, a.double(), b.double())
    return out.float()


def ssd_mirror(x, dt, A, B, C, D=None, *, bf16=False):
    """y of the kernels' decomposition; ``bf16``: x, B, C are bf16 values,
    taken as one exact term (the kernels' bf16 path)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    L, rep = tssd.KL, h // g
    nch = -(-s // L)
    pad = nch * L - s
    terms = 1 if bf16 else 2
    xf = F.pad(x.float(), (0, 0, 0, 0, 0, pad))
    dtf = F.pad(dt.float(), (0, 0, 0, pad))
    Bh = F.pad(torch.repeat_interleave(B.float(), rep, dim=2),
               (0, 0, 0, 0, 0, pad))
    Ch = F.pad(torch.repeat_interleave(C.float(), rep, dim=2),
               (0, 0, 0, 0, 0, pad))
    # (nch, b, h, L, .) chunk-major
    xs = xf.reshape(b, nch, L, h, p).permute(1, 0, 3, 2, 4)
    dts = dtf.reshape(b, nch, L, h).permute(1, 0, 3, 2)
    Bs = Bh.reshape(b, nch, L, h, n).permute(1, 0, 3, 2, 4)
    Cs = Ch.reshape(b, nch, L, h, n).permute(1, 0, 3, 2, 4)
    la = torch.cumsum(dts * (A.float() * LOG2E)[None, None, :, None], -1)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool))
    state, ys = torch.zeros((b, h, p, n)), []
    for c in range(nch):
        lac, dtc = la[c], dts[c]
        xt, Bt, Ct = (_split(t, terms) for t in (xs[c], Bs[c], Cs[c]))
        y = 0.0
        if c:
            y = torch.exp2(lac)[..., None] * _products(
                "zhlk,zhqk->zhlq", Ct, _split(state))
        G = _products("zhik,zhjk->zhij", Ct, Bt)
        diff = torch.where(causal, lac[..., :, None] - lac[..., None, :], 0.0)
        M = torch.where(causal, G * (torch.exp2(diff) * dtc[..., None, :]),
                        0.0)
        y = y + _products("zhij,zhjq->zhiq", _split(M), xt)
        if D is not None:
            y = y + D.float()[None, :, None, None] * xs[c]
        ys.append(y)
        if c + 1 < nch:                       # the state pass and the chain
            w = torch.exp2(lac[..., -1:] - lac) * dtc
            dS = _products("zhjq,zhjk->zhqk", _split(xs[c] * w[..., None]),
                           Bt)
            state = torch.exp2(lac[..., -1])[..., None, None] * state + dS
    y = torch.stack(ys, 0).permute(1, 0, 3, 2, 4).reshape(b, nch * L, h, p)
    return y[:, :s]


# (b, s, h, p, g, n): one step; s < 8; one chunk and a row past it; three
# chunks; four (zamba2's length) with h / g = 32; h / g = 1
SSD_MIRROR = [(2, 1, 4, 8, 2, 16), (1, 8, 2, 16, 1, 8),
              (1, 130, 6, 8, 2, 16), (2, 300, 4, 16, 2, 8),
              (1, 512, 32, 8, 1, 16), (1, 300, 4, 8, 4, 8)]


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", SSD_MIRROR, ids=str)
def test_ssd_kernel_decomposition_matches_reference(case, bf16):
    """The mirror against the reference's Pallas kernel in interpret mode
    and against the sequential scan, within the LM TOL (fp32 2e-4); with
    ``bf16`` the inputs are bf16 values and x, B, C single terms."""
    x, dt, A, B, C, D = _ssd_inputs(case + (128,))
    if bf16:
        x, B, C = (np.asarray(torch.from_numpy(t).to(torch.bfloat16)
                              .float()) for t in (x, B, C))
    got = ssd_mirror(*map(torch.from_numpy, (x, dt, A, B, C, D)), bf16=bf16)
    want = jssd.ssd(*(jnp.asarray(a) for a in (x, dt, A, B, C, D)),
                    interpret=True)
    _close(got, want)
    _close(got, ref.ssd(*map(torch.from_numpy, (x, dt, A, B, C, D))))


def test_ssd_kernel_decomposition_masks_the_decay_before_exp():
    """Fast decays over a long chunk (ROADMAP C.9a): dt 2, A -60 overflow
    exp(la_i - la_j) above the diagonal; the mirror, as the kernels, masks
    first and stays finite, equal to the sequential scan."""
    b, s, h, p, g, n = 1, 200, 2, 4, 1, 4
    rng = np.random.default_rng(3)
    x, B, C = _f(rng, (b, s, h, p)), _f(rng, (b, s, g, n)), \
        _f(rng, (b, s, g, n))
    dt = np.full((b, s, h), 2.0, np.float32)
    A = np.array([-1.0, -60.0], np.float32)
    t = [torch.from_numpy(a) for a in (x, dt, A, B, C)]
    got = ssd_mirror(*t)
    assert bool(torch.isfinite(got).all())
    _close(got, ref.ssd(*t))


# ---------------------------------------------------------------------------
# ops.* against the reference's ops.*
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["vector", "pallas"])
def test_ops_match_reference_ops(policy):
    """Both tiers of the port (the kernel tier chosen under rvv-128 runs
    its plain version here) against the reference's default dispatch."""
    q, k, v = _attn_inputs(FLASH[5], 11)
    dq, dk, dv, lens = _dec_inputs(DECODE[0])
    sargs = _ssd_inputs((1, 100, 2, 64, 1, 64, 128))
    J = lambda *a: [jnp.asarray(x) for x in a]          # noqa: E731
    T = lambda *a: [torch.from_numpy(x) for x in a]     # noqa: E731
    want = [jops.attention(*J(q, k, v), window=11, softcap=5.0),
            jops.decode_attention(*J(dq, dk, dv, lens), window=8),
            jops.ssd(*J(*sargs))]
    with use_target("rvv-128"), use_policy(policy), trace.count() as c:
        got = [ops.attention(*T(q, k, v), window=11, softcap=5.0),
               ops.decode_attention(*T(dq, dk, dv, lens), window=8),
               ops.ssd(*T(*sargs))]
    for g, w in zip(got, want):
        _close(g, w)
    assert {op for op, _ in c["per_op"]} == {"attention", "decode_attention",
                                            "ssd"}
    assert {tier for _, tier in c["per_op"]} == {policy}


# ---------------------------------------------------------------------------
# cost models (ROADMAP C.7)
# ---------------------------------------------------------------------------

COST_SHAPES = [(2, 512, 32, 128, 32), (1, 300, 8, 64, 4)]


@pytest.mark.parametrize("target", ["tpu-v5e", "rvv-128"])
@pytest.mark.parametrize("shape", COST_SHAPES, ids=str)
def test_kernel_costs_equal_reference(shape, target):
    b, s, h, d, hkv = shape
    qs, ks = (b, s, h, d), (b, s, hkv, d)
    jq, jk = jnp.zeros(qs, jnp.bfloat16), jnp.zeros(ks, jnp.bfloat16)
    mq = torch.empty(qs, dtype=torch.bfloat16, device="meta")
    mk = torch.empty(ks, dtype=torch.bfloat16, device="meta")
    T = lambda a: a.transpose(0, 2, 1, 3)               # noqa: E731
    dq, mdq = jq[:, :1], mq[:, :1]
    lens = torch.empty((b,), dtype=torch.int32, device="meta")
    xs, ss = (b, s, 2 * h, 64), (b, s, 2, 64)
    f32 = dict(dtype=torch.float32, device="meta")
    mx = torch.empty(xs, dtype=torch.bfloat16, device="meta")
    mB = torch.empty(ss, dtype=torch.bfloat16, device="meta")
    sargs = (mx, torch.empty(xs[:3], **f32), torch.empty((2 * h,), **f32),
             mB, mB, torch.empty((2 * h,), **f32))
    with juse_target(target):
        want = [jfa.cost(T(jq), T(jk), T(jk), causal=True),
                jfa.cost(T(dq), T(jk), T(jk), causal=False),
                jssd.cost(jnp.zeros(xs, jnp.bfloat16), None, None,
                          jnp.zeros(ss, jnp.bfloat16), None)]
    with use_target(target):
        got = [REGISTRY.lowering("attention", "pallas").cost(
                   mq, mk, mk, True, None, None, None),
               REGISTRY.lowering("decode_attention", "pallas").cost(
                   mdq, mk, mk, lens, None, None, None),
               REGISTRY.lowering("ssd", "pallas").cost(*sargs)]
    assert got == want
    # with dispatch's positional arguments the kernel tier is valid and
    # costed, and wins under the RVV model
    rows = {
        "attention": REGISTRY.explain("attention", mq, mk, mk, True, None,
                                      None, None, policy="pallas",
                                      target=target),
        "decode_attention": REGISTRY.explain(
            "decode_attention", mdq, mk, mk, lens, None, None, None,
            policy="pallas", target=target),
        "ssd": REGISTRY.explain("ssd", *sargs, policy="pallas",
                                target=target)}
    for op, row in rows.items():
        (kern,) = [c for c in row["candidates"] if c["tier"] == "pallas"]
        assert kern["valid"] and kern["cost"] is not None, (op, row)
        if target == "rvv-128":
            assert row["chosen"] == "pallas", (op, row)


def test_reference_never_ranks_its_attention_kernels():
    """The fault the port repairs (ROADMAP C.7): with dispatch's
    positional arguments the reference's attention kernel is uncosted and
    its decode kernel invalid."""
    q = jnp.zeros((1, 64, 4, 16), jnp.float32)
    lens = jnp.ones((1,), jnp.int32)
    a = JREG.explain("attention", q, q, q, True, None, None, None,
                     policy="pallas", target="rvv-128")
    d = JREG.explain("decode_attention", q[:, :1], q, q, lens, None, None,
                     None, policy="pallas", target="rvv-128")
    (ka,) = [c for c in a["candidates"] if c["tier"] == "pallas"]
    (kd,) = [c for c in d["candidates"] if c["tier"] == "pallas"]
    assert ka["cost"] is None and not kd["valid"]
    assert a["chosen"] == d["chosen"] == "vector"
