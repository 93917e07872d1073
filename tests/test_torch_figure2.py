"""The port's gemm, conv, pooling and ibilinear lowerings against the JAX
reference, on the CPU.

On the CPU each wrapper runs its kernel's plain version; it is held
against the reference's Pallas kernel in interpret mode, the port's
oracles against the reference's, and the port's ``ops.*`` (rvv-128,
policy 'pallas') against the reference's.  The same numpy-made inputs go
to both.  Tolerances are the reference's kernel-test TOL
(``tests/test_kernels.py``): fp32 rtol = atol = 2e-4, since the order of
the sums differs; bf16 3e-2.  Pool values and argmaxpool indices are
compared outright.

NaN: maxpool propagates it in both packages.  argmaxpool's kernel never
takes a NaN (strict ``>`` against a -inf start, first max wins), while
the oracle's ``argmax`` treats NaN as the maximum; so NaN inputs are
compared with the reference *kernel* only, and kept out of the oracle
comparisons.

The CUDA kernels themselves are held against these plain versions on the
card in ``test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import use_target as juse_target
from repro.kernels import conv as jconv
from repro.kernels import gemm as jgemm
from repro.kernels import ibilinear as jib
from repro.kernels import ops as jops
from repro.kernels import pooling as jpool
from repro.kernels import ref as jref
from repro_torch.core import use_target
from repro_torch.core.registry import REGISTRY
from repro_torch.kernels import _build, conv, gemm, ibilinear, ops, pooling
from repro_torch.kernels import ref

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
MODULES = (gemm, conv, pooling, ibilinear)


def _rand(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _both(x, dtype):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def _np(y):
    if isinstance(y, torch.Tensor):
        return y.float().numpy() if y.is_floating_point() else y.numpy()
    return np.asarray(y.astype(jnp.float32)) \
        if jnp.issubdtype(y.dtype, jnp.floating) else np.asarray(y)


def _close(got, want, dtype):
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


# ---------------------------------------------------------------------------
# gemm
# ---------------------------------------------------------------------------

GEMM_SHAPES = [(1, 1, 1), (7, 13, 5), (33, 17, 65), (64, 128, 64),
               (129, 33, 67)]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("mkn", GEMM_SHAPES, ids=str)
def test_gemm_plain_matches_interpret_kernel(mkn, bias, dtype):
    m, k, n = mkn
    rng = np.random.default_rng(m * 100 + k + n)
    ja, ta = _both(_rand(rng, (m, k)), dtype)
    jb, tb = _both(_rand(rng, (k, n)), dtype)
    jc, tc = _both(_rand(rng, (n,)), dtype) if bias else (None, None)
    lo, hi = (-1.0, 1.0) if bias else (float("-inf"), float("inf"))
    want = jgemm.gemm(ja, jb, jc, lo, hi, interpret=True)
    got = gemm.gemm(ta, tb, tc, lo, hi)
    assert got.shape == (m, n) and got.dtype == ta.dtype
    _close(got, want, dtype)


def test_gemm_clamp_propagates_nan_like_the_kernel():
    """A NaN or inf in A reaches its row; the clamp keeps NaN and bounds
    the infinities, as jnp.clip in the reference kernel."""
    rng = np.random.default_rng(1)
    a = _rand(rng, (6, 9))
    a[1, 2], a[3, 0], a[4, 4] = np.nan, np.inf, -np.inf
    b, bias = np.abs(_rand(rng, (9, 5))) + 0.1, _rand(rng, (5,))
    want = _np(jgemm.gemm(jnp.asarray(a), jnp.asarray(b), jnp.asarray(bias),
                          -1.0, 1.0, interpret=True))
    got = _np(gemm.gemm(torch.from_numpy(a), torch.from_numpy(b),
                        torch.from_numpy(bias), -1.0, 1.0))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[1]).all() and (got[3] == 1.0).all() and \
        (got[4] == -1.0).all()
    _close(got, want, "float32")


VARIANT_CASES = \
    [(torch.float32, m, "small_m") for m in (1, 4, 5, 8, 9, 16)] + \
    [(torch.bfloat16, m, "small_m") for m in (1, 4, 5, 8)] + \
    [(torch.float32, m, "simt") for m in (17, 64, 65, 2048)] + \
    [(torch.bfloat16, m, "mma") for m in (9, 16, 17, 64, 65, 2048)]


@pytest.mark.parametrize("dtype,m,want", VARIANT_CASES,
                         ids=lambda x: str(x).replace("torch.", ""))
def test_gemm_variant_is_a_function_of_dtype_and_m(dtype, m, want):
    """The kernel a CUDA call launches: split-K up to 8 rows in bf16 and
    16 in fp32, wgmma above it in bf16, the SIMT tiles above it in fp32."""
    assert gemm.variant(dtype, m) == want
    assert want in gemm.VARIANTS
    assert gemm.SMALL_M_MAX == {torch.bfloat16: 8, torch.float32: 16}


@pytest.mark.parametrize("kind,dtype", [("mma", torch.float32),
                                        ("simt", torch.bfloat16)],
                         ids=["mma-float32", "simt-bfloat16"])
def test_gemm_variant_refuses_a_dtype_it_does_not_take(kind, dtype):
    """wgmma takes bf16 only, the SIMT tiles fp32 only: asked for the
    other, the launch raises before anything is built."""
    a, b = torch.zeros((32, 8), dtype=dtype), torch.zeros((8, 8), dtype=dtype)
    with pytest.raises(TypeError, match=f"the {kind} kernel does not take"):
        gemm.launch(kind, a, b, None, -1.0, 1.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
@pytest.mark.parametrize("n,k", [(8512, 2048), (2048, 4096), (4096, 4096),
                                 (8192, 4096), (2048, 8192), (64, 100),
                                 (100, 2048), (1, 70), (64, 1), (7, 0),
                                 (8512, 100003)])
def test_gemm_split_k_slices_cover_k_once(n, k, dtype):
    """The small-M kernel's K slices [s*ks, min(k, (s+1)*ks)) are
    non-empty, disjoint and cover [0, k); a slice is a multiple of 8 rows
    unless it is all of k; there are enough slices to put
    ``SMALL_M_BLOCKS`` blocks in flight where k allows 64-row slices."""
    splits, ks = gemm.split_k(n, k, dtype)
    covered = np.zeros(k, np.int64)
    for s in range(splits):
        lo, hi = s * ks, min(k, (s + 1) * ks)
        assert hi > lo or k == 0
        covered[lo:hi] += 1
    assert (covered == 1).all() and splits * ks >= k
    assert splits == 1 or ks % 8 == 0
    assert 1 <= splits <= 65535
    cols = -(-n // (32 * 16 // dtype.itemsize))
    if k >= gemm.MIN_SLICE * -(-gemm.SMALL_M_BLOCKS // cols):
        assert cols * splits >= gemm.SMALL_M_BLOCKS


# (m, n, k): the Figure-2 product, 2048^3, zamba2's five float32 prefill
# products, a square one for the middle tile, ragged and tiny ones, K = 0
SIMT_SHAPES = [(256, 256, 512), (2048, 2048, 2048), (2048, 8512, 2048),
               (2048, 2048, 4096), (2048, 4096, 4096), (2048, 8192, 4096),
               (2048, 2048, 8192), (1024, 1024, 1024), (17, 64, 8192),
               (129, 67, 33), (40, 9, 24), (100, 70, 3000), (64, 64, 0),
               (17, 1, 1)]


@pytest.mark.parametrize("m,n,k", SIMT_SHAPES, ids=str)
def test_gemm_simt_plan_slices_cover_k_once(m, n, k):
    """The SIMT kernel's plan: one of its tiles; K slices [s*ks, min(k,
    (s+1)*ks)) non-empty, disjoint and covering [0, k), each a multiple
    of the slot depth unless there is one; the largest tile unsplit
    where it fills the card; else ``SIMT_BLOCKS`` blocks where k allows
    ``MIN_SLICE``-row slices.  The Figure-2 product reaches 100 blocks,
    and 2048^3 and the serving shapes are not split."""
    bm, bn, splits, ks = gemm.simt_plan(m, n, k)
    assert (bm, bn) in gemm.SIMT_TILES
    covered = np.zeros(k, np.int64)
    for s in range(splits):
        lo, hi = s * ks, min(k, (s + 1) * ks)
        assert hi > lo or k == 0
        covered[lo:hi] += 1
    assert (covered == 1).all() and splits * ks >= k
    assert splits == 1 or ks % gemm.SIMT_BK == 0
    assert 1 <= splits <= 65535
    tiles = -(-m // bm) * -(-n // bn)
    if -(-m // 128) * -(-n // 128) >= gemm.SIMT_BLOCKS:
        assert (bm, bn, splits) == (128, 128, 1)
    elif k >= gemm.MIN_SLICE * -(-gemm.SIMT_BLOCKS // tiles):
        assert tiles * splits >= gemm.SIMT_BLOCKS
    if (m, n, k) == (256, 256, 512):
        assert tiles * splits >= 100
    if m == 2048:
        assert (bm, bn, splits) == (128, 128, 1)


# ---------------------------------------------------------------------------
# conv_hwc / dwconv
# ---------------------------------------------------------------------------

X_SHAPE = (2, 10, 12, 8)
TAPS = [(3, 3), (1, 3)]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("stride", [(1, 1), (2, 2), (2, 1)], ids=str)
@pytest.mark.parametrize("taps", TAPS, ids=str)
def test_conv_plain_matches_interpret_kernel(taps, stride, dtype):
    rng = np.random.default_rng(sum(taps) * 10 + sum(stride))
    jx, tx = _both(_rand(rng, X_SHAPE), dtype)
    jw, tw = _both(_rand(rng, taps + (8, 16), 0.3), dtype)
    jb, tb = _both(_rand(rng, (16,)), dtype)
    want = jconv.conv_hwc(jx, jw, jb, stride, interpret=True)
    got = conv.conv_hwc(tx, tw, tb, stride)
    assert got.shape == want.shape and got.dtype == tx.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("taps", TAPS, ids=str)
def test_dwconv_plain_matches_interpret_kernel(taps, bias, dtype):
    rng = np.random.default_rng(sum(taps) + bias)
    jx, tx = _both(_rand(rng, X_SHAPE), dtype)
    jw, tw = _both(_rand(rng, taps + (8,), 0.3), dtype)
    jb, tb = _both(_rand(rng, (8,)), dtype) if bias else (None, None)
    want = jconv.dwconv(jx, jw, jb, interpret=True)
    got = conv.dwconv(tx, tw, tb)
    assert got.shape == want.shape and got.dtype == tx.dtype
    _close(got, want, dtype)


# ---------------------------------------------------------------------------
# maxpool / argmaxpool
# ---------------------------------------------------------------------------

# C 12 and 130 lie off the kernel's 16-byte vector (8 bf16; 4 fp32 for
# 130), and 3x3 is its generic window
POOLS = [((2, 10, 12, 8), (2, 2)), ((2, 11, 13, 8), (2, 2)),
         ((2, 10, 12, 8), (3, 3)), ((1, 9, 7, 5), (2, 3)),
         ((2, 10, 12, 12), (2, 2)), ((1, 9, 11, 130), (2, 2)),
         ((2, 9, 9, 12), (3, 3)), ((1, 9, 11, 130), (3, 3))]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape,window", POOLS, ids=str)
def test_pools_plain_match_interpret_kernels(shape, window, dtype):
    """Odd H and W leave a ragged tail, which both trim."""
    rng = np.random.default_rng(sum(shape) + sum(window))
    jx, tx = _both(_rand(rng, shape), dtype)
    want = jpool.maxpool(jx, window, interpret=True)
    got = pooling.maxpool(tx, window)
    assert got.shape == want.shape and got.dtype == tx.dtype
    np.testing.assert_array_equal(_np(got), _np(want))
    want_v, want_i = jpool.argmaxpool(jx, window, interpret=True)
    got_v, got_i = pooling.argmaxpool(tx, window)
    assert got_i.dtype == torch.int32 and got_v.dtype == tx.dtype
    np.testing.assert_array_equal(_np(got_v), _np(want_v))
    np.testing.assert_array_equal(_np(got_i), _np(want_i))


def test_pools_nan_inf_and_ties_match_interpret_kernels():
    """NaN propagates through maxpool and is never taken by argmaxpool
    (a window of NaN gives -inf at index 0); ties go to the first
    position in (i, j) order."""
    rng = np.random.default_rng(7)
    x = np.round(_rand(rng, (1, 8, 8, 4))).astype(np.float32)   # ties
    x[0, 0, 0, 0], x[0, 2, 3, 1], x[0, 5, 5, 2] = np.nan, np.inf, -np.inf
    x[0, 6:8, 6:8, 3] = np.nan                                  # all NaN
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    np.testing.assert_array_equal(_np(pooling.maxpool(tx)),
                                  _np(jpool.maxpool(jx, interpret=True)))
    got_v, got_i = pooling.argmaxpool(tx)
    want_v, want_i = jpool.argmaxpool(jx, interpret=True)
    np.testing.assert_array_equal(_np(got_v), _np(want_v))
    np.testing.assert_array_equal(_np(got_i), _np(want_i))
    assert _np(got_v)[0, 3, 3, 3] == -np.inf and _np(got_i)[0, 3, 3, 3] == 0


def test_integer_pools_run_the_plain_version():
    x = np.random.default_rng(3).integers(-50, 50, (1, 6, 6, 3))
    tx = torch.from_numpy(x.astype(np.int32))
    v, i = pooling.argmaxpool(tx)
    want_v, want_i = jpool.argmaxpool(jnp.asarray(x, jnp.int32),
                                      interpret=True)
    np.testing.assert_array_equal(v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(pooling.maxpool(tx).numpy(),
                                  np.asarray(jref.maxpool(jnp.asarray(x))))


# ---------------------------------------------------------------------------
# ibilinear
# ---------------------------------------------------------------------------

def _ib_inputs(rng, h=20, w=24, c=8, p=23):
    return (_rand(rng, (h, w, c)),
            rng.integers(0, h - 1, p).astype(np.int32),
            rng.integers(0, w - 1, p).astype(np.int32),
            rng.random(p).astype(np.float32),
            rng.random(p).astype(np.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ibilinear_plain_matches_interpret_kernel(dtype):
    img, iy, ix, wy, wx = _ib_inputs(np.random.default_rng(5))
    jimg, timg = _both(img, dtype)
    rest = (iy, ix, wy, wx)
    want = jib.ibilinear(jimg, *map(jnp.asarray, rest), interpret=True)
    got = ibilinear.ibilinear(timg, *map(torch.from_numpy, rest))
    assert got.shape == (23, 8) and got.dtype == timg.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("c", [12, 130])
def test_ibilinear_plain_matches_interpret_kernel_off_the_vector(c, dtype):
    """C 12 and 130: off the kernel's 16-byte vector (bf16; fp32 for
    130), so its group loops or idles threads."""
    img, iy, ix, wy, wx = _ib_inputs(np.random.default_rng(c), c=c, p=37)
    jimg, timg = _both(img, dtype)
    rest = (iy, ix, wy, wx)
    want = jib.ibilinear(jimg, *map(jnp.asarray, rest), interpret=True)
    got = ibilinear.ibilinear(timg, *map(torch.from_numpy, rest))
    assert got.shape == (37, c) and got.dtype == timg.dtype
    _close(got, want, dtype)


def test_ibilinear_corner_reads_stay_in_the_image():
    """Corners past the last row or column are clamped to it, so a
    corner at (H-1, W-1) reads only the image."""
    img = np.arange(2 * 3 * 2, dtype=np.float32).reshape(2, 3, 2)
    out = ibilinear.ibilinear(torch.from_numpy(img),
                              torch.tensor([1], dtype=torch.int32),
                              torch.tensor([2], dtype=torch.int32),
                              torch.tensor([0.5]), torch.tensor([0.5]))
    np.testing.assert_array_equal(out.numpy(), img[1, 2][None])


# ---------------------------------------------------------------------------
# the oracles and the dispatch path, both packages
# ---------------------------------------------------------------------------

def _cases(rng):
    """(op, numpy args, non-array args) at the small test shapes."""
    x = _rand(rng, X_SHAPE)
    return [
        ("gemm", (_rand(rng, (33, 17)), _rand(rng, (17, 65)),
                  _rand(rng, (65,))), (-1.0, 1.0)),
        ("conv_hwc", (x, _rand(rng, (3, 3, 8, 16), 0.3),
                      _rand(rng, (16,))), ((2, 2),)),
        ("dwconv", (x, _rand(rng, (3, 3, 8), 0.3), _rand(rng, (8,))), ()),
        ("maxpool", (_rand(rng, (2, 11, 13, 8)),), ((2, 2),)),
        ("argmaxpool", (_rand(rng, (2, 11, 13, 8)),), ((2, 2),)),
        ("ibilinear", _ib_inputs(rng), ()),
    ]


def _assert_same(op, got, want, dtype="float32"):
    if op in ("maxpool", "argmaxpool"):
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            np.testing.assert_array_equal(_np(g), _np(w))
    else:
        _close(got, want, dtype)


@pytest.mark.parametrize("case", range(6))
def test_oracle_matches_reference_oracle(case):
    op, arrays, extra = _cases(np.random.default_rng(11))[case]
    want = getattr(jref, op)(*map(jnp.asarray, arrays), *extra)
    got = getattr(ref, op)(*map(torch.from_numpy, arrays), *extra)
    _assert_same(op, got, want)


@pytest.mark.parametrize("case", range(6))
def test_dispatch_matches_reference_dispatch(case):
    """ops.* under rvv-128 with the kernel tier allowed, both packages:
    the port picks its kernel tier, and the outputs agree.  (The
    reference dispatches dwconv, maxpool and argmaxpool to its vector or
    scalar tier here, as its cost models refuse the stride argument —
    ROADMAP C.4; the outputs are compared all the same.)"""
    op, arrays, extra = _cases(np.random.default_rng(12))[case]
    with juse_target("rvv-128"):
        want = getattr(jops, op)(*map(jnp.asarray, arrays), *extra,
                                 policy="pallas")
    targs = tuple(map(torch.from_numpy, arrays))
    with use_target("rvv-128"):
        assert REGISTRY.select(op, *targs, *extra,
                               policy="pallas").tier == "pallas"
        got = getattr(ops, op)(*targs, *extra, policy="pallas")
    _assert_same(op, got, want)


# ---------------------------------------------------------------------------
# routing and validity
# ---------------------------------------------------------------------------

def test_cpu_tensors_never_reach_the_builder(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached the CUDA builder")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "launch", refuse)
    before = [dict(m.LAUNCHES) for m in MODULES]
    for op, arrays, extra in _cases(np.random.default_rng(13)):
        targs = tuple(map(torch.from_numpy, arrays))
        with use_target("rvv-128"):
            getattr(ops, op)(*targs, *extra, policy="pallas")
    assert [m.LAUNCHES for m in MODULES] == before


def test_wrappers_refuse_other_devices():
    meta = torch.empty((2, 4, 4, 3), device="meta")
    cpu = torch.zeros((3, 3, 3))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        pooling.maxpool(meta)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        conv.dwconv(meta, cpu)          # two devices
    with pytest.raises(ValueError, match="CUDA or CPU"):
        gemm.gemm(torch.empty((2, 2), device="meta"),
                  torch.empty((2, 2), device="meta"))


def test_kernel_tier_limits():
    """The kernel tier is valid only where the kernels take the
    operands: fp32 / bf16 of one dtype, pooling at stride == window,
    dwconv at stride 1, int32 corners and fp32 weights for ibilinear."""
    x = torch.zeros((1, 8, 8, 4))
    with use_target("rvv-128"):
        assert pooling.supports(x, (2, 2))
        assert not pooling.supports(x, (2, 2), (1, 1))
        assert not pooling.supports(x.to(torch.int32), (2, 2))
        assert REGISTRY.select("maxpool", x.to(torch.int32), (2, 2), None,
                               policy="pallas").tier == "vector"
        assert not conv.supports_dwconv(x, torch.zeros((3, 3, 4)),
                                        stride=(2, 2))
        assert not conv.supports_conv(x, torch.zeros((3, 3, 4, 4),
                                                     dtype=torch.bfloat16))
        assert not gemm.supports(torch.zeros((2, 2)),
                                 torch.zeros((2, 2), dtype=torch.float64))
        img, iy = torch.zeros((4, 4, 2)), torch.zeros(3, dtype=torch.int32)
        w = torch.zeros(3)
        assert ibilinear.supports(img, iy, iy, w, w)
        assert not ibilinear.supports(img, iy.long(), iy.long(), w, w)


def test_scratch_rule_kept_for_tpu_and_dropped_for_the_card():
    """On tpu-v5e a slab must fit 16 MiB of VMEM, as in the reference; on
    the h100 target the kernels stream from global memory."""
    big = torch.empty((1, 512, 512, 64), device="meta")
    w = torch.empty((3, 3, 64, 64), device="meta")
    with use_target("tpu-v5e"):
        assert not conv.supports_conv(big, w)
    with use_target("h100"):
        assert conv.supports_conv(big, w)
    with use_target("tpu-v5e"):
        assert conv.supports_conv(big[:, :28, :28], w)
