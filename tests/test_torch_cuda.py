"""The port's CUDA kernels on the card, against their plain torch versions.

Every test here is marked ``cuda`` and skips without a card.  The module
imports neither jax nor the JAX package, so it runs on a machine that has
only PyTorch built for CUDA and the CUDA toolkit::

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q

Tolerances as in ``chip_smoke.py``.  Elementwise: fp32 rtol 1e-5 / atol
2e-6, bf16 one ulp at 1 (8e-3), vrelu bitwise; NaN and inf positions
must agree; subnormal inputs are included.  gemm and conv_hwc: fp32
rtol = atol = 2e-4 (the reference's kernel TOL: the sums run in another
order), bf16 3e-2.  dwconv, ibilinear, the pools and argmaxpool's
indices: bitwise, since they round where their plain versions round.
The pools also at C off their 16-byte vector (12 in bf16, 130), in the
generic window (3x2, 3x3, also on the vector), through an x off 16
bytes, with NaN, inf and ties on the vector path, and past 2^31 elements
in bf16 (the 64-bit path, ~4.3 GB); ibilinear also at C 12 and 130,
through an image off 16 bytes and on a bf16 image past 2^31 elements
(its 64-bit path); each call one launch.  Every op of
``repro_torch.core.isa`` in each tier: the card equals the CPU bitwise
(floats within ``chip_smoke.CARD_ULP`` for rsqrt and the float sums), on
unsigned lanes and out-of-range offsets.
conv_hwc also at Ci 3, Ci 24 under K slices that straddle taps, N 3,
5x5 taps at stride 2, 1x1 taps and its 128 x 64 tile, and to itself
bitwise across runs under a sliced plan; dwconv also at C 8 and 130, 5x5
and 1x1 windows, runs of 8, 4 and 2 columns a thread with a ragged last
one, and an x off 16 bytes.  Each gemm variant (split-K small M, wgmma bf16,
SIMT fp32) is held to the same tolerance at M, N and K around the
small-M threshold and the serving shapes (deepseek-v2-lite-16b's and
minicpm3-4b's too, with vsigmoid at their silu's shapes); the SIMT
kernel also on each
of its tiles, with K cut into slices, and with B read element by element
(N off 4, or B off 16 bytes); split-K and the SIMT kernel's K slices to
themselves bitwise across runs.  flash_attention, decode_attention and ssd: rtol = atol =
2e-4 in fp32 and 3e-2 in bf16 (the reference's kernel TOL), at the
serving shapes of zamba2, granite (GQA 16/8, D 64) and mamba2 (ssd at
n 128, also bitwise across runs) and at GQA/window/softcap, Sq < Sk, ragged-length,
off-chunk, s < 8 and single-group shapes; decode also over a long cache
of many splits, with splits wholly outside a row's valid range, at D 20
(rows read element by element), through strided views of one cache
buffer, and bitwise across runs.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import trace, use_target
from repro_torch.kernels import _build, conv, gemm, ibilinear, ops, pooling
from repro_torch.kernels import elementwise as ew

pytestmark = pytest.mark.cuda

OPS = ("vrelu", "vsqrt", "vtanh", "vsigmoid")
SHAPES = [(1,), (7,), (127,), (8191,), (8193,), (8, 130), (3, 5, 7),
          (4, 1, 8192), (1024, 1024)]
DTYPES = (torch.float32, torch.bfloat16)
TOL = {torch.float32: dict(rtol=1e-5, atol=2e-6),
       torch.bfloat16: dict(rtol=8e-3, atol=8e-3)}
EDGE = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, 20.0, -20.0,
                 30.0, -30.0, 35.0, -35.0, 0.5, 2.5], np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda is not available)")
    return torch.device("cuda")


def _extra(op):
    return (0.0, 6.0) if op == "vrelu" else ()


def _input(op, n, seed):
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    if op == "vsqrt":
        return np.abs(x) + 0.01
    return 2.0 * x if op in ("vtanh", "vsigmoid") else x


def _check(op, got, want):
    g, w = got.float().cpu().numpy(), want.float().cpu().numpy()
    if op == "vrelu":
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, **TOL[got.dtype])


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("op", OPS)
def test_kernel_matches_plain_on_card(cuda, op, dtype):
    for shape in SHAPES:
        x = torch.from_numpy(_input(op, shape, seed=5)).to(cuda, dtype)
        before = ew.LAUNCHES[op]
        got = getattr(ew, op)(x, *_extra(op))
        assert ew.LAUNCHES[op] == before + 1
        assert got.shape == x.shape and got.dtype == dtype
        _check(op, got, ew.PLAIN[op](x, *_extra(op)))
    # one element into its storage: the unaligned one-by-one path
    x = torch.from_numpy(_input(op, 4099, seed=6)).to(cuda, dtype)[1:]
    _check(op, getattr(ew, op)(x, *_extra(op)), ew.PLAIN[op](x, *_extra(op)))
    x = torch.from_numpy(EDGE).to(cuda, dtype)
    _check(op, getattr(ew, op)(x, *_extra(op)), ew.PLAIN[op](x, *_extra(op)))


def _f(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _ib(rng, h, w, c, p):
    return (_f(rng, (h, w, c)), rng.integers(0, h - 1, p).astype(np.int32),
            rng.integers(0, w - 1, p).astype(np.int32),
            rng.random(p).astype(np.float32),
            rng.random(p).astype(np.float32))


# conv_hwc off the Figure-2 shape: Ci 3 (an RGB first layer); Ci 24 with
# K slices (and 16-deep slots) that straddle taps; N 3, so pixel tiles
# cross images; 5x5 taps at stride 2; 1x1 taps; the unsplit 128 x 64 tile
CONV_CASES = [((2, 33, 35, 3), (3, 3, 3, 32), (1, 1)),
              ((1, 12, 12, 24), (3, 3, 24, 40), (1, 1)),
              ((3, 9, 10, 16), (3, 3, 16, 24), (1, 1)),
              ((2, 19, 21, 8), (5, 5, 8, 16), (2, 2)),
              ((2, 7, 9, 32), (1, 1, 32, 48), (1, 1)),
              ((2, 66, 66, 32), (3, 3, 32, 128), (1, 1))]
# dwconv off the Figure-2 shape (whose plan takes runs of 2 columns a
# thread): C 8, C 130 (one channel a thread), a 5x5 and a 1x1 window, C
# 33, and 3x3 runs of 8 and of 4 columns a thread with a ragged last run
DW_CASES = [((2, 10, 12, 8), (3, 3, 8)), ((1, 9, 11, 130), (3, 3, 130)),
            ((2, 12, 13, 64), (5, 5, 64)), ((2, 6, 7, 48), (1, 1, 48)),
            ((3, 7, 5, 33), (3, 3, 33)), ((8, 64, 67, 128), (3, 3, 128)),
            ((2, 60, 45, 128), (3, 3, 128))]


def _cases(op, rng):
    """(float arrays, other arrays, extra args) at the Figure-2 shape and
    at awkward ones: ragged tiles, no bias, stride 2, non-square taps,
    odd pooled extents, a pixel count off the block size."""
    if op == "gemm":
        return [((_f(rng, (256, 512)), _f(rng, (512, 256)), _f(rng, (256,))),
                 (), (-1.0, 1.0)),
                ((_f(rng, (129, 33)), _f(rng, (33, 67)), None), (), ()),
                ((_f(rng, (1, 70)), _f(rng, (70, 1)), _f(rng, (1,))), (),
                 (-0.5, 0.5))]
    if op == "conv_hwc":
        return [((_f(rng, (1, 28, 28, 128)), _f(rng, (3, 3, 128, 128), 0.1),
                  _f(rng, (128,))), (), ((1, 1),)),
                ((_f(rng, (2, 17, 19, 24)), _f(rng, (3, 2, 24, 40), 0.3),
                  _f(rng, (40,))), (), ((2, 1),)),
                ((_f(rng, (2, 17, 19, 24)), _f(rng, (1, 3, 24, 40), 0.3),
                  None), (), ((2, 2),))] + \
            [((_f(rng, xs), _f(rng, ws, 0.3), _f(rng, ws[3:])), (), (st,))
             for xs, ws, st in CONV_CASES]
    if op == "dwconv":
        return [((_f(rng, (1, 56, 56, 128)), _f(rng, (3, 3, 128), 0.3),
                  _f(rng, (128,))), (), ()),
                ((_f(rng, (2, 9, 11, 20)), _f(rng, (1, 3, 20), 0.3), None),
                 (), ())] + \
            [((_f(rng, xs), _f(rng, ws, 0.3), _f(rng, ws[2:])), (), ())
             for xs, ws in DW_CASES]
    if op in ("maxpool", "argmaxpool"):
        return [((_f(rng, (1, 56, 56, 256)),), (), ((2, 2),)),
                ((_f(rng, (2, 13, 15, 12)),), (), ((2, 2),)),
                ((_f(rng, (2, 13, 15, 12)),), (), ((3, 2),)),
                ((_f(rng, (2, 13, 15, 12)),), (), ((3, 3),)),
                ((_f(rng, (2, 12, 13, 16)),), (), ((3, 3),)),
                ((_f(rng, (2, 13, 15, 130)),), (), ((2, 2),))]
    return [(a[:1], a[1:], ()) for a in (
        _ib(rng, 56, 56, 64, 3136), _ib(rng, 20, 24, 8, 1001),
        _ib(rng, 20, 24, 12, 777), _ib(rng, 20, 24, 130, 333))]


NEW = {"gemm": gemm, "conv_hwc": conv, "dwconv": conv, "maxpool": pooling,
       "argmaxpool": pooling, "ibilinear": ibilinear}
BITWISE = ("dwconv", "maxpool", "argmaxpool", "ibilinear")


def _to(a, dev, dtype):
    if a is None:
        return None
    t = torch.from_numpy(a).to(dev)
    return t.to(dtype) if t.is_floating_point() else t


def _same(op, got, want, dtype):
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.shape == w.shape and g.dtype == w.dtype
        g, w = g.cpu(), w.cpu()
        if op in BITWISE or not g.is_floating_point():
            if g.is_floating_point():
                assert torch.equal(g.isnan(), w.isnan()), op
                g, w = g[~g.isnan()], w[~w.isnan()]
            assert torch.equal(g, w), op
        else:
            tol = 2e-4 if dtype == torch.float32 else 3e-2
            np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                       rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("op", sorted(NEW))
def test_new_kernel_matches_plain_on_card(cuda, op, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mod = NEW[op]
    for floats, others, extra in _cases(op, np.random.default_rng(9)):
        # ibilinear's weights stay float32; its image takes the dtype
        args = [_to(a, cuda, dtype) for a in floats] + \
            [_to(a, cuda, torch.float32) for a in others]
        before = mod.LAUNCHES[op]
        got = mod.KERNELS[op](*args, *extra)
        assert mod.LAUNCHES[op] == before + 1
        _same(op, got, mod.PLAIN[op](*args, *extra), dtype)


def test_new_kernels_nan_and_inf_edges(cuda):
    """NaN and +-inf through the gemm clamp and the pools, against the
    plain versions: NaN propagates through the clamp and maxpool and is
    never taken by argmaxpool."""
    rng = np.random.default_rng(4)
    a = _f(rng, (40, 24))
    a[1, 2], a[3, 0], a[4, 4] = np.nan, np.inf, -np.inf
    b, bias = np.abs(_f(rng, (24, 9))) + 0.1, _f(rng, (9,))
    args = [torch.from_numpy(t).to(cuda) for t in (a, b, bias)]
    got = gemm.gemm(*args, -1.0, 1.0)
    _same("gemm", got, gemm.gemm_plain(*args, -1.0, 1.0), torch.float32)
    assert bool(got[1].isnan().all()) and bool((got[3] == 1.0).all())
    x = np.round(_f(rng, (2, 9, 8, 6)))
    x[0, 0, 0, 0], x[0, 2, 3, 1], x[1, 5, 5, 2] = np.nan, np.inf, -np.inf
    x[1, 6:8, 6:8, 3] = np.nan
    for dtype in DTYPES:
        tx = torch.from_numpy(x).to(cuda, dtype)
        for op in ("maxpool", "argmaxpool"):
            _same(op, pooling.KERNELS[op](tx), pooling.PLAIN[op](tx), dtype)


def _off16(t):
    """A copy of ``t`` in a view 4 bytes off 16-byte alignment."""
    flat = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    base = (-flat.data_ptr() % 16 + 4) // flat.element_size()
    v = flat[base:base + t.numel()].view(t.shape)
    v.copy_(t)
    assert v.data_ptr() % 16 == 4
    return v


def _launched_once(mod, op, *args):
    before = mod.LAUNCHES[op]
    out = mod.KERNELS[op](*args)
    assert mod.LAUNCHES[op] == before + 1
    return out


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_pools_and_ibilinear_read_a_view_off_16_bytes(cuda, dtype):
    """x or img a view 4 bytes off 16-byte alignment: the one-channel path
    (the plan says so), bitwise equal to the plain version."""
    rng = np.random.default_rng(12)
    x = _off16(torch.from_numpy(_f(rng, (2, 12, 14, 64))).to(cuda, dtype))
    assert not _build.vector16(x)
    for op in ("maxpool", "argmaxpool"):
        _same(op, _launched_once(pooling, op, x, (2, 2)),
              pooling.PLAIN[op](x, (2, 2)), dtype)
    floats, others, _ = _cases("ibilinear", rng)[0]
    img = _off16(_to(floats[0], cuda, dtype))
    rest = [_to(a, cuda, torch.float32) for a in others]
    assert not _build.vector16(img)
    _same("ibilinear", _launched_once(ibilinear, "ibilinear", img, *rest),
          ibilinear.ibilinear_plain(img, *rest), dtype)


@pytest.mark.parametrize("window", [(2, 2), (3, 3)], ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_pools_nan_inf_and_ties_on_the_vector_path(cuda, dtype, window):
    """The NaN, inf and tie case at C 16, where both dtypes take 16-byte
    vectors: NaN propagates through maxpool and is never taken by
    argmaxpool, ties go to the first tap."""
    x = np.round(_f(np.random.default_rng(5), (2, 9, 9, 16)))
    x[0, 0, 0, 0], x[0, 2, 3, 1], x[1, 5, 5, 2] = np.nan, np.inf, -np.inf
    x[1, 6:8, 6:8, 3] = np.nan
    x[0, 3:6, 3:6, 9] = np.nan
    tx = torch.from_numpy(x).to(cuda, dtype)
    assert _build.vector16(tx)
    for op in ("maxpool", "argmaxpool"):
        _same(op, _launched_once(pooling, op, tx, window),
              pooling.PLAIN[op](tx, window), dtype)


def test_pools_past_2_31_elements(cuda):
    """A bf16 x of 2,149,580,800 elements (~4.3 GB, W odd, so a tail
    column is dropped): the plan takes 64-bit indexing, and both pools
    equal their plain versions bitwise, past the 2^31st element too."""
    shape = (2, 1024, 1025, 1024)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(3)
    x = torch.randn(shape, generator=gen, device=cuda, dtype=torch.bfloat16)
    assert pooling.pool_plan(x.shape, x.dtype, (2, 2), True)["wide"]
    for op in ("maxpool", "argmaxpool"):
        got = _launched_once(pooling, op, x, (2, 2))
        _same(op, got, pooling.PLAIN[op](x, (2, 2)), torch.bfloat16)
        del got
    torch.cuda.empty_cache()


def test_ibilinear_past_2_31_elements(cuda):
    """A bf16 image of 2,149,580,800 elements (4.3 GB) read at corners in
    its last rows, most of them past element 2^31: the plan takes 64-bit
    offsets, and the kernel equals its plain version bitwise."""
    h, w, c, p = 1024, 1025, 2048, 999
    gen = torch.Generator(device=cuda)
    gen.manual_seed(4)
    img = torch.randn((h, w, c), generator=gen, device=cuda,
                      dtype=torch.bfloat16)
    iy = torch.randint(h - 3, h - 1, (p,), generator=gen, device=cuda,
                       dtype=torch.int32)
    ix = torch.randint(0, w - 1, (p,), generator=gen, device=cuda,
                       dtype=torch.int32)
    wy, wx = (torch.rand(p, generator=gen, device=cuda) for _ in range(2))
    assert ibilinear.ibilinear_plan(img.shape, p, img.dtype, True)["wide"]
    _same("ibilinear",
          _launched_once(ibilinear, "ibilinear", img, iy, ix, wy, wx),
          ibilinear.ibilinear_plain(img, iy, ix, wy, wx), torch.bfloat16)
    del img
    torch.cuda.empty_cache()


# M straddles the small-M thresholds (8 in bf16, 16 in fp32) and the wgmma
# tile (64); N 8512 is zamba2's input projection (ragged to 64 and 128),
# 100 ragged to 8; K 100 is ragged to 16 and to 8
GEMM_M = (1, 4, 5, 8, 9, 16, 17, 64, 65, 2048)
GEMM_N = (64, 8512, 100)
GEMM_K = (2048, 8192, 100)


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("k", GEMM_K)
@pytest.mark.parametrize("n", GEMM_N)
@pytest.mark.parametrize("m", GEMM_M)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_gemm_variant_matches_plain_on_card(cuda, dtype, m, n, k, bias):
    """Each variant against gemm_plain, and the variant that ran is the
    one ``gemm.variant`` names.  Weights scaled by K**-0.5 as the model's;
    with a bias the clamp is finite."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(m * 7 + n * 3 + k + bias)
    a = torch.from_numpy(_f(rng, (m, k))).to(cuda, dtype)
    b = torch.from_numpy(_f(rng, (k, n), k ** -0.5)).to(cuda, dtype)
    c = torch.from_numpy(_f(rng, (n,))).to(cuda, dtype) if bias else None
    lo, hi = (-1.5, 1.5) if bias else (float("-inf"), float("inf"))
    kind = gemm.variant(dtype, m)
    before = dict(gemm.LAUNCHES)
    got = gemm.gemm(a, b, c, lo, hi)
    assert gemm.LAUNCHES["gemm"] == before["gemm"] + 1
    for v in gemm.VARIANTS:
        assert gemm.LAUNCHES[f"gemm_{v}"] == \
            before[f"gemm_{v}"] + (v == kind)
    _same("gemm", got, gemm.gemm_plain(a, b, c, lo, hi), dtype)


@pytest.mark.parametrize("m", (4, 40))
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_gemm_variant_propagates_nan(cuda, dtype, m):
    """NaN and +-inf in A through each variant and the clamp: a NaN row
    stays NaN, the infinities are bounded, as in the plain version."""
    rng = np.random.default_rng(m)
    a = _f(rng, (m, 24))
    a[1, 2], a[3, 0] = np.nan, np.inf
    b, bias = np.abs(_f(rng, (24, 72))) + 0.1, _f(rng, (72,))
    args = [torch.from_numpy(t).to(cuda, dtype) for t in (a, b, bias)]
    got = gemm.gemm(*args, -1.0, 1.0)
    _same("gemm", got, gemm.gemm_plain(*args, -1.0, 1.0), dtype)
    assert bool(got[1].isnan().all()) and bool((got[3] == 1.0).all())


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_gemm_split_k_is_deterministic(cuda, dtype):
    """Two runs of the split-K kernel at a decode shape agree bitwise: the
    slices are added in one fixed order, with no atomics."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(_f(rng, (4, 8192))).to(cuda, dtype)
    b = torch.from_numpy(_f(rng, (8192, 2048), 8192 ** -0.5)).to(cuda, dtype)
    assert gemm.split_k(2048, 8192, dtype)[0] > 1
    first = gemm.gemm(a, b)
    for _ in range(3):
        assert torch.equal(gemm.gemm(a, b), first)


# deepseek-v2-lite-16b's and minicpm3-4b's serving products (m, k, n): a
# decode step's M = 4 and a prefill's M = 2048 against each weight (the
# head (2048, 102400) among deepseek's), and W_uk / W_uv, which only a
# prefill multiplies by a linear
MLA_GEMM = [(m, k, n) for k, n in (
    (2048, 3072), (2048, 576), (2048, 2048), (2048, 10944), (10944, 2048),
    (2048, 2816), (2816, 2048), (2048, 102400),
    (2560, 768), (768, 3840), (2560, 288), (2560, 2560), (2560, 6400),
    (6400, 2560)) for m in (4, 2048)] + [(2048, 512, 2048), (2048, 256, 2560)]


@pytest.mark.parametrize("shape", MLA_GEMM, ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_gemm_at_the_mla_serving_shapes_matches_plain_on_card(cuda, dtype,
                                                              shape):
    """One launch of the variant ``gemm.variant`` names, within the
    reference's TOL of the plain version; inputs made on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    m, k, n = shape
    gen = torch.Generator(device=cuda)
    gen.manual_seed(m + k + n)
    a = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
    b = (torch.randn((k, n), generator=gen, device=cuda)
         * k ** -0.5).to(dtype)
    kind = gemm.variant(dtype, m)
    before = dict(gemm.LAUNCHES)
    got = gemm.gemm(a, b)
    assert gemm.LAUNCHES[f"gemm_{kind}"] == before[f"gemm_{kind}"] + 1
    _same("gemm", got, gemm.gemm_plain(a, b), dtype)


# the silu's inputs in those archs' serving: deepseek's experts at capacity
# 240 (prefill) and 8 (decode), its shared experts and dense first layer,
# minicpm3's MLP
SILU_SHAPES = [(64, 240, 1408), (64, 8, 1408), (4, 512, 2816), (4, 1, 2816),
               (4, 512, 10944), (4, 1, 10944), (4, 512, 6400), (4, 1, 6400)]


@pytest.mark.parametrize("shape", SILU_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_vsigmoid_at_the_mla_serving_shapes_matches_plain_on_card(cuda,
                                                                  dtype,
                                                                  shape):
    x = torch.from_numpy(_input("vsigmoid", shape, seed=7)).to(cuda, dtype)
    before = ew.LAUNCHES["vsigmoid"]
    got = ew.vsigmoid(x)
    assert ew.LAUNCHES["vsigmoid"] == before + 1
    assert got.shape == x.shape and got.dtype == dtype
    _check("vsigmoid", got, ew.PLAIN["vsigmoid"](x))


# (m, n, k) and the plan each takes: the Figure-2 product and a thin one
# split by K, one with N off 4 split by K, the middle tile, N off 4 and
# K and N off 4 unsplit
SIMT_PLANS = [((256, 256, 512), (64, 64, 8, 64)),
              ((17, 64, 8192), (64, 64, 128, 64)),
              ((100, 70, 3000), (64, 64, 38, 80)),
              ((1024, 1024, 1024), (128, 64, 1, 1024)),
              ((300, 1001, 100), (64, 64, 2, 64)),
              ((129, 67, 33), (64, 64, 1, 33))]


@pytest.mark.parametrize("unaligned", [False, True],
                         ids=["aligned", "b_off_16"])
@pytest.mark.parametrize("shape,plan", SIMT_PLANS, ids=str)
def test_gemm_simt_plans_match_plain_on_card(cuda, shape, plan, unaligned):
    """The fp32 SIMT kernel on each of its tiles, split by K or not, with
    B as 16-byte copies or element by element (N off 4, or B a view one
    element into its storage), against gemm_plain with bias and clamp."""
    m, n, k = shape
    assert gemm.simt_plan(m, n, k) == plan
    rng = np.random.default_rng(m + n + k)
    a = torch.from_numpy(_f(rng, (m, k))).to(cuda)
    flat = torch.from_numpy(_f(rng, (k * n + 1,), k ** -0.5)).to(cuda)
    b = (flat[1:] if unaligned else flat[:-1]).view(k, n)
    c = torch.from_numpy(_f(rng, (n,))).to(cuda)
    before = gemm.LAUNCHES["gemm_simt"]
    got = gemm.gemm(a, b, c, -1.5, 1.5)
    assert gemm.LAUNCHES["gemm_simt"] == before + 1
    _same("gemm", got, gemm.gemm_plain(a, b, c, -1.5, 1.5), torch.float32)


def test_gemm_simt_split_is_deterministic(cuda):
    """Two runs of the SIMT kernel with K cut into slices (the Figure-2
    product) agree bitwise: the slices are added in one fixed order."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(_f(rng, (256, 512))).to(cuda)
    b = torch.from_numpy(_f(rng, (512, 256))).to(cuda)
    c = torch.from_numpy(_f(rng, (256,))).to(cuda)
    assert gemm.variant(torch.float32, 256) == "simt"
    assert gemm.simt_plan(256, 256, 512)[2] > 1
    first = gemm.gemm(a, b, c, -1.0, 1.0)
    for _ in range(3):
        assert torch.equal(gemm.gemm(a, b, c, -1.0, 1.0), first)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_conv_hwc_split_is_deterministic(cuda, dtype):
    """Two runs of conv_hwc under a sliced plan (the Figure-2 shape: 6 K
    slices of 192) agree bitwise: the slices are added in one fixed
    order."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(_f(rng, (1, 28, 28, 128))).to(cuda, dtype)
    w = torch.from_numpy(_f(rng, (3, 3, 128, 128), 0.1)).to(cuda, dtype)
    b = torch.from_numpy(_f(rng, (128,))).to(cuda, dtype)
    assert conv.conv_plan(x.shape, w.shape)[2] > 1
    first = conv.conv_hwc(x, w, b)
    for _ in range(3):
        assert torch.equal(conv.conv_hwc(x, w, b), first)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_dwconv_reads_an_x_off_16_bytes(cuda, dtype):
    """x a view 4 bytes off 16-byte alignment: the one-channel path,
    bitwise equal to the plain version."""
    rng = np.random.default_rng(7)
    shape = (2, 12, 14, 64)
    flat = torch.from_numpy(_f(rng, (int(np.prod(shape)) + 8,))).to(
        cuda, dtype)
    off = 4 // flat.element_size()
    x = flat[off:off + int(np.prod(shape))].view(shape)
    assert x.data_ptr() % 16 == 4
    w = torch.from_numpy(_f(rng, (3, 3, 64), 0.3)).to(cuda, dtype)
    b = torch.from_numpy(_f(rng, (64,))).to(cuda, dtype)
    _same("dwconv", conv.dwconv(x, w, b), conv.dwconv_plain(x, w, b), dtype)


def test_main_path_launches_each_kernel_once(cuda):
    """The ten Figure-2 ops through ops.* under rvv-128: the kernel tier
    for each, one launch each, the committed customized counts."""
    x = torch.from_numpy(_input("vsqrt", (1024, 1024), seed=7)).to(cuda)
    rng = np.random.default_rng(8)
    new_args = {}
    for op in NEW:
        floats, others, extra = _cases(op, rng)[0]
        new_args[op] = [_to(a, cuda, torch.float32)
                        for a in floats + others] + list(extra)
    mods = (ew,) + tuple({id(m): m for m in NEW.values()}.values())
    for m in mods:
        m.reset_launches()
    with use_target("rvv-128"), trace.count() as c:
        for op in OPS:
            getattr(ops, op)(x, *_extra(op))
        for op, args in new_args.items():
            getattr(ops, op)(*args)
    launches = {k: v for m in mods for k, v in m.LAUNCHES.items()}
    # the Figure-2 gemm (256 fp32 rows) runs the SIMT variant
    assert launches == {**{op: 1 for op in OPS + tuple(NEW)},
                        "gemm_simt": 1, "gemm_small_m": 0, "gemm_mma": 0}
    assert c["per_op"][("vtanh", "pallas")] == 5767168
    assert c["per_op"][("gemm", "pallas")] == 8421376
    assert c["per_op"][("argmaxpool", "pallas")] == 602112


def test_kernel_refuses_other_dtypes(cuda):
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ew.vtanh(torch.zeros(8, dtype=torch.float64, device=cuda))
    d = dict(dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gemm.gemm(torch.zeros((4, 4), **d), torch.zeros((4, 4), **d))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        conv.conv_hwc(torch.zeros((1, 4, 4, 2), **d),
                      torch.zeros((3, 3, 2, 2), **d))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        conv.dwconv(torch.zeros((1, 4, 4, 2), **d),
                    torch.zeros((3, 3, 2), **d))
    for op in ("maxpool", "argmaxpool"):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            pooling.KERNELS[op](torch.zeros((1, 4, 4, 2), dtype=torch.int32,
                                            device=cuda))
    i = torch.zeros(3, dtype=torch.int32, device=cuda)
    w = torch.zeros(3, device=cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ibilinear.ibilinear(torch.zeros((4, 4, 2), **d), i, i, w, w)
    with pytest.raises(TypeError, match="int32 corners"):
        ibilinear.ibilinear(torch.zeros((4, 4, 2), device=cuda), i.long(),
                            i.long(), w, w)


def test_build_is_reused(cuda):
    first = _build.build_all()
    assert _build.build_all() == first
    assert all(p.exists() for p in first.values())


# ---------------------------------------------------------------------------
# the LM kernels: flash_attention, decode_attention, ssd
# ---------------------------------------------------------------------------

LM_TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}


def _lm_close(got, want, dtype):
    assert got.shape == want.shape and got.dtype == want.dtype
    g, w = got.float().cpu().numpy(), want.float().cpu().numpy()
    assert np.isfinite(g).all()
    tol = LM_TOL[dtype]
    np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


# (B, Sq, Sk, H, Hkv, D, causal, window, softcap)
FLASH_CASES = [(4, 512, 512, 32, 32, 128, True, None, None),   # zamba2
               (4, 512, 512, 16, 8, 64, True, None, None),     # granite
               (2, 300, 300, 8, 4, 256, True, 64, 50.0),       # gemma2-like
               (2, 50, 200, 4, 2, 16, True, None, None),       # Sq < Sk
               (1, 37, 45, 6, 3, 24, False, None, 5.0),
               (2, 64, 64, 4, 2, 64, True, None, None),        # D 64
               (2, 200, 230, 4, 4, 64, True, 100, None),       # Sq > 64, ragged
               (1, 150, 150, 2, 1, 40, False, None, None),     # D off 16
               # gemma2 (window, softcap), gemma3 (MQA, window), whisper's
               # encoder, cross-attention and its one-row cross at a
               # decode step, pixtral (256 patches + 512 tokens)
               (4, 512, 512, 8, 4, 256, True, 4096, 50.0),
               (4, 1024, 1024, 4, 1, 256, True, 512, None),
               (4, 1500, 1500, 6, 6, 64, False, None, None),
               (4, 512, 1500, 6, 6, 64, False, None, None),
               (4, 1, 1500, 6, 6, 64, False, None, None),
               (4, 768, 768, 32, 8, 128, True, None, None)]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_attention_matches_plain_on_card(cuda, case, dtype):
    from repro_torch.kernels import flash_attention as fa
    b, sq, sk, h, hkv, d, causal, window, softcap = case
    rng = np.random.default_rng(sum(case[:6]))
    q, k, v = (torch.from_numpy(_f(rng, s)).to(cuda, dtype)
               for s in ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d)))
    before = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, causal, window, softcap)
    assert fa.LAUNCHES["flash_attention"] == before + 1
    _lm_close(got, fa.flash_attention_plain(q, k, v, causal, window,
                                            softcap), dtype)


# (B, S, H, Hkv, D, lengths, window, softcap)
DECODE_CASES = [(4, 544, 32, 32, 128, (512, 520, 530, 544), None, None),
                # granite: GQA 16/8 at D 64
                (4, 544, 16, 8, 64, (512, 520, 530, 544), None, None),
                (4, 200, 8, 4, 256, (0, 1, 100, 200), 64, 50.0),
                (3, 70, 4, 2, 16, (5, 69, 70), None, None),
                # a long cache over 17 splits, ragged
                (2, 4096, 8, 2, 128, (4000, 1234), None, None),
                # splits wholly past a row's length or before its window
                (4, 1024, 4, 4, 64, (0, 10, 300, 1024), 100, None),
                # D 20: rows read element by element
                (2, 300, 4, 2, 20, (300, 150), 100, 30.0),
                # gemma2 (softcap), gemma3's MQA over a full 512-slot
                # ring, whisper, pixtral (ragged)
                (4, 544, 8, 4, 256, (512, 520, 530, 544), None, 50.0),
                (4, 512, 4, 1, 256, (512, 512, 512, 512), None, None),
                (4, 544, 6, 6, 64, (512, 520, 530, 544), None, None),
                (4, 800, 32, 8, 128, (784, 790, 795, 800), None, None)]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", DECODE_CASES, ids=str)
def test_decode_attention_matches_plain_on_card(cuda, case, dtype):
    from repro_torch.kernels import flash_attention as fa
    b, s, h, hkv, d, lengths, window, softcap = case
    rng = np.random.default_rng(s + d)
    q, k, v = (torch.from_numpy(_f(rng, shape)).to(cuda, dtype)
               for shape in ((b, 1, h, d), (b, s, hkv, d), (b, s, hkv, d)))
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = fa.LAUNCHES["decode_attention"]
    got = fa.decode_attention(q, k, v, lens, window, softcap)
    assert fa.LAUNCHES["decode_attention"] == before + 1
    _lm_close(got, fa.decode_attention_plain(q, k, v, lens, window,
                                             softcap), dtype)


def _ssd_args(rng, b, s, h, p, g, n, dev, dtype):
    x = torch.from_numpy(_f(rng, (b, s, h, p))).to(dev, dtype)
    # slow decays (dt ~ 0.05, |A| ~ 1) so the state carries across chunks
    dt = torch.nn.functional.softplus(
        torch.from_numpy(_f(rng, (b, s, h)) - 3.0)).to(dev)
    A = -torch.from_numpy(np.exp(_f(rng, (h,), 0.5))).to(dev)
    B = torch.from_numpy(_f(rng, (b, s, g, n), 0.5)).to(dev, dtype)
    C = torch.from_numpy(_f(rng, (b, s, g, n), 0.5)).to(dev, dtype)
    D = torch.ones(h, device=dev)
    return x, dt, A, B, C, D


# (b, s, h, p, g, n): zamba2's prefill; mamba2's (n 128: 211,968 bytes of
# shared memory a block in fp32); s off the chunk; s < 8; g = 1; one
# position; 16 chunks in the state chain; p 128; p and n off 8
SSD_CASES = [(4, 512, 64, 64, 2, 64), (4, 512, 64, 64, 1, 128),
             (2, 300, 8, 16, 2, 32),
             (2, 5, 4, 16, 4, 16), (1, 130, 6, 32, 1, 8),
             (2, 1, 4, 64, 2, 64), (1, 2048, 8, 64, 2, 64),
             (1, 300, 4, 128, 2, 64), (2, 260, 4, 20, 2, 12)]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", SSD_CASES, ids=str)
def test_ssd_matches_plain_on_card(cuda, case, dtype):
    """Each call launches ssd.launches(s) kernels: the state pass and the
    output pass, or the output pass alone for one chunk."""
    from repro_torch.kernels import ssd
    args = _ssd_args(np.random.default_rng(sum(case)), *case, cuda, dtype)
    before = ssd.LAUNCHES["ssd"]
    got = ssd.ssd(*args)
    assert ssd.LAUNCHES["ssd"] == before + ssd.launches(case[1])
    _lm_close(got, ssd.ssd_plain(*args), dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_ssd_is_deterministic_and_masks_fast_decays(cuda, dtype):
    """Two runs agree bitwise (the states are chained in chunk order, no
    float atomics); dt 2 with A down to -60 over 300 positions stays finite
    and within tolerance (the decay is masked before exp)."""
    from repro_torch.kernels import ssd
    args = list(_ssd_args(np.random.default_rng(21), 1, 300, 4, 64, 1, 64,
                          cuda, dtype))
    args[1] = torch.full((1, 300, 4), 2.0, device=cuda)
    args[2] = -torch.linspace(1.0, 60.0, 4, device=cuda)
    first = ssd.ssd(*args)
    for _ in range(3):
        assert torch.equal(ssd.ssd(*args), first)
    _lm_close(first, ssd.ssd_plain(*args), dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_ssd_at_mamba2_shape_is_deterministic(cuda, dtype):
    """mamba2-1.3b's prefill call (n 128, g 1, with D): four chunks
    chained, 32 accumulator tiles a state block; two runs agree
    bitwise."""
    from repro_torch.kernels import ssd
    args = _ssd_args(np.random.default_rng(128), 4, 512, 64, 64, 1, 128,
                     cuda, dtype)
    first = ssd.ssd(*args)
    assert torch.equal(ssd.ssd(*args), first)


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "off_16"])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_decode_attention_reads_strided_cache_views(cuda, dtype, offset):
    """K and V as strided views of one (B, S + 7, 2, Hkv, D + 8) cache
    buffer, rows 16-byte aligned or one element off (the element path),
    against the plain version."""
    from repro_torch.kernels import flash_attention as fa
    b, s, h, hkv, d = 3, 700, 8, 4, 64
    rng = np.random.default_rng(11 + offset)
    buf = torch.from_numpy(_f(rng, (b, s + 7, 2, hkv, d + 8))).to(cuda, dtype)
    q = torch.from_numpy(_f(rng, (b, 1, h, d))).to(cuda, dtype)
    k = buf[:, :s, 0, :, offset:offset + d]
    v = buf[:, :s, 1, :, offset:offset + d]
    assert not k.is_contiguous()
    lens = torch.tensor((700, 333, 1), dtype=torch.int32, device=cuda)
    got = fa.decode_attention(q, k, v, lens, 500, None)
    _lm_close(got, fa.decode_attention_plain(q, k, v, lens, 500, None),
              dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_decode_attention_is_deterministic(cuda, dtype):
    """Two runs of decode at zamba2's shape (three splits) agree bitwise:
    the splits are merged in one fixed order, with no atomics."""
    from repro_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(_f(rng, shape)).to(cuda, dtype)
               for shape in ((4, 1, 32, 128), (4, 544, 32, 128),
                             (4, 544, 32, 128)))
    lens = torch.tensor((528, 100, 544, 1), dtype=torch.int32, device=cuda)
    assert fa.decode_plan(4, 32, 544, 128)[0] > 1
    first = fa.decode_attention(q, k, v, lens)
    for _ in range(3):
        assert torch.equal(fa.decode_attention(q, k, v, lens), first)


# -- the logical-op table (core.isa) on the card ------------------------------
#
# Every op in each of its tiers, on chip_smoke.isa_cases' inputs: unsigned
# 16- and 32-bit lanes (wraparound, saturation, logical shifts, ordered
# compares), float conversions of NaN/inf/out-of-range values, and the
# memory ops at offsets that clamp (whole-register windows), wrap once or
# drop (per-lane and masked stores) or gather clamped (per-lane loads).
# The card's result equals the CPU's bitwise; float lanes within
# chip_smoke.CARD_ULP for rsqrt and the float sums.

def _isa_on_card():
    from repro_torch.core import isa
    from repro_torch.core.registry import REGISTRY
    return [(op, t) for op in isa.__all__ for t in REGISTRY.tiers_of(op)]


@pytest.mark.parametrize("op,tier", _isa_on_card(),
                         ids=[f"{o}-{t}" for o, t in _isa_on_card()])
def test_isa_tier_on_the_card_equals_the_cpu(cuda, op, tier):
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    from repro_torch.core.registry import REGISTRY
    fn = REGISTRY.lowering(op, tier).fn
    for label, args in cs.isa_cases(op):
        card = fn(*cs.isa_args(op, args, cuda))
        host = fn(*cs.isa_args(op, args, "cpu"))
        card = card if isinstance(card, tuple) else (card,)
        host = host if isinstance(host, tuple) else (host,)
        for c, h in zip(card, host, strict=True):
            assert c.device.type == "cuda", label
            g, w = c.cpu().numpy(), h.numpy()
            assert g.shape == w.shape and g.dtype == w.dtype, label
            if np.issubdtype(w.dtype, np.floating):
                assert cs.ulp_gap(g.reshape(-1), w.reshape(-1)) <= \
                    cs.CARD_ULP.get(op, 0), label
            else:
                np.testing.assert_array_equal(g, w, err_msg=label)


# ---------------------------------------------------------------------------
# the port's JIT backend on the card: one CUDA graph per call signature
# ---------------------------------------------------------------------------
#
# ``PortedKernel.compile`` captures its first walk of a signature in a
# CUDA graph and replays it: the output equals the eager walk
# (``jit=False``) on the card bitwise, and the CPU's compiled output
# within the harness's conformance budget (integers bitwise).

_COMPILED_TARGETS = (("h100", False), ("rvv-1024", True))


def _corpus():
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root / "examples" / "neon_corpus"))
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    import harness
    from repro_torch import port
    return cs, harness, port.load_corpus(str(root / "examples" /
                                               "neon_corpus"))


def _corpus_names():
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] /
                           "examples" / "neon_corpus"))
    import harness
    return sorted(c.kernel for c in harness.cases())


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("target,revec", _COMPILED_TARGETS,
                         ids=[t for t, _ in _COMPILED_TARGETS])
@pytest.mark.parametrize("kernel", _corpus_names())
def test_compiled_kernel_replays_a_cuda_graph(cuda, kernel, target, revec):
    cs, harness, kernels = _corpus()
    from repro_torch import port
    k = kernels[kernel]
    port.compiled_cache_clear()
    step = cs.strip_step(k.fn)
    for n in sorted({0, 1, step - 1, step + 1, 64, 67}):
        case = {c.kernel: c for c in harness.cases(n=n, tail_n=n)}[kernel]
        args = cs.padded(case.make_args(np.random.default_rng(n)))
        ck = k.compile(target=target, revec=revec)
        out = _tuple(ck(*args))
        assert ck.last_call["captured"] and not ck.last_call["host_reads"]
        assert all(t.device.type == "cuda" for t in out)
        for _ in range(2):
            cs.same_bits(_tuple(ck(*args)), out, f"{kernel}/n={n} replay")
        cs.same_bits(_tuple(k.compile(target=target, revec=revec,
                                      jit=False)(*args)), out,
                     f"{kernel}/n={n} eager")
        # the CPU's compiled output: integers bitwise, floats within the
        # harness's budget (the card sums the reductions in another order)
        host = k.compile(target=target, revec=revec, device="cpu")(*args)
        cs.conform_ulp([t.cpu().numpy() for t in out],
                       [t.numpy() for t in _tuple(host)], case)
        want = case.reference(*args)
        cs.conform_ulp([t.cpu().numpy() for t in out], _tuple(want), case)
    port.compiled_cache_clear()


_BRANCH = """
void f(size_t n, const float* x, float* y) {
  float32x4_t v = vld1q_f32(x);
  float s = vaddvq_f32(v);
  float32x4_t w = vdupq_n_f32(0.0f);
  if (s > 0.0f) {
    w = vaddq_f32(v, v);
    vst1q_f32(y + 4, w);
  }
  vst1q_f32(y, w);
  *y = s > 1.0f ? s : -s;
}
"""
_GATHER = """
void f(size_t n, const int32_t* idx, const float* x, float* y) {
  int32_t k = vgetq_lane_s32(vld1q_s32(idx), 0);
  *y = *(x + k);
}
"""


def test_a_branch_on_device_data_is_captured(cuda):
    """Both arms run inside the graph and merge: each replay follows the
    data it is given, with no host read."""
    from repro_torch import port
    k = port.compile_kernel(_BRANCH)
    ck = k.compile(target="rvv-128")
    for sign in (1.0, -1.0, 1.0):
        x = (sign * np.array([0.5, 0.25, 1.0, 2.0], np.float32))
        args = (4, x, np.full(8, 9.0, np.float32))
        got = ck(*args)
        assert ck.last_call["captured"] and not ck.last_call["host_reads"]
        want = k(*args, target="rvv-128", device="cpu")
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


def test_data_reaching_an_offset_runs_without_a_graph(cuda):
    from repro_torch import port
    ck = port.compile_kernel(_GATHER).compile(target="rvv-128")
    x = np.arange(8, dtype=np.float32)
    for j in (3, 6):
        got = ck(4, np.array([j, 0, 0, 0], np.int32), x,
                 np.zeros(1, np.float32))
        assert float(got.cpu()[0]) == j
        assert not ck.last_call["captured"]
        assert ck.last_call["host_reads"] == 1


def test_captures_in_two_threads(cuda):
    """Capture is thread-local: two threads building and replaying their
    own kernels at once both get the eager walk's bits."""
    import threading
    cs, harness, kernels = _corpus()
    from repro_torch import port
    port.compiled_cache_clear()
    names = ("xnn_f32_vtanh_ukernel", "qs8_gemm_mx8_ukernel")
    cases = {c.kernel: c for c in harness.cases(n=256, tail_n=259)}
    results, errors = {}, []

    def work(name):
        try:
            args = cs.padded(cases[name].make_args(
                np.random.default_rng(1)))
            ck = kernels[name].compile(target="h100")
            results[name] = (args, [_tuple(ck(*args)) for _ in range(3)])
        except Exception as e:   # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for name, (args, outs) in results.items():
        eager = _tuple(kernels[name].compile(target="h100", jit=False)(
            *args))
        for out in outs:
            cs.same_bits(out, eager, name)
    port.compiled_cache_clear()


def test_the_ladder_on_the_card_is_not_degraded(cuda):
    cs, harness, kernels = _corpus()
    from repro_torch import port
    from repro_torch.port import faultinject, resilience
    port.compiled_cache_clear()
    resilience.reset_resilience()
    case = {c.kernel: c for c in harness.cases(n=67, tail_n=67)}[
        "xnn_f32_vdot_ukernel"]
    args = case.make_args(np.random.default_rng(0))
    k = kernels[case.kernel]
    out, rec = k.run_resilient(*args, target="h100")
    assert rec.used == "compiled+revec" and not rec.degraded
    assert out.device.type == "cuda"
    with faultinject.injected("compile.run", error=resilience.ExecError,
                              times=1):
        down, drec = k.run_resilient(*args, target="h100")
    assert drec.used == "compiled" and drec.degraded
    cs.same_bits((down,), (out,), "degraded rung")
    # a CPU entry of the cache never serves the card
    assert k.compile(target="h100", device="cpu") is not \
        k.compile(target="h100")
    port.compiled_cache_clear()
