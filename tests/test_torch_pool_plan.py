"""The host side of the port's pooling and ibilinear kernels, on the CPU.

``pooling.pool_plan`` and ``ibilinear.ibilinear_plan`` choose each
kernel's launch: the 16-byte vector of channels (4 fp32 or 8 bf16) or
one channel, the compile-time 2x2 window or the generic one, the
threads a pixel, the block size and the grid, and 32- or 64-bit
indexing.  The C entry points re-check these claims; here they are held
to their rules at channel counts on and off the vector, windows 1x1 to
3x3, inputs 4 bytes off 16-byte alignment and element counts on either
side of 2^31 (described, not allocated).  The kernels' decode of a
thread's work (pooling.cu ``window_origin``; ibilinear.cu's pixel
groups) is mirrored in numpy and held to the reference's windows and
pixels: every output is made once, from the right inputs.

The kernels themselves run only on the card (``test_torch_cuda.py``,
``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import pooling as jpool
from repro_torch.kernels import _build, ibilinear, pooling

CHANNELS = (8, 12, 64, 128, 130, 256)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
LANES = {"float32": 4, "bfloat16": 8}
WINDOWS = ((1, 1), (2, 2), (3, 2), (3, 3))
PAST_2_31 = (2, 1024, 1025, 1024)      # 2,149,580,800 elements
BELOW_2_31 = (2, 1024, 1023, 1024)     # 2,145,386,496 elements


def _tensor(shape, dtype, off16=False):
    """A CPU tensor of ``shape``, at a 16-byte-aligned address or (off16)
    4 bytes past one."""
    n = int(np.prod(shape))
    flat = torch.zeros(n + 16, dtype=dtype)
    base = (-flat.data_ptr() % 16) // flat.element_size()
    if off16:
        base += 4 // flat.element_size()
    t = flat[base:base + n].view(shape)
    assert t.data_ptr() % 16 == (4 if off16 else 0)
    return t


# ---------------------------------------------------------------------------
# pool_plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("off16", [False, True], ids=["aligned", "off16"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("c", CHANNELS)
def test_vector16_needs_whole_vectors_and_alignment(c, dtype, off16):
    """A 16-byte vector of channels where C is a multiple of its lanes and
    x and the outputs are 16-byte aligned; one channel otherwise."""
    x = _tensor((1, 2, 2, c), DTYPES[dtype], off16)
    y = _tensor((1, 1, 1, c), DTYPES[dtype])
    idx = _tensor((1, 1, 1, c), torch.int32)
    want = c % LANES[dtype] == 0 and not off16
    assert _build.vector16(x, y, idx) == want
    assert _build.vector16(x, y, None) == want
    plan = pooling.pool_plan(x.shape, x.dtype, (2, 2), want)
    assert plan["vector"] == want
    assert plan["lanes"] == (LANES[dtype] if want else 1)


def test_vector16_refuses_an_output_off_16_bytes():
    x = _tensor((1, 2, 2, 8), torch.float32)
    assert not _build.vector16(x, _tensor((1, 1, 1, 8), torch.float32,
                                              off16=True))
    assert not _build.vector16(x, _tensor((1, 1, 1, 8), torch.float32),
                                   _tensor((1, 1, 1, 8), torch.int32,
                                           off16=True))


@pytest.mark.parametrize("window", WINDOWS, ids=str)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("c", CHANNELS)
def test_pool_plan_window_and_grid(c, dtype, window):
    """The 2x2 window is the compile-time instantiation, every other one
    the generic; the grid has a thread for every output vector, and a
    grid of fewer blocks than SMs has blocks of 32 threads."""
    shape = (2, 13, 15, c)
    vector = c % LANES[dtype] == 0
    plan = pooling.pool_plan(shape, DTYPES[dtype], window, vector)
    assert plan["window"] == ("2x2" if window == (2, 2) else "generic")
    n, h, w, _ = shape
    vectors = n * (h // window[0]) * (w // window[1]) * (c // plan["lanes"])
    assert plan["blocks"] == -(-vectors // plan["threads"])
    assert plan["threads"] in (32, 64, 128, 256)
    assert plan["blocks"] >= _build.SMS or plan["threads"] == 32
    assert not plan["wide"]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape,wide", [(BELOW_2_31, False),
                                        (PAST_2_31, True)], ids=str)
def test_pool_plan_is_64_bit_from_2_31_elements(shape, wide, dtype):
    """64-bit indexing exactly where x has 2^31 or more elements; the grid
    of a large pool fills the card with 256-thread blocks."""
    plan = pooling.pool_plan(shape, DTYPES[dtype], (2, 2), True)
    assert plan["wide"] == wide
    assert plan["threads"] == _build.THREADS
    n, h, w, c = shape
    vectors = n * (h // 2) * (w // 2) * c // LANES[dtype]
    assert plan["blocks"] * plan["threads"] >= vectors


def _pool_origins(shape, window, lanes):
    """pooling.cu's window_origin for every output vector o, in order."""
    n, h, w, c = shape
    kh, kw = window
    oh, ow, cv = h // kh, w // kw, c // lanes
    o = np.arange(n * oh * ow * cv, dtype=np.int64)
    row, pos = o // (ow * cv), o % (ow * cv)
    ox, ch = pos // cv, pos % cv * lanes
    img, oy = row // oh, row % oh
    return ((img * h + oy * kh) * w + ox * kw) * c + ch


@pytest.mark.parametrize("window", WINDOWS, ids=str)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("c", CHANNELS)
def test_pool_decode_reads_the_reference_windows(c, dtype, window):
    """Output vector o, read at its window origin + (i*W + j)*C + lane,
    tap by tap in (i, j) order, gives the reference kernel's max and
    first-max index at output element o*lanes + lane."""
    shape = (2, 7, 8, c)
    kh, kw = window
    plan = pooling.pool_plan(shape, DTYPES[dtype], window,
                             c % LANES[dtype] == 0)
    lanes = plan["lanes"]
    x = np.random.default_rng(c + kh * 10 + kw).standard_normal(
        shape).astype(np.float32)
    flat = x.reshape(-1)
    origin = _pool_origins(shape, window, lanes)
    taps = np.stack([flat[origin[:, None] + (i * shape[2] + j) * c
                          + np.arange(lanes)]
                     for i in range(kh) for j in range(kw)])
    want_v, want_i = jpool.argmaxpool(jnp.asarray(x), window, interpret=True)
    np.testing.assert_array_equal(taps.max(axis=0).reshape(-1),
                                  np.asarray(want_v).reshape(-1))
    np.testing.assert_array_equal(taps.argmax(axis=0).reshape(-1),
                                  np.asarray(want_i).reshape(-1))


# ---------------------------------------------------------------------------
# ibilinear_plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("off16", [False, True], ids=["aligned", "off16"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("c", CHANNELS)
def test_ibilinear_plan_groups(c, dtype, off16):
    """16-byte vectors where C is a multiple of their lanes and img is
    aligned; a pixel takes its vectors rounded up to a power of two of
    threads, at most a warp (which then loops over C), and the grid
    covers every pixel."""
    img = _tensor((3, 4, c), DTYPES[dtype], off16)
    out = _tensor((5, c), DTYPES[dtype])
    vector = c % LANES[dtype] == 0 and not off16
    assert _build.vector16(img, out) == vector
    p = 1001
    plan = ibilinear.ibilinear_plan(img.shape, p, img.dtype, vector)
    lanes = LANES[dtype] if vector else 1
    vectors = c // lanes
    assert plan["lanes"] == lanes
    group = plan["group"]
    assert group & (group - 1) == 0 and group <= 32
    assert group >= vectors or group == 32
    assert group < 2 * vectors
    assert plan["pixels_per_warp"] * group == 32
    warps = plan["blocks"] * plan["threads"] // 32
    assert warps * plan["pixels_per_warp"] >= p
    assert (plan["blocks"] - 1) * plan["threads"] // 32 * \
        plan["pixels_per_warp"] < p
    assert not plan["wide"]


def test_ibilinear_plan_figure2_and_large_shapes():
    """The Figure-2 image (C 64 fp32): 16 threads a pixel, two pixels a
    warp; the large one (C 128): a warp a pixel in fp32, two pixels a
    warp in bf16."""
    f2 = ibilinear.ibilinear_plan((56, 56, 64), 3136, torch.float32, True)
    assert (f2["group"], f2["pixels_per_warp"]) == (16, 2)
    big = ibilinear.ibilinear_plan((512, 512, 128), 512 * 512,
                                   torch.float32, True)
    assert (big["group"], big["threads"]) == (32, 256)
    big16 = ibilinear.ibilinear_plan((512, 512, 128), 512 * 512,
                                     torch.bfloat16, True)
    assert big16["group"] == 16


@pytest.mark.parametrize("img_shape,p,wide", [
    ((46340, 46340, 1), 10, False),      # H*W*C 2,147,395,600
    ((46341, 46341, 1), 10, True),       # H*W*C 2,147,488,281
    ((1024, 1024, 2047), 10, False),     # 2,146,435,072
    ((1024, 1024, 2049), 10, True),      # 2,148,532,224
    ((8, 8, 1024), 2 ** 21 - 1, False),  # P*C 2,147,482,624
    ((8, 8, 1024), 2 ** 21 + 1, True),   # P*C 2,147,484,672
], ids=str)
def test_ibilinear_plan_is_64_bit_from_2_31_offsets(img_shape, p, wide):
    """64-bit offsets exactly where H*W*C or P*C reach 2^31."""
    plan = ibilinear.ibilinear_plan(img_shape, p, torch.bfloat16, False)
    assert plan["wide"] == wide


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("c", CHANNELS)
def test_ibilinear_groups_make_every_output_once(c, dtype):
    """ibilinear.cu's mapping: warp wp, lane l takes pixel wp * ppw +
    l // group and channel vectors l % group, + group, ...: over the
    grid every (pixel, channel) is made exactly once."""
    p = 77
    vector = c % LANES[dtype] == 0
    plan = ibilinear.ibilinear_plan((5, 6, c), p, DTYPES[dtype], vector)
    lanes, group, ppw = plan["lanes"], plan["group"], \
        plan["pixels_per_warp"]
    made = np.zeros((p, c), np.int64)
    for wp in range(plan["blocks"] * plan["threads"] // 32):
        for lane in range(32):
            px = wp * ppw + lane // group
            if px >= p:
                continue
            for cv in range(lane % group, c // lanes, group):
                made[px, cv * lanes:(cv + 1) * lanes] += 1
    assert (made == 1).all()
