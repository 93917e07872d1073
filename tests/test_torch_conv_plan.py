"""The host side of the port's conv kernels, on the CPU.

conv_hwc runs on the fp32 SIMT product that gemm's fp32 variant runs,
as an implicit GEMM (M = N*oh*ow pixels, N = Co, K = kh*kw*Ci): its plan
is ``gemm.simt_plan`` of those three, and A is the im2col matrix of x,
read through the decode that ``conv.im2col_offsets`` writes out once in
Python.  That decode gathers exactly the reference's windows (bitwise,
against slicing x tap by tap), and the product of the gathered rows with
the HWIO weights agrees with the JAX reference's ``ref.conv_hwc`` within
its kernel TOL (fp32 2e-4: the sums run in another order).  dwconv's
launch shape (``conv.dwconv_plan``) covers every channel and output
column once and fills the card where the shape allows.

The kernels themselves run only on the card (``test_torch_cuda.py``,
``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import conv, gemm, ref

TOL = dict(rtol=2e-4, atol=2e-4)

# (x shape, w shape, stride): the Figure-2 and large chip_smoke shapes,
# Ci 3 (an RGB first layer), Ci 24 with K slices that straddle taps, N 3
# (pixel tiles across images), 5x5 taps at stride 2, 1x1 taps, and the
# awkward shapes of chip_smoke.py
PLAN_CASES = [((1, 28, 28, 128), (3, 3, 128, 128), (1, 1)),
              ((8, 56, 56, 128), (3, 3, 128, 128), (1, 1)),
              ((2, 33, 35, 3), (3, 3, 3, 32), (1, 1)),
              ((1, 12, 12, 24), (3, 3, 24, 40), (1, 1)),
              ((3, 9, 10, 16), (3, 3, 16, 24), (1, 1)),
              ((2, 19, 21, 8), (5, 5, 8, 16), (2, 2)),
              ((2, 7, 9, 32), (1, 1, 32, 48), (1, 1)),
              ((2, 17, 19, 24), (3, 2, 24, 40), (2, 1)),
              ((2, 17, 19, 24), (1, 3, 24, 40), (2, 2))]


@pytest.mark.parametrize("xs,ws,stride", PLAN_CASES, ids=str)
def test_conv_plan_slices_cover_k_once(xs, ws, stride):
    """The plan is gemm's for (pixels, Co, kh*kw*Ci); its K slices are
    non-empty, disjoint and cover K once, each a multiple of the slot
    depth where there are several.  132 blocks at the Figure-2 shape
    (64 x 64 tiles x 6 slices of 192), 183 at the large one (128 x 128
    tiles, unsplit)."""
    oh, ow = conv.out_hw(xs[1], xs[2], ws[0], ws[1], stride)
    m, n, k = xs[0] * oh * ow, ws[3], ws[0] * ws[1] * ws[2]
    bm, bn, splits, ks = conv.conv_plan(xs, ws, stride)
    assert (bm, bn, splits, ks) == gemm.simt_plan(m, n, k)
    covered = np.zeros(k, np.int64)
    for s in range(splits):
        lo, hi = s * ks, min(k, (s + 1) * ks)
        assert hi > lo
        covered[lo:hi] += 1
    assert (covered == 1).all()
    assert splits == 1 or ks % gemm.SIMT_BK == 0
    blocks = -(-m // bm) * -(-n // bn) * splits
    if xs == (1, 28, 28, 128):
        assert (bm, bn, splits, ks, blocks) == (64, 64, 6, 192, 132)
    if xs == (8, 56, 56, 128):
        assert (bm, bn, splits, blocks) == (128, 128, 1, 183)
    if xs == (1, 12, 12, 24):
        # several slices, and a slice boundary inside a tap's channels
        assert splits > 1 and ks % xs[3] != 0


def _windows(x, ws, stride):
    """im2col by slicing x tap by tap: (pixels, kh*kw*Ci), columns in the
    (i, j, c) order of the HWIO weights."""
    kh, kw = ws[:2]
    n, h, w, ci = x.shape
    oh, ow = conv.out_hw(h, w, kh, kw, stride)
    taps = [x[:, i:i + stride[0] * (oh - 1) + 1:stride[0],
              j:j + stride[1] * (ow - 1) + 1:stride[1], :]
            for i in range(kh) for j in range(kw)]
    return torch.stack(taps, dim=3).reshape(n * oh * ow, kh * kw * ci)


@pytest.mark.parametrize("stride", [(1, 1), (2, 2)], ids=str)
@pytest.mark.parametrize("ci", [3, 24, 128])
def test_im2col_offsets_gather_the_reference_windows(ci, stride):
    """The kernel's decode (window origin + (kc // (kw*Ci)) * W*Ci +
    kc % (kw*Ci)) reads every tap of every output pixel's window, in the
    weights' (i, j, c) order; the gathered rows times the weights, plus
    the bias, agree with the port's and the JAX package's oracles."""
    rng = np.random.default_rng(ci + 10 * stride[0])
    xs, ws = (2, 11, 9, ci), (3, 2, ci, 16)
    x = rng.standard_normal(xs).astype(np.float32)
    w = (0.3 * rng.standard_normal(ws)).astype(np.float32)
    b = rng.standard_normal(ws[3]).astype(np.float32)
    tx = torch.from_numpy(x)
    rows, cols = conv.im2col_offsets(xs, ws, stride)
    a = tx.reshape(-1)[rows[:, None] + cols[None, :]]
    assert torch.equal(a, _windows(tx, ws, stride))
    oh, ow = conv.out_hw(xs[1], xs[2], ws[0], ws[1], stride)
    got = (a.double() @ torch.from_numpy(w).double().reshape(-1, ws[3])
           + torch.from_numpy(b).double()).reshape(xs[0], oh, ow, ws[3])
    want = jref.conv_hwc(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                         stride)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        got.numpy(), ref.conv_hwc(tx, torch.from_numpy(w),
                                  torch.from_numpy(b), stride).numpy(),
        **TOL)


# (x shape, w shape, dtype): the Figure-2 and large shapes, C 8 and 130,
# 5x5 and 1x1 windows, C 20 and 33 of chip_smoke.py
DW_CASES = [((1, 56, 56, 128), (3, 3, 128), torch.float32),
            ((16, 112, 112, 128), (3, 3, 128), torch.float32),
            ((1, 56, 56, 128), (3, 3, 128), torch.bfloat16),
            ((16, 112, 112, 128), (3, 3, 128), torch.bfloat16),
            ((2, 10, 12, 8), (3, 3, 8), torch.bfloat16),
            ((1, 9, 11, 130), (3, 3, 130), torch.float32),
            ((2, 12, 13, 64), (5, 5, 64), torch.float32),
            ((2, 6, 7, 48), (1, 1, 48), torch.bfloat16),
            ((2, 9, 11, 20), (1, 3, 20), torch.float32),
            ((3, 7, 5, 33), (3, 3, 33), torch.bfloat16)]


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "off_vector"])
@pytest.mark.parametrize("xs,ws,dtype", DW_CASES, ids=str)
def test_dwconv_plan_covers_every_output_once(xs, ws, dtype, offset):
    """The vector path (4 channels a thread) where C is a multiple of 4
    and the operands are aligned to the vector, else one channel a
    thread; a block's threads cover ``group`` channel vectors by
    ``DW_THREADS // group`` tasks of ``run`` output columns; the grid
    covers every channel vector and every (image, row, column) run, with
    no more than one block row or column to spare; the run is the
    largest that gives ``DW_BLOCKS`` blocks, or 1."""
    n, h, w, c = xs
    x = torch.zeros(n * h * w * c + offset, dtype=dtype)[offset:].view(xs)
    vector = conv.dwconv_vector(x, torch.zeros(ws, dtype=dtype))
    assert vector == (c % 4 == 0 and offset == 0)
    plan = conv.dwconv_plan(xs, ws, vector)
    oh, ow = conv.out_hw(h, w, ws[0], ws[1])
    lanes = conv.DW_LANES if vector else 1
    assert plan["lanes"] == lanes and plan["vector"] == vector
    group, run = plan["group"], plan["run"]
    gx, gy = plan["grid"]
    assert plan["block"] == [group, conv.DW_THREADS // group]
    assert group & (group - 1) == 0 and 1 <= group <= 32
    assert (gy - 1) * group < c // lanes <= gy * group
    tasks = n * oh * -(-ow // run)
    rows = conv.DW_THREADS // group
    assert (gx - 1) * rows < tasks <= gx * rows
    assert plan["blocks"] == gx * gy
    assert run in conv.DW_RUNS
    assert run == 1 or plan["blocks"] >= conv.DW_BLOCKS
    if run != conv.DW_RUNS[0]:
        bigger = conv.DW_RUNS[conv.DW_RUNS.index(run) - 1]
        assert -(-n * oh * -(-ow // bigger) // rows) * gy < conv.DW_BLOCKS
    if xs == (16, 112, 112, 128) and vector:
        assert run == 8
