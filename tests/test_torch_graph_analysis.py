"""``launch/graph_analysis.py`` against the closed forms of the JAX
package's ``tests/test_hlo_analysis.py``, and the stand-in launch path of
``kernels/_build.py``.

The reference counts a scan's body once a trip from the compiled HLO;
the port's counter sees a Python loop's ops as they are dispatched, so
the same closed forms hold with the loops unrolled.  Everything runs on
``meta`` tensors: shapes only.
"""
import pytest
import torch
import torch.distributed as dist
import torch.utils.checkpoint as tc

from repro_torch.core import use_policy, use_target
from repro_torch.kernels import _build, cost, gemm, ops
from repro_torch.launch import graph_analysis as GA


def meta(*shape, grad=False):
    return torch.empty(shape, device="meta").requires_grad_(grad)


def test_known_flops_loop():
    x, w = meta(256, 512), meta(512, 512)
    with GA.Counter() as c:
        y = x
        for _ in range(10):
            y = torch.tanh(y @ w)
    assert c.result()["flops"] == 10 * 2 * 256 * 512 * 512


def test_known_flops_remat_grad():
    """7 checkpointed steps under a gradient: forward, recompute and two
    products a step backward, 4x the forward (the gradient taken for x
    too, as the reference's scan body computes it for every step)."""
    x, w = meta(128, 256, grad=True), meta(256, 256, grad=True)

    def body(c):
        return torch.tanh(c @ w)
    with GA.Counter() as c:
        y = x
        for _ in range(7):
            y = tc.checkpoint(body, y, use_reentrant=False)
        torch.autograd.grad(y.sum(), (x, w))
    assert c.result()["flops"] == 4 * 7 * 2 * 128 * 256 * 256


def test_nested_loop_multiplicity():
    x, w = meta(64, 64), meta(64, 64)
    with GA.Counter() as c:
        y = x
        for _ in range(5):
            for _ in range(3):
                y = y @ w
    assert c.result()["flops"] == 5 * 3 * 2 * 64 * 64 * 64


def test_bytes_nonzero():
    x = meta(1024)
    with GA.Counter() as c:
        x + 1
    assert c.result()["bytes"] >= 2 * 4096        # read + write


def test_peak_bytes_follow_the_live_storages():
    """The tracked arguments, each op's output until it is freed."""
    x = meta(1024)
    with GA.Counter() as c:
        c.track({"x": x})
        y = x + 1
        z = y * 2
        del y
        w = z + 1
        del z, w
    assert c.result()["peak_bytes"] == 3 * 4096
    assert c.live == 4096


def test_fake_gemm_is_recorded_with_the_kernels_count():
    """A stand-in's gemm goes down the kernel path on the ``h100`` target:
    no library is loaded, nothing is launched or counted in ``LAUNCHES``,
    and the recorded work is ``cost.work``'s."""
    gemm.reset_launches()
    a = torch.empty((2048, 512), dtype=torch.bfloat16, device="meta")
    b = torch.empty((512, 1024), dtype=torch.bfloat16, device="meta")
    with use_policy("pallas"), _build.stand_in_card(), GA.Counter() as c:
        y = ops.gemm(a, b, target="h100")
        ops.gemm(a[:4], b, target="h100")
    r = c.result()
    assert r["launches"] == {"gemm": 2, "gemm_mma": 1, "gemm_small_m": 1}
    assert all(v == 0 for v in gemm.LAUNCHES.values())
    mma_bytes, mma_ops = cost.work("gemm", (a, b), y)
    assert mma_ops == 2 * 2048 * 512 * 1024
    small = cost.work("gemm", (a[:4], b), y[:4])
    assert r["flops"] == mma_ops + small[1]
    assert r["bytes"] >= mma_bytes + small[0]


def test_fake_cuda_tensor_through_gemm():
    """A FakeTensor on the card's device takes the stand-in path; a real
    CPU tensor runs the plain version and never records."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with use_policy("pallas"), _build.recording() as rec:
        with FakeTensorMode():
            a = torch.empty((64, 128), dtype=torch.bfloat16, device="cuda")
            b = torch.empty((128, 256), dtype=torch.bfloat16, device="cuda")
            y = ops.gemm(a, b, target="h100")
        assert y.device.type == "cuda" and tuple(y.shape) == (64, 256)
        assert [r["counts"] for r in rec] == [("gemm", "gemm_mma")]
        real = torch.ones((64, 128), dtype=torch.bfloat16)
        w = torch.ones((128, 256), dtype=torch.bfloat16)
        out = ops.gemm(real, w, target="h100")
        assert torch.equal(out, gemm.gemm_plain(real, w))
        assert len(rec) == 1
    assert not _build.stand_in(real)
    assert isinstance(_build.ptr(a), _build.FakePtr)
    assert type(_build.ptr(real)) is int


def test_meta_outside_the_stand_in_card_is_refused():
    a = torch.empty((4, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        gemm.gemm(a, a)
    with _build.stand_in_card():
        assert _build.route("gemm", a, a) == "cuda"
        assert isinstance(_build.ptr(a[1:]), _build.FakePtr)
        assert _build.ptr(a[1:]) == 16


def test_collectives_are_counted_by_kind():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", rank=0, world_size=4, store=FakeStore())
    try:
        x = meta(256, 512)
        with GA.Counter() as c:
            dist.all_reduce(x)
            parts = [torch.empty_like(x) for _ in range(4)]
            dist.all_gather(parts, x)
            out = torch.empty((1024, 512), device="meta")
            dist.all_gather_into_tensor(out, x)
            dist.reduce_scatter_tensor(meta(64, 512), x)
        r = c.result()
    finally:
        dist.destroy_process_group()
    n = 256 * 512 * 4
    assert r["collectives"] == {"all-reduce": n, "all-gather": 8 * n,
                                "reduce-scatter": n // 4}
    assert r["collective_total"] == n + 8 * n + n // 4


def test_elementwise_stand_in_counts_its_vector_ops():
    x = torch.empty((4, 512, 1024), dtype=torch.bfloat16, device="meta")
    with use_policy("pallas"), _build.stand_in_card(), \
            use_target("h100"), GA.Counter() as c:
        y = ops.vtanh(x)
    assert c.result()["launches"] == {"vtanh": 1}
    assert c.result()["flops"] == cost.work("vtanh", (x,), y)[1] > 0


def _m(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


F32 = torch.float32
# PERF.md's kernel table: (row, op, args, out, bound ms, bound by)
BOUND_ROWS = [
    ("5f", "gemm", (_m(2048, 2048), _m(2048, 8512)), _m(2048, 8512),
     0.072198, "operations"),
    ("11h", "flash_attention", (_m(4, 4096, 32, 128), _m(4, 4096, 32, 128),
                                _m(4, 4096, 32, 128), True, None),
     _m(4, 4096, 32, 128), 0.556006, "operations"),
    ("13e", "ssd", (_m(4, 4096, 64, 64), _m(4, 4096, 64, dtype=F32),
                    _m(64, dtype=F32), _m(4, 4096, 2, 64),
                    _m(4, 4096, 2, 64), _m(64, dtype=F32)),
     _m(4, 4096, 64, 64), 0.083886, "bytes")]


@pytest.mark.parametrize("row,op,args,out,ms,by", BOUND_ROWS,
                         ids=[r[0] for r in BOUND_ROWS])
def test_cost_gives_the_kernel_tables_bounds(row, op, args, out, ms, by):
    """``kernels/cost.py`` reproduces the bound of PERF.md's rows 5f (bf16
    gemm M 2048 at (2048, 8512)), 11h (flash at zamba2's train) and 13e
    (ssd at zamba2's train), which chip_smoke.py's bound column reads."""
    got, got_by, _, _ = cost.bound(op, args, out)
    assert round(got, 6) == ms and got_by == by
