"""The port's elementwise kernels against the JAX reference.

On the CPU the port's wrappers run the plain tile math; it is held
against the reference's Pallas kernels in interpret mode and against the
reference's dispatch path (rvv-128, policy 'pallas').  The same inputs,
made with numpy, go to both.  Tolerances:

  * fp32: rtol 1e-5, atol 2e-6 — a few ulps of reordering between XLA's
    CPU code and torch's; tanh's (1-z)/(1+z) cancels near 0, so the
    absolute term carries small |x|;
  * bf16: rtol = atol = 8e-3, one bf16 ulp at 1 (fp32 math that differs
    in its last bit can round to the neighbouring bf16 value);
  * vrelu: bitwise, NaN included.

Subnormal inputs are left out of the parity checks: XLA's CPU backend
flushes them (the reference gives vsqrt(1e-40) = 0) while the port keeps
IEEE subnormals (1e-20).  The comparison of kernel against plain version
on the card includes them (``chip_smoke.py``).

The kernels themselves are held against the plain versions on the card
in ``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import use_target as juse_target
from repro.kernels import elementwise as jew
from repro.kernels import ops as jops
from repro_torch.core import use_target
from repro_torch.core.registry import REGISTRY
from repro_torch.kernels import _build, ops
from repro_torch.kernels import elementwise as ew

OPS = ("vrelu", "vsqrt", "vtanh", "vsigmoid")
SHAPES = [(127,), (8, 130), (3, 5, 7), (1024, 1024)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(rtol=1e-5, atol=2e-6),
       "bfloat16": dict(rtol=8e-3, atol=8e-3)}
EDGE = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 20.0, -20.0, 30.0,
                 -30.0, 35.0, -35.0, 0.5, 2.5, 1.0, -1.0], np.float32)
RELU = (0.0, 6.0)


def _extra(op):
    return RELU if op == "vrelu" else ()


def _input(op, shape, seed):
    """Figure-2 input distributions (benchmarks/xnnpack_suite.py)."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if op == "vsqrt":
        return np.abs(x) + 0.01
    if op in ("vtanh", "vsigmoid"):
        return 2.0 * x
    return x


def _both(x, dtype):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def _np(y):
    if isinstance(y, torch.Tensor):
        return y.float().numpy()
    return np.asarray(y.astype(jnp.float32))


def _check(op, got, want, dtype):
    if op == "vrelu":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL[dtype])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("op", OPS)
def test_plain_path_matches_interpret_kernel(op, shape, dtype):
    jx, tx = _both(_input(op, shape, seed=len(shape) * 7 + 1), dtype)
    want = getattr(jew, op)(jx, *_extra(op), interpret=True)
    got = getattr(ew, op)(tx, *_extra(op))
    assert got.shape == tx.shape and got.dtype == tx.dtype
    _check(op, _np(got), _np(want), dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("op", OPS)
def test_dispatch_matches_reference_dispatch(op, shape, dtype):
    """ops.* under rvv-128 with the kernel tier allowed, both packages:
    the registry picks the customized tier and the outputs agree."""
    jx, tx = _both(_input(op, shape, seed=len(shape) * 7 + 2), dtype)
    with juse_target("rvv-128"):
        want = getattr(jops, op)(jx, *_extra(op), policy="pallas")
    with use_target("rvv-128"):
        assert REGISTRY.select(op, tx, *_extra(op),
                               policy="pallas").tier == "pallas"
        got = getattr(ops, op)(tx, *_extra(op), policy="pallas")
    _check(op, _np(got), _np(want), dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("op", OPS)
def test_edge_values_match_interpret_kernel(op, dtype):
    """Zeros of both signs, infinities, NaN, the clip points of tanh and
    sigmoid and beyond, and halfway points of the rounding."""
    jx, tx = _both(EDGE, dtype)
    want = _np(getattr(jew, op)(jx, *_extra(op), interpret=True))
    got = _np(getattr(ew, op)(tx, *_extra(op)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    _check(op, got, want, dtype)


def test_nan_propagates_like_the_reference():
    x = torch.tensor([np.nan])
    for op in OPS:
        assert torch.isnan(getattr(ew, op)(x, *_extra(op))).all(), op
    # vsqrt's fixups: 0 -> 0 first, then +-inf -> inf; negatives are NaN
    y = ew.vsqrt(torch.tensor([0.0, -0.0, np.inf, -np.inf, -4.0, 4.0]))
    np.testing.assert_array_equal(y.numpy()[:4], [0.0, 0.0, np.inf, np.inf])
    assert np.isnan(y.numpy()[4]) and y.numpy()[5] == 2.0


@pytest.mark.parametrize("lo,hi", [(0.1, 0.7), (-0.3, 1e-3), (0.0, 6.0)])
def test_vrelu_bounds_the_dtype_cannot_hold(lo, hi):
    """The reference rounds the bounds to x's dtype first; clamping with
    the exact bounds gives the same bf16 values, bit for bit."""
    x = np.linspace(-1.0, 1.0, 4097, dtype=np.float32)
    jx, tx = _both(x, "bfloat16")
    want = jew.vrelu(jx, lo, hi, interpret=True)
    np.testing.assert_array_equal(_np(ew.vrelu(tx, lo, hi)), _np(want))


def test_cpu_tensors_never_reach_the_builder(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached the CUDA builder")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build_all", refuse)
    monkeypatch.setattr(_build, "nvcc", refuse)
    before = dict(ew.LAUNCHES)
    x = torch.from_numpy(_input("vtanh", (64,), seed=3))
    for op in OPS:
        getattr(ew, op)(x, *_extra(op))
        getattr(ops, op)(x, *_extra(op), policy="pallas")
        with use_target("rvv-128"):
            getattr(ops, op)(x, *_extra(op), policy="pallas")
    assert ew.LAUNCHES == before


def test_launch_plan():
    """Two 16-byte vectors a thread only for a large bf16 tensor; a decode
    step's 32768 bf16 elements spread over more than 16 blocks; every plan
    covers the tensor with blocks of 32 to 256 threads."""
    assert ew.plan(1 << 26, 4) == (256, 1, 1 << 16)
    assert ew.plan(1 << 26, 2) == (256, 2, 1 << 14)
    assert ew.plan(4 * 512 * 8192, 2)[1] == 2
    threads, per, blocks = ew.plan(4 * 8192, 2)
    assert per == 1 and blocks >= ew.SMS - 4 and threads == 32
    for n in (1, 7, 127, 8191, 8193, 1 << 20, (1 << 26) + 3):
        for size in (2, 4):
            for aligned in (True, False):
                threads, per, blocks = ew.plan(n, size, aligned)
                assert 32 <= threads <= 256 and threads & (threads - 1) == 0
                vec = 16 // size if aligned else 1
                assert threads * per * blocks * vec >= n // vec * vec


def test_wrappers_refuse_other_devices():
    x = torch.empty(8, device="meta")
    for op in OPS:
        with pytest.raises(ValueError, match="CUDA or CPU"):
            getattr(ew, op)(x, *_extra(op))


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(_build.BuildError, match="nvcc not found"):
        _build.nvcc()


def _fake_nvcc(tmp_path, body):
    exe = tmp_path / "bin" / "nvcc"
    exe.parent.mkdir()
    exe.write_text("#!/bin/sh\n" + body)
    exe.chmod(0o755)
    return exe


def test_build_runs_nvcc_once_per_source(monkeypatch, tmp_path):
    """A stand-in nvcc writes its -o target and logs each call: the first
    build_all compiles every source, the second finds them built."""
    calls = tmp_path / "calls"
    exe = _fake_nvcc(tmp_path, f'echo "$@" >> {calls}\n'
                     'while [ "$1" != "-o" ]; do shift; done\n'
                     'echo lib > "$2"\n')
    monkeypatch.setenv("PATH", str(exe.parent))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    first = _build.build_all()
    assert set(first) == set(_build.sources())
    assert all(p.read_text() == "lib\n" for p in first.values())
    assert _build.build_all() == first
    lines = calls.read_text().splitlines()
    assert len(lines) == len(first)
    assert " ".join(_build.NVCC_FLAGS) in lines[0]


def test_failed_build_raises_and_leaves_nothing(monkeypatch, tmp_path):
    exe = _fake_nvcc(tmp_path, 'echo "error: refused" >&2\nexit 1\n')
    monkeypatch.setenv("PATH", str(exe.parent))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(_build.BuildError, match="refused"):
        _build.build_all()
    assert list((tmp_path / "build").iterdir()) == []


def test_build_target_is_keyed_by_source():
    out = _build._target("elementwise")
    assert out.parent == _build.BUILD_DIR
    assert out.name.startswith("libelementwise-") and out.suffix == ".so"
    assert _build.sources() == ["conv", "elementwise", "flash_attention",
                                "gemm", "ibilinear", "pooling", "ssd"]
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
