"""The port's CUDA kernels on the card, against their plain torch versions.

Every test here is marked ``cuda`` and skips without a card.  The module
imports neither jax nor the JAX package, so it runs on a machine that has
only PyTorch built for CUDA and the CUDA toolkit::

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q

Tolerances as in ``chip_smoke.py``: fp32 rtol 1e-5 / atol 2e-6, bf16 one
ulp at 1 (8e-3), vrelu bitwise; NaN and inf positions must agree.
Subnormal inputs are included.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import trace, use_target
from repro_torch.kernels import _build, ops
from repro_torch.kernels import elementwise as ew

pytestmark = pytest.mark.cuda

OPS = ("vrelu", "vsqrt", "vtanh", "vsigmoid")
SHAPES = [(127,), (8, 130), (3, 5, 7), (1024, 1024)]
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


def test_main_path_launches_each_kernel_once(cuda):
    x = torch.from_numpy(_input("vsqrt", (1024, 1024), seed=7)).to(cuda)
    ew.reset_launches()
    with use_target("rvv-128"), trace.count() as c:
        for op in OPS:
            getattr(ops, op)(x, *_extra(op))
    assert ew.LAUNCHES == {op: 1 for op in OPS}
    assert c["per_op"][("vtanh", "pallas")] == 5767168


def test_kernel_refuses_other_dtypes(cuda):
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ew.vtanh(torch.zeros(8, dtype=torch.float64, device=cuda))


def test_build_is_reused(cuda):
    first = _build.build_all()
    assert _build.build_all() == first and first["elementwise"].exists()
