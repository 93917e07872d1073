"""The port's cost models against the committed Figure-2 numbers.

``BENCH_xnnpack.json`` holds the reference's deterministic instruction
counts for the Figure-2 workloads.  The port's ``explain()`` must give
the same baseline and customized counts, and the same tiers, for the ten
Figure-2 ops at rvv-128/256/512/1024 and tpu-v5e — 50 rows, read from
the file — and the same TPU traffic ratios.  The port is held to the
committed file, not to the live reference, whose counts drift under the
installed jax (it counts a ``jit`` equation as a vector op: ``jnp.clip``
costs three, the committed file two).
"""
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import trace as jtrace
from repro.core import use_target as juse_target
from repro_torch.core import trace, use_target
from repro_torch.core.registry import REGISTRY, TIERS
from repro_torch.kernels import elementwise as ew
from repro_torch.kernels import ops  # noqa: F401  (registers lowerings)

BENCH = json.loads((Path(__file__).resolve().parents[1]
                    / "BENCH_xnnpack.json").read_text())["targets"]
RVV = ("rvv-128", "rvv-256", "rvv-512", "rvv-1024")
EW_OPS = ("vrelu", "vsqrt", "vtanh", "vsigmoid")
# the Figure-2 rows of BENCH_xnnpack.json, by row name -> registry op
FIG2 = {"gemm": "gemm", "convhwc": "conv_hwc", "dwconv": "dwconv",
        "maxpool": "maxpool", "argmaxpool": "argmaxpool", "vrelu": "vrelu",
        "vsqrt": "vsqrt", "vtanh": "vtanh", "vsigmoid": "vsigmoid",
        "ibilinear": "ibilinear"}


def _workload(op):
    """The Figure-2 inputs (benchmarks/xnnpack_suite.py: workloads()),
    made with numpy; only shapes and dtypes reach the cost models."""
    rng = np.random.default_rng(16)

    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32))

    if op in EW_OPS:
        x = f(1024, 1024)
        return {"vrelu": (x, 0.0, 6.0), "vsqrt": (x.abs() + 0.01,),
                "vtanh": (2.0 * x,), "vsigmoid": (2.0 * x,)}[op]
    if op == "gemm":
        return (f(256, 512), f(512, 256), f(256), -1.0, 1.0)
    if op == "conv_hwc":
        return (f(1, 28, 28, 128), 0.1 * f(3, 3, 128, 128), f(128))
    if op == "dwconv":
        return (f(1, 56, 56, 128), 0.3 * f(3, 3, 128), f(128))
    if op in ("maxpool", "argmaxpool"):
        return (f(1, 56, 56, 256), (2, 2))
    p = 56 * 56
    return (f(56, 56, 64),
            torch.from_numpy(rng.integers(0, 54, p).astype(np.int32)),
            torch.from_numpy(rng.integers(0, 54, p).astype(np.int32)),
            torch.from_numpy(rng.random(p).astype(np.float32)),
            torch.from_numpy(rng.random(p).astype(np.float32)))


def _row(op, target):
    """One Figure-2 row as xnnpack_suite computes it: the baseline is the
    highest valid tier under the vector cap on the RVV family, and the
    plain aten count (no union round-trip, no scalarized libm) on the
    TPU column; the customized count is the uncapped selection."""
    args = _workload(op)
    with use_target(target):
        cust = REGISTRY.explain(op, *args, policy="pallas")
        if target.startswith("rvv"):
            base = REGISTRY.explain(op, *args, policy="vector")
            ladder = max((c for c in base["candidates"]
                          if c["valid"] and c["cost"] is not None),
                         key=lambda c: TIERS.index(c["tier"]))
            b_tier, b_instrs = ladder["tier"], ladder["cost"]
        else:
            low = REGISTRY.select(op, *args, policy="vector")
            b_tier = low.tier
            b_instrs = trace.fx_vector_instrs(low.fn, *args)
    return {"baseline_tier": b_tier, "baseline_instrs": b_instrs,
            "customized_tier": cust["chosen"],
            "customized_instrs": cust["chosen_cost"]}


@pytest.mark.parametrize("target", RVV + ("tpu-v5e",))
@pytest.mark.parametrize("name", sorted(FIG2))
def test_figure2_row_matches_committed(name, target):
    want = BENCH[target][name]
    got = _row(FIG2[name], target)
    assert got == {k: want[k] for k in got}


@pytest.mark.parametrize("name", sorted(FIG2))
def test_tpu_traffic_ratio_matches_committed(name):
    """The TPU column's fusion win: unfused op-by-op bytes over the
    kernel's true input+output bytes (its tensor arguments and results,
    as the reference's suite counts them)."""
    op = FIG2[name]
    args = _workload(op)
    low = REGISTRY.select(op, *args, policy="vector", target="tpu-v5e")
    unfused = trace.fx_hbm_bytes(low.fn, *args)
    out = low.fn(*args)
    outs = out if isinstance(out, tuple) else (out,)
    fused = trace.io_bytes(*args, *outs)
    assert round(unfused / fused, 2) == \
        BENCH["tpu-v5e"][name]["traffic_ratio"]


def test_rvv128_counts_through_dispatch():
    """Counting the dispatched Figure-2 ops gives the committed customized
    (kernel tier) column, and under the vector cap the committed baseline
    column.  The cap dispatches the cheapest capped tier: that is the
    vector tier for nine ops, but the scalar loop for argmaxpool (2 per
    input element, 1605632, against the vector tier's 2010512) — the
    suite's baseline is the ladder's highest valid tier instead."""
    for policy, key in (("vector", "baseline_instrs"),
                        ("pallas", "customized_instrs")):
        with use_target("rvv-128"), trace.count() as c:
            for op in FIG2.values():
                getattr(ops, op)(*_workload(op), policy=policy)
        want = 0
        for name, op in FIG2.items():
            if policy == "vector" and op == "argmaxpool":
                got, n = c["per_op"][(op, "generic")], 2 * 56 * 56 * 256
            else:
                got = c["per_op"][(op, "vector" if policy == "vector"
                                   else "pallas")]
                n = BENCH["rvv-128"][name][key]
            assert got == n, name
            want += n
        assert c["total"] == want


def test_costing_a_huge_input_allocates_nothing():
    """The aten graph is captured on meta tensors: a 2^26-element input
    is costed as a meta tensor, which has no storage at all."""
    x = torch.empty(1 << 26, dtype=torch.float32, device="meta")
    with use_target("rvv-128"):
        assert trace.fx_vector_instrs(ref_tanh, x, scalarize=True) == \
            30 * (1 << 26)
        rep = REGISTRY.explain("vsigmoid", x, policy="vector")
    assert rep["chosen_cost"] == 28 * (1 << 26)


def ref_tanh(x):
    return torch.tanh(x.to(torch.float32)).to(x.dtype)


def test_aten_rules():
    x = torch.zeros(4096)
    with use_target("rvv-512"):
        v = 4096 // 16
        # a two-sided clamp is max then min; one bound is one op
        assert trace.fx_vector_instrs(lambda t: torch.clamp(t, 0.0, 6.0),
                                      x) == 2 * v
        assert trace.fx_vector_instrs(lambda t: torch.clamp(t, min=0.0),
                                      x) == v
        assert trace.fx_vector_instrs(lambda t: torch.clamp_min(t, 0.0),
                                      x) == v
        # sigmoid costs as the reference's logistic
        assert trace.fx_vector_instrs(torch.sigmoid, x) == 24 * v
        assert trace.fx_vector_instrs(torch.sigmoid, x,
                                      scalarize=True) == 28 * 4096
        # dtype casts are free: bf16 in, fp32 math, bf16 out
        xb = x.to(torch.bfloat16)
        assert trace.fx_vector_instrs(ref_tanh, xb) == \
            trace.fx_vector_instrs(torch.tanh, x) == 22 * v
        # the union round-trip doubles every vector op
        assert trace.fx_vector_instrs(lambda t: t * 2.0 + 1.0, x,
                                      union_overhead=True) == 4 * v
        # compares run at the data width, not the bool width
        assert trace.fx_vector_instrs(lambda t: t > 0, x) == v


# functions both packages write the same way, in primitives the live
# reference walk counts as the committed file does (jnp.where and
# jnp.clip are jit-wrapped and drift; lax.select is not)
_PAIRS = {
    "affine": (lambda t: t * 2.0 + 1.0, lambda a: a * 2.0 + 1.0),
    "tanh": (torch.tanh, jnp.tanh),
    "sqrt": (torch.sqrt, jnp.sqrt),
    "exp_mul": (lambda t: torch.exp(t) * t, lambda a: jnp.exp(a) * a),
    "select": (lambda t: torch.where(t > 0, t, -t),
               lambda a: jax.lax.select(a > 0, a, -a)),
    "sum": (lambda t: t.sum(), lambda a: a.sum()),
    "matmul": (lambda t: t @ t.T, lambda a: a @ a.T),
}


@pytest.mark.parametrize("target", ["rvv-128", "rvv-1024-m2", "tpu-v5e"])
@pytest.mark.parametrize("name", sorted(_PAIRS))
@pytest.mark.parametrize("scalarize,ovh", [(False, False), (True, True)])
def test_walk_matches_reference_walk(name, target, scalarize, ovh):
    tfn, jfn = _PAIRS[name]
    x = np.random.default_rng(0).standard_normal((64, 96)).astype(np.float32)
    with use_target(target):
        port = trace.fx_vector_instrs(tfn, torch.from_numpy(x),
                                      scalarize=scalarize,
                                      union_overhead=ovh)
    with juse_target(target):
        ref = jtrace.jaxpr_vector_instrs(jfn, jnp.asarray(x),
                                         scalarize=scalarize,
                                         union_overhead=ovh)
    assert port == ref


def test_hbm_bytes_match_reference_walk():
    x = np.random.default_rng(0).standard_normal((64, 96)).astype(np.float32)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    assert trace.fx_hbm_bytes(lambda t: torch.tanh(t) * t + t, tx) == \
        jtrace.jaxpr_hbm_bytes(lambda a: jnp.tanh(a) * a + a, jx)
    assert trace.io_bytes(tx, tx) == jtrace.io_bytes(jx, jx) == 2 * x.nbytes


@pytest.mark.parametrize("name", sorted(ew.CALIBRATION))
def test_elementwise_models_calibrated(name):
    """The declared ops/vreg of each customized kernel within 2x of the
    aten walk of the same tile math (the reference's calibration gate)."""
    fn, declared = ew.CALIBRATION[name]
    x = torch.linspace(0.1, 4.0, 1024)
    with use_target("rvv-512"):
        traced = trace.fx_vector_instrs(fn, x) / (1024 // 16)
    assert 0.5 <= traced / declared <= 2.0


def test_declared_cost_is_per_register_formula():
    x = torch.zeros(2048)
    for op in EW_OPS:
        low = REGISTRY.lowering(op, "pallas")
        for target in RVV + ("tpu-v5e", "h100"):
            with use_target(target):
                want = ew.DECLARED_OPS_PER_VREG[op] * math.ceil(
                    2048 / trace.vreg_for(torch.float32))
                assert low.cost(x) == want


def test_cost_target_scopes_the_costs_as_the_references():
    """``trace.cost_target``, the reference's historical name of
    ``use_target``: the same matmul costs the same under it on both
    sides, the MXU macro ops on tpu-v5e and the fma ladder on rvv-128."""
    assert trace.cost_target is use_target
    rng = np.random.default_rng(3)
    a = rng.standard_normal((256, 512)).astype(np.float32)
    b = rng.standard_normal((512, 256)).astype(np.float32)
    got = {}
    for name in ("tpu-v5e", "rvv-128"):
        with trace.cost_target(name):
            got[name] = trace.fx_vector_instrs(
                lambda x, y: x @ y, torch.from_numpy(a), torch.from_numpy(b))
        with jtrace.cost_target(name):
            want = jtrace.jaxpr_vector_instrs(
                lambda x, y: x @ y, jnp.asarray(a), jnp.asarray(b))
        assert got[name] == want, name
    assert got["rvv-128"] == 256 * 512 * 256 // 4
