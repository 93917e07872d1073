"""The logical-op table ``repro_torch.core.isa`` against the JAX package's
``repro.core.isa``: every op of ``isa.__all__``, in each of its tiers, on
every NEON lane dtype it takes below 64 bits, on the same numpy-made
inputs (wraparound and saturation edges, NaN and +-inf for the float
ops, out-of-range offsets for the memory ops).

Integers must agree bitwise, unsigned 16- and 32-bit lanes included.
Floats agree bitwise too, except ``_FLOAT_ULP``'s ops, whose float sums or
reciprocal square roots may round differently in torch and in XLA on the
CPU; the largest gap allowed is stated there.  64-bit lanes are left out:
the reference runs without x64 and narrows them to 32 bits (ROADMAP
C.13).

The inputs are ``chip_smoke.isa_cases``, the table the card's ``isa``
phase runs.  The cost side: the tier set, and every candidate's validity and cost
under rvv-64, rvv-128, rvv-1024 and tpu-v5e, equal the JAX registry's;
on ``h100`` the customized tier is taken wherever it is valid.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__),
                                                "..")))

from chip_smoke import DT, isa_cases, ulp_gap  # noqa: E402
from repro.core import isa as jisa  # noqa: E402
from repro.core.registry import REGISTRY as JREG  # noqa: E402
from repro_torch.core import isa  # noqa: E402
from repro_torch.core.registry import REGISTRY  # noqa: E402
from repro_torch.core.vtypes import torch_dtype  # noqa: E402

# float ops whose result may round differently (in ULP of the lane type):
# reductions sum in another order, rsqrt is not a division
_FLOAT_ULP = {"vaddv": 2, "vfold": 2, "vrsqrte": 1}
COST_TARGETS = ("rvv-64", "rvv-128", "rvv-1024", "tpu-v5e")


def _to_jax(a):
    if isinstance(a, DT):
        return jnp.dtype(str(a))
    if isinstance(a, np.ndarray):
        return jnp.asarray(a)
    return a


def _to_torch(a):
    if isinstance(a, DT):
        return torch_dtype(str(a))
    if isinstance(a, np.ndarray):
        return torch.from_numpy(a.copy())
    return a


def _as_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _same(op, got, want, label):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want), label
    for g, w in zip(got, want):
        g, w = _as_numpy(g), np.asarray(w)
        assert g.shape == w.shape, f"{label}: {g.shape} vs {w.shape}"
        assert g.dtype == w.dtype, f"{label}: {g.dtype} vs {w.dtype}"
        g = np.ascontiguousarray(g).reshape(-1)
        w = np.ascontiguousarray(w).reshape(-1)
        if np.issubdtype(w.dtype, np.floating):
            gap = ulp_gap(g, w)
            assert gap <= _FLOAT_ULP.get(op, 0), f"{label}: {gap} ulp"
        else:
            assert np.array_equal(g, w), f"{label}: {g} vs {w}"


OPS = list(jisa.__all__)
OP_TIERS = [(op, t) for op in OPS for t in JREG.tiers_of(op)]


def test_the_op_table_is_the_reference_s():
    assert list(isa.__all__) == OPS and len(OPS) == 71
    for op in OPS:
        assert REGISTRY.tiers_of(op) == JREG.tiers_of(op), op
    assert isa.RVV_MNEMONICS == jisa.RVV_MNEMONICS
    for op in list(jisa.RVV_MNEMONICS) + ["nope"]:
        for dc in ("int", "uint", "float"):
            assert isa.rvv_mnemonics(op, dc) == jisa.rvv_mnemonics(op, dc)


@pytest.mark.parametrize("op,tier", OP_TIERS,
                         ids=[f"{o}-{t}" for o, t in OP_TIERS])
def test_tier_matches_the_reference(op, tier):
    jfn = JREG.lowering(op, tier).fn
    tfn = REGISTRY.lowering(op, tier).fn
    for label, args in isa_cases(op):
        targs = [_to_torch(a) for a in args]
        keep = [a.clone() for a in targs if isinstance(a, torch.Tensor)]
        want = jfn(*[_to_jax(a) for a in args])
        got = tfn(*targs)
        _same(op, got, want, f"{op}/{tier}/{label}")
        # stores are functional: the caller's tensors never change
        for a, k in zip([a for a in targs if isinstance(a, torch.Tensor)],
                        keep):
            assert torch.equal(a.view(torch.uint8), k.view(torch.uint8)), \
                f"{op}/{tier}/{label} wrote into an input"


@pytest.mark.parametrize("target", COST_TARGETS)
def test_selection_and_costs_match_the_reference(target):
    for op in OPS:
        for label, args in isa_cases(op)[:6]:
            jx = JREG.explain(op, *[_to_jax(a) for a in args],
                              policy="pallas", target=target)
            tx = REGISTRY.explain(op, *[_to_torch(a) for a in args],
                                  policy="pallas", target=target)
            rows = [(c["tier"], c["valid"], c["width_ok"], c["cost"],
                     c["chosen"]) for c in jx["candidates"]]
            assert [(c["tier"], c["valid"], c["width_ok"], c["cost"],
                     c["chosen"]) for c in tx["candidates"]] == rows, \
                f"{op}/{label} on {target}"
            jt, jc = JREG.cost_of(op, *[_to_jax(a) for a in args],
                                  policy="pallas", target=target)
            assert REGISTRY.cost_of(op, *[_to_torch(a) for a in args],
                                    policy="pallas",
                                    target=target) == (jt, jc)


def test_h100_takes_the_customized_tier_wherever_valid():
    for op in OPS:
        for label, args in isa_cases(op)[:3]:
            x = REGISTRY.explain(op, *[_to_torch(a) for a in args],
                                 policy="pallas", target="h100")
            kernel = [c for c in x["candidates"] if c["tier"] == "pallas"]
            if kernel and kernel[0]["valid"]:
                assert x["chosen"] == "pallas", f"{op}/{label}"
            else:
                assert x["chosen"] in ("vector", "generic"), f"{op}/{label}"


@pytest.mark.parametrize("target", ("rvv-128", "rvv-256", "rvv-512",
                                    "rvv-1024"))
def test_listing8_probe_keeps_the_vector_tier(target):
    """benchmarks/xnnpack_suite.py's vadd probe: simple arithmetic keeps
    the vector tier on the RVV family, as in the reference."""
    probe = torch.zeros((1024,), dtype=torch.float32)
    got = REGISTRY.explain("vadd", probe, probe, policy="pallas",
                           target=target)
    want = JREG.explain("vadd", jnp.zeros((1024,), jnp.float32),
                        jnp.zeros((1024,), jnp.float32), policy="pallas",
                        target=target)
    assert got["chosen"] == want["chosen"] == "vector"
    assert got["chosen_cost"] == want["chosen_cost"]


def test_unsigned_wraparound_through_dispatch():
    """The public entry points on u16/u32 lanes, end to end through the
    registry: wraparound, saturation, logical shifts, unsigned compares."""
    for dt, top in ((torch.uint16, 65535), (torch.uint32, 4294967295)):
        a = torch.tensor([top, top - 1, 1, 0], dtype=dt)
        b = torch.tensor([1, top, top, 0], dtype=dt)
        assert isa.vadd(a, b).tolist() == [0, top - 2, 0, 0]
        assert isa.vsub(b, a).tolist() == [2, 1, top - 1, 0]
        assert isa.vqadd(a, b).tolist() == [top, top, top, 0]
        assert isa.vqsub(b, a).tolist() == [0, 1, top - 1, 0]
        assert isa.vshr_n(a, 1).tolist() == [top >> 1, (top - 1) >> 1, 0, 0]
        assert isa.vmax(a, b).tolist() == [top, top, top, 0]
        assert isa.vcgt(a, b).tolist() == [top, 0, 0, 0]
        # jnp.sum widens u16 lanes to u32; u32 sums wrap
        assert isa.vaddv(a).item() == (2 * top) % 2**32
