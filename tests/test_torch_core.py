"""The port's spine against the JAX reference: targets, vtypes, masks and
the registry's selection machinery (select, explain, policy cap, LRU).

Inputs are made with numpy and handed to both packages."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import masks as jmasks
from repro.core import targets as jtargets
from repro.core import vtypes as jvtypes
from repro_torch.core import masks, registry, targets, trace, vtypes
from repro_torch.core.registry import REGISTRY, _akey, _Registry
from repro_torch.kernels import ops

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16),
          (jnp.int8, torch.int8), (jnp.int16, torch.int16),
          (jnp.int32, torch.int32), (jnp.float16, torch.float16)]


# ---------------------------------------------------------------------------
# targets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(jtargets.TARGETS))
def test_target_matches_reference(name):
    """Every reference target is registered with identical fields and
    answers every derived question identically."""
    ref = jtargets.get_target(name)
    port = targets.get_target(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert (port.vla, port.has_mxu, port.effective_vlen) == \
        (ref.vla, ref.has_mxu, ref.effective_vlen)
    for jdt, tdt in DTYPES:
        assert port.sublane(tdt) == ref.sublane(jdt)
        assert port.vreg_elems(tdt) == ref.vreg_elems(jdt)
        for n in (1, 127, 1 << 20):
            assert port.vinstrs(n, tdt) == ref.vinstrs(n, jdt)
        for lanes in (2, 4, 16):
            assert port.retile_factor(lanes, tdt) == \
                ref.retile_factor(lanes, jdt)
    for bits in (32, 64, 128, 256, 4096):
        assert port.supports_width(bits) == ref.supports_width(bits)
    for scale, live in ((1, 0), (2, 0), (1, 9), (2, 5)):
        assert port.admissible_lmuls(scale, live) == \
            ref.admissible_lmuls(scale, live)


def test_port_adds_only_h100():
    assert set(targets.TARGETS) == set(jtargets.TARGETS) | {"h100"}


def test_h100_is_the_data_sheet_card():
    h = targets.get_target("h100")
    assert (h.kind, h.lane, h.mxu, h.vmem_bytes) == ("cuda", 32, 64, 232448)
    assert h.hbm_bytes == 80 * 2**30 and h.hbm_bw == 3.35e12
    assert h.peak_flops_bf16 == 989e12 and h.ici_bw == 450e9
    assert h.has_vector_libm and h.has_mxu


def test_h100_is_a_fixed_tile_machine():
    h = targets.get_target("h100")
    assert not h.vla and h.effective_vlen == 0
    assert h.sublane(torch.float32) == 8
    assert h.sublane(torch.bfloat16) == 16
    assert h.sublane(torch.int8) == 32
    assert h.vreg_elems(torch.float32) == 8 * 32
    assert h.vinstrs(1 << 20, torch.float32) == (1 << 20) // 256
    assert h.retile_factor(4, torch.float32) == 1
    assert h.supports_width(1 << 20)
    assert h.admissible_lmuls(2, 30) == (1,)


def test_default_and_compile_target():
    assert targets.current_target().name == "h100"
    for name in ("rvv-128", "rvv-1024-m4", "tpu-v5e", "tpu-v6", "h100"):
        with targets.use_target(name):
            assert targets.compile_target().name == "h100"
    custom = dataclasses.replace(targets.get_target("h100"), name="h100-450w")
    with targets.use_target(custom):
        assert targets.compile_target() is custom


def test_use_target_scoping_and_lmul():
    base = targets.current_target().name
    with targets.use_target("rvv-256"):
        assert targets.current_target().name == "rvv-256"
        with targets.use_target("tpu-v6"):
            assert targets.current_target().name == "tpu-v6"
        assert targets.current_target().name == "rvv-256"
    assert targets.current_target().name == base
    assert targets.with_lmul("rvv-128", 4) == \
        targets.get_target("rvv-128-m4")
    with pytest.raises(ValueError):
        targets.with_lmul("h100", 2)
    with pytest.raises(KeyError):
        targets.get_target("no-such-target")


# ---------------------------------------------------------------------------
# vtypes
# ---------------------------------------------------------------------------

def test_neon_table_matches_reference():
    assert set(vtypes.NEON_TYPES) == set(jvtypes.NEON_TYPES)
    for tname in ("tpu-v5e", "rvv-256"):
        port = vtypes.neon_type_table(tname)
        ref = jvtypes.neon_type_table(tname)
        for name, tm in port.items():
            r = ref[name]
            assert tm.physical == r.physical, name
            assert tm.logical.shape == r.logical.shape
            assert tm.logical.bits == r.logical.bits
            assert (tm.valid, tm.vl, tm.padded_elems, tm.waste) == \
                (r.valid, r.vl, r.padded_elems, r.waste)


@pytest.mark.parametrize("tname", ["tpu-v5e", "rvv-128", "tpu-v6"])
def test_tile_for_matches_reference(tname):
    for jdt, tdt in DTYPES:
        for shape in ((), (5,), (100, 100), (3, 7, 129), (8, 128)):
            for mxu in (False, True):
                port = vtypes.tile_for(vtypes.LVec(shape, tdt), tname,
                                       mxu=mxu)
                ref = jvtypes.tile_for(jvtypes.LVec(shape, jdt), tname,
                                       mxu=mxu)
                assert port.physical == ref.physical, (shape, tdt, mxu)


def test_tile_for_on_h100():
    assert vtypes.tile_for(vtypes.LVec((100, 100), torch.float32),
                           "h100").physical == (104, 128)
    assert vtypes.tile_for(vtypes.LVec((100, 100), torch.bfloat16),
                           "h100").physical == (112, 128)
    assert vtypes.tile_for(vtypes.LVec((100, 100), torch.float32), "h100",
                           mxu=True).physical == (128, 128)
    assert vtypes.round_up(100, 32) == 128 == jvtypes.round_up(100, 32)


def test_vmem_fit_matches_reference_and_h100_budget():
    for tname in ("tpu-v5e", "tpu-v6", "rvv-128"):
        for n in (1024, 1 << 20, 4 << 20, 16 << 20):
            assert vtypes.vmem_fit([(n, torch.float32)], tname) == \
                jvtypes.vmem_fit([(n, jnp.float32)], tname)
    # h100: the 227 KB a block can use, with the reference's 10% headroom
    fits = int(232448 * 0.9) // 4
    assert vtypes.vmem_fit([(fits, torch.float32)], "h100")
    assert not vtypes.vmem_fit([(fits + 1, torch.float32)], "h100")
    assert vtypes.vmem_fit([(fits, torch.bfloat16), (fits // 2,
                                                     torch.bfloat16)],
                           "h100")


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,cols,extra", [(1, 1, 0), (3, 5, 2),
                                             (17, 9, 7), (8, 128, 3)])
def test_masks_match_reference(rows, cols, extra):
    rng = np.random.default_rng(rows * 100 + cols)
    x = rng.standard_normal((rows, cols)).astype(np.float32)
    padded = (rows + extra, cols + extra + 1)
    xp = masks.pad_to(torch.from_numpy(x), padded, value=-1.0)
    np.testing.assert_array_equal(
        xp.numpy(), np.asarray(jmasks.pad_to(jnp.asarray(x), padded, -1.0)))
    np.testing.assert_array_equal(masks.unpad(xp, (rows, cols)).numpy(), x)
    np.testing.assert_array_equal(
        masks.tail_mask((rows, cols), padded, device="cpu").numpy(),
        np.asarray(jmasks.tail_mask((rows, cols), padded)))
    dst = np.full(padded, 7.0, np.float32)
    src = rng.standard_normal(padded).astype(np.float32)
    np.testing.assert_array_equal(
        masks.masked_store(torch.from_numpy(dst), torch.from_numpy(src),
                           (rows, cols)).numpy(),
        np.asarray(jmasks.masked_store(jnp.asarray(dst), jnp.asarray(src),
                                       (rows, cols))))
    tm = vtypes.tile_for(vtypes.LVec((rows, cols), torch.float32), "tpu-v5e")
    jtm = jvtypes.tile_for(jvtypes.LVec((rows, cols), jnp.float32),
                           "tpu-v5e")
    pt, m = masks.padded_and_mask(torch.from_numpy(x), tm)
    jpt, jm = jmasks.padded_and_mask(jnp.asarray(x), jtm)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jpt))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    for fill in (0.0, -np.inf):
        np.testing.assert_array_equal(
            masks.masked_select(pt, tm, fill).numpy(),
            np.asarray(jmasks.masked_select(jpt, jtm, fill)))


def test_masked_reduction_identity():
    x = torch.ones((3, 5), dtype=torch.float32)
    tm = vtypes.tile_for(vtypes.LVec((3, 5), torch.float32))
    xp = masks.pad_to(-2 * x, tm.physical)
    assert float(masks.masked_select(xp, tm, -np.inf).max()) == -2.0
    assert float(masks.masked_select(xp, tm, 0.0).sum()) == -30.0


def test_tensor_factories_default_to_cuda():
    """Functions that create tensors default to the card and never fall
    back to the CPU."""
    if torch.cuda.is_available():
        assert masks.tail_mask((2,), (4,)).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        masks.tail_mask((2,), (4,))
    with pytest.raises(RuntimeError, match="CUDA"):
        targets.resolve_device()
    assert targets.resolve_device("cpu").type == "cpu"


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def _x(shape=(64, 64), dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


def test_tiers_and_default_policy():
    assert registry.TIERS == ("generic", "vector", "pallas")
    for op in ("vrelu", "vsqrt", "vtanh", "vsigmoid"):
        assert REGISTRY.tiers_of(op) == ["generic", "vector", "pallas"]
    assert ops.default_policy() == \
        ("pallas" if torch.cuda.is_available() else "vector")
    assert REGISTRY._default == ops.default_policy()


def test_select_is_cost_driven_per_target():
    x = _x((1024, 1024))
    for op in ("vrelu", "vsqrt", "vtanh", "vsigmoid"):
        assert REGISTRY.select(op, x, policy="pallas",
                               target="rvv-128").tier == "pallas"
    # with a vector libm and no union overhead, sqrt is one op per
    # register on the vector tier against the kernel's declared 12
    assert REGISTRY.select("vsqrt", x, policy="pallas",
                           target="tpu-v5e").tier == "vector"
    # the others tie, and ties go to the more specialized tier
    for op in ("vtanh", "vsigmoid"):
        rep = REGISTRY.explain(op, x, policy="pallas", target="tpu-v5e")
        costs = {c["tier"]: c["cost"] for c in rep["candidates"]}
        assert costs["vector"] == costs["pallas"]
        assert rep["chosen"] == "pallas"
    # h100 runs the kernel wherever it is valid: all four at the Figure-2
    # size, vsqrt too, although its declared counts (the fixed-tile model
    # tpu-v5e's are) still rank the vector tier cheaper; the policy cap
    # still holds
    for op in ("vrelu", "vsqrt", "vtanh", "vsigmoid"):
        rep = REGISTRY.explain(op, x, policy="pallas", target="h100")
        assert rep["chosen"] == "pallas"
        assert REGISTRY.select(op, x, policy="pallas",
                               target="h100").tier == "pallas"
        assert REGISTRY.select(op, x, policy="vector",
                               target="h100").tier == "vector"
    rep = REGISTRY.explain("vsqrt", x, policy="pallas", target="h100")
    costs = {c["tier"]: c["cost"] for c in rep["candidates"]}
    assert costs["vector"] < costs["pallas"]


def test_policy_cap_reproduces_original_simde():
    x = _x()
    assert REGISTRY.select("vtanh", x, policy="vector",
                           target="rvv-128").tier == "vector"
    assert REGISTRY.select("vtanh", x, policy="generic",
                           target="rvv-128").tier == "generic"
    with registry.use_policy("vector"):
        assert REGISTRY.policy == "vector"
        rep = REGISTRY.explain("vtanh", x, target="rvv-128")
        assert [c["tier"] for c in rep["candidates"]] == \
            ["generic", "vector"]
    with pytest.raises(ValueError):
        REGISTRY.select("vtanh", x, policy="fastest")
    with pytest.raises(KeyError):
        REGISTRY.select("no_such_op", x, policy="vector")


def test_explain_report_shape_matches_reference():
    import repro.core.registry as jreg
    from repro.kernels import ops as jops  # noqa: F401  (registers)
    x = _x((128, 128))
    port = REGISTRY.explain("vsigmoid", x, policy="pallas", target="rvv-128")
    ref = jreg.REGISTRY.explain("vsigmoid", jnp.zeros((128, 128)),
                                policy="pallas", target="rvv-128")
    assert port.keys() == ref.keys()
    assert [c.keys() for c in port["candidates"]] == \
        [c.keys() for c in ref["candidates"]]
    assert (port["op"], port["target"], port["chosen"]) == \
        (ref["op"], ref["target"], ref["chosen"])
    assert port["chosen_cost"] == ref["chosen_cost"]
    assert [c["tier"] for c in port["candidates"]] == \
        [c["tier"] for c in ref["candidates"]]


def test_width_rule_drops_vector_tiers_on_short_registers():
    x = _x((8,))             # 256-bit operand saturates at 128 bits
    rep = REGISTRY.explain("vtanh", x, policy="pallas", target="rvv-64")
    by = {c["tier"]: c for c in rep["candidates"]}
    assert rep["chosen"] == "generic"
    assert not by["vector"]["width_ok"] and "vlen 64" in by["vector"]["note"]


def test_akey_keys_tensors_on_device_type():
    a = torch.zeros((4, 4))
    m = torch.empty((4, 4), device="meta")
    assert _akey(a) == ("#arr", (4, 4), "torch.float32", "cpu")
    assert _akey(a) != _akey(m)
    assert _akey(np.zeros((4, 4), np.float32))[-1] is None
    assert _akey([a, 1.0]) == ("#seq", _akey(a), 1.0)
    assert _akey({"un": "hashable"}) is registry._UNCACHEABLE


def _toy_registry():
    reg = _Registry(cache_capacity=8)
    reg.register("add", "vector", cost=trace.vector_cost(1))(
        lambda a, b, **kw: a + b)
    reg.register("add", "generic", cost=trace.scalar_cost(1))(
        lambda a, b, **kw: a + b)
    return reg


def test_selection_cache_hits_and_keys():
    reg = _toy_registry()
    x = _x()
    a = reg.select("add", x, x, policy="pallas", target="rvv-128")
    b = reg.select("add", x, x, policy="pallas", target="rvv-128")
    assert a is b and reg.cache_info()["hits"] == 1
    reg.select("add", x, x, policy="pallas", target="rvv-256")
    reg.select("add", x, x, policy="vector", target="rvv-128")
    reg.select("add", _x((65, 64)), x, policy="pallas", target="rvv-128")
    reg.select("add", x.to("meta"), x, policy="pallas", target="rvv-128")
    assert reg.cache_info()["misses"] == 5


def test_selection_cache_accounting_invariant():
    reg = _toy_registry()
    for i in range(5):
        reg.select("add", _x((16 + i,)), _x((16 + i,)), policy="pallas",
                   target="rvv-128")
    assert reg.cache_info()["size"] == 5
    reg.set_cache_capacity(2)
    info = reg.cache_info()
    assert info["size"] == 2 and info["evictions"] == 3
    x = _x((32, 32))
    before = reg.cache_info()
    a = reg.select("add", x, x, policy="pallas", target="rvv-128",
                   meta={"un": "hashable"})
    b = reg.select("add", x, x, policy="pallas", target="rvv-128",
                   meta={"un": "hashable"})
    assert a.tier == b.tier == "vector"
    info = reg.cache_info()
    assert info["uncacheable"] == before["uncacheable"] + 2
    assert (info["hits"], info["misses"]) == (before["hits"],
                                              before["misses"])
    assert info["lookups"] == \
        info["hits"] + info["misses"] + info["uncacheable"]
    reg.cache_clear()
    info = reg.cache_info()
    assert (info["hits"], info["misses"], info["evictions"],
            info["uncacheable"], info["lookups"]) == (0, 0, 0, 0, 0)
    with pytest.raises(ValueError):
        reg.set_cache_capacity(0)


def test_selection_cache_lru_keeps_hot_entries():
    reg = _toy_registry()
    reg.set_cache_capacity(3)
    xs = [_x((10 + i,)) for i in range(4)]
    for x in xs[:3]:
        reg.select("add", x, x, policy="pallas", target="rvv-128")
    reg.select("add", xs[0], xs[0], policy="pallas", target="rvv-128")
    reg.select("add", xs[3], xs[3], policy="pallas", target="rvv-128")
    info = reg.cache_info()
    assert info["size"] == 3 and info["evictions"] == 1
    reg.select("add", xs[0], xs[0], policy="pallas", target="rvv-128")
    assert reg.cache_info()["hits"] == info["hits"] + 1     # still hot
    reg.select("add", xs[1], xs[1], policy="pallas", target="rvv-128")
    assert reg.cache_info()["misses"] == info["misses"] + 1  # evicted


def test_set_calibration_rescales_and_invalidates():
    reg = _toy_registry()
    x = _x((1024,))
    assert reg.cost_of("add", x, x, policy="pallas",
                       target="rvv-128") == ("vector", 256)
    try:
        reg.set_calibration({"add": 2.5})
        assert reg.cache_info()["size"] == 0
        assert reg.cost_of("add", x, x, policy="pallas",
                           target="rvv-128") == ("vector", 640)
        assert trace.get_calibration() == {"factors": {"add": 2.5},
                                           "default": 1.0}
        assert trace.calibrated_cost("other", 0) == 0
        assert trace.calibrated_cost("add", None) is None
    finally:
        reg.set_calibration(None)
    assert trace.get_calibration() is None
    assert reg.cost_of("add", x, x, policy="pallas",
                       target="rvv-128") == ("vector", 256)


def test_broken_cost_model_is_unknown_not_fatal(caplog):
    reg = _Registry()
    reg.register("f", "vector", cost=lambda x: 1 // 0)(lambda x: x)
    reg.register("f", "generic", cost=trace.scalar_cost(1))(lambda x: x)
    rep = reg.explain("f", _x((4,)), policy="pallas", target="rvv-128")
    by = {c["tier"]: c for c in rep["candidates"]}
    assert by["vector"]["cost"] is None and rep["chosen"] == "generic"
    assert "cost model for f/vector raised" in caplog.text


def test_dispatch_records_selection_cost():
    x = _x((1024,))
    with trace.count() as c:
        y = REGISTRY.dispatch("vtanh", x, policy="pallas", target="rvv-128")
    assert c["per_op"][("vtanh", "pallas")] == 22 * 1024 // 4
    assert c["total"] == 22 * 256
    assert y.shape == x.shape and float(y.abs().max()) == 0.0
