"""Selection on the ``h100`` target: the port's default target runs the
kernel tier wherever it is valid, and every other target keeps the
reference's instruction counts and its cheapest-wins ranking.

The calls are those of PERF.md §6 (each row's op, shapes and dtypes) and
the serving calls of zamba2-1.2b, mamba2-1.3b, granite-moe-1b-a400m,
deepseek-v2-lite-16b, minicpm3-4b, gemma2-2b, gemma3-1b, whisper-tiny and
pixtral-12b in bf16 and float32.  MLA's
split-dim attention takes the vector tier on h100, as the reference's
rule has it everywhere.  The torch side runs on
meta tensors: selection reads no device data.  The tpu/rvv costs are held
to the JAX package's registry on the same shapes.
"""
import jax.numpy as jnp
import pytest
import torch

from repro.core.registry import REGISTRY as JREG
from repro.kernels import ops as jops  # noqa: F401  (registers)
from repro_torch.core import targets
from repro_torch.core.registry import REGISTRY, TIERS
from repro_torch.kernels import ops  # noqa: F401  (registers)

BF, F32, I32 = torch.bfloat16, torch.float32, torch.int32
INF = float("inf")


def _m(*shape, dtype=BF):
    return torch.empty(shape, dtype=dtype, device="meta")


def _gemm(m, k, n, dtype, bias=False, lo=-INF, hi=INF):
    return (_m(m, k, dtype=dtype), _m(k, n, dtype=dtype),
            _m(n, dtype=dtype) if bias else None, lo, hi)


def _ssd(dtype, D=False, g=2, n=64):
    return (_m(4, 512, 64, 64, dtype=dtype), _m(4, 512, 64, dtype=F32),
            _m(64, dtype=F32), _m(4, 512, g, n, dtype=dtype),
            _m(4, 512, g, n, dtype=dtype), _m(64, dtype=F32) if D else None)


def _attn(dtype, h=32, hkv=32, d=128):
    return (_m(4, 512, h, d, dtype=dtype), _m(4, 512, hkv, d, dtype=dtype),
            _m(4, 512, hkv, d, dtype=dtype), True, None, None, None)


def _decode(dtype, h=32, hkv=32, d=128):
    return (_m(4, 1, h, d, dtype=dtype), _m(4, 544, hkv, d, dtype=dtype),
            _m(4, 544, hkv, d, dtype=dtype), _m(4, dtype=I32), None, None,
            None)


SERVE_GEMM = ((2048, 8512), (4096, 2048), (4096, 4096), (4096, 8192),
              (8192, 2048))
_IDX = (_m(3136, dtype=I32), _m(3136, dtype=I32), _m(3136, dtype=F32),
        _m(3136, dtype=F32))
_IDX_BIG = (_m(262144, dtype=I32), _m(262144, dtype=I32),
            _m(262144, dtype=F32), _m(262144, dtype=F32))

# (§6 row, op, arguments): every call PERF.md §6 timed on the card
TIMED = [
    *[(r, op, (_m(*shape, dtype=dt),) + ((0.0, 6.0) if op == "vrelu" else ()))
      for r, op in (("1", "vtanh"), ("2", "vsigmoid"), ("3", "vsqrt"),
                    ("4", "vrelu"))
      for dt in (F32, BF) for shape in ((1 << 20,), (1 << 26,))],
    ("1", "vtanh", (_m(4, 512, 8192),)), ("1", "vtanh", (_m(4, 1, 8192),)),
    ("5", "gemm", _gemm(256, 512, 256, F32, True, -1.0, 1.0)),
    ("5", "gemm", _gemm(2048, 2048, 2048, F32, True, -1.0, 1.0)),
    *[(f"5{'abcde'[i]}", "gemm", _gemm(4, k, n, BF))
      for i, (k, n) in enumerate(SERVE_GEMM)],
    *[(f"5{'fghij'[i]}", "gemm", _gemm(2048, k, n, BF))
      for i, (k, n) in enumerate(SERVE_GEMM)],
    *[(f"5{'klmno'[i]}", "gemm", _gemm(2048, k, n, F32))
      for i, (k, n) in enumerate(SERVE_GEMM)],
    *[(f"6{s}", "conv_hwc", (_m(*x, dtype=dt), _m(3, 3, 128, 128, dtype=dt),
                             _m(128, dtype=dt)))
      for s, dt in (("", F32), ("b", BF))
      for x in ((1, 28, 28, 128), (8, 56, 56, 128))],
    *[(f"7{s}", "dwconv", (_m(*x, dtype=dt), _m(3, 3, 128, dtype=dt),
                           _m(128, dtype=dt)))
      for s, dt in (("", F32), ("b", BF))
      for x in ((1, 56, 56, 128), (16, 112, 112, 128))],
    *[(r, op, (_m(*x, dtype=F32), (2, 2), None))
      for r, op in (("8", "maxpool"), ("9", "argmaxpool"))
      for x in ((1, 56, 56, 256), (16, 112, 112, 256))],
    ("10", "ibilinear", (_m(56, 56, 64, dtype=F32), *_IDX)),
    ("10", "ibilinear", (_m(512, 512, 128, dtype=F32), *_IDX_BIG)),
    ("11", "attention", _attn(BF)),
    ("12", "decode_attention", _decode(BF)),
    ("13", "ssd", _ssd(BF)),
    ("13b", "ssd", _ssd(F32)),
]

# zamba2-1.2b's serving calls (configs/zamba2_1p2b.py), in bf16 and in
# float32 (the float32 logit check): gemm at a decode step's M = 4 and a
# prefill's M = 2048 rows against the five weight shapes, the shared
# block's gelu (vtanh) in prefill and decode, prefill attention, decode
# attention against the 544-slot cache, ssd with the skip term
SERVE = [(f"{str(dt)[6:]}-{name}", op, args)
         for dt in (BF, F32)
         for name, op, args in (
             *[(f"gemm_m{m}_{k}x{n}", "gemm", _gemm(m, k, n, dt))
               for m in (4, 2048) for k, n in SERVE_GEMM],
             ("vtanh_prefill", "vtanh", (_m(4, 512, 8192, dtype=dt),)),
             ("vtanh_decode", "vtanh", (_m(4, 1, 8192, dtype=dt),)),
             ("attention", "attention", _attn(dt)),
             ("decode", "decode_attention", _decode(dt)),
             ("ssd", "ssd", _ssd(dt, D=True)))]


# mamba2-1.3b's (configs/mamba2_1p3b.py: zamba2's two Mamba projections,
# ssd at g 1, n 128) and granite-moe-1b-a400m's (configs/
# granite_moe_1b_a400m.py: q/o (1024, 1024) and k/v (1024, 512)
# projections, the experts' silu at capacity 640 in a prefill and 8 in a
# decode step, GQA 16/8 at head_dim 64) serving calls, bf16 and float32
SERVE_ARCHS = [(f"{str(dt)[6:]}-{name}", op, args)
               for dt in (BF, F32)
               for name, op, args in (
                   *[(f"mamba2-gemm_m{m}_{k}x{n}", "gemm", _gemm(m, k, n, dt))
                     for m in (4, 2048) for k, n in SERVE_GEMM[:2]],
                   ("mamba2-ssd", "ssd", _ssd(dt, D=True, g=1, n=128)),
                   *[(f"granite-gemm_m{m}_{k}x{n}", "gemm",
                      _gemm(m, k, n, dt))
                     for m in (4, 2048) for k, n in ((1024, 1024),
                                                     (1024, 512))],
                   ("granite-vsigmoid_prefill", "vsigmoid",
                    (_m(32, 640, 512, dtype=dt),)),
                   ("granite-vsigmoid_decode", "vsigmoid",
                    (_m(32, 8, 512, dtype=dt),)),
                   ("granite-attention", "attention", _attn(dt, 16, 8, 64)),
                   ("granite-decode", "decode_attention",
                    _decode(dt, 16, 8, 64)))]


def _mla_attn(dtype, h, qk, v):
    """MLA's prefill attention: q and k at nope + rope, v narrower, the
    scale 1/sqrt(nope + rope)."""
    return (_m(4, 512, h, qk, dtype=dtype), _m(4, 512, h, qk, dtype=dtype),
            _m(4, 512, h, v, dtype=dtype), True, None, None, qk ** -0.5)


# deepseek-v2-lite-16b's (configs/deepseek_v2_lite_16b.py: q (2048, 3072),
# the kv down projection (2048, 576), o (2048, 2048), the dense first
# layer (2048, 10944) and (10944, 2048), the shared experts (2048, 2816)
# and (2816, 2048) and the head (2048, 102400) at M = 4 and 2048; W_uk and
# W_uv (512, 2048) in prefill only (decode absorbs them); the silu of the
# experts at capacity 240 and 8, of the shared experts and of the dense
# layer) and minicpm3-4b's (configs/minicpm3_4b.py: the q-lora (2560,
# 768) and (768, 3840), kv (2560, 288), o (2560, 2560), the MLP (2560,
# 6400) and (6400, 2560); (256, 2560) in prefill; its tied head is a
# plain matmul) serving calls, bf16 and float32
DEEPSEEK_GEMM = ((2048, 3072), (2048, 576), (2048, 2048), (2048, 10944),
                 (10944, 2048), (2048, 2816), (2816, 2048), (2048, 102400))
MINICPM_GEMM = ((2560, 768), (768, 3840), (2560, 288), (2560, 2560),
                (2560, 6400), (6400, 2560))
SERVE_MLA = [(f"{str(dt)[6:]}-{name}", op, args)
             for dt in (BF, F32)
             for name, op, args in (
                 *[(f"{arch}-gemm_m{m}_{k}x{n}", "gemm", _gemm(m, k, n, dt))
                   for arch, shapes, prefill in (
                       ("deepseek", DEEPSEEK_GEMM, (512, 2048)),
                       ("minicpm3", MINICPM_GEMM, (256, 2560)))
                   for m in (4, 2048)
                   for k, n in shapes + ((prefill,) if m == 2048 else ())],
                 *[(f"{label}", "vsigmoid", (_m(*shape, dtype=dt),))
                   for label, shape in (
                       ("deepseek-vsigmoid_experts_prefill", (64, 240, 1408)),
                       ("deepseek-vsigmoid_experts_decode", (64, 8, 1408)),
                       ("deepseek-vsigmoid_shared_prefill", (4, 512, 2816)),
                       ("deepseek-vsigmoid_shared_decode", (4, 1, 2816)),
                       ("deepseek-vsigmoid_dense_prefill", (4, 512, 10944)),
                       ("deepseek-vsigmoid_dense_decode", (4, 1, 10944)),
                       ("minicpm3-vsigmoid_prefill", (4, 512, 6400)),
                       ("minicpm3-vsigmoid_decode", (4, 1, 6400)))])]
MLA_ATTN = [(f"{str(dt)[6:]}-{arch}-attention", "attention",
             _mla_attn(dt, h, qk, v))
            for dt in (BF, F32)
            for arch, h, qk, v in (("deepseek", 16, 192, 128),
                                   ("minicpm3", 40, 96, 64))]


def _attn_at(dtype, b, sq, sk, h, hkv, d, causal=True, window=None,
             softcap=None):
    return (_m(b, sq, h, d, dtype=dtype), _m(b, sk, hkv, d, dtype=dtype),
            _m(b, sk, hkv, d, dtype=dtype), causal, window, softcap, None)


def _decode_at(dtype, s, h, hkv, d, softcap=None):
    return (_m(4, 1, h, d, dtype=dtype), _m(4, s, hkv, d, dtype=dtype),
            _m(4, s, hkv, d, dtype=dtype), _m(4, dtype=I32), None, softcap,
            None)


# gemma2-2b's, gemma3-1b's, whisper-tiny's and pixtral-12b's serving calls
# (configs/gemma2_2b.py, gemma3_1b.py, whisper_tiny.py, pixtral_12b.py),
# bf16 and float32: gemm at a decode step's and a prefill's M against
# each weight (q, k/v, o, MLP up and down; pixtral's head; whisper's
# encoder and cross k/v at 4 x 1500 frames, pixtral's prefill at 4 x
# (256 + 512) positions); the gelu (vtanh) and silu (vsigmoid); gemma2's
# final softcap (vtanh on the float32 logits); flash at each attention
# configuration (the local layers' windows, gemma2's softcap 50, whisper's
# non-causal encoder and its cross-attention at prefill and at a decode
# step); decode against each cache (gemma3's 512-slot ring)
NEW_ARCHS = {
    "gemma2": ((2304, 2048), (2304, 1024), (2048, 2304), (2304, 9216),
               (9216, 2304)),
    "gemma3": ((1152, 1024), (1152, 256), (1024, 1152), (1152, 6912),
               (6912, 1152)),
    "whisper": ((384, 384), (384, 1536), (1536, 384)),
    "pixtral": ((5120, 4096), (5120, 1024), (4096, 5120), (5120, 14336),
                (14336, 5120), (5120, 131072))}
NEW_M = {"gemma2": (4, 2048), "gemma3": (4, 2048),
         "whisper": (4, 2048, 6000), "pixtral": (4, 3072)}
SERVE_NEW = [(f"{str(dt)[6:]}-{name}", op, args)
             for dt in (BF, F32)
             for name, op, args in (
                 *[(f"{arch}-gemm_m{m}_{k}x{n}", "gemm", _gemm(m, k, n, dt))
                   for arch, shapes in NEW_ARCHS.items()
                   for m in NEW_M[arch] for k, n in shapes],
                 *[(label, op, (_m(*shape, dtype=dtype or dt),))
                   for label, op, shape, dtype in (
                       ("gemma2-gelu_prefill", "vtanh", (4, 512, 9216), None),
                       ("gemma2-gelu_decode", "vtanh", (4, 1, 9216), None),
                       ("gemma2-softcap_prefill", "vtanh", (4, 512, 256000),
                        F32),
                       ("gemma2-softcap_decode", "vtanh", (4, 1, 256000),
                        F32),
                       ("gemma3-gelu_prefill", "vtanh", (4, 512, 6912), None),
                       ("gemma3-gelu_decode", "vtanh", (4, 1, 6912), None),
                       ("whisper-gelu_prefill", "vtanh", (4, 512, 1536),
                        None),
                       ("whisper-gelu_decode", "vtanh", (4, 1, 1536), None),
                       ("whisper-gelu_enc", "vtanh", (4, 1500, 1536), None),
                       ("pixtral-silu_prefill", "vsigmoid", (4, 768, 14336),
                        None),
                       ("pixtral-silu_decode", "vsigmoid", (4, 1, 14336),
                        None))],
                 ("gemma2-attention_local", "attention",
                  _attn_at(dt, 4, 512, 512, 8, 4, 256, True, 4096, 50.0)),
                 ("gemma2-attention", "attention",
                  _attn_at(dt, 4, 512, 512, 8, 4, 256, True, None, 50.0)),
                 ("gemma2-attention_window", "attention",
                  _attn_at(dt, 1, 4160, 4160, 8, 4, 256, True, 4096, 50.0)),
                 ("gemma3-attention_local", "attention",
                  _attn_at(dt, 4, 512, 512, 4, 1, 256, True, 512)),
                 ("gemma3-attention", "attention",
                  _attn_at(dt, 4, 512, 512, 4, 1, 256)),
                 ("whisper-attention_enc", "attention",
                  _attn_at(dt, 4, 1500, 1500, 6, 6, 64, False)),
                 ("whisper-attention_self", "attention",
                  _attn_at(dt, 4, 512, 512, 6, 6, 64)),
                 ("whisper-attention_cross", "attention",
                  _attn_at(dt, 4, 512, 1500, 6, 6, 64, False)),
                 ("whisper-attention_cross_decode", "attention",
                  _attn_at(dt, 4, 1, 1500, 6, 6, 64, False)),
                 ("pixtral-attention", "attention",
                  _attn_at(dt, 4, 768, 768, 32, 8, 128)),
                 ("gemma2-decode", "decode_attention",
                  _decode_at(dt, 544, 8, 4, 256, 50.0)),
                 ("gemma3-decode_ring", "decode_attention",
                  _decode_at(dt, 512, 4, 1, 256)),
                 ("gemma3-decode", "decode_attention",
                  _decode_at(dt, 544, 4, 1, 256)),
                 ("whisper-decode", "decode_attention",
                  _decode_at(dt, 544, 6, 6, 64)),
                 ("pixtral-decode", "decode_attention",
                  _decode_at(dt, 800, 32, 8, 128)))]


def _row_id(row):
    label, op, args = row
    shapes = "x".join(str(tuple(a.shape)) for a in args
                      if isinstance(a, torch.Tensor))
    return f"{label}-{op}-{str(args[0].dtype)[6:]}-{shapes}"


def _chosen(op, args, target="h100"):
    return REGISTRY.explain(op, *args, policy="pallas",
                            target=target)["chosen"]


@pytest.mark.parametrize("row", TIMED, ids=_row_id)
def test_h100_ranks_as_the_card_timed_the_tiers(row):
    """Every call PERF.md §6 timed on the card takes the kernel tier on
    h100, those where the kernel beat its plain version by more than 10%
    (decode at 544 slots, gemm at M = 4 against zamba2's five weights,
    prefill attention, ssd) among them."""
    _, op, args = row
    assert _chosen(op, args) == "pallas"


@pytest.mark.parametrize("row", SERVE, ids=lambda r: r[0])
def test_h100_serves_zamba2_through_the_kernels(row):
    _, op, args = row
    assert _chosen(op, args) == "pallas"
    # the default target is h100, and selection under it is the same
    assert targets.current_target().name == "h100"
    assert REGISTRY.select(op, *args, policy="pallas").tier == "pallas"


@pytest.mark.parametrize("row", SERVE_ARCHS, ids=lambda r: r[0])
def test_h100_serves_mamba2_and_granite_through_the_kernels(row):
    """Each serving call of the two archs takes the kernel tier under the
    default target, ssd at n = 128 in float32 too (its shared memory
    fits a block: 211,968 of 232,448 bytes)."""
    _, op, args = row
    assert _chosen(op, args) == "pallas"
    assert REGISTRY.select(op, *args, policy="pallas").tier == "pallas"


@pytest.mark.parametrize("row", SERVE_MLA, ids=lambda r: r[0])
def test_h100_serves_deepseek_and_minicpm3_through_the_kernels(row):
    """Each gemm and vsigmoid call of the two MLA archs takes the kernel
    tier under the default target."""
    _, op, args = row
    assert _chosen(op, args) == "pallas"
    assert REGISTRY.select(op, *args, policy="pallas").tier == "pallas"


@pytest.mark.parametrize("row", SERVE_NEW, ids=lambda r: r[0])
def test_h100_serves_gemma_whisper_and_pixtral_through_the_kernels(row):
    """Each serving call of gemma2, gemma3, whisper and pixtral takes the
    kernel tier under the default target: D 256 with a window and a
    softcap, MQA, the one-row cross-attention of a whisper decode step,
    the 1500-frame encoder, pixtral's head among them."""
    _, op, args = row
    assert _chosen(op, args) == "pallas"
    assert REGISTRY.select(op, *args, policy="pallas").tier == "pallas"


@pytest.mark.parametrize("row", MLA_ATTN, ids=lambda r: r[0])
def test_h100_leaves_split_dim_attention_to_the_vector_tier(row):
    """MLA's prefill attention: the kernel tier is invalid (q's head dim
    is not v's, the reference's ``_attn_supports``), so h100 runs the
    vector tier, as the reference does on every target; the same q/k/v at
    one head dim would take the kernel."""
    _, op, args = row
    rep = REGISTRY.explain(op, *args, policy="pallas", target="h100")
    cands = {c["tier"]: c for c in rep["candidates"]}
    assert not cands["pallas"]["valid"] and cands["vector"]["valid"]
    assert rep["chosen"] == "vector"
    assert REGISTRY.select(op, *args, policy="pallas").tier == "vector"
    q, k, v = args[:3]
    same = (q, k, _m(*v.shape[:-1], q.shape[-1], dtype=v.dtype)) + args[3:]
    assert _chosen(op, same) == "pallas"


def test_h100_leaves_an_invalid_kernel_to_the_costs():
    """Where the kernel tier is invalid (int32 pooling; the policy capped
    at vector) h100 ranks the lower tiers by their declared counts."""
    x = torch.zeros((1, 8, 8, 4), dtype=torch.int32)
    rep = REGISTRY.explain("maxpool", x, (2, 2), None, policy="pallas",
                           target="h100")
    cands = {c["tier"]: c for c in rep["candidates"]}
    assert not cands["pallas"]["valid"]
    assert rep["chosen"] == min(
        (t for t in ("generic", "vector") if cands[t]["valid"]),
        key=lambda t: cands[t]["cost"])
    args = _gemm(4, 2048, 8512, BF)
    assert REGISTRY.explain("gemm", *args, policy="vector",
                            target="h100")["chosen"] == "vector"


OTHER = ["tpu-v5e", "tpu-v6", "rvv-64", *targets.RVV_FAMILY, "rvv-128-m2",
         "rvv-512-m4", "rvv-1024-m8"]


@pytest.mark.parametrize("target", OTHER)
def test_other_targets_rank_by_the_declared_models(target):
    """Both TPU models, every RVV width and each LMUL grouping, at every
    §6 call and serving call: each valid candidate's cost is its declared
    model's count, and the cheapest wins (a tie to the higher tier; none
    where the target's registers are too narrow for every tier)."""
    for _, op, args in TIMED + SERVE + SERVE_MLA + MLA_ATTN:
        row = REGISTRY.explain(op, *args, policy="pallas", target=target)
        costed = []
        with targets.use_target(target):
            for c in row["candidates"]:
                if c["valid"]:
                    low = REGISTRY.lowering(op, c["tier"])
                    assert c["cost"] == int(low.cost(*args)), (op, c)
                    costed.append((c["cost"], -TIERS.index(c["tier"]),
                                   c["tier"]))
        want = min(costed)[2] if costed else None
        assert row["chosen"] == want, (op, target)


_JDT = {BF: jnp.bfloat16, F32: jnp.float32, I32: jnp.int32}


def _jax(args):
    return tuple(jnp.zeros(a.shape, _JDT[a.dtype])
                 if isinstance(a, torch.Tensor) else a for a in args)


# the tiers whose torch cost model is the reference's formula: the
# kernel's structure count and the scalar emulation at every call, and
# for the elementwise ops the vector tier's count too (the other vector
# tiers are counted off the port's own aten graphs)
def _shared_tiers(op):
    return ("generic", "vector", "pallas") if op == "vtanh" \
        else ("generic", "pallas")


@pytest.mark.parametrize("target", ["tpu-v5e", "tpu-v6", "rvv-128",
                                    "rvv-512-m2", "rvv-1024"])
@pytest.mark.parametrize("row", SERVE + SERVE_ARCHS + SERVE_MLA + SERVE_NEW,
                         ids=lambda r: r[0])
def test_tpu_and_rvv_costs_are_unchanged(row, target):
    """The costs on the reference's machines are the JAX registry's, on
    the same shapes and dtypes (the attention ops' options after causal
    or lengths dropped: the reference's attention models take no
    positional window or softcap, and count none)."""
    _, op, args = row
    if op in ("attention", "decode_attention"):
        args = args[:4]
    while args[-1] is None:
        args = args[:-1]
    mine = REGISTRY.explain(op, *args, policy="pallas", target=target)
    ref = JREG.explain(op, *_jax(args), policy="pallas", target=target)
    costs = [{c["tier"]: c["cost"] for c in r["candidates"]
              if c["tier"] in _shared_tiers(op)} for r in (mine, ref)]
    assert costs[0] == costs[1]
    assert costs[0]["pallas"] is not None


@pytest.mark.parametrize("target", ["tpu-v5e", "tpu-v6", "rvv-128",
                                    "rvv-512-m2", "rvv-1024"])
@pytest.mark.parametrize("row", MLA_ATTN, ids=lambda r: r[0])
def test_split_dim_attention_costs_and_choice_match_reference(row, target):
    """MLA's attention on the reference's machines: the kernel tier
    invalid in both registries (so uncosted there), and both choose the
    same tier."""
    _, op, args = row
    while args[-1] is None:
        args = args[:-1]
    mine = REGISTRY.explain(op, *args, policy="pallas", target=target)
    ref = JREG.explain(op, *_jax(args), policy="pallas", target=target)
    for rep in (mine, ref):
        assert not {c["tier"]: c for c in rep["candidates"]}["pallas"][
            "valid"]
    costs = [{c["tier"]: c["cost"] for c in r["candidates"]
              if c["tier"] in ("generic", "pallas")} for r in (mine, ref)]
    assert costs[0] == costs[1]
    assert costs[0] == {"pallas": None}
    assert mine["chosen"] == ref["chosen"]
