"""``chip_smoke.py``'s ``sharded`` phase, on the CPU.

The card runs ``sharded_phase`` on mistral-large-123b (one layer, mesh
(2, 2): FSDP, data, tensor and sequence parallelism),
granite-moe-1b-a400m (full depth, mesh (1, 2)) and gemma3-1b (one
pattern unit, mesh (2, 1), ZeRO-1, int8 compression), with
``compressed_psum``, the pipeline and the multi-host launcher beside
them.  Here: the exact launches ``sharded_want`` and ``pipeline_want``
gate each rank on, held to the kernel entries' calls of a step of each
reduced model and of a pipeline rank; and the phase whole on the
reduced configs on gloo CPU ranks under ``policy="pallas"`` (no kernel
launches on the CPU, so the tiers are held and the launches are not):
its single-rank run, the sharded runs within the bf16 gate, the float32
runs within 2e-4 leaf by leaf, the control (the copy into the model
region without its backward all-reduce) caught, gemma3's int8 payload
the whole-leaf formula's with the per-slice control caught,
``compressed_psum`` bitwise, the pipeline bitwise and the launcher over
gloo.
"""
import sys
from pathlib import Path
from unittest import mock

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from repro_torch.core import use_policy  # noqa: E402
from repro_torch.launch import mesh as LM  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.kernels import elementwise as ew  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import gemm as gemm_mod  # noqa: E402
from repro_torch.kernels import ssd as ssd_mod  # noqa: E402
from repro_torch.data.pipeline import extra_inputs  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.train import loop  # noqa: E402

CPU = torch.device("cpu")


def _counting(monkeypatch):
    calls = {}
    for mod, name in ((gemm_mod, "gemm"), (ew, "vsigmoid"), (ew, "vtanh"),
                      (fa, "flash_attention"), (ssd_mod, "ssd")):
        entry = getattr(mod, name)

        def counted(*a, _entry=entry, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _entry(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    return calls


@pytest.mark.parametrize("arch", ["mistral-large-123b",
                                  "granite-moe-1b-a400m", "gemma2-2b",
                                  "gemma3-1b", "zamba2-1.2b",
                                  "deepseek-v2-lite-16b", "minicpm3-4b",
                                  "whisper-tiny"])
def test_sharded_want_counts_a_steps_kernel_calls(monkeypatch, arch):
    """One train step of the reduced model under the kernel tier calls
    each kernel entry as often as sharded_want says: the forward,
    remat's recompute, gemm's two backward products; an untied head's
    three gemm calls (mistral, deepseek), a tied head's none; zamba2's
    ssd (one launch a call at 32 positions) and its shared block; MLA's
    gemms and no flash; whisper's encoder and its decoder's
    cross-attention."""
    cfg = cs.sharded_config(arch, "reduced", "float32")
    params = loop.trainable(M.init(cfg, torch.Generator().manual_seed(0),
                                   CPU))
    opt = loop.adamw.init(params)
    calls = _counting(monkeypatch)
    batch = {**SyntheticLM(cfg.vocab_size, 32, 2).batch(0, device=CPU),
             **extra_inputs(cfg, 2, device=CPU)}
    with use_policy("pallas"):
        loop.make_train_step(cfg, loop.TrainConfig())(params, opt, None,
                                                      batch)
    want = cs.sharded_want(cfg, 32)
    assert {k: calls.get(k, 0) for k in cs.SHARDED_OPS} == want
    kinds = cfg.layer_pattern()
    attn = sum(k != "mamba" for k in kinds) + cfg.n_enc_layers + \
        kinds.count("dec")
    assert want["gemm"] > 0 and want["flash_attention"] == \
        2 * attn * (cfg.attn_kind != "mla")
    assert want["ssd"] == 2 * sum(k.startswith("mamba") for k in kinds)
    assert (want["vsigmoid"] > 0) == (cfg.act == "silu")
    assert (want["vtanh"] > 0) == (cfg.act == "gelu")


def test_sharded_phase_runs_reduced(monkeypatch):
    reduced = tuple((tag, arch, "reduced", mesh)
                    for tag, arch, _, mesh in cs.SHARDED)
    reduced_f32 = tuple((tag, arch, "reduced", mesh)
                        for tag, arch, _, mesh in cs.SHARDED_F32)
    monkeypatch.setattr(cs, "SHARDED", reduced)
    monkeypatch.setattr(cs, "SHARDED_F32", reduced_f32)
    monkeypatch.setattr(cs, "SHARDED_TIMEOUT", 100)
    # the spawned gloo ranks share the host's cores: one thread each, as
    # torchrun gives its ranks (eight each ran ~4x slower here)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setattr(cs, "SHARDED_TRAFFIC", dict(batch=4, seq=32, steps=2))
    monkeypatch.setattr(cs, "SHARDED_PSUM", 4099)
    monkeypatch.setattr(cs, "SERVE_TRAFFIC", dict(batch=4, prompt=32,
                                                  steps=2))
    monkeypatch.setattr(cs, "PIPELINE", {**cs.PIPELINE, "cut": "reduced",
                                         "seq": 16})
    out = cs.sharded_phase(CPU, policy="pallas")
    for tag in ("mistral", "granite", "gemma3"):
        rec = out[tag]
        assert rec["failures"] == [] and rec["leaves"] > 0, tag
        assert rec["median_rel_leaf_err"] <= cs.TRAIN_TOL
        assert [r["rank"] for r in rec["ranks"]] == \
            list(range(rec["mesh"][0] * rec["mesh"][1]))
    assert out["mistral"]["mesh"] == out["mistral_f32"]["mesh"] == [2, 2]
    assert out["gemma3"]["mesh"] == [2, 1]
    assert out["granite"]["mesh"] == [1, 2]
    # data > 1 with experts over 'model' (A.9.9): its single rank
    # dispatches as the two data shards do
    rec = out["granite_dp"]
    assert rec["failures"] == [] and rec["mesh"] == [2, 2]
    assert rec["median_rel_leaf_err"] <= cs.TRAIN_TOL
    # FSDP leaves ZeRO-1 nothing to slice; gemma3's optimizer state is
    # sliced over 'data'
    assert all(r["zero1_leaves"] == 0 for r in out["mistral"]["ranks"])
    for r in out["gemma3"]["ranks"]:
        assert r["zero1_leaves"] > 0
        assert r["opt_elems"] < r["local_params"]
    for tag in ("zamba2", "deepseek", "whisper", "gemma3_tp"):
        assert out[tag]["failures"] == [] and out[tag]["mesh"] == [1, 2], tag
    # heads that 'model' does not divide: 2 / 2 / 2 / 0 of whisper's 6
    rec = out["whisper_tp4"]
    assert rec["failures"] == [] and rec["mesh"] == [1, 4]
    assert [r["heads"] for r in rec["ranks"]] == [2, 2, 2, 0]
    assert "gemma3_tp8" not in out        # serving only
    for tag in ("granite_f32", "mistral_f32", "zamba2_f32",
                "granite_sp_f32", "zamba2_straddle_f32"):
        assert out[tag]["max_rel_leaf_err"] <= cs.LM_TOL["float32"], tag
    assert out["zamba2_f32"]["mesh"] == [1, 4]
    # SSM heads across SSM groups (A.9.11): 12 heads in 3 groups, 3 a
    # rank, ssd one group a head on every rank (4 rows of 32 positions,
    # p 16, n 16)
    rec = out["zamba2_straddle_f32"]
    assert rec["failures"] == [] and rec["mesh"] == [1, 4]
    assert [r["ssd_shapes"] for r in rec["ranks"]] == \
        [[(4, 32, 3, 16, 3, 16)]] * 4
    control = out["control_groups_repeated"]
    assert control["failures"]
    assert any("::mamba::" in k for k in control["failed_leaves"])
    control = out["control"]
    assert control["failures"]
    assert any(k.endswith("router") for k in control["failed_leaves"])
    # the gated norm's sum dropped: the mamba blocks' leaves fail
    control = out["control_norm_sum"]
    assert control["failures"]
    assert any("::mamba::" in k for k in control["failed_leaves"])
    # gemma3's int8 payload is the whole-leaf formula's; a per-slice scale
    # is caught
    int8 = out["gemma3"]["int8"]
    assert int8["max_scale_gap"] == 0 and int8["q_far"] == 0, int8
    assert int8["control_leaves_off"] > 0
    assert [r["elements"] for r in out["psum"]] == [4099, 4099]
    assert all(r["bitwise"] for r in out["psum"])
    head = out["pipeline"][0]
    assert head["bitwise"] and head["shape"] == [1, 16, 64], head
    assert head["grad_finite"] and head["grad_leaves"] > 1
    assert head["grad_gap"] <= cs.LM_TOL["bfloat16"], head
    assert [r["ticks"] for r in out["pipeline"]] == [9, 9]
    assert out["launcher"]["backend"] == "gloo"
    # serving on the mesh: each rank's logits the single rank's, the dry
    # run's arguments rank 0's (no launches on the CPU)
    for tag, mesh, dtype in (("zamba2", [1, 2], "bfloat16"),
                             ("mistral", [2, 2], "bfloat16"),
                             ("whisper_tp4", [1, 4], "bfloat16"),
                             ("gemma3_tp8", [1, 8], "bfloat16"),
                             ("granite_dp", [2, 2], "bfloat16"),
                             ("zamba2_straddle_f32", [1, 4], "float32")):
        serve = out["serve"][tag]
        assert serve["failures"] == [] and serve["mesh"] == mesh, tag
        assert serve["max_rel_logit_gap"] <= cs.LM_TOL[dtype]
        assert len(serve["gaps"][0]) == 3
        dry = serve["dryrun"][0]["decode"]
        assert dry["launches"]["decode_attention"] > 0
        assert sum(dry["argument_parts"].values()) == \
            serve["arguments"]["decode"]
    # the ranks without heads, each traced by the dry run beside rank 0
    assert out["serve"]["whisper_tp4"]["heads"] == [2, 2, 2, 0]
    assert out["serve"]["gemma3_tp8"]["heads"] == [1] * 4 + [0] * 4
    assert sorted(out["serve"]["gemma3_tp8"]["dryrun"]) == [0, 4]
    empty = out["serve"]["gemma3_tp8"]["dryrun"][4]["decode"]["launches"]
    assert "decode_attention" not in empty and empty["gemm"] > 0
    # an empty rank's launches are rank 0's as ``serve_rank_want`` cuts
    # them: no attention kernel, one gemm fewer an attention
    for tag, rank in (("whisper_tp4", 3), ("gemma3_tp8", 4)):
        dry = out["serve"][tag]["dryrun"]
        for kind in ("prefill", "decode"):
            assert cs.serve_rank_want([dry[0][kind]["launches"]], True) == \
                [dry[rank][kind]["launches"]], (tag, kind)


def _pipeline_calls(rank, world):
    """The kernel entries' calls of one ``_pipeline_job`` rank on the
    reduced gemma3 block."""
    calls = {}
    for mod, name in ((gemm_mod, "gemm"), (ew, "vsigmoid"), (ew, "vtanh"),
                      (fa, "flash_attention")):
        entry = getattr(mod, name)

        def counted(*a, _entry=entry, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _entry(*a, **k)
        setattr(mod, name, counted)
    spec = {**cs.PIPELINE, "cut": "reduced", "seq": 16}
    rec = cs._pipeline_job(rank, world, "cpu", "pallas", spec)
    return calls, rec


def test_pipeline_want_counts_a_ranks_kernel_calls():
    """Stage 1 of the two (no sequential run beside it) calls each
    kernel entry as often as ``pipeline_want`` says, forward and then
    forward and backward: a microbatch's seven gemms, its gelu's vtanh
    and its flash, and each gemm's two backward products."""
    (_, head), (calls, _) = LM.run_ranks(_pipeline_calls, 2, timeout=100)
    cfg = cs.sharded_config("gemma3-1b", "reduced", "bfloat16")
    want = cs.pipeline_want(cfg, cs.PIPELINE["micro"])
    back = cs.pipeline_want(cfg, cs.PIPELINE["micro"], backward=True)
    assert {k: calls.get(k, 0) for k in cs.SHARDED_OPS} == \
        {k: want[k] + back[k] for k in want}
    assert want == {"gemm": 56, "vsigmoid": 0, "vtanh": 8,
                    "flash_attention": 8, "ssd": 0}
    assert back == {**want, "gemm": 168}
    assert head["bitwise"] and head["grad_gap"] <= cs.LM_TOL["bfloat16"]


# MLA under an uneven split (no card job runs one): minicpm3 with 6 heads
# on (1, 4), heads 2 / 2 / 2 / 0
MLA_TP4 = ("minicpm3_tp4", "minicpm3-4b", "reduced", (1, 4))


@pytest.mark.parametrize("job", ["whisper_tp4", "gemma3_tp8",
                                 "minicpm3_tp4"])
def test_sharded_want_is_each_ranks_traced_launches(job):
    """Ranks differ where 'model' does not divide the heads: the dry run's
    trace of a train step (stand-ins on a fake process group, the kernel
    launches recorded, not made) of rank 0 and of the first rank without
    heads, reduced, launches what ``sharded_want`` gives each; the empty
    rank no flash and five gemm launches fewer an attention a pass (its
    q product is empty; its output product, K = 0, launches forward)."""
    import math
    from repro_torch.launch import dryrun
    from repro_torch.models import sharding as Sh
    if job == MLA_TP4[0]:
        shape = MLA_TP4[3]
        cfg = cs.sharded_config(*MLA_TP4[1:3], "bfloat16").replace(
            n_heads=6)
    else:
        tag, arch, _, shape = next(j for j in cs.SHARDED if j[0] == job)
        cfg = cs.job_config((tag, arch, "reduced", shape), "bfloat16")
    seq = 32
    specs = {"tokens": ((4, seq), torch.int32),
             "targets": ((4, seq), torch.int32)}
    if cfg.family == "encdec":
        specs["frames"] = ((4, cfg.n_frames, cfg.d_model), torch.float32)
    m = shape[1]
    empty = next(r for r in range(m)
                 if Sh.chunk_range(cfg.n_heads, r, m)[0] == cfg.n_heads)
    got = {}
    for rank in (0, empty):
        with dryrun.fake_ranks(math.prod(shape), rank):
            mesh = LM.make_mesh(shape, ("data", "model"), "cpu")
            rec, _ = dryrun.trace_cell(cfg, "train", specs, mesh)
        got[rank] = {op: rec["launches"].get(op, 0) for op in cs.SHARDED_OPS}
        assert got[rank] == cs.sharded_want(cfg, seq, empty=rank == empty)
    assert got[empty]["flash_attention"] == 0
    assert cfg.attn_kind == "mla" or got[0]["flash_attention"] > 0
    assert got[empty]["gemm"] < got[0]["gemm"]


def test_shard_capacity_dispatches_as_the_data_shards_do():
    """``shard_capacity``: a single rank's MoE dispatch over two data
    shards' rows equals each shard dispatched alone against its own
    capacity (bitwise), where the whole batch against the whole capacity
    drops other choices; the experts' activation is one call."""
    from repro_torch.models import moe
    cfg = cs.sharded_config("granite-moe-1b-a400m", "reduced",
                            "float32").replace(capacity_factor=0.5)
    gen = torch.Generator().manual_seed(0)
    params = moe.moe_init(gen, cfg, CPU)
    xt = torch.randn(64, cfg.d_model, generator=gen)
    gates, idx, _ = moe._route(params, xt, cfg)
    rows = (slice(0, 32), slice(32, 64))
    want = torch.cat([moe._dispatch_compute(
        params, xt[r], gates[r], idx[r], cfg, moe.capacity(cfg, 32), 0,
        cfg.n_experts) for r in rows])
    whole = moe._dispatch_compute(params, xt, gates, idx, cfg,
                                  moe.capacity(cfg, 64), 0, cfg.n_experts)
    assert not torch.equal(whole, want)
    calls = []
    act = moe.L.act_apply
    with cs.shard_capacity(moe, 2), \
            mock.patch.object(moe.L, "act_apply",
                              lambda *a: calls.append(1) or act(*a)):
        got = moe._dispatch_compute(params, xt, gates, idx, cfg,
                                    moe.capacity(cfg, 64), 0, cfg.n_experts)
    assert torch.equal(got, want) and len(calls) == 1
    with cs.shard_capacity(moe, 1):
        assert torch.equal(moe._dispatch_compute(
            params, xt, gates, idx, cfg, moe.capacity(cfg, 64), 0,
            cfg.n_experts), whole)
