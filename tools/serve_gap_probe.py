#!/usr/bin/env python3
"""Readings behind the serving check of ``chip_smoke.py``, on one NVIDIA GPU.

Run from the root of a checkout::

    python3 tools/serve_gap_probe.py [ARCH ...]

For each arch (default: ``ARCHS``, the served ones and mamba2-1.3b,
whose config ``get_config`` refuses until its bf16 check has a limit its
full depth passes) in bf16 at the
smoke's full width, depth and traffic (4 prompts of 512 tokens, 32
tokens; whisper's with its stub frames, pixtral's with its stub
patches), it generates the kernel run's greedy tokens and then, teacher
forced on them as ``chip_smoke.serve_arch`` is, prints one JSON line
with:

  * ``serving``: ``chip_smoke.warm_run``'s record: a warm prefill's and
    a decode step's host-clock ms, gemm's launches by variant, and the
    profiler's breakdown of a prefill and of two decode steps (device ms
    by kernel, idle share);
  * ``gate``: the smoke's whole-model reading, the kernel run against the
    vector run (max |logit difference| over max |logit|, each step, and
    its largest), an MoE's vector run routed by the kernel run's indices;
  * ``blocks``: each block of a vector run fed the kernel run's input
    (a whisper ``dec`` block also its encoder output): the largest output
    gap over the block's own update max |y - x|, over its output max |y|,
    and over its update after one rounding step of the output is allowed
    each element (``chip_smoke.stream_gaps``'s measure); the first
    measure's largest by layer (``chip_smoke.layer_labels``: whisper's
    encoder layers apart from its decoder's);
  * ``sound``: other correct runs held to the same vector run by the same
    statistic: the vector tier with ssd's fp32 sums chunked at 64 and 32
    rows, the vector tier with cuBLAS's bf16 split-K reductions
    disallowed, the kernel run with one op at a time on its vector tier,
    and the kernel run against the vector run without bf16 reductions
    (an op already on its vector tier, as MLA's attention is, reads as
    the kernel run);
  * ``unpinned`` (an MoE): the vector run on its own routing, its flips
    and its gap;
  * ``controls``: the kernel run with a fault planted in one block (the
    middle layer of the decoder stack, at every step): its update scaled
    by 1.05, or its update cut to 4 bits of mantissa; each held to the
    vector run by the whole-model statistic and, block by block, by the
    update measure;
  * ``float32_gate``: the whole-model statistic with the model in
    float32 (weights drawn anew from the seed once the bf16 model is
    freed), teacher forced on the same tokens, an MoE's vector run
    routed by the kernel run's indices.

It also checks whether the flag ``allow_bf16_reduced_precision_reduction``
changes a bf16 ``torch.matmul`` at the serving gemm shapes.  The last
line names the card and its power limit as ``nvidia-smi`` gives them.
"""
from __future__ import annotations

import functools
import importlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

# arch -> its config module under repro_torch.configs
ARCHS = {"zamba2-1.2b": "zamba2_1p2b", "mamba2-1.3b": "mamba2_1p3b",
         "granite-moe-1b-a400m": "granite_moe_1b_a400m",
         "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
         "minicpm3-4b": "minicpm3_4b", "gemma2-2b": "gemma2_2b",
         "gemma3-1b": "gemma3_1b", "whisper-tiny": "whisper_tiny",
         "pixtral-12b": "pixtral_12b"}
FAULT_SCALE = 1.05
FAULT_MANTISSA = 4        # bits kept of float32's 23


def rel_gap(kern, plain):
    """Each step's max |kern - plain| over max |kern|, and the largest."""
    steps = ((kern - plain).abs().amax(dim=(1, 2))
             / kern.abs().amax(dim=(1, 2))).tolist()
    return {"max": max(steps), "steps": [round(v, 6) for v in steps]}


def block_stats(kern, plain):
    """The three block measures of the module docstring."""
    import torch
    upd, out, ulp = [], [], []
    for a, b in zip(kern, plain):
        ya, yb, x = a["y"].float(), b["y"].float(), a["x"].float()
        d = (ya - yb).abs()
        tiny = np.finfo(np.float32).tiny
        u = (ya - x).abs().max().clamp_min(tiny)
        upd.append(float(d.max() / u))
        out.append(float(d.max() / ya.abs().max().clamp_min(tiny)))
        step = torch.maximum(cs.rounding_step(a["y"]),
                             cs.rounding_step(b["y"]))
        ulp.append(float((d - step).clamp_min(0).max() / u))
    by_layer = {}
    for a, u in zip(kern, upd):
        by_layer[a["layer"]] = max(by_layer.get(a["layer"], 0.0), u)
    worst = max(range(len(upd)), key=upd.__getitem__)
    return {"calls": len(upd), "update": max(upd), "worst_call": worst,
            "worst_layer": kern[worst]["layer"], "output": max(out),
            "update_one_step_allowed": max(ulp),
            "update_by_layer": {k: round(v, 6) for k, v in by_layer.items()}}


def faulty(apply, layer, how):
    """block_apply with a fault in ``layer`` (a ``chip_smoke.layer_labels``
    label) of every forward."""
    import torch
    label = cs.layer_labels()

    def run(kind, params, x, cache, ctx):
        y, cache, aux = apply(kind, params, x, cache, ctx)
        if label(kind, ctx) != layer:
            return y, cache, aux
        h = (y - x).float()
        if how == "scale":
            h = h * FAULT_SCALE
        else:
            keep = ~((1 << (23 - FAULT_MANTISSA)) - 1)
            h = (h.view(torch.int32) & keep).view(torch.float32)
        return (x.float() + h).to(y.dtype), cache, aux
    return run


def matmul_flag(dev):
    """Does disallowing bf16 split-K reductions change torch.matmul?"""
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    out = []
    for m in cs.SERVE_M:
        for k, n in cs.SERVE_GEMM[:2] + cs.GRANITE_GEMM:
            a = torch.randn(m, k, generator=gen, device=dev).bfloat16()
            w = torch.randn(k, n, generator=gen, device=dev).bfloat16()
            got = {}
            for flag in (True, False):
                torch.backends.cuda.matmul \
                    .allow_bf16_reduced_precision_reduction = flag
                got[flag] = (a @ w).float()
            out.append({"m": m, "k": k, "n": n,
                        "equal": bool(torch.equal(got[True], got[False])),
                        "max_abs_diff": float((got[True] - got[False])
                                              .abs().max())})
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    return out


def probe(dev, arch):
    import torch
    from repro_torch.core import use_policy
    from repro_torch.data.pipeline import extra_inputs
    from repro_torch.kernels import ops as ops_mod
    from repro_torch.kernels import ref as ref_mod
    from repro_torch.models import blocks as blocks_mod
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod
    from repro_torch.serve.engine import Engine

    cfg = importlib.import_module(
        f"repro_torch.configs.{ARCHS[arch]}").CONFIG
    b, plen, steps = cs.SERVE["batch"], cs.SERVE["prompt"], cs.SERVE["gen"]
    max_seq = plen + steps
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    params = M.init(cfg, gen, dev)
    prompts = np.random.default_rng(cs.SEED).integers(2, cfg.vocab_size,
                                                      (b, plen))
    extra = extra_inputs(cfg, b, cs.SEED, dev)
    tokens = Engine(cfg, params, b, max_seq, device=dev).generate(
        prompts, steps, extra)
    run = functools.partial(cs.teacher_logits, cfg, params, prompts, tokens,
                            max_seq, dev, extra=extra)
    moe = bool(cfg.n_experts)
    record = {"arch": arch}
    if dev.type == "cuda":
        record["serving"] = cs.warm_run(cfg, params, prompts, max_seq, dev,
                                        steps, extra)
        record["serving"]["tokens_repeat"] = bool(np.array_equal(
            record["serving"].pop("tokens"), tokens))

    route, kcalls = cs.route_probe(moe_mod) if moe else (None, None)
    block, kblocks = cs.block_probe(blocks_mod)
    kern = run("pallas", route, block)
    kinds = cfg.layer_pattern()
    middle = f"{kinds[len(kinds) // 2]}.{len(kinds) // 2}"

    def pinned():
        return cs.route_probe(moe_mod, pinned=kcalls)[0] if moe else None

    plain = run("vector", pinned())
    record["gate"] = rel_gap(kern, plain)
    pin_block, vblocks = cs.block_probe(blocks_mod, pinned=kblocks)
    run("vector", pinned(), pin_block)
    record["blocks"] = block_stats(kblocks, vblocks)
    del vblocks

    def swapped(name, fn, policy):
        orig = getattr(ops_mod, name)
        setattr(ops_mod, name, fn(orig))
        try:
            return run(policy, pinned())
        finally:
            setattr(ops_mod, name, orig)

    def on_vector(orig):
        def op(*a, **k):
            with use_policy("vector"):
                return orig(*a, **k)
        return op

    sound = {}
    if "ssd" in cs.serve_ops(cfg):
        for chunk in (64, 32):
            sound[f"vector_ssd_chunk{chunk}"] = rel_gap(swapped(
                "ssd", lambda _, c=chunk: (
                    lambda x, dt, A, B, C, D=None, **_:
                    ref_mod.ssd_chunked(x, dt, A, B, C, D, chunk=c)),
                "vector"), plain)
    for op in cs.serve_ops(cfg):
        sound[f"kernel_{op}_on_vector"] = rel_gap(
            swapped(op, on_vector, "pallas"), plain)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        fp32_red = run("vector", pinned())
    finally:
        torch.backends.cuda.matmul \
            .allow_bf16_reduced_precision_reduction = True
    sound["vector_fp32_reductions"] = rel_gap(fp32_red, plain)
    record["kernel_vs_vector_fp32_reductions"] = rel_gap(kern, fp32_red)
    del fp32_red
    record["sound"] = sound

    if moe:
        free, free_calls = cs.route_probe(moe_mod)
        unpinned = run("vector", free)
        record["unpinned"] = {"gap": rel_gap(kern, unpinned)["max"],
                              **cs.route_flips(kcalls, free_calls,
                                               cfg.top_k, "unpinned")}
        record["unpinned"].pop("flip_margins")
        del unpinned, free_calls

    controls = {}
    for how in ("scale", "mantissa"):
        apply = blocks_mod.block_apply
        blocks_mod.block_apply = faulty(apply, middle, how)
        try:
            cblock, cblocks = cs.block_probe(blocks_mod)
        finally:
            blocks_mod.block_apply = apply
        route_c = cs.route_probe(moe_mod, pinned=kcalls)[0] if moe else None
        ctrl = run("pallas", route_c, cblock)
        pin_block, vblocks = cs.block_probe(blocks_mod, pinned=cblocks)
        run("vector", pinned(), pin_block)
        stats = block_stats(cblocks, vblocks)
        controls[how] = {"layer": middle,
                         "gate": rel_gap(ctrl, plain)["max"],
                         "blocks_update": stats["update"],
                         "blocks_worst_layer": stats["worst_layer"],
                         "blocks_update_one_step_allowed":
                         stats["update_one_step_allowed"]}
        del ctrl, cblocks, vblocks
    record["controls"] = controls
    del params, kern, plain, kblocks
    torch.cuda.empty_cache()

    # the same model in float32 (weights drawn anew from the seed, once
    # the bf16 model is freed), teacher forced on the same tokens
    cfg32 = cfg.replace(dtype="float32")
    gen.manual_seed(cs.SEED)
    params = M.init(cfg32, gen, dev)
    run32 = functools.partial(cs.teacher_logits, cfg32, params, prompts,
                              tokens, max_seq, dev, extra=extra)
    route32, calls32 = cs.route_probe(moe_mod) if moe else (None, None)
    kern = run32("pallas", route32)
    pinned32 = cs.route_probe(moe_mod, pinned=calls32)[0] if moe else None
    record["float32_gate"] = rel_gap(kern, run32("vector", pinned32))["max"]
    print(json.dumps(record), flush=True)
    del params, kern
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    import torch
    archs = (sys.argv[1:] if argv is None else argv) or list(ARCHS)
    if not torch.cuda.is_available():
        print("serve_gap_probe: torch.cuda is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    dev = torch.device("cuda")
    print(json.dumps({"matmul_bf16_reduction_flag": matmul_flag(dev)}),
          flush=True)
    for arch in archs:
        probe(dev, arch)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
