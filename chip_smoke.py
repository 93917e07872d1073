#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card::

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
nvcc per source, all started together) and holds each of the thirteen
against its plain torch version on the card (conv_hwc and dwconv also at
their timed large size, conv_hwc also bitwise against itself under a
sliced plan, dwconv also through an x off 16 bytes; the pools and
ibilinear also at C off their 16-byte vector, the pools in the generic
window and with NaN, inf and ties on the vector path, both through an
input off 16 bytes, each call one launch; the elementwise four at odd
sizes and zamba2's gelu shapes in both dtypes; ssd from 1 to 2048
positions, at mamba2's n = 128, with fast decays, and bitwise against
itself; flash and decode also at granite's GQA 16/8, D 64 and at every
attention call of gemma2-2b, gemma3-1b, whisper-tiny and pixtral-12b
(``LM_NEW``: D 256 with window and softcap, MQA, whisper's non-causal
1500-frame encoder and its one-row cross-attention); vsigmoid also at the
silu's shapes of deepseek-v2-lite-16b, minicpm3-4b and pixtral, vtanh at
the gelu's of the gemmas and whisper and at gemma2's final softcap).
Then it drives the port's main paths:

  * the ten Figure-2 workloads of the paper through ``ops.* ->
    registry.dispatch -> traced costs -> customized tier -> CUDA kernel``
    under the rvv-128 cost model, checking the paper's Figure-2 selection
    properties;
  * serving at full width (bf16, seeded random weights) under the
    default target (h100) and policy, for zamba2-1.2b, mamba2-1.3b,
    whisper-tiny and pixtral-12b at full depth, granite-moe-1b-a400m,
    gemma2-2b, gemma3-1b, deepseek-v2-lite-16b, minicpm3-4b and
    mistral-large-123b cut to 6, 2, 6, 3, 4 and 4 layers
    (``SERVE_DEPTH``), each freed before the next (and each bf16 model
    before its float32 one): ``Engine.generate`` for 4 requests of
    512-token prompts and 32 greedy tokens (whisper's with 1500 stub
    frames each, pixtral's with 256 stub patches before the prompt:
    ``data.pipeline.extra_inputs``), which must run the kernel
    tier of every op the arch's layers reach (``serve_ops``: gemm; vtanh
    for the gelu of zamba2, the gemmas and whisper and for gemma2's final
    softcap, vsigmoid for the silu of the others' MLPs and experts; flash
    attention and flash decode where a layer attends with GQA; ssd where
    it is a Mamba2 layer), but MLA's prefill attention, whose split head
    dims keep it on the vector tier by the reference's rule, and whose
    absorbed decode dispatches no attention op (``serve_tier``), with
    exact launch counts of the LM kernels (``serve_want``: whisper's
    encoder and its cross-attention, at prefill and at every decode
    step, are flash launches), then a teacher-forced
    check of its logits against the same model under the vector tier
    over the whole model, in bf16 and again with the model in float32,
    both runs on the kernel tier of the same ops.  In bf16 a third run
    starts each vector block from the kernel block's input
    (``block_probe``) and holds every block's output to it
    (``stream_gaps``).  For mamba2-1.3b and pixtral-12b (``BLOCK_GATED``)
    the bf16 whole-model reading is printed, not gated, and planted
    controls (``planted_controls``: the middle layer's update scaled by
    1.05 or cut to 4 bits at every forward) must fail the bf16 per-block
    gate and, scaled, the float32 whole-model gate in the same run.  An
    MoE's router (granite's, deepseek's) is
    swapped for ``route_probe`` in both dtypes: the vector runs route by
    the kernel run's top-k indices (``route_flips`` counts where its own
    would differ and fails unless each such flip sits on a margin within
    the two runs' router-probability gap).  whisper's ``dec`` blocks in
    the pinned run also read the kernel run's encoder output.  The
    profiled prefill and decode steps also read the device ms of prefill
    attention and of MLA's absorbed decode (``SPANS``);
  * ``serve_window``: the same gates for gemma3-1b (one pattern unit, 6
    layers) at 4 requests of 1024-token prompts (32 tokens) and gemma2-2b
    (one unit, 2 layers) at one request of 4160 tokens (8 tokens),
    prompts longer than their windows (512, 4096):
    the local layers' ring is written in prefill, the window masks
    flash, gemma3's decode wraps its ring (``SERVE_WINDOW``).

Each path's kernel launches are counted from 0 and checked; gemm's are
also counted by variant (split-K in decode, wgmma in prefill).  Then the
training path (``train.loop``, ``optim``, ``checkpoint``, ``runtime``):

  * ``train``: zamba2-1.2b at full width, 8 of its 38 layers
    (``TRAIN``: one of its six pattern units and its last two mamba
    layers), bf16, seeded, under
    the default target and policy: 8 steps of ``SyntheticLM``'s 8 rows x
    4096 tokens at accum 2 (``TRAIN``), warmup 1; every step's exact
    launches (``train_want``: forward, remat's recompute and gemm's two
    backward products), each of gemm, vtanh, attention and ssd on its
    kernel tier with its autograd Function in the graph, finite losses
    with step 7's below step 0's, every param leaf moved, and step 0's
    gradient against the vector tier's from the same state: the loss
    and the global norm within 3e-2, the median leaf within 3e-2 of its
    max, the worst within 0.3 (``step0_gate``); host-clock ms and
    tokens/s a step, the peak memory, and step 1 under torch.profiler
    with a marker kernel at the edges of each span (device ms by kernel,
    the idle share, the device ms of the kernels inside each span: the
    forward, remat's recompute, the update, gemm's backward with its
    transposed copies, flash's and ssd's vector-tier recompute), the
    bf16-peak share of 6 N tokens;
  * ``train_grad``: zamba2 float32 at the same depth, 2 x 1024 tokens, one
    backward on the kernel tier and one on the vector tier: the loss
    within 2e-4 and each leaf's gradient within 2e-4 of its max, but
    Mamba2's A_log leaves, held to a float64 run of the vector tier: no
    further from it than the vector tier is, by more than 2e-4 of its
    max (``grad_gate``); bf16 printed, not gated per leaf;
  * ``train_archs``: the other eight served archs (mistral's only
    sharded) at full width, cut to one pattern unit, float32, 2 x 512
    tokens (pixtral's with its stub patches), the same per-leaf gate
    (raw; mamba2's A_log held to its float64 gradient), MoE routing
    pinned (``route_probe``), each op's kernel tier and Function;
  * ``train_resume``: zamba2 cut to one pattern unit, 6 steps of 4 x
    512 tokens, a
    checkpoint every 2, a failure injected at step 4: one restart, the
    last step saved, the params restored bitwise and the losses equal to
    an uninterrupted run's; each save's bytes and seconds;
  * ``sharded``: ``train.loop.make_sharded_train_step`` on gloo ranks
    that share the card (``launch.mesh.run_ranks``): mistral-large-123b
    at full width and 1 of 88 layers on a (2, 2) mesh of four ranks
    (FSDP, data, tensor and sequence parallelism), granite-moe-1b-a400m
    at full width, 12 of its 24 layers, on (1, 2) (TP, expert
    parallelism),
    gemma3-1b at full width, 6 of 26 layers, on (2, 1) (data
    parallelism, ZeRO-1, ``compress_grads``), and tensor parallelism of
    every other block kind on (1, 2) at full width: zamba2-1.2b's 6-layer
    unit (ssd on each rank's SSM heads), deepseek-v2-lite's 2 layers
    (MLA), whisper-tiny (enc, dec) and gemma3-1b's unit (its kv head
    split), whisper-tiny again on (1, 4), its 6 heads split 2 / 2 / 2 /
    0 (ROADMAP A.9.10), and granite at full width, 12 of 24 layers, on
    (2, 2) (data > 1 with experts over 'model', ROADMAP A.9.9; its single
    rank dispatching as the two data shards do, ``shard_capacity``), bf16, 4
    x 512 tokens, 2 steps, each held to its single-rank step, each
    rank's launches its own (``sharded_want``: a rank without heads
    launches no flash) (``sharded_phase``, ``SHARDED``); float32 runs
    (zamba2 reduced on (1, 4), granite reduced with sequence parallelism
    through moe, and zamba2 reduced with 12 SSM heads in 3 groups on
    (1, 4), ranks 1 and 2 straddling two groups, every rank's ssd one
    group a head, ROADMAP A.9.11, among them) and three controls that
    must fail; ``compressed_psum`` of 64 M floats on two ranks,
    bitwise the formula on one; ``train/pipeline.py`` over two stages of
    gemma3's ``attn`` block, bitwise the blocks in turn, and its backward
    (ROADMAP C.36) within 3e-2 of the blocks' in turn, every stage's
    gradient; the launcher's ``--coordinator`` over ``nccl`` (one host);
    and serving on the mesh (``SHARDED_SERVE``): zamba2's unit on (1, 2),
    mistral's layer on (2, 2), whisper-tiny on (1, 4), gemma3-1b's 6
    layers on (1, 8) (one of its 4 heads on ranks 0-3, none on 4-7;
    serving only), granite on (2, 2) (routed by the single rank's
    indices) and the straddled zamba2 on (1, 4) in float32 prefill 4 x
    512 tokens and decode 8 steps fed the single rank's tokens, each
    rank's logits within 3e-2 (bf16) or 2e-4 (float32) of the single
    rank's, its launches exact (``serve_rank_want``), and the dry run of
    the same cells (``launch/dryrun.py``, traced here on stand-ins for
    rank 0 and the first rank without heads) equal to those ranks'
    launches and argument bytes, its peak bytes beside rank 0's
    ``max_memory_allocated``;
  * ``guard``: each of the thirteen kernel entries refuses an input that
    requires grad (grad mode on) and launches nothing.

Then the NEON-migration frontend runs on the card:

  * ``isa``: every op of ``repro_torch.core.isa`` in each of its tiers on
    CUDA tensors and again on the CPU, on the same numpy-made inputs
    (``isa_cases``: every NEON lane dtype the op takes below 64 bits,
    wraparound and saturation edges on unsigned 16- and 32-bit lanes,
    NaN and +-inf for the float ops, offsets that clamp, wrap or drop for
    the memory ops); integers bitwise, floats bitwise but for
    ``CARD_ULP``'s ops (rsqrt, the float sums), each op's largest ULP gap
    printed; every output on the card;
  * ``port``: ``repro_torch.port.load_corpus("examples/neon_corpus")``,
    each of the 24 kernels through ``PortedKernel``'s interpreter ->
    ``isa`` -> ``registry.dispatch`` on CUDA tensors under ``h100`` and
    ``rvv-128`` (policy pallas), at benchmarks/port_suite.py's wall
    geometry (n = 2048, tail 2051) and at n in {0, 1, strip - 1,
    strip + 1}, each output on the card and held to the harness's NumPy
    reference within tests/test_port_conformance.py's ULP budgets; one
    ``port_kernel`` line a kernel and target with its host-clock ms,
    dispatches, host reads and tiers; then counted under ``trace.count``
    at rvv-128 and n = 64, which must equal BENCH_port.json's
    ``total_instrs``;
  * ``port_compiled``: the same kernels through ``PortedKernel.compile``
    (one CUDA graph per call signature) under ``h100`` and ``rvv-128``,
    and re-tiled (``revec=True``) for ``rvv-1024``, on CUDA tensors at
    the same five lengths: every signature captured with no host read,
    each output held to the harness's reference (``conform_ulp``), to the
    interpreter of the same IR on the card (integers bitwise, floats
    within rtol 2e-6 / atol 2e-7) and bitwise to the eager walk
    (``jit=False``) and to each replay; one ``port_compiled_kernel``
    line a kernel and target (first-call and median replay ms on the
    host clock, host reads, captured, the interpreter's ms); then
    ``run_resilient`` under ``h100``, which must be served by
    ``compiled+revec`` undegraded for all 24, and with one fault forced
    at ``compile.run`` by a lower rung with the same bits; each replay is
    also compared bit for bit with the interpreter of the same IR on the
    card, and the kernels that differ print their largest ULP gap;
  * ``port_serve``: ``repro_torch.serve.PortEngine`` on the card with
    benchmarks/serve_port_suite.py's shape (vadd, vdot and the qs8 dot;
    rvv-128, rvv-1024 and h100; batches 1, 8 and 32; the ``fine`` and
    ``coarse`` buckets; lengths 20-61 and 20-121): one CUDA graph a
    bucket, every later slate a replay, 32 distinct lengths in a bucket
    capturing no new graph, every output held to a direct compiled call
    (integers bitwise, floats within the harness's budget), no fault or
    fallback, programs within buckets x targets x kernels; one
    ``port_serve_row`` line a kernel, target and batch with requests/s
    and p50 / p99 ms a submit (host clock, synchronized) and the graph's
    device ms; batch 32 must reach 5x batch 1's requests/s on at least
    one target a kernel.  No CUDA kernel is launched by these phases.

Finally
it times every kernel beside its plain version, one PyTorch library call
and the card's bound: the sharded path's calls at its local shapes
(``time_sharded``), the elementwise four also in bf16, vtanh at the
gelu's serving shapes and vsigmoid at granite's experts', ssd also in
float32 and at mamba2's shape, flash and decode at granite's, gemm also
in bf16 and float32 at the serving path's shapes (M = 4 and 2048 against
zamba2's five weight shapes, granite's two in bf16, deepseek's and
minicpm3's in both dtypes; gemma2's, gemma3's, whisper's and pixtral's,
pixtral's head among them, in bf16), vsigmoid at their silu's shapes in
both dtypes, the new archs' gelu and silu in bf16 and gemma2's final
softcap in float32, the train path's calls at its shapes (gemm's
forward and backward products at 16384 rows, the gelu, flash and ssd at
4 x 4096; ``time_train``), flash and decode at every ``LM_NEW`` call in bf16
(sdpa as the library call but where there is a softcap), and split-K
against the kernel above it at M = 4, 8 and 16 (the small-M
threshold); conv_hwc, dwconv, the pools and ibilinear also in bf16,
beside the library call in bf16 where there is one; ibilinear's rows
also carry ``corner_bytes`` (its bytes if no corner run is reused)
and their share at the HBM rate.  The fp32 gemm's tile plan
(``gemm.simt_plan``), conv_hwc's (``conv.conv_plan``), the launch shapes
of dwconv (``conv.dwconv_plan``), the pools (``pooling.pool_plan``) and
ibilinear (``ibilinear.ibilinear_plan``) and the decode kernel's split
plan (``decode_plan``) are printed before their times.  Each phase
prints one JSON line; the last line is ``{"ok": true, "device": {...}}``.
Any failed check raises, and the run exits non-zero without that line.
Without CUDA, or without the repo's ``src/`` beside it, it exits
non-zero at once.

``python3 chip_smoke.py --times maxpool,argmaxpool,ibilinear [--src
DIR]`` only builds and times the named Figure-2 kernels (not the
elementwise four) at both sizes and in both dtypes; ``--src`` runs the
``repro_torch`` under another ``src/``, such as an unpacked parent
commit, so that two commits can be timed in turns in one call.
``tools/train_grad_probe.py`` takes the readings behind the gradient
gates (sound runs on two seeds, planted faults).
``python3 chip_smoke.py --port`` runs only the ``port``,
``port_compiled`` and ``port_serve`` phases (no build) and prints no
result line.  ``tools/serve_gap_probe.py`` takes the readings behind
the serving check (sound runs, planted faults).
"""
from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time
import zlib
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
T0 = time.perf_counter()
SEED = 0
SPIN_CYCLES = 200_000          # ~0.1 ms of the card's clock (time_ms)
EW_OPS = ("vrelu", "vsqrt", "vtanh", "vsigmoid")
NEW_OPS = ("gemm", "conv_hwc", "dwconv", "maxpool", "argmaxpool",
           "ibilinear")
# The paper's Figure 2 in its plot order: BENCH_xnnpack.json row -> op
FIG2 = (("gemm", "gemm"), ("convhwc", "conv_hwc"), ("dwconv", "dwconv"),
        ("maxpool", "maxpool"), ("argmaxpool", "argmaxpool"),
        ("vrelu", "vrelu"), ("vsqrt", "vsqrt"), ("vtanh", "vtanh"),
        ("vsigmoid", "vsigmoid"), ("ibilinear", "ibilinear"))
ALL_OPS = tuple(op for _, op in FIG2)
# The Pallas kernel each CUDA kernel replaces (file:line of its entry point)
REPLACES = {"vtanh": "src/repro/kernels/elementwise.py:156",
            "vsigmoid": "src/repro/kernels/elementwise.py:161",
            "vsqrt": "src/repro/kernels/elementwise.py:166",
            "vrelu": "src/repro/kernels/elementwise.py:171",
            "gemm": "src/repro/kernels/gemm.py:53",
            "conv_hwc": "src/repro/kernels/conv.py:57",
            "dwconv": "src/repro/kernels/conv.py:99",
            "maxpool": "src/repro/kernels/pooling.py:84",
            "argmaxpool": "src/repro/kernels/pooling.py:91",
            "ibilinear": "src/repro/kernels/ibilinear.py:42",
            "flash_attention": "src/repro/kernels/flash_attention.py:96",
            "decode_attention": "src/repro/kernels/flash_attention.py:196",
            "ssd": "src/repro/kernels/ssd.py:68"}
CSRC = "src/repro_torch/kernels/csrc/"
SOURCE = {op: CSRC + f for op, f in (
    ("vtanh", "elementwise.cu"), ("vsigmoid", "elementwise.cu"),
    ("vsqrt", "elementwise.cu"), ("vrelu", "elementwise.cu"),
    ("gemm", "gemm.cu"), ("conv_hwc", "conv.cu"), ("dwconv", "conv.cu"),
    ("maxpool", "pooling.cu"), ("argmaxpool", "pooling.cu"),
    ("ibilinear", "ibilinear.cu"),
    ("flash_attention", "flash_attention.cu"),
    ("decode_attention", "flash_attention.cu"), ("ssd", "ssd.cu"))}
LM_OPS = ("flash_attention", "decode_attention", "ssd")
# conv_hwc off the Figure-2 shape: Ci 3 (an RGB first layer); Ci 24 with
# K slices (and 16-deep slots) that straddle taps; N 3, so pixel tiles
# cross images; 5x5 taps at stride 2; 1x1 taps; the unsplit 128 x 64 tile
CONV_CASES = (((2, 33, 35, 3), (3, 3, 3, 32), (1, 1)),
              ((1, 12, 12, 24), (3, 3, 24, 40), (1, 1)),
              ((3, 9, 10, 16), (3, 3, 16, 24), (1, 1)),
              ((2, 19, 21, 8), (5, 5, 8, 16), (2, 2)),
              ((2, 7, 9, 32), (1, 1, 32, 48), (1, 1)),
              ((2, 66, 66, 32), (3, 3, 32, 128), (1, 1)))
# dwconv off the Figure-2 shape (whose plan takes runs of 2 columns a
# thread): C 8, C 130 (one channel a thread), a 5x5 and a 1x1 window, and
# 3x3 runs of 8 and of 4 columns a thread with a ragged last run
DW_CASES = (((2, 10, 12, 8), (3, 3, 8)), ((1, 9, 11, 130), (3, 3, 130)),
            ((2, 12, 13, 64), (5, 5, 64)), ((2, 6, 7, 48), (1, 1, 48)),
            ((8, 64, 67, 128), (3, 3, 128)), ((2, 60, 45, 128), (3, 3, 128)))
# zamba2-1.2b's gemm weights as (K, N): the Mamba input and output
# projections, the shared block's q/k/v, MLP up and MLP down (= o) ones;
# a decode step multiplies M = 4 rows by them, a prefill M = 2048
SERVE_GEMM = ((2048, 8512), (4096, 2048), (4096, 4096), (4096, 8192),
              (8192, 2048))
# granite-moe-1b-a400m's: q and o (1024, 1024), k and v (1024, 512)
GRANITE_GEMM = ((1024, 1024), (1024, 512))
# deepseek-v2-lite-16b's: q (2048, 3072), the kv down projection (2048,
# 576), o (2048, 2048), the dense first layer's up/gate and down, the two
# shared experts' up/gate and down, the head; minicpm3-4b's: the q-lora
# down and up, kv down (2560, 288), o, the MLP's up/gate and down (its
# tied head is a plain matmul).  Each at M = 4 and 2048; W_uk and W_uv
# (MLA_PREFILL_GEMM) at M = 2048 alone, as the absorbed decode multiplies
# them outside any linear
DEEPSEEK_GEMM = ((2048, 3072), (2048, 576), (2048, 2048), (2048, 10944),
                 (10944, 2048), (2048, 2816), (2816, 2048), (2048, 102400))
MINICPM_GEMM = ((2560, 768), (768, 3840), (2560, 288), (2560, 2560),
                (2560, 6400), (6400, 2560))
MLA_PREFILL_GEMM = {"deepseek": (512, 2048), "minicpm3": (256, 2560)}
MLA_GEMM = {"deepseek": DEEPSEEK_GEMM, "minicpm3": MINICPM_GEMM}
SERVE_M = (4, 2048)
# gemma2-2b's, gemma3-1b's, whisper-tiny's and pixtral-12b's as (K, N):
# q, k/v, o, the MLP's up (and gate) and down; pixtral's untied head too
# (the tied heads are plain matmuls).  (K, N) -> the M of a decode step
# and of a prefill: 4 x 512 tokens, pixtral's 4 x (256 + 512) positions,
# whisper's 4 x 1500 frames through the encoder and the cross k/v
NEW_GEMM = {
    "gemma2": (((2304, 2048), (2304, 1024), (2048, 2304), (2304, 9216),
                (9216, 2304)), (4, 2048)),
    "gemma3": (((1152, 1024), (1152, 256), (1024, 1152), (1152, 6912),
                (6912, 1152)), (4, 2048)),
    "whisper": (((384, 384), (384, 1536), (1536, 384)), (4, 2048, 6000)),
    "pixtral": (((5120, 4096), (5120, 1024), (4096, 5120), (5120, 14336),
                 (14336, 5120), (5120, 131072)), (4, 3072))}
# the gelu (vtanh) and silu (vsigmoid) of their MLPs in a prefill and a
# decode step, and gemma2's final logit softcap (vtanh on the float32
# logits of every prompt position, then of one a step)
NEW_EW_SHAPES = (("vtanh", "gemma2_gelu_prefill", (4, 512, 9216)),
                 ("vtanh", "gemma2_gelu_decode", (4, 1, 9216)),
                 ("vtanh", "gemma3_gelu_prefill", (4, 512, 6912)),
                 ("vtanh", "whisper_gelu_prefill", (4, 512, 1536)),
                 ("vtanh", "whisper_enc_gelu", (4, 1500, 1536)),
                 ("vsigmoid", "pixtral_silu_prefill", (4, 768, 14336)),
                 ("vsigmoid", "pixtral_silu_decode", (4, 1, 14336)))
SOFTCAP_SHAPES = (("gemma2_softcap_prefill", (4, 512, 256000)),
                  ("gemma2_softcap_decode", (4, 1, 256000)))
# the silu (vsigmoid) of the new archs' MLPs: deepseek's experts at
# capacity 240 (prefill) and 8 (decode), its shared experts and dense
# first layer, minicpm3's MLP, each in a prefill and a decode step
SILU_SHAPES = (("deepseek_experts_prefill", (64, 240, 1408)),
               ("deepseek_experts_decode", (64, 8, 1408)),
               ("deepseek_shared_prefill", (4, 512, 2816)),
               ("deepseek_shared_decode", (4, 1, 2816)),
               ("deepseek_dense_prefill", (4, 512, 10944)),
               ("deepseek_dense_decode", (4, 1, 10944)),
               ("minicpm3_prefill", (4, 512, 6400)),
               ("minicpm3_decode", (4, 1, 6400)))
# gemm's kernels by variant, as the profiler names them
# (split-K's reduce also finishes the SIMT kernel's K slices, which the
# bf16 serving path never cuts)
GEMM_KERNELS = {"small_m": ("small_m_kernel", "splitk_reduce"),
                "mma": ("mma::mma_kernel",), "simt": ("simt_kernel",)}
# decode_attention's two kernels (the splits, then their merge)
DECODE_KERNELS = ("dec::split_kernel", "dec::combine_kernel")
# The serving profiles' spans: (name, module, function) whose kernels'
# device ms are read (a record_function range swapped in around it):
# MLA's prefill attention on the vector tier (its split dims) and its
# absorbed decode, which the reference runs in plain products
SPANS = (("attention", "repro_torch.kernels.ops", "attention"),
         ("mla_absorbed", "repro_torch.models.attention", "_mla_absorbed"))
# The serving paths: each arch at full width (and the depth SERVE_DEPTH
# gives), bf16 and again
# float32: 4 requests of 512-token prompts, 32 greedy tokens (whisper's
# requests each with 1500 stub frames)
SERVE = dict(batch=4, prompt=512, gen=32)
SERVE_ARCHS = ("zamba2-1.2b", "mamba2-1.3b", "granite-moe-1b-a400m",
               "deepseek-v2-lite-16b", "minicpm3-4b", "gemma2-2b",
               "gemma3-1b", "whisper-tiny", "mistral-large-123b",
               "pixtral-12b")
# The archs whose bf16 serving gate is the per-block check (``stream_gaps``
# at E2E_TOL) beside the float32 whole-model check (E2E_F32_TOL), their
# bf16 whole-model reading printed, not gated.  At their full depth (48
# and 40 layers) that reading is as large on correct runs as on faulty
# ones: mamba2-1.3b 0.03195 on the kernel run and 0.0314-0.0353 on other
# correct runs against 0.0349-0.0401 with a planted fault, pixtral-12b
# 0.02861-0.03356 against 0.03371-0.03783; the per-block reading
# separates them (mamba2 0.0059, pixtral 0.0253 correct; 0.0440-0.0504
# faulty), as the float32 one does (mamba2 1.2e-5): ROADMAP C.22, C.23,
# tools/serve_gap_probe.py.  Every run plants the controls below in them
BLOCK_GATED = ("mamba2-1.3b", "pixtral-12b")
# the controls (tools/serve_gap_probe.py's): a fault in the middle layer
# of the decoder stack at every forward, its update scaled by FAULT_SCALE
# or cut to FAULT_MANTISSA bits of float32's 23; each must fail the bf16
# per-block gate, and the scaled one the float32 whole-model gate, teacher
# forced over the prefill and CONTROL_STEPS - 1 decode steps
FAULT_SCALE = 1.05
FAULT_MANTISSA = 4
SERVE_CONTROLS = ("scale", "mantissa")
CONTROL_STEPS = 4
# archs served at full width and cut depth: mistral's 88 layers take ~246
# GB in bf16; 8 of them (~24 GB, ~47 GB for the float32 check) fit the
# card.  The MLA archs, whose attention runs the vector tier, are cut so
# that the whole run stays within its time (their layers past the first
# few repeat the same block; deepseek keeps its dense first layer): at
# full depth deepseek's serving took 46 s more and the run 979 s.
# granite and the gemmas are cut (whole pattern units) for the same
# reason, the gemmas to one unit (gemma2's local and global pair, gemma3's
# five local layers and its global one) to pay for the full depth of
# mamba2-1.3b and pixtral-12b; mistral, deepseek (its dense first layer
# and two moe layers) and minicpm3 cut again to pay for the sharded
# phase's granite on (2, 2) and straddled SSM groups
SERVE_DEPTH = {"mistral-large-123b": 4, "deepseek-v2-lite-16b": 3,
               "minicpm3-4b": 4, "granite-moe-1b-a400m": 6,
               "gemma2-2b": 2, "gemma3-1b": 6}
# The sliding-window traffic (``serve_window``): prompts longer than each
# gemma's window, so that the local layers' ring is written in prefill,
# the window masks flash and (gemma3) decode wraps the ring; gemma2's
# vector tier takes its chunked attention there (Sq x Sk > 2048^2); each
# model cut to one pattern unit (``layers``: gemma3's five local layers
# and its global one, gemma2's local and global pair), which holds every
# mechanism the traffic drives, to keep the script within its time limit
SERVE_WINDOW = (("gemma3-1b", dict(batch=4, prompt=1024, gen=32, layers=6)),
                ("gemma2-2b", dict(batch=1, prompt=4160, gen=8, layers=2)))
# the block kinds whose layers attend (each with an MLP after it), and
# those that are Mamba2 layers
ATTN_KINDS = ("mamba_shared", "moe", "moe_dense", "attn", "local", "enc",
              "dec")
MAMBA_KINDS = ("mamba", "mamba_shared")
# an MLP's activation -> the elementwise op it dispatches
ACT_OP = {"gelu": "vtanh", "silu": "vsigmoid"}
# LM kernels against their plain versions: the reference's kernel TOL
# (fp32 2e-4; bf16 3e-2), relative and absolute.  The serving check:
# logits within 3e-2 of the largest logit of the kernel run; in bf16 also
# each block's output, the vector block fed the kernel block's input,
# within one rounding step of the output plus 3e-2 of the block's update.
LM_TOL = {"float32": 2e-4, "bfloat16": 3e-2}
E2E_TOL = 3e-2
# The same check with the model in float32, where the two runs differ only
# in the order of their sums: the reference's fp32 kernel TOL
E2E_F32_TOL = 2e-4
# Tolerances of a kernel against its plain version.  Elementwise: fp32
# within a few ulps (the rsqrt seed is approximate on the card), bf16 one
# ulp at 1.  gemm and conv_hwc sum in another order than their plain
# versions: the reference's kernel TOL (tests/test_kernels.py), fp32
# 2e-4, bf16 3e-2.  EXACT ops round where their plain versions round and
# must agree bitwise.
TOL = {"float32": (1e-5, 2e-6), "bfloat16": (8e-3, 8e-3)}
MM_TOL = {"float32": (2e-4, 2e-4), "bfloat16": (3e-2, 3e-2)}
EXACT = ("vrelu", "dwconv", "maxpool", "argmaxpool", "ibilinear")
# The dtypes each Figure-2 kernel but the elementwise four is timed in
# (gemm's bf16 rows are at the serving path's shapes)
NEW_DTYPES = {op: ("float32", "bfloat16") for op in NEW_OPS}
NEW_DTYPES["gemm"] = ("float32",)
# The train path (``train``): zamba2-1.2b at full width, 8 layers, bf16,
# 8 rows of 4096 tokens a step (train_4k's sequence, src/repro/configs/
# base.py:255; the pod's 256 rows cut to 8 for one card), accum 2, 8
# steps; step 0's loss and grad_norm within TRAIN_TOL (bf16's E2E_TOL) of
# the vector tier's, and its gradient leaf by leaf: the median leaf's max
# |g_k - g_v| / max |g_v| within TRAIN_TOL, the worst leaf's within
# TRAIN_LEAF_TOL (bf16 rounding alone reads up to 0.137 on a Mamba2 A_log
# at 2 x 1024; a gradient missing or 1.5x too large reads 0.5 or more:
# tools/train_grad_probe.py).  ``train_grad``: the gradient gate at 2 x
# 1024 tokens; ``train_archs``: the other served archs cut to one pattern
# unit at 2 x 512; ``train_resume``: zamba2 cut to one pattern unit,
# checkpoint and restart
# (8 of zamba2's 38 layers: one of its six pattern units and its last
# two mamba layers, which keep every block kind, to keep the script within
# its time limit with the sharded phase's granite on (2, 2) and straddled
# SSM groups)
TRAIN = dict(arch="zamba2-1.2b", layers=8, batch=8, seq=4096, accum=2,
             steps=8)
TRAIN_TOL = 3e-2
TRAIN_LEAF_TOL = 0.3
TRAIN_GRAD = dict(batch=2, seq=1024)
TRAIN_ARCHS = ("mamba2-1.3b", "granite-moe-1b-a400m", "deepseek-v2-lite-16b",
               "minicpm3-4b", "gemma2-2b", "gemma3-1b", "whisper-tiny",
               "pixtral-12b")
TRAIN_ARCH_TRAFFIC = dict(batch=2, seq=512)
# (4 x 512 tokens a step, to keep the script within its time limit)
TRAIN_RESUME = dict(batch=4, seq=512, steps=6, ckpt_every=2, fail_at=4)
# a microbatch's rows in ``train``: 4 x 4096
TRAIN_M = TRAIN["batch"] // TRAIN["accum"] * TRAIN["seq"]
# The profiled train step's spans (name, module, function), a marker
# kernel launched as each enters and leaves (``marks_swapped``): each
# microbatch's forward, each block (in the forward, part of it; in the
# backward, remat's recompute), the optimizer update, and the backward
# of gemm's, flash's and ssd's Functions
TRAIN_SPANS = (("forward", "repro_torch.train.loop", "loss_fn"),
               ("block", "repro_torch.models.blocks", "block_apply"),
               ("update", "repro_torch.optim.adamw", "update"),
               ("gemm_backward", "repro_torch.kernels.gemm",
                "GemmFn.backward"),
               ("flash_backward", "repro_torch.kernels.flash_attention",
                "FlashAttentionFn.backward"),
               ("ssd_backward", "repro_torch.kernels.ssd", "SsdFn.backward"))
# The modules that name float32 on the vector tier's train path: the
# float64 witness of ``train_grad`` reads their float32 as float64
TWIN_MODULES = ("repro_torch.kernels.ref", "repro_torch.models.layers",
                "repro_torch.models.ssm", "repro_torch.models.attention",
                "repro_torch.models.blocks", "repro_torch.models.model",
                "repro_torch.models.moe", "repro_torch.train.loop")
# the main path's outputs against the torch oracles: the reference's TOL
ORACLE_TOL = 2e-4
# The Figure-2 clamp bounds of vrelu (benchmarks/xnnpack_suite.py)
RELU_BOUNDS = (0.0, 6.0)
EDGE = [0.0, -0.0, float("inf"), float("-inf"), float("nan"), 1e-40,
        20.0, -20.0, 30.0, -30.0, 35.0, -35.0, 0.5, 2.5]


def emit(phase: str, **fields) -> None:
    """One JSON line, with the seconds since the script started (``t``)."""
    print(json.dumps({"phase": phase, **fields,
                      "t": time.perf_counter() - T0}), flush=True)


def extra_args(op):
    return RELU_BOUNDS if op == "vrelu" else ()


def workload(op, base):
    """The Figure-2 input of an elementwise ``op`` made from standard
    normals ``base`` (benchmarks/xnnpack_suite.py: workloads())."""
    if op == "vsqrt":
        return base.abs() + 0.01
    if op in ("vtanh", "vsigmoid"):
        return 2.0 * base
    return base


def _normal(rng, shape, scale=1.0):
    import torch
    return torch.from_numpy((scale * rng.standard_normal(shape))
                            .astype(np.float32))


def ibilinear_args(rng, h, w, c, p):
    """img, top-left corners in [0, H-2] x [0, W-2], weights in [0, 1)."""
    import torch
    return (_normal(rng, (h, w, c)),
            torch.from_numpy(rng.integers(0, h - 2, p).astype(np.int32)),
            torch.from_numpy(rng.integers(0, w - 2, p).astype(np.int32)),
            torch.from_numpy(rng.random(p).astype(np.float32)),
            torch.from_numpy(rng.random(p).astype(np.float32)))


def figure2_args(op, rng):
    """The Figure-2 workload of ``op`` (benchmarks/xnnpack_suite.py:
    workloads()), made with numpy from ``rng``."""
    if op in EW_OPS:
        return (workload(op, _normal(rng, (1024, 1024))),) + extra_args(op)
    if op == "gemm":
        return (_normal(rng, (256, 512)), _normal(rng, (512, 256)),
                _normal(rng, (256,)), -1.0, 1.0)
    if op == "conv_hwc":
        return (_normal(rng, (1, 28, 28, 128)),
                _normal(rng, (3, 3, 128, 128), 0.1), _normal(rng, (128,)))
    if op == "dwconv":
        return (_normal(rng, (1, 56, 56, 128)),
                _normal(rng, (3, 3, 128), 0.3), _normal(rng, (128,)))
    if op in ("maxpool", "argmaxpool"):
        return (_normal(rng, (1, 56, 56, 256)), (2, 2))
    return ibilinear_args(rng, 56, 56, 64, 56 * 56)


def awkward_args(op, rng):
    """Shapes off the kernels' tiles: ragged M/N/K and no bias for gemm,
    and K = 0 (a 'model' rank's output projection with no heads: the
    bias, clamped) at a decode's M and a prefill's, stride 2, non-square
    taps and CONV_CASES for conv, DW_CASES for dwconv, odd extents for
    the pools, a pixel count off the block size for ibilinear."""
    n = _normal
    if op == "gemm":
        return [(n(rng, (129, 33)), n(rng, (33, 67)), None),
                (n(rng, (1, 70)), n(rng, (70, 1)), n(rng, (1,)), -0.5, 0.5)] \
            + [(n(rng, (m, 0)), n(rng, (0, 67)), n(rng, (67,)), -0.5, 0.5)
               for m in (4, 129)]
    if op == "conv_hwc":
        return [(n(rng, (2, 17, 19, 24)), n(rng, (3, 2, 24, 40), 0.3),
                 n(rng, (40,)), (2, 1)),
                (n(rng, (2, 17, 19, 24)), n(rng, (1, 3, 24, 40), 0.3), None,
                 (2, 2))] + \
            [(n(rng, xs), n(rng, ws, 0.3), n(rng, ws[3:]), st)
             for xs, ws, st in CONV_CASES]
    if op == "dwconv":
        return [(n(rng, (2, 9, 11, 20)), n(rng, (1, 3, 20), 0.3), None),
                (n(rng, (3, 7, 5, 33)), n(rng, (3, 3, 33), 0.3),
                 n(rng, (33,)))] + \
            [(n(rng, xs), n(rng, ws, 0.3), n(rng, ws[2:]))
             for xs, ws in DW_CASES]
    if op in ("maxpool", "argmaxpool"):
        return [(n(rng, (2, 13, 15, 12)), (2, 2)),
                (n(rng, (2, 13, 15, 12)), (3, 2))]
    return [ibilinear_args(rng, 20, 24, 8, 1001)]


def serve_args(op, rng):
    """gemm at the serving path's shapes (a decode step's M = 4 and a
    prefill's M = 2048 rows, K up to 8192), no bias and no clamp, weights
    scaled by d_in**-0.5 as the model's are."""
    if op != "gemm":
        return []
    inf = float("inf")
    return [(_normal(rng, (m, k)), _normal(rng, (k, n), k ** -0.5), None,
             -inf, inf)
            for m, k, n in ((4, 2048, 8192), (2048, 2048, 8192),
                            (2048, 8192, 2048))]


def edge_args(op, rng):
    """NaN and +-inf through the gemm clamp and the pools (with ties)."""
    import torch
    if op == "gemm":
        a = _normal(rng, (40, 24))
        a[1, 2], a[3, 0], a[4, 4] = float("nan"), float("inf"), \
            float("-inf")
        return [(a, _normal(rng, (24, 9)).abs() + 0.1, _normal(rng, (9,)),
                 -1.0, 1.0)]
    if op in ("maxpool", "argmaxpool"):
        x = np.round(rng.standard_normal((2, 9, 8, 6))).astype(np.float32)
        x[0, 0, 0, 0], x[0, 2, 3, 1], x[1, 5, 5, 2] = np.nan, np.inf, -np.inf
        x[1, 6:8, 6:8, 3] = np.nan
        return [(torch.from_numpy(x), (2, 2))]
    return []


def vector_args(op, rng):
    """The pools and ibilinear on and off their 16-byte vectors, as
    (label, args): C 12 (off the bf16 vector) and 130 (off both), the
    generic window (3x3, also on the vector at C 16), the NaN, inf and
    tie case at C 16 (on the vector in both dtypes), and the Figure-2
    input, which main() moves into a view 4 bytes off 16-byte alignment
    ("off16")."""
    import torch
    n = _normal
    if op == "ibilinear":
        return [("awkward", ibilinear_args(rng, 20, 24, 12, 777)),
                ("awkward", ibilinear_args(rng, 20, 24, 130, 333)),
                ("off16", figure2_args(op, rng))]
    x = np.round(rng.standard_normal((2, 9, 8, 16))).astype(np.float32)
    x[0, 0, 0, 0], x[0, 2, 3, 1], x[1, 5, 5, 2] = np.nan, np.inf, -np.inf
    x[1, 6:8, 6:8, 3] = np.nan
    return [("awkward", (n(rng, (2, 13, 15, 12)), (3, 3))),
            ("awkward", (n(rng, (2, 12, 13, 16)), (3, 3))),
            ("awkward", (n(rng, (2, 13, 15, 130)), (2, 2))),
            ("edge", (torch.from_numpy(x), (2, 2))),
            ("edge", (torch.from_numpy(x), (3, 3))),
            ("off16", figure2_args(op, rng))]


def off16(t):
    """A copy of ``t`` in a view 4 bytes off 16-byte alignment, so that a
    kernel takes its one-element path."""
    import torch
    flat = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    base = (-flat.data_ptr() % 16 + 4) // flat.element_size()
    v = flat[base:base + t.numel()].view(t.shape)
    v.copy_(t)
    if v.data_ptr() % 16 != 4:
        raise AssertionError(f"off16: view at {v.data_ptr() % 16} bytes")
    return v


def big_args(op, gen, dev):
    """One size per new kernel where its bound exceeds ~50 us, made on the
    card."""
    import torch

    def r(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev)

    if op == "gemm":
        return (r(2048, 2048), r(2048, 2048), r(2048), -1.0, 1.0)
    if op == "conv_hwc":
        return (r(8, 56, 56, 128), r(3, 3, 128, 128, scale=0.1), r(128))
    if op == "dwconv":
        return (r(16, 112, 112, 128), r(3, 3, 128, scale=0.3), r(128))
    if op in ("maxpool", "argmaxpool"):
        return (r(16, 112, 112, 256), (2, 2))
    h = w = 512
    p = h * w
    return (r(h, w, 128),
            torch.randint(0, h - 1, (p,), generator=gen, device=dev,
                          dtype=torch.int32),
            torch.randint(0, w - 1, (p,), generator=gen, device=dev,
                          dtype=torch.int32),
            torch.rand(p, generator=gen, device=dev),
            torch.rand(p, generator=gen, device=dev))


def on(args, dev, dtype=None, keep=()):
    """``args`` with every tensor moved to ``dev``, and floating tensors
    cast to ``dtype`` when given, except at the positions in ``keep``."""
    import torch
    out = []
    for i, a in enumerate(args):
        if isinstance(a, torch.Tensor):
            a = a.to(dev)
            if dtype is not None and a.is_floating_point() and i not in keep:
                a = a.to(dtype)
        out.append(a)
    return tuple(out)


def library_call(op, args):
    """One PyTorch call computing the same function, used only as a
    yardstick of time (never by the port); None where there is none.
    Weights are brought to the layout the library wants beforehand."""
    import torch
    import torch.nn.functional as F
    if op == "gemm":
        a, b, bias, lo, hi = args
        return lambda: torch.addmm(bias, a, b).clamp_(lo, hi)
    if op in ("conv_hwc", "dwconv"):
        x, w, bias = args[:3]
        xc = x.permute(0, 3, 1, 2)                 # NHWC = channels last
        if op == "conv_hwc":
            wc, groups = w.permute(3, 2, 0, 1), 1
        else:
            wc, groups = w.permute(2, 0, 1).unsqueeze(1), w.shape[-1]
        wc = wc.contiguous(memory_format=torch.channels_last)
        return lambda: F.conv2d(xc, wc, bias, groups=groups)
    if op in ("maxpool", "argmaxpool"):
        xc, window = args[0].permute(0, 3, 1, 2), args[1]
        return lambda: F.max_pool2d(xc, window,
                                    return_indices=op == "argmaxpool")
    return None


def conv_checks(op, rng, dev):
    """conv_hwc: two runs under a sliced plan (the Figure-2 shape, 6 K
    slices) agree bitwise.  dwconv: an x that is a view 4 bytes off
    16-byte alignment (one channel a thread) against the plain version.
    In fp32 and bf16; returns the cases' records."""
    import torch
    from repro_torch.kernels import conv
    out = []
    for dt in (torch.float32, torch.bfloat16):
        if op == "conv_hwc":
            args = on(figure2_args(op, rng), dev, dt)
            splits = conv.conv_plan(args[0].shape, args[1].shape)[2]
            first = conv.conv_hwc(*args)
            if splits < 2 or not all(torch.equal(conv.conv_hwc(*args), first)
                                     for _ in range(3)):
                raise AssertionError(f"conv_hwc/{dt}: runs under a plan of "
                                     f"{splits} K slices differ")
            out.append({"case": "repeat", "dtype": str(dt)[6:],
                        "splits": splits, "bitwise": True})
            continue
        x, w, bias = on((_normal(rng, (2, 12, 14, 64)),
                         _normal(rng, (3, 3, 64), 0.3),
                         _normal(rng, (64,))), dev, dt)
        flat = torch.empty(x.numel() + 8, dtype=dt, device=dev)
        off = 4 // x.element_size()
        xv = flat[off:off + x.numel()].view(x.shape)
        xv.copy_(x)
        if xv.data_ptr() % 16 != 4 or conv.dwconv_vector(xv, w, bias):
            raise AssertionError("dwconv: the view is not 4 bytes off 16")
        err = compare(op, conv.dwconv(xv, w, bias),
                      conv.dwconv_plain(xv, w, bias))
        out.append({"case": "x_off_16", "dtype": str(dt)[6:],
                    "shapes": [list(x.shape), list(w.shape)],
                    "max_abs_err": err})
    return out


# The attention calls of gemma2, gemma3, whisper and pixtral, as (batch,
# query rows, keys, heads, kv heads, head dim, causal, window, softcap)
# for flash and (batch, cache slots, heads, kv heads, head dim, valid
# length, window, softcap) for decode: gemma2's (window 4096, softcap 50)
# and gemma3's (MQA, window 512) local layers at the standard traffic and
# at the window traffic (``SERVE_WINDOW``); whisper's encoder (non-causal,
# 1500 frames), decoder self-attention and cross-attention at prefill and
# at a decode step (one query row); pixtral's 256 patches + 512 tokens;
# each decode against its cache in the middle of the 32 steps (gemma3's
# ring full: 512 of 512 slots; gemma2's window traffic 4096 of 4096).
# The global layers of the gemmas run the same calls without the window.
LM_NEW = {
    "flash_attention": {
        "gemma2": (4, 512, 512, 8, 4, 256, True, 4096, 50.0),
        "gemma2_window": (1, 4160, 4160, 8, 4, 256, True, 4096, 50.0),
        "gemma3": (4, 512, 512, 4, 1, 256, True, 512, None),
        "gemma3_window": (4, 1024, 1024, 4, 1, 256, True, 512, None),
        "whisper_enc": (4, 1500, 1500, 6, 6, 64, False, None, None),
        "whisper_self": (4, 512, 512, 6, 6, 64, True, None, None),
        "whisper_cross": (4, 512, 1500, 6, 6, 64, False, None, None),
        "whisper_cross_decode": (4, 1, 1500, 6, 6, 64, False, None, None),
        "pixtral": (4, 768, 768, 32, 8, 128, True, None, None)},
    "decode_attention": {
        "gemma2": (4, 544, 8, 4, 256, 528, None, 50.0),
        "gemma2_window": (1, 4096, 8, 4, 256, 4096, None, 50.0),
        "gemma3": (4, 512, 4, 1, 256, 512, None, None),
        "whisper": (4, 544, 6, 6, 64, 528, None, None),
        "pixtral": (4, 800, 32, 8, 128, 784, None, None)}}


def lm_new_args(op, spec, draw, lengths):
    """An ``LM_NEW`` call's arguments: ``draw(shape)`` makes each tensor,
    ``lengths(b, n)`` decode's valid lengths."""
    if op == "flash_attention":
        b, sq, sk, h, hkv, d, causal, window, softcap = spec
        return (draw((b, sq, h, d)), draw((b, sk, hkv, d)),
                draw((b, sk, hkv, d)), causal, window, softcap)
    b, s, h, hkv, d, n, window, softcap = spec
    return (draw((b, 1, h, d)), draw((b, s, hkv, d)), draw((b, s, hkv, d)),
            lengths(b, n), window, softcap)


def lm_cases(op, rng):
    """(label, args) of an LM kernel on the host, fp32, made with numpy:
    zamba2's serving shapes first, granite's (GQA 16/8, D 64) and
    mamba2's (ssd at g 1, n 128) next, then the calls of gemma2, gemma3,
    whisper and pixtral (``LM_NEW``), GQA with a window and softcap 50,
    Sq < Sk with D 16 (attention), ragged lengths with a window (decode),
    s off the chunk, s < 8 and g < h (ssd)."""
    import torch
    n = _normal
    new = [(label, lm_new_args(
        op, spec, lambda shape: n(rng, shape),
        lambda b, v: torch.full((b,), v, dtype=torch.int32)))
        for label, spec in LM_NEW.get(op, {}).items()]
    if op == "flash_attention":
        def qkv(b, sq, sk, h, hkv, d):
            return (n(rng, (b, sq, h, d)), n(rng, (b, sk, hkv, d)),
                    n(rng, (b, sk, hkv, d)))
        return [("zamba2", qkv(4, 512, 512, 32, 32, 128) + (True, None, None)),
                ("granite", qkv(4, 512, 512, 16, 8, 64) + (True, None, None)),
                *new,
                ("gqa_window_softcap",
                 qkv(2, 300, 300, 8, 4, 256) + (True, 64, 50.0)),
                ("sq_lt_sk_d16", qkv(2, 50, 200, 4, 2, 16) + (True, None, None)),
                ("noncausal_softcap",
                 qkv(1, 37, 45, 6, 3, 24) + (False, None, 5.0))]
    if op == "decode_attention":
        def dec(b, s, h, hkv, d, lens):
            return (n(rng, (b, 1, h, d)), n(rng, (b, s, hkv, d)),
                    n(rng, (b, s, hkv, d)),
                    torch.tensor(lens, dtype=torch.int32))
        return [("zamba2", dec(4, 544, 32, 32, 128, (528,) * 4) + (None, None)),
                ("granite", dec(4, 544, 16, 8, 64, (528,) * 4) + (None, None)),
                *new,
                ("ragged_window_gqa_softcap",
                 dec(4, 200, 8, 4, 256, (0, 1, 100, 200)) + (64, 50.0)),
                ("ragged_d16", dec(3, 70, 4, 2, 16, (5, 69, 70)) + (None, None)),
                # 17 splits; splits wholly past a row's length or before
                # its window; D 20 (rows read element by element)
                ("long_ragged", dec(2, 4096, 8, 2, 128, (4000, 1234))
                 + (None, None)),
                ("empty_splits_window",
                 dec(4, 1024, 4, 4, 64, (0, 10, 300, 1024)) + (100, None)),
                ("d20_window_softcap",
                 dec(2, 300, 4, 2, 20, (300, 150)) + (100, 30.0))]

    def ssd_args(b, s, h, p, g, n_):
        # slow decays (dt ~ 0.05, |A| ~ 1): the state carries across chunks
        dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) - 3.0))
        return (n(rng, (b, s, h, p)), torch.from_numpy(dt.astype(np.float32)),
                -torch.from_numpy(np.exp(0.5 * rng.standard_normal(h))
                                  .astype(np.float32)),
                n(rng, (b, s, g, n_), 0.5), n(rng, (b, s, g, n_), 0.5),
                torch.ones(h))
    def fast_decay(b, s, h, p, g, n_):
        # dt 2 and A down to -60: exp(la_i - la_j) above the diagonal
        # overflows unless masked first (ROADMAP C.9a)
        args = list(ssd_args(b, s, h, p, g, n_))
        args[1] = torch.full((b, s, h), 2.0)
        args[2] = -torch.linspace(1.0, 60.0, h)
        return tuple(args)
    return [("zamba2", ssd_args(4, 512, 64, 64, 2, 64)),
            ("mamba2", ssd_args(4, 512, 64, 64, 1, 128)),
            ("off_chunk", ssd_args(2, 300, 8, 16, 2, 32)),
            ("s_lt_8", ssd_args(2, 5, 4, 16, 4, 16)),
            ("g_lt_h", ssd_args(1, 130, 6, 32, 1, 8)),
            ("s_1", ssd_args(2, 1, 4, 64, 2, 64)),
            ("s_8", ssd_args(2, 8, 4, 16, 1, 16)),
            ("s_2048_16_chunks", ssd_args(1, 2048, 8, 64, 2, 64)),
            ("p_128", ssd_args(1, 300, 4, 128, 2, 64)),
            ("p_20_n_12", ssd_args(2, 260, 4, 20, 2, 12)),
            ("fast_decay", fast_decay(1, 300, 4, 64, 1, 64))]


def lm_keep(op):
    """Argument positions an LM kernel takes in float32 whatever the
    working dtype: ssd's dt, A and D."""
    return (1, 2, 5) if op == "ssd" else ()


# The LM kernels' serving calls: arch -> attention's (heads, kv heads,
# head dim) and the Mamba2 layers' (ssd groups, state)
LM_SHAPES = {"zamba2": dict(attn=(32, 32, 128), ssd=(2, 64)),
             "granite": dict(attn=(16, 8, 64)), "mamba2": dict(ssd=(1, 128))}


def lm_time_args(op, gen, dev, arch="zamba2"):
    """An arch's serving inputs of an LM kernel, bf16, made on the card:
    prefill attention and ssd at 4 x 512, decode against a 544-slot cache
    with 528 valid positions (the middle of the 32 decode steps)."""
    import torch
    bf = torch.bfloat16
    shapes = LM_SHAPES[arch]

    def r(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(bf)
    if op == "flash_attention":
        h, hkv, d = shapes["attn"]
        return (r(4, 512, h, d), r(4, 512, hkv, d), r(4, 512, hkv, d),
                True, None, None)
    if op == "decode_attention":
        h, hkv, d = shapes["attn"]
        return (r(4, 1, h, d), r(4, 544, hkv, d), r(4, 544, hkv, d),
                torch.full((4,), 528, dtype=torch.int32, device=dev),
                None, None)
    g, n = shapes["ssd"]
    dt = torch.nn.functional.softplus(
        torch.randn((4, 512, 64), generator=gen, device=dev) - 1.0)
    A = -torch.arange(1, 65, dtype=torch.float32, device=dev)
    return (r(4, 512, 64, 64), dt, A, r(4, 512, g, n, scale=0.5),
            r(4, 512, g, n, scale=0.5), None)


def lm_library_call(op, args):
    """scaled_dot_product_attention on the same inputs (heads moved to
    dim 1 beforehand, as it wants them; GQA heads shared by it; a window
    as a boolean mask made beforehand), a yardstick of time only; none
    for ssd, and none where the call has a softcap, which sdpa does not
    apply."""
    import torch
    import torch.nn.functional as F
    if op == "ssd" or args[5] is not None:
        return None
    q, k, v = (t.transpose(1, 2).contiguous() for t in args[:3])
    gqa = q.shape[1] != k.shape[1]
    if op == "flash_attention":
        causal, window = args[3], args[4]
        if window is None:
            return lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=gqa)
        sq, sk = q.shape[2], k.shape[2]
        i = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        j = torch.arange(sk, device=q.device)[None, :]
        mask = (i - j < window) & ((i >= j) if causal else True)
        return lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=gqa)
    lens = args[3]
    mask = (torch.arange(k.shape[2], device=k.device)[None, :]
            < lens[:, None])[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=gqa)


def emit_simt_plan(size, m, n, k):
    """The fp32 SIMT gemm's plan for (m, k) @ (k, n): its tile, K slices
    and blocks in flight."""
    from repro_torch.kernels import gemm
    bm, bn, splits, ks = gemm.simt_plan(m, n, k)
    emit("simt_plan", size=size, shapes=[[m, k], [k, n]], tile=[bm, bn],
         splits=splits, ks=ks,
         blocks=-(-m // bm) * -(-n // bn) * splits)


def emit_plan(size, op, args):
    """The launch plan of a Figure-2 kernel other than gemm for these
    operands: conv_hwc's implicit GEMM (tile, K slices, blocks in
    flight), dwconv's launch shape, the pools' (vector width, window
    instantiation, block size, index width) or ibilinear's (vector width,
    threads a pixel, block size, index width)."""
    from repro_torch.kernels import _build, conv, ibilinear, pooling
    x, w = args[:2]
    dtype = str(x.dtype).replace("torch.", "")
    shapes = [list(a.shape) for a in args if hasattr(a, "shape")]
    if op in ("maxpool", "argmaxpool"):
        emit("pool_plan", size=size, op=op, dtype=dtype, shapes=shapes,
             taps=list(w), **pooling.pool_plan(x.shape, x.dtype, w,
                                                 _build.vector16(x)))
        return
    if op == "ibilinear":
        emit("ibilinear_plan", size=size, dtype=dtype, shapes=shapes,
             **ibilinear.ibilinear_plan(x.shape, w.shape[0], x.dtype,
                                        _build.vector16(x)))
        return
    if op == "dwconv":
        emit("dwconv_plan", size=size, dtype=dtype, shapes=shapes[:2],
             **conv.dwconv_plan(x.shape, w.shape,
                                conv.dwconv_vector(*args[:3])))
        return
    stride = args[3] if len(args) > 3 else (1, 1)
    n, h, iw, ci = x.shape
    kh, kw, _, co = w.shape
    oh, ow = conv.out_hw(h, iw, kh, kw, stride)
    bm, bn, splits, ks = conv.conv_plan(x.shape, w.shape, stride)
    emit("conv_plan", size=size, dtype=dtype, shapes=shapes[:2],
         gemm=[n * oh * ow, co, kh * kw * ci], tile=[bm, bn], splits=splits,
         ks=ks, blocks=-(-n * oh * ow // bm) * -(-co // bn) * splits)


def corner_bytes(args, out):
    """ibilinear's bytes if no corner run is reused: each pixel's four
    C-element corners read from memory, its four per-pixel scalars read
    once and its C outputs written once."""
    img, *per_pixel = args
    p, c = out.shape
    return 4 * p * c * img.element_size() + \
        sum(t.numel() * t.element_size() for t in per_pixel) + \
        out.numel() * out.element_size()


def time_new(op, mod, size, targs, flush):
    """One time row of a Figure-2 kernel other than the elementwise four:
    the kernel, its plain version and the library call on ``targs``,
    beside the card's bound (bf16 conv_hwc: its tensor cores'); for
    ibilinear also ``corner_bytes`` and their time at the HBM rate as a
    share of the kernel's."""
    import torch
    from repro_torch.kernels import cost
    out = mod.KERNELS[op](*targs)
    k_ms = time_ms(lambda: mod.KERNELS[op](*targs), flush)
    p_ms = time_ms(lambda: mod.PLAIN[op](*targs), flush)
    lib = library_call(op, targs)
    l_ms = None if lib is None else time_ms(lib, flush)
    b_ms, b_by, nbytes, n_ops = cost.bound(op, targs, out)
    dt = targs[0].dtype
    row = {"op": op, "size": size, "dtype": str(dt).replace("torch.", ""),
           "shapes": [list(a.shape) for a in targs
                      if isinstance(a, torch.Tensor)],
           "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
           "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "ops": n_ops,
           "bound_share": b_ms / k_ms}
    if l_ms is not None:
        row["library_ratio"] = k_ms / l_ms
    if op == "ibilinear":
        row["corner_bytes"] = corner_bytes(targs, out)
        row["corner_share"] = \
            row["corner_bytes"] / cost.HBM_BYTES_PER_S * 1e3 / k_ms
    return row


def compare(op, got, want):
    """Max abs error over finite entries; raises unless shapes, dtypes,
    NaN and inf positions agree and the rest is within the stated
    tolerance (bitwise for the EXACT ops and for integer outputs)."""
    import torch
    if isinstance(got, tuple):
        return max(compare(op, g, w) for g, w in zip(got, want))
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{op}: {got.shape}/{got.dtype} vs "
                             f"{want.shape}/{want.dtype}")
    if not got.is_floating_point():
        if not torch.equal(got, want):
            raise AssertionError(f"{op}: integer outputs differ")
        return 0.0
    g, w = got.float(), want.float()
    if not torch.equal(g.isnan(), w.isnan()):
        raise AssertionError(f"{op}: NaN positions differ")
    if not torch.equal(g.isinf(), w.isinf()) or \
            not torch.equal(g[g.isinf()], w[w.isinf()]):
        raise AssertionError(f"{op}: inf positions differ")
    fin = g.isfinite()
    err = (g[fin] - w[fin]).abs()
    max_err = float(err.max()) if err.numel() else 0.0
    if op in EXACT:
        if max_err != 0.0:
            raise AssertionError(f"{op}: not bitwise, max err {max_err}")
        return max_err
    dtype = str(got.dtype).replace("torch.", "")
    if op in LM_OPS:
        rtol = atol = LM_TOL[dtype]
    else:
        rtol, atol = (TOL if op in EW_OPS else MM_TOL)[dtype]
    bad = err > atol + rtol * w[fin].abs()
    if bool(bad.any()):
        raise AssertionError(f"{op}/{got.dtype}: {int(bad.sum())} entries "
                             f"beyond rtol {rtol} atol {atol}, max err "
                             f"{max_err}")
    return max_err


def time_ms(fn, flush, reps=25):
    """Median device time of ``fn`` in ms, from CUDA events around each
    call, after warm-up, with L2 flushed before each call.  After the
    flush the card spins for ~0.1 ms, so the host has enqueued the start
    event and the call before the card reaches them: the events time the
    device's work, not the host's Python around the launch."""
    import torch
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def spans_swapped():
    """Swap a ``record_function`` range named after each of ``SPANS``'s
    functions around it (nothing in the package changes); returns what
    to restore."""
    import importlib
    from torch.profiler import record_function
    saved = []
    for span, mod, attr in SPANS:
        m = importlib.import_module(mod)
        fn = getattr(m, attr)

        def ranged(*a, _fn=fn, _span=span, **k):
            with record_function(_span):
                return _fn(*a, **k)
        saved.append((m, attr, fn))
        setattr(m, attr, ranged)
    return saved


def profile_steps(run, steps):
    """Device time by kernel over ``run()`` under torch.profiler, per
    step: the kernels' names with their ms, the device-busy ms and the
    host-clock ms of a step (idle share = 1 - busy / wall), and the
    device ms of the kernels launched inside each of ``SPANS``.  Device
    times are None where the profiler saw no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    saved = spans_swapped()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    finally:
        for m, attr, fn in saved:
            setattr(m, attr, fn)
    by_kernel = {}
    gemm_ms = dict.fromkeys(GEMM_KERNELS, 0.0)
    decode_ms = 0.0
    spans = {span: None for span, _, _ in SPANS}
    for ev in prof.key_averages():
        if ev.key in spans:
            # the host range: the device time of the kernels launched in
            # it (its device-side annotation is no kernel).  The profiler
            # links torch's kernels to the range, not the port's own
            # (launched through ctypes): a span over flash reads nothing,
            # and stays None
            if not str(ev.device_type).endswith("CUDA"):
                us = getattr(ev, "device_time_total", None)
                if us is None:
                    us = getattr(ev, "cuda_time_total", 0)
                spans[ev.key] = (us / 1e3 / steps) or None
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if str(ev.device_type).endswith("CUDA") and us > 0:
            name = ev.key[:80]
            by_kernel[name] = by_kernel.get(name, 0.0) + us / 1e3 / steps
            for kind, parts in GEMM_KERNELS.items():
                if any(part in ev.key for part in parts):
                    gemm_ms[kind] += us / 1e3 / steps
            if any(part in ev.key for part in DECODE_KERNELS):
                decode_ms += us / 1e3 / steps
    busy = sum(by_kernel.values())
    return {"wall_ms_per_step": wall_ms,
            "device_busy_ms_per_step": busy or None,
            "idle_share": (1.0 - busy / wall_ms) if busy else None,
            "gemm_ms_per_step": {**gemm_ms, "all": sum(gemm_ms.values())},
            "decode_attention_ms_per_step": decode_ms,
            "spans_ms_per_step": spans,
            "kernels_ms_per_step": dict(sorted(by_kernel.items(),
                                               key=lambda kv: -kv[1])[:12])}


def serve_ops(cfg):
    """The ops an arch's serving path dispatches, from its layer kinds:
    gemm always; where a block attends, its MLP's activation (gelu
    through vtanh, silu through vsigmoid) and prefill attention, and
    decode attention unless the attention is MLA (its absorbed decode is
    plain products, as the reference's); ssd where a block is a Mamba2
    layer."""
    kinds = set(cfg.layer_pattern())
    ops_ = ["gemm"]
    if kinds & set(ATTN_KINDS):
        ops_ += [ACT_OP[cfg.act], "attention"]
        if cfg.attn_kind != "mla":
            ops_.append("decode_attention")
    if kinds & set(MAMBA_KINDS):
        ops_.append("ssd")
    return tuple(ops_)


def serve_tier(cfg, op):
    """The tier ``op`` must run on the arch's serving path under h100:
    its kernel, but MLA's attention, whose q/k head dim is not v's: the
    fused kernel does not take split dims, so it runs on the vector tier
    by the reference's own rule (``_attn_supports``,
    src/repro/kernels/ops.py:282-287; the port's kernels/ops.py mirrors
    it)."""
    return "vector" if op == "attention" and cfg.attn_kind == "mla" \
        else "pallas"


def serve_want(cfg, plen, steps):
    """Exact launches of the LM kernels in one ``Engine.generate`` of
    ``steps`` tokens after a ``plen``-token prompt: ssd's per Mamba2
    layer of the prefill (decode runs the recurrence in closed form), one
    flash launch per attending layer of the prefill and one decode launch
    per attending layer and later step; 0 where the arch has none, and
    both 0 for MLA (its attention runs no kernel, ``serve_tier``).  An
    encoder's layers add a flash launch each to the prefill, and a
    ``dec`` layer's cross-attention one flash launch to the prefill and
    to every later step (one query row against the frames: the
    reference runs it through ``ops.attention`` in every mode)."""
    from repro_torch.kernels import ssd as ssd_mod
    kinds = cfg.layer_pattern()
    n_ssd = sum(k in MAMBA_KINDS for k in kinds)
    n_attn = 0 if cfg.attn_kind == "mla" else \
        sum(k in ATTN_KINDS for k in kinds)
    n_cross = sum(k == "dec" for k in kinds)
    return {"ssd": n_ssd * ssd_mod.launches(plen),
            "flash_attention": n_attn + cfg.n_enc_layers + n_cross * steps,
            "decode_attention": n_attn * (steps - 1)}


def route_probe(moe_mod, pinned=None):
    """A stand-in for ``repro_torch.models.moe._route`` (swapped in from
    here; nothing in the package changes) and the list it fills: each
    call's router probabilities (float32) and its own top-k indices.
    Given ``pinned`` (another run's list), call i routes by the indices of
    pinned[i] instead, its gates renormalised from this run's own
    probabilities, so that two runs compare their continuous arithmetic
    alone."""
    import torch
    calls, route = [], moe_mod._route

    def probe(params, xt, cfg):
        gates, idx, aux = route(params, xt, cfg)
        probs = torch.softmax(xt.to(torch.float32) @ params["router"], -1)
        calls.append({"probs": probs, "idx": idx})
        if pinned is not None:
            idx = pinned[len(calls) - 1]["idx"]
            picked = probs.gather(1, idx)
            gates = picked / picked.sum(-1, keepdim=True)
        return gates, idx, aux
    return probe, calls


def layer_labels():
    """A function of a block call's (kind, ctx) that names its layer: the
    kind and the call's index among the calls made with the same ctx (one
    forward's decoder stack, or its encoder), e.g. ``mamba_shared.5`` or
    ``enc.2``."""
    seen = {"ctx": None, "j": 0}

    def label(kind, ctx):
        if ctx is not seen["ctx"]:
            seen["ctx"], seen["j"] = ctx, 0
        seen["j"] += 1
        return f"{kind}.{seen['j'] - 1}"
    return label


def block_probe(blocks_mod, pinned=None):
    """A stand-in for ``repro_torch.models.blocks.block_apply`` (swapped
    in from here) and the list it fills: each block call's input and
    output residual stream, its layer (``layer_labels``) and, for a
    ``dec`` block in prefill, the encoder output it reads.  Given
    ``pinned`` (another run's list), call i takes pinned[i]'s input, and
    its encoder output, in place of its own, so that each block of this
    run starts from the other run's residual stream and memory and the
    two runs differ by one block's arithmetic, not by the rounding of
    every block (or encoder) before it."""
    import dataclasses
    calls, apply, label = [], blocks_mod.block_apply, layer_labels()

    def probe(kind, params, x, cache, ctx):
        layer = label(kind, ctx)
        if pinned is not None:
            x = pinned[len(calls)]["x"]
            if pinned[len(calls)]["memory"] is not None:
                ctx = dataclasses.replace(
                    ctx, memory=pinned[len(calls)]["memory"])
        y, cache, aux = apply(kind, params, x, cache, ctx)
        calls.append({"x": x, "y": y, "layer": layer,
                      "memory": ctx.memory if kind == "dec" else None})
        return y, cache, aux
    return probe, calls


def rounding_step(y):
    """The spacing of y's dtype at each |y|: one rounding step of it."""
    import torch
    _, e = torch.frexp(y.float().abs())
    eps = torch.full(y.shape, torch.finfo(y.dtype).eps, device=y.device)
    return torch.ldexp(eps, e - 1)


def stream_gaps(kern, plain, rel_tol, what):
    """Each block's output, kernel against plain from the same input: by
    how much their difference exceeds one rounding step of the output
    (``rounding_step``, the larger of the two), over the kernel block's own
    update max |y - x|; raises where one exceeds rel_tol.  The update, not
    the output, is the scale: the residual stream it adds to would dilute
    an error in it, and a block's output cannot resolve less than its own
    rounding step."""
    import torch
    if len(kern) != len(plain):
        raise AssertionError(f"serve/{what}: {len(kern)} block calls "
                             f"against {len(plain)}")
    tiny = np.finfo(np.float32).tiny
    gaps = []
    for a, b in zip(kern, plain):
        ya, yb = a["y"].float(), b["y"].float()
        step = torch.maximum(rounding_step(a["y"]), rounding_step(b["y"]))
        over = ((ya - yb).abs() - step).clamp_min(0).max()
        gaps.append(float(over / (ya - a["x"].float()).abs().max()
                          .clamp_min(tiny)))
    worst = max(range(len(gaps)), key=gaps.__getitem__)
    if gaps[worst] > rel_tol:
        raise AssertionError(f"serve/{what}: block call {worst}'s output "
                             f"differs by {gaps[worst]} of its update's "
                             f"max, against {rel_tol}")
    return {"block_calls": len(gaps), "max_rel_block_err": gaps[worst],
            "worst_block_call": worst}


def route_flips(kern, plain, k, what):
    """Tokens whose top-k expert set differs between two runs' router
    calls.  Raises unless each flip falls where the smaller of the two
    runs' k-th/(k+1)-th probability margins is at most the token's
    router-probability gap between the runs: a flip trades an expert a
    of one run's top k for an expert b of the other's, and the two
    margins then sum to at most (p_a - p'_a) + (p'_b - p_b) <= 2 gap, so
    a rounding-sized gap is all that can flip a clear margin's
    order."""
    import torch
    if len(kern) != len(plain):
        raise AssertionError(f"serve/{what}: {len(kern)} router calls "
                             f"against {len(plain)}")
    n_flip, n_tok, gap_max, margins, worst = 0, 0, 0.0, [], 0.0
    for c, (a, b) in enumerate(zip(kern, plain)):
        pa, pb = a["probs"].double(), b["probs"].double()
        gap = (pa - pb).abs().amax(-1)
        sets = [torch.zeros_like(pa, dtype=torch.bool).scatter_(
            1, r["idx"].long(), True) for r in (a, b)]
        flipped = (sets[0] != sets[1]).any(-1)

        def margin(p):
            top = p.topk(k + 1, dim=-1).values
            return top[:, k - 1] - top[:, k]
        m = torch.minimum(margin(pa), margin(pb))
        if bool((flipped & (m > gap)).any()):
            raise AssertionError(f"serve/{what}: router call {c} flips an "
                                 "expert where the margin exceeds the "
                                 "router-probability gap")
        n_flip += int(flipped.sum())
        n_tok += pa.shape[0]
        gap_max = max(gap_max, float(gap.max()))
        margins += m[flipped].tolist()
        worst = max(worst, float((m[flipped] / gap[flipped]).max())
                    if bool(flipped.any()) else 0.0)
    return {"router_calls": len(kern), "tokens_routed": n_tok,
            "flips": n_flip, "max_router_prob_gap": gap_max,
            "flip_margins": sorted(margins)[:16],
            "max_flip_margin_over_gap": worst}


def teacher_logits(cfg, params, prompts, tokens, max_seq, dev, policy,
                   route=None, block=None, extra=None):
    """The logits of one teacher-forced run under ``policy``: the prompts
    prefilled (with ``extra``, the frames or patches), then ``tokens``
    (b, steps) fed one a step, each step's logits kept over the
    vocabulary (the padded rows hold -1e30 in every run, which would be
    every step's max |logit|); (steps, b, vocab) in float32.  An MoE's
    router calls go through ``route`` and the blocks through ``block``
    where one is given (``route_probe``, ``block_probe``), swapped in for
    the run and restored after it."""
    import torch
    from repro_torch.core import use_policy
    from repro_torch.models import blocks as blocks_mod
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod
    from repro_torch.serve.engine import make_prefill_step, make_serve_step

    package = (moe_mod._route, blocks_mod.block_apply)
    (b, plen), steps = prompts.shape, tokens.shape[1]
    vocab = cfg.vocab_size
    with use_policy(policy):
        moe_mod._route = route or package[0]
        blocks_mod.block_apply = block or package[1]
        try:
            prefill = make_prefill_step(cfg)
            step = make_serve_step(cfg)
            p_off = cfg.n_patches if cfg.family == "vlm" else 0
            cache = M.init_cache(cfg, b, max_seq + p_off, dev)
            lg, cache = prefill(params, cache, {
                "tokens": torch.as_tensor(prompts, device=dev),
                **(extra or {})})
            out = [lg[:, :vocab].float()]
            lens = torch.full((b,), plen + p_off, dtype=torch.int32,
                              device=dev)
            tok = torch.as_tensor(tokens, device=dev).long()
            for i in range(steps - 1):
                lg, cache = step(params, cache, tok[:, i:i + 1], lens)
                lens = lens + 1
                out.append(lg[:, :vocab].float())
        finally:
            moe_mod._route, blocks_mod.block_apply = package
    return torch.stack(out)


def held_logits(kern, plain, rel_tol, what, gate=True):
    """Per-step max |kernel - plain| logit, max |logit|, and the greedy
    tokens' agreement; raises unless every step is within rel_tol of its
    max |logit| (with ``gate``; without it that reading is returned, not
    held) and the tokens agree wherever the plain run's top-2 gap exceeds
    that."""
    if not bool(kern.isfinite().all()) or not bool(plain.isfinite().all()):
        raise AssertionError(f"serve/{what}: non-finite logits")
    err = (kern - plain).abs().amax(dim=(1, 2))
    scale = kern.abs().amax(dim=(1, 2))
    tol = rel_tol * scale
    if gate and bool((err > tol).any()):
        raise AssertionError(f"serve/{what}: logits differ from the vector "
                             f"tier's by {err.tolist()} against "
                             f"{tol.tolist()}")
    top2 = plain.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > tol[:, None]
    agree = kern.argmax(-1) == plain.argmax(-1)
    if bool((clear & ~agree).any()):
        raise AssertionError(f"serve/{what}: greedy tokens differ where the "
                             "plain run's top-2 gap exceeds the tolerance")
    return {"max_logit_err": err.tolist(), "max_abs_logit": scale.tolist(),
            "max_rel_logit_err": float((err / scale).max()),
            "greedy_agree": float(agree.float().mean()),
            "clear_steps": int(clear.sum())}


def faulty(apply, layer, how):
    """block_apply with a fault in ``layer`` (a ``layer_labels`` label) of
    every forward: its update scaled by FAULT_SCALE (``how`` "scale") or
    cut to FAULT_MANTISSA bits of mantissa."""
    import torch
    label = layer_labels()

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


def middle_layer(cfg):
    """The ``layer_labels`` label of the middle layer of cfg's decoder
    stack."""
    kinds = cfg.layer_pattern()
    return f"{kinds[len(kinds) // 2]}.{len(kinds) // 2}"


def planted_controls(run, layer, plain=None):
    """The controls of a ``BLOCK_GATED`` arch on ``run`` (``teacher_logits``
    of its model, prompts and first tokens, but the policy, router and
    blocks): for each fault of SERVE_CONTROLS planted in ``layer``
    (``faulty``), the kernel run with it, each vector block fed that run's
    block input, read by ``stream_gaps``; given ``plain`` (the vector run's
    logits over every step), the scaled fault's kernel run against its
    first steps, read by ``held_logits``.  Raises where a reading is
    within its gate (E2E_TOL per block; E2E_F32_TOL whole): the gate
    would miss the fault.  -> {fault: its reading and gate}."""
    from repro_torch.models import blocks as blocks_mod
    out = {}
    for how in SERVE_CONTROLS if plain is None else ("scale",):
        apply = blocks_mod.block_apply
        if plain is None:
            blocks_mod.block_apply = faulty(apply, layer, how)
            try:
                block, kblocks = block_probe(blocks_mod)
            finally:
                blocks_mod.block_apply = apply
            run("pallas", None, block)
            pin, vblocks = block_probe(blocks_mod, pinned=kblocks)
            run("vector", None, pin)
            gate, reading = E2E_TOL, stream_gaps(
                kblocks, vblocks, math.inf, how)["max_rel_block_err"]
            del kblocks, vblocks
        else:
            kern = run("pallas", None, faulty(apply, layer, how))
            gate, reading = E2E_F32_TOL, held_logits(
                kern, plain[:len(kern)], math.inf, how)["max_rel_logit_err"]
        if not reading > gate:
            raise AssertionError(f"serve/control: the {how} fault in {layer} "
                                 f"reads {reading}, within the gate {gate}")
        out[how] = {"layer": layer, "reading": reading, "gate": gate}
    return out


def warm_run(cfg, params, prompts, max_seq, dev, steps=SERVE["gen"],
             extra=None):
    """A second Engine over the same prompts (and ``extra``; its
    selections cached): a prefill and ``steps`` - 1 decode steps timed
    apart on the host clock, gemm's launches counted by variant in each,
    then a prefill and two decode steps under the profiler
    (``profile_steps``).  Returns the times, counts and profiles, and the
    tokens it generated."""
    import torch
    from repro_torch.kernels import gemm as gemm_mod
    from repro_torch.serve.engine import Engine

    def gemm_counts():
        return {k: v for k, v in gemm_mod.LAUNCHES.items() if k != "gemm"}

    b = prompts.shape[0]
    eng = Engine(cfg, params, b, max_seq, device=dev)
    torch.cuda.synchronize()
    gemm_mod.reset_launches()
    t0 = time.perf_counter()
    first = eng.prefill(prompts, extra)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_gemm = gemm_counts()
    gemm_mod.reset_launches()
    t0 = time.perf_counter()
    rest = eng.decode(first, steps - 1)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    decode_gemm = gemm_counts()
    eng.lengths = eng.lengths - 2           # rewrite the last two positions
    eng.position -= 2
    again = torch.as_tensor(rest[:, -3], device=dev)
    return {"prefill_ms": prefill_s * 1e3,
            "decode_ms_per_step": decode_s / (steps - 1) * 1e3,
            "tokens_per_s": b * steps / (prefill_s + decode_s),
            "gemm_launches": {"prefill": prefill_gemm,
                              "decode": decode_gemm},
            "decode_profile": profile_steps(lambda: eng.decode(again, 2), 2),
            "prefill_profile": profile_steps(
            lambda: eng.prefill(prompts, extra), 1),
            "tokens": np.concatenate([first.cpu().numpy()[:, None], rest],
                                     axis=1)}


def serve_arch(dev, modules, arch, traffic=SERVE, phase="serve"):
    """Drive ``arch`` serving at full width (and ``SERVE_DEPTH``'s depth,
    or ``traffic["layers"]``) through the port's
    Engine under the default target (h100) and policy, ``traffic``'s
    requests (whisper's with stub frames, pixtral's with stub patches:
    ``extra_inputs``), count the kernel launches of that run, time
    prefill and decode, and hold its logits against the vector tier's
    (teacher forced) over the whole model, in bf16 and in float32 (an
    MoE's vector run routed by the kernel run's indices, its flips
    counted); in bf16 also each block's output, the vector block started
    from the kernel run's input.  A ``BLOCK_GATED`` arch's bf16 gate is
    that per-block check, its whole-model reading printed, and its
    planted controls (``planted_controls``) must fail in both dtypes.
    Emits and returns the ``phase`` record."""
    import torch
    from repro_torch.kernels import cost
    from repro_torch.configs import get_config
    from repro_torch.core import trace
    from repro_torch.core.registry import REGISTRY
    from repro_torch.data.pipeline import extra_inputs
    from repro_torch.models import blocks as blocks_mod
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod
    from repro_torch.serve.engine import Engine

    started = time.perf_counter()
    cfg = get_config(arch)
    if arch in SERVE_DEPTH:
        cfg = cfg.replace(n_layers=SERVE_DEPTH[arch])
    if "layers" in traffic:
        cfg = cfg.replace(n_layers=traffic["layers"])
    block_gated = arch in BLOCK_GATED
    b, plen, steps = traffic["batch"], traffic["prompt"], traffic["gen"]
    max_seq = plen + steps
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    params = M.init(cfg, gen, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = np.random.default_rng(SEED).integers(2, cfg.vocab_size,
                                                   (b, plen))
    extra = extra_inputs(cfg, b, SEED, dev)
    ops_ = serve_ops(cfg)
    act = [op for op in ops_ if op in EW_OPS]
    want = serve_want(cfg, plen, steps)

    def tiers(counted):
        return {op: sorted({t for (o, t) in counted["per_op"] if o == op})
                for op in ops_}

    def gated(launched, chosen, what):
        want_tiers = {op: [serve_tier(cfg, op)] for op in ops_}
        if chosen != want_tiers:
            raise AssertionError(f"serve/{what}: h100 picked {chosen}; "
                                 "every op of the path must run its kernel "
                                 "tier, but MLA's split-dim attention, "
                                 "which the reference's rule leaves to the "
                                 f"vector tier: {want_tiers}")
        for op, n in want.items():
            if launched[op] != n:
                raise AssertionError(f"serve/{what}: {launched[op]} {op} "
                                     f"launches, expected {n}")
        for op in ["gemm"] + act:
            if launched[op] == 0:
                raise AssertionError(f"serve/{what}: {op} never launched")

    # the main path: counts set to 0, one Engine.generate, counts read
    for m in modules:
        m.reset_launches()
    with trace.count() as counted:
        eng = Engine(cfg, params, b, max_seq)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tokens = eng.generate(prompts, steps, extra)
        torch.cuda.synchronize()
        generate_s = time.perf_counter() - t0
    launches = {k: v for m in modules for k, v in m.LAUNCHES.items()}
    chosen = tiers(counted)
    emit("serve_tiers", arch=arch, traffic=phase, target="h100",
         policy=REGISTRY.policy, dtype=cfg.dtype, chosen=chosen)
    gated(launches, chosen, cfg.dtype)
    if tokens.shape != (b, steps) or not ((tokens >= 0) &
                                          (tokens < cfg.vocab_size)).all():
        raise AssertionError(f"serve: tokens {tokens.shape} out of range")

    warm = warm_run(cfg, params, prompts, max_seq, dev, steps, extra)
    prefill_gemm, decode_gemm = warm["gemm_launches"].values()
    if prefill_gemm["gemm_mma"] == 0 or decode_gemm["gemm_small_m"] == 0 \
            or decode_gemm["gemm_mma"] != 0:
        raise AssertionError(f"serve: gemm variants prefill {prefill_gemm}, "
                             f"decode {decode_gemm}; expected wgmma in "
                             "prefill and split-K alone in decode")
    if not np.array_equal(warm.pop("tokens"), tokens):
        raise AssertionError("serve: a second run gave other tokens")

    # teacher forced: the kernel run's tokens into both runs
    def checked(cfg_, params_, rel_tol, what, blocks, whole=True):
        """The kernel run (its launches and tiers counted), then the
        vector run held to it over the whole model (``held_logits``, its
        reading gated with ``whole``); an MoE's vector run routes by the
        kernel run's indices, and ``route_flips`` counts where its own
        router would differ.  With ``blocks`` a third run starts each
        vector block from the kernel run's input and holds every block's
        output (``stream_gaps``).  -> (the kernel and vector runs' logits,
        launches, tiers, readings)."""
        for m in modules:
            m.reset_launches()
        route = calls = block = kblocks = None
        if cfg_.n_experts:
            route, calls = route_probe(moe_mod)
        if blocks:
            block, kblocks = block_probe(blocks_mod)
        run = functools.partial(teacher_logits, cfg_, params_, prompts,
                                tokens, max_seq, dev, extra=extra)
        with trace.count() as counted_:
            kern = run("pallas", route, block)
        launched = {k: v for m in modules for k, v in m.LAUNCHES.items()}

        def pinned_route():
            return route_probe(moe_mod, pinned=calls) if cfg_.n_experts \
                else (None, None)
        pin, pinned_calls = pinned_route()
        plain = run("vector", pin)
        out = held_logits(kern, plain, rel_tol, what, gate=whole)
        if cfg_.n_experts:
            out["routing"] = {"pinned": True, **route_flips(
                calls, pinned_calls, cfg_.top_k, what)}
        if blocks:
            pin_block, vblocks = block_probe(blocks_mod, pinned=kblocks)
            run("vector", pinned_route()[0], pin_block)
            out["blocks"] = stream_gaps(kblocks, vblocks, rel_tol, what)
        return kern, plain, launched, tiers(counted_), out

    kern, plain, _, _, bf16_check = checked(
        cfg, params, E2E_TOL, cfg.dtype, blocks=True, whole=not block_gated)
    if not torch.equal(kern.argmax(-1).cpu(),
                       torch.as_tensor(tokens).long().T):
        raise AssertionError("serve: the teacher-forced kernel run does "
                             "not reproduce its own greedy tokens")
    del plain

    def controls(cfg_, params_, plain=None):
        """``planted_controls`` of this arch's model over the prompts and
        the first CONTROL_STEPS tokens, with its seconds."""
        t0 = time.perf_counter()
        out = planted_controls(functools.partial(
            teacher_logits, cfg_, params_, prompts,
            tokens[:, :CONTROL_STEPS], max_seq, dev, extra=extra),
            middle_layer(cfg_), plain)
        return {**out, "steps": CONTROL_STEPS,
                "seconds": time.perf_counter() - t0}
    record = {
        "arch": cfg.name, "traffic": phase, "params": M.count_params(params),
        "dtype": cfg.dtype, "layers": cfg.n_layers,
        "full_layers": get_config(arch).n_layers, "d_model": cfg.d_model,
        "batch": b, "prompt_len": plen, "generated": steps,
        "target": "h100", "chosen": chosen, "ops": list(ops_),
        "launches": launches, "expected_launches": want,
        "init_s": init_s, "generate_s": generate_s, **warm,
        "bf16_gate": "blocks" if block_gated else "whole_model",
        **bf16_check, "first_tokens": tokens[0].tolist()}
    if block_gated:
        record["controls"] = controls(cfg, params)
    record["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if cfg.n_experts:
        # a decode step reads every routed expert's weights (the dense
        # (E, C, d) buffer) in each MoE layer: their bytes at the HBM rate
        n_moe = sum(k == "moe" for k in cfg.layer_pattern())
        expert_bytes = n_moe * 3 * cfg.n_experts * cfg.d_model * \
            cfg.d_expert * params["unit"][0][0]["ffn"]["we_g"].element_size()
        record["expert_weight_floor_ms"] = \
            expert_bytes / cost.HBM_BYTES_PER_S * 1e3
        record["moe_capacity"] = {"prefill": moe_mod.capacity(cfg, b * plen),
                                  "decode": moe_mod.capacity(cfg, b)}
    # the bf16 model leaves the card before the float32 one is drawn
    # (deepseek's float32 weights alone take ~63 GB)
    del kern, eng, params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # the same model in float32 (weights drawn anew from the seed), the
    # same prompts and tokens: the kernels against the vector tier with no
    # bf16 rounding between them, the kernel run under the default target
    # as the bf16 one; its launches and tiers are counted to show that the
    # kernels carried it
    cfg32 = cfg.replace(dtype="float32")
    gen.manual_seed(SEED)
    params32 = M.init(cfg32, gen, dev)
    kern, plain, launches32, chosen32, f32_held = checked(
        cfg32, params32, E2E_F32_TOL, "float32", blocks=False)
    emit("serve_tiers", arch=arch, traffic=phase, target="h100",
         policy="pallas", dtype="float32", chosen=chosen32)
    gated(launches32, chosen32, "float32")
    if launches32["gemm_simt"] == 0:
        raise AssertionError("serve/float32: gemm_simt never launched")
    record["float32"] = {"launches": launches32, "chosen": chosen32,
                         **f32_held}
    if block_gated:
        record["float32"]["controls"] = controls(cfg32, params32, plain)
    record["float32"]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params32, kern, plain
    record["seconds"] = time.perf_counter() - started
    emit(phase, **record)
    torch.cuda.empty_cache()
    return record


def time_figure2(ops, module, args, gen, dev, flush, plans):
    """Time the Figure-2 kernels ``ops`` other than the elementwise four at
    the Figure-2 size (``args``) and the large one (``big_args``), in each
    dtype of NEW_DTYPES; emit each row, after its launch plan where
    ``plans``, and return the rows by (op, size, with "_bf16" in bf16)."""
    import torch
    rows = {}
    for op in ops:
        for size, size_args in (("figure2", args[op]),
                                ("large", big_args(op, gen, dev))):
            if plans and op == "gemm":
                (m, k), n = size_args[0].shape, size_args[1].shape[1]
                emit_simt_plan(size, m, n, k)
            for dt in map(lambda name: getattr(torch, name),
                          NEW_DTYPES[op]):
                targs = on(size_args, dev, dt,
                           keep=(3, 4) if op == "ibilinear" else ())
                if plans and op != "gemm":
                    emit_plan(size, op, targs)
                row = time_new(op, module[op], size, targs, flush)
                rows[(op, size if dt == torch.float32
                      else f"{size}_bf16")] = row
                emit("time", **row)
                del targs
            del size_args
    return rows


# -- the NEON frontend: the isa ops and the corpus ----------------------------

INTS = ("int8", "int16", "int32", "uint8", "uint16", "uint32")
FLOATS = ("float16", "float32")
ALL = INTS + FLOATS
# (narrow, wide) lane pairs of the width-changing families
WIDEN = (("int8", "int16"), ("int16", "int32"), ("uint8", "uint16"),
         ("uint16", "uint32"))
# The card against the CPU, float lanes: bitwise but for these ops, whose
# result may round differently on the card (ULP of the lane type): rsqrt
# is not a division there, and the reductions sum in another order
CARD_ULP = {"vrsqrte": 2, "vaddv": 2, "vfold": 2}
# benchmarks/port_suite.py's wall-clock geometry
WALL_N, WALL_TAIL_N = 2048, 2051
PORT_TARGETS = ("h100", "rvv-128")


class DT(str):
    """A dtype argument (``vcvt(a, DT("int32"))``)."""


def _ints(rng, dt, n):
    info = np.iinfo(dt)
    edge = np.array([info.min, info.max, 0, 1, info.max - 1,
                     info.min + 1, info.max // 2 + 1], dtype=dt)
    vals = rng.integers(info.min, int(info.max) + 1, n, dtype=dt)
    vals[:min(n, len(edge))] = edge[:min(n, len(edge))]
    return rng.permutation(vals)


def _floats(rng, dt, n, edges=True, lo=-4.0, hi=4.0):
    vals = rng.uniform(lo, hi, n).astype(dt)
    if edges:
        edge = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-3],
                        dtype=dt)
        vals[:min(n, len(edge))] = edge[:min(n, len(edge))]
    return rng.permutation(vals)


def _vec(rng, dt, n, **kw):
    if np.issubdtype(np.dtype(dt), np.integer):
        return _ints(rng, dt, n)
    return _floats(rng, dt, n, **kw)


def _lanes(dt):
    return 16 // np.dtype(dt).itemsize


def isa_cases(op):  # noqa: C901 — one table of every op's inputs
    """(label, args) pairs of numpy inputs for the isa op ``op``: every
    NEON lane dtype it takes below 64 bits, wraparound and saturation
    edges, NaN and +-inf for the float ops, offsets out of range for the
    memory ops."""
    rng = np.random.default_rng(zlib.crc32(op.encode()))
    out = []

    def add(label, *args):
        out.append((label, args))

    if op in ("vadd", "vsub", "vmul", "vmax", "vmin", "vqadd", "vqsub",
              "vceq", "vcgt", "vcge", "vclt", "vcle", "vpadd", "vzip",
              "vcombine"):
        for dt in ALL:
            n = _lanes(dt)
            add(dt, _vec(rng, dt, n), _vec(rng, dt, n))
            if op in ("vmax", "vmin") and dt in FLOATS:
                add(f"{dt}-zeros", np.array([0.0, -0.0, 0.0, -0.0], dt),
                    np.array([-0.0, 0.0, 0.0, -0.0], dt))
            if op in ("vqadd", "vqsub", "vadd", "vsub") and dt in INTS:
                info = np.iinfo(dt)
                a = np.array([info.max] * 2 + [info.min] * 2 + [0, 1],
                             dtype=dt)
                b = np.array([1, info.max, 1, info.max, info.max,
                              info.max], dtype=dt)
                add(f"{dt}-sat", a, b)
    elif op in ("vand", "vorr", "veor"):
        for dt in INTS:
            add(dt, _ints(rng, dt, _lanes(dt)), _ints(rng, dt, _lanes(dt)))
    elif op in ("vabs", "vneg", "vget_high", "vget_low", "vrev64",
                "vaddv", "vmaxv", "vminv"):
        for dt in ALL:
            edges = op not in ("vaddv",) or dt in INTS
            add(dt, _vec(rng, dt, _lanes(dt), edges=edges))
        if op in ("vmaxv", "vminv", "vaddv"):
            add("float32x2", _floats(rng, "float32", 2, edges=False))
        if op in ("vmaxv", "vminv"):
            for dt in FLOATS:
                for z in ([-0.0, 0.0, -1.0, -2.0], [0.0, -0.0, 1.0, 2.0],
                          [-0.0, -0.0, -1.0, -3.0], [0.0, 0.0, 1.0, 3.0]):
                    add(f"{dt}-zeros", np.array(z, dt))
    elif op in ("vshl_n", "vshr_n"):
        for dt in INTS:
            w = np.dtype(dt).itemsize * 8
            for n in (0, 1, w - 1, w, w + 3):
                add(f"{dt}<<{n}", _ints(rng, dt, _lanes(dt)), n)
    elif op == "vbsl":
        for dt in ALL:
            n = _lanes(dt)
            u = f"uint{np.dtype(dt).itemsize * 8}"
            mask = rng.choice(np.array([0, np.iinfo(u).max, 1], u), n)
            add(dt, mask, _vec(rng, dt, n), _vec(rng, dt, n))
    elif op in ("vmla", "vmls"):
        for dt in ALL:
            n = _lanes(dt)
            add(dt, *(_vec(rng, dt, n, edges=False) for _ in range(3)))
    elif op == "vfma":
        for dt in FLOATS:
            n = _lanes(dt)
            add(dt, *(_vec(rng, dt, n, edges=False) for _ in range(3)))
            add(f"{dt}-bcast", _vec(rng, dt, n, edges=False),
                _vec(rng, dt, 1, edges=False), _vec(rng, dt, n, edges=False))
    elif op == "vext":
        for dt in ALL:
            n = _lanes(dt)
            for k in (0, 1, n - 1):
                add(f"{dt}:{k}", _vec(rng, dt, n), _vec(rng, dt, n), k)
    elif op == "vrbit":
        for dt in ("uint8", "int8", "int16", "uint16"):
            add(dt, _ints(rng, dt, 16))
    elif op == "vdup":
        for dt in ALL:
            x = _vec(rng, dt, 1)[0]
            add(dt, np.dtype(dt).type(x), (_lanes(dt),))
    elif op in ("vrecpe", "vrsqrte"):
        for dt in FLOATS:
            add(dt, _floats(rng, dt, 16, lo=-9.0, hi=9.0))
            add(f"{dt}-pos", _floats(rng, dt, 16, edges=False, lo=1e-3,
                                     hi=9.0))
    elif op in ("vrecps", "vrsqrts"):
        for dt in FLOATS:
            add(dt, _floats(rng, dt, 8), _floats(rng, dt, 8))
    elif op == "vcvt":
        wild = np.array([np.nan, np.inf, -np.inf, 3e9, -3e9, 2147483520.0,
                         2147483648.0, -2.7, 2.7, 70000.0, -70000.0, 255.5,
                         -128.9, 0.0, -0.0, 1e-30], np.float32)
        for dt in INTS:
            add(f"float32->{dt}", wild, DT(dt))
            with np.errstate(over="ignore"):
                add(f"float16->{dt}", wild.astype(np.float16), DT(dt))
            add(f"{dt}->float32", _ints(rng, dt, 8), DT("float32"))
        add("float32->float16", _floats(rng, "float32", 8), DT("float16"))
        add("float16->float32", _floats(rng, "float16", 8), DT("float32"))
        add("int32->int16", _ints(rng, "int32", 8), DT("int16"))
    elif op == "vtbl":
        for dt in ALL:
            table = _vec(rng, dt, 8)
            add(f"{dt}[u8]", table, np.array([0, 7, 8, 200, 255, 3, 1, 6],
                                             np.uint8))
            add(f"{dt}[s8]", table, np.array([0, -1, -8, -9, 8, 100, -128,
                                              5], np.int8))
    elif op == "vreinterpret":
        for src in ALL:
            for dst in ("int8", "uint16", "uint32", "float16", "float32"):
                if src != dst:
                    add(f"{src}->{dst}", _vec(rng, src, _lanes(src)),
                        DT(dst))
    elif op in ("vmull", "vaddl", "vsubl"):
        for nar, wide in WIDEN:
            add(f"{nar}->{wide}", _ints(rng, nar, 8), _ints(rng, nar, 8),
                DT(wide))
    elif op in ("vmlal", "vmlsl"):
        for nar, wide in WIDEN:
            add(f"{nar}->{wide}", _ints(rng, wide, 8), _ints(rng, nar, 8),
                _ints(rng, nar, 8), DT(wide))
    elif op == "vmovl":
        for nar, wide in WIDEN:
            add(f"{nar}->{wide}", _ints(rng, nar, 8), DT(wide))
    elif op in ("vmovn", "vqmovn"):
        for nar, wide in WIDEN:
            add(f"{wide}->{nar}", _ints(rng, wide, 8), DT(nar))
    elif op == "vqmovun":
        for src, dst in (("int16", "uint8"), ("int32", "uint16")):
            add(f"{src}->{dst}", _ints(rng, src, 8), DT(dst))
    elif op == "vtile":
        for dt in ALL:
            for reps in (1, 3):
                add(f"{dt}x{reps}", _vec(rng, dt, 4), reps)
    elif op == "vfold":
        for dt in ALL:
            for factor in (2, 4):
                add(f"{dt}/{factor}", _vec(rng, dt, 16, edges=dt in INTS),
                    factor)
    else:
        out.extend(_isa_memory_cases(op, rng))
    assert out, op
    return out


# offsets around both ends of a 16-element buffer, including the ones
# that wrap once (-1 .. -16) and the ones that wrap and still fall out;
# lane types of each width, signed, unsigned and float
_OFFSETS = (0, 13, 20, -3, -20)
MEM = ("int8", "uint16", "uint32", "float32")


def _isa_memory_cases(op, rng):
    out = []
    base = op.rstrip("m") if op not in ("vld1gm",) else "vld1g"
    masked = op.endswith("m")
    for dt in MEM:
        buf = _vec(rng, dt, 16)
        for off in _OFFSETS:
            o = np.int64(off)
            if base == "vld1":
                for lanes in (4, 20):
                    if masked:
                        out.append((f"{dt}@{off}/{lanes}", (buf, o, lanes,
                                                           np.int64(3), 0)))
                    else:
                        out.append((f"{dt}@{off}/{lanes}", (buf, o, lanes)))
            elif base == "vst1":
                for m in (4, 20):
                    val = _vec(rng, dt, m)
                    if masked:
                        out.append((f"{dt}@{off}/{m}", (buf, o, val,
                                                       np.int64(3))))
                    else:
                        out.append((f"{dt}@{off}/{m}", (buf, o, val)))
            elif base == "vld1g":
                extra = (np.int64(2), 0) if masked else ()
                out.append((f"{dt}@{off}", (buf, o, 4, 3) + extra))
            elif base.startswith("vld"):
                k = int(base[3])
                for lanes in (2, 8):
                    extra = (np.int64(1), 0) if masked else ()
                    out.append((f"{dt}@{off}/{lanes}",
                                (buf, o, lanes) + extra))
            elif base.startswith("vst"):
                k = int(base[3])
                for lanes in (2, 8):
                    vs = tuple(_vec(rng, dt, lanes) for _ in range(k))
                    extra = (np.int64(1),) if masked else ()
                    out.append((f"{dt}@{off}/{lanes}",
                                (buf, o) + vs + extra))
    return out




def isa_args(op, args, dev):
    """A case's numpy arguments as the port takes them on ``dev``: arrays
    as tensors, dtype names as torch dtypes, vdup's scalar as a 0-d
    tensor (offsets and counts stay host integers)."""
    import torch
    from repro_torch.core import isa
    from repro_torch.core.vtypes import torch_dtype
    out = []
    for i, a in enumerate(args):
        if isinstance(a, DT):
            a = torch_dtype(str(a))
        elif isinstance(a, np.ndarray):
            a = torch.from_numpy(a.copy()).to(dev)
        elif op == "vdup" and i == 0:
            a = isa.lane_scalar(a.item(), a.dtype, dev)
        out.append(a)
    return out


def ulp_gap(got, want):
    """Largest gap in units in the last place between two float arrays of
    one dtype: 0 only where they agree bitwise (-0.0 is one ULP from 0.0),
    NaN lanes must sit at the same places."""
    if not np.array_equal(np.isnan(got), np.isnan(want)):
        return float("inf")
    keep = ~np.isnan(want)
    width = {2: np.int16, 4: np.int32}[want.dtype.itemsize]
    top = np.int64(np.iinfo(width).max)

    def ordered(x):
        i = np.ascontiguousarray(x[keep]).view(width).astype(np.int64)
        return np.where(i < 0, -(i & top) - 1, i)

    gap = np.abs(ordered(got) - ordered(want))
    return int(gap.max()) if gap.size else 0


def isa_phase(dev):
    """Every op of ``isa.__all__`` in each of its tiers, on the card and
    then on the CPU, on the same numpy-made inputs: integers bitwise,
    floats bitwise but for CARD_ULP's ops; each output on the card."""
    import torch
    from repro_torch.core import isa
    from repro_torch.core.registry import REGISTRY
    rows, n_cases = {}, 0
    for op in isa.__all__:
        gap, cases = 0, 0
        for tier in REGISTRY.tiers_of(op):
            fn = REGISTRY.lowering(op, tier).fn
            for label, args in isa_cases(op):
                card = fn(*isa_args(op, args, dev))
                host = fn(*isa_args(op, args, "cpu"))
                card = card if isinstance(card, tuple) else (card,)
                host = host if isinstance(host, tuple) else (host,)
                where = f"isa {op}/{tier}/{label}"
                for c, h in zip(card, host, strict=True):
                    if c.device.type != "cuda":
                        raise AssertionError(f"{where}: output on {c.device}")
                    g, w = c.cpu().numpy(), h.numpy()
                    if g.shape != w.shape or g.dtype != w.dtype:
                        raise AssertionError(f"{where}: {g.shape}/{g.dtype} "
                                             f"against {w.shape}/{w.dtype}")
                    if np.issubdtype(w.dtype, np.floating):
                        d = ulp_gap(g.reshape(-1), w.reshape(-1))
                        if d > CARD_ULP.get(op, 0):
                            raise AssertionError(f"{where}: {d} ulp from "
                                                 "the CPU")
                        gap = max(gap, d)
                    elif not np.array_equal(g, w):
                        raise AssertionError(f"{where}: differs from the "
                                             "CPU bitwise")
                cases += 1
        rows[op] = {"tiers": REGISTRY.tiers_of(op), "cases": cases,
                    "max_ulp": gap}
        n_cases += cases
    torch.cuda.synchronize()
    emit("isa", ops=len(rows), cases=n_cases, card_ulp_allowed=CARD_ULP,
         rows=rows)
    return rows


def strip_step(fn):
    """The step of a ported kernel's first strip loop, matched as the
    reference's re-vectorizer matches them (top-level loops first, then
    nested ones): a loop whose counter ``n`` steps down by a constant
    ``k`` under ``n >= k`` (k > 1) or ``n != 0``, with a vector intrinsic
    in its body.  8 where there is none."""
    from repro_torch.port.ir import IfOp, Loop

    def consts(block):
        return {ins.result: ins.attrs["value"] for ins in block.instrs
                if ins.op == "const"}

    def has_vector(block):
        for ins in block.instrs:
            if ins.op == "intrin":
                return True
            if isinstance(ins, Loop) and has_vector(ins.body):
                return True
            if isinstance(ins, IfOp) and (has_vector(ins.then)
                                          or has_vector(ins.els)):
                return True
        return False

    def match(loop):
        cmp_ = [i for i in loop.cond.instrs if i.result is loop.cond_value
                and i.op == "scmp"]
        if not cmp_ or not has_vector(loop.body):
            return None
        phi, bound = cmp_[0].args
        bound = consts(loop.cond).get(bound)
        if phi not in loop.phis or bound is None:
            return None
        y = loop.yields[loop.phis.index(phi)]
        body = consts(loop.body)
        dec = [i for i in loop.body.instrs if i.result is y
               and i.op == "sbin" and i.attrs["op"] == "-"
               and i.args[0] is phi and i.args[1] in body]
        if not dec:
            return None
        k = body[dec[0].args[1]]
        op = cmp_[0].attrs["op"]
        if (op == ">=" and bound == k and k > 1) or \
                (op == "!=" and bound == 0 and k >= 1):
            return k
        return None

    level = [fn.body]
    while level:
        nxt = []
        for block in level:
            for ins in block.instrs:
                if isinstance(ins, Loop):
                    k = match(ins)
                    if k is not None:
                        return k
                    nxt.append(ins.body)
                elif isinstance(ins, IfOp):
                    nxt += [ins.then, ins.els]
        level = nxt
    return 8


def conform_ulp(got, want, case):
    """tests/test_port_conformance.py's gate (:53-55, _assert_conforms):
    integers bitwise; floats within max(4, 2 rtol / eps) ULP, or within
    max(atol, 1e-6) absolute.  Returns the largest float ULP gap."""
    eps = float(np.finfo(np.float32).eps)
    budget = max(4, int(2 * case.rtol / eps))
    worst = 0
    for g, w in zip(got, want, strict=True):
        g, w = np.asarray(g), np.asarray(w)
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{case.kernel}: {g.shape}/{g.dtype} "
                                 f"against {w.shape}/{w.dtype}")
        if np.issubdtype(w.dtype, np.integer):
            if not np.array_equal(g, w):
                raise AssertionError(f"{case.kernel}: not bitwise")
            continue
        i = g.astype(np.float32).view(np.int32).astype(np.int64)
        j = w.astype(np.float32).view(np.int32).astype(np.int64)
        ulp = np.abs(np.where(i < 0, -(i & 0x7FFFFFFF), i)
                     - np.where(j < 0, -(j & 0x7FFFFFFF), j))
        close = np.abs(g.astype(np.float64) - w.astype(np.float64)) \
            <= max(case.atol, 1e-6)
        if not bool(np.all((ulp <= budget) | close)):
            raise AssertionError(f"{case.kernel}: {int(ulp.max())} ulp "
                                 f"(budget {budget})")
        worst = max(worst, int(ulp.max()) if ulp.size else 0)
    return worst


def run_ported(kernel, case, args, target, dev):
    """One call of a ported corpus kernel on the card, held to the
    harness's NumPy reference: its host-clock ms, dispatches, host reads,
    the tiers its ops took, and the counted instructions."""
    import torch
    from repro_torch import port
    from repro_torch.core import trace
    from repro_torch.core.registry import REGISTRY
    m = port.Machine(kernel.fn, policy="pallas", target=target, device=dev)
    before = REGISTRY.cache_info()["lookups"]
    with trace.count() as counted:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = m.run(*args)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    outs = out if isinstance(out, tuple) else (out,)
    for t in outs:
        if t.device.type != "cuda":
            raise AssertionError(f"{case.kernel}: output on {t.device}")
    want = case.reference(*args)
    ulp = conform_ulp([t.cpu().numpy() for t in outs],
                      want if isinstance(want, tuple) else (want,), case)
    return {"ms": ms, "dispatches": REGISTRY.cache_info()["lookups"] - before,
            "host_reads": m.host_reads, "instrs": counted["total"],
            "tiers": sorted({f"{op}:{tier}"
                             for op, tier in counted["per_op"]}),
            "max_ulp": ulp}


def padded(args):
    """n = 0 builds zero-length buffers: one element keeps them valid
    (the kernels touch the first n only), as the conformance suite does."""
    return tuple(np.zeros(1, a.dtype) if isinstance(a, np.ndarray)
                 and a.size == 0 else a for a in args)


def port_phase(dev, modules):
    """The 24 corpus kernels through ``repro_torch.port`` on the card
    under h100 and rvv-128 (policy pallas): at the wall-clock geometry of
    benchmarks/port_suite.py and at n in {0, 1, strip - 1, strip + 1},
    each held to the harness's NumPy reference; then counted under
    rvv-128 at n = 64 against BENCH_port.json.  The isa ops reach no
    CUDA kernel: the kernels' launch counts, set to 0 before, stay 0."""
    from repro_torch import port
    from repro_torch.core import trace
    corpus = ROOT / "examples" / "neon_corpus"
    # the NumPy references only: harness.run_differential is never called
    # (it imports the JAX package)
    sys.path.insert(0, str(corpus))
    import harness
    for m in modules:
        m.reset_launches()
    kernels = port.load_corpus(str(corpus))
    names = [c.kernel for c in harness.cases()]
    if sorted(kernels) != sorted(names) or len(names) != 24:
        raise AssertionError(f"corpus: {sorted(kernels)}")
    rows = []
    for target in PORT_TARGETS:
        wall = harness.cases(n=WALL_N, tail_n=WALL_TAIL_N)
        for i, case in enumerate(wall):
            k = kernels[case.kernel]
            row = run_ported(k, case, padded(
                case.make_args(np.random.default_rng(SEED + i))),
                target, dev)
            step = strip_step(k.fn)
            tails = sorted({0, 1, step - 1, step + 1})
            for n in tails:
                small = {c.kernel: c for c in harness.cases(
                    n=n, tail_n=n)}[case.kernel]
                r = run_ported(k, small, padded(
                    small.make_args(np.random.default_rng(SEED + n))),
                    target, dev)
                row["max_ulp"] = max(row["max_ulp"], r["max_ulp"])
            row.update(kernel=case.kernel, target=target, n=WALL_N,
                       tail_n=WALL_TAIL_N, strip=step, tails=tails)
            emit("port_kernel", **row)
            rows.append(row)
    bench = json.loads((ROOT / "BENCH_port.json").read_text())
    counted = {}
    for i, case in enumerate(harness.cases(n=64)):
        with trace.count() as c:
            kernels[case.kernel](*case.make_args(np.random.default_rng(i)),
                                 target="rvv-128", device=dev)
        want = bench["kernels"][case.kernel]["targets"]["rvv-128"][
            "total_instrs"]
        if c["total"] != want:
            raise AssertionError(f"{case.kernel}: counted {c['total']} at "
                                 f"rvv-128, committed {want}")
        counted[case.kernel] = c["total"]
    total = {t: {"ms": sum(r["ms"] for r in rows if r["target"] == t),
                 "dispatches": sum(r["dispatches"] for r in rows
                                   if r["target"] == t),
                 "host_reads": sum(r["host_reads"] for r in rows
                                   if r["target"] == t)}
             for t in PORT_TARGETS}
    launched = {k: v for m in modules for k, v in m.LAUNCHES.items() if v}
    if launched:
        raise AssertionError(f"the corpus launched CUDA kernels: {launched}")
    emit("port", kernels=len(names), targets=list(PORT_TARGETS),
         wall_total=total, counted_rvv128_n64=counted,
         kernel_launches=launched)
    return rows



# compiled runs of the corpus: (target, re-tiled); rvv-1024 widens the
# strips up to 8x (16x on the widening kernels)
COMPILED_RUNS = (("h100", False), ("rvv-128", False), ("rvv-1024", True))
REPLAYS = 10
# tests/test_port_compile.py:63-69: compiled against the interpreter
COMPILED_RTOL, COMPILED_ATOL = 2e-6, 2e-7


def same_bits(got, want, what):
    for g, w in zip(got, want, strict=True):
        g, w = g.cpu().numpy(), w.cpu().numpy()
        if g.shape != w.shape or g.dtype != w.dtype or \
                not np.array_equal(g.view(np.uint8), w.view(np.uint8)):
            raise AssertionError(f"{what}: not bitwise equal")


def near_interp(got, want, what):
    """Integers bitwise; floats within the reference's compiled-versus-
    interpreter gate."""
    for g, w in zip(got, want, strict=True):
        g, w = g.cpu().numpy(), w.cpu().numpy()
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{what}: {g.shape}/{g.dtype} against "
                                 f"{w.shape}/{w.dtype}")
        if np.issubdtype(w.dtype, np.floating):
            ok = np.allclose(g, w, rtol=COMPILED_RTOL, atol=COMPILED_ATOL,
                             equal_nan=True)
        else:
            ok = np.array_equal(g, w)
        if not ok:
            raise AssertionError(f"{what}: compiled and interpreted differ")


def run_compiled(kernel, case, args, target, revec, dev):
    """One ported kernel compiled for ``target`` on the card, its buffers
    CUDA tensors: the first call (walk, capture, instantiate, replay) and
    ``REPLAYS`` more, each on the host clock around a synchronized call.  The output is held to
    the harness's NumPy reference (``conform_ulp``), to the interpreter
    of the same IR on the card (``near_interp``), and bitwise to the
    eager walk (``jit=False``) on the card and to every replay."""
    import torch
    from repro_torch import port
    host_args, args = args, tuple(
        torch.as_tensor(a, device=dev) if isinstance(a, np.ndarray) else a
        for a in args)
    ck = kernel.compile(target=target, revec=revec)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = ck(*args)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    first = dict(ck.last_call)
    outs = out if isinstance(out, tuple) else (out,)
    replay_ms = []
    for _ in range(REPLAYS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = ck(*args)
        torch.cuda.synchronize()
        replay_ms.append((time.perf_counter() - t0) * 1e3)
        same_bits(again if isinstance(again, tuple) else (again,), outs,
                  f"{case.kernel}/{target}: a replay")
    for t in outs:
        if t.device.type != "cuda":
            raise AssertionError(f"{case.kernel}: output on {t.device}")
    eager = kernel.compile(target=target, revec=revec, jit=False)(*args)
    same_bits(eager if isinstance(eager, tuple) else (eager,), outs,
              f"{case.kernel}/{target}: the eager walk")
    m = port.Machine(ck.fn, policy="pallas", target=target, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    interp = m.run(*args)
    torch.cuda.synchronize()
    interp_ms = (time.perf_counter() - t0) * 1e3
    interp = interp if isinstance(interp, tuple) else (interp,)
    near_interp(outs, interp, f"{case.kernel}/{target}")
    want = case.reference(*host_args)
    ulp = conform_ulp([t.cpu().numpy() for t in outs],
                      want if isinstance(want, tuple) else (want,), case)
    return {"first_ms": first_ms, "replay_ms": statistics.median(replay_ms),
            "captured": first["captured"],
            "host_reads": ck.last_call["host_reads"],
            "issues": first["issues"], "interp_ms": interp_ms,
            "interp_ulp": interp_gap(outs, interp),
            "factor": ck.retiling.factor if ck.retiling else 1,
            "max_ulp": ulp}


def interp_gap(got, want):
    """The replay against the interpreter of the same IR on the card
    (ROADMAP C.17): 0 where every output agrees bitwise, else the largest
    float gap in ULP (``near_interp`` has already held the integers
    bitwise and the floats to its tolerance)."""
    gap = 0
    for g, w in zip(got, want, strict=True):
        g, w = g.cpu().numpy(), w.cpu().numpy()
        if np.array_equal(g.view(np.uint8), w.view(np.uint8)):
            continue
        gap = max(gap, ulp_gap(g, w) if np.issubdtype(w.dtype, np.floating)
                  else float("inf"))
    return gap


def port_compiled_phase(dev, modules, interp_rows):
    """The 24 corpus kernels compiled on the card
    (``PortedKernel.compile``: one CUDA graph per call signature) under
    h100 and rvv-128, and re-tiled for rvv-1024, at the ``port`` phase's
    lengths, each held three ways (``run_compiled``); every signature
    must be captured with no host read.  Then the ladder on the card:
    ``run_resilient`` under h100 must be served by ``compiled+revec``
    undegraded for every kernel, and with one fault forced at
    ``compile.run`` by a lower rung with the same values.  No CUDA kernel
    is launched (the 13 kernels' counts stay 0)."""
    import torch
    from repro_torch import port
    from repro_torch.port import faultinject, resilience
    corpus = ROOT / "examples" / "neon_corpus"
    sys.path.insert(0, str(corpus))
    import harness
    for m in modules:
        m.reset_launches()
    kernels = port.load_corpus(str(corpus))
    port_ms = {(r["kernel"], r["target"]): r["ms"] for r in interp_rows}
    rows = []
    wall = harness.cases(n=WALL_N, tail_n=WALL_TAIL_N)
    for target, revec in COMPILED_RUNS:
        port.compiled_cache_clear()
        for i, case in enumerate(wall):
            k = kernels[case.kernel]
            args = padded(case.make_args(np.random.default_rng(SEED + i)))
            row = run_compiled(k, case, args, target, revec, dev)
            step = strip_step(k.fn)
            tails = sorted({0, 1, step - 1, step + 1})
            captured, reads = [row["captured"]], [row["host_reads"]]
            gaps = [row["interp_ulp"]]
            for n in tails:
                small = {c.kernel: c for c in harness.cases(
                    n=n, tail_n=n)}[case.kernel]
                r = run_compiled(k, small, padded(
                    small.make_args(np.random.default_rng(SEED + n))),
                    target, revec, dev)
                row["max_ulp"] = max(row["max_ulp"], r["max_ulp"])
                captured.append(r["captured"])
                reads.append(r["host_reads"])
                gaps.append(r["interp_ulp"])
            row["interp_ulp"] = max(gaps)
            if not all(captured) or any(reads):
                raise AssertionError(f"{case.kernel}/{target}: captured "
                                     f"{captured}, host reads {reads}")
            row.update(kernel=case.kernel, target=target, revec=revec,
                       n=WALL_N, tail_n=WALL_TAIL_N, tails=tails,
                       port_phase_interp_ms=port_ms.get(
                           (case.kernel, target)))
            emit("port_compiled_kernel", **row)
            rows.append(row)
    # the ladder on the card
    port.compiled_cache_clear()
    resilience.reset_resilience()
    ladder = {}
    for i, case in enumerate(wall):
        k = kernels[case.kernel]
        args = padded(case.make_args(np.random.default_rng(SEED + i)))
        out, rec = k.run_resilient(*args, target="h100")
        if rec.used != "compiled+revec" or rec.degraded:
            raise AssertionError(f"{case.kernel}: the ladder on the card "
                                 f"served {rec.to_dict()}")
        with faultinject.injected("compile.run",
                                  error=resilience.ExecError, times=1):
            down, drec = k.run_resilient(*args, target="h100")
        if not drec.degraded or drec.used == "compiled+revec":
            raise AssertionError(f"{case.kernel}: a forced fault did not "
                                 f"degrade: {drec.to_dict()}")
        same_bits(down if isinstance(down, tuple) else (down,),
                  out if isinstance(out, tuple) else (out,),
                  f"{case.kernel}: the degraded rung")
        ladder[case.kernel] = [rec.used, drec.used]
    launched = {k: v for m in modules for k, v in m.LAUNCHES.items() if v}
    if launched:
        raise AssertionError(f"the compiled corpus launched CUDA kernels: "
                             f"{launched}")
    total = {}
    for target, revec in COMPILED_RUNS:
        mine = [r for r in rows if r["target"] == target]
        total[target] = {key: sum(r[key] for r in mine) for key in (
            "first_ms", "replay_ms", "interp_ms", "issues")}
        total[target].update(revec=revec, captured=sum(
            r["captured"] for r in mine), kernels=len(mine))
    port.compiled_cache_clear()
    torch.cuda.synchronize()
    c17 = {"rows": len(rows),
           "bitwise": sum(r["interp_ulp"] == 0 for r in rows),
           "max_ulp": {f"{r['kernel']}/{r['target']}": r["interp_ulp"]
                       for r in rows if r["interp_ulp"]}}
    emit("port_compiled", targets=[t for t, _ in COMPILED_RUNS],
         wall_total=total, ladder=ladder, compiled_vs_interp=c17,
         resilience=resilience.resilience_stats(),
         kernel_launches=launched)
    return rows


# the serving tier of the frontend: benchmarks/serve_port_suite.py's
# shape (:40-57), with the card's own target beside the two RVV ones
SERVE_KERNELS = {"xnn_f32_vadd_ukernel": "vadd.c",
                 "xnn_f32_vdot_ukernel": "vdot.c",
                 "qs8_vmlal_dot_ukernel": "vmlal_dot.c"}
SERVE_TARGETS = ("rvv-128", "rvv-1024", "h100")
SERVE_BATCHES = (1, 8, 32)
SERVE_POLICIES = ("fine", "coarse")
SHORT_N, LONG_N = (20, 61), (70, 121)
SERVE_REPEATS = 40
SPEEDUP_FLOOR = 5.0        # batch-32 against batch-1 requests/s


def serve_requests(kernel, count, n_range, rng, target=None, dev=None):
    """serve_port_suite._make_requests: ``count`` requests of lengths
    drawn from ``n_range``; buffers on the card when ``dev`` is given."""
    from repro_torch.serve import Request
    import torch
    reqs = []
    for _ in range(count):
        n = int(rng.integers(*n_range))
        if kernel.name == "qs8_vmlal_dot_ukernel":
            a = rng.integers(-2, 3, n).astype(np.int8)
            b = rng.integers(-2, 3, n).astype(np.int8)
            out = np.zeros(1, np.int16)
        else:
            a = rng.standard_normal(n).astype(np.float32)
            b = rng.standard_normal(n).astype(np.float32)
            out = np.zeros(1 if kernel.name == "xnn_f32_vdot_ukernel"
                           else n, np.float32)
        args = (n, a, b, out)
        if dev is not None:
            args = (n,) + tuple(torch.as_tensor(x, device=dev)
                                for x in args[1:])
        reqs.append(Request(kernel, args, target=target))
    return reqs


def held_to_direct(reqs, results, cases, what):
    """Every served row against a direct ``PortedKernel.compile`` call of
    the same request on the card (revec, as the engine's first rung):
    integers bitwise, floats within the harness's conformance budget.
    Returns how many rows agree bitwise."""
    import torch
    same = 0
    for req, got in zip(reqs, results, strict=True):
        if not isinstance(got, torch.Tensor) or got.device.type != "cuda":
            raise AssertionError(f"{what}: a result is {type(got)}")
        want = req.kernel.compile(target=req.target, revec=True)(*req.args)
        conform_ulp([got.cpu().numpy()], [want.cpu().numpy()],
                    cases[req.kernel.name])
        same += bool(torch.equal(got, want))
    return same


def graph_ms(prog, reps=20):
    """Device ms of one replay of ``prog``'s latest graph (CUDA events
    around ``reps`` replays)."""
    import torch
    plan = next(reversed(prog._plans.values()))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    plan.graph.replay()
    start.record()
    for _ in range(reps):
        plan.graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def port_serve_phase(dev, modules):
    """``repro_torch.serve.PortEngine`` on the card: requests/s and p50 /
    p99 ms a submit (host clock, synchronized) at batch 1, 8 and 32 for
    vadd, vdot and the qs8 dot under rvv-128, rvv-1024 and h100 (SHORT
    lengths, ``fine`` buckets); every slate after the first replays its
    bucket's graph, and every output is held to a direct compiled call.
    Batch 32 must reach SPEEDUP_FLOOR x batch 1 on at least one target a
    kernel.  Then MIXED lengths through the ``fine`` and ``coarse``
    policies: programs within the buckets x targets x kernels bound, and
    a second slate of fresh lengths in the same buckets captures no new
    graph.  No fault, fallback or CUDA kernel launch is allowed."""
    import torch
    from repro_torch import port
    from repro_torch.port import resilience
    from repro_torch.serve import BucketPolicy, PortEngine
    corpus = ROOT / "examples" / "neon_corpus"
    sys.path.insert(0, str(corpus))
    import harness
    for m in modules:
        m.reset_launches()
    port.compiled_cache_clear()
    resilience.reset_resilience()
    kernels = {name: port.compile_file(str(corpus / f), name=name)
               for name, f in SERVE_KERNELS.items()}
    cases = {c.kernel: c for c in harness.cases()}
    engines = []
    bitwise = [0, 0]

    def held(reqs, results, what):
        bitwise[0] += held_to_direct(reqs, results, cases, what)
        bitwise[1] += len(reqs)

    def clean(eng, what):
        r = eng.stats()["resilience"]
        bad = {k: r[k] for k in ("batch_faults", "row_fallbacks",
                                 "program_fallbacks", "errors_returned")
               if r[k]}
        if bad:
            raise AssertionError(f"{what}: {bad}")

    rows = {}
    for kname, kernel in kernels.items():
        for tgt in SERVE_TARGETS:
            for B in SERVE_BATCHES:
                rng = np.random.default_rng(SEED)
                eng = PortEngine(target=tgt, max_batch=B,
                                 bucket_policy="fine")
                engines.append(eng)
                reqs = serve_requests(kernel, B, SHORT_N, rng)
                for r in reqs:
                    r.target = tgt
                what = f"{kname}/{tgt}/b{B}"
                held(reqs, eng.submit(reqs), what)
                graphs = eng.stats()["graphs"]
                lat = []
                for _ in range(SERVE_REPEATS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    eng.submit(reqs)
                    torch.cuda.synchronize()
                    lat.append((time.perf_counter() - t0) * 1e3)
                prog = next(iter(eng._programs.values()))
                if eng.stats()["graphs"] != graphs or \
                        not prog.last_call.get("captured"):
                    raise AssertionError(f"{what}: a slate did not replay")
                if B == max(SERVE_BATCHES):
                    # B distinct lengths of the same bucket: no new graph
                    ns = rng.permutation(np.arange(*SHORT_N))[:B]
                    fresh = [serve_requests(kernel, 1, (int(n), int(n) + 1),
                                            rng, tgt)[0] for n in ns]
                    held(fresh, eng.submit(fresh), what + "/distinct")
                    if eng.stats()["graphs"] != graphs:
                        raise AssertionError(f"{what}: {B} distinct lengths "
                                             "captured a new graph")
                clean(eng, what)
                p50 = float(np.percentile(lat, 50))
                row = {"kernel": kname, "target": tgt, "batch": B,
                       "reqs_per_s": B / (p50 / 1e3), "p50_ms": p50,
                       "p99_ms": float(np.percentile(lat, 99)),
                       "graph_ms": graph_ms(prog), "graphs": graphs}
                rows[(kname, tgt, B)] = row
                emit("port_serve_row", **row)
    speedups = {k: {t: rows[(k, t, max(SERVE_BATCHES))]["reqs_per_s"]
                    / rows[(k, t, 1)]["reqs_per_s"] for t in SERVE_TARGETS}
                for k in kernels}
    for k, per in speedups.items():
        if max(per.values()) < SPEEDUP_FLOOR:
            raise AssertionError(f"{k}: batch-32 reaches only "
                                 f"{max(per.values()):.2f}x batch-1 "
                                 f"requests/s (floor {SPEEDUP_FLOOR}): {per}")
    # the tensor path: request buffers already on the card
    for kname, kernel in kernels.items():
        eng = PortEngine(target="rvv-128", max_batch=8)
        reqs = serve_requests(kernel, 8, LONG_N, np.random.default_rng(SEED),
                              target="rvv-128", dev=dev)
        held(reqs, eng.submit(reqs), f"{kname}/tensors")
        clean(eng, f"{kname}/tensors")
    policies = {}
    for pol in SERVE_POLICIES:
        policy = BucketPolicy.preset(pol)
        eng = PortEngine(max_batch=32, bucket_policy=pol)
        engines.append(eng)
        rng = np.random.default_rng(SEED + 1)
        sigs, lat = set(), []
        for kname, kernel in kernels.items():
            for tgt in SERVE_TARGETS:
                reqs = (serve_requests(kernel, 16, SHORT_N, rng, tgt)
                        + serve_requests(kernel, 16, LONG_N, rng, tgt))
                sigs |= {(kname, tgt, policy.bucket(int(r.args[0])))
                         for r in reqs}
                held(reqs, eng.submit(reqs), f"{pol}/{kname}/{tgt}")
                graphs = eng.stats()["graphs"]
                # fresh lengths in the same buckets: replays only
                again = (serve_requests(kernel, 16, SHORT_N, rng, tgt)
                         + serve_requests(kernel, 16, LONG_N, rng, tgt))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                served = eng.submit(again)
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t0) * 1e3)
                held(again, served, f"{pol}/{kname}/{tgt}")
                if eng.stats()["graphs"] != graphs:
                    raise AssertionError(f"{pol}/{kname}/{tgt}: fresh "
                                         "lengths captured a new graph")
        st = eng.stats()
        clean(eng, pol)
        if st["batch_programs"] > len(sigs):
            raise AssertionError(f"{pol}: {st['batch_programs']} programs "
                                 f"over the bound {len(sigs)}")
        policies[pol] = {"batch_programs": st["batch_programs"],
                         "program_bound": len(sigs), "graphs": st["graphs"],
                         "buckets": sorted({b for _, _, b in sigs}),
                         "pad_overhead": st["pad_overhead"],
                         "inert_rows": st["inert_rows"],
                         "submit_p50_ms": float(np.median(lat))}
    launched = {k: v for m in modules for k, v in m.LAUNCHES.items() if v}
    if launched:
        raise AssertionError(f"the served corpus launched CUDA kernels: "
                             f"{launched}")
    torch.cuda.synchronize()
    emit("port_serve", targets=list(SERVE_TARGETS),
         batches=list(SERVE_BATCHES), speedup_floor=SPEEDUP_FLOOR,
         batch_speedup=speedups, engines=policies,
         rows_bitwise_to_direct=bitwise,
         graphs=sum(e.stats()["graphs"] for e in engines),
         compile_cache=port.compiled_cache_info(),
         kernel_launches=launched)
    port.compiled_cache_clear()
    return rows


# ---------------------------------------------------------------------------
# training: zamba2-1.2b at full width and 8 layers, the gradient gates, the
# other archs' train steps, checkpoint and restart, the no-detach guard
# ---------------------------------------------------------------------------

def train_want(cfg, seq, accum):
    """Exact kernel launches of one train step of a hybrid (zamba2) model,
    ``accum`` microbatches of ``seq`` positions a row: every block runs
    under remat, so its kernels launch twice (the forward, and the
    recompute in the backward); each gemm launches twice more in the
    backward (dA = dY B^T, dB = A^T dY); vtanh's, flash's and ssd's
    backward are torch ops.  Per microbatch: a Mamba2 layer's two
    projections and two ssd launches (``ssd.launches``), the shared
    block's q, k, v, o and its MLP's products, its gelu and one flash; a
    tied head is a plain matmul."""
    from repro_torch.kernels import ssd as ssd_mod
    kinds = cfg.layer_pattern()
    n_mamba = sum(k in MAMBA_KINDS for k in kinds)
    n_shared = sum(k == "mamba_shared" for k in kinds)
    blocks = 2 * n_mamba + n_shared * (4 + (3 if cfg.gated_mlp else 2))
    return {"gemm": accum * 4 * blocks,
            "vtanh": accum * 2 * n_shared * (cfg.act == "gelu"),
            "flash_attention": accum * 2 * n_shared,
            "ssd": accum * 2 * n_mamba * ssd_mod.launches(seq),
            "vsigmoid": 0, "decode_attention": 0}


def graph_functions(root):
    """The class names of every node of the autograd graph under
    ``root`` (a loss's grad_fn)."""
    seen, stack, names = set(), [root], set()
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        stack.extend(f for f, _ in fn.next_functions)
    return names


def one_unit(cfg):
    """``cfg`` cut to its prefix and one pattern unit (the encoder kept)."""
    prefix, unit, _, _ = cfg.pattern_unit()
    return cfg.replace(n_layers=len(prefix) + len(unit))


def leaf_names(params):
    from repro_torch import tree
    return ["::".join(map(str, p)) for p, _ in tree.paths(params)]


def grads_of(cfg, params, batch, policy):
    """(loss, gradients of every param leaf) of one loss_fn + backward
    under ``policy``."""
    import torch
    from repro_torch import tree
    from repro_torch.core import use_policy
    from repro_torch.train import loop
    with use_policy(policy), torch.enable_grad():
        loss, (xent, aux) = loop.loss_fn(params, cfg, batch)
        grads = torch.autograd.grad(loss, tree.leaves(params))
    return float(loss.detach()), float(aux.detach()), grads


def held_grads(kern, plain, names, rel_tol, what, gate=True, exempt=()):
    """Each leaf's max |g_kernel - g_vector| over the vector gradient's
    max |g|; raises where a gradient is missing or not finite, and (with
    ``gate``) where one is zero where the vector one exceeds rel_tol of
    that max (a dropped gradient; an entry within it may round to 0 on
    one tier alone: ROADMAP C.29) or, outside the leaves named in
    ``exempt``, differs by more than rel_tol of it."""
    worst = {}
    for name, g, w in zip(names, kern, plain):
        if g is None or w is None or g.shape != w.shape:
            raise AssertionError(f"{what}: {name} has no gradient")
        if not bool(g.isfinite().all()):
            raise AssertionError(f"{what}: {name}'s gradient is not finite")
        scale = float(w.float().abs().max())
        if gate and bool(((w.float().abs() > rel_tol * scale) &
                          (g == 0)).any()):
            raise AssertionError(f"{what}: {name}'s gradient is zero where "
                                 "the vector tier's is not")
        err = float((g.float() - w.float()).abs().max())
        worst[name] = err / scale if scale else (0.0 if err == 0 else
                                                  float("inf"))
    gated = [k for k in worst if k not in exempt]
    top = max(gated, key=worst.get) if gated else None
    if gate and top is not None and worst[top] > rel_tol:
        raise AssertionError(f"{what}: {top}'s gradient differs from the "
                             f"vector tier's by {worst[top]} of its max, "
                             f"against {rel_tol}")
    return worst


def mean_grads(cfg, params, batch, parts, policy):
    """(mean loss, fp32 mean gradient of every leaf) of ``batch`` cut into
    ``parts`` contiguous blocks of rows, one loss.backward() each under
    ``policy``: a train step's gradient, before its update."""
    import torch
    n = next(iter(batch.values())).shape[0] // parts
    loss, total = 0.0, None
    for i in range(parts):
        lo, _, grads = grads_of(cfg, params, {k: v[i * n:(i + 1) * n]
                                              for k, v in batch.items()},
                                policy)
        loss += lo / parts
        if total is None:
            total = [torch.zeros(g.shape, dtype=torch.float32,
                                 device=g.device) for g in grads]
        for t, g in zip(total, grads):
            t.add_(g.float() / parts)
        del grads
    return loss, total


class _Float64Torch:
    """``torch`` with its float32 read as float64."""

    def __init__(self, torch):
        self._torch = torch
        self.float32 = torch.float64

    def __getattr__(self, name):
        return getattr(self._torch, name)


def float64_grads(cfg, params, batch, want):
    """The gradients of the leaves named in ``want`` from one
    loss.backward() of the vector tier in float64: the params cast to it,
    and each of ``TWIN_MODULES`` given a ``torch`` whose float32 is
    float64 for the call, so that no cast on the path rounds to float32
    (nothing in the package changes).  The witness the float32 gate holds
    Mamba2's A_log gradients to (ROADMAP C.29)."""
    import importlib
    import torch
    from repro_torch import tree
    from repro_torch.core import use_policy
    from repro_torch.train import loop
    names = leaf_names(params)
    p64 = tree.map(lambda p: p.detach().to(torch.float64)
                   .requires_grad_(True), params)
    picked = [(n, p) for n, p in zip(names, tree.leaves(p64)) if n in want]
    saved = []
    try:
        for name in TWIN_MODULES:
            m = importlib.import_module(name)
            saved.append((m, m.torch))
            m.torch = _Float64Torch(torch)
        with use_policy("vector"), torch.enable_grad():
            loss, _ = loop.loss_fn(p64, cfg.replace(dtype="float64"), batch)
            grads = torch.autograd.grad(loss, [p for _, p in picked])
    finally:
        for m, t in saved:
            m.torch = t
    return {n: g for (n, _), g in zip(picked, grads)}


def witnessed(kern, plain, exact, rel_tol, what):
    """Each leaf of ``exact`` (name -> its float64 gradient): the kernel
    tier's max |g_k - g64| and the vector tier's max |g_v - g64|, each over
    max |g64|; with the failure, where the kernel tier sits further from
    the float64 gradient than the vector tier does by more than rel_tol
    (``kern`` and ``plain``: name -> gradient)."""
    rows, failures = {}, []
    for name, g64 in exact.items():
        scale = float(g64.abs().max())
        k, v = (float((g[name].double() - g64).abs().max()) / scale
                for g in (kern, plain))
        rows[name] = {"kernel": k, "vector": v}
        if k > v + rel_tol:
            failures.append(f"{what}: {name}'s gradient is {k} of its max "
                            f"from the float64 one, the vector tier's {v}, "
                            f"against {rel_tol} beyond it")
    return rows, failures


def a_log_leaves(names):
    return [n for n in names if n.endswith("A_log")]


def grad_gate(kernel, vector, exact, names, what):
    """The float32 gradient gate on ``kernel`` and ``vector``, each (loss,
    every leaf's gradient) of one loss.backward() on its tier from the
    same params: the loss within LM_TOL's float32 2e-4, every leaf's max
    |g_k - g_v| over max |g_v| within it too, and non-zero wherever the
    vector tier's is, but for Mamba2's A_log leaves, whose gradient sums
    over every position and reads up to 2.3e-4 from float32 reordering
    alone (ROADMAP C.29): those are held to ``exact``, their float64
    gradient (``float64_grads``), by ``witnessed``.  -> (record, the
    gate's failures)."""
    tol = LM_TOL["float32"]
    (kl, kern), (vl, plain) = kernel, vector
    a_log = a_log_leaves(names)
    failures = []
    if abs(kl - vl) > tol * abs(vl):
        failures.append(f"{what}: loss {kl} against the vector tier's {vl}")
    worst = held_grads(kern, plain, names, tol, what, gate=False)
    try:
        held_grads(kern, plain, names, tol, what, exempt=a_log)
    except AssertionError as e:
        failures.append(str(e))
    wit, bad = witnessed(dict(zip(names, kern)), dict(zip(names, plain)),
                         exact, tol, what)
    failures += bad
    order = sorted(worst, key=lambda k: -worst[k])
    gated = [k for k in order if k not in a_log]
    record = {"loss": kl, "vector_loss": vl, "leaves": len(worst),
              "tolerance": tol, "max_rel_leaf_err": worst[order[0]],
              "worst_leaf": order[0], "max_gated": worst[gated[0]],
              "worst_gated": gated[0],
              "a_log_witness": {k: {"kernel": float(f"{r['kernel']:.3g}"),
                                    "vector": float(f"{r['vector']:.3g}")}
                                for k, r in wit.items()},
              "worst_8": {k: float(f"{worst[k]:.3g}") for k in order[:8]},
              "failures": failures}
    return record, failures


def step0_gate(kernel, vector, names, what, reported=None):
    """The bf16 step-0 gate on ``kernel`` and ``vector``, each (mean loss,
    fp32 mean gradient of every leaf) of a train step's batch on its tier
    from the same state (``mean_grads``): the loss and the gradient's
    global norm within TRAIN_TOL (relative), those the step itself
    ``reported`` too where given, and each leaf's max |g_k - g_v| over
    max |g_v| (``held_grads``): the median leaf's within TRAIN_TOL, the
    worst leaf's within TRAIN_LEAF_TOL.  -> (record, the gate's
    failures)."""
    (kl, kern), (vl, plain) = kernel, vector
    norm = [math.sqrt(sum(float(g.square().sum()) for g in gs))
            for gs in (kern, plain)]
    gaps = {"loss": abs(kl - vl) / abs(vl),
            "grad_norm": abs(norm[0] - norm[1]) / norm[1]}
    if reported is not None:
        gaps["step_loss"] = abs(reported["loss"] - vl) / abs(vl)
        gaps["step_grad_norm"] = abs(reported["grad_norm"] - norm[1]) / \
            norm[1]
    worst = held_grads(kern, plain, names, TRAIN_TOL, what, gate=False)
    order = sorted(worst, key=lambda k: -worst[k])
    median = statistics.median(worst.values())
    failures = [f"{what}: step 0's {k} {gaps[k]} from the vector tier's, "
                f"against {TRAIN_TOL}" for k in gaps if gaps[k] > TRAIN_TOL]
    if median > TRAIN_TOL:
        failures.append(f"{what}: the median leaf's gradient is {median} "
                        f"of its max from the vector tier's, against "
                        f"{TRAIN_TOL}")
    if worst[order[0]] > TRAIN_LEAF_TOL:
        failures.append(f"{what}: {order[0]}'s gradient is "
                        f"{worst[order[0]]} of its max from the vector "
                        f"tier's, against {TRAIN_LEAF_TOL}")
    record = {"loss": kl, "vector_loss": vl, "grad_norm": norm[0],
              "vector_grad_norm": norm[1], "rel_gap": gaps,
              "leaves": len(worst), "median_rel_leaf_err": median,
              "max_rel_leaf_err": worst[order[0]], "worst_leaf": order[0],
              "worst_8": {k: float(f"{worst[k]:.3g}") for k in order[:8]},
              "failures": failures}
    return record, failures


def train_batch(cfg, data, step, extra, dev):
    return {**data.batch(step, device=dev), **extra}


def train_phase(dev, modules):
    """zamba2-1.2b at full width and ``TRAIN``'s depth, bf16: its steps of
    SyntheticLM traffic through ``train.loop.make_train_step`` under the
    default target (h100) and policy.  Gates: every step's exact kernel
    launches (``train_want``), the kernel tier and the Function of each
    of gemm, vtanh, attention and ssd, finite losses with the last below
    the first, every param leaf moved, and step 0's gradient against the
    vector tier's from the same state (``step0_gate``).  Prints each step's
    host-clock ms and tokens/s, the peak memory, and from step 1 under
    torch.profiler (``profile_train_step``) the device ms by kernel and
    by span (the forward, remat's recompute, the update, gemm's backward
    with its transposed copies, flash's and ssd's vector-tier recompute,
    the rest of the backward), the idle share against the median
    unprofiled step; and the bf16-peak share of 6 N tokens."""
    import torch
    from repro_torch.kernels import cost
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.core import trace
    from repro_torch.core.registry import REGISTRY
    from repro_torch.data.pipeline import SyntheticLM, extra_inputs
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.train import loop

    cfg = get_config(TRAIN["arch"]).replace(n_layers=TRAIN["layers"])
    b, seq, accum, steps = (TRAIN[k] for k in ("batch", "seq", "accum",
                                               "steps"))
    tcfg = loop.TrainConfig(accum=accum, optim=adamw.AdamWConfig(
        warmup_steps=1, total_steps=steps))
    data = SyntheticLM(cfg.vocab_size, seq, b, seed=SEED)
    extra = extra_inputs(cfg, b, SEED, dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    def fresh():
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        params = loop.trainable(M.init(cfg, gen, dev))
        return params, adamw.init(params)

    params, opt = fresh()
    n_params = M.count_params(params)
    # the Functions in the graph of one microbatch's loss (no backward)
    micro = {k: v[:b // accum] for k, v in
             train_batch(cfg, data, 0, extra, dev).items()}
    with torch.enable_grad():
        loss, _ = loop.loss_fn(params, cfg, micro)
    functions = sorted(n for n in graph_functions(loss.grad_fn)
                       if n.endswith("FnBackward"))
    del loss, micro
    want_fns = ["FlashAttentionFnBackward", "GemmFnBackward",
                "SsdFnBackward", "VtanhFnBackward"]
    if functions != want_fns:
        raise AssertionError(f"train: Functions in the graph {functions}, "
                             f"expected {want_fns}")
    want = train_want(cfg, seq, accum)
    step_fn = loop.make_train_step(cfg, tcfg)
    history, step_ms = [], []
    launches_all = {k: 0 for m in modules for k in m.LAUNCHES}
    profiled = None
    for s in range(steps):
        for m in modules:
            m.reset_launches()
        batch = train_batch(cfg, data, s, extra, dev)

        def run():
            p, o, _, met = step_fn(params, opt, None, batch)
            return p, o, {k: float(v) for k, v in met.items()}
        with trace.count() as counted:
            if s == 1:
                profiled, out = profile_train_step(run)
                wall = profiled["wall_ms"]
            else:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = run()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
        params, opt, met = out
        step_ms.append(wall)
        launched = {k: v for m in modules for k, v in m.LAUNCHES.items()}
        for k, v in launched.items():
            launches_all[k] += v
        for op, n in want.items():
            if launched[op] != n:
                raise AssertionError(f"train: step {s}: {launched[op]} {op} "
                                     f"launches, expected {n}")
        chosen = {op: sorted({t for (o, t) in counted["per_op"] if o == op})
                  for op in ("gemm", "vtanh", "attention", "ssd")}
        if any(t != ["pallas"] for t in chosen.values()):
            raise AssertionError(f"train: step {s} ran {chosen}; each op "
                                 "must run its kernel tier")
        if not np.isfinite(met["loss"]):
            raise AssertionError(f"train: step {s}'s loss is {met['loss']}")
        history.append({"step": s, **met, "ms": wall,
                        "gemm_variants": {k: launched[k] for k in
                                          ("gemm_mma", "gemm_simt",
                                           "gemm_small_m")}})
        emit("train_step", **history[-1])
    if not history[-1]["loss"] < history[0]["loss"]:
        raise AssertionError(f"train: the loss went from "
                             f"{history[0]['loss']} to {history[-1]['loss']}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    final = [p.detach().clone() for p in tree.leaves(params)]
    del params, opt
    torch.cuda.empty_cache()
    params, opt = fresh()
    del opt
    still = [n for n, a, b_ in zip(leaf_names(params), final,
                                    tree.leaves(params)) if torch.equal(a, b_)]
    del final
    if still:
        raise AssertionError(f"train: {len(still)} param leaves never "
                             f"moved, e.g. {still[:4]}")
    # step 0 on both tiers from the same state: the kernel tier in the
    # step's own microbatches, the vector tier two rows at a time (the same
    # mean, its sums in another order: the vector tier's attention
    # backward at four rows of 4096 would not fit beside the state)
    batch = train_batch(cfg, data, 0, extra, dev)
    t0 = time.perf_counter()
    kernel = mean_grads(cfg, params, batch, accum, "pallas")
    vector = mean_grads(cfg, params, batch, b // 2, "vector")
    step0, failures = step0_gate(kernel, vector, leaf_names(params), "train",
                                 reported=history[0])
    step0["seconds"] = time.perf_counter() - t0
    del params, kernel, vector
    if failures:
        raise AssertionError("; ".join(failures))
    torch.cuda.empty_cache()
    tokens = b * seq
    # the unprofiled steps after the first
    ms = statistics.median(step_ms[2:])
    busy = profiled.pop("device_busy_ms")
    record = {
        "arch": cfg.name, "params": n_params, "dtype": cfg.dtype,
        "layers": cfg.n_layers, "batch": b, "seq": seq, "accum": accum,
        "steps": steps, "target": "h100", "policy": REGISTRY.policy,
        "functions": functions, "launches_per_step": want,
        "losses": [h["loss"] for h in history],
        "grad_norms": [h["grad_norm"] for h in history],
        "step_ms": step_ms, "step_ms_median_2_on": ms,
        "tokens_per_s": tokens / ms * 1e3, "peak_gb": peak_gb,
        "bf16_peak_share": 6 * n_params * tokens / (ms / 1e3)
        / cost.BF16_MMA_PER_S, "step0_vs_vector": step0,
        "profiled_step": {**profiled, "device_busy_ms": busy,
                          "idle_share": 1.0 - busy / ms}}
    emit("train", **record)
    return {"launches": launches_all, **record}


# the kernel ``torch.cuda._sleep`` launches: the spans' markers
MARK_KERNEL = "spin_kernel"


def marks_swapped(marks):
    """Swap a marker around each of ``TRAIN_SPANS``'s functions (a
    module's, or a class's ``Class.method``): a ``MARK_KERNEL`` launched
    as it enters and as it leaves, each noted in ``marks`` as (name,
    entering), in the order of their launches on the one stream (nothing
    in the package changes); returns what to restore: (owner, attribute,
    what it held)."""
    import importlib
    import torch
    saved = []
    for span, mod, attr in TRAIN_SPANS:
        owner = importlib.import_module(mod)
        if "." in attr:
            cls, attr = attr.split(".")
            owner = getattr(owner, cls)
        fn = getattr(owner, attr)

        def marked(*a, _fn=fn, _span=span, **k):
            marks.append((_span, True))
            torch.cuda._sleep(1)
            try:
                return _fn(*a, **k)
            finally:
                marks.append((_span, False))
                torch.cuda._sleep(1)
        saved.append((owner, attr, owner.__dict__[attr]))
        setattr(owner, attr, staticmethod(marked)
                if isinstance(owner, type) else marked)
    return saved


def span_kernel_ms(events, marks):
    """Device ms of a profile's kernels by span: each kernel read under
    the innermost span open at it on the device, the ``MARK_KERNEL``s
    matched in order to ``marks`` (a ``block`` in the ``forward`` is the
    forward's; elsewhere it is ``recompute``; outside every span
    ``other``), split into the port's kernels (``PORT_KERNELS``) and
    torch's.  Raises unless the profile holds one marker a mark."""
    ours = [p for parts in PORT_KERNELS.values() for p in parts]
    out = {n: {"port": 0.0, "torch": 0.0}
           for n in [n for n, _, _ in TRAIN_SPANS if n != "block"] +
           ["recompute", "other"]}
    device = sorted((ev for ev in events
                     if str(ev.device_type).endswith("CUDA")),
                    key=lambda ev: ev.time_range.start)
    n_marks = sum(MARK_KERNEL in ev.name for ev in device)
    if n_marks != len(marks):
        raise AssertionError(f"profile: {n_marks} marker kernels for "
                             f"{len(marks)} span marks")
    pending, stack = iter(marks), []
    for ev in device:
        if MARK_KERNEL in ev.name:
            name, entering = next(pending)
            if not entering:
                stack.pop()
            elif name == "block":
                stack.append("forward" if stack[-1:] == ["forward"]
                             else "recompute")
            else:
                stack.append(name)
            continue
        kind = "port" if any(p in ev.name for p in ours) else "torch"
        out[stack[-1] if stack else "other"][kind] += \
            ev.time_range.elapsed_us() / 1e3
    return out


def profile_train_step(run):
    """(reading, result) of ``run()`` under torch.profiler with CUDA
    activity alone (the host's op records cost more than the step), with
    ``TRAIN_SPANS``'s markers swapped in: its host-clock ms, the device
    ms by kernel name and in all, the port's kernels' ms by op, and each
    span's device ms (``span_kernel_ms``): gemm's backward's torch
    kernels are its transposed copies, flash's and ssd's their
    vector-tier recompute."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    marks = []
    torch.cuda.synchronize()
    saved = marks_swapped(marks)
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        for owner, attr, held in saved:
            setattr(owner, attr, held)
    events = prof.events()
    by_kernel = {}
    for ev in events:
        if str(ev.device_type).endswith("CUDA") and \
                MARK_KERNEL not in ev.name:
            key = ev.name[:80]
            by_kernel[key] = by_kernel.get(key, 0.0) + \
                ev.time_range.elapsed_us() / 1e3
    spans = span_kernel_ms(events, marks)
    return {"wall_ms": wall, "device_busy_ms": sum(by_kernel.values()),
            "kernels_ms": dict(sorted(by_kernel.items(),
                                      key=lambda kv: -kv[1])[:16]),
            "port_kernels_ms": port_kernel_ms(by_kernel),
            "spans_ms": spans, "marks": len(marks),
            "transposed_copies_ms": spans["gemm_backward"]["torch"]}, out


# the port's kernels as the profiler names them (csrc/*.cu)
PORT_KERNELS = {"gemm": ("mma::mma_kernel", "simt_kernel", "small_m_kernel",
                         "splitk_reduce"),
                "vtanh": ("vtanh",), "vsigmoid": ("vsigmoid",),
                "flash_attention": ("fa::", "flash"),
                "ssd": ("ssd_state", "ssd_out", "state_kernel",
                        "out_kernel")}


def port_kernel_ms(by_kernel):
    """Device ms of the port's own kernels in a profile, by op."""
    out = {op: 0.0 for op in PORT_KERNELS}
    for name, ms in by_kernel.items():
        for op, parts in PORT_KERNELS.items():
            if any(p in name for p in parts):
                out[op] += ms
                break
    return out


def train_grad_phase(dev):
    """The gradient gate: zamba2-1.2b at full width and ``TRAIN``'s depth,
    float32,
    ``TRAIN_GRAD``'s tokens, held by ``grad_gate``.  The same in bf16,
    each leaf's reading printed, the loss held within LM_TOL's 3e-2 and
    nothing gated per leaf (bf16 rounding alone crosses such limits:
    ROADMAP C.22)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import model as M
    from repro_torch.train import loop
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = get_config(TRAIN["arch"]).replace(
            n_layers=TRAIN["layers"], dtype=dtype)
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        params = loop.trainable(M.init(cfg, gen, dev))
        batch = SyntheticLM(cfg.vocab_size, TRAIN_GRAD["seq"],
                            TRAIN_GRAD["batch"], seed=SEED).batch(
                                0, device=dev)
        what = f"train_grad/{dtype}"
        if dtype == "float32":
            names = leaf_names(params)
            kernel = grads_of(cfg, params, batch, "pallas")[::2]
            vector = grads_of(cfg, params, batch, "vector")[::2]
            exact = float64_grads(cfg, params, batch, a_log_leaves(names))
            out[dtype], failures = grad_gate(kernel, vector, exact, names,
                                             what)
            del kernel, vector, exact
            emit("train_grad_reading", dtype=dtype, **out[dtype])
            if failures:
                raise AssertionError("; ".join(failures))
        else:
            tol = LM_TOL[dtype]
            kl, _, kern = grads_of(cfg, params, batch, "pallas")
            vl, _, plain = grads_of(cfg, params, batch, "vector")
            worst = held_grads(kern, plain, leaf_names(params), tol, what,
                               gate=False)
            order = sorted(worst, key=lambda k: -worst[k])
            out[dtype] = {"loss": kl, "vector_loss": vl,
                          "leaves": len(worst), "tolerance": tol,
                          "max_rel_leaf_err": worst[order[0]],
                          "worst_leaf": order[0],
                          "median_rel_leaf_err": statistics.median(
                              worst.values()),
                          "worst_8": {k: float(f"{worst[k]:.3g}")
                                      for k in order[:8]}}
            emit("train_grad_reading", dtype=dtype, **out[dtype])
            if abs(kl - vl) > tol * abs(vl):
                raise AssertionError(f"{what}: loss {kl} against the "
                                     f"vector tier's {vl}")
            del kern, plain
        del params
        torch.cuda.empty_cache()
    emit("train_grad", arch=TRAIN["arch"], **TRAIN_GRAD, **out)
    return out


def train_archs_phase(dev):
    """The other served archs' train step, full width and depth cut to
    their prefix and one pattern unit (``one_unit``; whisper's encoder
    kept), float32, ``TRAIN_ARCH_TRAFFIC``: one loss.backward() on the
    kernel tier and one on the vector tier from the same params, an
    MoE's vector run routed by the kernel run's indices (``route_probe``;
    remat's recompute routes again, in the same order in both runs),
    held to the same per-leaf gate as train_grad (Mamba2's A_log leaves
    to their float64 gradient, ``witnessed``: ROADMAP C.29); the kernel
    tier and the Function of each op the arch's blocks reach (vsigmoid's
    for the silu archs), the aux loss non-zero for an MoE."""
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.core import trace
    from repro_torch.data.pipeline import SyntheticLM, extra_inputs
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod
    from repro_torch.train import loop
    fn_of = {"gemm": "GemmFnBackward", "vtanh": "VtanhFnBackward",
             "vsigmoid": "VsigmoidFnBackward",
             "attention": "FlashAttentionFnBackward",
             "ssd": "SsdFnBackward"}
    rows = {}
    for arch in TRAIN_ARCHS:
        started = time.perf_counter()
        full = get_config(arch)
        cfg = one_unit(full).replace(dtype="float32")
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        params = loop.trainable(M.init(cfg, gen, dev))
        b, seq = TRAIN_ARCH_TRAFFIC["batch"], TRAIN_ARCH_TRAFFIC["seq"]
        batch = {**SyntheticLM(cfg.vocab_size, seq, b, seed=SEED).batch(
            0, device=dev), **extra_inputs(cfg, b, SEED, dev)}
        ops_ = [op for op in serve_ops(cfg) if op != "decode_attention"]
        kernel_ops = [op for op in ops_ if serve_tier(cfg, op) == "pallas"]
        route = calls = pin = None
        saved = moe_mod._route
        try:
            if cfg.n_experts:
                route, calls = route_probe(moe_mod)
                moe_mod._route = route
            with trace.count() as counted, torch.enable_grad():
                loss, (_, aux) = loop.loss_fn(params, cfg, batch)
                functions = sorted(n for n in graph_functions(loss.grad_fn)
                                   if n.endswith("FnBackward"))
                kern = torch.autograd.grad(loss, tree.leaves(params))
            kl, aux = float(loss.detach()), float(aux.detach())
            del loss
            if cfg.n_experts:
                moe_mod._route = saved
                pin, _ = route_probe(moe_mod, pinned=calls)
                moe_mod._route = pin
            vl, _, plain = grads_of(cfg, params, batch, "vector")
        finally:
            moe_mod._route = saved
        chosen = {op: sorted({t for (o, t) in counted["per_op"] if o == op})
                  for op in ops_}
        want_tiers = {op: [serve_tier(cfg, op)] for op in ops_}
        if chosen != want_tiers:
            raise AssertionError(f"train_archs/{arch}: ran {chosen}, "
                                 f"expected {want_tiers}")
        want_fns = sorted(fn_of[op] for op in kernel_ops)
        if functions != want_fns:
            raise AssertionError(f"train_archs/{arch}: Functions "
                                 f"{functions}, expected {want_fns}")
        if bool(cfg.n_experts) != (aux > 0):
            raise AssertionError(f"train_archs/{arch}: aux {aux}")
        if abs(kl - vl) > LM_TOL["float32"] * abs(vl):
            raise AssertionError(f"train_archs/{arch}: loss {kl} against "
                                 f"the vector tier's {vl}")
        names = leaf_names(params)
        a_log = a_log_leaves(names)
        worst = held_grads(kern, plain, names, LM_TOL["float32"],
                           f"train_archs/{arch}", exempt=a_log)
        witness, bad = witnessed(
            dict(zip(names, kern)), dict(zip(names, plain)),
            float64_grads(cfg, params, batch, a_log) if a_log else {},
            LM_TOL["float32"], f"train_archs/{arch}")
        if bad:
            raise AssertionError("; ".join(bad))
        top = max(worst, key=worst.get)
        rows[arch] = {"layers": cfg.n_layers, "full_layers": full.n_layers,
                      "enc_layers": cfg.n_enc_layers,
                      "params": M.count_params(params), "loss": kl,
                      "vector_loss": vl, "aux": aux, "functions": functions,
                      "chosen": chosen, "leaves": len(worst),
                      "max_rel_leaf_err": worst[top], "worst_leaf": top,
                      "a_log_witness": witness,
                      "router_calls": len(calls) if calls else 0,
                      "seconds": time.perf_counter() - started}
        del params, kern, plain, calls
        torch.cuda.empty_cache()
    emit("train_archs", dtype="float32", **TRAIN_ARCH_TRAFFIC,
         tolerance=LM_TOL["float32"], archs=rows)
    return rows


def train_resume_phase(dev):
    """Checkpoint and restart on the card: zamba2-1.2b at full width cut
    to one pattern unit (6 Mamba2 layers and the shared block), bf16,
    ``TRAIN_RESUME``'s steps through ``train.loop.train`` with an
    AsyncCheckpointer every ``ckpt_every`` steps and a failure injected
    at ``fail_at``, in a directory under build/ removed at the end.
    Gates: one restart, the latest step the last, the params restored
    from it bitwise equal to the trained ones, and the losses equal to an
    uninterrupted run's within 1e-6 (relative); whether they are bitwise
    is printed, with the bytes and seconds of each save."""
    import shutil
    import tempfile
    import torch
    from repro_torch import tree
    from repro_torch.checkpoint import checkpointer as ckpt
    from repro_torch.configs import get_config
    from repro_torch.optim import adamw
    from repro_torch.runtime.fault_tolerance import FailureInjector
    from repro_torch.train import loop
    cfg = one_unit(get_config(TRAIN["arch"]))
    r = TRAIN_RESUME
    tcfg = loop.TrainConfig(optim=adamw.AdamWConfig(
        warmup_steps=1, total_steps=r["steps"]))
    kw = dict(steps=r["steps"], batch_size=r["batch"], seq_len=r["seq"],
              tcfg=tcfg, seed=SEED, log_every=1000, device=dev)
    (ROOT / "build").mkdir(exist_ok=True)
    d = tempfile.mkdtemp(prefix="train_resume_", dir=ROOT / "build")
    saves, write = [], ckpt._write

    def timed_write(path, step, host):
        t0 = time.perf_counter()
        final = write(path, step, host)
        saves.append({"step": step, "seconds": time.perf_counter() - t0,
                      "bytes": sum(f.stat().st_size
                                   for f in Path(final).iterdir())})
        return final
    try:
        ckpt._write = timed_write
        t0 = time.perf_counter()
        res = loop.train(cfg, ckpt_dir=d, ckpt_every=r["ckpt_every"],
                         injector=FailureInjector(fail_at=[r["fail_at"]]),
                         **kw)
        run_s = time.perf_counter() - t0
        ckpt._write = write
        latest = ckpt.latest_step(d)
        restored = ckpt.restore(d, latest, {"params": res["params"]})
        same = all(torch.equal(a, b.detach()) for a, b in zip(
            tree.leaves(restored["params"]), tree.leaves(res["params"])))
        steps_seen = [h["step"] for h in res["history"]]
        del restored, res["params"]
        torch.cuda.empty_cache()
        plain = loop.train(cfg, **kw)
        del plain["params"]
    finally:
        ckpt._write = write
        shutil.rmtree(d, ignore_errors=True)
    if res["restarts"] != 1 or latest != r["steps"] - 1 or not same:
        raise AssertionError(f"train_resume: restarts {res['restarts']}, "
                             f"latest step {latest}, restored params "
                             f"bitwise {same}")
    # every step run, the one re-run after the restart too, against the
    # uninterrupted run's same step
    got = [(h["step"], h["loss"]) for h in res["history"]]
    want = {h["step"]: h["loss"] for h in plain["history"]}
    rel = max(abs(x - want[s]) / abs(want[s]) for s, x in got)
    if {s for s, _ in got} != set(want) or rel > 1e-6:
        raise AssertionError(f"train_resume: losses {got} against an "
                             f"uninterrupted run's {want}")
    record = {"arch": cfg.name, "layers": cfg.n_layers, **r,
              "restarts": res["restarts"], "steps_seen": steps_seen,
              "latest_step": latest, "params_restored_bitwise": same,
              "losses": got, "uninterrupted_losses": want,
              "max_rel_loss_gap": rel,
              "losses_bitwise": all(x == want[s] for s, x in got),
              "saves": saves, "run_s": run_s}
    emit("train_resume", **record)
    return record


# the sharded train step (``train.loop.make_sharded_train_step``): each
# model on ranks that share the one card (gloo stages CUDA tensors through
# the host; NCCL refuses two ranks on one device), held to the same
# model's single-rank step.  (tag, arch, depth cut, mesh): depth None is
# the full depth, "reduced" the config's reduced() widths.  mistral on
# (2, 2) runs FSDP, data, tensor and sequence parallelism at once (FSDP's
# cut already splits every leaf over 'data', so its optimizer state has
# no ZeRO-1 slice of its own); gemma3 (no FSDP, one 5:1 pattern unit of
# its 26 layers) runs ZeRO-1's slice and all-gather (SHARDED_ZERO1) and
# compresses its gradient to int8 (SHARDED_INT8).
SHARDED = (("mistral", "mistral-large-123b", 1, (2, 2)),
           ("granite", "granite-moe-1b-a400m", 12, (1, 2)),
           ("gemma3", "gemma3-1b", 6, (2, 1)),
           # tensor parallelism of every other block kind: zamba2's one
           # pattern unit (five mamba, one mamba_shared) with the ssd kernel
           # on each rank's 32 of 64 SSM heads, deepseek's MLA (moe_dense
           # and moe, 32 of 64 experts a rank), whisper's enc and dec
           # blocks (3 of 6 heads) and gemma3's one kv head split over two
           # ranks, each at full width
           ("zamba2", "zamba2-1.2b", 6, (1, 2)),
           ("deepseek", "deepseek-v2-lite-16b", 2, (1, 2)),
           ("whisper", "whisper-tiny", None, (1, 2)),
           ("gemma3_tp", "gemma3-1b", 6, (1, 2)),
           # heads that 'model' does not divide (ROADMAP A.9.10): whisper
           # whole on (1, 4), 2 / 2 / 2 / 0 of its 6 heads a rank, and
           # gemma3's 6 layers on (1, 8), one of its 4 heads on ranks 0-3
           # and none on 4-7 (serving only, ``SERVE_ONLY``)
           ("whisper_tp4", "whisper-tiny", None, (1, 4)),
           ("gemma3_tp8", "gemma3-1b", 6, (1, 8)),
           # data > 1 with experts over 'model' (ROADMAP A.9.9): granite
           # on (2, 2), its capacity per data shard (``shard_capacity``),
           # 12 of its 24 layers as the (1, 2) job (both cut from 24 for
           # the script's time)
           ("granite_dp", "granite-moe-1b-a400m", 12, (2, 2)))
SHARDED_ZERO1 = ("gemma3",)
SHARDED_INT8 = ("gemma3",)
# float32: zamba2 reduced on (1, 4) (two ranks share an SSM group),
# granite reduced with sequence parallelism through its moe blocks, and
# SSM heads that straddle SSM groups (ROADMAP A.9.11): zamba2 reduced
# with d_model 96 and 3 groups on (1, 4), 12 SSM heads, 3 a rank, 4 a
# group, ranks 1 and 2 reading two groups each, every rank's ssd run one
# group a head.  No public config straddles (the padded vocabulary keeps
# 'model' a power of two, which gives each rank whole groups of zamba2's
# 64 heads in 2 groups and mamba2's 64 in 1), so it runs at reduced widths.
SHARDED_F32 = (("granite_f32", "granite-moe-1b-a400m", 4, (1, 2)),
               ("mistral_f32", "mistral-large-123b", "reduced", (2, 2)),
               ("zamba2_f32", "zamba2-1.2b", "reduced", (1, 4)),
               ("granite_sp_f32", "granite-moe-1b-a400m", "reduced", (1, 2)),
               ("zamba2_straddle_f32", "zamba2-1.2b", "reduced", (1, 4)))
# a job's config fields beyond its cut (whisper_tp4: whisper-tiny's own 6
# heads, kept where the job is cut to reduced widths, as the CPU tests cut
# it)
SHARDED_OVER = {"granite_sp_f32": {"use_sp": True},
                "whisper_tp4": {"n_heads": 6, "n_kv_heads": 6},
                "zamba2_straddle_f32": {"d_model": 96, "ssm_groups": 3}}
# the jobs whose SSM heads straddle SSM groups: every rank's ssd calls
# must have one group a head
SHARDED_STRADDLED = ("zamba2_straddle_f32",)
# the controls, each the float32 job of its tag run again with a fault
# planted in its ranks, which must fail the job's gate: the copy into the
# model region reduced by nothing backward, the gated norm's sum of
# squares over 'model' dropped, and a straddling rank's groups read with
# the h // g repeat of a rank that holds whole groups
SHARDED_CONTROLS = {"granite_f32": "copy", "zamba2_f32": "norm_sum",
                    "zamba2_straddle_f32": "groups_repeated"}
# compressed_psum's input a rank (float32 elements), and the pipeline:
# two stages of one full-width ``attn`` block, M microbatches
SHARDED_PSUM = 64 << 20
PIPELINE = dict(arch="gemma3-1b", cut=None, micro=8, batch=1, seq=512)
SHARDED_TRAFFIC = dict(batch=4, seq=512, steps=2)
SHARDED_OPS = ("gemm", "vsigmoid", "vtanh", "flash_attention", "ssd")
SHARDED_TIMEOUT = 480
# the kernels' calls on the sharded path, timed: (rows, (K, N) of the
# local weights), the flash shapes (B, S, H, Hkv, D) and the silu's
# zamba2's on a (1, 2) rank: w_in's 4256 local columns, w_out and the
# shared block's o, its q / k / v and its MLP's down, its MLP's up
SHARDED_GEMM = {"mistral": (1024, ((12288, 6144), (12288, 512),
                                   (6144, 12288), (12288, 14336),
                                   (14336, 12288), (12288, 16384))),
                "granite": (2048, ((1024, 512), (1024, 256), (512, 1024))),
                "zamba2": (2048, ((2048, 4256), (2048, 2048), (4096, 2048),
                                  (4096, 4096)))}
# (B, S, H, Hkv, D, causal): gemma3's two q heads over its gathered kv
# head, whisper's encoder (3 of 6 heads), zamba2's shared block (16 of
# 32); on the uneven splits (A.9.10) whisper's 2 of 6 heads on (1, 4),
# its encoder and decoder, and gemma3's one head over its gathered kv
# head on (1, 8)
SHARDED_FLASH = {"mistral": (2, 512, 48, 4, 128, True),
                 "granite": (4, 512, 8, 4, 64, True),
                 "gemma3": (4, 512, 2, 1, 256, True),
                 "whisper": (4, 1500, 3, 3, 64, False),
                 "zamba2": (4, 512, 16, 16, 128, True),
                 "whisper_tp4_enc": (4, 1500, 2, 2, 64, False),
                 "whisper_tp4_dec": (4, 512, 2, 2, 64, True),
                 "gemma3_tp8": (4, 512, 1, 1, 256, True)}
# decode on the same ranks: (B, slots, H, Hkv, D), 512 of the slots valid
SHARDED_DECODE = {"whisper_tp4": (4, 520, 2, 2, 64),
                  "gemma3_tp8": (4, 520, 1, 1, 256)}
SHARDED_SILU = {"mistral": (2, 512, 14336), "granite_experts": (16, 640, 512)}
# ssd on a zamba2 (1, 2) rank, and on a rank of the straddled job (one
# group a head): (B, S, heads, p, groups, n, dtype)
SHARDED_SSD = {"zamba2": (4, 512, 32, 64, 1, 64, "bfloat16"),
               "zamba2_straddle": (4, 512, 3, 16, 3, 16, "float32")}
# serving on the mesh (``serve.engine``'s prefill and decode steps on a
# rank's shards, its part of the cache and its rows): the jobs of these
# tags in their dtype, a prefill of ``prompt`` seeded tokens a row and
# ``steps`` decode steps fed the single rank's greedy tokens, each rank
# held to the single rank's steps on the same params (an MoE routed by
# the single rank's indices); and the dry run (``launch/dryrun.py``) of
# the same two cells on stand-ins in this process
SHARDED_SERVE = ("zamba2", "mistral", "whisper_tp4", "gemma3_tp8",
                 "granite_dp", "zamba2_straddle_f32")
SERVE_ONLY = ("gemma3_tp8",)
SERVE_TRAFFIC = dict(batch=4, prompt=512, steps=8)


def sharded_config(arch, cut, dtype):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if cut == "reduced":
        cfg = cfg.reduced()
    elif cut is not None:
        cfg = cfg.replace(n_layers=cut)
    return cfg.replace(dtype=dtype)


def job_config(job, dtype=None):
    """A ``SHARDED`` or ``SHARDED_F32`` job's config in ``dtype`` (None:
    the job's own, float32 for a ``SHARDED_F32`` job, else bf16)."""
    tag, arch, cut, _ = job
    dtype = dtype or ("float32" if tag.endswith("f32") else "bfloat16")
    return sharded_config(arch, cut, dtype).replace(
        **SHARDED_OVER.get(tag, {}))


@contextlib.contextmanager
def shard_capacity(moe_mod, n_b):
    """``repro_torch.models.moe``'s dispatch on a single rank as ``n_b``
    data shards of whole rows take it on a mesh (stand-ins swapped in
    from here for the scope; nothing in the package changes): each
    shard's choices against ``capacity(cfg, t // n_b)``, the reference's
    capacity per data shard, in rows of their own of one expert buffer,
    so that a data-parallel run and the single rank drop the same
    choices and launch the same kernels.  Nothing changes for ``n_b``
    1."""
    import torch
    dispatch, slots = moe_mod._dispatch_compute, moe_mod._slots

    def shard_slots(idx, cap, e_lo, e_local):
        t, c = idx.shape[0] // n_b, cap // n_b
        parts = [slots(idx[i * t:(i + 1) * t], c, e_lo, e_local)
                 for i in range(n_b)]
        return (torch.cat([e for e, _, _ in parts]),
                torch.cat([torch.where(keep, pos + i * c, cap)
                           for i, (_, pos, keep) in enumerate(parts)]),
                torch.cat([keep for _, _, keep in parts]))

    def per_shard(params, xt, gates, idx, cfg, cap, e_lo, e_local):
        cap = n_b * moe_mod.capacity(cfg, xt.shape[0] // n_b)
        return dispatch(params, xt, gates, idx, cfg, cap, e_lo, e_local)
    if n_b > 1:
        moe_mod._dispatch_compute, moe_mod._slots = per_shard, shard_slots
    try:
        yield
    finally:
        moe_mod._dispatch_compute, moe_mod._slots = dispatch, slots


@contextlib.contextmanager
def ssd_shapes():
    """``kernels.ops.ssd`` wrapped to add each call's (b, s, heads, p,
    groups, n) to the set it yields."""
    from repro_torch.kernels import ops
    fn, seen = ops.ssd, set()

    def recorded(x, dt, A, B, *a, **k):
        seen.add(tuple(x.shape) + tuple(B.shape[2:]))
        return fn(x, dt, A, B, *a, **k)
    ops.ssd = recorded
    try:
        yield seen
    finally:
        ops.ssd = fn


def sharded_want(cfg, seq, empty=False):
    """Exact launches of gemm, vsigmoid, vtanh, flash and ssd in one train
    step on one rank of any mesh, ``seq`` positions a row: each block
    runs under remat, so its kernels launch twice, and each gemm twice
    more in the backward (dA, dB).  A
    GQA block's q, k, v, o and its dense MLP's products are gemms (an
    MoE's experts are batched matmuls), its activation one vsigmoid (silu)
    or vtanh (gelu), its attention one flash; an MLA block's q (``wq``, or
    ``w_dq`` and ``w_uq``), ``w_dkv``, ``w_uk``, ``w_uv`` and ``wo`` are
    gemms and its attention runs on the vector tier (no flash); a Mamba2
    layer's ``w_in`` and ``w_out`` are gemms and its scan one ssd call of
    ``ssd.launches(seq)`` launches; ``mamba_shared`` adds zamba2's shared
    GQA block with its MLP; whisper's encoder blocks are GQA blocks and
    its decoder's add the cross-attention's q, k, v, o and a flash.  An
    untied head is a gemm outside remat (3 launches), a tied one a plain
    matmul; a final softcap one vtanh outside remat.  Under a 'model'
    split each rank makes the same calls on its shards; on a rank that
    holds no heads (``empty``: 'model' does not divide them) an
    attention has no heads, so it launches no flash, and its products
    onto the heads (GQA's q; MLA's q, ``w_uk`` and ``w_uv``) have N = 0:
    their forward, its recompute and dB launch nothing (an empty
    output), their dA (K = 0) does; the output product (K = 0) launches
    forward and in the recompute (its bias, here none: zeros), and its
    dA (N = 0) and dB (M = 0) launch nothing."""
    from repro_torch.kernels import ssd as ssd_mod
    mlp = 3 if cfg.gated_mlp else 2
    mla = cfg.attn_kind == "mla"
    attn = (2 if cfg.q_lora_rank else 1) + 4 if mla else 4
    n = {"gemm": 0, "idle": 0, "act": 0, "flash": 0, "ssd": 0}
    # the gemm launches an empty rank does not make, an attention: 3 of
    # each product onto the heads, 2 of the output product
    idle = 3 * (3 if mla else 1) + 2 if empty else 0

    def add(gemm, act=0, attns=0, ssd=0):
        """A block's gemms, activations, attentions (each a flash but
        MLA's) and ssd calls."""
        n["gemm"] += gemm
        n["idle"] += idle * attns
        n["act"] += act
        n["flash"] += 0 if empty or mla else attns
        n["ssd"] += ssd
    for k in cfg.layer_pattern() + ["enc"] * cfg.n_enc_layers:
        if k in MAMBA_KINDS:
            add(2, ssd=1)
        if k in ("mamba_shared", "enc"):
            add(4 + mlp, 1, 1)
        elif k == "dec":
            add(8 + mlp, 1, 2)
        elif k == "moe":
            shared = bool(cfg.n_shared_experts)
            add(attn + mlp * shared, 1 + shared, 1)
        elif k != "mamba":
            add(attn + mlp, 1, 1)
    return {"gemm": 4 * n["gemm"] - n["idle"] +
            (0 if cfg.tie_embeddings else 3),
            "vsigmoid": 2 * n["act"] * (cfg.act == "silu"),
            "vtanh": 2 * n["act"] * (cfg.act == "gelu") +
            (cfg.final_softcap is not None),
            "flash_attention": 2 * n["flash"],
            "ssd": 2 * n["ssd"] * ssd_mod.launches(seq)}


def sharded_tiers(cfg, want):
    """The tier each op of ``want`` must run on: the kernel tier where it
    launches, and attention's wherever the model has any (a rank without
    heads dispatches it and launches nothing), MLA's attention the vector
    tier (the reference's rule), none elsewhere."""
    tiers = {op: ["pallas"] if want.get(op) else [] for op in SHARDED_OPS}
    if cfg.attn_kind == "mla":
        tiers["flash_attention"] = ["vector"]
    elif cfg.n_enc_layers or set(cfg.layer_pattern()) - {"mamba"}:
        tiers["flash_attention"] = ["pallas"]
    return tiers


def _in_policy(policy):
    """``use_policy(policy)``, or the registry's default where None."""
    from repro_torch.core import use_policy
    return contextlib.nullcontext() if policy is None else use_policy(policy)


def rank_heads(cfg, mesh):
    """The attention heads this rank of ``mesh`` holds: its chunk of them
    along 'model' as ``sharding.model_range`` cuts them."""
    from repro_torch.models import sharding as Sh
    lo, hi = Sh.chunk_range(cfg.n_heads, mesh.coordinate()["model"],
                            mesh.shape["model"])
    return hi - lo


def _sharded_batches(cfg, dev, traffic):
    """The steps' batches: seeded tokens, and whisper's stub frames."""
    from repro_torch.data.pipeline import SyntheticLM, extra_inputs
    data = SyntheticLM(cfg.vocab_size, traffic["seq"], traffic["batch"],
                       seed=SEED)
    extra = extra_inputs(cfg, traffic["batch"], SEED, dev)
    return [{**data.batch(s, device=dev), **extra}
            for s in range(traffic["steps"])]


def _counted_step(step, dev):
    """One call of ``step()`` with every kernel's count set to 0 before
    it: -> (its result, its LM launches, the tiers its ops ran), raising
    unless the launches are ``sharded_want``'s and each op its kernel
    tier's."""
    from repro_torch.core import trace
    from repro_torch.kernels import elementwise as ew
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gemm
    from repro_torch.kernels import ssd as ssd_mod
    mods = (gemm, ew, fa, ssd_mod)
    for m in mods:
        m.reset_launches()
    with trace.count() as counted:
        out = step()
        _sync(dev)
    launched = {k: v for m in mods for k, v in m.LAUNCHES.items()
                if k in SHARDED_OPS}
    chosen = {op: sorted({t for (o, t) in counted["per_op"]
                          if o == ("attention" if op == "flash_attention"
                                   else op)}) for op in SHARDED_OPS}
    return out, launched, chosen


def _held(launched, chosen, want, cfg, what, dev):
    """Raise unless each op ran the tier ``sharded_tiers`` gives ``cfg``
    and ``want``, and (on the card, where a call is a launch) the
    launches are ``want``, an op it does not name none."""
    got = {op: launched.get(op, 0) for op in SHARDED_OPS}
    if dev.type == "cuda" and got != {op: want.get(op, 0)
                                      for op in SHARDED_OPS}:
        raise AssertionError(f"{what}: launches {launched}, expected {want}")
    tiers = sharded_tiers(cfg, want)
    if chosen != tiers:
        raise AssertionError(f"{what}: ran {chosen}; expected {tiers}")


def _sharded_single(rank, world, jobs, traffic, out_dir, dev_type,
                    policy, serve_traffic):
    """The single-rank step (``train.loop.make_train_step``) of each job, on
    ``dev_type`` (the card) under ``policy`` (None: the default): step
    0's gradient (one loss_fn + backward, saved to ``out_dir`` in the
    model's dtype) and the two steps' metrics and launches; an MoE's
    router calls recorded (``route_probe``) for the sharded ranks to
    route by; a ``SHARDED_INT8`` job's steps with ``compress_grads``, step
    0's int8 payload saved (q) and returned (the scales).  An MoE job on
    a mesh of more than one data rank dispatches as its data shards do
    (``shard_capacity``)."""
    import torch
    from repro_torch import tree
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod
    from repro_torch.optim import adamw, compression
    from repro_torch.train import loop
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(dev_type)
    out, seconds = {}, {}
    for job in jobs:
        if job[0] in SHARDED_SERVE:
            t0 = time.perf_counter()
            out[f"serve/{job[0]}"] = _serve_single(job, serve_traffic,
                                                   out_dir, dev, policy)
            seconds[f"serve/{job[0]}"] = time.perf_counter() - t0
    for job in jobs:
        tag = job[0]
        if tag in SERVE_ONLY:
            continue
        t_job = time.perf_counter()
        cfg = job_config(job)
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        params = loop.trainable(M.init(cfg, gen, dev))
        batches = _sharded_batches(cfg, dev, traffic)
        saved, calls = moe_mod._route, None
        n_b = job[3][0]
        try:
            if cfg.n_experts:
                moe_mod._route, calls = route_probe(moe_mod)
            with _in_policy(policy), torch.enable_grad(), \
                    shard_capacity(moe_mod, n_b):
                loss, _ = loop.loss_fn(params, cfg, batches[0])
                grads = torch.autograd.grad(loss, tree.leaves(params))
            torch.save([g.detach().to(model_dtype(cfg)).cpu() for g in grads],
                       out_dir / f"{tag}.grads.pt")
            del grads, loss
            # the sharded ranks route step by step as the steps below do
            # (their first step's gradient is this pass's)
            first = len(calls) if calls is not None else 0
            int8 = tag in SHARDED_INT8
            step = loop.make_train_step(
                cfg, loop.TrainConfig(compress_grads=int8))
            opt = adamw.init(params)
            err = compression.err_init(params) if int8 else None
            packed = _recording(compression, "compress") if int8 else []
            metrics, launches, step_s = [], [], []
            for s, b in enumerate(batches):
                t0 = time.perf_counter()
                with _in_policy(policy), shard_capacity(moe_mod, n_b):
                    (params, opt, err, m), launched, chosen = _counted_step(
                        lambda: step(params, opt, err, b), dev)
                step_s.append(time.perf_counter() - t0)
                want = sharded_want(cfg, traffic["seq"])
                _held(launched, chosen, want, cfg,
                      f"sharded/{tag}/single step {s}", dev)
                metrics.append({k: float(v) for k, v in m.items()})
                launches.append(launched)
        finally:
            moe_mod._route = saved
            _recording(compression, "compress", stop=True)
        if calls is not None:
            torch.save([c["idx"].cpu() for c in calls[first:]],
                       out_dir / f"{tag}.routes.pt")
        out[tag] = {"params": M.count_params(params), "metrics": metrics,
                    "launches": launches, "step_s": step_s,
                    "peak_gb": _peak_gb(dev)}
        if packed:
            torch.save([q.cpu() for q in tree.leaves(packed[0][0][0]["q"])],
                       out_dir / f"{tag}.q.pt")
            out[tag]["scales"] = [float(x) for x in
                                  tree.leaves(packed[0][0][0]["scale"])]
        del params, opt, err, packed
        _freed(dev)
        seconds[tag] = time.perf_counter() - t_job
    out["seconds"] = seconds
    return out


def _counted_serve(fn, dev):
    """(``fn()``, every kernel's launches in it that are not 0, by launch
    counter), each count set to 0 before."""
    from repro_torch.kernels import (conv, elementwise, flash_attention,
                                     gemm, ibilinear, pooling, ssd)
    mods = (conv, elementwise, flash_attention, gemm, ibilinear, pooling,
            ssd)
    for m in mods:
        m.reset_launches()
    out = fn()
    _sync(dev)
    return out, {k: v for m in mods for k, v in m.LAUNCHES.items() if v}


def _serve_prompts(cfg, traffic):
    """The seeded prompts of ``traffic`` (``SERVE_TRAFFIC``), (batch,
    prompt) int32."""
    rng = np.random.default_rng(SEED + 11)
    return rng.integers(0, cfg.vocab_size, (traffic["batch"],
                                            traffic["prompt"])) \
        .astype(np.int32)


def _serve_extra(cfg, traffic, dev):
    """The prefill's other inputs: whisper's seeded stub frames (float32,
    as ``launch/dryrun.py``'s input specs give them), none elsewhere."""
    from repro_torch.data.pipeline import extra_inputs
    return extra_inputs(cfg, traffic["batch"], SEED, dev)


def _serve_single(job, traffic, out_dir, dev, policy):
    """A ``SHARDED_SERVE`` job on the single rank: ``serve.engine``'s
    prefill and decode steps (the ``Engine``'s) from the seeded init the
    sharded ranks cut, a prefill of ``_serve_prompts`` and
    ``traffic["steps"]`` greedy steps; its logits and tokens saved
    to ``out_dir`` for the ranks, its launches a step returned.  An MoE's
    router indices are saved too, for the ranks to route by, and on a
    mesh of more than one data rank it dispatches as its data shards do
    (``shard_capacity``)."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod
    from repro_torch.serve import engine as E
    tag = job[0]
    cfg = job_config(job)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params = M.init(cfg, gen, dev)
    b, s, n = (traffic[k] for k in ("batch", "prompt", "steps"))
    cache = M.init_cache(cfg, b, s + n, dev)
    prompts = torch.as_tensor(_serve_prompts(cfg, traffic), device=dev)
    extra = _serve_extra(cfg, traffic, dev)
    prefill, step = E.make_prefill_step(cfg), E.make_serve_step(cfg)
    saved, calls = moe_mod._route, []
    if cfg.n_experts:
        moe_mod._route, calls = route_probe(moe_mod)
    t0 = time.perf_counter()
    try:
        with torch.no_grad(), _in_policy(policy), \
                shard_capacity(moe_mod, job[3][0]):
            (logits, cache), launched = _counted_serve(
                lambda: prefill(params, cache, {"tokens": prompts, **extra}),
                dev)
            seen, tokens, launches = [logits.float().cpu()], [], [launched]
            for i in range(n):
                tok = torch.argmax(logits, dim=-1).to(torch.int32)
                lengths = torch.full((b,), s + i, dtype=torch.int32,
                                     device=dev)
                (logits, cache), launched = _counted_serve(
                    lambda: step(params, cache, tok[:, None], lengths), dev)
                seen.append(logits.float().cpu())
                tokens.append(tok.cpu())
                launches.append(launched)
    finally:
        moe_mod._route = saved
    torch.save({"logits": seen, "tokens": tokens,
                "routes": [c["idx"].cpu() for c in calls]},
               out_dir / f"{tag}.serve.pt")
    rec = {"launches": launches, "s": time.perf_counter() - t0,
           "peak_gb": _peak_gb(dev)}
    del params, cache
    _freed(dev)
    return rec


def _logit_gap(got, want, vocab):
    """max |got - want| over max |want| of the ``vocab`` columns of the
    vocabulary (the padded ones hold -1e30 in every run, which would be
    every step's max |logit|: ``teacher_logits``), in float32 on the
    host."""
    got, want = got[..., :vocab].float().cpu(), want[..., :vocab].float().cpu()
    return float((got - want).abs().max() / want.abs().max())


def _serve_job(rank, job, traffic, out_dir, dev_type, policy):
    """A ``SHARDED_SERVE`` job on this rank of its mesh: the same seeded
    params cut to the rank's shards, its part of the cache
    (``model.init_cache`` with the mesh), the prefill of its rows of the
    prompts and the decode steps fed its rows of the single rank's
    tokens (an MoE routed by the single rank's indices of its rows);
    each step's logits against the single rank's rows, its launches a
    step, the bytes of its arguments (params, cache and rows, as the dry
    run counts them) and its peak bytes."""
    import torch
    from repro_torch.launch import mesh as LM
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import sharding as Sh
    from repro_torch import tree
    from repro_torch.launch.dryrun import tensor_bytes
    from repro_torch.serve import engine as E
    dev = torch.device(dev_type)
    tag, _, _, shape = job
    cfg = job_config(job)
    mesh = LM.make_mesh(shape, ("data", "model"), dev_type)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    full = M.init(cfg, gen, dev)
    like = tree.map(lambda p: p.to("meta"), full)
    local = Sh.shard_params(full, mesh, cfg)
    del full
    _freed(dev)
    single = torch.load(out_dir / f"{tag}.serve.pt")
    b, s, n = (traffic[k] for k in ("batch", "prompt", "steps"))
    prompts = Sh.local_rows(torch.as_tensor(_serve_prompts(cfg, traffic),
                                            device=dev), mesh)
    extra = {k: Sh.local_rows(v, mesh)
             for k, v in _serve_extra(cfg, traffic, dev).items()}
    cache = M.init_cache(cfg, b, s + n, dev, mesh=mesh)
    held = tensor_bytes(local) + tensor_bytes(cache)
    prefill = E.make_prefill_step(cfg, mesh=mesh, params_sds=like)
    step = E.make_serve_step(cfg, mesh=mesh, params_sds=like)
    rows = lambda t: Sh.local_rows(t, mesh)  # noqa: E731
    saved = moe_mod._route
    if cfg.n_experts:
        moe_mod._route, _ = route_probe(moe_mod, pinned=rank_routes(
            single["routes"], cfg, mesh, b, dev))
    t0 = time.perf_counter()
    try:
        with torch.no_grad(), _in_policy(policy):
            (logits, cache), launched = _counted_serve(
                lambda: prefill(local, cache, {"tokens": prompts, **extra}),
                dev)
            gaps = [_logit_gap(logits, rows(single["logits"][0]),
                               cfg.vocab_size)]
            launches = [launched]
            for i in range(n):
                tok = rows(single["tokens"][i].to(dev))
                lengths = torch.full(tok.shape, s + i, dtype=torch.int32,
                                     device=dev)
                (logits, cache), launched = _counted_serve(
                    lambda: step(local, cache, tok[:, None], lengths), dev)
                gaps.append(_logit_gap(logits,
                                       rows(single["logits"][i + 1]),
                                       cfg.vocab_size))
                launches.append(launched)
    finally:
        moe_mod._route = saved
    rec = {"rank": rank, "mesh": list(shape), "heads": rank_heads(cfg, mesh),
           "gaps": gaps, "launches": launches, "s": time.perf_counter() - t0,
           "arguments": {"prefill": held + tensor_bytes(prompts) +
                         tensor_bytes(extra),
                         "decode": held + tensor_bytes(tok[:, None])},
           "peak_bytes": torch.cuda.max_memory_allocated()
           if dev.type == "cuda" else None}
    del local, cache
    _freed(dev)
    return rec


def serve_dryrun(job, traffic, rank=0):
    """The dry run (``launch/dryrun.py``) of a ``SHARDED_SERVE`` job's two
    cells, its prefill (whisper's stub frames in its inputs) and a decode
    step, traced for ``rank`` on stand-ins in this process (torch's fake
    process group; no device): {kind: (record, argument bytes by
    part)}."""
    import torch
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as LM
    shape = job[3]
    cfg = job_config(job)
    b, s, n = (traffic[k] for k in ("batch", "prompt", "steps"))
    frames = {"frames": ((b, cfg.n_frames, cfg.d_model), torch.float32)} \
        if cfg.family == "encdec" else {}
    out = {}
    with dryrun.fake_ranks(math.prod(shape), rank):
        mesh = LM.make_mesh(shape, ("data", "model"), "cpu")
        for kind, specs in (
                ("prefill", {"tokens": ((b, s), torch.int32), **frames}),
                ("decode", {"tokens": ((b, 1), torch.int32)})):
            out[kind] = dryrun.trace_cell(cfg, kind, specs, mesh,
                                          cache_len=s + n)
    return out


def serve_rank_want(launches, empty):
    """A mesh rank's launches a serving step, from the single rank's
    (``launches``, one dict a step): the same where the rank holds
    heads; on a rank without heads none of the attention kernels, and one
    gemm fewer an attention (its q product is empty; its output product,
    K = 0, launches), of the one gemm variant the step runs."""
    if not empty:
        return launches
    out = []
    for step in launches:
        calls = step.get("flash_attention", 0) + \
            step.get("decode_attention", 0)
        variants = [k for k in step if k.startswith("gemm_")]
        if len(variants) != 1:
            raise ValueError(f"a serving step of gemm variants {variants}")
        want = {k: v for k, v in step.items()
                if k not in ("flash_attention", "decode_attention")}
        for k in ("gemm", variants[0]):
            want[k] -= calls
        out.append(want)
    return out


def serve_gate(single, ranks, job, dev):
    """A ``SHARDED_SERVE`` job's gates: every rank's logits within
    ``LM_TOL`` of the job's dtype of the single rank's at every step; on the
    card its launches a step the single rank's (``serve_rank_want``: a
    rank without heads launches no attention kernel), and the dry run's
    of rank 0 and of the first rank without heads (prefill, and every
    decode step); those ranks' argument bytes the dry run's; the dry
    run's peak bytes beside rank 0's ``max_memory_allocated`` (not
    gated).  -> (record, failures)."""
    tag = job[0]
    one = single[f"serve/{tag}"]
    mine = [r[f"serve/{tag}"] for r in ranks]
    t0 = time.perf_counter()
    traced = [0] + [r["rank"] for r in mine if r["heads"] == 0][:1]
    dry = {rank: serve_dryrun(job, SERVE_TRAFFIC, rank) for rank in traced}
    dry_s = time.perf_counter() - t0
    failures = []
    tol = LM_TOL[job_config(job).dtype]
    for r in mine:
        worst = max(r["gaps"])
        if worst > tol:
            failures.append(f"sharded_serve/{tag}: rank {r['rank']}'s logits "
                            f"{worst} of max|logit| from the single rank's, "
                            f"against {tol}")
        if dev.type != "cuda":
            continue
        want = serve_rank_want(one["launches"], r["heads"] == 0)
        if r["launches"] != want:
            failures.append(f"sharded_serve/{tag}: rank {r['rank']} "
                            f"({r['heads']} heads) launched {r['launches']}, "
                            f"expected {want}")
    for rank, cells in dry.items():
        r = mine[rank]
        want = {"prefill": [r["launches"][0]], "decode": r["launches"][1:]}
        for kind, (rec, parts) in cells.items():
            if dev.type == "cuda" and any(got != rec["launches"]
                                          for got in want[kind]):
                failures.append(f"sharded_serve/{tag}: the dry run's {kind} "
                                f"launches {rec['launches']}, rank {rank}'s "
                                f"{want[kind]}")
            if sum(parts.values()) != r["arguments"][kind]:
                failures.append(f"sharded_serve/{tag}: the dry run's {kind} "
                                f"arguments {parts}, rank {rank}'s "
                                f"{r['arguments'][kind]} bytes")
    r0 = mine[0]
    peak = max(rec["peak_bytes"] for rec, _ in dry[0].values())
    record = {"mesh": r0["mesh"], "traffic": SERVE_TRAFFIC,
              "heads": [r["heads"] for r in mine],
              "max_rel_logit_gap": max(max(r["gaps"]) for r in mine),
              "gaps": [r["gaps"] for r in mine],
              "launches": {r["rank"]: r["launches"][:2] for r in mine
                           if r["rank"] in traced},
              "single_launches": one["launches"][:2],
              "dryrun": {rank: {kind: {"launches": rec["launches"],
                                       "argument_parts": parts,
                                       "peak_bytes": rec["peak_bytes"],
                                       "flops": rec["flops"],
                                       "collectives": rec["collectives"]}
                                for kind, (rec, parts) in cells.items()}
                         for rank, cells in dry.items()},
              "arguments": r0["arguments"],
              "rank_max_allocated": r0["peak_bytes"],
              "dry_peak_over_allocated": None if not r0["peak_bytes"]
              else peak / r0["peak_bytes"],
              "s": [r["s"] for r in mine], "single_s": one["s"],
              "dryrun_s": dry_s, "failures": failures}
    return record, failures


def _recording(module, name, stop=False):
    """``module.name`` wrapped to record each call's (output, args) in the
    list returned; with ``stop``, the function put back as it was."""
    fn = getattr(module, name)
    if stop:
        setattr(module, name, getattr(fn, "recorded", fn))
        return None
    calls = []

    def recorded(*a):
        out = fn(*a)
        calls.append((out, a))
        return out
    recorded.recorded = fn
    setattr(module, name, recorded)
    return calls


def model_dtype(cfg):
    import torch
    return getattr(torch, cfg.dtype)


def _no_copy_reduce(ctx, g):
    """The control's ``sharding._Copy.backward``: the copy into the model
    region without its all-reduce."""
    return g, None


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak_gb(dev):
    import torch
    return torch.cuda.max_memory_allocated() / 1e9 \
        if dev.type == "cuda" else None


def _freed(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def _no_norm_sum(x):
    """The control's ``sharding.sum_over_model``: each rank's gated norm
    over its own heads' channels alone."""
    return x


def _repeated_groups(lo, hi, glo, ghi, per, device):
    """The control's ``ssm.head_groups``: the rank's groups each repeated
    h // g times (rounded up) in order, cut to its h heads, as a rank
    that holds whole groups reads them; a straddling rank's heads then
    read some other head's group."""
    import torch
    h, g = hi - lo, ghi - glo
    return torch.arange(h, device=device) // -(-h // g)


def _planted(fault):
    """(module, attribute, stand-in) of a control's fault."""
    from repro_torch.models import sharding as Sh
    from repro_torch.models import ssm
    if fault == "copy":
        return Sh._Copy, "backward", staticmethod(_no_copy_reduce)
    if fault == "groups_repeated":
        return ssm, "head_groups", _repeated_groups
    return Sh, "sum_over_model", _no_norm_sum


def _sharded_ranks(rank, world, jobs, traffic, out_dir, controls, dev_type,
                   policy, side):
    """Each job of ``world`` ranks' two sharded steps on this rank
    (``_sharded_job``); on two ranks also ``compressed_psum`` of
    ``side["psum"]`` elements (``_psum_job``) and the pipeline of
    ``side["pipeline"]`` (``_pipeline_job``); the ``SHARDED_SERVE`` jobs
    of ``world`` ranks serve ``side["serve"]`` first (``_serve_job``);
    then each job that
    ``controls`` names again with its fault planted (``_planted``), under
    ``out["control/<tag>"]``.  ``dev_type`` and ``policy`` as
    ``_sharded_single``'s."""
    mine = [job for job in jobs if math.prod(job[3]) == world]
    out, seconds = {}, {}

    def timed(key, fn, *args):
        t0 = time.perf_counter()
        out[key] = fn(*args)
        seconds[key] = time.perf_counter() - t0
    for job in mine:
        if job[0] in SHARDED_SERVE:
            timed(f"serve/{job[0]}", _serve_job, rank, job, side["serve"],
                  out_dir, dev_type, policy)
    for job in mine:
        if job[0] not in SERVE_ONLY:
            timed(job[0], _sharded_job, rank, job, traffic, out_dir,
                  dev_type, policy)
    if world == 2:
        timed("psum", _psum_job, rank, world, dev_type, side["psum"])
        timed("pipeline", _pipeline_job, rank, world, dev_type, policy,
              side["pipeline"])
    for job in mine:
        if job[0] not in controls:
            continue
        owner, name, stand_in = _planted(controls[job[0]])
        saved = owner.__dict__[name]
        setattr(owner, name, stand_in)
        try:
            timed(f"control/{job[0]}", _sharded_job, rank, job, traffic,
                  out_dir, dev_type, policy)
        finally:
            setattr(owner, name, saved)
    out["seconds"] = seconds
    return out


def _psum_job(rank, world, dev_type, n):
    """``compressed_psum`` over a ('pod',) mesh of the ranks, of ``n``
    normals a rank (rank r's drawn from seed SEED + 100 +
    r on the card), against the reference's formula applied on this one
    rank to every rank's input (each drawn again): bitwise; host seconds
    of the collective."""
    import torch
    from repro_torch.launch import mesh as LM
    from repro_torch.optim import compression
    dev = torch.device(dev_type)
    mesh = LM.make_mesh((world,), ("pod",), dev_type)

    def draw(r):
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 100 + r)
        return torch.randn(n, generator=gen, device=dev)
    x = draw(rank)
    _sync(dev)
    t0 = time.perf_counter()
    got = compression.compressed_psum(x, mesh, "pod")
    _sync(dev)
    seconds = time.perf_counter() - t0
    xs = [draw(r) for r in range(world)]
    scale = torch.stack([torch.clamp(v.abs().max(), min=1e-12) / 127.0
                         for v in xs]).max()
    total = sum(torch.clamp(torch.round(v / scale), -127, 127)
                .to(torch.int32) for v in xs)
    want = total.to(torch.float32) * scale / float(world)
    mean = torch.stack(xs).mean(0)
    rec = {"elements": n, "bitwise": bool(torch.equal(got, want)),
           "max_abs_err": float((got - want).abs().max()),
           "max_abs_err_vs_mean": float((got - mean).abs().max()),
           "scale": float(scale), "seconds": seconds}
    del x, xs, total, want, mean, got
    _freed(dev)
    return rec


def pipeline_want(cfg, micro, backward=False):
    """Exact launches of one ``train.pipeline.pipeline`` rank over stages
    of one ``attn`` block each: a microbatch's q, k, v, o and MLP gemms,
    its activation and its flash, once each; with ``backward`` each gemm
    twice more (dA, dB; the activation's and flash's gradients launch
    nothing)."""
    mlp = 3 if cfg.gated_mlp else 2
    return {"gemm": micro * (4 + mlp) * (3 if backward else 1),
            "vsigmoid": micro * (cfg.act == "silu"),
            "vtanh": micro * (cfg.act == "gelu"),
            "flash_attention": micro, "ssd": 0}


def _pipeline_job(rank, world, dev_type, policy, spec):
    """``train.pipeline.pipeline`` over a ('pipe',) mesh of the ranks, a
    stage one ``attn`` block of ``spec`` (``PIPELINE``: its own seeded
    params, stacked on a leading stage axis), ``spec["micro"]`` seeded
    microbatches,
    bf16: forward, each rank's launches exact (``pipeline_want``) on the
    kernel tier, and on rank 0 the outputs against the blocks applied in
    turn on this one rank (bitwise, else the gap); then forward and
    backward of ``y.sum()``, launches exact, and on rank 0 every stage's
    gradient and the microbatches' against the blocks' in turn (the gap
    over each one's max |g|, ``grad_gap``: ROADMAP C.36); host seconds of
    each."""
    import torch
    from repro_torch import tree
    from repro_torch.launch import mesh as LM
    from repro_torch.models import blocks as B
    from repro_torch.train.pipeline import pipeline
    dev = torch.device(dev_type)
    cfg = sharded_config(spec["arch"], spec["cut"], "bfloat16")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    stages = [B.block_init("attn", gen, cfg, dev) for _ in range(world)]
    stacked = tree.map(lambda *xs: torch.stack(xs), *stages)
    m, b, seq = spec["micro"], spec["batch"], spec["seq"]
    x = torch.randn((m, b, seq, cfg.d_model), generator=gen,
                    device=dev).to(torch.bfloat16)
    ctx = B.Ctx(cfg=cfg, mode="train",
                positions=torch.arange(seq, device=dev).expand(b, seq))

    def stage(p, v):
        return B.block_apply("attn", p, v, None, ctx)[0]
    mesh = LM.make_mesh((world,), ("pipe",), dev_type)
    t0 = time.perf_counter()
    with torch.no_grad(), _in_policy(policy):
        y, launched, chosen = _counted_step(
            lambda: pipeline(stage, stacked, x, mesh), dev)
    seconds = time.perf_counter() - t0
    _held(launched, chosen, pipeline_want(cfg, m), cfg,
          f"sharded/pipeline/rank {rank}", dev)
    rec = {"rank": rank, "micro": m, "shape": list(x.shape[1:]),
           "launches": launched, "seconds": seconds,
           "bubble": world - 1, "ticks": m + world - 1}
    if rank == 0:
        t0 = time.perf_counter()
        with torch.no_grad(), _in_policy(policy):
            want = torch.stack([functools.reduce(
                lambda v, p: stage(p, v), stages, x[j]) for j in range(m)])
            _sync(dev)
        rec.update(sequential_seconds=time.perf_counter() - t0,
                   bitwise=bool(torch.equal(y, want)),
                   max_abs_err=float((y.float() - want.float()).abs().max()),
                   finite=bool(y.isfinite().all()))
        del want
    # the backward: every rank's gradient of the stacked stages and of x
    # is whole (summed over 'pipe')
    params = tree.map(lambda a: a.detach().requires_grad_(), stacked)
    xg = x.detach().requires_grad_()
    wrt = tree.leaves(params) + [xg]

    def backward():
        out = pipeline(stage, params, xg, mesh)
        return torch.autograd.grad(out.float().sum(), wrt)
    t0 = time.perf_counter()
    with _in_policy(policy):
        grads, launched, chosen = _counted_step(backward, dev)
    rec.update(backward_seconds=time.perf_counter() - t0,
               backward_launches=launched)
    _held(launched, chosen, pipeline_want(cfg, m, backward=True), cfg,
          f"sharded/pipeline/rank {rank} backward", dev)
    if rank == 0:
        with _in_policy(policy):
            loss = sum(functools.reduce(
                lambda v, i: stage(tree.map(lambda a: a[i], params), v),
                range(world), xg[j]).float().sum() for j in range(m))
            want = torch.autograd.grad(loss, wrt)
        gaps = [float((g.float() - w.float()).abs().max()
                      / w.float().abs().max().clamp(min=1e-30))
                for g, w in zip(grads, want)]
        rec.update(grad_gap=max(gaps), grad_leaves=len(gaps),
                   grad_finite=all(bool(g.isfinite().all()) for g in grads))
        del loss, want
    del stages, stacked, x, y, params, xg, grads
    _freed(dev)
    return rec


def launcher_start(dev):
    """Start ``python -m repro_torch.launch.train --coordinator`` as one
    host of one (``--num-hosts 1 --host-id 0``) on ``dev`` (``nccl`` on
    the card, ``gloo`` on the CPU): zamba2-1.2b ``--reduced``, 2 steps;
    -> (the process, its start time) for ``launcher_result``."""
    from repro_torch.launch import mesh as LM
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "zamba2-1.2b", "--reduced", "--steps", "2", "--batch", "2",
           "--seq", "64", "--device", dev.type, "--coordinator",
           f"127.0.0.1:{LM._free_port()}", "--num-hosts", "1",
           "--host-id", "0"]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return (subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True, cwd=ROOT),
            time.perf_counter())


def launcher_result(started, dev):
    """The launcher's last loss and seconds, raising unless it exits 0
    with a finite loss within ``SHARDED_TIMEOUT``; the process is killed
    if it outlasts it."""
    proc, t0 = started
    try:
        out, err = proc.communicate(timeout=SHARDED_TIMEOUT)
    finally:
        proc.kill()
    seconds = time.perf_counter() - t0
    found = [ln for ln in out.splitlines()
             if ln.startswith("done: step 1 loss ")]
    loss = float(found[0].split()[4]) if found else float("nan")
    if proc.returncode or not math.isfinite(loss):
        raise AssertionError(f"launcher: exit {proc.returncode}, "
                             f"{out[-500:]} {err[-2000:]}")
    return {"backend": "nccl" if dev.type == "cuda" else "gloo",
            "loss": loss, "seconds": seconds}


def rank_routes(idx, cfg, mesh, batch, dev):
    """The single-rank run's router indices ``idx``, call by call, cut to
    the tokens this rank routes (``route_probe``'s ``pinned``): its rows
    of the ``batch`` (its data shard), and under sequence parallelism its
    chunk of each row's sequence."""
    from repro_torch.models import sharding as Sh
    out = []
    for i in idx:
        i = Sh.local_rows(i.to(dev).reshape(batch, -1, i.shape[-1]), mesh)
        m = mesh.shape["model"]
        if cfg.use_sp and m > 1:
            lo, hi = Sh.chunk_range(i.shape[1], mesh.coordinate()["model"],
                                    m)
            i = i[:, lo:hi]
        out.append({"idx": i.reshape(-1, i.shape[-1])})
    return out


def _sharded_job(rank, job, traffic, out_dir, dev_type, policy):
    """One job's two sharded steps on this rank, on the card, the params
    cut from the same seeded init as the single-rank run's, an MoE routed
    by the single-rank run's indices: the first as its two parts
    (``make_sharded_grads``, then ``sharded_update``), the gradient
    between them gathered leaf by leaf to its full shape (in the model's
    dtype) and held on rank 0 against the single-rank one
    (``sharded_grad_gaps``); the second through
    ``make_sharded_train_step``.  A ``SHARDED_INT8`` job compresses its
    gradient (``compress_grads``), and its first update's int8 payload is
    held on rank 0 (``sharded_int8_gaps``).  The shapes of step 0's ssd
    calls, (b, s, heads, p, groups, n), are recorded (``ssd_shapes``)."""
    import torch
    from repro_torch import tree
    from repro_torch.launch import mesh as LM
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import sharding as Sh
    from repro_torch.optim import compression
    from repro_torch.train import loop
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(dev_type)
    tag, _, _, shape = job
    cfg = job_config(job)
    mesh = LM.make_mesh(shape, ("data", "model"), dev_type)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    full = M.init(cfg, gen, dev)
    like = tree.map(lambda p: p.to("meta"), full)
    local = loop.trainable(Sh.shard_params(full, mesh, cfg))
    del full
    _freed(dev)
    batches = _sharded_batches(cfg, dev, traffic)
    bsds = {k: v.to("meta") for k, v in batches[0].items()}
    int8 = tag in SHARDED_INT8
    tcfg = loop.TrainConfig(compress_grads=int8)
    err = loop.sharded_err_init(local, cfg, mesh, like) if int8 else None
    saved = moe_mod._route
    try:
        if cfg.n_experts:
            pinned = rank_routes(torch.load(out_dir / f"{tag}.routes.pt"),
                                 cfg, mesh, traffic["batch"], dev)
            moe_mod._route, _ = route_probe(moe_mod, pinned=pinned)
        grads_fn = loop.make_sharded_grads(cfg, tcfg, mesh, like, bsds)
        lay = grads_fn.layout
        opt = loop.sharded_opt_init(local, cfg, mesh, like)
        step = loop.make_sharded_train_step(cfg, tcfg, mesh, like, bsds)
        heads = rank_heads(cfg, mesh)
        want = sharded_want(cfg, traffic["seq"], empty=heads == 0)
        # step 1 is the step's two parts, its gradient gathered and held
        # to the single rank's between them (not timed)
        t0 = time.perf_counter()
        with _in_policy(policy), ssd_shapes() as ssd_seen:
            (loss, aux, grads), launched, chosen = _counted_step(
                lambda: grads_fn(local, batches[0]), dev)
        step_s = [time.perf_counter() - t0]
        _held(launched, chosen, want, cfg,
              f"sharded/{tag}/rank {rank} step 0", dev)
        gaps = sharded_grad_gaps(grads, lay, mesh, like, cfg, rank,
                                 out_dir / f"{tag}.grads.pt")
        seen = _recording(compression, "compress_sharded") if int8 else []
        t0 = time.perf_counter()
        try:
            local, opt, err, om = loop.sharded_update(
                grads, opt, local, lay, tcfg.optim, err)
            _sync(dev)
        finally:
            _recording(compression, "compress_sharded", stop=True)
        step_s[0] += time.perf_counter() - t0
        int8_gaps = sharded_int8_gaps(seen[0], lay, mesh, rank,
                                      out_dir / tag) if int8 else None
        del grads, seen
        metrics = [{"loss": loss, "aux": aux, **om}]
        launches = [launched]
        for s, b in enumerate(batches[1:], 1):
            t0 = time.perf_counter()
            with _in_policy(policy):
                (local, opt, err, m), launched, chosen = _counted_step(
                    lambda: step(local, opt, err, b), dev)
            step_s.append(time.perf_counter() - t0)
            _held(launched, chosen, want, cfg,
                  f"sharded/{tag}/rank {rank} step {s}", dev)
            metrics.append(m)
            launches.append(launched)
        metrics = [{k: float(v) for k, v in m.items()} for m in metrics]
    finally:
        moe_mod._route = saved
    rec = {"rank": rank, "mesh": list(shape), "heads": heads, "gaps": gaps,
           "metrics": metrics, "launches": launches, "step_s": step_s,
           "ssd_shapes": sorted(ssd_seen),
           "local_params": M.count_params(local),
           "zero1_leaves": sum(bool(lay.zero1_dims(i))
                               for i in range(len(lay.shapes))),
           "opt_elems": sum(x.numel() for x in tree.leaves(opt["m"])),
           "peak_gb": _peak_gb(dev), "int8": int8_gaps}
    del local, opt, err
    _freed(dev)
    return rec


def sharded_grad_gaps(grads, layout, mesh, like, cfg, rank, path):
    """Each leaf's gradient (this rank's shards, ``grads``) gathered to its
    full shape in the model's dtype (every rank takes part) and, on rank
    0, its max |g - g_single| over the single-rank leaf's max |g| (the
    single-rank gradient read leaf by leaf from ``path``); {} elsewhere."""
    import torch
    from repro_torch.models import sharding as Sh
    want = torch.load(path, mmap=True) if rank == 0 else None
    gaps = {}
    for name, g, spec, shape, w in zip(
            leaf_names(like), grads, layout.pspecs, layout.shapes,
            want if want is not None else [None] * len(grads)):
        whole = Sh.gather(g.to(model_dtype(cfg)), spec, mesh, shape)
        if w is not None:
            w = w.to(whole.device).float()
            scale = float(w.abs().max())
            err = float((whole.float() - w).abs().max())
            gaps[name] = err / scale if scale else \
                (0.0 if err == 0 else float("inf"))
        del whole
    return gaps


INT8_SCALE_TOL = 1e-6


def sharded_int8_gaps(seen, layout, mesh, rank, stem):
    """Step 0's compression on the mesh (``seen``: ``compress_sharded``'s
    (output, args) of this rank's ZeRO-1 slices), each leaf gathered
    whole (every rank takes part) and read on rank 0 against
    ``compression.compress`` of the whole leaf on one rank (the
    reference's formula on the same gradient): each scale's relative gap
    and the q elements off by one and by more.  The control, each slice
    scaled by its own max (no all-reduce), read against the same.  And,
    as readings, the gaps to the single-rank step's own payload
    (``stem``.q.pt and the scales in the single run's record; its bf16
    gradient is not this run's).  {} on the other ranks."""
    import torch
    from repro_torch.models import sharding as Sh
    from repro_torch.optim import compression
    (packed, _), (gs, errs, _, axes, _) = seen
    if len(set(layout.groups)) != len(layout.groups):
        raise ValueError("the whole-leaf int8 check takes a model whose "
                         "leaves each have a scale of their own (one "
                         "pattern unit)")
    control = compression.compress_sharded(gs, errs, mesh,
                                           [()] * len(gs))[0]["scale"]
    q_single = torch.load(f"{stem}.q.pt", mmap=True) if rank == 0 else None
    rows = []
    for i, (g, e, q) in enumerate(zip(gs, errs, packed["q"])):
        spec, shape = layout.ospecs[i], layout.shapes[i]
        whole = Sh.gather(g.to(torch.float32) + e, spec, mesh, shape)
        qw = Sh.gather(q.to(torch.int32), spec, mesh, shape)
        if rank == 0:
            want, _ = compression.compress([whole])
            s, w = float(packed["scale"][i]), float(want["scale"][0])
            d = (qw - want["q"][0].to(torch.int32)).abs()
            d1 = (qw - q_single[i].to(qw.device, torch.int32)).abs()
            rows.append({"scale": s, "scale_gap": abs(s - w) / w,
                         "control_gap": abs(float(control[i]) - w) / w,
                         "q_off1": int((d == 1).sum()),
                         "q_far": int((d > 1).sum()),
                         "elems": d.numel(),
                         "single_q_off1": int((d1 == 1).sum()),
                         "single_q_far": int((d1 > 1).sum())})
        del whole, qw
    return {"leaves": rows} if rank == 0 else {}


def int8_gate(single, ranks, tag):
    """The int8 gate of a ``SHARDED_INT8`` job from rank 0's
    ``sharded_int8_gaps``: every leaf's scale within ``INT8_SCALE_TOL`` of
    the whole-leaf formula's and q within one step of it; the per-slice
    control must miss the scale gate.  -> (record, failures)."""
    rows = ranks[0][tag]["int8"]["leaves"]
    elems = sum(r["elems"] for r in rows)
    scales = single[tag]["scales"]
    rec = {"leaves": len(rows),
           "max_scale_gap": max(r["scale_gap"] for r in rows),
           "q_off1_share": sum(r["q_off1"] for r in rows) / elems,
           "q_far": sum(r["q_far"] for r in rows),
           "control_max_scale_gap": max(r["control_gap"] for r in rows),
           "control_leaves_off": sum(r["control_gap"] > INT8_SCALE_TOL
                                     for r in rows),
           "single_scale_gap_median": statistics.median(
               abs(r["scale"] - w) / w for r, w in zip(rows, scales)),
           "single_scale_gap_max": max(
               abs(r["scale"] - w) / w for r, w in zip(rows, scales)),
           "single_q_off1_share": sum(r["single_q_off1"] for r in rows)
           / elems,
           "single_q_far_share": sum(r["single_q_far"] for r in rows)
           / elems}
    failures = []
    if rec["max_scale_gap"] > INT8_SCALE_TOL or rec["q_far"]:
        failures.append(f"sharded/{tag}: the mesh's int8 payload is off the "
                        f"whole-leaf formula's ({rec})")
    if rec["control_leaves_off"] == 0:
        failures.append(f"sharded/{tag}: a per-slice scale passed the int8 "
                        "gate")
    return rec, failures


def sharded_gate(single, ranks, tag, rel_tol, leaf_tol=None):
    """The gaps of a sharded run to the single-rank one: the loss of each
    step and its ``grad_norm`` (relative), and step 0's per-leaf
    gradient gaps (each over the single-rank leaf's max |g|): with
    ``leaf_tol`` the median leaf within ``rel_tol`` and the worst within
    ``leaf_tol`` (the bf16 gate), else every leaf within ``rel_tol``.
    Every rank's launches and metrics must agree.  -> (record,
    failures)."""
    one = single[tag]
    r0 = ranks[0][tag]
    failures = []
    gaps = {}
    for s, (a, b) in enumerate(zip(r0["metrics"], one["metrics"])):
        for k in ("loss", "grad_norm"):
            gaps[f"step{s + 1}_{k}"] = abs(a[k] - b[k]) / abs(b[k])
    for r in ranks[1:]:
        if r[tag]["metrics"] != r0["metrics"]:
            failures.append(f"sharded/{tag}: rank {r[tag]['rank']}'s metrics "
                            f"{r[tag]['metrics']} differ from rank 0's")
    failures += [f"sharded/{tag}: {k} {v} from the single-rank step's, "
                 f"against {rel_tol}" for k, v in gaps.items()
                 if v > rel_tol]
    leaf = r0["gaps"]
    order = sorted(leaf, key=lambda k: -leaf[k])
    median = statistics.median(leaf.values())
    if leaf_tol is None:
        failures += [f"sharded/{tag}: {k}'s gradient is {leaf[k]} of its "
                     f"max from the single-rank one, against {rel_tol}"
                     for k in order if leaf[k] > rel_tol][:4]
    else:
        if median > rel_tol:
            failures.append(f"sharded/{tag}: the median leaf's gradient is "
                            f"{median} of its max from the single-rank one,"
                            f" against {rel_tol}")
        if leaf[order[0]] > leaf_tol:
            failures.append(f"sharded/{tag}: {order[0]}'s gradient is "
                            f"{leaf[order[0]]} of its max from the "
                            f"single-rank one, against {leaf_tol}")
    record = {"mesh": r0["mesh"], "single": one, "rel_gap": gaps,
              "leaves": len(leaf), "median_rel_leaf_err": median,
              "max_rel_leaf_err": leaf[order[0]], "worst_leaf": order[0],
              "worst_8": {k: float(f"{leaf[k]:.3g}") for k in order[:8]},
              "ranks": [{k: r[tag][k] for k in ("rank", "heads", "launches",
                                                "step_s", "local_params",
                                                "zero1_leaves", "opt_elems",
                                                "peak_gb", "ssd_shapes")}
                        for r in ranks],
              "metrics": r0["metrics"], "failures": failures}
    return record, failures


def sharded_phase(dev, policy=None):
    """``make_sharded_train_step`` on ranks that share the card
    (``launch.mesh.run_ranks``: gloo, every collective and the whole run
    under a timeout): mistral-large-123b at full width cut to one of its
    88 layers on a (2, 2) mesh of four ranks (FSDP, data, tensor and
    sequence parallelism: each layer gathered to its TP-only shard, the
    stream cut over the sequence), granite-moe-1b-a400m at full width, 12
    of its 24 layers, on (1, 2) (``linear_rp``'s bf16 TP branch, 16 of 32
    experts a rank, the vocab-parallel embedding and head) and gemma3-1b at full
    width, one pattern unit, on (2, 1) (data parallelism with ZeRO-1:
    each rank's optimizer and error state a slice of its leaves, the
    updated slices all-gathered back; the gradient int8-compressed),
    and tensor parallelism over (1, 2) of every other block kind at full
    width: zamba2-1.2b's one pattern unit (mamba, with the ssd kernel on
    each rank's SSM heads, and mamba_shared), deepseek-v2-lite's first
    two layers (MLA, moe_dense, moe), whisper-tiny whole (enc, dec) and
    gemma3-1b's unit again (its one kv head split over the ranks), and
    whisper-tiny on (1, 4), its 6 heads split unevenly (2 / 2 / 2 / 0),
    and granite at full width, 12 of its 24 layers, on (2, 2) (its
    single rank dispatching as the two data shards do,
    ``shard_capacity``),
    bf16, ``SHARDED_TRAFFIC``, each held to the same model's single-rank step
    from the same seeded weights and tokens, run first in a process of
    its own: the loss of both steps and their grad_norm within 3e-2, step
    0's gradient leaf by leaf (median within 3e-2, worst within 0.3),
    every rank's gemm, vsigmoid, vtanh, flash and ssd launches of each
    step exact (``sharded_want`` of the rank's heads) and on the kernel
    tier (MLA's attention
    on the vector tier), the optimizer state of each ``SHARDED_ZERO1``
    job sliced, and each ``SHARDED_INT8`` job's int8 payload the
    whole-leaf formula's (``int8_gate``: a per-slice scale must miss
    it).  Then in float32 (granite 4 layers on (1, 2), mistral reduced on
    (2, 2), zamba2 reduced on (1, 4), granite reduced with sequence
    parallelism through its moe blocks on (1, 2), and zamba2 reduced with
    SSM heads that straddle SSM groups on (1, 4), every rank's ssd calls
    one group a head, ``SHARDED_STRADDLED``) every leaf within
    2e-4; then, in the same ranks, the controls (``SHARDED_CONTROLS``):
    the float32 granite run with the copy into the model region reduced
    by nothing backward, the float32 zamba2 run with the gated norm's
    sum over 'model' dropped and the straddled run with each rank's
    groups read by the h // g repeat, each of which must fail that gate.  The
    two ranks also run ``compressed_psum`` (``_psum_job``: bitwise
    the formula on one rank) and ``train/pipeline.py`` (``_pipeline_job``:
    bitwise the blocks in turn, launches exact, and its backward's
    gradients within 3e-2 of the blocks' in turn); the launcher with
    ``--coordinator`` runs beside the single-rank steps (``launcher_start``,
    ``launcher_result``; its seconds, and theirs, are taken side by side).
    The routing of every MoE run (granite's, deepseek's) is pinned to the
    single-rank run's (``rank_routes``).  The ``SHARDED_SERVE`` jobs
    also serve on their ranks (``_serve_job``: prefill and decode on the
    mesh, each rank held to the single rank's ``_serve_single``), and
    the dry run of their cells is traced here and held to the launches
    and argument bytes of rank 0 and of the first rank without heads
    (``serve_gate``); ``SERVE_ONLY`` jobs only serve.  (``policy`` and
    ``dev`` let the CPU tests run it on reduced configs; on the CPU no
    kernel launches, so only the tiers are held.)"""
    import shutil
    from repro_torch.launch import mesh as LM
    out_dir = ROOT / "build" / "sharded"
    out_dir.mkdir(parents=True, exist_ok=True)
    _freed(dev)
    jobs = SHARDED + SHARDED_F32
    worlds = sorted({math.prod(job[3]) for job in jobs} | {2})
    t0 = time.perf_counter()
    ranks_s = {}
    launcher = launcher_start(dev)
    try:
        single = LM.run_ranks(_sharded_single, 1, jobs, SHARDED_TRAFFIC,
                              out_dir, dev.type, policy, SERVE_TRAFFIC,
                              timeout=SHARDED_TIMEOUT)[0]
        single_s = time.perf_counter() - t0
        by_world = {}
        for world in worlds:
            t0 = time.perf_counter()
            by_world[world] = LM.run_ranks(
                _sharded_ranks, world, jobs, SHARDED_TRAFFIC, out_dir,
                SHARDED_CONTROLS, dev.type, policy,
                {"psum": SHARDED_PSUM, "pipeline": PIPELINE,
                 "serve": SERVE_TRAFFIC},
                timeout=SHARDED_TIMEOUT)
            ranks_s[world] = time.perf_counter() - t0
        launched = launcher_result(launcher, dev)
    finally:
        launcher[0].kill()
        shutil.rmtree(out_dir, ignore_errors=True)
    ranks_of = {job[0]: by_world[math.prod(job[3])] for job in jobs}
    two = by_world[2]
    records, failures = {}, []
    trained = [tag for tag, *_ in SHARDED if tag not in SERVE_ONLY]
    for tag in trained:
        records[tag], bad = sharded_gate(single, ranks_of[tag], tag,
                                         TRAIN_TOL, TRAIN_LEAF_TOL)
        failures += bad
    for tag in SHARDED_ZERO1:
        sliced = [(r[tag]["zero1_leaves"], r[tag]["opt_elems"],
                   r[tag]["local_params"]) for r in ranks_of[tag]]
        records[tag]["zero1"] = sliced
        if any(n == 0 or e >= p for n, e, p in sliced):
            failures.append(f"sharded/{tag}: ZeRO-1 sliced no optimizer "
                            f"state ((leaves, elements, params) {sliced})")
    for tag in SHARDED_INT8:
        records[tag]["int8"], bad = int8_gate(single, ranks_of[tag], tag)
        failures += bad
    for tag, *_ in SHARDED_F32:
        records[tag], bad = sharded_gate(single, ranks_of[tag], tag,
                                         LM_TOL["float32"])
        failures += bad
    # a straddling job's ssd runs one group a head on every rank: (b, s,
    # h, p, h, n), h its share of the SSM heads
    for job in jobs:
        if job[0] in SHARDED_STRADDLED:
            cfg = job_config(job)
            h = cfg.ssm_heads // job[3][1]
            want = [(SHARDED_TRAFFIC["batch"], SHARDED_TRAFFIC["seq"], h,
                     cfg.ssm_headdim, h, cfg.ssm_state)]
            got = [r[job[0]]["ssd_shapes"] for r in ranks_of[job[0]]]
            if any(list(map(tuple, g)) != want for g in got):
                failures.append(f"sharded/{job[0]}: ssd ran at {got} on its "
                                f"ranks, not one group a head, {want}")
    # each control must fail its job's gate, on the leaves its fault
    # reaches: the router's and the norms' (the copy), the mamba blocks'
    # (the gated norm's sum, the groups repeated)
    reached = {"copy": lambda k: k.endswith("router") or "::ln" in k,
               "norm_sum": lambda k: "::mamba::" in k,
               "groups_repeated": lambda k: "::mamba::" in k}
    for ctag, fault in SHARDED_CONTROLS.items():
        control = [{ctag: r.pop(f"control/{ctag}")} for r in ranks_of[ctag]]
        key = "control" if fault == "copy" else f"control_{fault}"
        records[key], caught = sharded_gate(single, control, ctag,
                                            LM_TOL["float32"])
        records[key].pop("single")
        caught_leaves = sorted(k for k, v in control[0][ctag]["gaps"].items()
                               if v > LM_TOL["float32"])
        records[key]["failed_leaves"] = caught_leaves
        if not caught or not any(map(reached[fault], caught_leaves)):
            failures.append(f"sharded/{key}: the {fault} fault in {ctag} "
                            f"passed the gate ({caught_leaves})")
    records["psum"] = [r["psum"] for r in two]
    if not all(r["bitwise"] for r in records["psum"]):
        failures.append(f"sharded/psum: compressed_psum is not the formula "
                        f"on one rank bitwise ({records['psum']})")
    records["pipeline"] = [r["pipeline"] for r in two]
    head = records["pipeline"][0]
    if not (head["bitwise"] and head["finite"]):
        failures.append(f"sharded/pipeline: the pipeline's outputs are not "
                        f"the blocks' in turn bitwise ({head})")
    if not (head["grad_finite"] and head["grad_gap"] <= LM_TOL["bfloat16"]):
        failures.append(f"sharded/pipeline: the pipeline's gradient is "
                        f"{head['grad_gap']} of its max from the blocks' in "
                        f"turn, against {LM_TOL['bfloat16']}")
    records["serve"] = {}
    for job in jobs:
        if job[0] in SHARDED_SERVE:
            records["serve"][job[0]], bad = serve_gate(
                single, ranks_of[job[0]], job, dev)
            failures += bad
    records["launcher"] = launched
    launches = {op: sum(n[op] for tag in trained
                        for r in ranks_of[tag] for n in r[tag]["launches"])
                + sum(r["pipeline"]["launches"][op] for r in two)
                for op in SHARDED_OPS}
    # each job's host seconds: the single rank's, and rank 0's of each
    # group of ranks (a group's ranks_s is its jobs' and its processes'
    # start)
    job_s = {"single": single["seconds"],
             **{world: by_world[world][0]["seconds"] for world in worlds}}
    emit("sharded", traffic=SHARDED_TRAFFIC, single_s=single_s,
         ranks_s=ranks_s, job_s=job_s, launches=launches,
         want={job[0]: sharded_want(job_config(job, "bfloat16"),
                                    SHARDED_TRAFFIC["seq"])
               for job in SHARDED if job[0] in trained}, **records)
    if failures:
        raise AssertionError("; ".join(failures))
    return {"launches": launches, **records}


def guard_phase(dev, module):
    """Every one of the thirteen kernel entries, called on a CUDA input
    that requires grad with grad mode on, raises RuntimeError naming its
    op and launches nothing."""
    import torch
    rng = np.random.default_rng(SEED + 5)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    refused = {}
    for op in ALL_OPS + LM_OPS:
        args = on(figure2_args(op, rng), dev) if op in ALL_OPS else \
            lm_time_args(op, gen, dev)
        args = (args[0].detach().requires_grad_(True),) + tuple(args[1:])
        mod = module[op]
        before = dict(mod.LAUNCHES)
        try:
            mod.KERNELS[op](*args)
        except RuntimeError as e:
            if op not in str(e):
                raise AssertionError(f"guard: {op} raised {e!r}") from e
            refused[op] = str(e)[:60]
        else:
            raise AssertionError(f"guard: {op} launched on an input that "
                                 "requires grad")
        if mod.LAUNCHES != before:
            raise AssertionError(f"guard: {op} launched before it raised")
    emit("guard", refused=sorted(refused))
    return refused


def time_gemm_parts(k, n, m, label, r, flush):
    """The ``time`` rows of a train step's three gemm calls against a (k,
    n) weight at m rows, bf16 (``r(*shape, scale)`` draws an operand):
    the forward and its backward products dA = dY B^T and dB = A^T dY
    (on the transposed copies the backward makes), each held to its plain
    version (MM_TOL) and timed beside it, torch.matmul and the card's
    bound."""
    import torch
    from repro_torch.kernels import cost, gemm
    bf = torch.bfloat16
    rows = {}
    x, w, g = r(m, k), r(k, n, scale=k ** -0.5), r(m, n)
    for part, (a, b) in (("fwd", (x, w)), ("da", (g, w.t().contiguous())),
                         ("db", (x.t().contiguous(), g))):
        m_, k_ = a.shape
        n_ = b.shape[1]
        size = f"{label}_{part}_{k}x{n}"
        out = gemm.gemm(a, b)
        err = compare(f"gemm/{size}", out, gemm.gemm_plain(a, b))
        k_ms = time_ms(lambda: gemm.gemm(a, b), flush)
        p_ms = time_ms(lambda: gemm.gemm_plain(a, b), flush)
        l_ms = time_ms(lambda: torch.matmul(a, b), flush)
        b_ms, b_by, nbytes, n_ops = cost.bound("gemm", (a, b), out)
        del out
        row = {"op": "gemm", "size": size, "dtype": "bfloat16",
               "shapes": [[m_, k_], [k_, n_]],
               "variant": gemm.variant(bf, m_), "max_abs_err": err,
               "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
               "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
               "ops": n_ops, "bound_share": b_ms / k_ms,
               "library_ratio": k_ms / l_ms}
        rows[("gemm", row["size"])] = row
        emit("time", **row)
    return rows


def time_train(gen, dev, flush):
    """The ``time`` rows of the train path's kernel calls at zamba2's train
    shapes (``TRAIN_M`` rows a microbatch), bf16, each output held to its
    plain version's on the same inputs (``compare``: MM_TOL, TOL and
    LM_TOL's bf16), and timed beside it, the library call and the card's
    bound."""
    import torch
    from repro_torch.kernels import cost
    from repro_torch.kernels import elementwise as ew
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd
    bf = torch.bfloat16
    rows = {}

    def r(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(bf)
    for k, n in SERVE_GEMM:
        rows.update(time_gemm_parts(k, n, TRAIN_M, "train", r, flush))
    s, b_ = TRAIN["seq"], TRAIN["batch"] // TRAIN["accum"]
    x = 2.0 * r(b_, s, 8192)
    y = ew.vtanh(x)
    err = compare("vtanh", y, ew.vtanh_plain(x))
    k_ms = time_ms(lambda: ew.vtanh(x), flush)
    p_ms = time_ms(lambda: ew.vtanh_plain(x), flush)
    l_ms = time_ms(lambda: torch.tanh(x), flush)
    b_ms, b_by, nbytes, n_ops = cost.bound("vtanh", (x,), y)
    del y
    row = {"op": "vtanh", "size": "train_gelu", "dtype": "bfloat16",
           "shape": list(x.shape), "max_abs_err": err, "kernel_ms": k_ms,
           "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": b_ms,
           "bound_by": b_by, "bytes": nbytes, "ops": n_ops,
           "bound_share": b_ms / k_ms}
    rows[("vtanh", "train_gelu")] = row
    emit("time", **row)
    del x
    h, hkv, d = LM_SHAPES["zamba2"]["attn"]
    g_, n_ = LM_SHAPES["zamba2"]["ssd"]
    dt = torch.nn.functional.softplus(
        torch.randn((b_, s, 64), generator=gen, device=dev) - 1.0)
    lm = {"flash_attention": (r(b_, s, h, d), r(b_, s, hkv, d),
                              r(b_, s, hkv, d), True, None, None),
          "ssd": (r(b_, s, 64, 64), dt,
                  -torch.arange(1, 65, dtype=torch.float32, device=dev),
                  r(b_, s, g_, n_, scale=0.5), r(b_, s, g_, n_, scale=0.5),
                  torch.ones(64, device=dev))}
    for op, targs in lm.items():
        mod = fa if op == "flash_attention" else ssd
        out = mod.KERNELS[op](*targs)
        if not bool(out.isfinite().all()):
            raise AssertionError(f"{op}/train: non-finite output")
        err = compare(op, out, mod.PLAIN[op](*targs))
        k_ms = time_ms(lambda: mod.KERNELS[op](*targs), flush)
        p_ms = time_ms(lambda: mod.PLAIN[op](*targs), flush)
        lib = lm_library_call(op, targs)
        l_ms = None if lib is None else time_ms(lib, flush)
        b_ms, b_by, nbytes, n_ops = cost.bound(op, targs, out)
        row = {"op": op, "size": "train", "dtype": "bfloat16",
               "shapes": [list(a.shape) for a in targs
                          if isinstance(a, torch.Tensor)],
               "max_abs_err": err, "kernel_ms": k_ms, "plain_ms": p_ms,
               "library_ms": l_ms, "bound_ms": b_ms, "bound_by": b_by,
               "bytes": nbytes, "ops": n_ops, "bound_share": b_ms / k_ms}
        rows[(op, "train")] = row
        emit("time", **row)
        del out
    return rows


def time_sharded(gen, dev, flush):
    """The ``time`` rows of the sharded path's kernel calls at its local
    shapes (``SHARDED_GEMM``, ``SHARDED_FLASH``, ``SHARDED_DECODE``,
    ``SHARDED_SILU``, ``SHARDED_SSD``), bf16 (ssd in its job's dtype: the
    straddled job's float32), each output held to its
    plain version's and timed beside it, the library call and the card's
    bound."""
    import torch
    from repro_torch.kernels import cost
    from repro_torch.kernels import elementwise as ew
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd
    bf = torch.bfloat16
    rows = {}

    def r(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(bf)
    for arch, (m, shapes) in SHARDED_GEMM.items():
        for k, n in shapes:
            rows.update(time_gemm_parts(k, n, m, f"sharded_{arch}", r, flush))
    lm = [("flash_attention", arch, (r(b, s, h, d), r(b, s, hkv, d),
                                     r(b, s, hkv, d), causal, None, None))
          for arch, (b, s, h, hkv, d, causal) in SHARDED_FLASH.items()]
    lm += [("decode_attention", arch, (
        r(b, 1, h, d), r(b, s, hkv, d), r(b, s, hkv, d),
        torch.full((b,), 512, dtype=torch.int32, device=dev), None, None))
        for arch, (b, s, h, hkv, d) in SHARDED_DECODE.items()]
    for arch, (b, s, h, p, g, n, dtype) in SHARDED_SSD.items():
        dt = torch.nn.functional.softplus(
            torch.randn((b, s, h), generator=gen, device=dev) - 1.0)
        to = getattr(torch, dtype)
        lm.append(("ssd", arch, (
            r(b, s, h, p).to(to), dt,
            -torch.arange(1, h + 1, dtype=torch.float32, device=dev),
            r(b, s, g, n, scale=0.5).to(to), r(b, s, g, n, scale=0.5).to(to),
            torch.ones(h, device=dev))))
    for op, arch, targs in lm:
        mod = ssd if op == "ssd" else fa
        out = mod.KERNELS[op](*targs)
        if not bool(out.isfinite().all()):
            raise AssertionError(f"{op}/sharded_{arch}: non-finite output")
        err = compare(op, out, mod.PLAIN[op](*targs))
        k_ms = time_ms(lambda: mod.KERNELS[op](*targs), flush)
        p_ms = time_ms(lambda: mod.PLAIN[op](*targs), flush)
        lib = lm_library_call(op, targs)
        l_ms = None if lib is None else time_ms(lib, flush)
        b_ms, b_by, nbytes, n_ops = cost.bound(op, targs, out)
        row = {"op": op, "size": f"sharded_{arch}",
               "dtype": str(targs[0].dtype).replace("torch.", ""),
               "shapes": [list(a.shape) for a in targs
                          if isinstance(a, torch.Tensor)],
               "max_abs_err": err, "kernel_ms": k_ms, "plain_ms": p_ms,
               "library_ms": l_ms, "bound_ms": b_ms, "bound_by": b_by,
               "bytes": nbytes, "ops": n_ops, "bound_share": b_ms / k_ms}
        rows[(op, row["size"])] = row
        emit("time", **row)
        del out, targs
    del lm
    for label, shape in SHARDED_SILU.items():
        x = r(*shape, scale=2.0)
        y = ew.vsigmoid(x)
        err = compare("vsigmoid", y, ew.vsigmoid_plain(x))
        k_ms = time_ms(lambda: ew.vsigmoid(x), flush)
        p_ms = time_ms(lambda: ew.vsigmoid_plain(x), flush)
        l_ms = time_ms(lambda: torch.sigmoid(x), flush)
        b_ms, b_by, nbytes, n_ops = cost.bound("vsigmoid", (x,), y)
        del y
        row = {"op": "vsigmoid", "size": f"sharded_{label}",
               "dtype": "bfloat16", "shape": list(shape), "max_abs_err": err,
               "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
               "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
               "ops": n_ops, "bound_share": b_ms / k_ms}
        rows[("vsigmoid", row["size"])] = row
        emit("time", **row)
        del x
    return rows


def time_only(ops, dev):
    """``--times``: build and time only ``ops``, on inputs made as main()
    makes them, with no launch plans printed.  With ``--src`` this times
    another checkout's kernels, so that two commits can be compared in
    one call."""
    import torch
    from repro_torch.kernels import conv, gemm, ibilinear, pooling
    module = {"gemm": gemm, "conv_hwc": conv, "dwconv": conv,
              "maxpool": pooling, "argmaxpool": pooling,
              "ibilinear": ibilinear}
    unknown = set(ops) - set(module)
    if unknown:
        raise SystemExit(f"chip_smoke: --times takes {sorted(module)}, not "
                         f"{sorted(unknown)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(SEED)
    args = {op: on(figure2_args(op, rng), dev) for op in ALL_OPS}
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    time_figure2(ops, module, args, gen, dev, flush, plans=False)
    return 0


def main(argv=None) -> int:
    import argparse
    import torch
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--times", default="", help="comma-separated ops: "
                        "only build and time these (e.g. maxpool,ibilinear)")
    parser.add_argument("--port", action="store_true", help="only run the "
                        "corpus phases (port, port_compiled, port_serve): no "
                        "build, no result line")
    parser.add_argument("--src", default=str(ROOT / "src"), help="the src/ "
                        "directory whose repro_torch is run (default: the "
                        "one beside this script)")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this run needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    src = Path(opts.src).resolve()
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: no repro_torch under {src}; run it from a "
              "checkout of the repo", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    if opts.times:
        emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
             src=str(src))
        return time_only(opts.times.split(","), torch.device("cuda"))
    if opts.port:
        from repro_torch.kernels import conv, gemm, ibilinear, pooling, ssd
        from repro_torch.kernels import elementwise as ew
        from repro_torch.kernels import flash_attention as fa
        emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
             torch=torch.__version__, cuda=torch.version.cuda)
        modules = (ew, gemm, conv, pooling, ibilinear, fa, ssd)
        dev = torch.device("cuda")
        port_compiled_phase(dev, modules, port_phase(dev, modules))
        port_serve_phase(dev, modules)
        return 0
    from repro_torch.core import trace, use_target
    from repro_torch.core.registry import REGISTRY, TIERS
    from repro_torch.kernels import _build, conv, cost, gemm, ibilinear, \
        ops, pooling, ref, ssd
    from repro_torch.kernels import elementwise as ew
    from repro_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    module = {"gemm": gemm, "conv_hwc": conv, "dwconv": conv,
              "maxpool": pooling, "argmaxpool": pooling,
              "ibilinear": ibilinear, **{op: ew for op in EW_OPS},
              "flash_attention": fa, "decode_attention": fa, "ssd": ssd}
    modules = (ew, gemm, conv, pooling, ibilinear, fa, ssd)

    # 1. device ---------------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    # 2. build: one nvcc per source, all started together ----------------
    t0 = time.perf_counter()
    libs = _build.build_all()
    for m in modules:
        m._lib()
    emit("build", seconds=time.perf_counter() - t0,
         libraries={k: str(v.relative_to(ROOT)) for k, v in libs.items()})

    # 3. every kernel against its plain version on the card -------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    # the Figure-2 size, odd sizes around the vector and the block, and
    # the gelu's shapes in zamba2's prefill and decode (bf16 serves them)
    cases = [(s, dt) for s in ((1024, 1024), (1,), (7,), (127,), (8191,),
                               (8193,), (3, 5, 7), (4, 1, 8192),
                               (4, 512, 8192), (1 << 26,))
             for dt in (torch.float32, torch.bfloat16)]
    # vsigmoid also at the silu's shapes in deepseek's and minicpm3's
    # serving (SILU_SHAPES)
    silu_cases = [(shape, dt) for _, shape in SILU_SHAPES
                  for dt in (torch.float32, torch.bfloat16)]
    # and both at the gelu's and silu's shapes of gemma2, gemma3, whisper
    # and pixtral (NEW_EW_SHAPES), vtanh at gemma2's final softcap, whose
    # logits are float32 in either model dtype
    new_cases = {op: [(shape, dt) for o, _, shape in NEW_EW_SHAPES
                      if o == op for dt in (torch.float32, torch.bfloat16)]
                 for op in EW_OPS}
    new_cases["vtanh"] += [(shape, torch.float32)
                           for _, shape in SOFTCAP_SHAPES]
    max_err = {}
    for op in EW_OPS:
        errs = []
        for shape, dt in cases + new_cases[op] + \
                (silu_cases if op == "vsigmoid" else []):
            x = workload(op, torch.randn(shape, generator=gen,
                                         device=dev)).to(dt)
            err = compare(op, ew.KERNELS[op](x, *extra_args(op)),
                          ew.PLAIN[op](x, *extra_args(op)))
            errs.append({"shape": list(shape), "dtype": str(dt)[6:],
                         "max_abs_err": err})
            if shape == (1024, 1024) and dt == torch.float32:
                max_err[op] = err
        for dt in (torch.float32, torch.bfloat16):
            # a view one element into its storage: not 16-byte aligned,
            # so the kernel takes its one-element-per-step path
            x = workload(op, torch.randn(4099, generator=gen,
                                         device=dev)).to(dt)[1:]
            err = compare(op, ew.KERNELS[op](x, *extra_args(op)),
                          ew.PLAIN[op](x, *extra_args(op)))
            errs.append({"shape": "unaligned[4098]", "dtype": str(dt)[6:],
                         "max_abs_err": err})
            x = torch.tensor(EDGE, dtype=dt, device=dev)
            err = compare(op, ew.KERNELS[op](x, *extra_args(op)),
                          ew.PLAIN[op](x, *extra_args(op)))
            errs.append({"shape": "edge", "dtype": str(dt)[6:],
                         "max_abs_err": err})
        torch.cuda.synchronize()
        emit("kernel_vs_plain", op=op, tolerance=TOL, cases=errs)
    rng = np.random.default_rng(SEED + 1)
    serve_rng = np.random.default_rng(SEED + 2)
    vec_rng = np.random.default_rng(SEED + 3)
    for op in NEW_OPS:
        mod, errs = module[op], []
        labelled = [("figure2", figure2_args(op, rng))] + \
            [("awkward", a) for a in awkward_args(op, rng)] + \
            [("edge", a) for a in edge_args(op, rng)] + \
            [("serve", a) for a in serve_args(op, serve_rng)]
        if op in ("conv_hwc", "dwconv"):    # the timed large size
            labelled.append(("large", big_args(op, gen, dev)))
        if op in ("maxpool", "argmaxpool", "ibilinear"):
            labelled += vector_args(op, vec_rng)
        for label, host_args in labelled:
            for dt in (torch.float32, torch.bfloat16):
                # ibilinear's weights stay float32; its image takes dt
                args = on(host_args, dev, dt,
                          keep=(3, 4) if op == "ibilinear" else ())
                if label == "off16":
                    args = (off16(args[0]),) + args[1:]
                before = mod.LAUNCHES[op]
                got = mod.KERNELS[op](*args)
                if mod.LAUNCHES[op] != before + 1:
                    raise AssertionError(f"{op}/{label}: "
                                         f"{mod.LAUNCHES[op] - before} "
                                         "launches, expected 1")
                err = compare(op, got, mod.PLAIN[op](*args))
                errs.append({"case": label, "dtype": str(dt)[6:],
                             "shapes": [list(a.shape) for a in args
                                        if isinstance(a, torch.Tensor)],
                             "max_abs_err": err})
                if label == "figure2" and dt == torch.float32:
                    max_err[op] = err
        if op in ("conv_hwc", "dwconv"):
            errs += conv_checks(op, rng, dev)
        torch.cuda.synchronize()
        emit("kernel_vs_plain", op=op,
             tolerance="bitwise" if op in EXACT else MM_TOL, cases=errs)
    for op in LM_OPS:
        errs = []
        for label, host_args in lm_cases(op, rng):
            for dt in (torch.float32, torch.bfloat16):
                args = on(host_args, dev, dt, keep=lm_keep(op))
                got = module[op].KERNELS[op](*args)
                err = compare(op, got, module[op].PLAIN[op](*args))
                if not bool(got.isfinite().all()):
                    raise AssertionError(f"{op}/{label}: non-finite output")
                if op == "ssd" and not torch.equal(
                        module[op].KERNELS[op](*args), got):
                    raise AssertionError(f"ssd/{label}/{dt}: two runs "
                                         "differ")
                errs.append({"case": label, "dtype": str(dt)[6:],
                             "shapes": [list(a.shape) for a in args
                                        if isinstance(a, torch.Tensor)],
                             "max_abs_err": err})
                if label == "zamba2" and dt == torch.float32:
                    max_err[op] = err
        torch.cuda.synchronize()
        emit("kernel_vs_plain", op=op, tolerance=LM_TOL, cases=errs)

    # 4. the main path: the ten Figure-2 workloads through ops.* ----------
    committed = json.loads((ROOT / "BENCH_xnnpack.json").read_text())
    rvv128 = committed["targets"]["rvv-128"]
    rng = np.random.default_rng(SEED)
    args = {op: on(figure2_args(op, rng), dev) for op in ALL_OPS}
    with use_target("rvv-128"):
        chosen = {op: REGISTRY.explain(op, *args[op])["chosen"]
                  for op in ALL_OPS}
    for m in modules:
        m.reset_launches()
    outs, first_ms = {}, {}
    with use_target("rvv-128"), trace.count() as counted:
        for op in ALL_OPS:
            t0 = time.perf_counter()
            outs[op] = getattr(ops, op)(*args[op])
            torch.cuda.synchronize()
            first_ms[op] = (time.perf_counter() - t0) * 1e3
    launches = {k: v for m in modules for k, v in m.LAUNCHES.items()}
    per_op = {op: counted["per_op"].get((op, "pallas"), 0) for op in ALL_OPS}
    want_counts = {op: rvv128[name]["customized_instrs"]
                   for name, op in FIG2}
    for op in ALL_OPS:
        if chosen[op] != "pallas":
            raise AssertionError(f"{op}: rvv-128 chose {chosen[op]}")
        if launches[op] != 1:
            raise AssertionError(f"{op}: {launches[op]} launches on the "
                                 "main path, expected 1")
        if per_op[op] != want_counts[op]:
            raise AssertionError(f"{op}: counted {per_op[op]}, committed "
                                 f"{want_counts[op]}")
    # what came out: finite, of the oracle's shape, and within the
    # reference's kernel-test tolerance (tests/test_kernels.py TOL fp32
    # 2e-4) of the plain torch oracle; argmaxpool's indices equal outright
    oracle_err = {}
    for op in ALL_OPS:
        got, want = outs[op], getattr(ref, op)(*args[op])
        pairs = list(zip(got, want)) if isinstance(got, tuple) \
            else [(got, want)]
        errs = []
        for y, w in pairs:
            if y.shape != w.shape or y.dtype != w.dtype:
                raise AssertionError(f"{op}: {y.shape}/{y.dtype} against "
                                     f"the oracle's {w.shape}/{w.dtype}")
            if not y.is_floating_point():
                if not torch.equal(y, w):
                    raise AssertionError(f"{op}: indices differ from the "
                                         "oracle's")
                continue
            if not bool(y.isfinite().all()):
                raise AssertionError(f"{op}: non-finite output")
            if not torch.allclose(y, w, rtol=ORACLE_TOL, atol=ORACLE_TOL):
                raise AssertionError(f"{op}: disagrees with the torch oracle")
            errs.append(float((y - w).abs().max()))
        oracle_err[op] = max(errs)
    # the Figure-2 rows as benchmarks/xnnpack_suite.py run_target builds
    # them: the baseline is the ladder's highest valid tier under the
    # vector cap, the customized column the uncapped choice
    rows = []
    with use_target("rvv-128"):
        for name, op in FIG2:
            base = REGISTRY.explain(op, *args[op], policy="vector")
            ladder = max((c for c in base["candidates"]
                          if c["valid"] and c["cost"] is not None),
                         key=lambda c: TIERS.index(c["tier"]))
            cust = REGISTRY.explain(op, *args[op], policy="pallas")
            rows.append({"name": name, "baseline_tier": ladder["tier"],
                         "customized_tier": cust["chosen"],
                         "baseline_instrs": ladder["cost"],
                         "customized_instrs": cust["chosen_cost"],
                         "speedup": round(ladder["cost"]
                                          / max(1, cust["chosen_cost"]), 2)})
    for r in rows:      # _check_figure2, and the committed column itself
        if r["customized_tier"] != "pallas" or r["speedup"] <= 1.0:
            raise AssertionError(f"Figure 2: {r}")
        want = {k: rvv128[r["name"]][k] for k in r if k != "name"}
        if {k: r[k] for k in want} != want:
            raise AssertionError(f"Figure 2: {r} against committed {want}")
    top2 = {r["name"] for r in sorted(rows, key=lambda r: -r["speedup"])[:2]}
    if top2 != {"vtanh", "vsigmoid"}:
        raise AssertionError(f"Figure 2: largest wins are {top2}")
    with use_target("h100"):
        h100 = {op: REGISTRY.explain(op, *args[op])["chosen"]
                for op in ALL_OPS}
    if any(t != "pallas" for t in h100.values()):
        raise AssertionError(f"h100 picked {h100} at the Figure-2 size; "
                             "every op must take its kernel tier")
    emit("main_path", target="rvv-128", policy=REGISTRY.policy,
         chosen=chosen, launches=launches, counted=per_op,
         committed=want_counts, oracle_max_abs_err=oracle_err,
         h100_chosen=h100)
    emit("figure2", target="rvv-128", rows=rows,
         top2=sorted(top2))

    # host time per call at the Figure-2 size: the main path's first call
    # (selection-cache miss), then back-to-back calls through the registry
    # and through the bare kernel wrapper, on the host clock
    calls = 200
    ops_ms, wrapper_ms = {}, {}
    for op in ALL_OPS:
        for fn, into in ((getattr(ops, op), ops_ms),
                         (module[op].KERNELS[op], wrapper_ms)):
            with use_target("rvv-128"):
                fn(*args[op])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(calls):
                    fn(*args[op])
                torch.cuda.synchronize()
            into[op] = (time.perf_counter() - t0) / calls * 1e3
    emit("host", calls=calls, first_call_ms=first_ms,
         ops_call_ms=ops_ms, wrapper_call_ms=wrapper_ms,
         registry=REGISTRY.cache_info())

    # 5. the serving paths: each arch at full width, then the
    # gemmas at prompts longer than their windows ----------------------
    serve = {arch: serve_arch(dev, modules, arch) for arch in SERVE_ARCHS}
    serve.update({f"{arch}/window": serve_arch(dev, modules, arch, traffic,
                                               "serve_window")
                  for arch, traffic in SERVE_WINDOW})

    # 5b. training: zamba2 at full width and 8 layers, the gradient gates,
    # the other archs, checkpoint and restart, the no-detach guard --------
    train = train_phase(dev, modules)
    train_grad_phase(dev)
    train_archs_phase(dev)
    train_resume_phase(dev)
    sharded = sharded_phase(dev)
    guard_phase(dev, module)

    # 6. the NEON frontend: every isa op, then the corpus through port ----
    isa_phase(dev)
    port_compiled_phase(dev, modules, port_phase(dev, modules))
    port_serve_phase(dev, modules)

    # 7. times ------------------------------------------------------------
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MiB
    library = {"vrelu": lambda x: torch.clamp(x, *RELU_BOUNDS),
               "vsqrt": torch.sqrt, "vtanh": torch.tanh,
               "vsigmoid": torch.sigmoid}
    times = {}
    # fp32 and bf16 at the Figure-2 and the large size; vtanh also at the
    # shapes of zamba2's gelu in prefill and decode, vsigmoid at granite's
    # experts' silu, in bf16
    ew_sizes = [(op, dt, size, shape)
                for op in EW_OPS for dt in (torch.float32, torch.bfloat16)
                for size, shape in (("figure2", (1 << 20,)),
                                    ("large", (1 << 26,)))]
    ew_sizes += [("vtanh", torch.bfloat16, "serve_prefill", (4, 512, 8192)),
                 ("vtanh", torch.bfloat16, "serve_decode", (4, 1, 8192)),
                 # granite's experts' silu: (E, capacity, d_expert)
                 ("vsigmoid", torch.bfloat16, "moe_prefill", (32, 640, 512)),
                 ("vsigmoid", torch.bfloat16, "moe_decode", (32, 8, 512))]
    # deepseek's and minicpm3's silu, in both dtypes (the float32 check's)
    ew_sizes += [("vsigmoid", dt, size, shape) for size, shape in SILU_SHAPES
                 for dt in (torch.bfloat16, torch.float32)]
    # gemma2's, gemma3's and whisper's gelu and pixtral's silu in bf16;
    # gemma2's final softcap on its float32 logits
    ew_sizes += [(op, torch.bfloat16, size, shape)
                 for op, size, shape in NEW_EW_SHAPES]
    ew_sizes += [("vtanh", torch.float32, size, shape)
                 for size, shape in SOFTCAP_SHAPES]
    for op, dt, size, shape in ew_sizes:
        x = workload(op, torch.randn(shape, generator=gen,
                                     device=dev)).to(dt)
        ex = extra_args(op)
        k_ms = time_ms(lambda: ew.KERNELS[op](x, *ex), flush)
        p_ms = time_ms(lambda: ew.PLAIN[op](x, *ex), flush)
        l_ms = time_ms(lambda: library[op](x), flush)
        n = x.numel()
        b_ms, b_by, nbytes, n_ops = cost.bound(op, (x, *ex),
                                               ew.KERNELS[op](x, *ex))
        dtype = str(dt).replace("torch.", "")
        row = {"op": op, "size": size, "n": n, "shape": list(shape),
               "dtype": dtype, "kernel_ms": k_ms, "plain_ms": p_ms,
               "library_ms": l_ms, "bound_ms": b_ms, "bound_by": b_by,
               "bytes": nbytes, "ops": n_ops, "bound_share": b_ms / k_ms,
               "library_ratio": k_ms / l_ms,
               "plan": list(ew.plan(n, x.element_size()))}
        times[(op, size if dt == torch.float32 else f"{size}_bf16")] = row
        emit("time", **row)
        del x
    times.update(time_figure2(NEW_OPS, module, args, gen, dev, flush,
                              plans=True))
    # zamba2's calls, then granite's attention and mamba2's ssd; ssd also in
    # float32 (the float32 serving check's calls)
    lm_timed = [(op, "serve", lm_time_args(op, gen, dev)) for op in LM_OPS]
    lm_timed += [(op, f"serve_{arch}", lm_time_args(op, gen, dev, arch))
                 for op, arch in (("flash_attention", "granite"),
                                  ("decode_attention", "granite"),
                                  ("ssd", "mamba2"))]
    lm_timed += [("ssd", size + "_f32", on(args, dev, torch.float32,
                                           keep=lm_keep("ssd")))
                 for op, size, args in lm_timed if op == "ssd"]
    # the attention calls of gemma2, gemma3, whisper and pixtral, bf16
    lm_timed += [(op, f"serve_{label}", lm_new_args(
        op, spec,
        lambda shape: torch.randn(shape, generator=gen, device=dev)
        .to(torch.bfloat16),
        lambda b, v: torch.full((b,), v, dtype=torch.int32, device=dev)))
        for op, specs in LM_NEW.items() for label, spec in specs.items()]
    for op, size, targs in lm_timed:
        mod = module[op]
        if op == "decode_attention":
            b, _, h, d = targs[0].shape
            splits, ks = fa.decode_plan(b, h, targs[1].shape[1], d)
            emit("decode_plan", size=size, shapes=[list(t.shape) for t in
                                                     targs[:3]],
                 splits=splits, ks=ks, blocks=b * h * splits)
        out = mod.KERNELS[op](*targs)
        k_ms = time_ms(lambda: mod.KERNELS[op](*targs), flush)
        p_ms = time_ms(lambda: mod.PLAIN[op](*targs), flush)
        lib = lm_library_call(op, targs)
        l_ms = None if lib is None else time_ms(lib, flush)
        # (float32 ssd runs on the bf16 tensor cores too: kernels/cost.py)
        b_ms, b_by, nbytes, n_ops = cost.bound(op, targs, out)
        bf16 = targs[0].dtype == torch.bfloat16
        row = {"op": op, "size": size,
               "dtype": "bfloat16" if bf16 else "float32",
               "shapes": [list(a.shape) for a in targs
                          if isinstance(a, torch.Tensor)],
               "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
               "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
               "ops": n_ops, "bound_share": b_ms / k_ms}
        times[(op, size)] = row
        emit("time", **row)
        del out, targs
    del lm_timed
    # gemm where the serving paths run it: M = 4 and M = 2048 rows against
    # zamba2's five weight shapes (mamba2's two among them), in bf16 and in
    # float32 (the float32 serving check), against granite's two in bf16,
    # and against deepseek's and minicpm3's in both dtypes (W_uk / W_uv at
    # M = 2048 alone), each beside torch.matmul on the same operands (no
    # bias and no clamp: addmm's function here); every output held to the
    # plain version within the reference's TOL (MM_TOL)
    bf, inf = torch.bfloat16, float("inf")
    f32 = torch.float32
    gemm_rows = [(dt, "", k, n, SERVE_M)
                 for dt, shapes in ((bf, SERVE_GEMM + GRANITE_GEMM),
                                    (f32, SERVE_GEMM)) for k, n in shapes]
    gemm_rows += [(dt, f"{arch}_", k, n, SERVE_M) for dt in (bf, f32)
                  for arch, shapes in MLA_GEMM.items() for k, n in shapes]
    gemm_rows += [(dt, f"{arch}_", k, n, SERVE_M[1:]) for dt in (bf, f32)
                  for arch, (k, n) in MLA_PREFILL_GEMM.items()]
    # gemma2's, gemma3's, whisper's and pixtral's (pixtral's head among
    # them) at their decode and prefill M, in bf16
    gemm_rows += [(bf, f"{arch}_", k, n, ms)
                  for arch, (shapes, ms) in NEW_GEMM.items()
                  for k, n in shapes]
    for dt, arch, k, n, ms in gemm_rows:
        w = (torch.randn((k, n), generator=gen, device=dev)
             * k ** -0.5).to(dt)
        for m in ms:
            x = torch.randn((m, k), generator=gen, device=dev).to(dt)
            tag = f"serve_{arch}m{m}_{k}x{n}" + ("" if dt == bf else "_f32")
            if gemm.variant(dt, m) == "simt":
                emit_simt_plan(tag, m, n, k)
            out = gemm.gemm(x, w)
            err = compare("gemm", out, gemm.gemm_plain(x, w))
            k_ms = time_ms(lambda: gemm.gemm(x, w), flush)
            p_ms = time_ms(lambda: gemm.gemm_plain(x, w), flush)
            l_ms = time_ms(lambda: torch.matmul(x, w), flush)
            b_ms, b_by, nbytes, n_ops = cost.bound("gemm", (x, w), out)
            row = {"op": "gemm", "size": tag,
                   "dtype": str(dt).replace("torch.", ""),
                   "shapes": [[m, k], [k, n]],
                   "variant": gemm.variant(dt, m), "max_abs_err": err,
                   "kernel_ms": k_ms, "plain_ms": p_ms,
                   "library_ms": l_ms, "bound_ms": b_ms,
                   "bound_by": b_by, "bytes": nbytes,
                   "ops": n_ops, "bound_share": b_ms / k_ms,
                   "library_ratio": k_ms / l_ms}
            times[("gemm", row["size"])] = row
            emit("time", **row)
            del out, x
        del w
    # the train path's calls (``train``: a microbatch of 4 x 4096 = 16384
    # rows of zamba2), bf16: gemm's forward and its backward products dA =
    # dY B^T and dB = A^T dY (on the transposed copies the backward makes)
    # against the five weight shapes, then the gelu, causal flash and ssd
    # with its skip term at S 4096
    times.update(time_train(gen, dev, flush))
    # the sharded path's calls at its local shapes
    times.update(time_sharded(gen, dev, flush))
    # the small-M threshold: split-K against the kernel that takes the rows
    # above it, at M = 4, 8 and 16, in both dtypes
    for k, n in ((2048, 8512), (8192, 2048)):
        for dt, above in ((bf, "mma"), (torch.float32, "simt")):
            w = (torch.randn((k, n), generator=gen, device=dev)
                 * k ** -0.5).to(dt)
            for m in (4, 8, 16):
                x = torch.randn((m, k), generator=gen, device=dev).to(dt)
                row = {"shapes": [[m, k], [k, n]], "dtype": str(dt)[6:]}
                for kind in ("small_m", above):
                    row[f"{kind}_ms"] = time_ms(
                        lambda: gemm.launch(kind, x, w, None, -inf, inf),
                        flush)
                emit("gemm_threshold", **row)
            del w, x
    del flush

    # 8. kernels: at their main path's shapes (Figure-2; serving) ---------
    # gemm at the serving path's commonest call: M = 4, bf16, the Mamba
    # input projection (38 of a zamba2 decode step's launches); launches
    # summed over the main paths, each counted from 0 (Figure-2, then each
    # arch's generate, then each window traffic's)
    kernels = []
    paths = {"figure2": launches,
             **{arch: r["launches"] for arch, r in serve.items()},
             "train": train["launches"], "sharded": sharded["launches"]}
    at = {op: (op, "serve") for op in LM_OPS}
    at["gemm"] = ("gemm", "serve_m4_2048x8512")
    max_err["gemm"] = times[at["gemm"]]["max_abs_err"]
    for op in ALL_OPS + LM_OPS:
        t = times[at.get(op, (op, "figure2"))]
        by_path = {p: n[op] for p, n in paths.items() if n.get(op)}
        kernels.append({"name": op, "route": "cuda", "source": SOURCE[op],
                        "replaces": REPLACES[op],
                        "launches": sum(by_path.values()),
                        "launches_by_path": by_path,
                        "max_abs_err": max_err[op], "ms": t["kernel_ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"],
                        "library_ms": t["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
