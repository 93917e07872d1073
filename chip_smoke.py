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
  * serving at full width and depth (bf16, seeded random weights) under
    the default target (h100) and policy, for zamba2-1.2b,
    granite-moe-1b-a400m, deepseek-v2-lite-16b, minicpm3-4b, gemma2-2b,
    gemma3-1b and whisper-tiny, each freed before the next (and each
    bf16 model before its float32 one): ``Engine.generate`` for 4
    requests of 512-token prompts and 32 greedy tokens (whisper's with
    1500 stub frames each: ``data.pipeline.extra_inputs``; pixtral-12b
    is held, ROADMAP C.23, and served by ``tools/serve_gap_probe.py``
    with its stub patches), which must run the kernel
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
    (``stream_gaps``).  An MoE's router (granite's, deepseek's) is
    swapped for ``route_probe`` in both dtypes: the vector runs route by
    the kernel run's top-k indices (``route_flips`` counts where its own
    would differ and fails unless each such flip sits on a margin within
    the two runs' router-probability gap).  whisper's ``dec`` blocks in
    the pinned run also read the kernel run's encoder output.  The
    profiled prefill and decode steps also read the device ms of prefill
    attention and of MLA's absorbed decode (``SPANS``);
  * ``serve_window``: the same gates for gemma3-1b at 4 requests of
    1024-token prompts (32 tokens) and gemma2-2b at one request of 4160
    tokens (8 tokens), prompts longer than their windows (512, 4096):
    the local layers' ring is written in prefill, the window masks
    flash, gemma3's decode wraps its ring (``SERVE_WINDOW``).

Each path's kernel launches are counted from 0 and checked; gemm's are
also counted by variant (split-K in decode, wgmma in prefill).  Then the
training path (``train.loop``, ``optim``, ``checkpoint``, ``runtime``):

  * ``train``: zamba2-1.2b at full width and depth, bf16, seeded, under
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
  * ``train_grad``: zamba2 float32 at full depth, 2 x 1024 tokens, one
    backward on the kernel tier and one on the vector tier: the loss
    within 2e-4 and each leaf's gradient within 2e-4 of its max, but
    Mamba2's A_log leaves, held to a float64 run of the vector tier: no
    further from it than the vector tier is, by more than 2e-4 of its
    max (``grad_gate``); bf16 printed, not gated per leaf;
  * ``train_archs``: the other six served archs at full width, cut to
    one pattern unit, float32, 2 x 512 tokens, the same per-leaf gate
    (raw), MoE routing pinned (``route_probe``), each op's kernel tier
    and Function;
  * ``train_resume``: zamba2 cut to one pattern unit, 6 steps, a
    checkpoint every 2, a failure injected at step 4: one restart, the
    last step saved, the params restored bitwise and the losses equal to
    an uninterrupted run's; each save's bytes and seconds;
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
and the card's bound: the elementwise four also in bf16, vtanh at the
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

import functools
import json
import math
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
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_OPS_PER_S = 67e12         # H100 SXM data sheet, fp32 outside tensor cores
BF16_MMA_PER_S = 989e12        # H100 SXM data sheet, dense bf16 tensor cores
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
# The serving paths: each arch at full width and depth, bf16 and again
# float32: 4 requests of 512-token prompts, 32 greedy tokens (whisper's
# requests each with 1500 stub frames)
SERVE = dict(batch=4, prompt=512, gen=32)
# (mamba2-1.3b's and pixtral-12b's configs and blocks are in the port,
# but get_config refuses them: at full depth their bf16 logits cross
# E2E_TOL by rounding alone; ROADMAP C.22, C.23.  Their kernels' calls
# are checked and timed here all the same, and tools/serve_gap_probe.py
# serves them)
SERVE_ARCHS = ("zamba2-1.2b", "granite-moe-1b-a400m", "deepseek-v2-lite-16b",
               "minicpm3-4b", "gemma2-2b", "gemma3-1b", "whisper-tiny")
# The sliding-window traffic (``serve_window``): prompts longer than each
# gemma's window, so that the local layers' ring is written in prefill,
# the window masks flash and (gemma3) decode wraps the ring; gemma2's
# vector tier takes its chunked attention there (Sq x Sk > 2048^2)
SERVE_WINDOW = (("gemma3-1b", dict(batch=4, prompt=1024, gen=32)),
                ("gemma2-2b", dict(batch=1, prompt=4160, gen=8)))
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
# The train path (``train``): zamba2-1.2b at full width and depth, bf16,
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
TRAIN = dict(arch="zamba2-1.2b", batch=8, seq=4096, accum=2, steps=8)
TRAIN_TOL = 3e-2
TRAIN_LEAF_TOL = 0.3
TRAIN_GRAD = dict(batch=2, seq=1024)
TRAIN_ARCHS = ("granite-moe-1b-a400m", "deepseek-v2-lite-16b", "minicpm3-4b",
               "gemma2-2b", "gemma3-1b", "whisper-tiny")
TRAIN_ARCH_TRAFFIC = dict(batch=2, seq=512)
TRAIN_RESUME = dict(batch=4, seq=1024, steps=6, ckpt_every=2, fail_at=4)
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
    stride 2, non-square taps and CONV_CASES for conv, DW_CASES for
    dwconv, odd extents for the pools, a pixel count off the block size
    for ibilinear."""
    n = _normal
    if op == "gemm":
        return [(n(rng, (129, 33)), n(rng, (33, 67)), None),
                (n(rng, (1, 70)), n(rng, (70, 1)), n(rng, (1,)), -0.5, 0.5)]
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


def lm_work(op, args, out):
    """(bytes, matrix operations) the LM function needs on these inputs:
    each input read once and the output written once (decode: only the
    valid prefix of the cache); multiply-adds of the visible (query, key)
    pairs or of the SSD chunk products, two operations each."""
    import math
    import torch
    size = lambda t: t.numel() * t.element_size()       # noqa: E731
    if op == "flash_attention":
        q, k, v, causal, window = args[:5]
        b, sq, h, d = q.shape
        sk = k.shape[1]
        i = torch.arange(sq)[:, None] + (sk - sq)
        j = torch.arange(sk)[None, :]
        vis = torch.ones((sq, sk), dtype=torch.bool)
        if causal:
            vis &= i >= j
        if window is not None:
            vis &= i - j < window
        pairs = int(vis.sum())
        return (size(q) + size(k) + size(v) + size(out),
                4 * b * h * pairs * d)
    if op == "decode_attention":
        q, k, v, lens, window = args[:5]
        b, _, h, d = q.shape
        hkv = k.shape[2]
        hi = lens.clamp(0, k.shape[1])
        lo = (hi - window).clamp(min=0) if window is not None else 0 * hi
        keys = int((hi - lo).sum())
        return (size(q) + size(lens) + size(out)
                + 2 * keys * hkv * d * k.element_size(),
                4 * h * d * keys)
    x, B = args[0], args[3]
    b, s, h, p = x.shape
    n = B.shape[-1]
    L = min(128, -(-s // 8) * 8)
    macs = b * h * math.ceil(s / L) * (L * (L + 1) // 2 * (n + p)
                                       + 2 * L * p * n)
    return (sum(size(t) for t in args if isinstance(t, torch.Tensor))
            + size(out), 2 * macs)


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


def mma_bound_ms(nbytes, n_ops):
    """The larger of the bytes at the HBM rate and the operations at the
    dense bf16 tensor-core rate."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / BF16_MMA_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms \
        else "operations"


def work(op, args, out):
    """(bytes, operations) the function must move and do: each input read
    once, each output written once; fp32 operations on these inputs."""
    import torch
    outs = out if isinstance(out, tuple) else (out,)
    tensors = [a for a in args if isinstance(a, torch.Tensor)] + list(outs)
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    y = outs[0].numel()
    if op == "gemm":
        m, k = args[0].shape
        # the product, the bias add and the two-sided clamp
        n_ops = 2 * m * k * args[1].shape[1] + 3 * y
    elif op == "conv_hwc":
        kh, kw, ci, _ = args[1].shape
        n_ops = y * (2 * kh * kw * ci + 1)
    elif op == "dwconv":
        kh, kw, _ = args[1].shape
        n_ops = y * (2 * kh * kw + 1)
    elif op in ("maxpool", "argmaxpool"):
        kh, kw = args[1]
        n_ops = y * (kh * kw - (op == "maxpool"))
    else:
        n_ops = 12 * y                   # 3 subs, 6 muls, 3 adds
    return nbytes, n_ops


def bound_ms(nbytes, n_ops):
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / FP32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms \
        else "operations"


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
    out = mod.KERNELS[op](*targs)
    k_ms = time_ms(lambda: mod.KERNELS[op](*targs), flush)
    p_ms = time_ms(lambda: mod.PLAIN[op](*targs), flush)
    lib = library_call(op, targs)
    l_ms = None if lib is None else time_ms(lib, flush)
    nbytes, n_ops = work(op, targs, out)
    dt = targs[0].dtype
    b_ms, b_by = (mma_bound_ms if op == "conv_hwc" and dt == torch.bfloat16
                  else bound_ms)(nbytes, n_ops)
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
            row["corner_bytes"] / HBM_BYTES_PER_S * 1e3 / k_ms
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


def held_logits(kern, plain, rel_tol, what):
    """Per-step max |kernel - plain| logit, max |logit|, and the greedy
    tokens' agreement; raises unless every step is within rel_tol of its
    max |logit| and the tokens agree wherever the plain run's top-2 gap
    exceeds that."""
    if not bool(kern.isfinite().all()) or not bool(plain.isfinite().all()):
        raise AssertionError(f"serve/{what}: non-finite logits")
    err = (kern - plain).abs().amax(dim=(1, 2))
    scale = kern.abs().amax(dim=(1, 2))
    tol = rel_tol * scale
    if bool((err > tol).any()):
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
    """Drive ``arch`` serving at full width and depth through the port's
    Engine under the default target (h100) and policy, ``traffic``'s
    requests (whisper's with stub frames, pixtral's with stub patches:
    ``extra_inputs``), count the kernel launches of that run, time
    prefill and decode, and hold its logits against the vector tier's
    (teacher forced) over the whole model, in bf16 and in float32 (an
    MoE's vector run routed by the kernel run's indices, its flips
    counted); in bf16 also each block's output, the vector block started
    from the kernel run's input.  Emits and returns the ``phase``
    record."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import trace
    from repro_torch.core.registry import REGISTRY
    from repro_torch.data.pipeline import extra_inputs
    from repro_torch.models import blocks as blocks_mod
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod
    from repro_torch.serve.engine import Engine

    cfg = get_config(arch)
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
    def checked(cfg_, params_, rel_tol, what, blocks):
        """The kernel run (its launches and tiers counted), then the
        vector run held to it over the whole model (``held_logits``); an
        MoE's vector run routes by the kernel run's indices, and
        ``route_flips`` counts where its own router would differ.  With
        ``blocks`` a third run starts each vector block from the kernel
        run's input and holds every block's output (``stream_gaps``)."""
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
        out = held_logits(kern, run("vector", pin), rel_tol, what)
        if cfg_.n_experts:
            out["routing"] = {"pinned": True, **route_flips(
                calls, pinned_calls, cfg_.top_k, what)}
        if blocks:
            pin_block, vblocks = block_probe(blocks_mod, pinned=kblocks)
            run("vector", pinned_route()[0], pin_block)
            out["blocks"] = stream_gaps(kblocks, vblocks, rel_tol, what)
        return kern, launched, tiers(counted_), out

    kern, _, _, bf16_check = checked(cfg, params, E2E_TOL, cfg.dtype,
                                     blocks=True)
    if not torch.equal(kern.argmax(-1).cpu(),
                       torch.as_tensor(tokens).long().T):
        raise AssertionError("serve: the teacher-forced kernel run does "
                             "not reproduce its own greedy tokens")
    record = {
        "arch": cfg.name, "traffic": phase, "params": M.count_params(params),
        "dtype": cfg.dtype, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "batch": b, "prompt_len": plen, "generated": steps,
        "target": "h100", "chosen": chosen, "ops": list(ops_),
        "launches": launches, "expected_launches": want,
        "init_s": init_s, "generate_s": generate_s, **warm,
        **bf16_check, "first_tokens": tokens[0].tolist(),
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    if cfg.n_experts:
        # a decode step reads every routed expert's weights (the dense
        # (E, C, d) buffer) in each MoE layer: their bytes at the HBM rate
        n_moe = sum(k == "moe" for k in cfg.layer_pattern())
        expert_bytes = n_moe * 3 * cfg.n_experts * cfg.d_model * \
            cfg.d_expert * params["unit"][0][0]["ffn"]["we_g"].element_size()
        record["expert_weight_floor_ms"] = \
            expert_bytes / HBM_BYTES_PER_S * 1e3
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
    kern, launches32, chosen32, f32_held = checked(
        cfg32, params32, E2E_F32_TOL, "float32", blocks=False)
    emit("serve_tiers", arch=arch, traffic=phase, target="h100",
         policy="pallas", dtype="float32", chosen=chosen32)
    gated(launches32, chosen32, "float32")
    if launches32["gemm_simt"] == 0:
        raise AssertionError("serve/float32: gemm_simt never launched")
    record["float32"] = {"launches": launches32, "chosen": chosen32,
                         **f32_held,
                         "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    del params32, kern
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
# training: zamba2-1.2b at full width and depth, the gradient gates, the
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
    """zamba2-1.2b at full width and depth, bf16: ``TRAIN``'s steps of
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
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.core import trace
    from repro_torch.core.registry import REGISTRY
    from repro_torch.data.pipeline import SyntheticLM, extra_inputs
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.train import loop

    cfg = get_config(TRAIN["arch"])
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
        / BF16_MMA_PER_S, "step0_vs_vector": step0,
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
    """The gradient gate: zamba2-1.2b at full width and depth, float32,
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
        cfg = get_config(TRAIN["arch"]).replace(dtype=dtype)
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
    held to the same per-leaf gate as train_grad; the kernel tier and
    the Function of each op the arch's blocks reach (vsigmoid's for the
    silu archs), the aux loss non-zero for an MoE."""
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
        worst = held_grads(kern, plain, leaf_names(params),
                           LM_TOL["float32"], f"train_archs/{arch}")
        top = max(worst, key=worst.get)
        rows[arch] = {"layers": cfg.n_layers, "full_layers": full.n_layers,
                      "enc_layers": cfg.n_enc_layers,
                      "params": M.count_params(params), "loss": kl,
                      "vector_loss": vl, "aux": aux, "functions": functions,
                      "chosen": chosen, "leaves": len(worst),
                      "max_rel_leaf_err": worst[top], "worst_leaf": top,
                      "router_calls": len(calls) if calls else 0}
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


def time_train(gen, dev, flush):
    """The ``time`` rows of the train path's kernel calls at zamba2's train
    shapes (``TRAIN_M`` rows a microbatch), bf16, each output held to its
    plain version's on the same inputs (``compare``: MM_TOL, TOL and
    LM_TOL's bf16), and timed beside it, the library call and the card's
    bound."""
    import torch
    from repro_torch.core import trace, use_target
    from repro_torch.kernels import elementwise as ew
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gemm, ssd
    bf = torch.bfloat16
    rows = {}

    def r(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(bf)
    for k, n in SERVE_GEMM:
        x, w, g = r(TRAIN_M, k), r(k, n, scale=k ** -0.5), r(TRAIN_M, n)
        for part, (a, b) in (("fwd", (x, w)), ("da", (g, w.t().contiguous())),
                             ("db", (x.t().contiguous(), g))):
            m_, k_ = a.shape
            n_ = b.shape[1]
            size = f"train_{part}_{k}x{n}"
            err = compare(f"gemm/{size}", gemm.gemm(a, b),
                          gemm.gemm_plain(a, b))
            k_ms = time_ms(lambda: gemm.gemm(a, b), flush)
            p_ms = time_ms(lambda: gemm.gemm_plain(a, b), flush)
            l_ms = time_ms(lambda: torch.matmul(a, b), flush)
            nbytes = 2 * (a.numel() + b.numel() + m_ * n_)
            b_ms, b_by = mma_bound_ms(nbytes, 2 * m_ * n_ * k_)
            row = {"op": "gemm", "size": size, "dtype": "bfloat16",
                   "shapes": [[m_, k_], [k_, n_]],
                   "variant": gemm.variant(bf, m_), "max_abs_err": err,
                   "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                   "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
                   "ops": 2 * m_ * n_ * k_, "bound_share": b_ms / k_ms,
                   "library_ratio": k_ms / l_ms}
            rows[("gemm", row["size"])] = row
            emit("time", **row)
        del x, w, g
    s, b_ = TRAIN["seq"], TRAIN["batch"] // TRAIN["accum"]
    x = 2.0 * r(b_, s, 8192)
    err = compare("vtanh", ew.vtanh(x), ew.vtanh_plain(x))
    k_ms = time_ms(lambda: ew.vtanh(x), flush)
    p_ms = time_ms(lambda: ew.vtanh_plain(x), flush)
    l_ms = time_ms(lambda: torch.tanh(x), flush)
    with use_target("h100"):
        f32 = torch.empty(x.shape, device="meta")
        n_ops = trace.fx_vector_instrs(ew.vtanh_math, f32) * \
            trace.vreg_for(f32.dtype)
    b_ms, b_by = bound_ms(2 * x.numel() * 2, n_ops)
    row = {"op": "vtanh", "size": "train_gelu", "dtype": "bfloat16",
           "shape": list(x.shape), "max_abs_err": err, "kernel_ms": k_ms,
           "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": b_ms,
           "bound_by": b_by, "bytes": 4 * x.numel(), "ops": n_ops,
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
        nbytes, n_ops = lm_work(op, targs, out)
        b_ms, b_by = mma_bound_ms(nbytes, n_ops)
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
    from repro_torch.kernels import _build, conv, gemm, ibilinear, ops, \
        pooling, ref, ssd
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

    # 5. the serving paths: each arch at full width and depth, then the
    # gemmas at prompts longer than their windows ----------------------
    serve = {arch: serve_arch(dev, modules, arch) for arch in SERVE_ARCHS}
    serve.update({f"{arch}/window": serve_arch(dev, modules, arch, traffic,
                                               "serve_window")
                  for arch, traffic in SERVE_WINDOW})

    # 5b. training: zamba2 at full width and depth, the gradient gates,
    # the other archs, checkpoint and restart, the no-detach guard --------
    train = train_phase(dev, modules)
    train_grad_phase(dev)
    train_archs_phase(dev)
    train_resume_phase(dev)
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
    math_fn = {"vrelu": lambda x: ew.vrelu_math(x, *RELU_BOUNDS),
               "vsqrt": ew.vsqrt_math, "vtanh": ew.vtanh_math,
               "vsigmoid": ew.vsigmoid_math}
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
        nbytes = 2 * n * x.element_size()
        with use_target("h100"):
            f32 = torch.empty(shape, device="meta")
            n_ops = trace.fx_vector_instrs(math_fn[op], f32) * \
                trace.vreg_for(f32.dtype)
        b_ms, b_by = bound_ms(nbytes, n_ops)
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
        nbytes, n_ops = lm_work(op, targs, out)
        bf16 = targs[0].dtype == torch.bfloat16
        if op == "ssd" and not bf16:
            # float32 ssd runs on the bf16 tensor cores too, each product
            # as three of its operands' split terms (csrc/ssd.cu)
            n_ops *= 3
        # the bf16 tensor cores' rate where the kernel runs on them
        b_ms, b_by = (mma_bound_ms if bf16 or op == "ssd" else bound_ms)(
            nbytes, n_ops)
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
            nbytes = x.element_size() * (x.numel() + w.numel()
                                         + out.numel())
            b_ms, b_by = (mma_bound_ms if dt == bf else bound_ms)(
                nbytes, 2 * m * n * k)
            row = {"op": "gemm", "size": tag,
                   "dtype": str(dt).replace("torch.", ""),
                   "shapes": [[m, k], [k, n]],
                   "variant": gemm.variant(dt, m), "max_abs_err": err,
                   "kernel_ms": k_ms, "plain_ms": p_ms,
                   "library_ms": l_ms, "bound_ms": b_ms,
                   "bound_by": b_by, "bytes": nbytes,
                   "ops": 2 * m * n * k, "bound_share": b_ms / k_ms,
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
             "train": train["launches"]}
    at = {op: (op, "serve") for op in LM_OPS}
    at["gemm"] = ("gemm", "serve_m4_2048x8512")
    max_err["gemm"] = times[at["gemm"]]["max_abs_err"]
    for op in ALL_OPS + LM_OPS:
        t = times[at.get(op, (op, "figure2"))]
        by_path = {p: n[op] for p, n in paths.items() if n[op]}
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
