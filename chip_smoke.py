#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card::

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/kernels/csrc``, holds
each against its plain torch version on the card, drives the port's main
path (``ops.* -> registry.dispatch -> traced costs -> customized tier ->
CUDA kernel``) on the Figure-2 workloads of the paper, and times every
kernel beside its plain version, one PyTorch library call and the card's
memory-bound floor.  Each phase prints one JSON line; the last line is
``{"ok": true, "device": {...}}``.  Any failed check raises, and the run
exits non-zero without that line.  Without CUDA, or without the repo's
``src/`` beside it, it exits non-zero at once.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_OPS_PER_S = 67e12         # H100 SXM data sheet, fp32 outside tensor cores
OPS = ("vrelu", "vsqrt", "vtanh", "vsigmoid")
# The Pallas kernel each CUDA kernel replaces (file:line of its entry point)
REPLACES = {"vtanh": "src/repro/kernels/elementwise.py:156",
            "vsigmoid": "src/repro/kernels/elementwise.py:161",
            "vsqrt": "src/repro/kernels/elementwise.py:166",
            "vrelu": "src/repro/kernels/elementwise.py:171"}
SOURCE = "src/repro_torch/kernels/csrc/elementwise.cu"
# Tolerances of the kernel against its plain version: fp32 within a few
# ulps (the rsqrt seed is approximate on the card), bf16 one ulp at 1,
# vrelu bitwise.
TOL = {"float32": (1e-5, 2e-6), "bfloat16": (8e-3, 8e-3)}
# The Figure-2 clamp bounds of vrelu (benchmarks/xnnpack_suite.py)
RELU_BOUNDS = (0.0, 6.0)
EDGE = [0.0, -0.0, float("inf"), float("-inf"), float("nan"), 1e-40,
        20.0, -20.0, 30.0, -30.0, 35.0, -35.0, 0.5, 2.5]


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def extra_args(op):
    return RELU_BOUNDS if op == "vrelu" else ()


def workload(op, base):
    """The Figure-2 input of ``op`` made from standard normals ``base``
    (benchmarks/xnnpack_suite.py: workloads())."""
    if op == "vsqrt":
        return base.abs() + 0.01
    if op in ("vtanh", "vsigmoid"):
        return 2.0 * base
    return base


def compare(op, got, want):
    """Max abs error over finite entries; raises unless NaN and inf
    positions agree and the rest is within the stated tolerance."""
    import torch
    g, w = got.float(), want.float()
    if g.shape != w.shape or got.dtype != want.dtype:
        raise AssertionError(f"{op}: {got.shape}/{got.dtype} vs "
                             f"{want.shape}/{want.dtype}")
    if not torch.equal(g.isnan(), w.isnan()):
        raise AssertionError(f"{op}: NaN positions differ")
    if not torch.equal(g.isinf(), w.isinf()) or \
            not torch.equal(g[g.isinf()], w[w.isinf()]):
        raise AssertionError(f"{op}: inf positions differ")
    fin = g.isfinite()
    err = (g[fin] - w[fin]).abs()
    max_err = float(err.max()) if err.numel() else 0.0
    if op == "vrelu":
        if max_err != 0.0:
            raise AssertionError(f"vrelu: not bitwise, max err {max_err}")
        return max_err
    rtol, atol = TOL[str(got.dtype).replace("torch.", "")]
    bad = err > atol + rtol * w[fin].abs()
    if bool(bad.any()):
        raise AssertionError(f"{op}/{got.dtype}: {int(bad.sum())} entries "
                             f"beyond rtol {rtol} atol {atol}, max err "
                             f"{max_err}")
    return max_err


def time_ms(fn, flush, reps=25):
    """Median device time of ``fn`` in ms, from CUDA events around each
    call, after warm-up, with L2 flushed before each call."""
    import torch
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this run needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              "from a checkout of the repo", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.core import trace, use_target
    from repro_torch.core.registry import REGISTRY
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import elementwise as ew

    dev = torch.device("cuda")

    # 1. device ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    # 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build_all()
    ew._lib()
    emit("build", seconds=time.perf_counter() - t0,
         libraries={k: str(v.relative_to(ROOT)) for k, v in libs.items()})

    # 3. every kernel against its plain version on the card -------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    cases = [(s, dt) for s in ((1024, 1024), (127,), (3, 5, 7))
             for dt in (torch.float32, torch.bfloat16)]
    cases.append(((1 << 26,), torch.float32))
    max_err = {}
    for op in OPS:
        errs = []
        for shape, dt in cases:
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

    # 4. the main path ----------------------------------------------------
    committed = json.loads((ROOT / "BENCH_xnnpack.json").read_text())
    rng = np.random.default_rng(SEED)
    args = {}
    for op in OPS:
        base = torch.from_numpy(
            rng.standard_normal((1024, 1024)).astype(np.float32))
        args[op] = (workload(op, base).to(dev),) + extra_args(op)
    with use_target("rvv-128"):
        chosen = {op: REGISTRY.explain(op, *args[op])["chosen"]
                  for op in OPS}
    ew.reset_launches()
    outs, first_ms = {}, {}
    with use_target("rvv-128"), trace.count() as counted:
        for op in OPS:
            t0 = time.perf_counter()
            outs[op] = getattr(ops, op)(*args[op])
            torch.cuda.synchronize()
            first_ms[op] = (time.perf_counter() - t0) * 1e3
    launches = dict(ew.LAUNCHES)
    per_op = {op: counted["per_op"].get((op, "pallas"), 0) for op in OPS}
    want_counts = {op: committed["targets"]["rvv-128"][op]
                   ["customized_instrs"] for op in OPS}
    for op in OPS:
        if chosen[op] != "pallas":
            raise AssertionError(f"{op}: rvv-128 chose {chosen[op]}")
        if launches[op] != 1:
            raise AssertionError(f"{op}: {launches[op]} launches on the "
                                 "main path, expected 1")
        if per_op[op] != want_counts[op]:
            raise AssertionError(f"{op}: counted {per_op[op]}, committed "
                                 f"{want_counts[op]}")
    # what came out: right shape, finite, and within the reference's
    # kernel-test tolerance (tests/test_kernels.py TOL fp32 2e-4) of the
    # plain torch oracle
    oracle_err = {}
    for op in OPS:
        y = outs[op]
        want = getattr(ref, op)(*args[op])
        if y.shape != (1024, 1024) or not bool(y.isfinite().all()):
            raise AssertionError(f"{op}: bad output {y.shape}")
        if not torch.allclose(y, want, rtol=2e-4, atol=2e-4):
            raise AssertionError(f"{op}: disagrees with the torch oracle")
        oracle_err[op] = float((y - want).abs().max())
    with use_target("h100"):
        h100 = {op: REGISTRY.explain(op, *args[op])["chosen"] for op in OPS}
    emit("main_path", target="rvv-128", policy=REGISTRY.policy,
         chosen=chosen, launches=launches, counted=per_op,
         committed=want_counts, oracle_max_abs_err=oracle_err,
         h100_chosen=h100)

    # host time per call at the Figure-2 size: the main path's first call
    # (selection-cache miss), then back-to-back calls through the registry
    # and through the bare kernel wrapper, on the host clock
    calls = 200
    ops_ms, wrapper_ms = {}, {}
    for op in OPS:
        for fn, into in ((getattr(ops, op), ops_ms),
                         (ew.KERNELS[op], wrapper_ms)):
            with use_target("rvv-128"):
                fn(*args[op])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(calls):
                    fn(*args[op])
                torch.cuda.synchronize()
            into[op] = (time.perf_counter() - t0) / calls * 1e3
    emit("host", n=1 << 20, calls=calls, first_call_ms=first_ms,
         ops_call_ms=ops_ms, wrapper_call_ms=wrapper_ms,
         registry=REGISTRY.cache_info())

    # 5. times ------------------------------------------------------------
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MiB
    library = {"vrelu": lambda x: torch.clamp(x, *RELU_BOUNDS),
               "vsqrt": torch.sqrt, "vtanh": torch.tanh,
               "vsigmoid": torch.sigmoid}
    math_fn = {"vrelu": lambda x: ew.vrelu_math(x, *RELU_BOUNDS),
               "vsqrt": ew.vsqrt_math, "vtanh": ew.vtanh_math,
               "vsigmoid": ew.vsigmoid_math}
    times = {}
    for op in OPS:
        for n in (1 << 20, 1 << 26):
            x = workload(op, torch.randn(n, generator=gen, device=dev))
            ex = extra_args(op)
            k_ms = time_ms(lambda: ew.KERNELS[op](x, *ex), flush)
            p_ms = time_ms(lambda: ew.PLAIN[op](x, *ex), flush)
            l_ms = time_ms(lambda: library[op](x), flush)
            nbytes = 2 * n * x.element_size()
            with use_target("h100"):
                vreg = trace.vreg_for(x.dtype)
                n_ops = trace.fx_vector_instrs(math_fn[op], x) * vreg
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = n_ops / FP32_OPS_PER_S * 1e3
            row = {"op": op, "n": n, "dtype": "float32",
                   "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                   "bound_ms": max(bytes_ms, ops_ms),
                   "bound_by": "bytes" if bytes_ms >= ops_ms
                   else "operations",
                   "bytes": nbytes, "ops": n_ops,
                   "kernel_GBps": nbytes / (k_ms * 1e-3) / 1e9,
                   "library_GBps": nbytes / (l_ms * 1e-3) / 1e9}
            times[(op, n)] = row
            emit("time", **row)
    del flush

    # 6. kernels ----------------------------------------------------------
    kernels = []
    for op in OPS:
        t = times[(op, 1 << 20)]
        kernels.append({"name": op, "route": "cuda", "source": SOURCE,
                        "replaces": REPLACES[op], "launches": launches[op],
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
