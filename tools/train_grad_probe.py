#!/usr/bin/env python3
"""Readings behind the gradient gates of ``chip_smoke.py``, on one NVIDIA
GPU.

Run from the root of a checkout::

    python3 tools/train_grad_probe.py [SEED ...]

zamba2-1.2b at full width and depth, params and SyntheticLM tokens drawn
from each SEED (default: the smoke's ``SEED`` and the next one):

  * ``grad``: ``train_grad``'s float32 gate (``chip_smoke.grad_gate``) at
    its 2 x 1024 tokens: every leaf but Mamba2's A_log held to 2e-4 of
    the vector tier's, the A_log leaves to their float64 gradient;
  * ``step0``: ``train``'s bf16 step-0 gate (``chip_smoke.step0_gate``)
    at its 8 x 4096 tokens: the loss, the gradient's norm, the median
    and the worst leaf.

On the first seed each gate is read again with each of ``FAULTS``
planted on the kernel tier (the vector tier's run is the one above),
and must fail:

  * ``gemm_bf16``: gemm's kernel entry given its operands rounded to
    bf16 (the float32 gate only: bf16 operands are so already);
  * ``ssd_no_dt``: ssd's Function returning a zero gradient for dt (a
    gradient missing from a small leaf, dt_bias);
  * ``ssd_dD_x1.5``: ssd's Function's gradient for D 1.5 times too large
    (a small leaf's gradient scaled).

Prints one JSON line a reading (its failures listed), then the card's
name and power limit as ``nvidia-smi`` gives them.  Exits 1 where a sound
run fails its gate or a faulty one passes.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

FAULTS = ("gemm_bf16", "ssd_no_dt", "ssd_dD_x1.5")


def planted(fault):
    """Plant ``fault`` (one of FAULTS); returns what to restore."""
    import torch
    from repro_torch.kernels import gemm as gemm_mod
    from repro_torch.kernels import ssd as ssd_mod
    if fault == "gemm_bf16":
        entry = gemm_mod.gemm

        def rounded(a, b, *rest):
            return entry(a.to(torch.bfloat16).to(a.dtype),
                         b.to(torch.bfloat16).to(b.dtype), *rest)
        gemm_mod.gemm = rounded
        return gemm_mod, "gemm", entry
    backward = ssd_mod.SsdFn.backward

    def faulty(ctx, g):
        dx, ddt, da, db, dc, dd, chunk = backward(ctx, g)
        if fault == "ssd_no_dt":
            ddt = torch.zeros_like(ddt)
        else:
            dd = dd * 1.5
        return dx, ddt, da, db, dc, dd, chunk
    ssd_mod.SsdFn.backward = staticmethod(faulty)
    return ssd_mod.SsdFn, "backward", staticmethod(backward)


def main(argv=None) -> int:
    import torch
    args = sys.argv[1:] if argv is None else argv
    seeds = [int(a) for a in args] or [cs.SEED, cs.SEED + 1]
    if not torch.cuda.is_available():
        print("train_grad_probe: torch.cuda is not available",
              file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import _build
    from repro_torch.models import model as M
    from repro_torch.train import loop
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    dev = torch.device("cuda")
    wrong = []

    def report(gate, seed, fault, record, failures):
        print(json.dumps({"gate": gate, "seed": seed, "fault": fault,
                          **record}), flush=True)
        if bool(failures) != (fault is not None):
            wrong.append((gate, seed, fault))

    def params_of(cfg, seed):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return loop.trainable(M.init(cfg, gen, dev))

    for i, seed in enumerate(seeds):
        faults = FAULTS if i == 0 else ()
        # the float32 gate at train_grad's tokens
        cfg = get_config(cs.TRAIN["arch"]).replace(dtype="float32")
        params = params_of(cfg, seed)
        batch = SyntheticLM(cfg.vocab_size, cs.TRAIN_GRAD["seq"],
                            cs.TRAIN_GRAD["batch"], seed=seed).batch(
                                0, device=dev)
        names = cs.leaf_names(params)
        vector = cs.grads_of(cfg, params, batch, "vector")[::2]
        exact = cs.float64_grads(cfg, params, batch, cs.a_log_leaves(names))
        for fault in (None,) + faults:
            restore = planted(fault) if fault else None
            try:
                kernel = cs.grads_of(cfg, params, batch, "pallas")[::2]
            finally:
                if restore:
                    setattr(*restore)
            report("grad", seed, fault, *cs.grad_gate(
                kernel, vector, exact, names, "grad"))
            del kernel
        del params, vector, exact
        torch.cuda.empty_cache()
        # the bf16 step-0 gate at train's tokens
        cfg = get_config(cs.TRAIN["arch"])
        params = params_of(cfg, seed)
        b = cs.TRAIN["batch"]
        batch = SyntheticLM(cfg.vocab_size, cs.TRAIN["seq"], b,
                            seed=seed).batch(0, device=dev)
        vector = cs.mean_grads(cfg, params, batch, b // 2, "vector")
        for fault in (None,) + tuple(f for f in faults if f != "gemm_bf16"):
            restore = planted(fault) if fault else None
            try:
                kernel = cs.mean_grads(cfg, params, batch,
                                       cs.TRAIN["accum"], "pallas")
            finally:
                if restore:
                    setattr(*restore)
            report("step0", seed, fault, *cs.step0_gate(
                kernel, vector, names, "step0"))
            del kernel
        del params, vector
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    if wrong:
        print(f"train_grad_probe: gates that read the wrong way: {wrong}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
