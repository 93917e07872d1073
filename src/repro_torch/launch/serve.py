"""Serving launcher: batched generation with the Engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \
      --reduced --device cpu --batch 4 --prompt-len 16 --gen 32

Without ``--device`` it runs on the card.  Weights come from a seeded
``torch.Generator`` on the device, the prompts from numpy, and whisper's
frames and pixtral's patches from ``data.pipeline.extra_inputs``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=None)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from ..configs import get_config
    from ..core.targets import resolve_device
    from ..data.pipeline import extra_inputs
    from ..models import model as M
    from ..serve.engine import Engine

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = M.init(cfg, gen, dev)
    max_seq = args.max_seq or (args.prompt_len + args.gen + 8)
    eng = Engine(cfg, params, max_batch=args.batch, max_seq=max_seq,
                 temperature=args.temperature, device=dev)
    prompts = np.random.default_rng(args.seed).integers(
        2, cfg.vocab_size, (args.batch, args.prompt_len), dtype=np.int64)
    extra = extra_inputs(cfg, args.batch, args.seed, dev)
    t0 = time.perf_counter()
    out = eng.generate(prompts, args.gen, extra)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"generated {out.shape} on {dev} in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s)")
    for row in out[: min(2, args.batch)]:
        print("  ", row.tolist())
    return out


if __name__ == "__main__":
    main()
