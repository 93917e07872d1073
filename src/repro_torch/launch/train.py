"""Training launcher, on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
      --reduced --device cpu --steps 200 --batch 8 --seq 128 \\
      --ckpt-dir build/ckpt --resume auto

  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \\
      --steps 8 --batch 8 --seq 4096 --accum 2

Without ``--device`` it runs on the card.  The weights come from a seeded
``torch.Generator``, the data from ``data.pipeline.SyntheticLM`` (and
whisper's frames from ``extra_inputs``).  The multi-host path of the
JAX package's launcher (``--coordinator``, ``--num-hosts``,
``--host-id``) waits for the port's distribution and is refused.
"""
from __future__ import annotations

import argparse
import logging
import shutil


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", choices=("auto", "none"), default="auto")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    # multi-host deployment: not ported
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-hosts", type=int, default=1)
    ap.add_argument("--host-id", type=int, default=0)
    args = ap.parse_args(argv)

    if args.coordinator or args.num_hosts > 1:
        raise NotImplementedError(
            "multi-host training (--coordinator, --num-hosts) is the "
            "distribution part of ROADMAP A.13, not ported yet; this "
            "launcher trains on one device")

    logging.basicConfig(level=logging.INFO)
    from ..configs import get_config
    from ..optim.adamw import AdamWConfig
    from ..train.loop import TrainConfig, train

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tcfg = TrainConfig(
        accum=args.accum, compress_grads=args.compress_grads,
        optim=AdamWConfig(lr=args.lr, total_steps=args.steps))
    if args.resume == "none" and args.ckpt_dir:
        shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    res = train(cfg, steps=args.steps, batch_size=args.batch,
                seq_len=args.seq, tcfg=tcfg, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, seed=args.seed,
                device=args.device)
    last = res["history"][-1]
    print(f"done: step {last['step']} loss {last['loss']:.4f} "
          f"restarts {res['restarts']} stragglers {len(res['watchdog'])}")


if __name__ == "__main__":
    main()
