"""Stub modality frontends: whisper's audio frames and pixtral's image
patches as precomputed (B, n, d) embeddings, drawn with numpy from the
seed as the JAX package's ``data/pipeline.py`` draws them.

Only :func:`extra_inputs` is here; the synthetic training data of that
module is not ported yet (ROADMAP A.13).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.targets import resolve_device


def extra_inputs(cfg, batch_size: int, seed: int = 0, device=None) -> dict:
    """{"frames": (B, n_frames, d)} for an encoder-decoder, {"patches":
    (B, n_patches, d)} for a vlm, {} otherwise; float32 standard normals
    on ``device`` (default: the card)."""
    device = resolve_device("cuda" if device is None else device)
    extra = {}
    if cfg.family == "encdec":
        rng = np.random.default_rng(seed)
        extra["frames"] = torch.from_numpy(
            rng.normal(size=(batch_size, cfg.n_frames, cfg.d_model))
            .astype(np.float32)).to(device)
    if cfg.family == "vlm":
        rng = np.random.default_rng(seed + 1)
        extra["patches"] = torch.from_numpy(
            rng.normal(size=(batch_size, cfg.n_patches, cfg.d_model))
            .astype(np.float32)).to(device)
    return extra
