"""Synthetic LM data and stub modality frontends, drawn with numpy from
the seed exactly as the JAX package's ``data/pipeline.py`` draws them.

:class:`SyntheticLM` makes (tokens, targets) next-token batches: documents
of Zipf-ish unigrams packed back to back with EOS separators into fixed
rows, each row deterministic in (seed, step, row), so every host draws
only its slice and a restart resumes the stream from the step counter.
The rows are bitwise the reference's.  :func:`extra_inputs` makes
whisper's audio frames and pixtral's image patches as precomputed
(B, n, d) embeddings.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.targets import resolve_device


@dataclasses.dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    eos: int = 1
    mean_doc_len: int = 256

    def _rng(self, step: int, row: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, row]))

    def _row(self, step: int, row: int) -> np.ndarray:
        rng = self._rng(step, row)
        out = np.empty(self.seq_len + 1, np.int32)
        pos = 0
        # zipf-ish unigram over the vocab, shifted past specials
        while pos < self.seq_len + 1:
            doc_len = min(1 + rng.geometric(1.0 / self.mean_doc_len),
                          self.seq_len + 1 - pos)
            z = rng.zipf(1.3, size=doc_len)
            doc = (z % max(2, self.vocab_size - 2)) + 2
            out[pos:pos + doc_len] = doc
            pos += doc_len
            if pos < self.seq_len + 1:
                out[pos] = self.eos
                pos += 1
        return out

    def batch(self, step: int, rows=None, device=None,
              dtype=torch.int64) -> dict:
        """{"tokens", "targets"}: (rows, seq_len) ``dtype`` tensors on
        ``device`` (default: the card).  rows: optional row indices (host
        sharding)."""
        device = resolve_device("cuda" if device is None else device)
        rows = range(self.global_batch) if rows is None else rows
        arr = torch.from_numpy(np.stack([self._row(step, r) for r in rows]))
        arr = arr.to(device=device, dtype=dtype)
        return {"tokens": arr[:, :-1], "targets": arr[:, 1:]}

    def host_batch(self, step: int, host_id: int, n_hosts: int,
                   device=None, dtype=torch.int64) -> dict:
        per = self.global_batch // n_hosts
        return self.batch(step, range(host_id * per, (host_id + 1) * per),
                          device, dtype)


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
