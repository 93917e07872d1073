"""Serving engine: batched prefill + decode over static-shape caches.

The engine owns a fixed-capacity request batch: prefill fills the
caches, decode advances every row one token per step (one
``serve_step``).  Greedy or temperature sampling.  PyTorch runs eagerly,
so the steps are the forward functions themselves (the reference jits
them); the caches are written in place.

``prefill`` and ``generate`` take the reference's ``extra``: the stub
frame (encdec) or patch (vlm) embeddings of ``data.pipeline.extra_inputs``.
A vlm's ``n_patches`` patches sit before the tokens, so its cache holds
``max_seq`` + ``n_patches`` positions and its rows start decoding at the
prompt's length plus ``n_patches``.

The cache holds positions 0 .. ``max_seq`` + that offset - 1.  ``decode``
refuses, before its first step, to run past them (ValueError), where the
reference drops the cache writes and goes on (ROADMAP C.11): on the card
such a write is an out-of-range index, a device-side assert that leaves
the CUDA context unusable.  The check reads the engine's host copy of the
position, never device data.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ..core.targets import resolve_device
from ..models import model as M


def make_prefill_step(cfg, target=None):
    def prefill(params, cache, batch):
        logits, cache, _ = M.forward(params, cfg, batch, mode="prefill",
                                     cache=cache, target=target)
        return logits[:, -1], cache
    return prefill


def make_serve_step(cfg, target=None):
    """One decode step: (params, cache, tokens, lengths) -> (logits, cache).

    ``target`` pins the step's attention/ssd lowering selections to an
    explicit machine model.
    """
    def serve_step(params, cache, tokens, lengths):
        logits, cache, _ = M.forward(params, cfg, {"tokens": tokens},
                                     mode="decode", cache=cache,
                                     lengths=lengths, target=target)
        return logits[:, 0], cache
    return serve_step


@dataclasses.dataclass
class Engine:
    cfg: Any
    params: Any
    max_batch: int
    max_seq: int
    temperature: float = 0.0
    target: Any = None             # explicit lowering target (None=ambient)
    device: Any = None             # None = the card
    # the next cache position every row writes: ``lengths`` kept on the
    # host, so the bound check never reads the device
    position: int = dataclasses.field(default=0, init=False)

    def __post_init__(self):
        self.device = resolve_device("cuda" if self.device is None
                                     else self.device)
        # the positions a vlm's patches take before the tokens
        self.p_off = self.cfg.n_patches if self.cfg.family == "vlm" else 0
        self.cache = M.init_cache(self.cfg, self.max_batch,
                                  self.max_seq + self.p_off, self.device)
        self.lengths = torch.zeros((self.max_batch,), dtype=torch.int32,
                                   device=self.device)
        self._prefill = make_prefill_step(self.cfg, self.target)
        self._step = make_serve_step(self.cfg, self.target)

    def prefill(self, prompts, extra: Optional[dict] = None):
        """prompts:(B, S_prompt), ``extra`` the frames or patches —
        fills the cache, returns first tokens."""
        prompts = torch.as_tensor(np.asarray(prompts), device=self.device)
        batch = {"tokens": prompts, **(extra or {})}
        last_logits, self.cache = self._prefill(self.params, self.cache,
                                                batch)
        self.position = prompts.shape[1] + self.p_off
        self.lengths = torch.full((prompts.shape[0],), self.position,
                                  dtype=torch.int32, device=self.device)
        return self._sample(last_logits)

    def decode(self, tokens: torch.Tensor, steps: int) -> np.ndarray:
        """Advance ``steps`` tokens for the whole batch; returns (B, steps).
        Raises ValueError, before any step, where a step would write at or
        past the cache's ``max_seq`` + ``p_off`` positions."""
        slots = self.max_seq + self.p_off
        if self.position + steps > slots:
            raise ValueError(
                f"decode: {steps} steps from position {self.position} would "
                f"write cache positions up to {self.position + steps - 1}, "
                f"past max_seq {self.max_seq}"
                + (f" + {self.p_off} patches" if self.p_off else ""))
        out = []
        cur = tokens
        for _ in range(steps):
            logits, self.cache = self._step(self.params, self.cache,
                                            cur[:, None], self.lengths)
            self.lengths = self.lengths + 1
            self.position += 1
            cur = self._sample(logits)
            out.append(cur)
        if not out:
            return np.zeros((tokens.shape[0], 0), np.int32)
        return torch.stack(out, dim=1).cpu().numpy()

    def _sample(self, logits) -> torch.Tensor:
        if self.temperature <= 0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        # seeded by the reference's rule (the sum of the lengths); torch's
        # draws are not jax.random's
        gen = torch.Generator(device=logits.device)
        gen.manual_seed(int(self.lengths.sum()))
        probs = torch.softmax(logits.to(torch.float32) / self.temperature,
                              dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0] \
            .to(torch.int32)

    def generate(self, prompts, steps: int,
                 extra: Optional[dict] = None) -> np.ndarray:
        first = self.prefill(prompts, extra)
        rest = self.decode(first, steps - 1)
        return np.concatenate([first.cpu().numpy()[:, None], rest], axis=1)
