"""Predicated tails: the paper's Listing-4 correctness fix, in shape space.

SIMDe's generic store memcpy's ``sizeof(union)`` bytes, which clobbers
memory when the physical vector (RVV register) is wider than the logical
NEON vector.  The paper's customized conversion passes the exact element
count ``vl`` to the predicated RVV store.  The same hazard appears
whenever a logical extent is padded to a hardware tile: reductions read
garbage lanes, stores write past the logical extent.  These helpers build
the masks/pads that keep padded-tile compute exact.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from .targets import resolve_device
from .vtypes import TileMap


def pad_to(x: torch.Tensor, padded_shape: Sequence[int],
           value=0) -> torch.Tensor:
    """Pad trailing dims of ``x`` up to ``padded_shape`` with ``value``."""
    off = len(padded_shape) - x.ndim
    pads = []
    for i, d in enumerate(x.shape):
        tgt = padded_shape[i + off]
        if tgt < d:
            raise ValueError(f"cannot pad dim {i}: {d} > {tgt}")
        pads.append(tgt - d)
    if not any(pads):
        return x
    # F.pad lists (before, after) pairs from the last dim backwards
    spec = []
    for p in reversed(pads):
        spec += [0, p]
    return F.pad(x, spec, value=value)


def unpad(x: torch.Tensor, logical_shape: Sequence[int]) -> torch.Tensor:
    """Slice a padded tile back to its logical extent (the ``vl`` store)."""
    lead = x.ndim - len(logical_shape)
    idx = (slice(None),) * lead + tuple(slice(0, d) for d in logical_shape)
    return x[idx]


def tail_mask(logical_shape: Sequence[int], padded_shape: Sequence[int],
              dtype=torch.bool, device="cuda") -> torch.Tensor:
    """Boolean mask of shape ``padded_shape`` that is True on logical lanes.

    This is the ``vl`` predicate of RVV generalized to N-D tiles:
    reductions over a padded tile must be taken under this mask, and
    masked stores must write only where it is True.
    """
    dev = resolve_device(device)
    m = None
    for l, p in zip(logical_shape, padded_shape):
        nxt = torch.arange(p, device=dev) < l
        m = nxt if m is None else m[..., None] & nxt
    return m.to(dtype)


def masked_select(x: torch.Tensor, tm: TileMap, fill) -> torch.Tensor:
    """Replace padding lanes with ``fill`` (identity element for reductions)."""
    m = tail_mask(tm.logical.shape, tm.physical[-len(tm.logical.shape):],
                  device=x.device)
    return torch.where(m, x, torch.tensor(fill, dtype=x.dtype,
                                          device=x.device))


def masked_store(dst: torch.Tensor, src: torch.Tensor,
                 logical_shape: Sequence[int]) -> torch.Tensor:
    """Functional predicated store: write ``src``'s logical lanes into dst.

    ``dst`` and ``src`` share the padded shape; only the logical extent of
    ``src`` lands in the result — the rest of ``dst`` is preserved, which
    is exactly what ``__riscv_vse32_v_i32m1(ptr, v, vl)`` guarantees and
    memcpy-of-union does not (paper Listing 4).
    """
    m = tail_mask(logical_shape, src.shape[-len(logical_shape):],
                  device=src.device)
    return torch.where(m.expand(src.shape), src, dst)


def padded_and_mask(x: torch.Tensor,
                    tm: TileMap) -> Tuple[torch.Tensor, torch.Tensor]:
    xp = pad_to(x, tm.physical)
    m = tail_mask(x.shape, xp.shape, device=x.device)
    return xp, m
