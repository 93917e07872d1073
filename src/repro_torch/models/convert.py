"""Carry the JAX package's parameters across to the port.

The reference's ``init`` returns a pytree whose repeated unit is stacked
on a leading axis of length ``repeats`` (``lax.scan`` runs over it), and
whose encoder (whisper's ``enc``) is stacked on one of ``n_enc_layers``.
:func:`from_jax` takes that tree with numpy leaves, e.g.
``jax.tree.map(np.asarray, M.init(cfg, key))``, unstacks both axes
and returns the port's parameter dictionary on ``device``: the card
unless told otherwise, as every entry point of the port (the parity tests
pass ``device="cpu"``).  It needs no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.targets import resolve_device


def tensor(a, device=None) -> torch.Tensor:
    """A numpy array (float32, int, or ml_dtypes bfloat16) as a tensor on
    ``device`` (default: the card)."""
    device = resolve_device("cuda" if device is None else device)
    a = np.array(a)                     # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _unstack(stacked, n, what, device):
    """The list of the ``n`` trees stacked on ``stacked``'s leading axis."""
    for leaf in _leaves(stacked):
        if leaf.shape[0] != n:
            raise ValueError(f"{what}: leading axis {leaf.shape[0]} is not "
                             f"its {n} layers")
    return [_map(stacked, lambda a, r=r: tensor(a[r], device))
            for r in range(n)]


def from_jax(tree, cfg, device=None):
    """The port's params from the reference's (numpy leaves), on
    ``device`` (default: the card)."""
    device = resolve_device("cuda" if device is None else device)
    _, unit, reps, _ = cfg.pattern_unit()
    out = {k: _map(v, lambda a: tensor(a, device))
           for k, v in tree.items() if k not in ("unit", "enc")}
    out["unit"] = [_unstack(tree["unit"][j], reps, f"unit {j}", device)
                   for j in range(len(unit))]
    if "enc" in tree:
        out["enc"] = _unstack(tree["enc"], cfg.n_enc_layers, "enc", device)
    return out
