"""Carry the JAX package's parameters across to the port.

The reference's ``init`` returns a pytree whose repeated unit is stacked
on a leading axis of length ``repeats`` (``lax.scan`` runs over it), and
whose encoder (whisper's ``enc``) is stacked on one of ``n_enc_layers``.
:func:`from_jax` takes that tree with numpy leaves, e.g.
``jax.tree.map(np.asarray, M.init(cfg, key))``, unstacks both axes
and returns the port's parameter dictionary on ``device``: the card
unless told otherwise, as every entry point of the port (the parity tests
pass ``device="cpu"``).  It carries the reference's optimizer state
across the same way, so that both packages can start a train step from
the same state.  It needs no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import tree as T
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
    return T.map(fn, tree)


def _unstack(stacked, n, what, device):
    """The list of the ``n`` trees stacked on ``stacked``'s leading axis."""
    for leaf in T.leaves(stacked):
        if leaf.shape[0] != n:
            raise ValueError(f"{what}: leading axis {leaf.shape[0]} is not "
                             f"its {n} layers")
    return [_map(stacked, lambda a, r=r: tensor(a[r], device))
            for r in range(n)]


OPT_KEYS = {"m", "v", "master", "step"}


def from_jax(tree, cfg, device=None):
    """The port's params from the reference's (numpy leaves), on
    ``device`` (default: the card).  Given the reference's ``adamw.init``
    state instead (its ``m``, ``v`` and ``master`` in the params' tree,
    ``step`` a scalar), the port's optimizer state."""
    device = resolve_device("cuda" if device is None else device)
    if set(tree) == OPT_KEYS:
        return {**{k: from_jax(tree[k], cfg, device)
                   for k in ("m", "v", "master")},
                "step": tensor(tree["step"], device)}
    _, unit, reps, _ = cfg.pattern_unit()
    out = {k: _map(v, lambda a: tensor(a, device))
           for k, v in tree.items() if k not in ("unit", "enc")}
    out["unit"] = [_unstack(tree["unit"][j], reps, f"unit {j}", device)
                   for j in range(len(unit))]
    if "enc" in tree:
        out["enc"] = _unstack(tree["enc"], cfg.n_enc_layers, "enc", device)
    return out
