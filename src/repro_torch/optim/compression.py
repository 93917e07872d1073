"""Gradient compression: int8 quantization with error feedback, in torch.

The JAX package's ``compress`` / ``decompress`` / ``err_init`` step for
step: each leaf (plus its carried error) is scaled by max|x| / 127,
rounded half to even (``torch.round``, as ``jnp.round``), clipped to
[-127, 127] and stored as int8; the rounding error is carried into the
next step.  The int8 payloads are bitwise the reference's.  Its
``compressed_psum`` is a collective and waits for the port's
distribution (ROADMAP A.13).
"""
from __future__ import annotations

import torch

from .. import tree


def _q(x, err):
    xf = x.to(torch.float32) + (err if err is not None else 0.0)
    scale = torch.clamp(torch.max(torch.abs(xf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    new_err = xf - q.to(torch.float32) * scale
    return q, scale, new_err


def compress(grads, err_state=None):
    """-> ({"q": int8 tree, "scale": fp32 scalar tree}, new error tree)."""
    leaves = tree.leaves(grads)
    errs = tree.leaves(err_state) if err_state is not None else \
        [None] * len(leaves)
    out = [_q(g, e) for g, e in zip(leaves, errs)]
    return ({"q": tree.unflatten(grads, [o[0] for o in out]),
             "scale": tree.unflatten(grads, [o[1] for o in out])},
            tree.unflatten(grads, [o[2] for o in out]))


def decompress(packed):
    return tree.map(lambda q, s: q.to(torch.float32) * s, packed["q"],
                    packed["scale"])


def err_init(grads_like):
    return tree.map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_like)
