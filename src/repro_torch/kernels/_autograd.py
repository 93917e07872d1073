"""What the kernels' autograd Functions share.

No kernel of the JAX package has a backward kernel, and the reference
never differentiates through one: it trains on its vector tier.  Each
kernel on the port's train path (gemm, vtanh, vsigmoid, flash_attention,
ssd) has a ``torch.autograd.Function`` in its module whose forward
launches the kernel (with grad mode off, so ``_build.route`` lets it) and
whose backward is the kernel's gradient in torch ops, or the gradient of
the op's vector tier recomputed from the saved inputs.  ``ops.py`` picks
the Function where :func:`wants_grad` holds and the bare kernel
elsewhere, so serving is unchanged.
"""
from __future__ import annotations

import torch


def wants_grad(*tensors) -> bool:
    """Whether autograd must see through a call on ``tensors``."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def vjp(fn, inputs, grad, needs, batched, rows=None):
    """The gradients of ``fn(*inputs)`` against ``grad``, by autograd
    through ``fn`` recomputed from detached copies of the inputs: one per
    input, None where ``needs`` is false or the input is None.

    ``rows`` cuts the batch (dim 0 of the inputs ``batched`` marks, and of
    ``grad``) into runs of that many rows, each recomputed and
    differentiated alone, which bounds the memory the recompute holds;
    the gradients of the unbatched inputs are summed over the runs.
    ``fn`` must treat the rows of a batch independently."""
    n = grad.shape[0]
    rows = n if rows is None else max(1, rows)
    parts = [[] for _ in inputs]
    for lo in range(0, n, rows):
        part = [None if t is None else
                (t[lo:lo + rows] if b else t).detach().requires_grad_(
                    bool(w) and t.is_floating_point())
                for t, b, w in zip(inputs, batched, needs)]
        want = [i for i, t in enumerate(part)
                if t is not None and t.requires_grad]
        if not want:
            break
        with torch.enable_grad():
            y = fn(*part)
        got = torch.autograd.grad(y, [part[i] for i in want],
                                  grad[lo:lo + rows])
        for i, gi in zip(want, got):
            parts[i].append(gi)
    return [None if not p else torch.cat(p) if b else sum(p[1:], p[0])
            for p, b in zip(parts, batched)]
