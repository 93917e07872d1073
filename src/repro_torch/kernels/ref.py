"""Plain torch oracles — the paper's "original SIMDe" tier.

Each function is the straightforward whole-tensor translation a generic
portability layer produces: op-by-op, no fusion, fp32 math.  They serve
two roles:

  1. correctness oracle for the customized kernels,
  2. the *baseline* side of the paper's Figure-2 comparison (the
     registry's vector tier costs them by walking their aten graphs).

The elementwise four are here; the other oracles arrive with their
kernels.
"""
from __future__ import annotations

import torch


# ---------------------------------------------------------------------------
# elementwise: vrelu (clamp), vsqrt, vtanh, vsigmoid
# ---------------------------------------------------------------------------

def vrelu(x, clamp_min=0.0, clamp_max=float("inf")):
    """XNNPACK vrelu is a minmax clamp."""
    return torch.clamp(x, clamp_min, clamp_max)


def vsqrt(x):
    return torch.sqrt(x.to(torch.float32)).to(x.dtype)


def vtanh(x):
    return torch.tanh(x.to(torch.float32)).to(x.dtype)


def vsigmoid(x):
    return torch.sigmoid(x.to(torch.float32)).to(x.dtype)
