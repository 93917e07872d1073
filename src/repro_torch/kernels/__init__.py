"""Customized CUDA lowerings (the paper's "customized RVV implementations").

One module per compute hot-spot, each a hand-written CUDA kernel for the
H100 (``csrc/``, built by ``_build``) beside its plain torch version;
``ops.py`` is the public dispatched API and ``ref.py`` holds the plain
torch oracles.
"""
from . import ops, ref

__all__ = ["ops", "ref"]
