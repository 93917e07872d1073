"""Architecture registry of the port: ``get_config(name)`` / ``--arch``.

The port's model stack has every block kind of the reference: the Mamba2
kinds (``mamba``, ``mamba_shared``), the GQA shared block, the ``attn``,
``local`` (sliding window), ``moe`` and ``moe_dense`` transformer blocks
with GQA or MLA attention, and whisper's ``enc`` and ``dec`` blocks (with
cross-attention); vlm patch inputs are prepended to the tokens.  An arch
that needs a module not ported yet, or whose serving check on the card
does not pass yet (mamba2-1.3b, pixtral-12b: their config modules are
here), is known by name but refused with the ROADMAP item that holds
it.
"""
from __future__ import annotations

import importlib

from .base import SHAPES, ModelConfig, ShapeConfig

# arch -> config module, for the archs whose block kinds are ported
_PORTED = {
    "zamba2-1.2b": "zamba2_1p2b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "minicpm3-4b": "minicpm3_4b",
    "gemma2-2b": "gemma2_2b",
    "gemma3-1b": "gemma3_1b",
    "whisper-tiny": "whisper_tiny",
    # its full depth trains only sharded (models/sharding.py); one card
    # holds it at cut depth
    "mistral-large-123b": "mistral_large_123b",
}
# arch -> what it still needs (ROADMAP A.9, in its order)
_WAITING = {
    "mamba2-1.3b": "a bf16 serving limit that its full depth can pass "
                   "(configs/mamba2_1p3b.py and its blocks are ported; "
                   "ROADMAP C.22)",
    "pixtral-12b": "a bf16 serving limit that its full depth can pass "
                   "(configs/pixtral_12b.py, its patch inputs and the "
                   "Engine's offset are ported; ROADMAP C.23)",
}

ARCH_NAMES = tuple(_PORTED)
# known by name, their configs ported, refused by get_config
HELD_NAMES = tuple(_WAITING)


def get_config(name: str) -> ModelConfig:
    if name in _WAITING:
        raise NotImplementedError(
            f"arch {name!r} needs {_WAITING[name]}, not ported yet "
            f"(ROADMAP A.9); ported: {ARCH_NAMES}")
    if name not in _PORTED:
        raise KeyError(f"unknown arch {name!r}; ported: {ARCH_NAMES}")
    return importlib.import_module(f".{_PORTED[name]}", __package__).CONFIG


__all__ = ["ARCH_NAMES", "HELD_NAMES", "SHAPES", "ModelConfig", "ShapeConfig",
           "get_config"]
