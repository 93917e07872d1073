"""Architecture registry of the port: ``get_config(name)`` / ``--arch``.

The port's model stack has every block kind of the reference: the Mamba2
kinds (``mamba``, ``mamba_shared``), the GQA shared block, the ``attn``,
``local`` (sliding window), ``moe`` and ``moe_dense`` transformer blocks
with GQA or MLA attention, and whisper's ``enc`` and ``dec`` blocks (with
cross-attention); vlm patch inputs are prepended to the tokens.  Every
arch of the reference is served and trained; an unknown name is
refused.
"""
from __future__ import annotations

import importlib

from .base import SHAPES, ModelConfig, ShapeConfig

# arch -> config module
_PORTED = {
    "zamba2-1.2b": "zamba2_1p2b",
    "mamba2-1.3b": "mamba2_1p3b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "minicpm3-4b": "minicpm3_4b",
    "gemma2-2b": "gemma2_2b",
    "gemma3-1b": "gemma3_1b",
    "whisper-tiny": "whisper_tiny",
    "pixtral-12b": "pixtral_12b",
    # its full depth trains only sharded (models/sharding.py); one card
    # holds it at cut depth
    "mistral-large-123b": "mistral_large_123b",
}

ARCH_NAMES = tuple(_PORTED)


def get_config(name: str) -> ModelConfig:
    if name not in _PORTED:
        raise KeyError(f"unknown arch {name!r}; ported: {ARCH_NAMES}")
    return importlib.import_module(f".{_PORTED[name]}", __package__).CONFIG


def all_configs():
    """Every arch's config, by name."""
    return {name: get_config(name) for name in ARCH_NAMES}


__all__ = ["ARCH_NAMES", "SHAPES", "ModelConfig", "ShapeConfig",
           "get_config", "all_configs"]
