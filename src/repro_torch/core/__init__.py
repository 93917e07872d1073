"""repro_torch.core — the paper's contribution as a composable PyTorch feature.

A portability layer that maps a fixed-width logical vector ISA (NEON
semantics) onto a target vector machine through a set of lowerings
(generic / vector / customized kernel) chosen per (op, shape, dtype,
target) by evaluated instruction cost, with explicit type-tiling and
tail predication.  The PyTorch counterpart of ``repro.core``, the
logical-op table (``isa``) that the NEON frontend issues included.
"""
from . import isa, masks, registry, targets, trace, vtypes
from .registry import (REGISTRY, dispatch, explain, register, select,
                       use_policy)
from .targets import (Target, compile_target, current_target, get_target,
                      set_default_target, use_target, with_lmul)
from .vtypes import LVec, TileMap, neon_type_table, tile_for

__all__ = [
    "isa", "masks", "registry", "targets", "trace", "vtypes",
    "REGISTRY", "dispatch", "explain", "register", "select", "use_policy",
    "Target", "compile_target", "current_target", "get_target",
    "set_default_target", "use_target", "with_lmul",
    "LVec", "TileMap", "neon_type_table", "tile_for",
]
