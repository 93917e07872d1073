"""Logical vector types and their mapping onto physical tiles.

This is the analogue of the paper's *type conversion* strategy (SIMDe
§3.2, Table 2).  The paper maps fixed-width NEON register types
(64/128-bit) onto RISC-V VLA register types whenever ``vlen >= logical
width``.  A fixed-tile machine has the same problem inverted: logical
tiles must be packed into hardware-native shapes.  On the H100 the
minor dimension is a warp of 32 lanes, the matrix tile is ``wgmma``'s
64 rows, and the scratch budget is the shared memory one block can use.

``TileMap`` carries the (logical shape -> padded physical tile, tail
mask) mapping, which plays the role of the paper's NEON-type ->
vint*m1_t table, and the ``vl``-style element count that makes partial
stores correct (paper Listing 4).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import numpy as np
import torch

from .targets import Target, itemsize, resolve_target

# A ``target=None`` parameter below means "the active target" — callers
# may also pass a Target or a registered name.


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# Logical vectors and the tile map (Table 2 analogue)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LVec:
    """A *logical* fixed-shape vector, like a NEON register type.

    NEON's int32x4_t is ``LVec((4,), torch.int32)``.  The abstraction is
    shape+dtype, decoupled from physical layout, exactly like SIMDe's
    generic union.
    """

    shape: Tuple[int, ...]
    dtype: torch.dtype

    @property
    def elems(self) -> int:
        return math.prod(self.shape) if self.shape else 1

    @property
    def bits(self) -> int:
        return self.elems * itemsize(self.dtype) * 8


@dataclasses.dataclass(frozen=True)
class TileMap:
    """Mapping of a logical vector onto a padded physical tile.

    ``valid`` is the paper's substitution rule: NEON type ``t`` maps onto
    an RVV register iff ``vlen >= width(t)``; here a logical tile maps
    onto a physical tile iff every logical dim fits the padded dim.
    ``vl`` is the number of *meaningful* elements.
    """

    logical: LVec
    physical: Tuple[int, ...]

    @property
    def valid(self) -> bool:
        if len(self.physical) < len(self.logical.shape):
            return False
        pad = self.physical[len(self.physical) - len(self.logical.shape):]
        return all(l <= p for l, p in zip(self.logical.shape, pad))

    @property
    def vl(self) -> int:
        return self.logical.elems

    @property
    def padded_elems(self) -> int:
        return math.prod(self.physical)

    @property
    def waste(self) -> float:
        """Fraction of physical lanes that carry no logical data."""
        return 1.0 - self.vl / max(1, self.padded_elems)


def tile_for(lv: LVec, target: Optional[Union[str, Target]] = None, *,
             mxu: bool = False) -> TileMap:
    """Compute the physical tile for a logical vector (the Table-2 lookup).

    1-D logical vectors are laid out along lanes of a single row; >=2-D
    tiles pad the minor dim to the lane width and the second-minor dim
    to the dtype sublane count (or the matrix tile for MXU operands).
    """
    target = resolve_target(target)
    shape = lv.shape
    if len(shape) == 0:
        return TileMap(lv, (1, target.lane))
    if len(shape) == 1:
        return TileMap(lv, (1, round_up(shape[0], target.lane)))
    second = target.mxu if mxu else target.sublane(lv.dtype)
    phys = tuple(shape[:-2]) + (
        round_up(shape[-2], second),
        round_up(shape[-1], target.lane),
    )
    return TileMap(lv, phys)


# ---------------------------------------------------------------------------
# The NEON type table (the paper's Table 2)
# ---------------------------------------------------------------------------

NEON_TYPES = {
    # 64-bit D registers
    "int8x8_t": ((8,), torch.int8), "int16x4_t": ((4,), torch.int16),
    "int32x2_t": ((2,), torch.int32), "int64x1_t": ((1,), torch.int64),
    "uint8x8_t": ((8,), torch.uint8), "uint16x4_t": ((4,), torch.uint16),
    "uint32x2_t": ((2,), torch.uint32), "uint64x1_t": ((1,), torch.uint64),
    "float16x4_t": ((4,), torch.float16),
    "float32x2_t": ((2,), torch.float32),
    "float64x1_t": ((1,), torch.float64),
    # 128-bit Q registers
    "int8x16_t": ((16,), torch.int8), "int16x8_t": ((8,), torch.int16),
    "int32x4_t": ((4,), torch.int32), "int64x2_t": ((2,), torch.int64),
    "uint8x16_t": ((16,), torch.uint8), "uint16x8_t": ((8,), torch.uint16),
    "uint32x4_t": ((4,), torch.uint32), "uint64x2_t": ((2,), torch.uint64),
    "float16x8_t": ((8,), torch.float16),
    "float32x4_t": ((4,), torch.float32),
    "float64x2_t": ((2,), torch.float64),
}


def neon_lvec(type_name: str) -> LVec:
    """The LVec for a NEON register type name (KeyError if unknown)."""
    shape, dtype = NEON_TYPES[type_name]
    return LVec(shape, dtype)


# torch dtype <-> numpy dtype name (the reference's lane names)
_NAME = {torch.float16: "float16", torch.float32: "float32",
         torch.float64: "float64", torch.bfloat16: "bfloat16",
         torch.int8: "int8", torch.int16: "int16", torch.int32: "int32",
         torch.int64: "int64", torch.uint8: "uint8", torch.uint16: "uint16",
         torch.uint32: "uint32", torch.uint64: "uint64", torch.bool: "bool"}
_OF_NAME = {v: k for k, v in _NAME.items()}


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype for a torch dtype, a numpy dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _OF_NAME[np.dtype(dtype).name]


def dtype_name(dtype) -> str:
    """The numpy name of a lane dtype ('float32', 'uint16', ...)."""
    return _NAME[torch_dtype(dtype)]


def numpy_dtype(dtype) -> np.dtype:
    """The numpy dtype of the same name as a torch dtype."""
    return np.dtype(dtype_name(dtype))


def neon_type_table(target: Optional[Union[str, Target]] = None):
    """NEON type -> TileMap on ``target`` — the Table 2 analogue.

    Every NEON type is mappable on a fixed-tile machine; the ``waste``
    column shows why whole-tile batching rather than per-register
    emulation is the right adaptation.
    """
    target = resolve_target(target)
    return {name: tile_for(LVec(shape, dtype), target)
            for name, (shape, dtype) in NEON_TYPES.items()}


def vmem_fit(block_elems_by_dtype,
             target: Optional[Union[str, Target]] = None,
             headroom: float = 0.9) -> bool:
    """True if the summed block working set fits the target's scratch
    budget: on ``h100`` the shared memory one block can use (targets
    with no scratch constraint always fit)."""
    target = resolve_target(target)
    if target.vmem_bytes is None:
        return True
    total = sum(int(n) * itemsize(dt) for n, dt in block_elems_by_dtype)
    return total <= target.vmem_bytes * headroom
