"""Customized lowering of XNNPACK ibilinear (bilinear interpolation).

XNNPACK precomputes per-output-pixel top-left corners and fractional
weights, and the NEON microkernel loads 2x2 corner pairs.  The
reference's TPU kernel brings the corners in by scalar prefetch and
slices 2x2xC corners out of a whole image held in VMEM.  The CUDA kernel
(``csrc/ibilinear.cu``) keeps the image in global memory: a group of
threads takes a pixel, each thread 16 bytes of channels at a time (4
fp32 or 8 bf16; one channel where C or an operand's alignment does not
allow a vector), several pixels a warp when C is small; a pixel's
iy/ix/wy/wx are read once and shared by shuffle, its four corner loads
(two adjacent runs a row) issued before the blend, corner reads clamped
to the image.  :func:`ibilinear_plan` picks the vector width, the group,
the block size and 32- or 64-bit image offsets; the C entry point
re-checks each claim and refuses one that does not hold.

Layouts are the reference's: img (H, W, C) float32 or bfloat16, iy/ix
(P,) int32 top-left corners in [0, H-2] x [0, W-2], wy/wx (P,) float32
weights; the output is (P, C) of img's dtype.

``ibilinear_plain`` is the kernel's blend in fp32 torch ops, step for
step; the wrapper launches the kernel for CUDA tensors (counted in
``LAUNCHES``) and runs the plain version for CPU tensors.  ``supports``
keeps the reference's rule that the image fit the scratch budget on the
targets that have one (tpu-*); on a ``cuda``-kind target the kernel
reads the image from global memory and only its own limits apply.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..core import trace
from ..core.vtypes import vmem_fit
from . import _build

LAUNCHES = {"ibilinear": 0}


def ibilinear_plain(img, iy, ix, wy, wx):
    """top = c00*(1-wx) + c01*wx, bot = c10*(1-wx) + c11*wx,
    out = top*(1-wy) + bot*wy in fp32, corners clamped to the image,
    rounded once to img's dtype."""
    h, w, _ = img.shape
    f = img.to(torch.float32)
    y0, x0 = iy.long(), ix.long()
    y1, x1 = (y0 + 1).clamp(0, h - 1), (x0 + 1).clamp(0, w - 1)
    y0, x0 = y0.clamp(0, h - 1), x0.clamp(0, w - 1)
    fy = wy.to(torch.float32)[:, None]
    fx = wx.to(torch.float32)[:, None]
    top = f[y0, x0] * (1 - fx) + f[y0, x1] * fx
    bot = f[y1, x0] * (1 - fx) + f[y1, x1] * fx
    return (top * (1 - fy) + bot * fy).to(img.dtype)


def ibilinear_plan(img_shape, p, dtype, vector: bool) -> dict:
    """The kernel's launch shape for an image of ``img_shape`` (H, W, C)
    and ``dtype`` at ``p`` pixels.  ``vector`` (``_build.vector16``): a
    thread takes 16-byte vectors of channels (``lanes`` 4 fp32 or 8
    bf16), else one channel at a time.  ``group`` threads take a pixel:
    the C // lanes vectors rounded up to a power of two, at most 32 (a
    group loops over more); ``pixels_per_warp`` = 32 // group; blocks of
    ``threads`` (``_build.spread``).  ``wide``: 64-bit offsets, where
    H*W*C or P*C reach 2^31."""
    h, w, c = img_shape
    lanes = _build.lanes(dtype, vector)
    group = min(32, 1 << (c // lanes - 1).bit_length())
    per_warp = 32 // group
    threads, blocks = _build.spread(max(1, -(-p // per_warp)) * 32)
    return {"vector": vector, "lanes": lanes, "group": group,
            "pixels_per_warp": per_warp, "threads": threads,
            "blocks": blocks,
            "wide": max(h * w * c, p * c) > _build.INT32_MAX}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("ibilinear")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    for dt in _build.DTYPES.values():
        fn = getattr(lib, f"repro_ibilinear_{dt}")
        fn.restype = ctypes.c_int
        fn.argtypes = [p] * 6 + [i64] * 8 + [p]
    return lib


def _takes(img, iy, ix, wy, wx) -> bool:
    return img.dtype in _build.DTYPES and \
        iy.dtype == ix.dtype == torch.int32 and \
        wy.dtype == wx.dtype == torch.float32


def ibilinear(img, iy, ix, wy, wx):
    """img:(H,W,C) iy,ix:(P,) int32 wy,wx:(P,) float32 -> (P,C)."""
    if _build.route("ibilinear", img, iy, ix, wy, wx) == "cpu":
        return ibilinear_plain(img, iy, ix, wy, wx)
    if not _takes(img, iy, ix, wy, wx):
        raise TypeError(f"ibilinear: kernel takes a float32 or bfloat16 "
                        f"image, int32 corners and float32 weights, not "
                        f"{img.dtype}, {iy.dtype}/{ix.dtype}, "
                        f"{wy.dtype}/{wx.dtype}")
    p = iy.shape[0]
    if img.ndim != 3 or any(t.shape != (p,) for t in (iy, ix, wy, wx)):
        shapes = [tuple(t.shape) for t in (iy, ix, wy, wx)]
        raise ValueError(f"ibilinear: img {tuple(img.shape)}, corners and "
                         f"weights {shapes}")
    h, w, c = img.shape
    img, iy, ix, wy, wx = (t.contiguous() for t in (img, iy, ix, wy, wx))
    out = torch.empty((p, c), dtype=img.dtype, device=img.device)
    if out.numel() == 0:
        return out
    plan = ibilinear_plan(img.shape, p, img.dtype,
                          _build.vector16(img, out))
    _build.launch(_lib, f"repro_ibilinear_{_build.DTYPES[img.dtype]}",
                  img.device, *map(_build.ptr, (img, iy, ix, wy, wx, out)),
                  h, w, c, p, plan["lanes"], plan["group"], plan["threads"],
                  int(plan["wide"]), what="ibilinear kernel",
                  count=(LAUNCHES, ("ibilinear",)),
                  work=("ibilinear", (img, iy, ix, wy, wx), out))
    return out


KERNELS = {"ibilinear": ibilinear}
PLAIN = {"ibilinear": ibilinear_plain}


def reset_launches() -> None:
    LAUNCHES["ibilinear"] = 0


def supports(img, iy, ix, wy, wx, **kw) -> bool:
    if img.ndim != 3 or not _takes(img, iy, ix, wy, wx):
        return False
    if trace.current_target().kind == "cuda":   # no image slab to fit
        return True
    h, w, c = img.shape
    return vmem_fit([(h * w * c, img.dtype)])


def cost(img, iy, ix, wy, wx, **_) -> int:
    p = iy.shape[0]
    c = img.shape[-1]
    # per pixel: 4 corner vector loads + 6 fma-class ops on C-lane vectors
    return p * (4 + 6) * math.ceil(c / trace.current_target().lane)
