"""Customized lowerings: maxpool + argmaxpool (NHWC, stride == window).

XNNPACK's NEON maxpool walks pointer ladders with vmax chains; the
reference's TPU kernel reduces (rows, W, C) slabs in VMEM by reshape
decimation, and argmaxpool tracks the running max and its window index
with a select ladder (the paper's vceq->merge composition).  The CUDA
kernel (``csrc/pooling.cu``) is one template with the index output
switched on for argmaxpool.  With stride equal to the window no input
element is read twice, so it is a pure stream: a thread makes one
output vector of 16 bytes (4 fp32 or 8 bf16 channels; one channel where
C or an operand's alignment does not allow a vector), issuing all the
loads of a 2x2 window before its compares.  :func:`pool_plan` picks the
vector width, the compile-time 2x2 window or the generic one, the block
size and 32- or 64-bit indexing; the C entry point re-checks each claim
and refuses one that does not hold.  The ragged tail rows and columns
are never read (VALID: oh = H // kh), so nothing is trimmed or padded.

Layout is the reference's: x NHWC (N, H, W, C), float32 or bfloat16 for
the kernel; argmaxpool's indices are int32, ``i * kw + j`` within the
window.  NaN: maxpool propagates it, as ``jnp.max`` in the reference
kernel; argmaxpool's strict ``>`` never takes it (a window of NaN gives
-inf at index 0), as the reference *kernel* does — the oracle
``ref.argmaxpool`` (argmax) treats NaN as the maximum instead.

The plain versions (``*_plain``) follow the reference kernel's bodies in
torch ops; the wrappers launch the kernel for CUDA tensors (counted in
``LAUNCHES``) and run the plain version for CPU tensors, which may also
hold integers.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..core import trace
from . import _build

LAUNCHES = {"maxpool": 0, "argmaxpool": 0}


def _windows(x, window):
    """(N, oh, kh, ow, kw, C): the ragged tail trimmed and the windows
    decimated by reshape, as ``_pool_call`` and the bodies do."""
    n, h, w, c = x.shape
    kh, kw = window
    oh, ow = h // kh, w // kw
    return x[:, :oh * kh, :ow * kw].reshape(n, oh, kh, ow, kw, c)


def maxpool_plain(x, window=(2, 2)):
    """``_maxpool_body``: the max over each window, NaN propagating."""
    return _windows(x, window).amax(dim=(2, 4))


def argmaxpool_plain(x, window=(2, 2)):
    """``_argmaxpool_body``: best = -inf (an integer dtype's minimum),
    index 0; each tap in (i, j) order replaces them where strictly
    greater.  Returns (max, int32 index)."""
    xr = _windows(x, window)
    n, oh, kh, ow, kw, c = xr.shape
    neg = float("-inf") if x.dtype.is_floating_point \
        else torch.iinfo(x.dtype).min
    best = torch.full((n, oh, ow, c), neg, dtype=x.dtype, device=x.device)
    best_i = torch.zeros((n, oh, ow, c), dtype=torch.int32, device=x.device)
    for i in range(kh):
        for j in range(kw):
            cand = xr[:, :, i, :, j, :]
            take = cand > best
            best = torch.where(take, cand, best)
            best_i = torch.where(take, i * kw + j, best_i)
    return best, best_i


def pool_plan(shape, dtype, window, vector: bool) -> dict:
    """The kernel's launch shape for x of ``shape`` (N, H, W, C) and
    ``dtype`` pooled by ``window``.  ``vector`` (``_build.vector16``): a
    thread's channels are one 16-byte vector (``lanes`` 4 fp32 or 8 bf16),
    else one channel.  ``window`` "2x2" is the compile-time 2x2
    instantiation, "generic" reads the taps at run time.  A thread makes
    one output vector, in blocks of ``threads`` (``_build.spread``);
    ``blocks`` is the 1-D grid (no grid dimension of 65535 to outgrow).
    ``wide``: 64-bit indexing, where x has 2^31 or more elements."""
    n, h, w, c = shape
    kh, kw = window
    lanes = _build.lanes(dtype, vector)
    threads, blocks = _build.spread(
        max(1, n * (h // kh) * (w // kw) * (c // lanes)))
    return {"vector": vector, "lanes": lanes,
            "window": "2x2" if (kh, kw) == (2, 2) else "generic",
            "threads": threads, "blocks": blocks,
            "wide": n * h * w * c > _build.INT32_MAX}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("pooling")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    for dt in _build.DTYPES.values():
        fn = getattr(lib, f"repro_maxpool_{dt}")
        fn.restype = ctypes.c_int
        fn.argtypes = [p, p] + [i64] * 10 + [p]
        fn = getattr(lib, f"repro_argmaxpool_{dt}")
        fn.restype = ctypes.c_int
        fn.argtypes = [p, p, p] + [i64] * 10 + [p]
    return lib


def _launch(op, x, window):
    if x.dtype not in _build.DTYPES:
        raise TypeError(f"{op}: kernel takes float32 or bfloat16, "
                        f"not {x.dtype}")
    kh, kw = window
    if x.ndim != 4 or kh < 1 or kw < 1:
        raise ValueError(f"{op}: x {tuple(x.shape)}, window {window}")
    x = x.contiguous()
    n, h, w, c = x.shape
    shape = (n, h // kh, w // kw, c)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    idx = torch.empty(shape, dtype=torch.int32, device=x.device) \
        if op == "argmaxpool" else None
    if out.numel() == 0:
        return out, idx
    plan = pool_plan(x.shape, x.dtype, window, _build.vector16(x, out, idx))
    ptrs = (_build.ptr(x), _build.ptr(out)) + (
        () if idx is None else (_build.ptr(idx),))
    _build.launch(_lib, f"repro_{op}_{_build.DTYPES[x.dtype]}", x.device,
                  *ptrs, n, h, w, c, kh, kw, plan["lanes"],
                  int(plan["window"] == "2x2"), plan["threads"],
                  int(plan["wide"]), what=f"{op} kernel",
                  count=(LAUNCHES, (op,)),
                  work=(op, (x, window), (out,) if idx is None
                        else (out, idx)))
    return out, idx


def maxpool(x, window=(2, 2)):
    """Max over stride == window windows, VALID.  x:(N,H,W,C)."""
    if _build.route("maxpool", x) == "cpu":
        return maxpool_plain(x, window)
    return _launch("maxpool", x, window)[0]


def argmaxpool(x, window=(2, 2)):
    """(window max, int32 index i*kw+j of its first occurrence)."""
    if _build.route("argmaxpool", x) == "cpu":
        return argmaxpool_plain(x, window)
    return _launch("argmaxpool", x, window)


KERNELS = {"maxpool": maxpool, "argmaxpool": argmaxpool}
PLAIN = {"maxpool": maxpool_plain, "argmaxpool": argmaxpool_plain}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def supports(x, window=(2, 2), stride=None, **kw) -> bool:
    """Valid iff stride == window (decimation exact) on a 4-D float32 or
    bfloat16 tensor: the reference's rule plus the kernel's dtypes."""
    return (stride is None or tuple(stride) == tuple(window)) and \
        x.ndim == 4 and x.dtype in _build.DTYPES


# The pooling models take the stride that ops.* passes, unlike the
# reference's, which raise on it (ROADMAP C.4); the counts are the same.
def cost_maxpool(x, window=(2, 2), stride=None, **kw) -> int:
    kh, kw_ = window
    out_elems = x.numel() // (kh * kw_)
    return (kh * kw_ - 1) * math.ceil(out_elems / trace.vreg_for(x.dtype))


def cost_argmaxpool(x, window=(2, 2), stride=None, **kw) -> int:
    kh, kw_ = window
    out_elems = x.numel() // (kh * kw_)
    return 3 * kh * kw_ * math.ceil(out_elems / trace.vreg_for(x.dtype))
