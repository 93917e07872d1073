"""Customized elementwise lowerings: vrelu, vsqrt, vtanh, vsigmoid.

These four are the paper's clearest wins (Figure 2: vtanh/vsigmoid show
the largest speedups).  The generic tier scalarizes transcendental calls
(no vector libm), while the customized conversions compute them with pure
vector arithmetic:

  vsqrt    — rsqrt seed + 2 Newton-Raphson refinements (NEON vrsqrte/
             vrsqrts ladder), fixed up at x=0/inf,
  vtanh    — rational form using an exp2 range reduction with
             bit-assembled 2^n scaling,
  vsigmoid — same exp2 reduction + one-Newton reciprocal (vrecpe ladder),
  vrelu    — fused minmax clamp (XNNPACK vrelu is clamp).

Each op has three parts here:

  * ``*_math`` — the plain tile math, step for step the JAX reference's,
    in fp32 torch ops;
  * the wrapper (``vtanh`` ...) — for a CUDA tensor it launches the
    hand-written kernel of ``csrc/elementwise.cu`` and counts the launch
    in ``LAUNCHES``; for a CPU tensor it runs the plain math (the
    analogue of Pallas ``interpret=True``); anything else raises;
  * the declared cost model the registry ranks it by;
  * for vtanh and vsigmoid, the autograd Function a train step calls the
    kernel through (``VtanhFn``, ``VsigmoidFn``).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..core import trace
from . import _build

_LOG2E = 1.4426950408889634

# Launches of each kernel since the last reset: one per kernel launch,
# counted by the wrapper where it launches and nowhere else.
LAUNCHES = {"vtanh": 0, "vsigmoid": 0, "vsqrt": 0, "vrelu": 0}


# ---------------------------------------------------------------------------
# plain tile math (fp32 tensors)
# ---------------------------------------------------------------------------

def _exp2_poly(f):
    """2^f for f in [-0.5, 0.5], degree-5 minimax-ish polynomial."""
    c = (1.0, 0.6931471805599453, 0.24022650695910072,
         0.05550410866482158, 0.009618129107628477, 0.0013333558146428443)
    p = f * c[5] + c[4]
    for ci in (c[3], c[2], c[1], c[0]):
        p = p * f + ci
    return p


def _exp(x):
    """Vector exp via exp2 range reduction with bit-assembled scaling:
    exp(x) = 2^(x*log2e) = 2^n * 2^f, 2^n built by shifting the biased
    exponent into an IEEE-754 payload."""
    y = x * _LOG2E
    n = torch.round(y)                       # half to even, as jnp.round
    f = y - n
    two_n = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return _exp2_poly(f) * two_n


def vtanh_math(x):
    t = torch.clamp(torch.abs(x), 0.0, 20.0)
    z = _exp(-2.0 * t)                       # in (0, 1]
    th = (1.0 - z) / (1.0 + z)
    # torch.sign maps NaN to 0 where jnp.sign keeps it, but a NaN x
    # makes th NaN, so the product is NaN either way
    return torch.sign(x) * th


def vsigmoid_math(x):
    t = torch.clamp(x, -30.0, 30.0)
    z = _exp(-torch.abs(t))
    den = 1.0 + z
    # vrecpe + one Newton step: r <- r * (2 - den * r)
    r = 1.0 / den
    r = r * (2.0 - den * r)
    pos = 1.0 - z * r          # sigma(|t|)
    return torch.where(t >= 0, pos, z * r)


def vsqrt_math(x):
    y = torch.rsqrt(x)                        # vrsqrte seed
    for _ in range(2):                        # vrsqrts Newton ladder
        y = y * (1.5 - 0.5 * x * y * y)
    s = x * y
    s = torch.where(x == 0.0, 0.0, s)
    return torch.where(torch.isinf(x), math.inf, s)


def vrelu_math(x, clamp_min, clamp_max):
    # in x's own dtype; a bound that dtype cannot hold gives the same
    # result as the reference's bound rounded to it, since rounding to
    # nearest is monotone and x itself is representable
    return torch.clamp(x, clamp_min, clamp_max)


# The plain version of each kernel: the same function in torch ops, on
# the input's own device.  vrelu stays in x's dtype, the others compute
# in fp32 and round to x's dtype.
def vtanh_plain(x):
    return vtanh_math(x.to(torch.float32)).to(x.dtype)


def vsigmoid_plain(x):
    return vsigmoid_math(x.to(torch.float32)).to(x.dtype)


def vsqrt_plain(x):
    return vsqrt_math(x.to(torch.float32)).to(x.dtype)


def vrelu_plain(x, clamp_min=0.0, clamp_max=float("inf")):
    return vrelu_math(x, clamp_min, clamp_max)


# ---------------------------------------------------------------------------
# kernel launch
# ---------------------------------------------------------------------------

# The launch plan (csrc/elementwise.cu).  A bf16 thread takes two 16-byte
# vectors where that still gives TWO_WAVES blocks of THREADS (every SM's
# 8 resident blocks, twice over), else one; fp32 always one.  A grid of
# fewer than SMS blocks halves its blocks, down to 32 threads, so that a
# decode step's 32768 bf16 elements run on 128 SMs and not on 16.
THREADS = 256
SMS = 132                   # H100 SXM
TWO_WAVES = 2 * 8 * SMS


def plan(n: int, itemsize: int, aligned: bool = True):
    """(threads a block, vectors a thread, blocks) of the kernel for n
    elements of ``itemsize`` bytes; a vector is 16 bytes when ``aligned``,
    else one element."""
    per_vec = 16 // itemsize if aligned else 1
    items = max(1, n // per_vec)
    if itemsize == 2 and -(-items // (2 * THREADS)) >= TWO_WAVES:
        return THREADS, 2, -(-items // (2 * THREADS))
    threads = THREADS
    while threads > 32 and -(-items // threads) < SMS:
        threads //= 2
    return threads, 1, -(-items // threads)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The elementwise library with every entry point's types declared."""
    lib = _build.load("elementwise")
    p, i64, f32, i32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_float,
                        ctypes.c_int)
    for op in LAUNCHES:
        for dt in _build.DTYPES.values():
            fn = getattr(lib, f"repro_{op}_{dt}")
            fn.restype = ctypes.c_int
            fn.argtypes = ([p, p, i64, f32, f32, i32, i32, p] if op == "vrelu"
                           else [p, p, i64, i32, i32, p])
    return lib


def _launch(op: str, x: torch.Tensor, *scalars) -> torch.Tensor:
    if x.dtype not in _build.DTYPES:
        raise TypeError(f"{op}: kernel takes float32 or bfloat16, "
                        f"not {x.dtype}")
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    aligned = x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    threads, per_thread, _ = plan(x.numel(), x.element_size(), aligned)
    fn = getattr(_lib(), f"repro_{op}_{_build.DTYPES[x.dtype]}")
    _build.launch(fn, x.device, x.data_ptr(), out.data_ptr(), x.numel(),
                  *scalars, threads, per_thread, what=f"{op} kernel")
    LAUNCHES[op] += 1
    return out


def vtanh(x):
    if _build.route("vtanh", x) == "cpu":
        return vtanh_plain(x)
    return _launch("vtanh", x)


def vsigmoid(x):
    if _build.route("vsigmoid", x) == "cpu":
        return vsigmoid_plain(x)
    return _launch("vsigmoid", x)


def vsqrt(x):
    if _build.route("vsqrt", x) == "cpu":
        return vsqrt_plain(x)
    return _launch("vsqrt", x)


def vrelu(x, clamp_min=0.0, clamp_max=float("inf")):
    if _build.route("vrelu", x) == "cpu":
        return vrelu_plain(x, clamp_min, clamp_max)
    return _launch("vrelu", x, clamp_min, clamp_max)


class VtanhFn(torch.autograd.Function):
    """vtanh through the kernel; its gradient g (1 - y^2) from the saved
    output, in fp32, one fused elementwise pass of torch ops."""

    @staticmethod
    def forward(ctx, x):
        y = vtanh(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        yf = y.to(torch.float32)
        return (g.to(torch.float32) * (1.0 - yf * yf)).to(y.dtype)


class VsigmoidFn(torch.autograd.Function):
    """vsigmoid through the kernel; its gradient g y (1 - y) from the
    saved output, in fp32."""

    @staticmethod
    def forward(ctx, x):
        y = vsigmoid(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        yf = y.to(torch.float32)
        return (g.to(torch.float32) * yf * (1.0 - yf)).to(y.dtype)


KERNELS = {"vtanh": vtanh, "vsigmoid": vsigmoid, "vsqrt": vsqrt,
           "vrelu": vrelu}
PLAIN = {"vtanh": vtanh_plain, "vsigmoid": vsigmoid_plain,
         "vsqrt": vsqrt_plain, "vrelu": vrelu_plain}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# dynamic-instruction cost models (vector ops per register tile)
# ---------------------------------------------------------------------------

def _ew_cost(ops_per_vec):
    def cost(x, *a, **kw):
        return ops_per_vec * math.ceil(x.numel() / trace.vreg_for(x.dtype))
    return cost


# declared ops/vreg, read off the tile math above — the single source
# for both the registered cost models and CALIBRATION
DECLARED_OPS_PER_VREG = {
    "vtanh": 22,      # exp2 poly(10) + reduction(6) + rational(6)
    "vsigmoid": 24,
    "vsqrt": 12,      # seed + 2 Newton x4 + fixups
    "vrelu": 2,       # min + max
}

cost_vtanh = _ew_cost(DECLARED_OPS_PER_VREG["vtanh"])
cost_vsigmoid = _ew_cost(DECLARED_OPS_PER_VREG["vsigmoid"])
cost_vsqrt = _ew_cost(DECLARED_OPS_PER_VREG["vsqrt"])
cost_vrelu = _ew_cost(DECLARED_OPS_PER_VREG["vrelu"])

# (tile math, declared ops/vreg) pairs: the calibration tests hold the
# declared numbers against trace.fx_vector_instrs of the same code
CALIBRATION = {
    "vtanh": (vtanh_math, DECLARED_OPS_PER_VREG["vtanh"]),
    "vsigmoid": (vsigmoid_math, DECLARED_OPS_PER_VREG["vsigmoid"]),
    "vsqrt": (vsqrt_math, DECLARED_OPS_PER_VREG["vsqrt"]),
    "vrelu": (lambda x: vrelu_math(x, 0.0, 6.0),
              DECLARED_OPS_PER_VREG["vrelu"]),
}


def supports(x, *a, **kw) -> bool:
    return x.dtype in _build.DTYPES
