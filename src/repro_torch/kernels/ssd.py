"""Customized lowering of the Mamba2 SSD (state-space duality) scan.

The sequential recurrence

    S_t = exp(dt_t A) S_{t-1} + dt_t x_t (x) B_t ;   y_t = C_t . S_t

runs, in the reference's TPU kernel, as chunks of L steps on a
sequential grid axis with the (p, n) state in VMEM scratch.  The Hopper
kernels (``csrc/ssd.cu``) are parallel over chunks of KL = 128 rows:

  * ``ssd_state_kernel`` (every chunk but the last): the chunk's state
    change dS_c = (w * x)^T B with w_j = exp(la_L - la_j) dt_j, and its
    end decay; the last block of a (batch, head) to finish chains them
    in chunk order into the state at each chunk's start,
    S_{c+1} = exp(la_L,c) S_c + dS_c;
  * ``ssd_out_kernel`` (every chunk): from the chunk's inputs and S_c,

        y_inter = exp(la) * (C @ S_c^T)
        y_intra = ((C B^T) * decay) @ (dt * x)

Both run their products on the tensor cores, fp32 operands split into two
bf16 terms.  The block decomposition is exact for any chunk length, so
the kernels' fixed 128 rows give the function of any ``chunk``.  Groups
are read per head (h // (h/g)), nothing is repeated or padded in device
memory: rows past the sequence load as zero (dt = 0 is a no-op step).
The output kernel adds the skip term D before it rounds y; the
reference, and the plain version, add it outside.

  * ``ssd_plain`` — the plain version: ``ref.ssd_chunked`` at the
    reference's chunk length (the decay masked before ``exp``);
  * ``ssd`` — the wrapper: a CUDA tensor launches the kernels (two for
    more than one chunk, else one) and counts each in ``LAUNCHES``, a CPU
    tensor runs the plain version;
  * ``cost`` / ``supports`` — the reference's cost, verbatim;
    ``supports`` adds the kernels' dtypes, p <= 128 and their shared
    memory;
  * ``SsdFn`` — the autograd Function a train step calls it through.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..core.targets import compile_target, current_target
from ..core.vtypes import round_up
from . import _autograd, _build, ref

LAUNCHES = {"ssd": 0}
SUBLANE_F32 = 8            # the reference's chunk rounding (fp32 sublane)
KL = 128                   # the kernels' chunk rows (csrc/ssd.cu: kL)
P_MAX = 128                # the output kernel's register tiles


def chunk_len(s: int, chunk: int = 128) -> int:
    """The reference's chunk length: min(chunk, round_up(s, 8))."""
    return min(chunk, round_up(max(1, s), SUBLANE_F32))


def chunks(s: int) -> int:
    """Chunks of KL rows the kernels cut s positions into."""
    return -(-s // KL)


def launches(s: int) -> int:
    """Kernel launches of one call: the state pass runs only where there is
    a chunk before the last."""
    return 2 if chunks(s) > 1 else 1


def _pad16(v: int) -> int:
    return -(-v // 16) * 16


def smem_bytes(p: int, n: int, dtype=torch.bfloat16) -> int:
    """Shared memory of the larger of the two kernels' blocks
    (csrc/ssd.cu: state_smem, out_smem): bf16 planes, two for an fp32
    operand, rows padded to 16 columns + 8."""
    terms = 2 if dtype == torch.float32 else 1
    ldp, ldn = _pad16(p) + 8, _pad16(n) + 8
    state = 2 * (2 * KL * ldp + terms * KL * ldn) + 3 * 4 * KL
    out = 2 * (terms * (2 * KL * ldn + KL * ldp) + 2 * _pad16(p) * ldn) \
        + 2 * 4 * KL
    return max(state, out)


def _smem_budget() -> int:
    """Shared memory one block of the card can use."""
    return compile_target().vmem_bytes


def _add_d(y, x, D):
    if D is None:
        return y
    return y + (D[None, None, :, None] * x.to(torch.float32)).to(y.dtype)


def ssd_plain(x, dt, A, B, C, D=None, chunk=128):
    """x:(b,s,h,p) dt:(b,s,h) A:(h,) B,C:(b,s,g,n) -> y:(b,s,h,p): the
    chunked oracle at the reference's chunk length."""
    return ref.ssd_chunked(x, dt, A, B, C, D,
                           chunk=chunk_len(x.shape[1], chunk))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for dt in _build.DTYPES.values():
        fn = getattr(lib, f"repro_ssd_state_{dt}")
        fn.restype = ctypes.c_int
        fn.argtypes = [ptr] * 8 + [i64] * 6 + [i64] * 12 + [i32, ptr]
        fn = getattr(lib, f"repro_ssd_out_{dt}")
        fn.restype = ctypes.c_int
        fn.argtypes = [ptr] * 8 + [i64] * 6 + [i64] * 12 + [i32, ptr]
    return lib


def _takes(x, dt, A, B, C) -> bool:
    return (x.dtype in _build.DTYPES and B.dtype == x.dtype
            and C.dtype == x.dtype and dt.dtype == torch.float32
            and A.dtype == torch.float32)


def _vec(x, B, C) -> bool:
    """bf16 operands whose rows the kernels copy 16 bytes at a time."""
    p, n = x.shape[-1], B.shape[-1]
    return (x.dtype == torch.bfloat16 and p % 8 == 0 and n % 8 == 0
            and all(_build.ptr(t) % 16 == 0 and
                    all(st % 8 == 0 for st in t.stride()[:3])
                    for t in (x, B, C)))


def ssd(x, dt, A, B, C, D=None, chunk=128):
    """Chunked SSD.  x:(b,s,h,p) dt:(b,s,h) A:(h,) B,C:(b,s,g,n).
    ``chunk`` is the plain version's chunk length; the kernels' is KL."""
    if _build.route("ssd", x, dt, A, B, C, D) == "cpu":
        return ssd_plain(x, dt, A, B, C, D, chunk)
    if not _takes(x, dt, A, B, C):
        raise TypeError(f"ssd: kernel takes float32 or bfloat16 x, B, C of "
                        f"one dtype and float32 dt, A, not {x.dtype}/"
                        f"{B.dtype}/{C.dtype}, {dt.dtype}/{A.dtype}")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if tuple(dt.shape) != (b, s, h) or tuple(A.shape) != (h,) or \
            B.shape != C.shape or tuple(B.shape[:2]) != (b, s) or \
            g == 0 or h % g or p > P_MAX or \
            smem_bytes(p, n, x.dtype) > _smem_budget():
        raise ValueError(f"ssd: shapes x {tuple(x.shape)} dt "
                         f"{tuple(dt.shape)} A {tuple(A.shape)} B "
                         f"{tuple(B.shape)} C {tuple(C.shape)}; the kernels "
                         f"take h % g == 0, p <= {P_MAX} and "
                         f"{_smem_budget()} bytes of shared memory per block")
    ts = [t if t.stride(-1) == 1 else t.contiguous() for t in (x, B, C)]
    x_, B_, C_ = ts
    dt_, A_ = dt.contiguous(), A.contiguous()
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    if y.numel() == 0 or n == 0:
        return _add_d(y.zero_(), x, D)
    D_ = None if D is None else D.to(torch.float32).contiguous()
    sfx = _build.DTYPES[x.dtype]
    shape = (b, s, h, p, g, n, *x_.stride()[:3], *dt_.stride(),
             *B_.stride()[:3], *C_.stride()[:3], int(_vec(x_, B_, C_)))
    nch1, dev = chunks(s) - 1, x.device
    # the state pass's workspace: each chunk's state change (fp32) and the
    # chained start states (two bf16 planes), both (p, n) padded to 16, the
    # end decays and a finished-block count per (batch, head)
    states = torch.empty(b * h * nch1 * 2 * _pad16(p) * _pad16(n),
                         dtype=torch.int16, device=dev)
    if nch1:
        changes = torch.empty(b * h * nch1 * _pad16(p) * _pad16(n),
                              dtype=torch.float32, device=dev)
        decay = torch.empty(b * h * nch1, dtype=torch.float32, device=dev)
        count = torch.zeros(b * h, dtype=torch.int32, device=dev)
        # (the call's work is carried by the output pass's launch)
        _build.launch(_lib, f"repro_ssd_state_{sfx}", dev,
                      *map(_build.ptr, (x_, dt_, A_, B_, changes, states,
                                        decay, count)), *shape,
                      what="ssd state kernel", count=(LAUNCHES, ("ssd",)))
    _build.launch(_lib, f"repro_ssd_out_{sfx}", dev,
                  *map(_build.ptr, (x_, dt_, A_, B_, C_, D_, states, y)),
                  *shape, what="ssd output kernel",
                  count=(LAUNCHES, ("ssd",)),
                  work=("ssd", (x, dt, A, B, C, D), y))
    return y


class SsdFn(torch.autograd.Function):
    """The SSD scan through the kernels, with the gradient of the op's
    vector tier (``ops._ssd_vector``: ``ref.ssd_chunked`` past 256
    positions, the sequential scan below) recomputed from the saved
    inputs: the gradient the reference computes.  A's and D's gradients
    sum over the batch."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, chunk):
        y = ssd(x, dt, A, B, C, D, chunk)
        ctx.save_for_backward(x, dt, A, B, C, D)
        return y

    @staticmethod
    def backward(ctx, g):
        from .ops import _ssd_vector
        grads = _autograd.vjp(_ssd_vector, ctx.saved_tensors, g,
                              ctx.needs_input_grad[:6],
                              (True, True, False, True, True, False))
        return (*grads, None)


KERNELS = {"ssd": ssd}
PLAIN = {"ssd": ssd_plain}


def reset_launches() -> None:
    LAUNCHES["ssd"] = 0


def supports(x, dt, A, B, C, D=None, *_, **kw) -> bool:
    """The reference's rule (h % g == 0), with the kernels' dtypes, p and
    shared memory."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    return (h % B.shape[2] == 0 and _takes(x, dt, A, B, C) and p <= P_MAX
            and smem_bytes(p, n, x.dtype) <= _smem_budget())


def cost(x, dt, A, B, C, D=None, *, chunk=128, **_) -> int:
    """The reference's kernel-structure count."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    L = chunk
    tgt = current_target()
    nch = math.ceil(s / L)
    vreg = tgt.vreg_elems(x.dtype)
    if tgt.has_mxu:
        mx = tgt.mxu
        mm = (math.ceil(L / mx) ** 2 * math.ceil(n / mx)         # C B^T
              + math.ceil(L / mx) ** 2 * math.ceil(p / mx)       # (GW) x
              + 2 * math.ceil(L / mx) * math.ceil(n / mx) * math.ceil(p / mx))
    else:                        # vfma ladder at VLA width
        mm = math.ceil(L * L * (n + p) / vreg) + 2 * math.ceil(L * n * p / vreg)
    per_chunk = mm + 8 * math.ceil(L * L / vreg)
    return b * h * nch * per_chunk
