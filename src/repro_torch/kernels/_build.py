"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` alone (no PyTorch
headers, so a build takes seconds) into a shared library with a plain C
interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -shared -Xcompiler -fPIC -o lib<name>.so csrc/<name>.cu

No ``--use_fast_math`` and no ``-ftz``: the kernels need IEEE division
and keep subnormals (see the note at the top of each source).

Libraries go to ``build/repro_torch/`` at the root of the checkout,
named by a hash of the source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited source is rebuilt and an unchanged one is loaded
as it is.  A missing ``nvcc`` or a failed build raises; nothing falls
back.

The wrappers call an entry point through :func:`launch`, which passes
PyTorch's current stream, raises if the launch was refused and counts
it; they pick the kernel or the plain version with :func:`route`.

A stand-in for a card tensor has shapes and no data: a ``FakeTensor``
(``torch._subclasses``; on a CUDA build of torch its device is the
card's), or a ``meta`` tensor inside :func:`stand_in_card`.  Its
address (:func:`ptr`) is its offset in its storage, so the alignment
rules see what the card's allocation would give, and :func:`launch`
given one loads nothing and calls nothing: it records the launch, its
counts and its work (``kernels/cost.py``) in each active
:func:`recording`.  This is how ``launch/graph_analysis.py`` counts the
kernels a step would launch on the card without a card.  A tensor with
data never takes that path.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# The dtypes every kernel takes, and the suffix of their C entry points
DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}

# Launch shapes of the streaming kernels (the pools, ibilinear): blocks of
# THREADS threads, halved (down to 32) while the grid would have fewer
# blocks than the card has SMs, so that a small call spreads over the
# card; a vector is 16 bytes of the channel (last) dimension.
THREADS = 256
SMS = 132                   # H100 SXM
VECTOR_BYTES = 16
INT32_MAX = 2 ** 31 - 1

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_tls = threading.local()


class BuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def nvcc() -> str:
    """Path of nvcc: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise BuildError("nvcc not found (looked on PATH and in "
                     f"{home}/bin); the CUDA kernels cannot be built")


def sources() -> List[str]:
    """Names of the kernel sources, ``csrc/<name>.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Build every source that is not built yet, one nvcc per source, all
    started together, and wait for all of them; returns name -> library
    path.  Raises BuildError if any build failed."""
    names = list(sources() if names is None else names)
    outs = {n: _target(n) for n in names}
    todo = [n for n in names if not outs[n].exists()]
    if not todo:
        return outs
    exe = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = outs[n].with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (tmp, subprocess.Popen(
            [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, outs[n])
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed on csrc/{n}.cu "
                          f"(exit {proc.returncode}):\n{log}")
    if failed:
        raise BuildError("\n".join(failed))
    return outs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all([name])[name]))
            _libs[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (its return value
    is ``cudaGetLastError()`` right after the launch)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")


def _is_dtensor(t) -> bool:
    return type(t).__name__ == "DTensor" and \
        type(t).__module__.startswith("torch.distributed.tensor")


def stand_in(t) -> bool:
    """Whether ``t`` stands for a card tensor without data: a FakeTensor,
    or a meta tensor inside :func:`stand_in_card`."""
    if isinstance(t, torch._subclasses.FakeTensor):
        return True
    return t.is_meta and getattr(_tls, "card", False)


@contextlib.contextmanager
def stand_in_card():
    """Meta tensors stand for the card's tensors on this thread: the
    kernels' wrappers route them to the kernel path (:func:`route`), whose
    launches are recorded rather than made (:func:`launch`)."""
    prev = getattr(_tls, "card", False)
    _tls.card = True
    try:
        yield
    finally:
        _tls.card = prev


@contextlib.contextmanager
def recording():
    """Collect the stand-in launches made on this thread inside the
    block: yields a list that gets one dictionary a launch (``counts``:
    the launch counters it stands for; ``shapes``, ``dtype``; ``bytes``
    and ``ops`` of its function's work, ``kernels/cost.py``)."""
    out = []
    stack = getattr(_tls, "recorders", [])
    _tls.recorders = stack + [out]
    try:
        yield out
    finally:
        _tls.recorders = stack


def route(op: str, *tensors) -> str:
    """'cuda' launches the kernel, 'cpu' runs the plain version; tensors
    on any other device, or spread over two devices, are refused.  So is
    a CUDA call that autograd would need to see through (grad mode on and
    an input that requires grad): the kernel writes into an output with
    no ``grad_fn``, so the gradient of everything upstream would be
    dropped without a word.  Such a call goes through the op's autograd
    Function (``ops.<op>`` picks it), whose forward runs with grad mode
    off.  A DTensor is refused too: the kernel would read one rank's
    local storage as if it were the whole tensor; a sharded model hands
    the kernels its local shards (``models/sharding.py``).  Meta tensors
    inside :func:`stand_in_card` are the card's."""
    for t in tensors:
        if _is_dtensor(t):
            raise TypeError(
                f"{op}: a DTensor ({t.placements} on {t.device_mesh}) "
                f"reached a hand kernel, which takes plain tensors; pass "
                f"its local shard (DTensor.to_local())")
    devices = {"cuda" if t.is_meta and stand_in(t) else t.device.type
               for t in tensors if t is not None}
    if len(devices) == 1:
        (dev,) = devices
        if dev == "cuda" and torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in tensors):
            raise RuntimeError(
                f"{op}: an input requires grad, and the kernel's output "
                f"would have no grad_fn; call it through ops (its autograd "
                f"Function) or under torch.no_grad()")
        if dev in ("cuda", "cpu"):
            return dev
    raise ValueError(f"{op}: kernels take CUDA or CPU tensors, all on one "
                     f"device, not "
                     f"{sorted({str(t.device) for t in tensors if t is not None})}")


class FakePtr(int):
    """A stand-in tensor's address: its byte offset in its storage
    (storages start 256-byte aligned on the card)."""


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """Device address for a ctypes pointer argument; None passes NULL; a
    stand-in's is a :class:`FakePtr`."""
    if t is None:
        return None
    if stand_in(t):
        return FakePtr(t.storage_offset() * t.element_size())
    return t.data_ptr()


def lanes(dtype: torch.dtype, vector: bool) -> int:
    """Elements of ``dtype`` a thread takes at a time: one 16-byte vector
    (4 fp32, 8 bf16) where ``vector``, else one."""
    return VECTOR_BYTES // dtype.itemsize if vector else 1


def vector16(x: torch.Tensor, *outs: Optional[torch.Tensor]) -> bool:
    """Whether a kernel may take 16-byte vectors along x's last (channel)
    dimension: its length a multiple of the vector's lanes, and x and the
    outputs 16-byte aligned (outputs made by ``torch.empty`` always are; x
    may be a view that is not).  ``None`` outputs are skipped."""
    return x.shape[-1] % lanes(x.dtype, True) == 0 and all(
        ptr(t) % VECTOR_BYTES == 0 for t in (x, *outs) if t is not None)


def spread(items: int):
    """(threads a block, blocks) for one thread an item: THREADS a block,
    halved down to 32 while that gives fewer than SMS blocks; the blocks
    capped at the grid's limit (the kernels loop past it)."""
    threads = THREADS
    while threads > 32 and -(-items // threads) < SMS:
        threads //= 2
    return threads, min(-(-items // threads), INT32_MAX)


def launch(lib, entry: str, device: torch.device, *args, what: str,
           count, work=None) -> None:
    """Call entry point ``entry`` of the library ``lib()`` gives on
    ``device`` with PyTorch's current stream as its last argument, raise
    if the launch was refused, and add one to each counter of ``count``
    (a dictionary and its keys).  Given a stand-in's address
    (:class:`FakePtr`) nothing is loaded or called and nothing is
    counted: each active :func:`recording` gets the launch, with the work
    of ``work`` (``(op, args, out)`` for ``cost.work``; None where this
    launch is a part of a call whose work another launch carries)."""
    counter, keys = count
    if any(isinstance(a, FakePtr) for a in args):
        _record(keys, work)
        return
    fn = getattr(lib(), entry)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    check(rc, what)
    for k in keys:
        counter[k] += 1


def _record(keys, work) -> None:
    stack = getattr(_tls, "recorders", [])
    if not stack:
        return
    from torch.utils._python_dispatch import _disable_current_modes
    from . import cost
    rec = {"counts": tuple(keys), "shapes": [], "dtype": None, "bytes": 0,
           "ops": 0}
    if work is not None:
        op, args, out = work
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        rec["shapes"] = [list(t.shape) for t in tensors]
        rec["dtype"] = str(tensors[0].dtype).replace("torch.", "")
        # (the cost model's own tracing is no part of the counted step)
        with _disable_current_modes():
            rec["bytes"], rec["ops"] = cost.work(op, args, out)
    for out in stack:
        out.append(rec)
