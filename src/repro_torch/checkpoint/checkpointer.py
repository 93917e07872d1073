"""Asynchronous checkpoints with atomic commits, in the JAX package's
on-disk layout.

Layout: ``<dir>/step_<N:08d>/`` with one ``.npy`` per leaf, named by the
md5 of its ``::``-joined key path (dict keys and list indices), and
``manifest.json`` (each leaf's file, shape and logical dtype).  A bf16
leaf is stored as ``uint16`` with ``bfloat16`` as its logical dtype, as
the reference stores ml_dtypes.  Writes go to ``step_<N>.tmp``, the
manifest is fsynced and the directory renamed into place, so a
half-written checkpoint is never visible and a restart always finds a
whole latest step.  ``AsyncCheckpointer.save`` copies the tree to host
memory (``.cpu()``) before it returns, so the train step may overwrite
its tensors at once, and writes on a background thread.  ``restore``
loads onto a template's devices and dtypes.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from .. import tree

_SEP = "::"


def _key(path) -> str:
    return _SEP.join(str(p) for p in path)


def _host(x: torch.Tensor) -> torch.Tensor:
    return x.detach().to("cpu", copy=True)


def save(path: str, step: int, tree_: Any) -> str:
    """Synchronous atomic save; returns the committed directory."""
    return _write(path, step, tree.map(_host, tree_))


def _numpy(t: torch.Tensor):
    """(array to store, logical dtype name) of a host tensor: bf16, which
    numpy lacks, as its uint16 bits."""
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), name
    return t.numpy(), name


def _write(path: str, step: int, host_tree: Any) -> str:
    final = os.path.join(path, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}}
    for p, leaf in tree.paths(host_tree):
        key = _key(p)
        arr, logical_dtype = _numpy(leaf)
        fname = hashlib.md5(key.encode()).hexdigest()[:16] + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][key] = {
            "file": fname, "shape": list(arr.shape), "dtype": logical_dtype}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


class AsyncCheckpointer:
    """Snapshot synchronously, write in the background, join on demand;
    keep the newest ``keep`` steps."""

    def __init__(self, path: str, keep: int = 3):
        self.path = path
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree_: Any) -> None:
        self.wait()
        host = tree.map(_host, tree_)

        def work():
            try:
                _write(self.path, step, host)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(list_steps(self.path))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.path, f"step_{s:08d}"),
                          ignore_errors=True)


def list_steps(path: str):
    if not os.path.isdir(path):
        return []
    out = []
    for d in os.listdir(path):
        if d.startswith("step_") and not d.endswith(".tmp"):
            try:
                out.append(int(d.split("_")[1]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(path: str) -> Optional[int]:
    steps = list_steps(path)
    return steps[-1] if steps else None


def _tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":        # its bits, as uint16 or raw void
        return torch.from_numpy(arr.view(np.int16).copy()) \
            .view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def restore(path: str, step: int, template: Any) -> Any:
    """Load step ``step`` into ``template``'s structure, each leaf on its
    template leaf's device and in its dtype."""
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)

    def load(p, t):
        meta = manifest["leaves"][_key(p)]
        arr = np.load(os.path.join(d, meta["file"]))
        return _tensor(arr, meta["dtype"]).to(device=t.device, dtype=t.dtype)
    return tree.unflatten(template, [load(p, t)
                                     for p, t in tree.paths(template)])
