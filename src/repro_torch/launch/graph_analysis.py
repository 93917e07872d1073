"""What one rank dispatches in a step: the counterpart of the JAX
package's ``launch/hlo_analysis.py``.

The reference parses the compiled, SPMD-partitioned HLO of a step and
sums its costs per device, with while-loop trip counts.  The port has no
HLO: PyTorch runs eagerly, so a rank's step is the ops it dispatches.
:class:`Counter` is a ``TorchDispatchMode`` that watches them while a
step runs on stand-in tensors (``meta`` tensors inside
``kernels._build.stand_in_card``, or FakeTensors: shapes, no data, no
allocation) and counts, per rank and step:

  * ``flops``: ``torch.utils.flop_counter``'s formulas for the torch ops
    (products, convolutions, attention), plus the operations of every
    hand kernel launch the wrappers record (``kernels/cost.py``);
  * ``bytes``: operand and result bytes of every dispatched op that moves
    data, plus each recorded kernel's bytes.  Views, allocations and
    metadata ops are skipped, as the reference skips parameters,
    constants, tuples and bitcasts;
  * ``collectives``: output bytes by kind, the c10d ops under the
    reference's five names (``allreduce_`` all-reduce, the all-gathers
    all-gather, ``reduce_scatter`` reduce-scatter, ``alltoall``
    all-to-all, ``send`` / ``recv`` collective-permute), and
    ``collective_total``;
  * ``launches``: the kernel launches a card would make, by the wrappers'
    launch counters (``LAUNCHES`` keys, gemm's variants among them);
  * ``peak_bytes``: the largest sum of the rank's live storages (the
    tracked arguments, and every op's outputs until they are freed).

Python loops run their bodies op by op, so every iteration is counted as
it runs: there are no trip counts to read, and the reference's
``whiles`` / ``scan_trips`` column has no counterpart here.  Remat's
recompute dispatches its ops again in the backward and is counted, as
the reference's HLO counts it.  The lowering registry's own costing
(host-side tracing of the candidates) is not counted.
"""
from __future__ import annotations

import collections
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from .. import tree
from ..core import registry
from ..kernels import _build

# c10d op name fragments -> the reference's five kinds
_KINDS = (("allreduce", "all-reduce"), ("allgather", "all-gather"),
          ("reduce_scatter", "reduce-scatter"), ("alltoall", "all-to-all"),
          ("send", "collective-permute"), ("recv", "collective-permute"))
# ops that move no data beyond the views their schemas mark: allocations,
# the view a product's reshape makes, a scalar read
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "_unsafe_view", "_local_scalar_dense"}
_PROXY = torch._C._TorchDispatchModeKey.PROXY


def _tensors(x):
    """Every tensor in ``x`` (nested lists, tuples, dicts), in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for e in x for t in _tensors(e)]
    if isinstance(x, dict):
        return [t for e in x.values() for t in _tensors(e)]
    return []


def _size(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def collective_kind(func):
    """The reference's kind of a c10d op, or None for any other op."""
    if func.namespace not in ("c10d", "_c10d_functional"):
        return None
    name = func._schema.name.split("::")[-1]
    return next((kind for frag, kind in _KINDS if frag in name), None)


class Counter:
    """Counts one rank's dispatched work inside ``with Counter() as c:``;
    :meth:`track` the step's arguments first so that ``peak_bytes``
    starts from them.  :meth:`result` is the record."""

    def __init__(self):
        self.flops = 0
        self.bytes = 0
        self.collectives = collections.defaultdict(int)
        self.launches = collections.Counter()
        self.live = 0
        self.peak = 0
        self._storages = {}
        self._mode = _Mode(self)
        self._recording = None
        self._records = None

    # -- live storages ------------------------------------------------------
    def track(self, *trees) -> None:
        """Count the storages of the tensors in ``trees`` as live (the
        step's arguments: params, optimizer state, batch, cache)."""
        for t in (x for tr in trees for x in tree.leaves(tr)
                  if isinstance(x, torch.Tensor)):
            self._hold(t)

    def _hold(self, t) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live -= self._storages.pop(key, 0)

    # -- context ------------------------------------------------------------
    def __enter__(self):
        self._recording = _build.recording()
        self._records = self._recording.__enter__()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            self._mode.__exit__(*exc)
        finally:
            self._recording.__exit__(*exc)
        for rec in self._records:
            self.flops += rec["ops"]
            self.bytes += rec["bytes"]
            self.launches.update(rec["counts"])
        self._records = []
        return False

    def result(self) -> dict:
        coll = {k: int(v) for k, v in self.collectives.items()}
        return {"flops": int(self.flops), "bytes": int(self.bytes),
                "collectives": coll,
                "collective_total": int(sum(coll.values())),
                "launches": dict(sorted(self.launches.items())),
                "peak_bytes": int(self.peak)}


class _Mode(TorchDispatchMode):
    def __init__(self, counter):
        super().__init__()
        self.c = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if registry.REGISTRY.costing() or \
                torch._C._get_dispatch_mode(_PROXY) is not None:
            return out
        c = self.c
        outs = _tensors(out)
        kind = collective_kind(func)
        if kind is not None:
            # the c10d ops write their outputs in place: the first argument
            c.collectives[kind] += _size(_tensors(args[0]))
        packet = func._overloadpacket
        if packet in flop_registry:
            c.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        name = func._schema.name.split("::")[-1]
        if not func.is_view and name not in _NO_TRAFFIC:
            c.bytes += _size(_tensors((args, kwargs))) + _size(outs)
        for t in outs:
            c._hold(t)
        return out
