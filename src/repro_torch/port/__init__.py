"""repro_torch.port — the NEON-source migration frontend.

The paper's primary task is *automated migration* of legacy NEON
intrinsic code: SIMDe ingests real C kernels and maps their types and
functions onto the target's vector architecture.  This package is that
frontend for the port's logical ISA (``repro_torch.core.isa``):

    C NEON kernel --cparse--> AST --lower--> typed SSA IR
        --intrinsics--> logical-ISA calls --interp--> registry.dispatch
                                                (cost-driven selection)

``compile_kernel`` turns source into a callable that executes on torch
tensors, on the card unless told otherwise; ``report`` emits the paper's
§4 analysis tables (per-intrinsic substitution/tier/instruction-count
across the RVV width family).

    >>> from repro_torch import port
    >>> k = port.compile_file("examples/neon_corpus/vadd.c")
    >>> out = k(n, a, b, out_buf)                    # runs on the card
    >>> out = k(n, a, b, out_buf, device="cpu")      # or on the CPU
    >>> rep = port.report(k, n, a, b, out_buf)       # migration report

The JIT backend of the reference (``retile``, ``compile``,
``CompiledKernel``, its LRU, ``run_resilient``) and ``autotune`` are not
ported yet (ROADMAP A.10c, A.10d).
"""
from __future__ import annotations

import os
from typing import Dict, Optional

from . import cparse, faultinject, intrinsics, interp, ir, lower
from . import resilience
from .cparse import ParseError, parse
from .interp import ExecError, Machine
from .intrinsics import UnknownIntrinsic, resolve
from .ir import TFunction
from .lower import LowerError, lower_function
from .report import PORT_SWEEP, format_report
from .report import report as _report
from .resilience import (
    CacheCorruption, CompileError, CompileTimeout, DeadlineExceeded,
    DegradationRecord, LadderExhausted, PortError, RevecVeto, SimError,
    degradation_records, resilience_stats, reset_resilience,
)

__all__ = [
    "PortedKernel", "compile_kernel", "compile_file", "load_corpus",
    "report", "format_report", "PORT_SWEEP",
    "parse", "lower_function", "resolve", "Machine",
    "ParseError", "LowerError", "ExecError", "UnknownIntrinsic",
    "CompileError",
    # resilience layer
    "PortError", "RevecVeto", "SimError", "CompileTimeout",
    "CacheCorruption", "DeadlineExceeded", "LadderExhausted",
    "DegradationRecord", "degradation_records", "resilience_stats",
    "reset_resilience", "resilience", "faultinject",
]


class PortedKernel:
    """A NEON kernel compiled onto the logical ISA.

    Calling it runs the kernel: pass one Python value per C parameter in
    order — ints for ``size_t``/scalar params, 1-D arrays or tensors for
    pointer params.  The return value is the final contents of the
    written-to buffer(s) (functional out-params), as tensors on
    ``device`` (default: the card).
    """

    def __init__(self, fn: TFunction):
        self.fn = fn

    @property
    def name(self) -> str:
        return self.fn.name

    @property
    def param_names(self):
        return [p.hint for p in self.fn.params]

    def __call__(self, *args, policy: Optional[str] = "pallas",
                 target=None, device=None):
        return Machine(self.fn, policy=policy, target=target,
                       device=device).run(*args)

    def estimate(self, *args, policy: Optional[str] = "pallas",
                 target=None) -> Dict:
        """Estimated dynamic vector-instruction counts for these example
        args: abstract interpretation — scalar control flow runs, every
        vector issue becomes a selection-cache cost lookup."""
        return Machine(self.fn, policy=policy, target=target,
                       abstract=True).run(*args)

    def substitution(self, target) -> Dict[str, bool]:
        """Table 2 for this kernel: per intrinsic, does its fixed-width
        register map natively onto ``target`` (``vlen >= width``)?"""
        from ..core import targets as _targets
        tgt = _targets.get_target(target)
        return {ins.attrs["intrinsic"]:
                tgt.supports_width(ins.attrs["width_bits"])
                for ins in self.fn.intrinsic_sites()}

    def pretty(self) -> str:
        return self.fn.pretty()

    def __repr__(self):
        return (f"PortedKernel({self.name!r}, params="
                f"{self.param_names}, writes={self.fn.writes})")


def compile_kernel(source: str, name: Optional[str] = None,
                   filename: Optional[str] = None) -> PortedKernel:
    """Parse + type + translate one kernel from C source.

    ``name`` selects a function when the translation unit defines
    several (default: the only one, or error).  ``filename`` feeds the
    ``file:line:col`` provenance on ParseError/LowerError.
    """
    fns = parse(source, filename=filename)
    if not fns:
        raise ParseError("no function definition found", file=filename)
    if name is None:
        if len(fns) > 1:
            raise ParseError(
                f"source defines {[f.name for f in fns]}; pass name=",
                file=filename)
        fdef = fns[0]
    else:
        try:
            fdef = next(f for f in fns if f.name == name)
        except StopIteration:
            raise ParseError(f"no function {name!r} in source "
                             f"(found {[f.name for f in fns]})",
                             file=filename)
    return PortedKernel(lower_function(fdef, source=source,
                                       filename=filename))


def compile_file(path: str, name: Optional[str] = None) -> PortedKernel:
    with open(path) as f:
        return compile_kernel(f.read(), name=name, filename=path)


def load_corpus(dirpath: str) -> Dict[str, PortedKernel]:
    """Compile every ``.c`` file in a corpus directory (sorted)."""
    out: Dict[str, PortedKernel] = {}
    for fname in sorted(os.listdir(dirpath)):
        if fname.endswith(".c"):
            k = compile_file(os.path.join(dirpath, fname))
            out[k.name] = k
    return out


def report(kernel, *example_args, **kw) -> Dict:
    """Migration report; accepts a PortedKernel or raw C source."""
    if isinstance(kernel, str):
        kernel = compile_kernel(kernel)
    return _report(kernel, *example_args, **kw)
