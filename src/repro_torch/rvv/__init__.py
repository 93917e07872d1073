"""repro_torch.rvv — real RVV intrinsic codegen + instruction-level oracle.

The port frontend translates NEON kernels onto the logical ISA and the
re-vectorizer re-tiles them at VLEN x LMUL, but everything stays in
cost-model space.  This package is the paper's actual deliverable: walk
the (re-tiled) IR and emit **compilable RVV intrinsic C** — real
``vsetvli`` strips, ``__riscv_vle/vse/vlseg3e/vwmacc/vnclip/...`` —
then *execute* that instruction stream on an in-repo RVV simulator so
every ``revec_instrs`` estimate is backed by a retired-instruction
fact, and legalization bugs no NumPy reference can see (vsetvli
placement, tail policy, vxrm rounding) fail a differential check.

    >>> from repro_torch import rvv
    >>> from repro_torch.port import compile_file
    >>> k = compile_file("examples/neon_corpus/vadd.c")
    >>> prog = rvv.emit(k, "rvv-256")      # re-tiled, real vsetvli
    >>> print(prog.render_c())             # one .c unit per (kernel, target)
    >>> out, counts = rvv.execute(prog, n, a, b)
    >>> counts["executed"]                 # retired, not estimated

See DESIGN.md §12 for the codegen contract and the supported-
instruction table (generated from ``repro_torch.core.isa.RVV_MNEMONICS``).
Like the JAX package's ``repro.rvv`` it runs on NumPy only: the
simulator never touches a torch tensor.
"""
from __future__ import annotations

from .codegen import CodegenError, RvvProgram, emit, render_c
from .sim import RvvSim, SimError, run

__all__ = ["CodegenError", "SimError", "RvvProgram", "RvvSim",
           "emit", "render_c", "run", "execute"]


def execute(program_or_kernel, *args, target=None,
            revec: bool = True):
    """Emit (if needed) and run on the simulator.

    Accepts an :class:`RvvProgram`, or a PortedKernel/TFunction plus a
    ``target`` to emit for.  Returns ``(outputs, counts)`` where
    outputs follow the interpreter's calling convention and counts are
    the simulator's retired-instruction tallies.
    """
    prog = program_or_kernel
    if not isinstance(prog, RvvProgram):
        prog = emit(program_or_kernel, target, revec=revec)
    return run(prog, *args, with_counts=True)
