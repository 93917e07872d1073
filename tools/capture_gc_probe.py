"""Whether a collection that frees one CUDA graph while another is being
captured breaks that capture (with the installed torch and CUDA).

    python3 tools/capture_gc_probe.py      # needs a CUDA device

Prints one line: the capture survived, or the error it failed with.
``port/compile.py`` pauses Python's cyclic collector during its captures
for this reason.
"""
import gc

import torch


def main():
    x = torch.zeros(4, device="cuda")
    s = torch.cuda.Stream()
    g0 = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g0, stream=s):
        x + 1
    g1 = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(g1, stream=s, capture_error_mode="thread_local"):
            x * 2
            holder = [g0]
            holder.append(holder)      # a cycle: only the collector frees it
            del g0, holder
            gc.collect()
        print("capture_gc_probe: the capture survived", flush=True)
    except Exception as e:  # noqa: BLE001 — report whatever capture raised
        print("capture_gc_probe: the capture failed:",
              str(e).splitlines()[0], flush=True)


if __name__ == "__main__":
    main()
