"""repro_torch — the portable-SIMD lowering framework (SIMDe->RVV paper)
ported to PyTorch, with the customized kernels written by hand in CUDA
for the NVIDIA H100."""
__version__ = "1.0.0"
