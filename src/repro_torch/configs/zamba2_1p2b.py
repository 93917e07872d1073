"""zamba2-1.2b [arXiv:2411.15242] — hybrid Mamba2 + shared attention.

38 Mamba2 layers d_model=2048 (ssm_state=64); a single *shared*
attention+MLP block (operating on concat(hidden, embedding) of width 2d,
32H, d_ff=8192) is invoked every 6 layers.  Per-invocation LoRA deltas on
the shared block are omitted (DESIGN.md §Arch-applicability).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    vocab_size=32_000,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,            # attention over concat width 2d = 4096
    d_ff=8192,
    ssm_state=64,
    ssm_headdim=64,
    ssm_groups=2,
    ssm_conv=4,
    ssm_chunk=128,
    shared_attn_every=6,
    rope_theta=10_000.0,
    act="gelu",
    tie_embeddings=True,
    # hybrid: long_500k RUNS (SSM state decode; shared-attn cache is
    # sequence-sharded)
)
