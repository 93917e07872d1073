"""gemma2-2b [arXiv:2408.00118].

26L d_model=2304 8H (GQA kv=4, head_dim 256) d_ff=9216 vocab=256000,
alternating local (4096 window) / global layers, attn softcap 50,
final logit softcap 30, sandwich norms.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    vocab_size=256_000,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    local_global=(1, 1),
    window=4096,
    softcap=50.0,
    final_softcap=30.0,
    sandwich_norm=True,
    scale_embeddings=True,
    rope_theta=10_000.0,
    act="gelu",
    tie_embeddings=True,
    skip_shapes=("long_500k",),
)
