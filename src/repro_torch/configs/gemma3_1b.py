"""gemma3-1b [hf:google/gemma-3-1b-pt].

26L d_model=1152 4H (GQA kv=1, head_dim 256) d_ff=6912 vocab=262144,
5 local (sliding 512) : 1 global layer pattern, qk-norm, sandwich norms.
long_500k skipped: global layers still need the full dense cache
(DESIGN.md §shape-cell skips).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    vocab_size=262_144,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    local_global=(5, 1),
    window=512,
    rope_theta=1_000_000.0,
    qk_norm=True,
    sandwich_norm=True,
    scale_embeddings=True,
    act="gelu",
    tie_embeddings=True,
    skip_shapes=("long_500k",),
)
