"""whisper-tiny [arXiv:2212.04356] — encoder-decoder audio backbone.

4 encoder + 4 decoder layers, d_model=384 6H d_ff=1536 vocab=51865,
LayerNorm + GELU, non-gated MLP.  The conv frontend is a STUB per the
brief: input_specs() provides precomputed (B, frames, d) embeddings.
Decode shapes interpret seq_len as decoder-cache length with a fixed
1500-frame encoder memory; sinusoidal positions extend past the
448-token original decoder horizon (DESIGN.md).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,
    n_enc_layers=4,
    d_model=384,
    vocab_size=51_865,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    n_frames=1500,
    norm="layernorm",
    act="gelu",
    gated_mlp=False,
    rope_theta=0.0,          # sinusoidal absolute positions, no rope
    tie_embeddings=True,
    skip_shapes=("long_500k",),
)
