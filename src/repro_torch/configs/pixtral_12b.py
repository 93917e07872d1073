"""pixtral-12b [hf:mistralai/Pixtral-12B-2409] — VLM backbone.

40L d_model=5120 32H (GQA kv=8, head_dim 128) d_ff=14336 vocab=131072
(mistral-nemo-like decoder).  The pixtral ViT frontend is a STUB per the
brief: input_specs() provides precomputed (B, patches, d) embeddings,
prepended to the token sequence.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    vocab_size=131_072,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    n_patches=256,           # stub image: 256 patch embeddings
    rope_theta=1_000_000.0,
    act="silu",
    tie_embeddings=False,
    fsdp=True,
    skip_shapes=("long_500k",),
)
