"""minicpm3-4b [hf:openbmb/MiniCPM3-4B] — dense with MLA.

62L d_model=2560 40H d_ff=6400 vocab=73448; MLA q_lora=768 kv_lora=256,
qk rope 32 + nope 64, v_head 64.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    vocab_size=73_448,
    n_heads=40,
    n_kv_heads=40,
    head_dim=96,             # nope 64 + rope 32
    d_ff=6400,
    attn_kind="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_rope_dim=32,
    qk_nope_dim=64,
    v_head_dim=64,
    rope_theta=10_000.0,
    act="silu",
    scale_embeddings=True,
    tie_embeddings=True,
    skip_shapes=("long_500k",),
)
