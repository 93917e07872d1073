"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base].

24L d_model=1024 16H (GQA kv=8) per-expert d_ff=512, vocab 49155,
MoE 32 experts top-8, every layer MoE.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    vocab_size=49_155,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    n_experts=32,
    top_k=8,
    d_expert=512,
    rope_theta=10_000.0,
    act="silu",
    tie_embeddings=True,
    skip_shapes=("long_500k",),  # full attention: 500k dense cache regime
)
