"""mistral-large-123b [hf:mistralai/Mistral-Large-Instruct-2407].

88L d_model=12288 96H (GQA kv=8, head_dim 128) d_ff=28672 vocab=32768.
The TP/FSDP/SP stress case: params+optimizer demand 2-axis sharding.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12_288,
    vocab_size=32_768,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28_672,
    rope_theta=1_000_000.0,
    act="silu",
    tie_embeddings=False,
    use_sp=True,
    fsdp=True,
    skip_shapes=("long_500k",),
)
