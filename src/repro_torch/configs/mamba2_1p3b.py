"""mamba2-1.3b [arXiv:2405.21060] — pure SSM (SSD), attention-free.

48L d_model=2048, expand 2 (d_inner 4096), headdim 64 (64 heads),
ssm_state=128, conv 4, vocab 50280.  long_500k RUNS: O(1)-state decode.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    vocab_size=50_280,
    attn_kind="none",
    d_ff=0,
    ssm_state=128,
    ssm_headdim=64,
    ssm_groups=1,
    ssm_conv=4,
    ssm_chunk=128,
    ssm_expand=2,
    norm="rmsnorm",
    tie_embeddings=True,
)
