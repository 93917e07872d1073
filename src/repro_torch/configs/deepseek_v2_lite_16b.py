"""deepseek-v2-lite-16b [arXiv:2405.04434].

27L d_model=2048 16H, MLA kv_lora=512 (no q-lora in Lite), rope 64 +
nope 128 head dims, v_head 128; MoE: 64 routed + 2 shared experts,
top-6, expert d_ff=1408; first layer dense FFN (10944).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    vocab_size=102_400,
    n_heads=16,
    n_kv_heads=16,
    head_dim=192,            # qk_nope + qk_rope
    d_ff=1408,
    attn_kind="mla",
    q_lora_rank=0,
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    d_expert=1408,
    first_dense_layers=1,
    d_ff_dense=10_944,
    rope_theta=10_000.0,
    act="silu",
    tie_embeddings=False,
    skip_shapes=("long_500k",),
)
