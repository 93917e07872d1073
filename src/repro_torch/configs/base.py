"""Model/shape configuration schema: a copy of the JAX package's
``configs/base.py`` (pure Python), so that the port imports nothing of it."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

_MISSING = object()


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    vocab_size: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0

    # attention -------------------------------------------------------------
    attn_kind: str = "gqa"           # gqa | mla | none
    rope_theta: float = 10_000.0
    window: Optional[int] = None     # sliding-window size for 'local' layers
    local_global: Optional[Tuple[int, int]] = None  # e.g. (5, 1); None = global
    softcap: Optional[float] = None          # attention logit softcap (gemma2)
    final_softcap: Optional[float] = None    # final logit softcap (gemma2)
    qk_norm: bool = False            # gemma3 per-head q/k rmsnorm

    # MLA (deepseek-v2 / minicpm3) -------------------------------------------
    q_lora_rank: int = 0             # 0 = dense q projection
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0

    # MoE ---------------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    capacity_factor: float = 1.25
    first_dense_layers: int = 0      # deepseek-v2: first layer uses dense FFN
    d_ff_dense: int = 0              # FFN width of those dense layers

    # SSM (mamba2) -------------------------------------------------------------
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 128
    ssm_expand: int = 2

    # hybrid (zamba2) -----------------------------------------------------------
    shared_attn_every: int = 0       # invoke the shared attn block every N layers

    # encoder-decoder (whisper) ---------------------------------------------------
    n_enc_layers: int = 0
    n_frames: int = 1500             # stub audio-frame positions

    # vlm (pixtral) ----------------------------------------------------------------
    n_patches: int = 0               # stub image-patch positions

    # misc -----------------------------------------------------------------------
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "silu"                # silu | gelu
    gated_mlp: bool = True
    sandwich_norm: bool = False      # gemma2/3 pre+post block norms
    scale_embeddings: bool = False   # gemma: x *= sqrt(d)
    tie_embeddings: bool = True
    dtype: str = "bfloat16"

    # distribution hints -----------------------------------------------------------
    use_sp: bool = False             # sequence-parallel residual stream
    fsdp: bool = False               # shard params over the data axis too
    remat: bool = True
    # which shape cells are skipped for this arch (e.g. quadratic @ 500k)
    skip_shapes: Tuple[str, ...] = ()

    # ---------------------------------------------------------------------------
    def __post_init__(self):
        if self.n_heads and not self.head_dim and self.attn_kind == "gqa":
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_heads and not self.n_kv_heads:
            object.__setattr__(self, "n_kv_heads", self.n_heads)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: same family/topology, tiny widths."""
        kw = dict(
            n_layers=min(self.n_layers, 4),
            d_model=64,
            vocab_size=256,
            n_heads=min(self.n_heads, 4) or 0,
            n_kv_heads=min(self.n_kv_heads, 2) or 0,
            head_dim=16 if self.n_heads else 0,
            d_ff=128 if self.d_ff else 0,
        )
        if self.attn_kind == "mla":
            kw.update(q_lora_rank=32 if self.q_lora_rank else 0,
                      kv_lora_rank=32, qk_rope_dim=8, qk_nope_dim=16,
                      v_head_dim=16, head_dim=24)
        if self.n_experts:
            kw.update(n_experts=min(self.n_experts, 8),
                      top_k=min(self.top_k, 2), d_expert=32,
                      d_ff_dense=128 if self.d_ff_dense else 0)
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_headdim=16, ssm_chunk=32)
        if self.shared_attn_every:
            kw.update(shared_attn_every=2)
        if self.local_global:
            unit = sum(self.local_global)
            kw.update(n_layers=max(4, unit))
        if self.n_enc_layers:
            kw.update(n_enc_layers=2, n_frames=8)
        if self.n_patches:
            kw.update(n_patches=4)
        if self.window:
            kw.update(window=16)
        return self.replace(**kw)

    # parameter-count estimates (for roofline MODEL_FLOPS = 6*N*D) ----------
    def param_counts(self) -> Tuple[int, int]:
        """(total, active-per-token) parameter counts of the backbone."""
        d = self.d_model
        emb = self.vocab_size * d
        total = emb if self.tie_embeddings else 2 * emb
        active = total

        def attn_params():
            if self.attn_kind == "mla":
                qd = (self.q_lora_rank * (d + self.n_heads * (self.qk_rope_dim + self.qk_nope_dim))
                      if self.q_lora_rank else
                      d * self.n_heads * (self.qk_rope_dim + self.qk_nope_dim))
                kvd = d * (self.kv_lora_rank + self.qk_rope_dim) + \
                    self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
                out = self.n_heads * self.v_head_dim * d
                return qd + kvd + out
            hd = self.head_dim
            return d * hd * (self.n_heads + 2 * self.n_kv_heads) + \
                self.n_heads * hd * d

        def mlp_params(ff):
            return d * ff * (3 if self.gated_mlp else 2)

        def mamba_params():
            di, g, n = self.d_inner, self.ssm_groups, self.ssm_state
            h = self.ssm_heads
            in_p = d * (2 * di + 2 * g * n + h)
            conv = (di + 2 * g * n) * self.ssm_conv
            out_p = di * d
            return in_p + conv + out_p + 3 * h

        kinds = self.layer_pattern()
        for kind in kinds:
            if kind == "mamba" or kind == "mamba_shared":
                total += mamba_params()
                active += mamba_params()
                if kind == "mamba_shared":
                    pass  # shared params counted once below
            elif kind == "moe":
                a = attn_params()
                moe_total = self.n_experts * 3 * d * self.d_expert
                moe_active = self.top_k * 3 * d * self.d_expert
                shared = self.n_shared_experts * 3 * d * self.d_expert
                router = d * self.n_experts
                total += a + moe_total + shared + router
                active += a + moe_active + shared + router
            elif kind == "moe_dense":
                a = attn_params()
                total += a + mlp_params(self.d_ff_dense or self.d_ff)
                active += a + mlp_params(self.d_ff_dense or self.d_ff)
            else:  # attn / local / enc / dec
                a = attn_params()
                f = mlp_params(self.d_ff)
                x = a + f
                if kind == "dec":
                    x += a  # cross attention
                total += x
                active += x
        if self.shared_attn_every:
            # one shared attention+mlp block over concat width 2d
            d2 = 2 * d
            shared = d2 * self.head_dim * (self.n_heads + 2 * self.n_kv_heads) \
                + self.n_heads * self.head_dim * d + 2 * d2 * self.d_ff
            total += shared
            # active per invocation already excluded from per-layer loop
            n_inv = len([k for k in kinds if k == "mamba_shared"])
            active += shared  # shared weights touched each pass
        return total, active

    def layer_pattern(self):
        """Per-layer block kinds, length n_layers (+ encoder for encdec)."""
        n = self.n_layers
        if self.family == "ssm":
            return ["mamba"] * n
        if self.family == "hybrid":
            k = self.shared_attn_every
            return [("mamba_shared" if (i + 1) % k == 0 else "mamba")
                    for i in range(n)]
        if self.family == "moe":
            pat = []
            for i in range(n):
                pat.append("moe_dense" if i < self.first_dense_layers else "moe")
            return pat
        if self.family == "encdec":
            return ["dec"] * n
        if self.local_global is not None:
            loc, glob = self.local_global
            unit = ["local"] * loc + ["attn"] * glob
            pat = [unit[i % len(unit)] for i in range(n)]
            return pat
        return ["attn"] * n

    def pattern_unit(self):
        """(unit, repeats, remainder) decomposition for scan-over-superblocks."""
        pat = self.layer_pattern()
        if self.family == "hybrid":
            unit = pat[:self.shared_attn_every]
        elif self.local_global is not None:
            unit = pat[:sum(self.local_global)]
        elif self.first_dense_layers:
            unit = None  # handled as remainder-prefix
        else:
            unit = pat[:1]
        if unit is None:
            prefix = pat[:self.first_dense_layers]
            rest = pat[self.first_dense_layers:]
            return prefix, rest[:1], len(rest), []
        reps = len(pat) // len(unit)
        rem = pat[reps * len(unit):]
        return [], unit, reps, rem


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
