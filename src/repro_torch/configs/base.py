"""Model configuration schema + shape suite shared by every architecture
(the port's copy of ``repro/configs/base.py``, held equal by value)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_every: int = 1           # MoE FFN at layers where (layer % moe_every == moe_offset)
    moe_offset: int = 0
    capacity_factor: float = 1.25

    # attention
    sliding_window: int = 0      # 0 => full attention
    rope_theta: float = 1e4
    mlp_variant: str = "swiglu"  # swiglu | geglu | gelu

    # ssm (rwkv6 / mamba)
    ssm_state: int = 16          # mamba d_state
    ssm_expand: int = 2          # mamba d_inner = expand * d_model
    ssm_conv: int = 4            # mamba causal-conv width
    ssm_dt_rank: int = 0         # 0 => d_model // 16

    # hybrid (jamba): layers per group and the attention position inside it
    hybrid_group: int = 8        # 1 attention layer per `hybrid_group` layers
    hybrid_attn_index: int = 0

    # encoder-decoder (whisper): encoder depth + stub frontend sequence
    encoder_layers: int = 0
    encoder_seq: int = 0
    encoder_d_model: int = 0

    # vlm: stub patch-embedding count
    num_patches: int = 0

    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or max(1, self.d_model // 16)

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Can this arch decode at 500k context with bounded state?"""
        if self.family in ("ssm",):
            return True
        if self.family == "hybrid":
            return True               # attention is 1:hybrid_group and KV is small
        return self.sliding_window > 0  # SWA bounds the KV cache

    def param_count(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS)."""
        from repro_torch.models.counting import count_params
        return count_params(self)

    def active_param_count(self) -> int:
        from repro_torch.models.counting import count_active_params
        return count_active_params(self)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


# The assigned LM shape suite (identical for all 10 archs).
SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def cell_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Is (arch x shape) a runnable dry-run cell?  Returns (ok, reason)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention arch: 500k decode needs sub-quadratic attention"
    return True, ""
