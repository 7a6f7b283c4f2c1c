"""jamba-1.5-large-398b [hybrid] — 72L d8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16 experts top-2, Mamba:attention 7:1 interleave
(1 attention layer per 8-layer group), MoE every other layer.
[arXiv:2403.19887; hf]"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=65536,
    num_experts=16, num_experts_per_tok=2, moe_every=2, moe_offset=1,
    hybrid_group=8, hybrid_attn_index=4,
    ssm_state=16, ssm_expand=2, ssm_conv=4,
    rope_theta=1e4, mlp_variant="swiglu",
)

REDUCED = dataclasses.replace(
    CONFIG, num_layers=8, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, num_experts=4, hybrid_group=4,
    hybrid_attn_index=2, ssm_state=4)
