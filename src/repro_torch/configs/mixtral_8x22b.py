"""mixtral-8x22b [moe] — 56L d6144 48H (GQA kv=8) d_ff=16384 vocab=32768,
MoE 8 experts top-2, sliding-window attention.  [arXiv:2401.04088; hf]"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    num_layers=56, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=32768,
    num_experts=8, num_experts_per_tok=2,
    sliding_window=4096, rope_theta=1e6, mlp_variant="swiglu",
)

REDUCED = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, num_experts=4, sliding_window=16)
