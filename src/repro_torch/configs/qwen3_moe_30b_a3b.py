"""qwen3-moe-30b-a3b [moe] — 48L d2048 32H (GQA kv=4) per-expert d_ff=768
vocab=151936, MoE 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B]
head_dim=128 per the HF config (decoupled from d_model/num_heads)."""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4, head_dim=128,
    d_ff=768, vocab_size=151936,
    num_experts=128, num_experts_per_tok=8,
    rope_theta=1e6, mlp_variant="swiglu",
)

REDUCED = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=32, vocab_size=256, num_experts=8, num_experts_per_tok=2)
