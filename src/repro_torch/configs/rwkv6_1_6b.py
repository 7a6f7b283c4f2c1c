"""rwkv6-1.6b [ssm] — 24L d2048 (attention-free) d_ff=7168 vocab=65536.
"Finch": data-dependent per-channel decay; head size 64 => 32 heads.
[arXiv:2404.05892]"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32, head_dim=64,
    d_ff=7168, vocab_size=65536,
    mlp_variant="gelu",  # rwkv channel-mix uses squared relu; see models.ssm
)

REDUCED = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256)
