"""mistral-nemo-12b [dense] — 40L d5120 32H (GQA kv=8) d_ff=14336
vocab=131072, 128k context.  head_dim=128 per the HF config.
[hf:mistralai/Mistral-Nemo-Base-2407]"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b", family="dense",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=131072,
    rope_theta=1e6, mlp_variant="swiglu",
)

REDUCED = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256)
