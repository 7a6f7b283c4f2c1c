"""gemma-7b [dense] — 28L d3072 16H (MHA kv=16) d_ff=24576 vocab=256000,
GeGLU MLP, head_dim=256 (attention width 4096 != d_model).
[arXiv:2403.08295; hf]"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b", family="dense",
    num_layers=28, d_model=3072, num_heads=16, num_kv_heads=16, head_dim=256,
    d_ff=24576, vocab_size=256000,
    rope_theta=1e4, mlp_variant="geglu", tie_embeddings=True,
)

REDUCED = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=32,
    d_ff=128, vocab_size=512)
