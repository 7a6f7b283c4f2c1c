"""internvl2-1b [vlm] — 24L d896 14H (GQA kv=2) d_ff=4864 vocab=151655.
InternLM2 text backbone; the InternViT frontend is a STUB: input_specs()
supplies precomputed patch embeddings [B, 256, 896].  [arXiv:2404.16821; hf]"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2, head_dim=64,
    d_ff=4864, vocab_size=151655,
    num_patches=256,
    rope_theta=1e6, mlp_variant="swiglu",
)

REDUCED = dataclasses.replace(
    CONFIG, num_layers=2, d_model=56, num_heads=2, num_kv_heads=1, head_dim=28,
    d_ff=128, vocab_size=256, num_patches=8)
