"""codeqwen1.5-7b [dense] — 32L d4096 32H (MHA kv=32) d_ff=13440 vocab=92416.
qwen1.5 architecture.  [hf:Qwen/CodeQwen1.5-7B]"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=32, head_dim=128,
    d_ff=13440, vocab_size=92416,
    rope_theta=1e6, mlp_variant="swiglu",
)

REDUCED = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256)
