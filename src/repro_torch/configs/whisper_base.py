"""whisper-base [audio] — 6L d512 8H d_ff=2048 vocab=51865, encoder-decoder.
The conv/mel frontend is a STUB: input_specs() supplies precomputed frame
embeddings [B, 1500, 512].  [arXiv:2212.04356]"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="encdec",
    num_layers=6, d_model=512, num_heads=8, num_kv_heads=8, head_dim=64,
    d_ff=2048, vocab_size=51865,
    encoder_layers=6, encoder_seq=1500, encoder_d_model=512,
    rope_theta=1e4, mlp_variant="gelu",
)

REDUCED = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256, encoder_layers=2, encoder_seq=30,
    encoder_d_model=64)
