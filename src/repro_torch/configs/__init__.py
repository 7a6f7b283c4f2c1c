"""Architecture registry: ``--arch <id>`` resolves here (the port's copy of
``repro/configs/__init__.py``; every config equal to the JAX one by value)."""
from __future__ import annotations

from typing import Dict

from .base import SHAPES, ModelConfig, ShapeConfig, cell_applicable
from . import (codeqwen1_5_7b, gemma_7b, internvl2_1b, jamba_1_5_large_398b,
               mistral_nemo_12b, mixtral_8x22b, qwen3_moe_30b_a3b,
               rwkv6_1_6b, tinyllama_1_1b, whisper_base)

_MODULES = {
    "mixtral-8x22b": mixtral_8x22b,
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b,
    "codeqwen1.5-7b": codeqwen1_5_7b,
    "tinyllama-1.1b": tinyllama_1_1b,
    "mistral-nemo-12b": mistral_nemo_12b,
    "gemma-7b": gemma_7b,
    "whisper-base": whisper_base,
    "internvl2-1b": internvl2_1b,
    "rwkv6-1.6b": rwkv6_1_6b,
    "jamba-1.5-large-398b": jamba_1_5_large_398b,
}

ARCHS = tuple(_MODULES.keys())


def get(name: str) -> ModelConfig:
    return _MODULES[name].CONFIG


def reduced(name: str) -> ModelConfig:
    """Small same-family config for CPU smoke tests."""
    return _MODULES[name].REDUCED


def all_configs() -> Dict[str, ModelConfig]:
    return {k: m.CONFIG for k, m in _MODULES.items()}


__all__ = ["ARCHS", "SHAPES", "ModelConfig", "ShapeConfig", "cell_applicable",
           "get", "reduced", "all_configs"]
