"""Optimizer side of the port: memory-efficient AdamW and sketch-based
gradient compression."""
from . import adamw
from .adamw import AdamWConfig

__all__ = ["adamw", "AdamWConfig"]
