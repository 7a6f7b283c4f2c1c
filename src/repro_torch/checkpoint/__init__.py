"""Atomic, async checkpoints in the JAX package's on-disk format."""
from .store import (AsyncCheckpointer, all_steps, latest_step, restore, save)

__all__ = ["AsyncCheckpointer", "all_steps", "latest_step", "restore", "save"]
