"""Numpy copies of the u32 mixers (``repro.core.u32``): the host samplers
(TS/PS) and the DMH replica salts draw bit for bit what the JAX package's
numpy twins draw.

The torch int64 mixer in ``repro_torch.kernels.common`` serves tensors on a
device; this module serves numpy arrays on the host.  All functions take
and return numpy arrays; uint32 arithmetic wraps mod 2^32 by construction.
"""
from __future__ import annotations

import numpy as np

_M1 = np.uint32(0x85EBCA6B)
_M2 = np.uint32(0xC2B2AE35)
_GOLDEN = np.uint32(0x9E3779B9)


def mix32(x: np.ndarray) -> np.ndarray:
    """Murmur3 fmix32 over uint32 lanes."""
    z = np.asarray(x).astype(np.uint32)
    z = z ^ (z >> np.uint32(16))
    z = z * _M1
    z = z ^ (z >> np.uint32(13))
    z = z * _M2
    z = z ^ (z >> np.uint32(16))
    return z


def hash_u32(key: np.ndarray, salt: np.ndarray) -> np.ndarray:
    """Mix key with a salt (two rounds, broadcast)."""
    k = np.asarray(key).astype(np.uint32)
    s = np.asarray(salt).astype(np.uint32)
    return mix32(mix32(k + s * _GOLDEN)
                 ^ (s * _M2 + np.uint32(0x27D4EB2F)))


def uniform01(key: np.ndarray, salt: np.ndarray) -> np.ndarray:
    """Strictly-interior uniform (0,1) f32 from the top 24 hash bits."""
    bits = hash_u32(key, salt) >> np.uint32(8)
    return (bits.astype(np.float32) * np.float32(2 ** -24)
            + np.float32(2 ** -25))


def salt_for(seed: int, stream: int, t: np.ndarray) -> np.ndarray:
    """Combine (seed, stream, sample index t) into a uint32 salt."""
    base = ((int(seed) & 0xFFFFFFFF) * 0x9E3779B1
            + int(stream) * 0x517CC1B7) & 0xFFFFFFFF
    return (np.uint32(base)
            + np.asarray(t).astype(np.uint32) * np.uint32(0x2545F491))
