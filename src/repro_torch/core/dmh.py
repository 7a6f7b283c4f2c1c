"""Pseudo-key replication of DMH ingest (copy of the part of
``repro.core.dmh`` that the device ingest uses).

A DMH sketch expands each key into ``c = dmh_replication(m)`` pseudo-keys
``key ^ r * REPLICA_SALT`` that share its weight, replica-major on the
last axis; r = 0 is the identity, so c = 1 is plain DMH.  ``c`` depends
on m alone, so sketches of different vectors stay coordinated.  The port's
sketch derives the pseudo-keys where it runs (``ops.dmh_sketch(...,
replicas=c)``); :func:`replicate_keys` is the host form the JAX package
passes to its kernel.
"""
from __future__ import annotations

import numpy as np

REPLICA_SALT = 0x85EBCA6B


def dmh_replication(m: int) -> int:
    """Pseudo-key replication factor ``c = clamp(m // 64, 1, 4)``."""
    return max(1, min(4, int(m) // 64))


def replica_salts(c: int) -> np.ndarray:
    """u32 XOR salts of a key's c pseudo-keys (``r * REPLICA_SALT``,
    wrapping in u32)."""
    return (np.arange(c, dtype=np.uint64)
            * np.uint64(REPLICA_SALT)).astype(np.uint32)


def replicate_keys(keys_u32: np.ndarray, c: int) -> np.ndarray:
    """Expand ``[..., n]`` u32 keys into ``[..., c * n]`` pseudo-keys,
    replica-major on the last axis."""
    salts = replica_salts(c)
    out = keys_u32[..., None, :] ^ salts[:, None]
    return out.reshape(*keys_u32.shape[:-1], c * keys_u32.shape[-1])
