"""2-universal affine hashing over Z_p, p = 2^31 - 1 (copy of the part of
``repro.core.hashing`` that KMV sampling uses).

Keys are relabelled by the splitmix64 finalizer before the affine hash;
all arithmetic is numpy int64/uint64, bit for bit the JAX package's.
"""
from __future__ import annotations

import dataclasses

import numpy as np

MERSENNE_P = np.int64((1 << 31) - 1)


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([0x5EED, int(seed)]))


def mix64(x: np.ndarray) -> np.ndarray:
    """Splitmix64 finalizer: a fixed bijection of the key space."""
    z = np.asarray(x).astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def _mix_to_zp(x: np.ndarray) -> np.ndarray:
    return (mix64(x) % np.uint64(MERSENNE_P)).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class AffineHashFamily:
    """m independent hashes h_t(x) = (c1[t]*x + c2[t]) mod p, x in [0, p)."""

    c1: np.ndarray  # int64 [m], in [1, p)
    c2: np.ndarray  # int64 [m], in [0, p)

    @staticmethod
    def create(m: int, seed: int) -> "AffineHashFamily":
        g = _rng(seed)
        c1 = g.integers(1, MERSENNE_P, size=m, dtype=np.int64)
        c2 = g.integers(0, MERSENNE_P, size=m, dtype=np.int64)
        return AffineHashFamily(c1=c1, c2=c2)

    @property
    def m(self) -> int:
        return int(self.c1.shape[0])

    def hash_ints(self, x: np.ndarray) -> np.ndarray:
        """Hash int64 inputs x[...] -> int64 [m, ...] in [0, p)."""
        x = _mix_to_zp(x)
        shape = (self.m,) + (1,) * x.ndim
        return (self.c1.reshape(shape) * x + self.c2.reshape(shape)) % MERSENNE_P
