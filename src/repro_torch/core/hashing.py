"""2-universal hashing over Z_p, p = 2^31 - 1 (copy of
``repro.core.hashing``): the affine hash of MinHash and KMV sampling, the
multilinear pair hash of the host WeightedMinHash and its keyed uniforms.

Keys are relabelled by the splitmix64 finalizer before hashing; all
arithmetic is numpy int64/uint64, bit for bit the JAX package's.  Within a
block i the pair hash ``h(i, j) = (a i + b j + c) mod p`` is the
progression ``start(i) + j b (mod p)`` that :mod:`.progmin` minimises.
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

    def hash_unit(self, x: np.ndarray) -> np.ndarray:
        """Hash to floats in [0, 1), as the paper's algorithms are written."""
        return self.hash_ints(x).astype(np.float64) / float(MERSENNE_P)


@dataclasses.dataclass(frozen=True)
class PairHashFamily:
    """m independent multilinear hashes h_t(i, j) = (a[t] i + b[t] j + c[t])
    mod p, 2-universal over pairs with 0 <= i, j < p."""

    a: np.ndarray  # int64 [m], in [1, p)
    b: np.ndarray  # int64 [m], in [1, p): the progression step, non-zero
    c: np.ndarray  # int64 [m], in [0, p)

    @staticmethod
    def create(m: int, seed: int) -> "PairHashFamily":
        g = _rng(seed ^ 0x9E3779B9)
        a = g.integers(1, MERSENNE_P, size=m, dtype=np.int64)
        b = g.integers(1, MERSENNE_P, size=m, dtype=np.int64)
        c = g.integers(0, MERSENNE_P, size=m, dtype=np.int64)
        return PairHashFamily(a=a, b=b, c=c)

    @property
    def m(self) -> int:
        return int(self.a.shape[0])

    def block_starts(self, blocks: np.ndarray) -> np.ndarray:
        """h_t(i, 0) for each block i: int64 [m, nnz] in [0, p).  The block
        index is mix64-relabelled first; the slot index j is not."""
        blocks = _mix_to_zp(np.asarray(blocks, dtype=np.int64))
        return (self.a[:, None] * blocks[None, :]
                + self.c[:, None]) % MERSENNE_P

    def hash_pairs_bruteforce(self, i: int, js: np.ndarray) -> np.ndarray:
        """Hash (i, j) for each j: int64 [m, len(js)] (a test oracle)."""
        js = np.asarray(js, dtype=np.int64) % MERSENNE_P
        i = np.int64(_mix_to_zp(np.array([int(i)]))[0])
        return (self.a[:, None] * i + self.b[:, None] * js[None, :]
                + self.c[:, None]) % MERSENNE_P


def uniforms_from_key(seed: int, stream: int, keys: np.ndarray,
                      m: int) -> np.ndarray:
    """Pseudo-uniform floats in (0, 1) keyed by (key, t), t in [0, m):
    float64 [m, nnz], each ``stream`` an independent family."""
    fam = AffineHashFamily.create(m, seed ^ (0xA5A5A5 + 7919 * stream))
    z = fam.hash_ints(keys).astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    z = z ^ (z >> np.uint64(31))
    u = (z >> np.uint64(11)).astype(np.float64) / float(1 << 53)
    return np.clip(u, 1e-12, 1.0 - 1e-12)
