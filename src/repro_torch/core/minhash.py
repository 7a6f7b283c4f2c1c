"""Unweighted (augmented) MinHash, Algorithms 1 and 2 of the paper (copy
of ``repro.core.minhash``): the paper's MH baseline.

A sketch keeps, for each of m hash functions, the minimum hash over the
vector's support and the vector's value at the argmin.  The estimate is the
collision-indicator sum scaled by the union-size estimate ``U~``.  MinHash
is union-mergeable: the sketch of two disjoint-support vectors' sum is the
elementwise minimum of theirs.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from .hashing import MERSENNE_P, AffineHashFamily
from .types import SparseVec


@dataclasses.dataclass
class MHSketch:
    hash_mins: np.ndarray  # int64 [m]; p marks an empty input
    values: np.ndarray     # float64 [m]: the vector's value at the argmin
    m: int
    seed: int

    def storage_doubles(self) -> float:
        return 1.5 * self.m  # a 32-bit hash and a 64-bit value a sample


class MinHash:
    name = "mh"

    def __init__(self, m: int, seed: int = 0):
        self.m = int(m)
        self.seed = int(seed)
        self._hash = AffineHashFamily.create(self.m, self.seed)

    def sketch(self, v: SparseVec) -> MHSketch:
        if v.nnz == 0:
            return MHSketch(hash_mins=np.full(self.m, MERSENNE_P, np.int64),
                            values=np.zeros(self.m), m=self.m, seed=self.seed)
        h = self._hash.hash_ints(v.indices)            # [m, nnz]
        arg = np.argmin(h, axis=1)
        return MHSketch(hash_mins=h[np.arange(self.m), arg],
                        values=v.values[arg], m=self.m, seed=self.seed)

    def sketch_dense(self, a: np.ndarray) -> MHSketch:
        return self.sketch(SparseVec.from_dense(a))

    def merge_union(self, sa: MHSketch, sb: MHSketch) -> MHSketch:
        """The exact sketch of the union of two disjoint-support vectors,
        each minimum's value carried from its side."""
        take_a = sa.hash_mins <= sb.hash_mins
        return MHSketch(hash_mins=np.where(take_a, sa.hash_mins, sb.hash_mins),
                        values=np.where(take_a, sa.values, sb.values),
                        m=self.m, seed=self.seed)

    def estimate(self, sa: MHSketch, sb: MHSketch) -> float:
        return float(self.estimate_batch(_stack([sa]), _stack([sb]))[0])

    def estimate_batch(self, A: "StackedMH", B: "StackedMH") -> np.ndarray:
        """Algorithm 2 over P sketch pairs."""
        p = float(MERSENNE_P)
        ha = A.hash_mins.astype(np.float64) / p
        hb = B.hash_mins.astype(np.float64) / p
        denom = np.maximum(np.sum(np.minimum(ha, hb), axis=1), 1e-300)
        u_tilde = self.m / denom - 1.0                  # line 1
        collide = A.hash_mins == B.hash_mins
        s = np.sum(np.where(collide, A.values * B.values, 0.0), axis=1)
        return u_tilde / self.m * s                     # line 2


@dataclasses.dataclass
class StackedMH:
    hash_mins: np.ndarray  # int64 [P, m]
    values: np.ndarray     # float64 [P, m]


def _stack(sketches: List[MHSketch]) -> StackedMH:
    return StackedMH(hash_mins=np.stack([s.hash_mins for s in sketches]),
                     values=np.stack([s.values for s in sketches]))


stack_mh = _stack
