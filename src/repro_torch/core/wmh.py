"""Weighted MinHash inner-product sketching, Algorithms 3-5 of the paper
(copy of ``repro.core.wmh``): the host oracle of ``backend="host"``.

Sketch (Algorithm 3): normalise to unit norm, round the squared entries to
exact multiples of 1/L (Algorithm 4, :mod:`.rounding`), expand entry i
into ``k_i = L z~_i^2`` active slots of block i, and take m MinHashes over
the active slots.  The expansion is never built: per (hash t, block i) the
slot hashes form a progression mod p (:class:`.hashing.PairHashFamily`)
whose minimum :func:`.progmin.progression_min` takes exactly.

Estimate (Algorithm 5): the collision-indicator importance sum with
weights ``1 / q_i``, scaled by the weighted-union-size estimate ``M~``
and by ``||a|| ||b||``.  A sketch is m 31-bit hash minima, m values and
the norm: 1.5 m + 1 doubles.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from .hashing import MERSENNE_P, PairHashFamily
from .progmin import progression_min
from .rounding import round_counts
from .types import SparseVec

DEFAULT_L = 10 ** 7  # the paper's L in every experiment (its Section 5)


def compensated_sum(x: np.ndarray, axis: int = -1) -> np.ndarray:
    """Kahan-Neumaier compensated summation along ``axis`` (float64): the
    Algorithm-5 denominator, whose rounding drift L = 1e7 amplifies."""
    x = np.moveaxis(np.asarray(x, np.float64), axis, 0)
    total = np.zeros(x.shape[1:], np.float64)
    comp = np.zeros_like(total)
    for row in x:
        t = total + row
        comp = comp + np.where(np.abs(total) >= np.abs(row),
                               (total - t) + row, (row - t) + total)
        total = t
    return total + comp


@dataclasses.dataclass
class WMHSketch:
    hash_mins: np.ndarray  # int64 [m] in [0, p); p marks an empty input
    values: np.ndarray     # float64 [m]: rounded normalised value at argmin
    norm: float            # ||a||
    m: int
    L: int
    seed: int

    def storage_doubles(self) -> float:
        """A 32-bit hash and a 64-bit value per sample, plus the norm."""
        return 1.5 * self.m + 1.0


class WeightedMinHash:
    """Coordinated sketcher: every vector sketched with one (m, seed, L)
    uses the same hash functions, as Algorithms 3 and 5 require."""

    name = "wmh"

    def __init__(self, m: int, seed: int = 0, L: int = DEFAULT_L):
        if m < 1:
            raise ValueError("m must be >= 1")
        self.m = int(m)
        self.L = int(L)
        self.seed = int(seed)
        self._hash = PairHashFamily.create(self.m, self.seed)

    def sketch(self, v: SparseVec) -> WMHSketch:
        norm = v.norm()
        if v.nnz == 0 or norm == 0.0:
            return WMHSketch(
                hash_mins=np.full(self.m, MERSENNE_P, dtype=np.int64),
                values=np.zeros(self.m, dtype=np.float64),
                norm=0.0, m=self.m, L=self.L, seed=self.seed)
        z = v.values / norm
        k = round_counts(z, self.L)                    # int64, sum == L
        keep = k > 0
        blocks = v.indices[keep]
        counts = k[keep]
        vals = np.sign(z[keep]) * np.sqrt(counts.astype(np.float64) / self.L)

        starts = self._hash.block_starts(blocks)       # [m, nnz]
        steps = (self._hash.b[:, None] % MERSENNE_P) * np.ones_like(starts)
        n_rep = counts[None, :] * np.ones_like(starts)
        block_mins = progression_min(steps, starts, MERSENNE_P, n_rep)

        arg = np.argmin(block_mins, axis=1)            # [m]
        return WMHSketch(hash_mins=block_mins[np.arange(self.m), arg],
                         values=vals[arg], norm=norm, m=self.m, L=self.L,
                         seed=self.seed)

    def sketch_dense(self, a: np.ndarray) -> WMHSketch:
        return self.sketch(SparseVec.from_dense(a))

    def estimate(self, sa: WMHSketch, sb: WMHSketch) -> float:
        return float(self.estimate_batch(_stack([sa]), _stack([sb]))[0])

    def estimate_batch(self, A: "StackedWMH", B: "StackedWMH") -> np.ndarray:
        """Algorithm 5 over P sketch pairs."""
        p = float(MERSENNE_P)
        ha = A.hash_mins.astype(np.float64) / p        # [P, m] in [0, 1]
        hb = B.hash_mins.astype(np.float64) / p
        collide = A.hash_mins == B.hash_mins
        va, vb = A.values, B.values
        q = np.minimum(va * va, vb * vb)
        q = np.where(collide & (q > 0), q, 1.0)
        denom = np.maximum(compensated_sum(np.minimum(ha, hb), axis=1),
                           1e-300)
        m_tilde = (self.m / denom - 1.0) / float(self.L)
        summand = np.where(collide, va * vb / q, 0.0)
        est_unit = m_tilde / self.m * np.sum(summand, axis=1)
        out = A.norm * B.norm * est_unit
        return np.where((A.norm == 0) | (B.norm == 0), 0.0, out)


@dataclasses.dataclass
class StackedWMH:
    hash_mins: np.ndarray  # int64 [P, m]
    values: np.ndarray     # float64 [P, m]
    norm: np.ndarray       # float64 [P]


def _stack(sketches: List[WMHSketch]) -> StackedWMH:
    return StackedWMH(
        hash_mins=np.stack([s.hash_mins for s in sketches]),
        values=np.stack([s.values for s in sketches]),
        norm=np.array([s.norm for s in sketches], dtype=np.float64))


stack_wmh = _stack


def sketch_bruteforce(sketcher: WeightedMinHash, v: SparseVec) -> WMHSketch:
    """The oracle of the progression-minimum path: expand the extended
    vector and hash all of its active slots with the same pair hash (small
    nnz and L only)."""
    norm = v.norm()
    if v.nnz == 0 or norm == 0.0:
        return sketcher.sketch(v)
    z = v.values / norm
    k = round_counts(z, sketcher.L)
    keep = k > 0
    blocks = v.indices[keep]
    counts = k[keep]
    vals = np.sign(z[keep]) * np.sqrt(counts.astype(np.float64) / sketcher.L)

    m = sketcher.m
    best = np.full(m, MERSENNE_P, dtype=np.int64)
    best_val = np.zeros(m, dtype=np.float64)
    for bi, ki, vi in zip(blocks, counts, vals):
        h = sketcher._hash.hash_pairs_bruteforce(int(bi), np.arange(int(ki)))
        hmin = h.min(axis=1)
        upd = hmin < best
        best = np.where(upd, hmin, best)
        best_val = np.where(upd, vi, best_val)
    return WMHSketch(hash_mins=best, values=best_val, norm=norm,
                     m=m, L=sketcher.L, seed=sketcher.seed)
