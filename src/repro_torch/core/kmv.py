"""k-Minimum-Values keyed samples (copy of the sketching half of
``repro.core.kmv``): the correlation sketch of Santos et al. 2021 that the
index refines its k candidates from on the host."""
from __future__ import annotations

import dataclasses

import numpy as np

from .hashing import AffineHashFamily
from .types import SparseVec


@dataclasses.dataclass
class KMVSketch:
    hashes: np.ndarray   # int64 [<=k], sorted ascending
    values: np.ndarray   # float64 [<=k], vector values aligned with hashes
    k: int
    seed: int


class KMV:
    """One hash function; keep the k smallest (hash, value) pairs."""

    def __init__(self, k: int, seed: int = 0):
        self.k = int(k)
        self.seed = int(seed)
        self._hash = AffineHashFamily.create(1, self.seed ^ 0x7F4A7C15)

    def sketch(self, v: SparseVec) -> KMVSketch:
        if v.nnz == 0:
            return KMVSketch(hashes=np.zeros(0, np.int64),
                             values=np.zeros(0), k=self.k, seed=self.seed)
        h = self._hash.hash_ints(v.indices)[0]          # [nnz]
        order = np.argsort(h, kind="stable")[: self.k]
        return KMVSketch(hashes=h[order], values=v.values[order],
                         k=self.k, seed=self.seed)
