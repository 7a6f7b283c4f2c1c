"""k-Minimum-Values sampling (copy of ``repro.core.kmv``): one hash
function keeps the k smallest (hash, value) pairs of the support, sampled
without replacement -- the paper's KMV baseline, and the correlation sketch
of Santos et al. 2021 that the index refines its k candidates from on the
host.  The union size comes from the k-th smallest hash of the merged
sample, the inner product from the matched samples."""
from __future__ import annotations

import dataclasses

import numpy as np

from .hashing import MERSENNE_P, AffineHashFamily
from .types import SparseVec


@dataclasses.dataclass
class KMVSketch:
    hashes: np.ndarray   # int64 [<=k], sorted ascending
    values: np.ndarray   # float64 [<=k], vector values aligned with hashes
    k: int
    seed: int

    def storage_doubles(self) -> float:
        return 1.5 * self.k  # a 32-bit hash and a 64-bit value a sample


class KMV:
    """One hash function; keep the k smallest (hash, value) pairs."""

    name = "kmv"

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

    def sketch_dense(self, a: np.ndarray) -> KMVSketch:
        return self.sketch(SparseVec.from_dense(a))

    def merge_union(self, sa: KMVSketch, sb: KMVSketch) -> KMVSketch:
        """The exact sketch of the union of two disjoint-support vectors:
        the k smallest hashes of the combined samples."""
        h = np.concatenate([sa.hashes, sb.hashes])
        v = np.concatenate([sa.values, sb.values])
        order = np.argsort(h, kind="stable")[: self.k]
        return KMVSketch(hashes=h[order], values=v[order], k=self.k,
                         seed=self.seed)

    def estimate(self, sa: KMVSketch, sb: KMVSketch) -> float:
        if sa.hashes.size == 0 or sb.hashes.size == 0:
            return 0.0
        union_h = np.union1d(sa.hashes, sb.hashes)      # sorted, unique
        kk = min(self.k, union_h.size)
        x = union_h[:kk]
        tau = float(x[-1]) / float(MERSENNE_P)          # k-th smallest
        if tau <= 0.0:
            return 0.0
        u_hat = (kk - 1) / tau if kk > 1 else 1.0 / tau  # union size
        # matched samples: in both sketches and among the union's k
        # smallest (so among each containing sketch's k smallest too)
        common, ia, ib = np.intersect1d(sa.hashes, sb.hashes,
                                        return_indices=True)
        keep = common <= x[-1]
        prod = np.sum(sa.values[ia[keep]] * sb.values[ib[keep]])
        return float(u_hat / kk * prod)

    def estimate_pairs(self, As, Bs) -> np.ndarray:
        return np.array([self.estimate(a, b) for a, b in zip(As, Bs)])
