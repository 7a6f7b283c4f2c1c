"""Sparse vectors over a huge key domain (copy of ``repro.core.types``).

Only what the port uses is kept: construction from (index, value) pairs
with duplicate aggregation or from a dense array, ``nnz`` and the L2 norm.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SparseVec:
    """A sparse real vector: ``v[indices[k]] = values[k]``, dimension ``n``.

    Indices are unique and values non-zero (``from_pairs`` drops zeros), so
    ``nnz == len(indices)``.
    """

    indices: np.ndarray  # int64 [nnz], unique, ascending
    values: np.ndarray   # float64 [nnz], non-zero
    n: int               # ambient dimension

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def norm(self) -> float:
        return float(np.sqrt(np.sum(self.values ** 2)))

    @staticmethod
    def from_dense(a: np.ndarray) -> "SparseVec":
        a = np.asarray(a, dtype=np.float64)
        idx = np.nonzero(a)[0].astype(np.int64)
        return SparseVec(indices=idx, values=a[idx], n=int(a.shape[0]))

    @staticmethod
    def from_pairs(indices, values, n: int,
                   sum_duplicates: bool = False) -> "SparseVec":
        idx = np.asarray(indices, dtype=np.int64)
        val = np.asarray(values, dtype=np.float64)
        if sum_duplicates and idx.size:
            uniq, inverse = np.unique(idx, return_inverse=True)
            acc = np.zeros(uniq.size, np.float64)
            np.add.at(acc, inverse, val)
            idx, val = uniq, acc
        keep = val != 0.0
        idx, val = idx[keep], val[keep]
        order = np.argsort(idx, kind="stable")
        idx, val = idx[order], val[order]
        if idx.size and np.any(idx[1:] == idx[:-1]):
            raise ValueError("duplicate indices in SparseVec")
        return SparseVec(indices=idx, values=val, n=n)
