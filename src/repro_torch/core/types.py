"""Sparse vectors over a huge key domain (copy of ``repro.core.types``):
construction from (index, value) pairs with duplicate aggregation or from
a dense array, and the exact ground truth the paper's estimators are held
to -- the inner product and the bounds of Fact 1 and Theorem 2.
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

    def densify(self) -> np.ndarray:
        out = np.zeros(self.n, dtype=np.float64)
        out[self.indices] = self.values
        return out

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


def inner(a: SparseVec, b: SparseVec) -> float:
    """Exact inner product of two sparse vectors (the ground truth)."""
    ia = {int(i): float(v) for i, v in zip(a.indices, a.values)}
    acc = 0.0
    for i, v in zip(b.indices, b.values):
        acc += ia.get(int(i), 0.0) * float(v)
    return acc


def inner_fast(a: SparseVec, b: SparseVec) -> float:
    """Vectorised exact inner product via sorted-index intersection."""
    common, ia, ib = np.intersect1d(a.indices, b.indices, return_indices=True)
    if common.size == 0:
        return 0.0
    return float(np.sum(a.values[ia] * b.values[ib]))


def intersection_norms(a: SparseVec, b: SparseVec):
    """``(|I|, ||a_I||, ||b_I||)`` with ``I = supp(a) & supp(b)``: the
    terms of Theorem 2."""
    common, ia, ib = np.intersect1d(a.indices, b.indices, return_indices=True)
    a_i = float(np.sqrt(np.sum(a.values[ia] ** 2)))
    b_i = float(np.sqrt(np.sum(b.values[ib] ** 2)))
    return int(common.size), a_i, b_i


def theorem2_bound(a: SparseVec, b: SparseVec, eps: float = 1.0) -> float:
    """The right side of Theorem 2:
    ``eps max(||a_I|| ||b||, ||a|| ||b_I||)``."""
    _, a_i, b_i = intersection_norms(a, b)
    return eps * max(a_i * b.norm(), a.norm() * b_i)


def fact1_bound(a: SparseVec, b: SparseVec, eps: float = 1.0) -> float:
    """The right side of Fact 1 (linear sketching): ``eps ||a|| ||b||``."""
    return eps * a.norm() * b.norm()
