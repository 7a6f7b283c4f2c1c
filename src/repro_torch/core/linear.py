"""Host CountSketch and JL on the kernels' u32 RNG (copy of
``CountSketchU32`` and ``JLU32`` from ``repro.core.linear``): the host
oracles of the CS and JL serving families.

Buckets and signs come from the u32 mixer the CUDA sketches draw
(``CS_STREAM_BUCKET`` and ``CS_STREAM_SIGN`` per repetition r,
``JL_STREAM_SIGN`` per sample t), so a host sketch and a device sketch of
one vector hold the same table up to f64 against f32 summation order.
Both are linear, ``S(a + b) = S(a) + S(b)``: merging adds tables.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.kernels.common import (CS_STREAM_BUCKET, CS_STREAM_SIGN,
                                        JL_STREAM_SIGN)

from . import u32
from .types import SparseVec

REPS = 5  # CountSketch repetitions: the median of five


def _keys_u32(indices: np.ndarray) -> np.ndarray:
    """Fold int64 indices into the kernels' uint32 key domain."""
    return (np.asarray(indices, np.int64)
            & np.int64(0xFFFFFFFF)).astype(np.uint32)


@dataclasses.dataclass
class JLSketch:
    proj: np.ndarray  # float64 [m]

    def storage_doubles(self) -> float:
        return float(self.proj.shape[0])


@dataclasses.dataclass
class CSSketch:
    table: np.ndarray  # float64 [reps, width]

    def storage_doubles(self) -> float:
        return float(self.table.size)


class JLU32:
    """``S(a)[t] = m^-1/2 sum_i sigma_t(i) a_i`` with ``sigma_t(i)`` the
    parity of ``hash_u32(key_i, salt(seed, JL_STREAM_SIGN, t))``."""

    name = "jl_u32"

    def __init__(self, m: int, seed: int = 0):
        self.m = int(m)
        self.seed = int(seed)

    def sketch(self, v: SparseVec) -> JLSketch:
        if v.nnz == 0:
            return JLSketch(proj=np.zeros(self.m))
        salt = u32.salt_for(self.seed, JL_STREAM_SIGN, np.arange(self.m))
        h = u32.hash_u32(_keys_u32(v.indices)[None, :], salt[:, None])
        signs = 1.0 - 2.0 * (h & np.uint32(1)).astype(np.float64)
        return JLSketch(proj=(signs @ v.values) / np.sqrt(self.m))

    def sketch_dense(self, a: np.ndarray) -> JLSketch:
        return self.sketch(SparseVec.from_dense(a))

    def estimate(self, sa: JLSketch, sb: JLSketch) -> float:
        return float(np.dot(sa.proj, sb.proj))

    def merge(self, sa: JLSketch, sb: JLSketch) -> JLSketch:
        return JLSketch(proj=sa.proj + sb.proj)


class CountSketchU32:
    """CountSketch whose bucket and sign per repetition come from the u32
    mixer; the estimate is the median over repetitions of the table
    dots."""

    name = "cs_u32"

    def __init__(self, width: int, seed: int = 0, reps: int = REPS):
        self.width = int(width)
        self.reps = int(reps)
        self.seed = int(seed)

    def _hashes(self, indices: np.ndarray):
        r = np.arange(self.reps)
        keys = _keys_u32(indices)[None, :]
        hb = u32.hash_u32(
            keys, u32.salt_for(self.seed, CS_STREAM_BUCKET, r)[:, None])
        buckets = (hb % np.uint32(self.width)).astype(np.int64)  # [R, nnz]
        hs = u32.hash_u32(
            keys, u32.salt_for(self.seed, CS_STREAM_SIGN, r)[:, None])
        signs = 1.0 - 2.0 * (hs & np.uint32(1)).astype(np.float64)
        return buckets, signs

    def sketch(self, v: SparseVec) -> CSSketch:
        table = np.zeros((self.reps, self.width), dtype=np.float64)
        if v.nnz == 0:
            return CSSketch(table=table)
        buckets, signs = self._hashes(v.indices)
        for r in range(self.reps):
            np.add.at(table[r], buckets[r], signs[r] * v.values)
        return CSSketch(table=table)

    def sketch_dense(self, a: np.ndarray) -> CSSketch:
        return self.sketch(SparseVec.from_dense(a))

    def estimate(self, sa: CSSketch, sb: CSSketch) -> float:
        return float(np.median(np.sum(sa.table * sb.table, axis=1)))

    def merge(self, sa: CSSketch, sb: CSSketch) -> CSSketch:
        return CSSketch(table=sa.table + sb.table)

