"""Linear sketches, JL projection and CountSketch (copy of
``repro.core.linear``).  Both are linear maps, ``S(a + b) = S(a) + S(b)``:
merging adds tables.

Two hash contracts live here:

* ``JL`` and ``CountSketch``, the paper's f64 baselines of Fact 1: signs
  and buckets from 4-wise independent polynomial hashes over Z_p, so the
  classic AMS and CountSketch variance analysis applies.
* ``JLU32`` and ``CountSketchU32``, the host oracles of the CS and JL
  serving families: buckets and signs come from the u32 mixer the CUDA
  sketches draw (``CS_STREAM_BUCKET`` and ``CS_STREAM_SIGN`` per repetition
  r, ``JL_STREAM_SIGN`` per sample t), so a host sketch and a device sketch
  of one vector hold the same table up to f64 against f32 summation order.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.kernels.common import (CS_STREAM_BUCKET, CS_STREAM_SIGN,
                                        JL_STREAM_SIGN)

from . import u32
from .hashing import MERSENNE_P, _mix_to_zp, _rng
from .types import SparseVec

REPS = 5  # CountSketch repetitions: the median of five


def _keys_u32(indices: np.ndarray) -> np.ndarray:
    """Fold int64 indices into the kernels' uint32 key domain."""
    return (np.asarray(indices, np.int64)
            & np.int64(0xFFFFFFFF)).astype(np.uint32)


def _poly_hash(coeffs: np.ndarray, x: np.ndarray) -> np.ndarray:
    """4-wise independent polynomial hash over Z_p: coeffs [k, deg], x
    [nnz] -> int64 [k, nnz]."""
    x = _mix_to_zp(np.asarray(x, dtype=np.int64))
    acc = np.zeros((coeffs.shape[0], x.shape[0]), dtype=np.int64)
    for d in range(coeffs.shape[1]):  # Horner, mod p a step: products < 2^62
        acc = (acc * x[None, :] + coeffs[:, d][:, None]) % MERSENNE_P
    return acc


def _make_coeffs(k: int, deg: int, seed: int) -> np.ndarray:
    return _rng(seed).integers(0, MERSENNE_P, size=(k, deg), dtype=np.int64)


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


class _Projection:
    """``S(a)[t] = m^-1/2 sum_i sigma_t(i) a_i``; a subclass draws the
    signs ``sigma [m, nnz]``."""

    def sketch(self, v: SparseVec) -> JLSketch:
        if v.nnz == 0:
            return JLSketch(proj=np.zeros(self.m))
        return JLSketch(proj=(self._signs(v.indices) @ v.values)
                        / np.sqrt(self.m))

    def sketch_dense(self, a: np.ndarray) -> JLSketch:
        return self.sketch(SparseVec.from_dense(a))

    def estimate(self, sa: JLSketch, sb: JLSketch) -> float:
        return float(np.dot(sa.proj, sb.proj))

    def merge(self, sa: JLSketch, sb: JLSketch) -> JLSketch:
        return JLSketch(proj=sa.proj + sb.proj)


class _Tables:
    """CountSketch over ``reps`` repetitions; a subclass draws the buckets
    and signs ``[reps, nnz]``.  The estimate is the median over repetitions
    of the table dots; ``decode`` the median point query."""

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

    def decode(self, s: CSSketch, indices: np.ndarray) -> np.ndarray:
        buckets, signs = self._hashes(indices)
        est = np.stack([s.table[r, buckets[r]] * signs[r]
                        for r in range(self.reps)])
        return np.median(est, axis=0)


class JL(_Projection):
    """The paper's JL: sigma from a 4-wise polynomial hash a sample."""

    name = "jl"

    def __init__(self, m: int, seed: int = 0):
        self.m = int(m)
        self.seed = int(seed)
        self._coeffs = _make_coeffs(self.m, 4, seed ^ 0x11)

    def _signs(self, indices: np.ndarray) -> np.ndarray:
        h = _poly_hash(self._coeffs, indices)          # [m, nnz]
        return 1.0 - 2.0 * (h & 1).astype(np.float64)


class CountSketch(_Tables):
    """The paper's CountSketch: buckets and signs from 4-wise polynomial
    hashes a repetition."""

    name = "cs"

    def __init__(self, width: int, seed: int = 0, reps: int = REPS):
        self.width = int(width)
        self.reps = int(reps)
        self.seed = int(seed)
        self._bucket_coeffs = _make_coeffs(self.reps, 4, seed ^ 0x22)
        self._sign_coeffs = _make_coeffs(self.reps, 4, seed ^ 0x33)

    def _hashes(self, indices: np.ndarray):
        buckets = _poly_hash(self._bucket_coeffs, indices) % self.width
        signs = 1.0 - 2.0 * (_poly_hash(self._sign_coeffs, indices) & 1)
        return buckets, signs


class JLU32(_Projection):
    """``sigma_t(i)`` the parity of ``hash_u32(key_i, salt(seed,
    JL_STREAM_SIGN, t))``."""

    name = "jl_u32"

    def __init__(self, m: int, seed: int = 0):
        self.m = int(m)
        self.seed = int(seed)

    def _signs(self, indices: np.ndarray) -> np.ndarray:
        salt = u32.salt_for(self.seed, JL_STREAM_SIGN, np.arange(self.m))
        h = u32.hash_u32(_keys_u32(indices)[None, :], salt[:, None])
        return 1.0 - 2.0 * (h & np.uint32(1)).astype(np.float64)


class CountSketchU32(_Tables):
    """CountSketch whose bucket and sign a repetition come from the u32
    mixer."""

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
