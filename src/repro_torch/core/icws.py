"""Host (numpy) ICWS sketch and estimator: a copy of ``repro.core.icws``.

The oracle of the port's corpus path: :class:`ICWS` sketches a
:class:`~repro_torch.core.types.SparseVec` on the host with the same u32
mixer and salt streams as the CUDA sketch kernel (``csrc/icws_sketch.cu``)
and the JAX package's host and device sketches, so a host-sketched vector
carries fingerprints interoperable with device-sketched ones, bit for bit
equal to ``repro.core.ICWS``'s (both are numpy over the same mixer).
``ICWS.estimate_batch`` is the f64 estimator that the device corpus
estimates are held against; host sketches enter a device corpus through
``SketchCorpus.add_sketches`` (``argkeys`` is the merge sidecar).

Per (index i, sample t), keyed pseudo-randomness:
    r ~ Gamma(2,1)   (= -log(u1*u2)),   c ~ Gamma(2,1),   beta ~ U[0,1]
    t_i  = floor(log(w_i) / r + beta)
    y_i  = exp(r * (t_i - beta))
    a_i  = c / (y_i * exp(r))
Sample = argmin_i a_i; two sketches collide at sample t iff the argmin
index and its level t_i agree.  A 31-bit fingerprint of (index, level) is
kept (-1 is the empty sentinel), with the signed normalized value at the
argmin and the norm.  The estimate is Algorithm 5 with the weighted union
size ``M = 2 / (1 + J^)`` of unit-norm weights.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from repro_torch.kernels.common import (ICWS_STREAM_BETA, ICWS_STREAM_C1,
                                        ICWS_STREAM_C2, ICWS_STREAM_FP,
                                        ICWS_STREAM_R1, ICWS_STREAM_R2)

from . import u32
from .types import SparseVec

_BIG = np.float32(3.0e38)  # empty-lane sentinel, the kernels' BIG


@dataclasses.dataclass
class ICWSSketch:
    # int32 [m]: 31-bit fp of (argmin index, level); -1 empty
    fingerprints: np.ndarray
    values: np.ndarray        # float64 [m]: normalized signed value at argmin
    norm: float
    # int32 [m] winning key (index mod 2^32) per sample; 0 for empty samples:
    # the union-merge sidecar (levels are recomputed under the merged norm)
    argkeys: np.ndarray = None

    def storage_doubles(self) -> float:
        return 1.5 * self.fingerprints.shape[0] + 1.0


class ICWS:
    name = "icws"

    def __init__(self, m: int, seed: int = 0):
        self.m = int(m)
        self.seed = int(seed)

    def _draws(self, keys_u32: np.ndarray, t: np.ndarray):
        """(r, c, beta) f32 for each (t, key) pair that broadcasts."""
        def u(stream: int) -> np.ndarray:
            return u32.uniform01(keys_u32, u32.salt_for(self.seed, stream, t))

        r = -np.log(u(ICWS_STREAM_R1) * u(ICWS_STREAM_R2))   # Gamma(2,1)
        c = -np.log(u(ICWS_STREAM_C1) * u(ICWS_STREAM_C2))   # Gamma(2,1)
        return r, c, u(ICWS_STREAM_BETA)

    def _fingerprints(self, keys_u32, lvl, t) -> np.ndarray:
        fpbits = u32.hash_u32(
            keys_u32 ^ (lvl.astype(np.uint32) * np.uint32(0x9E3779B9)),
            u32.salt_for(self.seed, ICWS_STREAM_FP, t))
        return (fpbits & np.uint32(0x7FFFFFFF)).astype(np.int32)

    def sketch(self, v: SparseVec) -> ICWSSketch:
        norm = v.norm()
        if v.nnz == 0 or norm == 0.0:
            return ICWSSketch(fingerprints=np.full(self.m, -1, np.int32),
                              values=np.zeros(self.m), norm=0.0,
                              argkeys=np.zeros(self.m, np.int32))
        keys_u32 = (v.indices.astype(np.int64)
                    & np.int64(0xFFFFFFFF)).astype(np.uint32)
        z = v.values / norm
        z32 = z.astype(np.float32)
        w = z32 * z32                               # f32 weights, sum ~ 1
        rows = np.arange(self.m)
        r, c, beta = self._draws(keys_u32[None, :],
                                 rows.astype(np.int64)[:, None])  # [m, nnz]
        logw = np.log(np.maximum(w, np.float32(1e-37)))[None, :]
        lvl = np.floor(logw / r + beta)             # t_i
        y = np.exp(r * (lvl - beta))
        a = c / (y * np.exp(r))
        # f32 squaring can underflow a tiny non-zero entry to w == 0; the
        # kernel masks those lanes as padding, so the host does too
        a = np.where((w > 0)[None, :], a, _BIG)
        arg = np.argmin(a, axis=1)                  # [m]
        lvl_sel = lvl[rows, arg].astype(np.int32)
        fp = self._fingerprints(keys_u32[arg], lvl_sel, rows)
        return ICWSSketch(fingerprints=fp, values=z[arg], norm=norm,
                          argkeys=keys_u32[arg].view(np.int32))

    def sketch_dense(self, a: np.ndarray) -> ICWSSketch:
        return self.sketch(SparseVec.from_dense(a))

    def merge(self, sa: ICWSSketch, sb: ICWSSketch) -> ICWSSketch:
        """Union-merge oracle: sketch of ``a + b`` from the two sketches of
        vectors with disjoint supports, re-scoring each sample's two
        winners under the merged norm (variates redrawn from (sample,
        key), the smaller hash wins, ties toward the smaller key).
        Approximate against sketching the union from scratch, as in the
        JAX package."""
        if sa.norm == 0.0:
            return dataclasses.replace(sb)
        if sb.norm == 0.0:
            return dataclasses.replace(sa)
        if sa.argkeys is None or sb.argkeys is None:
            raise ValueError("ICWS merge needs argkeys sidecars "
                             "(pre-argkeys sketches cannot be merged)")
        norm_c = float(np.sqrt(sa.norm ** 2 + sb.norm ** 2))
        t = np.arange(self.m, dtype=np.int64)

        def rescore(s: ICWSSketch):
            keys = np.asarray(s.argkeys).view(np.uint32)
            z = np.asarray(s.values, np.float64) * (s.norm / norm_c)
            z32 = z.astype(np.float32)
            w = z32 * z32
            r, c, beta = self._draws(keys, t)
            logw = np.log(np.maximum(w, np.float32(1e-37)))
            lvl = np.floor(logw / r + beta)
            y = np.exp(r * (lvl - beta))
            a = c / (y * np.exp(r))
            a = np.where((s.fingerprints < 0) | (w <= 0), _BIG, a)
            return keys, z, a.astype(np.float32), lvl.astype(np.int32)

        ka, za, aa, la = rescore(sa)
        kb, zb, ab, lb = rescore(sb)
        pick_b = (ab < aa) | ((ab == aa) & (kb < ka))
        key_c = np.where(pick_b, kb, ka)
        val_c = np.where(pick_b, zb, za)
        fp = self._fingerprints(key_c, np.where(pick_b, lb, la), t)
        dead = np.minimum(aa, ab) >= _BIG
        return ICWSSketch(
            fingerprints=np.where(dead, -1, fp).astype(np.int32),
            values=np.where(dead, 0.0, val_c),
            norm=norm_c,
            argkeys=np.where(dead, 0, key_c.view(np.int32)).astype(np.int32))

    def estimate(self, sa: ICWSSketch, sb: ICWSSketch) -> float:
        return float(self.estimate_batch(_stack([sa]), _stack([sb]))[0])

    def estimate_batch(self, A: "StackedICWS", B: "StackedICWS") -> np.ndarray:
        collide = (A.fingerprints == B.fingerprints) & (A.fingerprints >= 0)
        va, vb = A.values, B.values
        q = np.minimum(va * va, vb * vb)
        q = np.where(collide & (q > 0), q, 1.0)
        j_hat = np.mean(collide, axis=1)
        m_tilde = 2.0 / (1.0 + j_hat)       # M = 2/(1+J) for unit norms
        s = np.sum(np.where(collide, va * vb / q, 0.0), axis=1)
        out = A.norm * B.norm * (m_tilde / collide.shape[1]) * s
        return np.where((A.norm == 0) | (B.norm == 0), 0.0, out)


@dataclasses.dataclass
class StackedICWS:
    fingerprints: np.ndarray
    values: np.ndarray
    norm: np.ndarray


def _stack(sketches: List[ICWSSketch]) -> StackedICWS:
    return StackedICWS(
        fingerprints=np.stack([s.fingerprints for s in sketches]),
        values=np.stack([s.values for s in sketches]),
        norm=np.array([s.norm for s in sketches], dtype=np.float64))


stack_icws = _stack
