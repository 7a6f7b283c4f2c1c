"""DMH, densified one-permutation weighted MinHash: the host sketcher with
its union-merge, and the pseudo-key replication of its ingest (copy of
``repro.core.dmh``).

A DMH sketch expands each key into ``c = dmh_replication(m)`` pseudo-keys
``key ^ r * REPLICA_SALT`` that share its weight, replica-major on the
last axis; r = 0 is the identity, so c = 1 is plain DMH.  ``c`` depends
on m alone, so sketches of different vectors stay coordinated.  The port's
sketch derives the pseudo-keys where it runs (``ops.dmh_sketch(...,
replicas=c)``); :func:`replicate_keys` is the host form the JAX package
passes to its kernel.

:class:`DMH` is the host oracle of the DMH family: each key goes to one
bin ``h(key) mod m`` (``DMH_STREAM_BIN``), is scored by the ICWS variates
drawn at ``t = bin``, and empty bins borrow from occupied ones through the
reseeded probe sequence ``h(t; j) mod m`` (``DMH_STREAM_DENSIFY``), the
sequence the sketch kernel probes.  Its sketches are
:class:`~.icws.ICWSSketch` rows, bit for bit ``repro.core.dmh.DMH``'s.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.kernels.common import (DMH_STREAM_BETA, DMH_STREAM_BIN,
                                        DMH_STREAM_C1, DMH_STREAM_C2,
                                        DMH_STREAM_DENSIFY, DMH_STREAM_FP,
                                        DMH_STREAM_R1, DMH_STREAM_R2,
                                        densify_probes)

from . import u32
from .icws import _BIG, ICWS, ICWSSketch
from .types import SparseVec

REPLICA_SALT = 0x85EBCA6B


def dmh_replication(m: int) -> int:
    """Pseudo-key replication factor ``c = clamp(m // 64, 1, 4)``."""
    return max(1, min(4, int(m) // 64))


def replica_salts(c: int) -> np.ndarray:
    """u32 XOR salts of a key's c pseudo-keys (``r * REPLICA_SALT``,
    wrapping in u32)."""
    return (np.arange(c, dtype=np.uint64)
            * np.uint64(REPLICA_SALT)).astype(np.uint32)


def replicate_keys(keys_u32: np.ndarray, c: int) -> np.ndarray:
    """Expand ``[..., n]`` u32 keys into ``[..., c * n]`` pseudo-keys,
    replica-major on the last axis."""
    salts = replica_salts(c)
    out = keys_u32[..., None, :] ^ salts[:, None]
    return out.reshape(*keys_u32.shape[:-1], c * keys_u32.shape[-1])


class DMH(ICWS):
    """Densified one-permutation weighted MinHash host sketcher: the ICWS
    estimator, stacking and storage with one pass over the non-zeros in
    place of an m-way broadcast."""

    name = "dmh"

    def _bins(self, keys_u32: np.ndarray) -> np.ndarray:
        """One u32 draw per key: its bin in [0, m)."""
        salt = u32.salt_for(self.seed, DMH_STREAM_BIN, np.zeros(1, np.uint32))
        return u32.hash_u32(keys_u32, salt) % np.uint32(self.m)

    def _rank(self, keys_u32: np.ndarray, w: np.ndarray, bins: np.ndarray):
        """ICWS hash value and level per key, variates drawn at t = bin."""
        def u(stream: int) -> np.ndarray:
            return u32.uniform01(keys_u32,
                                 u32.salt_for(self.seed, stream, bins))

        r = -np.log(u(DMH_STREAM_R1) * u(DMH_STREAM_R2))
        c = -np.log(u(DMH_STREAM_C1) * u(DMH_STREAM_C2))
        beta = u(DMH_STREAM_BETA)
        logw = np.log(np.maximum(w, np.float32(1e-37)))
        lvl = np.floor(logw / r + beta)
        y = np.exp(r * (lvl - beta))
        a = c / (y * np.exp(r))
        return np.where(w > 0, a, _BIG).astype(np.float32), lvl

    def _fingerprint(self, keys_u32: np.ndarray, lvl: np.ndarray,
                     t: np.ndarray) -> np.ndarray:
        fpbits = u32.hash_u32(
            keys_u32 ^ (lvl.astype(np.int32).astype(np.uint32)
                        * np.uint32(0x9E3779B9)),
            u32.salt_for(self.seed, DMH_STREAM_FP, t))
        return (fpbits & np.uint32(0x7FFFFFFF)).astype(np.int32)

    def _densify_sources(self, occupied: np.ndarray):
        """(empty bins, source bin of each): the first probe ``h(t; j) mod
        m`` that lands on an occupied bin, else the first occupied bin."""
        occ = np.asarray(occupied, bool)
        t = np.arange(self.m, dtype=np.int64)
        empty = t[~occ]
        salts = u32.salt_for(self.seed, DMH_STREAM_DENSIFY,
                             np.arange(densify_probes(self.m),
                                       dtype=np.int64))
        src = (u32.hash_u32(empty[:, None].astype(np.uint32), salts[None, :])
               % np.uint32(self.m)).astype(np.int64)        # [E, J]
        hit = occ[src]
        has = hit.any(axis=1)
        first = np.argmax(hit, axis=1)
        fallback = int(np.argmax(occ))
        picked = np.where(has, src[np.arange(empty.size), first], fallback)
        return empty, picked

    def sketch(self, v: SparseVec) -> ICWSSketch:
        norm = v.norm()
        if v.nnz == 0 or norm == 0.0:
            return ICWSSketch(fingerprints=np.full(self.m, -1, np.int32),
                              values=np.zeros(self.m), norm=0.0,
                              argkeys=np.zeros(self.m, np.int32))
        keys_u32 = (v.indices.astype(np.int64)
                    & np.int64(0xFFFFFFFF)).astype(np.uint32)
        z = v.values / norm
        c = dmh_replication(self.m)
        if c > 1:
            keys_u32 = replicate_keys(keys_u32, c)
            z = np.tile(z, c)
        z32 = z.astype(np.float32)
        w = z32 * z32
        bins = self._bins(keys_u32)
        a, lvl = self._rank(keys_u32, w, bins)
        t = np.arange(self.m, dtype=np.int64)
        # per-bin first-min argmin, the kernel's strict-< merge
        a_mat = np.where(bins[None, :] == t[:, None], a[None, :], _BIG)
        arg = np.argmin(a_mat, axis=1)
        amin = a_mat[t, arg].astype(np.float32)
        key_sel = keys_u32[arg]
        val_sel = z[arg]
        fp = self._fingerprint(key_sel, lvl[arg], t)
        occ = amin < _BIG
        if not occ.any():
            # every weight underflowed f32 squaring: an empty sketch that
            # keeps the true norm, as the device path does
            return ICWSSketch(fingerprints=np.full(self.m, -1, np.int32),
                              values=np.zeros(self.m), norm=norm,
                              argkeys=np.zeros(self.m, np.int32))
        if not occ.all():
            empty, src = self._densify_sources(occ)
            fp[empty] = fp[src]
            val_sel[empty] = val_sel[src]
            key_sel[empty] = key_sel[src]
        return ICWSSketch(fingerprints=fp, values=val_sel, norm=norm,
                          argkeys=key_sel.view(np.int32))

    def merge(self, sa: ICWSSketch, sb: ICWSSketch) -> ICWSSketch:
        """Union-merge of two disjoint-support DMH sketches.  Bin t holds
        its own minimum iff ``bin(argkey[t]) == t``; per such origin bin
        the two winners are re-scored under the merged norm, strict-< with
        ties toward the smaller key picks one, and bins with no origin on
        either side re-densify from the merged occupancy."""
        if sa.norm == 0.0:
            return dataclasses.replace(sb)
        if sb.norm == 0.0:
            return dataclasses.replace(sa)
        if sa.argkeys is None or sb.argkeys is None:
            raise ValueError("DMH merge needs argkeys sidecars "
                             "(pre-argkeys sketches cannot be merged)")
        norm_c = float(np.sqrt(sa.norm ** 2 + sb.norm ** 2))
        t = np.arange(self.m, dtype=np.int64)

        def rescore(s: ICWSSketch):
            keys = np.asarray(s.argkeys).view(np.uint32)
            origin = ((np.asarray(s.fingerprints) >= 0)
                      & (self._bins(keys) == t))
            z = np.asarray(s.values, np.float64) * (s.norm / norm_c)
            z32 = z.astype(np.float32)
            a, lvl = self._rank(keys, z32 * z32, t)
            a = np.where(origin, a, _BIG).astype(np.float32)
            return keys, z, a, lvl

        ka, za, aa, la = rescore(sa)
        kb, zb, ab, lb = rescore(sb)
        pick_b = (ab < aa) | ((ab == aa) & (kb < ka))
        key_c = np.where(pick_b, kb, ka)
        val_c = np.where(pick_b, zb, za)
        fp = self._fingerprint(key_c, np.where(pick_b, lb, la), t)
        occ = np.minimum(aa, ab) < _BIG
        fp = np.where(occ, fp, -1).astype(np.int32)
        val_c = np.where(occ, val_c, 0.0)
        key_c = np.where(occ, key_c, np.uint32(0))
        if occ.any() and not occ.all():
            empty, src = self._densify_sources(occ)
            fp[empty] = fp[src]
            val_c[empty] = val_c[src]
            key_c[empty] = key_c[src]
        return ICWSSketch(fingerprints=fp, values=val_c, norm=norm_c,
                          argkeys=key_c.astype(np.uint32).view(np.int32))
