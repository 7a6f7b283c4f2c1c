"""Threshold and priority sampling of one sparse vector (copy of the
functions in ``repro.core.sampling``).

Both schemes share one coordinated uniform hash ``h(key) in (0, 1)``
(stream ``SAMPLE_STREAM_HASH``), so two independently built samples pick
the same coordinates consistently.  Both serialize to the fixed-slot row
``(keys, vals, tau)`` that the key-match estimate consumes: live keys in
the 31-bit non-negative domain, unique (duplicates aggregated) and
ascending, with inclusion probabilities ``p = min(1, slots * v^2 / tau)``
(``tau <= 0`` means probability 1).  Rows are bit for bit the JAX
package's.  :class:`ThresholdSamplingU32` and :class:`PrioritySamplingU32`
are the families' host oracles: sketch, estimate and union-merge.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from . import u32
from .types import SparseVec

# salt stream of the coordinated sample hash (same id as the JAX package's
# sampling stream; spelled the port's way so no registry name appears here)
SAMPLE_STREAM_HASH = 41

# live keys occupy the 31-bit non-negative domain: the estimate's negative
# pad sentinels (query -1, corpus and spare rows -2) can never collide
SAMPLE_KEY_MASK = 0x7FFFFFFF


def ts_target(slots: int) -> int:
    """Default threshold-sampling target for a ``slots``-slot row: two
    standard deviations of slack below the slot count."""
    return max(1, int(slots) - int(np.ceil(2.0 * np.sqrt(max(slots, 1)))))


def _fold_aggregate(indices: np.ndarray, values: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Fold raw int64 indices into the 31-bit key domain and aggregate
    duplicates.  Returns (sorted unique keys, summed values), exact zeros
    dropped."""
    k = np.asarray(indices, np.int64) & np.int64(SAMPLE_KEY_MASK)
    v = np.asarray(values, np.float64)
    uniq, inverse = np.unique(k, return_inverse=True)
    agg = np.zeros(uniq.size, np.float64)
    np.add.at(agg, inverse, v)
    live = agg != 0.0
    return uniq[live], agg[live]


def _sample_hash(keys: np.ndarray, seed: int) -> np.ndarray:
    """The coordinated uniform hash h(key) in (0, 1), as float64."""
    # a length-1 salt array: numpy warns on wrapping scalar uint32 overflow
    # inside the mixer, not on array lanes
    salt = u32.salt_for(seed, SAMPLE_STREAM_HASH, np.zeros(1, np.uint32))
    return u32.uniform01(keys.astype(np.uint64).astype(np.uint32),
                         salt).astype(np.float64)


def threshold_sample(indices: np.ndarray, values: np.ndarray, *, slots: int,
                     seed: int) -> Tuple[np.ndarray, np.ndarray, float]:
    """Threshold-sample one sparse vector: keep every key with ``h < p =
    min(1, target * v^2 / ||v||^2)``, ``target = ts_target(slots)``; on the
    rare overflow past ``slots`` keep the ``slots`` smallest ``h / p``
    ranks.  Returns ``(keys, vals, tau)`` with keys ascending and ``tau =
    ||v||^2 * slots / target``."""
    target = ts_target(slots)
    keys, vals = _fold_aggregate(indices, values)
    if keys.size == 0:
        return keys.astype(np.int64), vals, 0.0
    sq = vals * vals
    norm2 = float(sq.sum())
    p = np.minimum(1.0, float(target) * sq / norm2)
    h = _sample_hash(keys, seed)
    keep = h < p
    if int(keep.sum()) > slots:
        rank = np.where(keep, h / p, np.inf)
        keep = np.zeros_like(keep)
        keep[np.argsort(rank, kind="stable")[:slots]] = True
    tau = norm2 * float(slots) / float(target)
    return keys[keep], vals[keep], tau


def priority_sample(indices: np.ndarray, values: np.ndarray, *, slots: int,
                    seed: int) -> Tuple[np.ndarray, np.ndarray, float]:
    """Priority-sample one sparse vector: keep the ``slots`` smallest ranks
    ``h / v^2``, ``tau = slots / R_(slots+1)``; ``tau = 0`` (probability 1)
    when the whole support fits.  Keys come out ascending."""
    keys, vals = _fold_aggregate(indices, values)
    if keys.size <= slots:
        return keys, vals, 0.0
    h = _sample_hash(keys, seed)
    rank = h / (vals * vals)
    order = np.argsort(rank, kind="stable")
    tau = float(slots) / float(rank[order[slots]])
    keep = np.sort(order[:slots])
    return keys[keep], vals[keep], tau


def sample_probs(vals: np.ndarray, tau: float, slots: int) -> np.ndarray:
    """Inclusion probabilities of a stored row in f64: ``min(1, slots v^2 /
    tau)``, 1 where ``tau <= 0``, 0 for empty (``v == 0``) slots."""
    v = np.asarray(vals, np.float64)
    if tau > 0:
        p = np.minimum(1.0, float(slots) * v * v / float(tau))
    else:
        p = np.ones_like(v)
    return np.where(v != 0.0, p, 0.0)


@dataclasses.dataclass
class SampleSketch:
    """Up to ``slots`` (key, value) pairs and the probability scale
    ``tau``."""

    keys: np.ndarray      # int64 ascending, 31-bit domain
    values: np.ndarray    # float64 raw values
    tau: float            # p = min(1, slots * v^2 / tau); tau <= 0 => 1
    slots: int            # the fixed layout size the probabilities scale to

    def storage_doubles(self) -> float:
        """A key (i32) and value (f32) pair per slot is one double
        equivalent, plus one double for tau."""
        return float(self.slots) + 1.0


class _SamplingU32:
    """Shared host plumbing of the two sampling sketchers."""

    def __init__(self, slots: int, seed: int = 0):
        if slots < 1:
            raise ValueError("slots must be >= 1")
        self.slots = int(slots)
        self.seed = int(seed)

    def _select(self, indices, values):
        raise NotImplementedError

    def sketch(self, v: SparseVec) -> SampleSketch:
        keys, vals, tau = self._select(v.indices, v.values)
        return SampleSketch(keys=keys, values=vals, tau=tau, slots=self.slots)

    def sketch_dense(self, a: np.ndarray) -> SampleSketch:
        return self.sketch(SparseVec.from_dense(a))

    def estimate(self, sa: SampleSketch, sb: SampleSketch) -> float:
        """``sum va vb / min(pa, pb)`` over the matched keys: the
        coordinated hash makes ``min(pa, pb)`` the probability that a key
        lands in both samples."""
        common, ia, ib = np.intersect1d(sa.keys, sb.keys, return_indices=True)
        if common.size == 0:
            return 0.0
        va, vb = sa.values[ia], sb.values[ib]
        p = np.minimum(sample_probs(va, sa.tau, self.slots),
                       sample_probs(vb, sb.tau, self.slots))
        return float(np.sum(va * vb / np.where(p > 0, p, 1.0) * (p > 0)))

    def _merge_candidates(self, sa: SampleSketch, sb: SampleSketch):
        """Validate a union-merge and return the pooled slots."""
        for s in (sa, sb):
            if s.slots != self.slots:
                raise ValueError(f"slot mismatch: sketch has {s.slots}, "
                                 f"sketcher has {self.slots}")
        if np.intersect1d(sa.keys, sb.keys).size:
            raise ValueError("union-merge requires disjoint supports "
                             "(shared keys found in both samples)")
        return (np.concatenate([sa.keys, sb.keys]),
                np.concatenate([sa.values, sb.values]))

    @staticmethod
    def _packed(keys, vals, keep, tau, slots) -> SampleSketch:
        order = np.argsort(keys[keep], kind="stable")
        return SampleSketch(keys=keys[keep][order], values=vals[keep][order],
                            tau=float(tau), slots=slots)


class ThresholdSamplingU32(_SamplingU32):
    """Threshold-sampling host oracle at the target
    :func:`ts_target` gives."""

    name = "ts"

    def _select(self, indices, values):
        return threshold_sample(indices, values, slots=self.slots,
                                seed=self.seed)

    def merge(self, sa: SampleSketch, sb: SampleSketch) -> SampleSketch:
        """Re-subsample the pooled slots under the merged threshold: for
        disjoint supports ``tau_a + tau_b`` is the union's tau, and the
        same coordinated coin ``h < p_c`` reproduces the build-once sample
        (modulo the rare per-shard overflow truncation)."""
        keys, vals = self._merge_candidates(sa, sb)
        tau = float(sa.tau) + float(sb.tau)
        if keys.size == 0:
            return SampleSketch(keys=keys, values=vals, tau=tau,
                                slots=self.slots)
        p = sample_probs(vals, tau, self.slots)
        h = _sample_hash(keys, self.seed)
        keep = h < p
        if int(keep.sum()) > self.slots:
            rank = np.where(keep, h / p, np.inf)
            keep = np.zeros_like(keep)
            keep[np.argsort(rank, kind="stable")[:self.slots]] = True
        return self._packed(keys, vals, keep, tau, self.slots)


class PrioritySamplingU32(_SamplingU32):
    """Priority-sampling host oracle: exactly ``min(nnz, slots)`` samples,
    the threshold rank folded into ``tau``."""

    name = "ps"

    def _select(self, indices, values):
        return priority_sample(indices, values, slots=self.slots,
                               seed=self.seed)

    def merge(self, sa: SampleSketch, sb: SampleSketch) -> SampleSketch:
        """Exactly the build-once priority sample: each side's threshold
        rank is ``T = slots / tau`` (infinite for ``tau <= 0``), the
        union's ``min(T_a, T_b, T_cand)`` with ``T_cand`` the (slots+1)-th
        smallest pooled rank; pooled ranks below it are kept."""
        keys, vals = self._merge_candidates(sa, sb)
        t_a = np.inf if sa.tau <= 0 else float(self.slots) / float(sa.tau)
        t_b = np.inf if sb.tau <= 0 else float(self.slots) / float(sb.tau)
        if keys.size == 0:
            return SampleSketch(keys=keys, values=vals, tau=0.0,
                                slots=self.slots)
        rank = _sample_hash(keys, self.seed) / (vals * vals)
        t_cand = (np.sort(rank)[self.slots] if keys.size > self.slots
                  else np.inf)
        t_c = min(t_a, t_b, t_cand)
        if np.isinf(t_c):
            keep = np.ones(keys.size, bool)
            tau = 0.0
        else:
            keep = rank < t_c
            tau = float(self.slots) / t_c
        return self._packed(keys, vals, keep, tau, self.slots)
