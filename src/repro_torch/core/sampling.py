"""Threshold and priority sampling of one sparse vector (copy of the
functions in ``repro.core.sampling``).

Both schemes share one coordinated uniform hash ``h(key) in (0, 1)``
(stream ``SAMPLE_STREAM_HASH``), so two independently built samples pick
the same coordinates consistently.  Both serialize to the fixed-slot row
``(keys, vals, tau)`` that the key-match estimate consumes: live keys in
the 31-bit non-negative domain, unique (duplicates aggregated) and
ascending, with inclusion probabilities ``p = min(1, slots * v^2 / tau)``
(``tau <= 0`` means probability 1).  Rows are bit for bit the JAX
package's.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from . import u32

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
