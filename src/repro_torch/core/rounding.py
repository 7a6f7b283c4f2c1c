"""Algorithm 4, vector rounding for the host WeightedMinHash (copy of
``repro.core.rounding``).

A unit vector ``z`` becomes exact integer repetition counts ``k_i =
floor(z_i^2 L)`` with the deficit ``L - sum(k)`` added at the largest
entry, so ``sum(k) == L`` holds exactly and the rounding error is
relative, not additive.
"""
from __future__ import annotations

import numpy as np


def round_counts(z: np.ndarray, L: int) -> np.ndarray:
    """Repetition counts ``k[i] = L * z~[i]^2`` as exact int64: ``sum(k) ==
    L``, ``k >= 0``, the deficit added at ``argmax |z|``."""
    z = np.asarray(z, dtype=np.float64)
    L = int(L)
    k = np.floor(z * z * L).astype(np.int64)
    deficit = L - int(k.sum())
    if deficit < 0:
        # only through round-off in the unit normalisation: shave the
        # excess off the largest count
        i = int(np.argmax(k))
        k[i] += deficit
        if k[i] < 0:  # pragma: no cover - needs pathological inputs
            raise ValueError("rounding deficit exceeded the largest count")
        return k
    k[int(np.argmax(np.abs(z)))] += deficit
    return k


def rounded_values(z: np.ndarray, k: np.ndarray, L: int) -> np.ndarray:
    """``z~[i] = sign(z[i]) sqrt(k[i] / L)``: the exactly-unit rounded
    vector."""
    z = np.asarray(z, dtype=np.float64)
    return np.sign(z) * np.sqrt(k.astype(np.float64) / float(L))


def round_unit(z: np.ndarray, L: int) -> np.ndarray:
    """All of Algorithm 4: a unit vector in, its rounded unit vector out."""
    return rounded_values(z, round_counts(z, L), L)
