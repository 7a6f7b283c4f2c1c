"""Exact minimum of an arithmetic progression mod p in O(log p), vectorised
(copy of ``repro.core.progmin``).

With the pair hash ``h(i, j) = (a i + b j + c) mod p`` the slot hashes of
block i of the host WeightedMinHash's extended vector form the progression
``start_i + j b (mod p)``, j = 0 .. k_i - 1.  Its minimum comes from a
Euclidean descent in which each step at least halves the modulus, run as a
fixed-trip-count loop over the whole (m, nnz) grid: the same answer as
hashing all k_i slots, bit for bit.

Recurrence: ``f(a, b, m, n) = min_{i<n} (a i + b) mod m``, 0 <= a, b < m.

* ``a == 0`` or ``n == 1``: ``b``.
* ``a <= m/2``: with ``T = (a (n-1) + b) // m`` wraps, ``b`` if T == 0,
  else ``min(b, f((-m) mod a, (b - m) mod a, a, T))``.
* ``a > m/2`` (steps down by ``d = m - a``): ``b - d (n-1)`` if that never
  wraps, else ``min(v_last, f(m mod d, b mod d, d, K))`` with ``K = (d n -
  1 - b) // m + 1`` completed segments and ``v_last = (b - d (n-1)) mod m``.
"""
from __future__ import annotations

import numpy as np

_MAX_ITERS = 48  # the modulus halves each iteration; 2^31 needs <= 32


def progression_min(a, b, m, n) -> np.ndarray:
    """Elementwise ``min_{i=0..n-1} (a i + b) mod m`` over int64 arrays that
    broadcast; requires 0 <= a < m, 0 <= b < m and n >= 1."""
    a, b, m, n = np.broadcast_arrays(
        np.asarray(a, dtype=np.int64), np.asarray(b, dtype=np.int64),
        np.asarray(m, dtype=np.int64), np.asarray(n, dtype=np.int64))
    a, b, m, n = (np.ascontiguousarray(x).copy() for x in (a, b, m, n))
    if a.size == 0:
        return np.zeros_like(a)
    if (np.any(n < 1) or np.any(a < 0) or np.any(b < 0) or np.any(a >= m)
            or np.any(b >= m)):
        raise ValueError("progression_min requires 0<=a<m, 0<=b<m, n>=1")

    best = (m - 1).copy()   # values are < m: m - 1 is a safe infinity
    active = np.ones(a.shape, dtype=bool)
    for _ in range(_MAX_ITERS):
        if not active.any():
            break
        term = active & ((a == 0) | (n == 1))
        best[term] = np.minimum(best[term], b[term])
        active &= ~term

        half = m >> 1
        inc = active & (a <= half)
        dec = active & (a > half)

        if inc.any():
            ai, bi, mi, ni = a[inc], b[inc], m[inc], n[inc]
            T = (ai * (ni - 1) + bi) // mi
            best[inc] = np.minimum(best[inc], bi)
            done = T == 0
            na = (-mi) % ai
            nb = (bi - mi) % ai
            sub = np.zeros(a.shape, dtype=bool)
            sub[inc] = ~done
            fin = np.zeros(a.shape, dtype=bool)
            fin[inc] = done
            active &= ~fin
            a[sub], b[sub] = na[~done], nb[~done]
            m[sub], n[sub] = ai[~done], T[~done]

        if dec.any():
            ad, bd, md, nd = a[dec], b[dec], m[dec], n[dec]
            d = md - ad
            nowrap = d * (nd - 1) <= bd
            vals_nowrap = bd - d * (nd - 1)
            v_last = (bd - d * (nd - 1)) % md
            K = np.where(nowrap, 1, (d * nd - 1 - bd) // md + 1)
            best[dec] = np.minimum(best[dec],
                                   np.where(nowrap, vals_nowrap, v_last))
            fin = np.zeros(a.shape, dtype=bool)
            fin[dec] = nowrap
            active &= ~fin
            sub = np.zeros(a.shape, dtype=bool)
            sub[dec] = ~nowrap
            a[sub] = (md % d)[~nowrap]
            b[sub] = (bd % d)[~nowrap]
            m[sub] = d[~nowrap]
            n[sub] = K[~nowrap]

    if active.any():  # pragma: no cover - unreachable: the modulus halves
        raise RuntimeError("progression_min failed to converge")
    return best


def progression_min_bruteforce(a: int, b: int, m: int, n: int) -> int:
    """O(n) oracle for tests (keep n small)."""
    i = np.arange(int(n), dtype=np.int64)
    return int(np.min((np.int64(a) * i + np.int64(b)) % np.int64(m)))
