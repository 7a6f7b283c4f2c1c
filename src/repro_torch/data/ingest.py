"""Batch ingest: pad sparse vectors into the sketch kernels' ``[B, N]``
layouts (numpy, bit for bit ``repro.data.ingest.pad_sparse_batch`` and
``pad_linear_batch``) and sketch them on a device; or, for the sampling
families (TS/PS), build the finished sample rows on the host
(``pad_sample_batch``, bit for bit the JAX package's) and move them to a
device."""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.dmh import dmh_replication
from repro_torch.core.sampling import priority_sample, threshold_sample
from repro_torch.core.types import SparseVec
from repro_torch.kernels import ops
from repro_torch.kernels.sample_estimate import SAMPLE_QUERY_PAD_KEY


def _flat_scatter(vecs: Sequence[SparseVec], active: np.ndarray,
                  nnz: np.ndarray):
    """(rows, cols, concatenated indices, concatenated values, counts) of
    the active vectors: the shared fill of both padding layouts."""
    counts = nnz[active]
    idx_cat = np.concatenate([v.indices for v, a in zip(vecs, active) if a])
    val_cat = np.concatenate([v.values for v, a in zip(vecs, active) if a])
    rows = np.repeat(np.nonzero(active)[0], counts)
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    cols = np.arange(idx_cat.size) - np.repeat(starts, counts)
    return rows, cols, idx_cat, val_cat, counts


def _keys_i32(idx_cat: np.ndarray) -> np.ndarray:
    """Fold int64 indices into the kernels' uint32 key domain (as int32)."""
    return (idx_cat & np.int64(0xFFFFFFFF)).astype(np.uint32).astype(np.int32)


def pad_sparse_batch(vecs: Sequence[SparseVec], *, bucket: int = 256
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pad sparse vectors into the ICWS kernel's ``[B, N]`` layout.

    Returns host arrays ``(w, keys, vals, norms)``: f32 normalized squared
    weights (0 marks a pad lane), int32 keys (mod 2^32), f32 normalized
    signed values, and f64 norms.  ``N`` is the max nnz rounded up to a
    multiple of ``bucket``.  Norms are per-vector ``SparseVec.norm()``
    calls, so the normalized values equal the JAX package's bit for bit.
    """
    B = len(vecs)
    nnz = np.fromiter((v.nnz for v in vecs), np.int64, count=B)
    max_nnz = int(nnz.max()) if B else 0
    N = max(bucket, -(-max_nnz // bucket) * bucket)
    w = np.zeros((B, N), np.float32)
    keys = np.zeros((B, N), np.int32)
    vals = np.zeros((B, N), np.float32)
    norms = np.array([v.norm() for v in vecs], np.float64)
    active = (nnz > 0) & (norms > 0.0) if B else np.zeros(0, bool)
    if np.any(active):
        rows, cols, idx_cat, val_cat, counts = _flat_scatter(vecs, active, nnz)
        z32 = (val_cat / np.repeat(norms[active], counts)).astype(np.float32)
        w[rows, cols] = z32 * z32
        keys[rows, cols] = _keys_i32(idx_cat)
        vals[rows, cols] = z32
    return w, keys, vals, norms


def pad_linear_batch(vecs: Sequence[SparseVec], *, bucket: int = 256
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Pad sparse vectors into the linear kernels' ``[B, N]`` layout.

    Returns host arrays ``(keys, vals)``: int32 keys (mod 2^32) and f32 RAW
    signed values (linear sketches apply to the un-normalized vector; there
    is no norm side channel).  Pad lanes hold value 0, which adds nothing
    to any linear sketch.
    """
    B = len(vecs)
    nnz = np.fromiter((v.nnz for v in vecs), np.int64, count=B)
    max_nnz = int(nnz.max()) if B else 0
    N = max(bucket, -(-max_nnz // bucket) * bucket)
    keys = np.zeros((B, N), np.int32)
    vals = np.zeros((B, N), np.float32)
    active = nnz > 0 if B else np.zeros(0, bool)
    if np.any(active):
        rows, cols, idx_cat, val_cat, _ = _flat_scatter(vecs, active, nnz)
        keys[rows, cols] = _keys_i32(idx_cat)
        vals[rows, cols] = val_cat.astype(np.float32)
    return keys, vals


def pad_sample_batch(vecs: Sequence[SparseVec], *, slots: int,
                     method: str = "ts", seed: int = 0
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Build fixed-slot sampling rows for a batch of sparse vectors.

    Returns host arrays ``(keys [B, slots] i32, vals [B, slots] f32, tau
    [B] f32)``: live (key, value) pairs ascending-key in the leading slots,
    empty slots filled with the query-pad sentinel (-1) and value 0, and
    ``tau`` the row's probability scale.  ``method`` picks threshold
    (``"ts"``) or priority (``"ps"``) sampling.  The sampling is the
    sketch, per-vector host work (hash, select, sort); the rows satisfy
    the key-match kernel's sorted-prefix contract by construction.
    """
    if method == "ts":
        def select(v):
            return threshold_sample(v.indices, v.values, slots=slots,
                                    seed=seed)
    elif method == "ps":
        def select(v):
            return priority_sample(v.indices, v.values, slots=slots,
                                   seed=seed)
    else:
        raise ValueError(f"unknown sampling method {method!r}; "
                         "choose 'ts' or 'ps'")
    B = len(vecs)
    keys = np.full((B, slots), SAMPLE_QUERY_PAD_KEY, np.int32)
    vals = np.zeros((B, slots), np.float32)
    taus = np.zeros(B, np.float32)
    for b, v in enumerate(vecs):
        k, vv, tau = select(v)
        keys[b, :k.size] = k.astype(np.int32)
        vals[b, :k.size] = vv.astype(np.float32)
        taus[b] = tau
    return keys, vals, taus


def sketch_batch(vecs: Sequence[SparseVec], *, m: int, seed: int = 0,
                 bucket: int = 256, device="cuda"):
    """Sketch a batch of sparse vectors with one ICWS launch on ``device``.

    Returns ``(fp [B, m] int32, val [B, m] f32, norm [B] f32, argkey [B, m]
    int32)`` on that device -- the four ICWS family components.
    """
    w, keys, vals, norms = pad_sparse_batch(vecs, bucket=bucket)
    dev = torch.device(device)
    fp, val, _, argkey = ops.icws_sketch(
        torch.from_numpy(w).to(dev), torch.from_numpy(keys).to(dev),
        torch.from_numpy(vals).to(dev), m=m, seed=seed)
    return fp, val, torch.from_numpy(norms.astype(np.float32)).to(dev), argkey


def linear_sketch_batch(vecs: Sequence[SparseVec], *, method: str,
                        width: int, reps: int = 1, seed: int = 0,
                        bucket: int = 256, device="cuda") -> torch.Tensor:
    """Sketch a batch of sparse vectors with one linear-sketch launch on
    ``device``: CountSketch (``method="cs"``, ``[B, reps, width]``) or JL
    (``method="jl"``, ``m = width``, ``[B, 1, width]``).  Returns the
    tables, the linear families' one component."""
    keys, vals = pad_linear_batch(vecs, bucket=bucket)
    dev = torch.device(device)
    keys, vals = torch.from_numpy(keys).to(dev), torch.from_numpy(vals).to(dev)
    if method == "cs":
        return ops.countsketch_sparse(keys, vals, width=width, reps=reps,
                                      seed=seed)
    if method == "jl":
        if reps != 1:
            raise ValueError(f"a JL table has one rep; got reps={reps}")
        return ops.jl_sketch(keys, vals, m=width, seed=seed)[:, None, :]
    raise ValueError(f"unknown linear sketch {method!r}; choose 'cs' or 'jl'")


def dmh_sketch_batch(vecs: Sequence[SparseVec], *, m: int, seed: int = 0,
                     bucket: int = 256, device="cuda"):
    """Sketch a batch of sparse vectors with one DMH launch on ``device``.

    The ICWS padding (:func:`pad_sparse_batch`), then ``ops.dmh_sketch``
    with ``replicas = dmh_replication(m)``: each key's c pseudo-keys are
    derived where the sketch runs, so only the unreplicated rows reach the
    device.  Returns the four ICWS family components ``(fp, val, norm,
    argkey)``.
    """
    w, keys, vals, norms = pad_sparse_batch(vecs, bucket=bucket)
    dev = torch.device(device)
    fp, val, _, argkey = ops.dmh_sketch(
        torch.from_numpy(w).to(dev), torch.from_numpy(keys).to(dev),
        torch.from_numpy(vals).to(dev), m=m, seed=seed,
        replicas=dmh_replication(m))
    return fp, val, torch.from_numpy(norms.astype(np.float32)).to(dev), argkey


def sample_sketch_batch(vecs: Sequence[SparseVec], *, slots: int,
                        method: str, seed: int = 0, device="cuda"):
    """Host-build B sampling rows (:func:`pad_sample_batch`) and move them
    to ``device``: ``(keys [B, slots] i32, vals [B, slots] f32, taus [B]
    f32)``, the sampling families' three components.  No kernel runs."""
    dev = torch.device(device)
    return tuple(torch.from_numpy(a).to(dev) for a in pad_sample_batch(
        vecs, slots=slots, method=method, seed=seed))
