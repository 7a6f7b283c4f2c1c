"""CountSketch of a padded sparse batch and of a dense vector: CUDA
kernels and plain twins.

Replaces the TPU kernel ``repro/kernels/countsketch.py::_cs_sparse_kernel``
(launcher ``countsketch_sparse_pallas``).  Contract::

    keys [B, N] i32, vals [B, N] f32 -> tables [B, R, W] f32

with ``T[b, r, w] = sum_n [bucket_r(key_n) == w] * sign_r(key_n) * val_n``;
the bucket is ``hash_u32(key, salt_for(seed, CS_STREAM_BUCKET, r)) % W``,
the sign ``+1`` where ``hash_u32(key, salt_for(seed, CS_STREAM_SIGN, r))``
is even and ``-1`` where it is odd.  Zero-valued pad lanes add ``+-0`` and
change no bit.

Port contract: each (b, r, w) sum runs over ``n = 0 .. N-1`` in order, one
f32 add per matching non-zero, in both versions.  The order depends on
neither B nor the padded N (pads sit past the row's non-zeros and add
zeros), so a row sketches to the same bits alone or in a batch, and the
kernel and its plain version agree bit for bit on the card.  The TPU
kernel's one-hot matmul sums in the MXU's order instead, so the port agrees
with it to f32 tolerance.

The CUDA kernel (``csrc/countsketch_sparse.cu``) gives each (row, rep) one
block per 256 buckets, a thread a bucket: per chunk of non-zeros the block
groups the terms by bucket, stably in ``n`` (warp-level matches and integer
counts), and each thread adds its bucket's run in order.  No atomics.

The dense sketch (gradient compression) replaces
``repro/kernels/countsketch.py::_cs_kernel`` (launcher
``countsketch_pallas``)::

    x [T] f32, width, reps, seed, offset -> table [reps, width] f32

with element i hashed as the u32 ``(offset + i) mod 2^32`` on the same
streams, so a dense vector sketches as the sparse batch of its positions.
Its order: positions are cut into chunks of ``DENSE_CHUNK``; each (rep,
chunk, bucket) sums its elements in t order, and each (rep, bucket) sums
its chunk partials in chunk order.  Both versions take that order, so they
agree bit for bit on the card, and for ``T <= DENSE_CHUNK`` the dense
sketch at offset o equals the sparse sketch of keys ``o + arange(T)`` bit
for bit.  The CUDA version (``csrc/countsketch_dense.cu``) is two
kernels: one warp per (rep, chunk) keeps the chunk's table in shared
memory and adds each group of 32 elements in t order, in one
read-add-write where the group's buckets are distinct (a tag table finds
a shared bucket; its lanes then add by rank), hashing the next batch while
a group's reads land; then one thread per (rep, bucket) adds the partials.
"""
from __future__ import annotations

import torch

from . import build
from .common import (CS_STREAM_BUCKET, CS_STREAM_SIGN, as_u32, hash_u32,
                     salt_for)


def _check_inputs(keys, vals, width: int, reps: int):
    if keys.dim() != 2 or vals.shape != keys.shape:
        raise ValueError(f"keys/vals must share one [B, N] shape; got "
                         f"{tuple(keys.shape)}, {tuple(vals.shape)}")
    if (keys.dtype, vals.dtype) != (torch.int32, torch.float32):
        raise TypeError(f"countsketch takes keys i32, vals f32; got "
                        f"{keys.dtype}, {vals.dtype}")
    if keys.device != vals.device:
        raise ValueError("keys/vals must lie on one device")
    if width < 1 or reps < 1:
        raise ValueError(f"width and reps must be >= 1; got {width}, {reps}")


def _hash(k: torch.Tensor, r: torch.Tensor, *, width: int, seed: int):
    """Bucket (int64) and sign (f32 +-1) of u32 keys ``k`` in reps ``r``
    (broadcast against each other)."""
    bucket = hash_u32(k, salt_for(seed, CS_STREAM_BUCKET, r)) % width
    hs = hash_u32(k, salt_for(seed, CS_STREAM_SIGN, r))
    return bucket, torch.where((hs & 1) == 0, 1.0, -1.0).to(torch.float32)


def _bucket_sign(keys: torch.Tensor, *, width: int, reps: int, seed: int):
    """Per-(row, rep, non-zero) bucket (int64) and sign (f32 +-1), each
    ``[B, R, N]``."""
    r = torch.arange(reps, dtype=torch.int64, device=keys.device)
    return _hash(as_u32(keys)[:, None, :], r[None, :, None], width=width,
                 seed=seed)


def countsketch_sparse_plain(keys: torch.Tensor, vals: torch.Tensor, *,
                             width: int, reps: int, seed: int) -> torch.Tensor:
    """Eager-PyTorch CountSketch in the kernel's order: one ``scatter_add_``
    per non-zero n, ascending, each adding one term to every (row, rep)."""
    _check_inputs(keys, vals, width, reps)
    B, N = keys.shape
    bucket, sign = _bucket_sign(keys, width=width, reps=reps, seed=seed)
    contrib = sign * vals[:, None, :]                          # exact: +-val
    table = torch.zeros((B * reps, width), dtype=torch.float32,
                        device=keys.device)
    bucket = bucket.reshape(B * reps, N)
    contrib = contrib.reshape(B * reps, N)
    for n in range(N):
        table.scatter_add_(1, bucket[:, n:n + 1], contrib[:, n:n + 1])
    return table.reshape(B, reps, width)


def countsketch_sparse_cuda(keys: torch.Tensor, vals: torch.Tensor, *,
                            width: int, reps: int, seed: int) -> torch.Tensor:
    """Launch the CUDA CountSketch on PyTorch's current stream.

    Takes CUDA tensors only and raises on anything else.  Adds one to
    ``countsketch_sparse_cuda.launches`` per launch.
    """
    _check_inputs(keys, vals, width, reps)
    if keys.device.type != "cuda":
        raise ValueError(f"countsketch_sparse_cuda takes CUDA tensors; got "
                         f"{keys.device}")
    keys, vals = keys.contiguous(), vals.contiguous()
    B, N = keys.shape
    out = torch.empty((B, reps, width), dtype=torch.float32,
                      device=keys.device)
    if B == 0:
        return out
    lib = build.library()
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        err = lib.repro_countsketch_sparse(
            keys.data_ptr(), vals.data_ptr(), B, N, width, reps,
            seed & 0xFFFFFFFF, out.data_ptr(), stream)
    build.check(err, "countsketch_sparse")
    countsketch_sparse_cuda.launches += 1
    return out


countsketch_sparse_cuda.launches = 0


# -- dense vectors (gradient compression) ------------------------------------
# Elements summed into one partial table, in t order, before the partials
# are added in chunk order: a constant, so the order depends on T alone.
DENSE_CHUNK = 65_536


def _check_dense(x, width: int, reps: int):
    if x.dim() != 1 or x.dtype != torch.float32:
        raise TypeError(f"countsketch takes one [T] f32 vector; got "
                        f"{tuple(x.shape)} {x.dtype}")
    if width < 1 or reps < 1:
        raise ValueError(f"width and reps must be >= 1; got {width}, {reps}")


def countsketch_dense_plain(x: torch.Tensor, *, width: int, reps: int,
                            seed: int, offset: int = 0) -> torch.Tensor:
    """Eager-PyTorch dense CountSketch in the kernel's order.

    Element i hashes as the u32 ``offset + i``.  Each (rep, chunk, bucket)
    sum runs over the chunk's elements in t order from ``+0``; then each
    (rep, bucket) adds its chunk partials in chunk order from ``+0``.  The
    in-chunk order comes from a stable sort by (rep, chunk, bucket) and each
    term's rank in its group: one ``scatter_add_`` per rank, every call
    adding at most one term to each partial."""
    _check_dense(x, width, reps)
    chunk = DENSE_CHUNK
    T = x.shape[0]
    dev = x.device
    n_chunks = max(1, -(-T // chunk))
    pos = torch.arange(T, dtype=torch.int64, device=dev)
    r = torch.arange(reps, dtype=torch.int64, device=dev)[:, None]
    bucket, sign = _hash(as_u32(pos + offset)[None], r, width=width,
                         seed=seed)                            # [R, T]
    term = (sign * x).reshape(-1)                              # exact: +-x
    group = ((r * n_chunks + pos // chunk) * width + bucket).reshape(-1)
    order = torch.sort(group, stable=True).indices
    g = group[order]
    head = torch.ones_like(g, dtype=torch.bool)
    head[1:] = g[1:] != g[:-1]
    at = torch.arange(g.numel(), device=dev)
    rank = at - torch.cummax(torch.where(head, at, 0), 0).values
    partial = torch.zeros(reps * n_chunks * width, dtype=torch.float32,
                          device=dev)
    for k in range(int(rank.max().item()) + 1 if T else 0):
        sel = order[rank == k]
        partial.scatter_add_(0, group[sel], term[sel])
    partial = partial.view(reps, n_chunks, width)
    out = torch.zeros((reps, width), dtype=torch.float32, device=dev)
    for c in range(n_chunks):
        out += partial[:, c]
    return out


def countsketch_dense_cuda(x: torch.Tensor, *, width: int, reps: int,
                           seed: int, offset: int = 0) -> torch.Tensor:
    """Launch the dense CUDA CountSketch (two kernels: chunk partials, then
    their sum in chunk order) on PyTorch's current stream.

    Takes a CUDA tensor only and raises on anything else.  Adds one to
    ``countsketch_dense_cuda.launches`` per call."""
    _check_dense(x, width, reps)
    if x.device.type != "cuda":
        raise ValueError(f"countsketch_dense_cuda takes a CUDA tensor; got "
                         f"{x.device}")
    x = x.contiguous()
    T = x.shape[0]
    if T == 0:
        return torch.zeros((reps, width), dtype=torch.float32, device=x.device)
    n_chunks = -(-T // DENSE_CHUNK)
    out = torch.empty((reps, width), dtype=torch.float32, device=x.device)
    # the chunk partials; one chunk's partial is the table itself
    scratch = (torch.empty((reps, n_chunks, width), dtype=torch.float32,
                           device=x.device) if n_chunks > 1 else None)
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_countsketch_dense(
            x.data_ptr(), T, width, reps, seed & 0xFFFFFFFF,
            offset & 0xFFFFFFFF, DENSE_CHUNK,
            None if scratch is None else scratch.data_ptr(), out.data_ptr(),
            stream)
    build.check(err, "countsketch_dense")
    countsketch_dense_cuda.launches += 1
    return out


countsketch_dense_cuda.launches = 0
