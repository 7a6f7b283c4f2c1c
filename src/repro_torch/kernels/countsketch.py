"""CountSketch of a padded sparse batch: CUDA kernel and plain twin.

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
block: the block hashes a chunk of non-zeros into shared memory, then each
thread owns buckets and scans the chunk in ``n`` order.  No atomics.
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


def _bucket_sign(keys: torch.Tensor, *, width: int, reps: int, seed: int):
    """Per-(row, rep, non-zero) bucket (int64) and sign (f32 +-1), each
    ``[B, R, N]``."""
    k = as_u32(keys)[:, None, :]                               # [B, 1, N]
    r = torch.arange(reps, dtype=torch.int64, device=keys.device)
    bucket = hash_u32(k, salt_for(seed, CS_STREAM_BUCKET, r)[None, :, None]) \
        % width
    hs = hash_u32(k, salt_for(seed, CS_STREAM_SIGN, r)[None, :, None])
    sign = torch.where((hs & 1) == 0, 1.0, -1.0).to(torch.float32)
    return bucket, sign


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
