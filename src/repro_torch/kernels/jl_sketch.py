"""JL (AMS) projection of a padded sparse batch: CUDA kernel and plain twin.

Replaces the TPU kernel ``repro/kernels/jl_sketch.py::_jl_kernel``
(launcher ``jl_sketch_pallas``).  Contract::

    keys [B, N] i32, vals [B, N] f32 -> proj [B, m] f32

with ``proj[b, t] = (sum_n sign(t, key_n) * val_n) / sqrt(m)``, the sign
``+1`` where ``hash_u32(key, salt_for(seed, JL_STREAM_SIGN, t))`` is even
and ``-1`` where it is odd, and the f32 ``sqrt(m)`` divided last (an IEEE
divide, as the JAX kernel does).  Zero-valued pad lanes add ``+-0``.

Port contract: each (b, t) sum runs over ``n = 0 .. N-1`` in order, one f32
add at a time, in both versions: a row projects to the same bits alone or
in a batch and at any padded N, and the kernel equals its plain version bit
for bit on the card.  The TPU kernel sums in the MXU's order, so the port
agrees with it to f32 tolerance.

The CUDA kernel (``csrc/jl_sketch.cu``) gives a block one row and a tile
of ``_t_tile(B, m)`` samples: eight warps hash the row's keys and store
each signed term in shared memory, and one lane per t adds them over
ascending n.
"""
from __future__ import annotations

import torch

from . import build
from .common import JL_STREAM_SIGN, as_u32, hash_u32, salt_for

# non-zeros per plain-version chunk: one [B, m, chunk] sign tensor at a time
_PLAIN_CHUNK = 256
# the card's SMs, and the blocks a launch should give each of them
_SMS, _BLOCKS_PER_SM = 132, 2


def _check_inputs(keys, vals, m: int):
    if keys.dim() != 2 or vals.shape != keys.shape:
        raise ValueError(f"keys/vals must share one [B, N] shape; got "
                         f"{tuple(keys.shape)}, {tuple(vals.shape)}")
    if (keys.dtype, vals.dtype) != (torch.int32, torch.float32):
        raise TypeError(f"jl sketch takes keys i32, vals f32; got "
                        f"{keys.dtype}, {vals.dtype}")
    if keys.device != vals.device:
        raise ValueError("keys/vals must lie on one device")
    if m < 1:
        raise ValueError(f"m must be >= 1; got {m}")


def jl_sketch_plain(keys: torch.Tensor, vals: torch.Tensor, *, m: int,
                    seed: int) -> torch.Tensor:
    """Eager-PyTorch JL projection in the kernel's order: the signs of a
    chunk of non-zeros at a time, then one ``[B, m]`` add per non-zero n,
    ascending."""
    _check_inputs(keys, vals, m)
    B, N = keys.shape
    dev = keys.device
    salt = salt_for(seed, JL_STREAM_SIGN,
                    torch.arange(m, dtype=torch.int64, device=dev))
    acc = torch.zeros((B, m), dtype=torch.float32, device=dev)
    for lo in range(0, N, _PLAIN_CHUNK):
        hi = min(N, lo + _PLAIN_CHUNK)
        hs = hash_u32(as_u32(keys[:, None, lo:hi]), salt[None, :, None])
        sign = torch.where((hs & 1) == 0, 1.0, -1.0).to(torch.float32)
        for n in range(hi - lo):                      # sign: [B, m, chunk]
            acc = acc + sign[:, :, n] * vals[:, lo + n, None]
    return acc / torch.sqrt(torch.tensor(float(m), dtype=torch.float32,
                                          device=dev))


def _t_tile(B: int, m: int) -> int:
    """Samples t a block, 8 or 16: 16 where that launch still gives every
    SM two blocks (more rows keep the chain warp's lanes busier), else 8,
    so that a few rows fill the card."""
    return 16 if B * -(-m // 16) >= _SMS * _BLOCKS_PER_SM else 8


def jl_sketch_cuda(keys: torch.Tensor, vals: torch.Tensor, *, m: int,
                   seed: int) -> torch.Tensor:
    """Launch the CUDA JL projection on PyTorch's current stream.

    Takes CUDA tensors only and raises on anything else.  Adds one to
    ``jl_sketch_cuda.launches`` per launch.
    """
    _check_inputs(keys, vals, m)
    if keys.device.type != "cuda":
        raise ValueError(f"jl_sketch_cuda takes CUDA tensors; got "
                         f"{keys.device}")
    keys, vals = keys.contiguous(), vals.contiguous()
    B, N = keys.shape
    out = torch.empty((B, m), dtype=torch.float32, device=keys.device)
    if B == 0:
        return out
    lib = build.library()
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        err = lib.repro_jl_sketch(keys.data_ptr(), vals.data_ptr(), B, N, m,
                                  _t_tile(B, m), seed & 0xFFFFFFFF,
                                  out.data_ptr(), stream)
    build.check(err, "jl_sketch")
    jl_sketch_cuda.launches += 1
    return out


jl_sketch_cuda.launches = 0
