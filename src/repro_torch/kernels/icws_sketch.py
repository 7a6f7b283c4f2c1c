"""Batched ICWS (weighted MinHash) sketch: CUDA kernel and plain twin.

Replaces the TPU kernel ``repro/kernels/icws_sketch.py::_icws_kernel``
(launcher ``icws_sketch_pallas`` at ``pack_vals=False``) and, as
``icws_sketch_packed_*``, ``_icws_kernel_packed`` (``pack_vals=True``),
which appends the bf16-halfword plane ``[B, (m + m % 2) // 2]`` i32 of the
value output (:func:`~repro_torch.kernels.packed.pack_sketch_vals`).
Contract::

    [B, N] (w f32, keys i32, vals f32) -> (fp i32, val f32, amin f32, argkey i32) [B, m]

For every (row b, sample t, non-zero i) five hashed uniforms (salted by t)
give r, c ~ Gamma(2, 1) and beta; ``lvl = floor(log(max(w, 1e-37)) / r +
beta)`` and ``a = c / (exp(r (lvl - beta)) exp(r))``, with pad lanes
(``w == 0``) masked to ``BIG``.  Sample t keeps the FIRST index of the
minimal ``a`` (the Pallas kernel's ``jnp.argmin`` plus strict-``<`` tile
merge); its 31-bit fingerprint hashes (key, level).  Empty rows give
``fp = -1, val = 0, argkey = 0``.

The CUDA kernel (``csrc/icws_sketch.cu``) is bound by transcendentals and
integer mixing, not by bytes: per (row, t, non-zero) it does about ten
murmur rounds, two ``logf``, two ``expf`` and two IEEE divides; the third
``logf``, of the weight, runs once per (row, non-zero) as a block stages its
row's non-zeros in shared memory.  A block serves one row; a group of
``S`` threads (a power of two up to 256, a whole block) owns a (row, t)
pair and strides over the non-zeros; the group then merges (a, index)
lexicographically (within each warp by shuffles, then across its warps
through shared memory), which is the first-index argmin whatever ``S`` is,
so results do not depend on the launch shape.  ``S`` grows when ``B * m``
is too small to fill the card (single-table ingest sketches only three
rows).
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import build
from .common import (BIG, ICWS_DRAWS, ICWS_STREAM_FP, as_u32, icws_rank,
                     level_fingerprint)
from .packed import pack_sketch_vals

# elements of one [rows, m, N] intermediate the plain version holds at a time
_PLAIN_CHUNK = 1 << 22
# threads the CUDA launch aims for: 132 SMs x 1,536 resident threads each
# (six blocks of 256 at the kernel's 40 registers a thread)
_TARGET_THREADS = 132 * 1536
# the kernel takes the row length and a non-zero's index as 32-bit ints
_MAX_N = 2 ** 31 - 1


def _check_inputs(w, keys, vals, m: int):
    if w.dim() != 2 or keys.shape != w.shape or vals.shape != w.shape:
        raise ValueError(f"w/keys/vals must share one [B, N] shape; got "
                         f"{tuple(w.shape)}, {tuple(keys.shape)}, "
                         f"{tuple(vals.shape)}")
    if (w.dtype, keys.dtype, vals.dtype) != (torch.float32, torch.int32,
                                             torch.float32):
        raise TypeError("icws sketch takes w f32, keys i32, vals f32; got "
                        f"{w.dtype}, {keys.dtype}, {vals.dtype}")
    if not (w.device == keys.device == vals.device):
        raise ValueError("w/keys/vals must lie on one device")
    if m < 1:
        raise ValueError(f"m must be >= 1; got {m}")


def icws_sketch_plain(w: torch.Tensor, keys: torch.Tensor, vals: torch.Tensor,
                      *, m: int, seed: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """Eager-PyTorch ICWS sketch, the kernel's arithmetic op for op.

    Works a few rows at a time so that no ``[B, m, N]`` tensor is held
    whole; each row's result is independent of the others.
    """
    _check_inputs(w, keys, vals, m)
    B, N = w.shape
    dev = w.device
    t = torch.arange(m, dtype=torch.int64, device=dev)
    fp = torch.empty((B, m), dtype=torch.int32, device=dev)
    val = torch.empty((B, m), dtype=torch.float32, device=dev)
    amin = torch.empty((B, m), dtype=torch.float32, device=dev)
    argkey = torch.empty((B, m), dtype=torch.int32, device=dev)
    rows = max(1, _PLAIN_CHUNK // max(1, m * N))
    for lo in range(0, B, rows):
        hi = min(B, lo + rows)
        wc, kc, vc = w[lo:hi], keys[lo:hi], vals[lo:hi]
        a, lvl = icws_rank(as_u32(kc)[:, None, :], wc[:, None, :], seed,
                           ICWS_DRAWS, t[None, :, None])   # [b, m, N]
        a = torch.where((wc > 0)[:, None, :], a, BIG)
        # torch.argmin returns the first index of the minimum
        arg = torch.argmin(a, dim=2)                       # [b, m]
        am = torch.gather(a, 2, arg[:, :, None])[:, :, 0]
        key_sel = torch.gather(kc, 1, arg)
        val_sel = torch.gather(vc, 1, arg)
        lvl_sel = torch.gather(lvl, 2, arg[:, :, None])[:, :, 0]
        empty = am >= BIG
        fp[lo:hi] = torch.where(empty, -1, level_fingerprint(
            key_sel, lvl_sel, seed, ICWS_STREAM_FP, t)).to(torch.int32)
        val[lo:hi] = torch.where(empty, 0.0, val_sel)
        amin[lo:hi] = am
        argkey[lo:hi] = torch.where(empty, 0, key_sel)
    return fp, val, amin, argkey


def _group_size(B: int, m: int, N: int) -> int:
    """Threads per (row, t) pair: a power of two that brings the launch
    near ``_TARGET_THREADS`` without exceeding the non-zero count, and at
    most half a block, so that each staged ``logw`` serves at least two
    samples (the kernel takes up to 256, a whole block, where every draw
    pays for its staged ``logf`` again)."""
    s = 1
    while s < 128 and B * m * s < _TARGET_THREADS and 2 * s <= max(N, 1):
        s *= 2
    return s


def _launch(w, keys, vals, m: int, seed: int, pack: bool):
    """One launch of ``csrc/icws_sketch.cu``; with ``pack`` its Pack
    variant, whose fifth output the kernel ORs halfwords into (zeroed
    here)."""
    _check_inputs(w, keys, vals, m)
    if w.shape[1] > _MAX_N:
        raise ValueError(f"rows of {w.shape[1]} non-zeros; the CUDA ICWS "
                         f"sketch takes at most {_MAX_N} a row")
    if w.device.type != "cuda":
        raise ValueError(f"the CUDA ICWS sketch takes CUDA tensors; got "
                         f"{w.device}")
    w, keys, vals = w.contiguous(), keys.contiguous(), vals.contiguous()
    B, N = w.shape
    out = (torch.empty((B, m), dtype=torch.int32, device=w.device),
           torch.empty((B, m), dtype=torch.float32, device=w.device),
           torch.empty((B, m), dtype=torch.float32, device=w.device),
           torch.empty((B, m), dtype=torch.int32, device=w.device))
    if pack:
        out += (torch.zeros((B, (m + 1) // 2), dtype=torch.int32,
                            device=w.device),)
    if B == 0:
        return out
    lib = build.library()
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = lib.repro_icws_sketch(
            w.data_ptr(), keys.data_ptr(), vals.data_ptr(), B, N, m,
            seed & 0xFFFFFFFF, _group_size(B, m, N),
            *(o.data_ptr() for o in out[:4]),
            out[4].data_ptr() if pack else None, stream)
    build.check(err, "icws_sketch")
    return out


def icws_sketch_cuda(w: torch.Tensor, keys: torch.Tensor, vals: torch.Tensor,
                     *, m: int, seed: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """Launch the CUDA ICWS sketch on PyTorch's current stream.

    Takes CUDA tensors only and raises on anything else; the empty-row
    fixup happens inside the kernel.  Adds one to
    ``icws_sketch_cuda.launches`` per launch.
    """
    out = _launch(w, keys, vals, m, seed, pack=False)
    icws_sketch_cuda.launches += 1
    return out


def icws_sketch_packed_plain(w, keys, vals, *, m: int, seed: int):
    """The plain sketch, then its ``pack_vals`` plane: five outputs."""
    out = icws_sketch_plain(w, keys, vals, m=m, seed=seed)
    return out + (pack_sketch_vals(out[1], out[2]),)


def icws_sketch_packed_cuda(w, keys, vals, *, m: int, seed: int):
    """Launch the CUDA ICWS sketch with its pack epilogue: the four
    outputs plus the packed value plane.  Adds one to
    ``icws_sketch_packed_cuda.launches`` per launch."""
    out = _launch(w, keys, vals, m, seed, pack=True)
    icws_sketch_packed_cuda.launches += 1
    return out


icws_sketch_cuda.launches = 0
icws_sketch_packed_cuda.launches = 0
