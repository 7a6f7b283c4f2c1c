"""Batched DMH (densified one-permutation weighted MinHash) sketch: CUDA
kernel and plain twin.

Replaces the TPU kernel ``repro/kernels/dmh_sketch.py::_dmh_kernel`` and
its ``_densify`` epilogue (launcher ``dmh_sketch_pallas`` at
``pack_vals=False``) and, as ``dmh_sketch_packed_*``,
``_dmh_kernel_packed`` (``pack_vals=True``: the bf16-halfword plane of the
densified values as a fifth output).  Contract::

    [B, N] (w f32, keys i32, vals f32) -> (fp i32, val f32, amin f32, argkey i32) [B, m]

the ICWS wire layout.  ``N`` counts lanes after pseudo-key replication
(``data/ingest.dmh_sketch_batch`` expands replica-major), so the lane
index is ``r * n + i``.  Per lane: one bin ``hash(key, salt(DMH_STREAM_BIN,
0)) % m``, then the ICWS variates drawn at ``t = bin`` (streams 52-56) give
``a`` (``BIG`` on pad lanes, ``w == 0``).  Each bin keeps the minimum
``a``, ties to the LOWEST lane index (the Pallas kernel's strict-``<`` tile
merge plus ``argmin``, and ``dmh_sketch_scatter``'s two scatter-mins); its
31-bit fingerprint hashes (key, level) with the bin's stream-57 salt.
Densification: each empty bin t of a non-empty row borrows every plane
from ``hash(t, salt(DMH_STREAM_DENSIFY, j)) % m`` for the first ``j <
densify_probes(m)`` that lands on an occupied bin, else from the first
occupied bin.  Empty rows give ``fp = -1, val = 0, argkey = 0`` and
``amin = BIG``.

The CUDA kernel (``csrc/dmh_sketch.cu``) gives each row one block, with
the m-bin state in shared memory: each lane's first-min is one 64-bit
``atomicMin`` on ``(float bits of a) << 32 | lane`` (``a > 0``, so its bits
order as unsigned integers), which is independent of the order in which
lanes arrive -- bitwise deterministic.  A thread per bin then gathers its
winner and runs the densify probes.  Bound: latency, not bytes or
operations -- O(c * nnz + m) work per row against B1's O(nnz * m).
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import build
from .common import (BIG, DMH_STREAM_BETA, DMH_STREAM_BIN, DMH_STREAM_C1,
                     DMH_STREAM_C2, DMH_STREAM_DENSIFY, DMH_STREAM_FP,
                     DMH_STREAM_R1, DMH_STREAM_R2, as_u32, densify_probes,
                     hash_u32, mul32, salt_for, uniform01)
from .packed import pack_sketch_vals

# bins one block may hold: 24 bytes of shared memory per bin, of the
# 227 KB a block can use
MAX_BINS = 9_000


def _check_inputs(w, keys, vals, m: int):
    if w.dim() != 2 or keys.shape != w.shape or vals.shape != w.shape:
        raise ValueError(f"w/keys/vals must share one [B, N] shape; got "
                         f"{tuple(w.shape)}, {tuple(keys.shape)}, "
                         f"{tuple(vals.shape)}")
    if (w.dtype, keys.dtype, vals.dtype) != (torch.float32, torch.int32,
                                             torch.float32):
        raise TypeError("dmh sketch takes w f32, keys i32, vals f32; got "
                        f"{w.dtype}, {keys.dtype}, {vals.dtype}")
    if not (w.device == keys.device == vals.device):
        raise ValueError("w/keys/vals must lie on one device")
    if m < 1 or w.shape[1] < 1:
        raise ValueError(f"m and N must be >= 1; got m={m}, "
                         f"N={w.shape[1]}")


def dmh_sketch_plain(w: torch.Tensor, keys: torch.Tensor, vals: torch.Tensor,
                     *, m: int, seed: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """Eager-PyTorch DMH sketch in the scatter-min form of
    ``dmh_sketch_scatter``: one ``scatter_reduce(amin)`` for the minimum
    ``a`` per bin, a second for the lowest lane attaining it, then the
    densify probes as a ``[B, m, J]`` occupancy gather."""
    _check_inputs(w, keys, vals, m)
    B, N = w.shape
    dev = w.device
    kk = as_u32(keys)                                      # [B, N]
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    bins = hash_u32(kk, salt_for(seed, DMH_STREAM_BIN, zero)) % m

    def u(stream):
        return uniform01(kk, salt_for(seed, stream, bins))

    r = -torch.log(u(DMH_STREAM_R1) * u(DMH_STREAM_R2))
    c = -torch.log(u(DMH_STREAM_C1) * u(DMH_STREAM_C2))
    beta = u(DMH_STREAM_BETA)
    logw = torch.log(torch.clamp_min(w, 1e-37))
    lvl = torch.floor(logw / r + beta)
    y = torch.exp(r * (lvl - beta))
    a = torch.where(w > 0, c / (y * torch.exp(r)), BIG)

    # per-bin first-min: the minimum, then the lowest lane attaining it
    seg = (torch.arange(B, device=dev)[:, None] * m + bins).reshape(-1)
    amin = torch.full((B * m,), BIG, dtype=torch.float32, device=dev)
    amin = amin.scatter_reduce(0, seg, a.reshape(-1), "amin")
    hit = a.reshape(-1) == amin[seg]
    lane = torch.arange(N, device=dev).expand(B, N).reshape(-1)
    arg = torch.full((B * m,), N, dtype=torch.int64, device=dev)
    arg = arg.scatter_reduce(0, seg, torch.where(hit, lane, N), "amin")
    arg = arg.clamp_max(N - 1).reshape(B, m)   # bins no lane maps to: inert
    amin = amin.reshape(B, m)

    key_sel = torch.gather(keys, 1, arg)
    val_sel = torch.gather(vals, 1, arg)
    lvl_sel = torch.gather(lvl, 1, arg)
    t = torch.arange(m, dtype=torch.int64, device=dev)
    fpbits = hash_u32(as_u32(key_sel)
                      ^ mul32(as_u32(lvl_sel.to(torch.int32)), 0x9E3779B9),
                      salt_for(seed, DMH_STREAM_FP, t)[None, :])
    fp = (fpbits & 0x7FFFFFFF).to(torch.int32)

    # densification: the first probe j landing on an occupied bin, else
    # the first occupied bin
    occ = amin < BIG                                       # [B, m]
    J = densify_probes(m)
    j = torch.arange(J, dtype=torch.int32, device=dev)
    probe = hash_u32(t[:, None], salt_for(seed, DMH_STREAM_DENSIFY, j)[None, :]) % m
    firstj = torch.where(occ[:, probe], j, J).amin(2)      # [B, m]
    has = firstj < J
    src_w = hash_u32(t[None, :], salt_for(
        seed, DMH_STREAM_DENSIFY, firstj.clamp_max(J - 1))) % m
    first_occ = torch.where(occ, t, m).amin(1, keepdim=True).clamp_max(m - 1)
    src = torch.where(has, src_w, first_occ)
    need = ~occ & occ.any(1, keepdim=True)

    def borrow(x):
        return torch.where(need, torch.gather(x, 1, src), x)

    fp, val_sel, key_sel, amin = (borrow(fp), borrow(val_sel),
                                  borrow(key_sel), borrow(amin))
    empty = amin >= BIG
    return (torch.where(empty, -1, fp), torch.where(empty, 0.0, val_sel),
            amin, torch.where(empty, 0, key_sel))


def _launch(w, keys, vals, m: int, seed: int, pack: bool):
    """One launch of ``csrc/dmh_sketch.cu``; with ``pack`` its Pack variant
    and a fifth output."""
    _check_inputs(w, keys, vals, m)
    if w.device.type != "cuda":
        raise ValueError(f"the CUDA DMH sketch takes CUDA tensors; got "
                         f"{w.device}")
    if m > MAX_BINS:
        raise ValueError(f"dmh_sketch_cuda holds at most {MAX_BINS} bins in "
                         f"shared memory; got m={m}")
    w, keys, vals = w.contiguous(), keys.contiguous(), vals.contiguous()
    B, N = w.shape
    out = (torch.empty((B, m), dtype=torch.int32, device=w.device),
           torch.empty((B, m), dtype=torch.float32, device=w.device),
           torch.empty((B, m), dtype=torch.float32, device=w.device),
           torch.empty((B, m), dtype=torch.int32, device=w.device))
    if pack:
        out += (torch.empty((B, (m + 1) // 2), dtype=torch.int32,
                            device=w.device),)
    if B == 0:
        return out
    lib = build.library()
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = lib.repro_dmh_sketch(
            w.data_ptr(), keys.data_ptr(), vals.data_ptr(), B, N, m,
            seed & 0xFFFFFFFF, densify_probes(m),
            *(o.data_ptr() for o in out[:4]),
            out[4].data_ptr() if pack else None, stream)
    build.check(err, "dmh_sketch")
    return out


def dmh_sketch_cuda(w: torch.Tensor, keys: torch.Tensor, vals: torch.Tensor,
                    *, m: int, seed: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """Launch the CUDA DMH sketch on PyTorch's current stream.

    Takes CUDA tensors only and raises on anything else; densification and
    the empty-row fixup happen inside the kernel.  Adds one to
    ``dmh_sketch_cuda.launches`` per launch.
    """
    out = _launch(w, keys, vals, m, seed, pack=False)
    dmh_sketch_cuda.launches += 1
    return out


def dmh_sketch_packed_plain(w, keys, vals, *, m: int, seed: int):
    """The plain DMH sketch, then its ``pack_vals`` plane: five outputs."""
    out = dmh_sketch_plain(w, keys, vals, m=m, seed=seed)
    return out + (pack_sketch_vals(out[1], out[2]),)


def dmh_sketch_packed_cuda(w, keys, vals, *, m: int, seed: int):
    """Launch the CUDA DMH sketch with its pack epilogue: the four outputs
    plus the packed value plane.  Adds one to
    ``dmh_sketch_packed_cuda.launches`` per launch."""
    out = _launch(w, keys, vals, m, seed, pack=True)
    dmh_sketch_packed_cuda.launches += 1
    return out


dmh_sketch_cuda.launches = 0
dmh_sketch_packed_cuda.launches = 0
