"""Batched DMH (densified one-permutation weighted MinHash) sketch: CUDA
kernel and plain twin.

Replaces the TPU kernel ``repro/kernels/dmh_sketch.py::_dmh_kernel`` and
its ``_densify`` epilogue (launcher ``dmh_sketch_pallas`` at
``pack_vals=False``) and, as ``dmh_sketch_packed_*``,
``_dmh_kernel_packed`` (``pack_vals=True``: the bf16-halfword plane of the
densified values as a fifth output).  Contract, with c replicas a key::

    [B, n] (w f32, keys i32, vals f32) -> (fp i32, val f32, amin f32, argkey i32) [B, m]

the ICWS wire layout.  A row has ``N = c * n`` lanes, replica-major: lane
``l = r * n + i`` reads ``w[i]`` and ``vals[i]`` and takes the pseudo-key
``keys[i] ^ r * REPLICA_SALT`` (u32 wrap), so ``replicas=c`` on the
unreplicated rows gives, bit for bit, what ``replicas=1`` gives on rows
replicated on the host (``core.dmh.replicate_keys``, ``w`` and ``vals``
tiled: the JAX package's form).  Per lane: one bin ``hash(key,
salt(DMH_STREAM_BIN, 0)) % m``, then the ICWS variates drawn at ``t = bin``
(streams 52-56) give ``a`` (``BIG`` on pad lanes, ``w == 0``).  Each bin
keeps the minimum ``a``, ties to the LOWEST lane index (the Pallas
kernel's strict-``<`` tile merge plus ``argmin``, and
``dmh_sketch_scatter``'s two scatter-mins); its 31-bit fingerprint hashes
(key, level) with the bin's stream-57 salt.  Densification: each empty bin
t of a non-empty row borrows every plane from ``hash(t,
salt(DMH_STREAM_DENSIFY, j)) % m`` for the first ``j < densify_probes(m)``
that lands on an occupied bin, else from the first occupied bin.  Empty
rows give ``fp = -1, val = 0, argkey = 0`` and ``amin = BIG``.

The CUDA kernel (``csrc/dmh_sketch.cu``) gives each row a thread-block
cluster of ``_launch_shape`` blocks that split its lanes: each lane's
first-min is one 64-bit ``atomicMin`` on ``(float bits of a) << 32 |
lane`` in its block's shared memory (``a > 0``, so its bits order as
unsigned integers), which is independent of the order in which lanes
arrive -- bitwise deterministic.  Each block then owns a range of bins:
it takes the minimum of the cluster's partial minima, resolves the
winners, and runs the densify probes against the row's occupancy,
gathered across the cluster.  Bound: latency, not bytes or operations --
O(c * n + m) work per row against B1's O(n * m).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..core.dmh import REPLICA_SALT
from . import build
from .common import (BIG, DMH_DRAWS, DMH_STREAM_BIN, DMH_STREAM_FP, as_u32,
                     densify_probes, densify_sources, hash_u32, icws_rank,
                     level_fingerprint, mul32, salt_for)
from .packed import pack_sketch_vals

# bins one block may hold: 24 bytes of shared memory per bin, of the
# 227 KB a block can use
MAX_BINS = 9_000
# the card's SMs: a row's cluster grows until the launch's blocks cover them
_SMS = 132
# the largest cluster the launch rule picks: 16, past the portable 8 (the
# launcher takes it only where the card holds such clusters, else 8); at B
# = 3 it measured faster than 8 at every smoke shape
# (``tools/time_icws_sketch.py --dmh``, PERF.md)
MAX_CLUSTER = 16


def _check_inputs(w, keys, vals, m: int, replicas: int):
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
    if replicas < 1:
        raise ValueError(f"replicas must be >= 1; got {replicas}")


def _replicate(w, keys, vals, c: int):
    """The ``[B, c * n]`` rows of c replicas, replica-major: keys XOR
    ``r * REPLICA_SALT`` (u32 wrap), ``w`` and ``vals`` tiled."""
    if c == 1:
        return w, keys, vals
    B, n = keys.shape
    salts = mul32(torch.arange(c, dtype=torch.int64, device=keys.device),
                  REPLICA_SALT)
    k = (as_u32(keys)[:, None, :] ^ salts[None, :, None]).reshape(B, c * n)
    k = torch.where(k >= 2 ** 31, k - 2 ** 32, k).to(torch.int32)
    return w.repeat(1, c), k, vals.repeat(1, c)


def dmh_sketch_plain(w: torch.Tensor, keys: torch.Tensor, vals: torch.Tensor,
                     *, m: int, seed: int, replicas: int = 1
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """Eager-PyTorch DMH sketch in the scatter-min form of
    ``dmh_sketch_scatter``: the replicas expanded first, then one
    ``scatter_reduce(amin)`` for the minimum ``a`` per bin, a second for
    the lowest lane attaining it, then the densify probes as a ``[B, m,
    J]`` occupancy gather."""
    _check_inputs(w, keys, vals, m, replicas)
    w, keys, vals = _replicate(w, keys, vals, replicas)
    B, N = w.shape
    dev = w.device
    kk = as_u32(keys)                                      # [B, N]
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    bins = hash_u32(kk, salt_for(seed, DMH_STREAM_BIN, zero)) % m
    a, lvl = icws_rank(kk, w, seed, DMH_DRAWS, bins)
    a = torch.where(w > 0, a, BIG)

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
    fp = level_fingerprint(key_sel, lvl_sel, seed, DMH_STREAM_FP, t)

    # densification: the first probe j landing on an occupied bin, else
    # the first occupied bin
    need, src = densify_sources(amin < BIG, seed, m)

    def borrow(x):
        return torch.where(need, torch.gather(x, 1, src), x)

    fp, val_sel, key_sel, amin = (borrow(fp), borrow(val_sel),
                                  borrow(key_sel), borrow(amin))
    empty = amin >= BIG
    return (torch.where(empty, -1, fp), torch.where(empty, 0.0, val_sel),
            amin, torch.where(empty, 0, key_sel))


def _launch_shape(B: int, m: int, lanes: int):
    """(blocks a row's cluster, threads a block) of a launch of B rows of
    ``lanes`` lanes each: the cluster doubles, up to ``MAX_CLUSTER`` and
    while a block keeps at least two bins, until B clusters cover half the
    SMs (at B = 48, clusters of 2 measured faster than of 4 or 1: past
    that, more blocks cost more in cluster traffic than they gain); a block
    takes one thread a lane of its share, up to 1,024, in whole warps and
    at least two."""
    cluster = 1
    while (cluster < MAX_CLUSTER and 2 * B * cluster < _SMS
           and m >= 4 * cluster):
        cluster *= 2
    share = -(-lanes // cluster)
    return cluster, min(1024, max(64, 32 * -(-share // 32)))


def _launch(w, keys, vals, m: int, seed: int, pack: bool, replicas: int):
    """One launch of ``csrc/dmh_sketch.cu``; with ``pack`` its Pack variant
    and a fifth output."""
    _check_inputs(w, keys, vals, m, replicas)
    if w.device.type != "cuda":
        raise ValueError(f"the CUDA DMH sketch takes CUDA tensors; got "
                         f"{w.device}")
    if m > MAX_BINS:
        raise ValueError(f"dmh_sketch_cuda holds at most {MAX_BINS} bins in "
                         f"shared memory; got m={m}")
    w, keys, vals = w.contiguous(), keys.contiguous(), vals.contiguous()
    B, n = w.shape
    out = (torch.empty((B, m), dtype=torch.int32, device=w.device),
           torch.empty((B, m), dtype=torch.float32, device=w.device),
           torch.empty((B, m), dtype=torch.float32, device=w.device),
           torch.empty((B, m), dtype=torch.int32, device=w.device))
    if pack:
        out += (torch.empty((B, (m + 1) // 2), dtype=torch.int32,
                            device=w.device),)
    if B == 0:
        return out
    cluster, threads = _launch_shape(B, m, n * replicas)
    lib = build.library()
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = lib.repro_dmh_sketch(
            w.data_ptr(), keys.data_ptr(), vals.data_ptr(), B, n, replicas, m,
            seed & 0xFFFFFFFF, densify_probes(m), cluster, threads,
            *(o.data_ptr() for o in out[:4]),
            out[4].data_ptr() if pack else None, stream)
    build.check(err, "dmh_sketch")
    return out


def dmh_sketch_cuda(w: torch.Tensor, keys: torch.Tensor, vals: torch.Tensor,
                    *, m: int, seed: int, replicas: int = 1
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """Launch the CUDA DMH sketch on PyTorch's current stream.

    Takes CUDA tensors only and raises on anything else; the replicas'
    keys, densification and the empty-row fixup happen inside the kernel.
    Adds one to ``dmh_sketch_cuda.launches`` per launch.
    """
    out = _launch(w, keys, vals, m, seed, False, replicas)
    dmh_sketch_cuda.launches += 1
    return out


def dmh_sketch_packed_plain(w, keys, vals, *, m: int, seed: int,
                            replicas: int = 1):
    """The plain DMH sketch, then its ``pack_vals`` plane: five outputs."""
    out = dmh_sketch_plain(w, keys, vals, m=m, seed=seed, replicas=replicas)
    return out + (pack_sketch_vals(out[1], out[2]),)


def dmh_sketch_packed_cuda(w, keys, vals, *, m: int, seed: int,
                           replicas: int = 1):
    """Launch the CUDA DMH sketch with its pack epilogue: the four outputs
    plus the packed value plane.  Adds one to
    ``dmh_sketch_packed_cuda.launches`` per launch."""
    out = _launch(w, keys, vals, m, seed, True, replicas)
    dmh_sketch_packed_cuda.launches += 1
    return out


dmh_sketch_cuda.launches = 0
dmh_sketch_packed_cuda.launches = 0
