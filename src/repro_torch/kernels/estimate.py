"""Fused multi-field ICWS estimate partials: CUDA kernel and plain twin.

Replaces the TPU kernel ``repro/kernels/estimate.py::_fields_kernel``
(launcher ``estimate_fields_pallas``).  Contract::

    fq/vq [F, Q, m], fc/vc [C, P, m], static qmap/cmap -> (cnt, sw) [G, Q, P] f32

with ``cnt = sum_t 1[fq == fc and fq >= 0]`` and ``sw = sum_t 1[...] * vq *
vc / min(vq^2, vc^2)`` (IEEE divide, the safe denominator of the JAX
``_mvm_body``), for each field pair ``g = (qmap[g], cmap[g])``.

Port contract: each (q, p) sum runs over ``t = 0 .. m-1`` in order, one
f32 add at a time, in both versions -- so the result does not depend on
Q, P or any tiling (batched and sequential queries agree bit for bit), and
the CUDA kernel and the plain version do the same IEEE operations in the
same order.  The field pair is read through ``qmap``/``cmap``; neither
version builds per-pair copies or a ``[Q, P, m]`` tensor.  The corpus
planes may be any strided view whose last dimension is contiguous (a
tenant's slice of the store's ``[3, cap, m]`` buffers is passed as is).

The CUDA kernel (``csrc/estimate_fields.cu``) is bound by the bytes of the
corpus planes it reads; see the source for its design.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import build

MAX_PAIRS = 16                 # kMaxPairs in csrc/estimate_fields.cu
# corpus rows per plain-version chunk: one [Q, rows] accumulator pair at a time
_PLAIN_ROWS = 1 << 16


def _check_inputs(fq, vq, fc, vc, qmap, cmap):
    qmap = tuple(int(i) for i in qmap)
    cmap = tuple(int(i) for i in cmap)
    if len(qmap) != len(cmap):
        raise ValueError("qmap/cmap length mismatch")
    if not qmap:
        raise ValueError("qmap/cmap must name at least one field pair")
    if fq.dim() != 3 or fc.dim() != 3 or vq.shape != fq.shape \
            or vc.shape != fc.shape or fq.shape[2] != fc.shape[2]:
        raise ValueError(f"expected fq/vq [F, Q, m] and fc/vc [C, P, m]; got "
                         f"{tuple(fq.shape)}, {tuple(vq.shape)}, "
                         f"{tuple(fc.shape)}, {tuple(vc.shape)}")
    if (fq.dtype, vq.dtype, fc.dtype, vc.dtype) != (
            torch.int32, torch.float32, torch.int32, torch.float32):
        raise TypeError("estimate takes int32 fingerprints and f32 values")
    if not (fq.device == vq.device == fc.device == vc.device):
        raise ValueError("query and corpus planes must lie on one device")
    F, C = fq.shape[0], fc.shape[0]
    if min(qmap) < 0 or max(qmap) >= F or min(cmap) < 0 or max(cmap) >= C:
        raise ValueError("field map index out of range")
    return qmap, cmap


def estimate_fields_plain(fq: torch.Tensor, vq: torch.Tensor,
                          fc: torch.Tensor, vc: torch.Tensor, *,
                          qmap: Sequence[int], cmap: Sequence[int]
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eager-PyTorch fused field partials, the kernel's arithmetic in the
    kernel's order: for each field pair and chunk of corpus rows, a loop
    over t adds one ``[Q, rows]`` term at a time."""
    qmap, cmap = _check_inputs(fq, vq, fc, vc, qmap, cmap)
    G, Q, P, m = len(qmap), fq.shape[1], fc.shape[1], fq.shape[2]
    dev = fq.device
    cnt = torch.empty((G, Q, P), dtype=torch.float32, device=dev)
    sw = torch.empty((G, Q, P), dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for g, (qf, cf) in enumerate(zip(qmap, cmap)):
        fqg, vqg = fq[qf], vq[qf]                          # [Q, m]
        for lo in range(0, P, _PLAIN_ROWS):
            hi = min(P, lo + _PLAIN_ROWS)
            fct = fc[cf, lo:hi].t()                        # [m, rows] views
            vct = vc[cf, lo:hi].t()
            n = torch.zeros((Q, hi - lo), dtype=torch.float32, device=dev)
            s = torch.zeros((Q, hi - lo), dtype=torch.float32, device=dev)
            for t in range(m):
                a = fqg[:, t:t + 1]                        # [Q, 1]
                x = vqg[:, t:t + 1]
                v = vct[t][None, :]                        # [1, rows]
                hit = (a == fct[t][None, :]) & (a >= 0)    # [Q, rows]
                q = torch.minimum(x * x, v * v)
                safe = torch.where(hit & (q > 0), q, one)
                n = n + torch.where(hit, one, zero)
                s = s + torch.where(hit, x * v / safe, zero)
            cnt[g, :, lo:hi] = n
            sw[g, :, lo:hi] = s
    return cnt, sw


def estimate_fields_cuda(fq: torch.Tensor, vq: torch.Tensor,
                         fc: torch.Tensor, vc: torch.Tensor, *,
                         qmap: Sequence[int], cmap: Sequence[int]
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA fields kernel on PyTorch's current stream.

    Takes CUDA tensors only; the query planes are made contiguous (they
    are small), the corpus planes are read in place through their strides.
    Adds one to ``estimate_fields_cuda.launches`` per launch.
    """
    qmap, cmap = _check_inputs(fq, vq, fc, vc, qmap, cmap)
    if fq.device.type != "cuda":
        raise ValueError(f"estimate_fields_cuda takes CUDA tensors; got "
                         f"{fq.device}")
    if len(qmap) > MAX_PAIRS:
        raise ValueError(f"at most {MAX_PAIRS} field pairs per launch")
    if fc.stride(2) != 1 or vc.stride(2) != 1:
        raise ValueError("corpus planes need a contiguous last dimension")
    fq, vq = fq.contiguous(), vq.contiguous()
    G, Q, P, m = len(qmap), fq.shape[1], fc.shape[1], fq.shape[2]
    cnt = torch.empty((G, Q, P), dtype=torch.float32, device=fq.device)
    sw = torch.empty((G, Q, P), dtype=torch.float32, device=fq.device)
    if Q == 0 or P == 0 or m == 0:
        return cnt.zero_(), sw.zero_()
    lib = build.library()
    qarr = (ctypes.c_int * len(qmap))(*qmap)
    carr = (ctypes.c_int * len(cmap))(*cmap)
    with torch.cuda.device(fq.device):
        stream = torch.cuda.current_stream(fq.device).cuda_stream
        err = lib.repro_estimate_fields(
            fq.data_ptr(), vq.data_ptr(), fc.data_ptr(), vc.data_ptr(),
            fc.stride(0), fc.stride(1), vc.stride(0), vc.stride(1),
            qarr, carr, G, Q, P, m, cnt.data_ptr(), sw.data_ptr(), stream)
    build.check(err, "estimate_fields")
    estimate_fields_cuda.launches += 1
    return cnt, sw


estimate_fields_cuda.launches = 0
