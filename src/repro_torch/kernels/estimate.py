"""Estimate launches: CUDA kernels and plain twins.

Seven kernels live here.  The ICWS collision partials of many queries
against a corpus replace the TPU kernels
``repro/kernels/estimate.py::_fields_kernel`` (B2, launcher
``estimate_fields_pallas``), ``_fields_packed_kernel`` (B11, over the
packed store's bf16-halfword corpus words) and ``_mvm_kernel`` (B4,
launcher ``estimate_many_vs_many_pallas``), all in
``csrc/estimate_fields.cu``: B2, B11 and B4 are one pipelined body
(``csrc/fields_body.cuh``) that reads each corpus field once for every
pair that uses it (B4 at one pair).  The pair partials replace ``_est_kernel`` (B3:
``estimate_partials_pallas`` and ``estimate_one_vs_many_pallas``,
``csrc/estimate_pairs.cu``; the one-vs-many route is that body at one
pair and one query).  The
linear-sketch dots replace ``_linear_fields_kernel`` (B8) and
``_linear_fields_packed_kernel`` (B12; see
:func:`linear_estimate_fields_plain`).  The ICWS contract::

    fq/vq [F, Q, m], fc/vc [C, P, m], static qmap/cmap -> (cnt, sw) [G, Q, P] f32

with ``cnt = sum_t 1[fq == fc and fq >= 0]`` and ``sw = sum_t 1[...] * vq *
vc / min(vq^2, vc^2)`` (IEEE divide, the safe denominator of the JAX
``_mvm_body``), for each field pair ``g = (qmap[g], cmap[g])``; B4 is the
same function on one plane pair (``[Q, m] x [P, m] -> [Q, P]``), B3 on
row pairs (``[P, m] x [P, m] -> [P]``) or one query against every row
(``[m] x [P, m] -> [P]``).  A packed twin decodes the corpus values inside
the kernel and gives its unpacked twin's bits on the decoded corpus.

Port contract: each (q, p) sum runs over ``t = 0 .. m-1`` in order, one
f32 add at a time, in both versions -- so the result does not depend on
Q, P or any tiling (batched and sequential queries agree bit for bit; a
row of B4, B3's one-vs-many route and B3's pairwise route on the tiled
query give the same bits), and the CUDA kernel and the plain version do
the same IEEE operations in the same order.  The field pair is read
through ``qmap``/``cmap``; neither version builds per-pair copies, a tiled
query or a ``[Q, P, m]`` tensor.  The corpus planes may be any strided
view whose last dimension is contiguous (a tenant's slice of the store's
``[3, cap, m]`` buffers, or field 0 of a ``[1, cap, m]`` buffer, is passed
as is).

The CUDA kernels are bound by the bytes of the corpus planes they read;
see the sources for their design.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import build
from .packed import unpack_halfwords_f32

MAX_PAIRS = 16   # kMaxPairs in csrc/fields_body.cuh, linear_estimate_fields.cu
# corpus rows per plain-version chunk: one [Q, rows] accumulator pair at a time
_PLAIN_ROWS = 1 << 16


def _launch(kernel: str, x: torch.Tensor, *args) -> None:
    """Call ``repro_<kernel>`` on PyTorch's current stream of ``x``'s card
    and raise if the launch was refused."""
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, "repro_" + kernel)(*args, stream)
    build.check(err, kernel)


def _check_maps(qmap, cmap, F: int, C: int):
    qmap = tuple(int(i) for i in qmap)
    cmap = tuple(int(i) for i in cmap)
    if len(qmap) != len(cmap):
        raise ValueError("qmap/cmap length mismatch")
    if not qmap:
        raise ValueError("qmap/cmap must name at least one field pair")
    if min(qmap) < 0 or max(qmap) >= F or min(cmap) < 0 or max(cmap) >= C:
        raise ValueError("field map index out of range")
    return qmap, cmap


def _check_inputs(fq, vq, fc, vc, qmap, cmap):
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
    return _check_maps(qmap, cmap, fq.shape[0], fc.shape[0])


def _add_hits(n, s, a, x, f, v):
    """One step t of every collision sum in the plain versions: query
    fingerprints/values ``a``/``x`` against corpus ``f``/``v`` (shapes that
    broadcast), the hit's count and weight added to ``n`` and ``s`` -- the
    kernels' IEEE operations in their order."""
    hit = (a == f) & (a >= 0)
    q = torch.minimum(x * x, v * v)
    safe = torch.where(hit & (q > 0), q, 1.0)
    return (n + torch.where(hit, 1.0, 0.0),
            s + torch.where(hit, x * v / safe, 0.0))


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
    for g, (qf, cf) in enumerate(zip(qmap, cmap)):
        fqg, vqg = fq[qf], vq[qf]                          # [Q, m]
        for lo in range(0, P, _PLAIN_ROWS):
            hi = min(P, lo + _PLAIN_ROWS)
            fct = fc[cf, lo:hi].t()                        # [m, rows] views
            vct = vc[cf, lo:hi].t()
            n = torch.zeros((Q, hi - lo), dtype=torch.float32, device=dev)
            s = torch.zeros((Q, hi - lo), dtype=torch.float32, device=dev)
            for t in range(m):
                n, s = _add_hits(n, s, fqg[:, t:t + 1], vqg[:, t:t + 1],
                                 fct[t][None, :], vct[t][None, :])
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
    _launch("estimate_fields", fq, fq.data_ptr(), vq.data_ptr(),
            fc.data_ptr(), vc.data_ptr(), fc.stride(0), fc.stride(1),
            vc.stride(0), vc.stride(1), (ctypes.c_int * G)(*qmap),
            (ctypes.c_int * G)(*cmap), G, Q, P, m, cnt.data_ptr(),
            sw.data_ptr())
    estimate_fields_cuda.launches += 1
    return cnt, sw


estimate_fields_cuda.launches = 0


# ---------------------------------------------------------------------------
# One plane pair: sketch pairs, one query vs many rows (B3), many vs many (B4)
# ---------------------------------------------------------------------------
def _check_pair(fa, va, fb, vb, lead: str):
    """fb/vb ``[P, m]``; fa/va ``lead`` rows of the same m, int32 / f32, on
    one device."""
    if fb.dim() != 2 or vb.shape != fb.shape or fa.dim() != 2 \
            or va.shape != fa.shape or fa.shape[1] != fb.shape[1]:
        raise ValueError(f"expected fa/va [{lead}, m] and fb/vb [P, m]; got "
                         f"{tuple(fa.shape)}, {tuple(va.shape)}, "
                         f"{tuple(fb.shape)}, {tuple(vb.shape)}")
    if (fa.dtype, va.dtype, fb.dtype, vb.dtype) != (
            torch.int32, torch.float32, torch.int32, torch.float32):
        raise TypeError("estimate takes int32 fingerprints and f32 values")
    if not (fa.device == va.device == fb.device == vb.device):
        raise ValueError("both sides must lie on one device")


def _check_pairwise(fpa, va, fpb, vb):
    _check_pair(fpa, va, fpb, vb, "P")
    if fpa.shape[0] != fpb.shape[0]:
        raise ValueError(f"pairwise sides differ in rows: {fpa.shape[0]} "
                         f"and {fpb.shape[0]}")


def _query_row(fq, vq, fpc, vc):
    """The one query of a one-vs-many launch as ``[1, m]`` views
    (``[1, m]`` or ``[m]`` given), checked against the corpus."""
    if fq.dim() not in (1, 2) or fq.numel() != fpc.shape[-1]:
        raise ValueError(f"expected one query sketch [1, m] or [m] with the "
                         f"corpus's m; got {tuple(fq.shape)} against "
                         f"{tuple(fpc.shape)}")
    fq, vq = fq.reshape(1, -1), vq.reshape(1, -1)
    _check_pair(fq, vq, fpc, vc, "1")
    return fq, vq


def _check_cuda(x: torch.Tensor, name: str, *planes) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors; got {x.device}")
    if any(p.stride(-1) != 1 for p in planes):
        raise ValueError("sketch planes need a contiguous last dimension")


def estimate_partials_plain(fpa, va, fpb, vb):
    """Plain pairwise partials: row p of A against row p of B, ``[P, m]``
    each -> ``(cnt, sw) [P]`` f32, a loop over t adding one ``[P]`` term
    at a time (the guard on side A)."""
    _check_pairwise(fpa, va, fpb, vb)
    P, m = fpb.shape
    n = torch.zeros(P, dtype=torch.float32, device=fpb.device)
    s = torch.zeros(P, dtype=torch.float32, device=fpb.device)
    for t in range(m):
        n, s = _add_hits(n, s, fpa[:, t], va[:, t], fpb[:, t], vb[:, t])
    return n, s


def estimate_partials_cuda(fpa, va, fpb, vb):
    """Launch B3's pairwise route (``estimate_pairs_kernel`` of
    ``csrc/estimate_pairs.cu``) on PyTorch's current stream; CUDA tensors
    only, both sides read in place through their row strides.  Adds one to
    ``estimate_partials_cuda.launches``."""
    _check_pairwise(fpa, va, fpb, vb)
    _check_cuda(fpb, "estimate_partials_cuda", fpa, va, fpb, vb)
    return _launch_pairs(estimate_partials_cuda, "estimate_pairs", fpb,
                         fpa.data_ptr(), va.data_ptr(), fpb.data_ptr(),
                         vb.data_ptr(), fpa.stride(0), va.stride(0),
                         fpb.stride(0), vb.stride(0))


estimate_partials_cuda.launches = 0


def estimate_one_vs_many_plain(fq, vq, fpc, vc):
    """Plain one-vs-many partials: one query ``[1, m]`` (or ``[m]``)
    against every row of ``[P, m]`` -> ``(cnt, sw) [P]`` f32, the query
    broadcast (never tiled), a loop over t adding one ``[P]`` term at a
    time."""
    fq, vq = _query_row(fq, vq, fpc, vc)
    P, m = fpc.shape
    n = torch.zeros(P, dtype=torch.float32, device=fpc.device)
    s = torch.zeros(P, dtype=torch.float32, device=fpc.device)
    for t in range(m):
        n, s = _add_hits(n, s, fq[0, t], vq[0, t], fpc[:, t], vc[:, t])
    return n, s


def estimate_one_vs_many_cuda(fq, vq, fpc, vc):
    """Launch B3's one-vs-many route (``estimate_one_vs_many_kernel`` of
    ``csrc/estimate_pairs.cu``: B2's body at one pair and one query, the
    query's tile staged once per block and read by broadcast) on
    PyTorch's current stream; CUDA tensors only, the query made contiguous,
    the corpus read in place.  Adds one to
    ``estimate_one_vs_many_cuda.launches``."""
    fq, vq = _query_row(fq, vq, fpc, vc)
    _check_cuda(fpc, "estimate_one_vs_many_cuda", fq, vq, fpc, vc)
    fq, vq = fq.contiguous(), vq.contiguous()
    return _launch_pairs(estimate_one_vs_many_cuda, "estimate_one_vs_many",
                         fpc, fq.data_ptr(), vq.data_ptr(), fpc.data_ptr(),
                         vc.data_ptr(), fpc.stride(0), vc.stride(0))


estimate_one_vs_many_cuda.launches = 0


def _launch_pairs(wrapper, kernel, fb, *args):
    """Launch B3's ``kernel`` on ``args`` (pointers, strides) over the rows
    of ``fb`` into new ``(cnt, sw) [P]``, counted on ``wrapper``."""
    P, m = fb.shape
    cnt = torch.empty(P, dtype=torch.float32, device=fb.device)
    sw = torch.empty(P, dtype=torch.float32, device=fb.device)
    if P == 0 or m == 0:
        return cnt.zero_(), sw.zero_()
    _launch(kernel, fb, *args, P, m, cnt.data_ptr(), sw.data_ptr())
    wrapper.launches += 1
    return cnt, sw


def estimate_many_vs_many_plain(fq, vq, fpc, vc):
    """Plain many-vs-many partials, ``[Q, m] x [P, m] -> (cnt, sw) [Q,
    P]``: :func:`estimate_fields_plain` on the one plane pair (views, no
    copy) -- B4 is B2's function at G = 1."""
    _check_pair(fq, vq, fpc, vc, "Q")
    cnt, sw = estimate_fields_plain(fq[None], vq[None], fpc[None], vc[None],
                                    qmap=(0,), cmap=(0,))
    return cnt[0], sw[0]


def estimate_many_vs_many_cuda(fq, vq, fpc, vc):
    """Launch B4 (``estimate_many_kernel`` of ``csrc/estimate_fields.cu``:
    B2's body at one pair, in B3 one-vs-many's shape at one query, else 16
    queries a block) on PyTorch's current stream; CUDA tensors only, the
    queries made contiguous (they are small), the corpus read in place
    through its row stride.  Adds one to
    ``estimate_many_vs_many_cuda.launches``."""
    _check_pair(fq, vq, fpc, vc, "Q")
    _check_cuda(fpc, "estimate_many_vs_many_cuda", fpc, vc)
    fq, vq = fq.contiguous(), vq.contiguous()
    (Q, m), P = fq.shape, fpc.shape[0]
    cnt = torch.empty((Q, P), dtype=torch.float32, device=fpc.device)
    sw = torch.empty((Q, P), dtype=torch.float32, device=fpc.device)
    if Q == 0 or P == 0 or m == 0:
        return cnt.zero_(), sw.zero_()
    _launch("estimate_many", fpc, fq.data_ptr(), vq.data_ptr(),
            fpc.data_ptr(), vc.data_ptr(), fpc.stride(0), vc.stride(0), Q, P,
            m, cnt.data_ptr(), sw.data_ptr())
    estimate_many_vs_many_cuda.launches += 1
    return cnt, sw


estimate_many_vs_many_cuda.launches = 0


# ---------------------------------------------------------------------------
# Linear-family estimation: per-rep sketch dots (CountSketch, JL)
# ---------------------------------------------------------------------------
def _check_linear(tq, tc, qmap, cmap):
    if tq.dim() != 4 or tc.dim() != 4 or tq.shape[2:] != tc.shape[2:]:
        raise ValueError(f"expected tq [F, Q, R, W] and tc [C, P, R, W]; got "
                         f"{tuple(tq.shape)}, {tuple(tc.shape)}")
    if (tq.dtype, tc.dtype) != (torch.float32, torch.float32):
        raise TypeError(f"linear estimate takes f32 tables; got {tq.dtype}, "
                        f"{tc.dtype}")
    if tq.device != tc.device:
        raise ValueError("query and corpus tables must lie on one device")
    return _check_maps(qmap, cmap, tq.shape[0], tc.shape[0])


def linear_estimate_fields_plain(tq: torch.Tensor, tc: torch.Tensor, *,
                                 qmap: Sequence[int], cmap: Sequence[int]
                                 ) -> torch.Tensor:
    """Per-rep linear-sketch dots of every field pair, in plain PyTorch.

    Twin of ``linear_estimate_fields_pallas``: ``tq [F, Q, R, W]``, ``tc
    [C, P, R, W]`` -> ``[G, R, Q, P]`` f32 with ``out[g, r, q, p] = sum_w
    tq[qmap[g], q, r, w] * tc[cmap[g], p, r, w]``.  Each sum runs over
    ``w = 0 .. W-1`` in order, an f32 product then an f32 add per step
    (never a fused multiply-add, never TF32), in this version and in the
    CUDA kernel alike: the result does not depend on Q, P or tiling, and
    the two agree bit for bit on the card.  The median over reps is the
    caller's epilogue (``ops.linear_estimate_fields``).
    """
    qmap, cmap = _check_linear(tq, tc, qmap, cmap)
    Q, P, R, W = tq.shape[1], tc.shape[1], tc.shape[2], tc.shape[3]
    dev = tq.device
    out = torch.empty((len(qmap), R, Q, P), dtype=torch.float32, device=dev)
    for g, (qf, cf) in enumerate(zip(qmap, cmap)):
        for r in range(R):
            a = tq[qf, :, r]                               # [Q, W]
            for lo in range(0, P, _PLAIN_ROWS):
                hi = min(P, lo + _PLAIN_ROWS)
                bt = tc[cf, lo:hi, r].t()                  # [W, rows] view
                acc = torch.zeros((Q, hi - lo), dtype=torch.float32,
                                  device=dev)
                for w in range(W):
                    acc = acc + a[:, w:w + 1] * bt[w][None, :]
                out[g, r, :, lo:hi] = acc
    return out


def linear_estimate_fields_cuda(tq: torch.Tensor, tc: torch.Tensor, *,
                                qmap: Sequence[int], cmap: Sequence[int]
                                ) -> torch.Tensor:
    """Launch the CUDA linear-fields kernel on PyTorch's current stream.

    Takes CUDA tensors only; the query tables are made contiguous (they are
    small), the corpus tables are read in place through their field and
    row strides (each row's ``[R, W]`` table must be contiguous, as a
    tenant slice of the store's ``[3, cap, R, W]`` buffer is).  Adds one to
    ``linear_estimate_fields_cuda.launches`` per launch.
    """
    qmap, cmap = _check_linear(tq, tc, qmap, cmap)
    if tq.device.type != "cuda":
        raise ValueError(f"linear_estimate_fields_cuda takes CUDA tensors; "
                         f"got {tq.device}")
    if len(qmap) > MAX_PAIRS:
        raise ValueError(f"at most {MAX_PAIRS} field pairs per launch")
    Q, P, R, W = tq.shape[1], tc.shape[1], tc.shape[2], tc.shape[3]
    if tc.stride(3) != 1 or tc.stride(2) != W:
        raise ValueError("each corpus row's [R, W] table must be contiguous")
    tq = tq.contiguous()
    out = torch.empty((len(qmap), R, Q, P), dtype=torch.float32,
                      device=tq.device)
    if Q == 0 or P == 0 or R == 0 or W == 0:
        return out.zero_()
    _launch("linear_estimate_fields", tq, tq.data_ptr(), tc.data_ptr(),
            tc.stride(0), tc.stride(1), (ctypes.c_int * len(qmap))(*qmap),
            (ctypes.c_int * len(cmap))(*cmap), len(qmap), Q, P, R, W,
            out.data_ptr())
    linear_estimate_fields_cuda.launches += 1
    return out


linear_estimate_fields_cuda.launches = 0


# ---------------------------------------------------------------------------
# Packed corpus: the values (tables) as bf16-halfword words, decoded on chip
# ---------------------------------------------------------------------------
def _check_packed(fq, vq, fc, wc, qmap, cmap):
    if wc.dim() != 3 or wc.dtype != torch.int32 \
            or tuple(wc.shape) != (fc.shape[0], fc.shape[1], fc.shape[2] // 2) \
            or fc.shape[2] % 2:
        raise ValueError(f"expected fc [C, P, me] with me even and wc [C, P, "
                         f"me / 2] int32; got {tuple(fc.shape)}, "
                         f"{tuple(wc.shape)} {wc.dtype}")
    # the unpacked launch's checks, with a value-shaped stand-in (a
    # broadcast scalar: nothing is allocated) for the corpus values
    stand_in = torch.zeros((), dtype=torch.float32, device=fc.device)
    return _check_inputs(fq, vq, fc, stand_in.expand(fc.shape), qmap, cmap)


def estimate_fields_packed_plain(fq, vq, fc, wc, *, qmap, cmap):
    """The plain fused field partials over a packed corpus: ``wc [C, P, me
    / 2]`` i32 words in place of ``vc [C, P, me]`` (``me`` even; the query
    padded to it), decoded a chunk of rows at a time, then
    :func:`estimate_fields_plain` on the decoded chunk."""
    qmap, cmap = _check_packed(fq, vq, fc, wc, qmap, cmap)
    G, Q, P = len(qmap), fq.shape[1], fc.shape[1]
    cnt = torch.empty((G, Q, P), dtype=torch.float32, device=fq.device)
    sw = torch.empty((G, Q, P), dtype=torch.float32, device=fq.device)
    for lo in range(0, P, _PLAIN_ROWS):
        hi = min(P, lo + _PLAIN_ROWS)
        cnt[:, :, lo:hi], sw[:, :, lo:hi] = estimate_fields_plain(
            fq, vq, fc[:, lo:hi], unpack_halfwords_f32(wc[:, lo:hi]),
            qmap=qmap, cmap=cmap)
    return cnt, sw


def estimate_fields_packed_cuda(fq, vq, fc, wc, *, qmap, cmap):
    """Launch B11 (``estimate_fields_packed_kernel`` of
    ``csrc/estimate_fields.cu``: B2's body with the corpus values decoded
    from ``wc`` where the compare loads them) on PyTorch's current stream;
    CUDA tensors only, the queries made contiguous, the corpus read in
    place through its strides.  Adds one to
    ``estimate_fields_packed_cuda.launches`` per launch."""
    qmap, cmap = _check_packed(fq, vq, fc, wc, qmap, cmap)
    if fq.device.type != "cuda":
        raise ValueError(f"estimate_fields_packed_cuda takes CUDA tensors; "
                         f"got {fq.device}")
    if len(qmap) > MAX_PAIRS:
        raise ValueError(f"at most {MAX_PAIRS} field pairs per launch")
    if fc.stride(2) != 1 or wc.stride(2) != 1:
        raise ValueError("corpus planes need a contiguous last dimension")
    fq, vq = fq.contiguous(), vq.contiguous()
    G, Q, P, m = len(qmap), fq.shape[1], fc.shape[1], fq.shape[2]
    cnt = torch.empty((G, Q, P), dtype=torch.float32, device=fq.device)
    sw = torch.empty((G, Q, P), dtype=torch.float32, device=fq.device)
    if Q == 0 or P == 0 or m == 0:
        return cnt.zero_(), sw.zero_()
    _launch("estimate_fields_packed", fq, fq.data_ptr(), vq.data_ptr(),
            fc.data_ptr(), wc.data_ptr(), fc.stride(0), fc.stride(1),
            wc.stride(0), wc.stride(1), (ctypes.c_int * G)(*qmap),
            (ctypes.c_int * G)(*cmap), G, Q, P, m, cnt.data_ptr(),
            sw.data_ptr())
    estimate_fields_packed_cuda.launches += 1
    return cnt, sw


estimate_fields_packed_cuda.launches = 0


def _check_linear_packed(tq, wc, qmap, cmap):
    if wc.dim() != 4 or wc.dtype != torch.int32 or tq.dim() != 4 \
            or tuple(tq.shape[2:]) != (wc.shape[2], 2 * wc.shape[3]):
        raise ValueError(f"expected tq [F, Q, R, We] and wc [C, P, R, We / 2] "
                         f"int32; got {tuple(tq.shape)}, {tuple(wc.shape)} "
                         f"{wc.dtype}")
    return _check_linear(tq, tq.new_empty((wc.shape[0], 0) + tuple(tq.shape[2:])),
                         qmap, cmap)


def linear_estimate_fields_packed_plain(tq, wc, *, qmap, cmap):
    """The plain per-rep dots over packed corpus tables: ``wc [C, P, R, We
    / 2]`` i32 words (``We`` even; the query padded to it), decoded a chunk
    of rows at a time, then :func:`linear_estimate_fields_plain`."""
    qmap, cmap = _check_linear_packed(tq, wc, qmap, cmap)
    Q, P, R = tq.shape[1], wc.shape[1], wc.shape[2]
    out = torch.empty((len(qmap), R, Q, P), dtype=torch.float32,
                      device=tq.device)
    for lo in range(0, P, _PLAIN_ROWS):
        hi = min(P, lo + _PLAIN_ROWS)
        out[:, :, :, lo:hi] = linear_estimate_fields_plain(
            tq, unpack_halfwords_f32(wc[:, lo:hi]), qmap=qmap, cmap=cmap)
    return out


def linear_estimate_fields_packed_cuda(tq, wc, *, qmap, cmap):
    """Launch the packed linear-fields kernel
    (``linear_estimate_fields_packed_kernel`` of
    ``csrc/linear_estimate_fields.cu``) on PyTorch's current stream; CUDA
    tensors only, each corpus row's ``[R, We / 2]`` words contiguous.  Adds
    one to ``linear_estimate_fields_packed_cuda.launches`` per launch."""
    qmap, cmap = _check_linear_packed(tq, wc, qmap, cmap)
    if tq.device.type != "cuda":
        raise ValueError(f"linear_estimate_fields_packed_cuda takes CUDA "
                         f"tensors; got {tq.device}")
    if len(qmap) > MAX_PAIRS:
        raise ValueError(f"at most {MAX_PAIRS} field pairs per launch")
    Q, P, R, W = tq.shape[1], wc.shape[1], wc.shape[2], tq.shape[3]
    if wc.stride(3) != 1 or wc.stride(2) != W // 2:
        raise ValueError("each corpus row's [R, We / 2] words must be "
                         "contiguous")
    tq = tq.contiguous()
    out = torch.empty((len(qmap), R, Q, P), dtype=torch.float32,
                      device=tq.device)
    if Q == 0 or P == 0 or R == 0 or W == 0:
        return out.zero_()
    _launch("linear_estimate_fields_packed", tq, tq.data_ptr(), wc.data_ptr(),
            wc.stride(0), wc.stride(1), (ctypes.c_int * len(qmap))(*qmap),
            (ctypes.c_int * len(cmap))(*cmap), len(qmap), Q, P, R, W,
            out.data_ptr())
    linear_estimate_fields_packed_cuda.launches += 1
    return out


linear_estimate_fields_packed_cuda.launches = 0
