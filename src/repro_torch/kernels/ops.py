"""Device-dispatching launch layer (the port's ``repro/kernels/ops.py``).

Every op picks its implementation from the device its tensors lie on: a
CPU tensor takes the plain PyTorch version, a CUDA tensor launches the
hand-written kernel -- or raises, if the kernel does not build or its
launch is refused.  There is no fallback from the kernel to the plain
version.  Launch counts live on the kernel wrappers
(``icws_sketch_cuda.launches``, ``estimate_fields_cuda.launches``,
``estimate_partials_cuda.launches``, ``estimate_one_vs_many_cuda.launches``,
``estimate_many_vs_many_cuda.launches``,
``countsketch_sparse_cuda.launches``, ``countsketch_dense_cuda.launches``,
``jl_sketch_cuda.launches``,
``linear_estimate_fields_cuda.launches``, ``dmh_sketch_cuda.launches``,
``sample_estimate_fields_cuda.launches``, and the packed twins'
``*_packed_cuda.launches``).

The packed-corpus ops mirror their unpacked twins -- the same epilogue,
the true sketch width in every formula -- with the corpus values arriving
as bf16-halfword words (:mod:`.packed`).  Queries are sketched fresh and
stay unpacked; where the stored width gained a pad slot (an odd width
rounded up to even), the query is padded here with the sentinels the
kernels already treat as dead.  So a packed estimate equals the unpacked
one on ``family.unpack_rows(family.pack_rows(rows))`` bit for bit.

Every public def carries ``@_obs.instrumented("<its own name>")`` (the
rule OB001 sets for the JAX package's ops; a port test applies it here):
with observability on, each call counts under ``ops.launches_total{op,
family}`` and its host time lands in ``ops.launch_seconds``, and
``_route`` sets the ``ops.interpret_mode`` gauge: 1.0 when a CPU tensor
takes the plain version, 0.0 when a CUDA kernel is launched.  No op
resolves blocks from a tuning cache yet, so ``ops.autotune_resolved_total``
is never emitted (``ROADMAP.md`` Queue A 16).

Sharded ops (``*_sharded``, ``sharded_top_k``): the corpus rows are split
over one axis of a mesh (:mod:`repro_torch.launch.mesh`), the queries
replicate, and every shard runs the same single-device op on its rows
(:func:`_sharded`).  Each (query, row) estimate reduces only over that
row's samples or slots, in an order no launcher picks by the row count,
so the concatenated shard outputs equal the single-device launch bit for
bit.  The sharded op counts once a call; the inner op and the kernel
counters count once a shard.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

from repro_torch import obs as _obs

from repro_torch.distributed.sharding import shard_rows

from .common import CORPUS_PAD_FP, QUERY_PAD_FP, stable_top_k
from .countsketch import (_bucket_sign, countsketch_dense_cuda,
                          countsketch_dense_plain, countsketch_sparse_cuda,
                          countsketch_sparse_plain)
from .dmh_sketch import (dmh_sketch_cuda, dmh_sketch_packed_cuda,
                         dmh_sketch_packed_plain, dmh_sketch_plain)
from .estimate import (estimate_fields_cuda, estimate_fields_packed_cuda,
                       estimate_fields_packed_plain, estimate_fields_plain,
                       estimate_many_vs_many_cuda, estimate_many_vs_many_plain,
                       estimate_one_vs_many_cuda, estimate_one_vs_many_plain,
                       estimate_partials_cuda, estimate_partials_plain,
                       linear_estimate_fields_cuda,
                       linear_estimate_fields_packed_cuda,
                       linear_estimate_fields_packed_plain,
                       linear_estimate_fields_plain)
from .icws_sketch import (icws_sketch_cuda, icws_sketch_packed_cuda,
                          icws_sketch_packed_plain, icws_sketch_plain)
from .jl_sketch import jl_sketch_cuda, jl_sketch_plain
from .sample_estimate import (sample_estimate_fields_cuda,
                              sample_estimate_fields_packed_cuda,
                              sample_estimate_fields_packed_plain,
                              sample_estimate_fields_taus_plain,
                              sample_inclusion_probs)


def _route(x: torch.Tensor, plain, kernel):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {x.device}")
    cpu = x.device.type == "cpu"
    if _obs.enabled():
        _obs.gauge("ops.interpret_mode").set(float(cpu))
    return plain if cpu else kernel


@_obs.instrumented("icws_sketch")
def icws_sketch(w, keys, vals, *, m: int, seed: int = 0,
                pack_vals: bool = False):
    """ICWS sketch of a padded sparse batch.
    [B, N] -> (fp, val, amin, argkey) [B, m]; ``pack_vals=True`` appends
    the packed value plane ``[B, (m + m % 2) // 2]`` i32, packed in the
    kernel."""
    fn = (_route(w, icws_sketch_packed_plain, icws_sketch_packed_cuda)
          if pack_vals else _route(w, icws_sketch_plain, icws_sketch_cuda))
    return fn(w, keys, vals, m=m, seed=seed)


@_obs.instrumented("dmh_sketch")
def dmh_sketch(w, keys, vals, *, m: int, seed: int = 0,
               pack_vals: bool = False, replicas: int = 1):
    """DMH sketch of a padded sparse batch, in the ICWS wire layout.
    [B, n] -> (fp, val, amin, argkey) [B, m]; each key's ``replicas``
    pseudo-keys are derived where the sketch runs (at 1 the rows are taken
    as they are: host-replicated rows, as the JAX package passes them);
    ``pack_vals=True`` appends the packed value plane as
    :func:`icws_sketch` does."""
    fn = (_route(w, dmh_sketch_packed_plain, dmh_sketch_packed_cuda)
          if pack_vals else _route(w, dmh_sketch_plain, dmh_sketch_cuda))
    return fn(w, keys, vals, m=m, seed=seed, replicas=replicas)


@_obs.instrumented("estimate_partials")
def estimate_partials(fpa, va, fpb, vb):
    """Algorithm-5 partial sums for P sketch pairs: ``[P, m]`` each ->
    ``(cnt, sw) [P]``."""
    fn = _route(fpb, estimate_partials_plain, estimate_partials_cuda)
    return fn(fpa, va, fpb, vb)


@_obs.instrumented("estimate_partials_one_vs_many")
def estimate_partials_one_vs_many(fq, vq, fpc, vc):
    """Partial sums of one query sketch (``[1, m]`` or ``[m]``) against a
    ``[P, m]`` corpus, the query broadcast: ``(cnt, sw) [P]``."""
    fn = _route(fpc, estimate_one_vs_many_plain, estimate_one_vs_many_cuda)
    return fn(fq, vq, fpc, vc)


@_obs.instrumented("estimate_partials_many_vs_many")
def estimate_partials_many_vs_many(fq, vq, fpc, vc):
    """Partial sums of ``[Q, m]`` queries against a ``[P, m]`` corpus in
    one launch: ``(cnt, sw) [Q, P]``."""
    fn = _route(fpc, estimate_many_vs_many_plain, estimate_many_vs_many_cuda)
    return fn(fq, vq, fpc, vc)


def _norm_epilogue(cnt, sw, na, nb, m: int):
    """``est = na * nb * (m~ / m) * sw`` with ``m~ = 2 / (1 + cnt / m)``,
    zero where either norm is zero (the JAX package's operand order; the
    norms broadcast against ``cnt``).  ``m`` divides as a 0-d f32 tensor
    filled on ``cnt``'s device (no host copy, so no sync): on CUDA torch
    takes a division by a python scalar as a multiply by its reciprocal,
    which JAX and the CPU do not."""
    m = cnt.new_full((), float(m), dtype=torch.float32)
    m_tilde = 2.0 / (1.0 + cnt / m)
    est = na * nb * (m_tilde / m) * sw
    return torch.where((na == 0) | (nb == 0), 0.0, est)


@_obs.instrumented("icws_estimate")
def icws_estimate(fpa, va, na, fpb, vb, nb):
    """ICWS inner-product estimates of P sketch pairs: fp ``[P, m]`` i32,
    v ``[P, m]`` f32, norms ``[P]`` f32 -> ``[P]`` f32."""
    cnt, sw = estimate_partials(fpa, va, fpb, vb)
    return _norm_epilogue(cnt, sw, na, nb, fpa.shape[1])


@_obs.instrumented("icws_estimate_corpus")
def icws_estimate_corpus(fq, vq, nq, fpc, vc, nc):
    """ICWS inner-product estimates of one query against a whole corpus.

    Args: fq/vq ``[1, m]`` (or ``[m]``) query, nq its norm (a 0-d tensor
    or a float); fpc/vc ``[P, m]`` corpus, nc ``[P]`` norms.  Returns
    ``[P]`` f32; the query is broadcast inside the kernel, never tiled.
    """
    cnt, sw = estimate_partials_one_vs_many(fq, vq, fpc, vc)
    nq = torch.as_tensor(nq, dtype=torch.float32, device=fpc.device)
    return _norm_epilogue(cnt, sw, nq, nc, fpc.shape[1])


@_obs.instrumented("icws_estimate_many")
def icws_estimate_many(fq, vq, nq, fpc, vc, nc):
    """ICWS inner-product estimates of Q queries against a whole corpus:
    fq/vq ``[Q, m]``, nq ``[Q]``; fpc/vc ``[P, m]``, nc ``[P]``.  Returns
    ``[Q, P]`` f32 from ONE many-vs-many launch."""
    cnt, sw = estimate_partials_many_vs_many(fq, vq, fpc, vc)
    return _norm_epilogue(cnt, sw, nq[:, None], nc[None, :], fpc.shape[1])


@_obs.instrumented("icws_estimate_corpus_stacked")
def icws_estimate_corpus_stacked(fq, vq, nq, fpb, vb, nb):
    """One query against field 0 of stacked ``[1, cap, m]`` store buffers,
    read in place (a view, no ``[cap, m]`` copy).  Unused capacity rows
    (pad fingerprints, zero norms) estimate to zero; callers slice the
    result to the live row count."""
    return icws_estimate_corpus(fq, vq, nq, fpb[0], vb[0], nb[0])


@_obs.instrumented("icws_estimate_many_stacked")
def icws_estimate_many_stacked(fq, vq, nq, fpb, vb, nb):
    """Q queries against field 0 of stacked ``[1, cap, m]`` store buffers."""
    return icws_estimate_many(fq, vq, nq, fpb[0], vb[0], nb[0])


def _sharded(fn, replicated, sharded, fills, *, mesh, axis: str,
             **kwargs):
    """One call of ``fn`` a shard of mesh axis ``axis``: the
    ``replicated`` tensors copied to the shard's device, then each corpus
    buffer of ``sharded`` at the shard's rows (dim 1).  A buffer is a
    tensor, split here and padded with its entry of ``fills`` (the inert
    fill of its family's spare rows) to a multiple of the shard count, or
    a sequence of per-shard tensors already on their devices (a sharded
    store's ``shard_buffers()``).  Every shard's launch is issued before
    any output is read; the outputs (corpus rows last) are concatenated in
    shard order on the first replicated tensor's device and cut to the
    corpus rows."""
    devs = mesh.axis_devices(axis)
    parts = [tuple(x) if isinstance(x, (tuple, list))
             else shard_rows(x, devs, fill=f)
             for x, f in zip(sharded, fills)]
    if any(len(p) != len(devs) for p in parts):
        raise ValueError(f"corpus buffers of {[len(p) for p in parts]} "
                         f"shards for a {len(devs)}-way axis {axis!r}")
    lead = sharded[0]
    rows = (sum(p.shape[1] for p in lead) if isinstance(lead, (tuple, list))
            else lead.shape[1])
    outs = [fn(*(r.to(dev) for r in replicated), *(p[s] for p in parts),
               **kwargs)
            for s, dev in enumerate(devs)]
    home = replicated[0].device
    return torch.cat([o.to(home) for o in outs], dim=-1)[..., :rows]


@_obs.instrumented("icws_estimate_many_sharded")
def icws_estimate_many_sharded(fq, vq, nq, fpb, vb, nb, *, mesh,
                               axis="data"):
    """:func:`icws_estimate_many_stacked` with the F = 1 store's corpus
    rows split over mesh axis ``axis`` (:func:`_sharded`).  Returns ``[Q,
    cap]`` f32, bit for bit the single-device launch."""
    return _sharded(icws_estimate_many_stacked, (fq, vq, nq), (fpb, vb, nb),
                    (CORPUS_PAD_FP, 0, 0), mesh=mesh, axis=axis)


@_obs.instrumented("estimate_partials_fields")
def estimate_partials_fields(fq, vq, fpc, vc, *, qmap: Sequence[int],
                             cmap: Sequence[int]):
    """Fused multi-field partial sums: one launch for all field pairs."""
    fn = _route(fq, estimate_fields_plain, estimate_fields_cuda)
    return fn(fq, vq, fpc, vc, qmap=qmap, cmap=cmap)


@_obs.instrumented("icws_estimate_fields")
def icws_estimate_fields(fq, vq, nq, fpc, vc, nc, *, qmap: Sequence[int],
                         cmap: Sequence[int]):
    """Fused multi-field ICWS inner-product estimates, ONE kernel launch.

    Args: fq/vq [F, Q, m] per-field queries, nq [F, Q] norms; fpc/vc
    [C, P, m] per-field corpus, nc [C, P] norms.  Returns [G, Q, P] f32:
    the partials, then the ``m~ = 2 / (1 + j^)`` norm epilogue, with zero
    where either norm is zero.
    """
    cnt, sw = estimate_partials_fields(fq, vq, fpc, vc, qmap=qmap, cmap=cmap)
    return _icws_epilogue(cnt, sw, nq, nc, fq.shape[2], qmap, cmap)


@_obs.instrumented("icws_estimate_fields_packed")
def icws_estimate_fields_packed(fq, vq, nq, fpc, wc, nc, *,
                                qmap: Sequence[int], cmap: Sequence[int]):
    """Packed-corpus :func:`icws_estimate_fields`: fpc ``[C, P, me]`` i32,
    wc ``[C, P, me // 2]`` i32 packed values (me = m rounded up to even),
    nc ``[C, P]``.  The query pads to me; the epilogue runs over the true
    m.  Returns [G, Q, P] f32."""
    m, me = fq.shape[2], fpc.shape[2]
    fq = F.pad(fq, (0, me - m), value=QUERY_PAD_FP)
    vq = F.pad(vq, (0, me - m))
    fn = _route(fq, estimate_fields_packed_plain, estimate_fields_packed_cuda)
    cnt, sw = fn(fq, vq, fpc, wc, qmap=qmap, cmap=cmap)
    return _icws_epilogue(cnt, sw, nq, nc, m, qmap, cmap)


def _icws_epilogue(cnt, sw, nq, nc, m: int, qmap, cmap):
    """:func:`_norm_epilogue` with each field pair's norms."""
    nqg = torch.stack([nq[qf] for qf in qmap])[:, :, None]    # [G, Q, 1]
    ncg = torch.stack([nc[cf] for cf in cmap])[:, None, :]    # [G, 1, P]
    return _norm_epilogue(cnt, sw, nqg, ncg, m)


@_obs.instrumented("countsketch_sparse")
def countsketch_sparse(keys, vals, *, width: int, reps: int = 5,
                       seed: int = 0):
    """CountSketch of a padded sparse batch.  [B, N] -> [B, reps, width]."""
    fn = _route(keys, countsketch_sparse_plain, countsketch_sparse_cuda)
    return fn(keys, vals, width=width, reps=reps, seed=seed)


@_obs.instrumented("countsketch")
def countsketch(x, *, width: int, reps: int = 5, seed: int = 0,
                offset: int = 0):
    """CountSketch table ``[reps, width]`` of a dense f32 vector ``[T]``;
    element i hashes as the u32 ``offset + i``."""
    fn = _route(x, countsketch_dense_plain, countsketch_dense_cuda)
    return fn(x, width=width, reps=reps, seed=seed, offset=offset)


@_obs.instrumented("countsketch_decode")
def countsketch_decode(table, indices, *, seed: int = 0):
    """Median-of-reps point query of a ``[reps, width]`` table at
    ``indices [n]``: each rep's bucket times its sign, then the median over
    reps as :func:`_median_reps` takes it.  A gather; no kernel (the JAX
    package has none either)."""
    reps, width = table.shape
    bucket, sign = _bucket_sign(indices[None], width=width, reps=reps,
                                seed=seed)                     # [1, R, n]
    est = torch.gather(table, 1, bucket[0]) * sign[0]          # [R, n]
    return _median_reps(est.T)


@_obs.instrumented("jl_sketch")
def jl_sketch(keys, vals, *, m: int, seed: int = 0):
    """JL projection of a padded sparse batch.  [B, N] -> [B, m]."""
    fn = _route(keys, jl_sketch_plain, jl_sketch_cuda)
    return fn(keys, vals, m=m, seed=seed)


def _median_reps(dots: torch.Tensor) -> torch.Tensor:
    """Median over the rep axis (dim 1) as ``jnp.median`` takes it: the
    mean of the two middle values, ``(lo + hi) * 0.5``, which for an odd
    count is the middle value itself.  (``torch.median`` returns the lower
    middle instead.)"""
    R = dots.shape[1]
    s = torch.sort(dots, dim=1).values
    return (s[:, (R - 1) // 2] + s[:, R // 2]) * 0.5


@_obs.instrumented("linear_estimate_fields")
def linear_estimate_fields(tq, tc, *, qmap: Sequence[int],
                           cmap: Sequence[int]):
    """Fused multi-field linear-sketch estimates, ONE kernel launch.

    Args: tq [F, Q, R, W] per-field query tables, tc [C, P, R, W] per-field
    corpus tables (JL: R = 1, W = m).  Returns [G, Q, P] f32: the per-rep
    dots, then the median over reps (for R = 1 the dot itself).  Zero rows
    (empty sketches, spare store rows, padding) estimate to zero.
    """
    fn = _route(tq, linear_estimate_fields_plain, linear_estimate_fields_cuda)
    return _median_reps(fn(tq, tc, qmap=qmap, cmap=cmap))


@_obs.instrumented("linear_estimate_fields_packed")
def linear_estimate_fields_packed(tq, wc, *, qmap: Sequence[int],
                                  cmap: Sequence[int]):
    """Packed-corpus :func:`linear_estimate_fields`: wc ``[C, P, R, We //
    2]`` i32 packed tables (We = W rounded up to even); the query gains
    zero columns to We, which add +0 to every sum and change no bit."""
    tq = F.pad(tq, (0, 2 * wc.shape[3] - tq.shape[3]))
    fn = _route(tq, linear_estimate_fields_packed_plain,
                linear_estimate_fields_packed_cuda)
    return _median_reps(fn(tq, wc, qmap=qmap, cmap=cmap))


@_obs.instrumented("sample_estimate_fields")
def sample_estimate_fields(kq, vq, tq, kc, vc, tc, *, qmap: Sequence[int],
                           cmap: Sequence[int]):
    """Fused multi-field sampling-sketch (TS/PS) estimates, ONE kernel launch.

    Args: kq/vq [F, Q, S] per-field query sample keys/values, tq [F, Q]
    probability scales; kc/vc [C, P, S] / tc [C, P] the corpus samples.
    Returns [G, Q, P] f32 inverse-inclusion-probability estimates.  The
    prologue reconstructs the query's probabilities ``min(1, S v^2 /
    tau)`` elementwise (the stored layout stays (key, val, tau)); the
    kernel computes a matched corpus slot's from its value and tau, so the
    card builds no ``[C, P, S]`` plane (the CPU's plain twin does).
    """
    aq = sample_inclusion_probs(vq, tq)
    fn = _route(kq, sample_estimate_fields_taus_plain,
                sample_estimate_fields_cuda)
    return fn(kq, vq, aq, kc, vc, tc, qmap=qmap, cmap=cmap)


@_obs.instrumented("sample_estimate_fields_packed")
def sample_estimate_fields_packed(kq, vq, tq, kc, wc, tc, *,
                                  qmap: Sequence[int], cmap: Sequence[int]):
    """Packed-corpus :func:`sample_estimate_fields`: kc ``[C, P, Se]`` i32
    keys, wc ``[C, P, Se // 2]`` i32 packed values (Se = slots rounded up
    to even), tc ``[C, P]`` taus.  The query's probabilities are the
    prologue's; the corpus's are computed in the kernel from the decoded
    value and tau, with the query's (true) slot count."""
    aq = sample_inclusion_probs(vq, tq)
    fn = _route(kq, sample_estimate_fields_packed_plain,
                sample_estimate_fields_packed_cuda)
    return fn(kq, vq, aq, kc, wc, tc, qmap=qmap, cmap=cmap)


# Sharded twins of the fused fields launches: queries replicate, corpus
# rows split over mesh axis ``axis`` and pad with the spare rows' inert
# fills (pad fingerprints and keys CORPUS_PAD_FP; zero values, words,
# tables, norms and taus).  Each returns [G, Q, cap] f32, bit for bit the
# single-device launch.

@_obs.instrumented("icws_estimate_fields_sharded")
def icws_estimate_fields_sharded(fq, vq, nq, fpc, vc, nc, *,
                                 qmap: Sequence[int], cmap: Sequence[int],
                                 mesh, axis="data"):
    """Sharded :func:`icws_estimate_fields`."""
    return _sharded(icws_estimate_fields, (fq, vq, nq), (fpc, vc, nc),
                    (CORPUS_PAD_FP, 0, 0), mesh=mesh, axis=axis,
                    qmap=qmap, cmap=cmap)


@_obs.instrumented("icws_estimate_fields_packed_sharded")
def icws_estimate_fields_packed_sharded(fq, vq, nq, fpc, wc, nc, *,
                                        qmap: Sequence[int],
                                        cmap: Sequence[int], mesh,
                                        axis="data"):
    """Sharded :func:`icws_estimate_fields_packed`."""
    return _sharded(icws_estimate_fields_packed, (fq, vq, nq), (fpc, wc, nc),
                    (CORPUS_PAD_FP, 0, 0), mesh=mesh, axis=axis,
                    qmap=qmap, cmap=cmap)


@_obs.instrumented("linear_estimate_fields_sharded")
def linear_estimate_fields_sharded(tq, tc, *, qmap: Sequence[int],
                                   cmap: Sequence[int], mesh, axis="data"):
    """Sharded :func:`linear_estimate_fields` (zero tables are inert)."""
    return _sharded(linear_estimate_fields, (tq,), (tc,), (0,), mesh=mesh,
                    axis=axis, qmap=qmap, cmap=cmap)


@_obs.instrumented("linear_estimate_fields_packed_sharded")
def linear_estimate_fields_packed_sharded(tq, wc, *, qmap: Sequence[int],
                                          cmap: Sequence[int], mesh,
                                          axis="data"):
    """Sharded :func:`linear_estimate_fields_packed` (zero words decode
    to zero tables)."""
    return _sharded(linear_estimate_fields_packed, (tq,), (wc,), (0,),
                    mesh=mesh, axis=axis, qmap=qmap, cmap=cmap)


@_obs.instrumented("sample_estimate_fields_sharded")
def sample_estimate_fields_sharded(kq, vq, tq, kc, vc, tc, *,
                                   qmap: Sequence[int], cmap: Sequence[int],
                                   mesh, axis="data"):
    """Sharded :func:`sample_estimate_fields` (pad keys, zero values and
    zero taus: probability 0 on every slot)."""
    return _sharded(sample_estimate_fields, (kq, vq, tq), (kc, vc, tc),
                    (CORPUS_PAD_FP, 0, 0), mesh=mesh, axis=axis,
                    qmap=qmap, cmap=cmap)


@_obs.instrumented("sample_estimate_fields_packed_sharded")
def sample_estimate_fields_packed_sharded(kq, vq, tq, kc, wc, tc, *,
                                          qmap: Sequence[int],
                                          cmap: Sequence[int], mesh,
                                          axis="data"):
    """Sharded :func:`sample_estimate_fields_packed`."""
    return _sharded(sample_estimate_fields_packed, (kq, vq, tq),
                    (kc, wc, tc), (CORPUS_PAD_FP, 0, 0), mesh=mesh,
                    axis=axis, qmap=qmap, cmap=cmap)


@_obs.instrumented("sharded_top_k")
def sharded_top_k(score, k: int, *, mesh, axis="data"):
    """Top-k over the last dim of ``score`` with its columns split over
    mesh axis ``axis``: each shard's ``min(k, shard)`` best (padded with
    ``-inf``, below every score), its indices offset by the shard's first
    column, merged in shard order.  Values and indices equal
    :func:`~.common.stable_top_k` on the whole row, ties included: a
    shard's candidates keep ascending indices within equal scores, and the
    merge's stable sort keeps shard order."""
    devs = mesh.axis_devices(axis)
    parts = shard_rows(score, devs, fill=-math.inf, dim=score.dim() - 1)
    shard = parts[0].shape[-1]
    kl = min(k, shard)
    cand = [stable_top_k(p, kl) for p in parts]
    home = score.device
    vals = torch.cat([v.to(home) for v, _ in cand], dim=-1)
    idx = torch.cat([(i + s * shard).to(home)
                     for s, (_, i) in enumerate(cand)], dim=-1)
    v, pos = stable_top_k(vals, k)
    return v, torch.gather(idx, -1, pos)
