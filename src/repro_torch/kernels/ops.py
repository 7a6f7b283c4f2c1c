"""Device-dispatching launch layer (the port's ``repro/kernels/ops.py``).

Every op picks its implementation from the device its tensors lie on: a
CPU tensor takes the plain PyTorch version, a CUDA tensor launches the
hand-written kernel -- or raises, if the kernel does not build or its
launch is refused.  There is no fallback from the kernel to the plain
version.  Launch counts live on the kernel wrappers
(``icws_sketch_cuda.launches``, ``estimate_fields_cuda.launches``,
``countsketch_sparse_cuda.launches``, ``jl_sketch_cuda.launches``,
``linear_estimate_fields_cuda.launches``, ``dmh_sketch_cuda.launches``,
``sample_estimate_fields_cuda.launches``).
"""
from __future__ import annotations

from typing import Sequence

import torch

from .countsketch import countsketch_sparse_cuda, countsketch_sparse_plain
from .dmh_sketch import dmh_sketch_cuda, dmh_sketch_plain
from .estimate import (estimate_fields_cuda, estimate_fields_plain,
                       linear_estimate_fields_cuda,
                       linear_estimate_fields_plain)
from .icws_sketch import icws_sketch_cuda, icws_sketch_plain
from .jl_sketch import jl_sketch_cuda, jl_sketch_plain
from .sample_estimate import (sample_estimate_fields_cuda,
                              sample_estimate_fields_plain,
                              sample_inclusion_probs)


def _route(x: torch.Tensor, plain, kernel):
    if x.device.type == "cpu":
        return plain
    if x.device.type == "cuda":
        return kernel
    raise ValueError(f"no kernel for device {x.device}")


def icws_sketch(w, keys, vals, *, m: int, seed: int = 0):
    """ICWS sketch of a padded sparse batch.
    [B, N] -> (fp, val, amin, argkey) [B, m]."""
    fn = _route(w, icws_sketch_plain, icws_sketch_cuda)
    return fn(w, keys, vals, m=m, seed=seed)


def dmh_sketch(w, keys, vals, *, m: int, seed: int = 0):
    """DMH sketch of a padded (replicated) sparse batch, in the ICWS wire
    layout.  [B, N] -> (fp, val, amin, argkey) [B, m]."""
    fn = _route(w, dmh_sketch_plain, dmh_sketch_cuda)
    return fn(w, keys, vals, m=m, seed=seed)


def estimate_partials_fields(fq, vq, fpc, vc, *, qmap: Sequence[int],
                             cmap: Sequence[int]):
    """Fused multi-field partial sums: one launch for all field pairs."""
    fn = _route(fq, estimate_fields_plain, estimate_fields_cuda)
    return fn(fq, vq, fpc, vc, qmap=qmap, cmap=cmap)


def icws_estimate_fields(fq, vq, nq, fpc, vc, nc, *, qmap: Sequence[int],
                         cmap: Sequence[int]):
    """Fused multi-field ICWS inner-product estimates, ONE kernel launch.

    Args: fq/vq [F, Q, m] per-field queries, nq [F, Q] norms; fpc/vc
    [C, P, m] per-field corpus, nc [C, P] norms.  Returns [G, Q, P] f32:
    the partials, then the ``m~ = 2 / (1 + j^)`` norm epilogue, with zero
    where either norm is zero.
    """
    m = fpc.shape[2]
    cnt, sw = estimate_partials_fields(fq, vq, fpc, vc, qmap=qmap, cmap=cmap)
    j_hat = cnt / m
    m_tilde = 2.0 / (1.0 + j_hat)
    nqg = torch.stack([nq[qf] for qf in qmap])[:, :, None]    # [G, Q, 1]
    ncg = torch.stack([nc[cf] for cf in cmap])[:, None, :]    # [G, 1, P]
    est = nqg * ncg * (m_tilde / m) * sw
    return torch.where((nqg == 0) | (ncg == 0), 0.0, est)


def countsketch_sparse(keys, vals, *, width: int, reps: int = 5,
                       seed: int = 0):
    """CountSketch of a padded sparse batch.  [B, N] -> [B, reps, width]."""
    fn = _route(keys, countsketch_sparse_plain, countsketch_sparse_cuda)
    return fn(keys, vals, width=width, reps=reps, seed=seed)


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


def sample_estimate_fields(kq, vq, tq, kc, vc, tc, *, qmap: Sequence[int],
                           cmap: Sequence[int]):
    """Fused multi-field sampling-sketch (TS/PS) estimates, ONE kernel launch.

    Args: kq/vq [F, Q, S] per-field query sample keys/values, tq [F, Q]
    probability scales; kc/vc [C, P, S] / tc [C, P] the corpus samples.
    Returns [G, Q, P] f32 inverse-inclusion-probability estimates.  The
    prologue reconstructs both sides' probabilities ``min(1, S v^2 / tau)``
    elementwise (the stored layout stays (key, val, tau)); the key-match
    launch follows.
    """
    aq = sample_inclusion_probs(vq, tq)
    ac = sample_inclusion_probs(vc, tc)
    fn = _route(kq, sample_estimate_fields_plain, sample_estimate_fields_cuda)
    return fn(kq, vq, aq, kc, vc, ac, qmap=qmap, cmap=cmap)
