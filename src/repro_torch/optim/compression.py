"""Sketch-based gradient compression with error feedback (the port's
``repro/optim/compression.py``).

A gradient is compressed to a ``reps x width`` CountSketch table (linear,
so replicas could add tables instead of gradients), decoded with the
median-of-reps point query, and the part not applied is kept as an error-
feedback residual.  Everything runs on the device of the gradient: the
sketch goes through :func:`repro_torch.kernels.ops.countsketch`, which
launches the CUDA kernel on a CUDA tensor and takes the plain version on a
CPU tensor.  ``use_kernel`` is kept field for field with the JAX package's
config, where it picks the Pallas kernel over the jnp reference; here the
device of the tensor decides, and both settings take the same route.

``compressed_update(axis_name=...)`` is the data-parallel form: where the
JAX package runs it once per replica under ``shard_map`` and ``pmean``s
the table and then the masked values over the named axis, here each
replica is a process and both means are ``torch.distributed.all_reduce``
sums over the process group registered under the name
(:func:`repro_torch.distributed.sharding.register_axis`; gloo for CPU
tensors, NCCL for CUDA tensors), divided by the group's size.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.distributed.sharding import axis_group
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    width: int = 4096            # table width per repetition
    reps: int = 5
    seed: int = 17
    use_kernel: bool = False     # the JAX package's field; the device decides
    residual_decay: float = 0.9  # EF memory decay: bounds stale-flush energy


def _sqrt_f32(n: int) -> torch.Tensor:
    return torch.sqrt(torch.tensor(float(n), dtype=torch.float32))


def compress(flat_grad: torch.Tensor, cfg: CompressionConfig) -> torch.Tensor:
    """[T] f32 -> [reps, width] CountSketch table (the u32 contract of the
    served CountSketch rows, so a gradient table can be estimated against
    one)."""
    return ops.countsketch(flat_grad, width=cfg.width, reps=cfg.reps,
                           seed=cfg.seed)


def decompress(table: torch.Tensor, n: int,
               cfg: CompressionConfig) -> torch.Tensor:
    """[reps, width] -> [n] median-of-reps estimates (a gather, with no
    kernel in either package)."""
    indices = torch.arange(n, dtype=torch.int64, device=table.device)
    return ops.countsketch_decode(table, indices, seed=cfg.seed)


def ef_decode(table: torch.Tensor, n: int, cfg: CompressionConfig,
              norm_bound: torch.Tensor, noise_mult: float = 2.0) -> torch.Tensor:
    """Noise-thresholded decode (FetchSGD's extraction rule): keep only
    estimates at or above ``tau = noise_mult * norm_bound / sqrt(width)``,
    then clip the result's norm to ``norm_bound``."""
    est = decompress(table, n, cfg)
    tau = noise_mult * norm_bound / _sqrt_f32(cfg.width)
    est = torch.where(est.abs() >= tau, est, 0.0)
    norm = torch.linalg.vector_norm(est)
    scale = torch.clamp(norm_bound / torch.clamp(norm, min=1e-30), max=1.0)
    return est * scale


def _pmean(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """``jax.lax.pmean`` over the replica axis ``axis_name``: the sum over
    its process group, divided by the group's size as a 0-d f32 tensor
    filled on ``x``'s device (a python scalar would divide by a reciprocal
    multiply on CUDA; a tensor copied from the host would sync)."""
    group = axis_group(axis_name)
    total = x.clone()
    torch.distributed.all_reduce(total, op=torch.distributed.ReduceOp.SUM,
                                 group=group)
    n = torch.distributed.get_world_size(group)
    return total / x.new_full((), float(n))


def compressed_update(flat_grad: torch.Tensor, residual: torch.Tensor,
                      axis_name: Optional[str], cfg: CompressionConfig,
                      lr: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback compressed update (the classical EF-SGD form)::

        p_t     = residual_t + lr * grad_t
        Delta_t = p_t on the coordinates the sketch names heavy (est at or
                  above tau = 2 ||p|| / sqrt(width), or among the width // 2
                  largest |est|), clipped per coordinate to 3 * lr * (|g| +
                  ||g|| / sqrt(T))
        res_t+1 = residual_decay * (p_t - Delta_t)

    With ``axis_name`` the table is averaged over the replicas before the
    decode, and so are the masked exact values, kept where this replica's
    mask holds.  Returns (Delta [T] to subtract from the parameters, the
    new residual [T])."""
    p = residual + lr * flat_grad
    table = compress(p, cfg)
    if axis_name is not None:
        table = _pmean(table, axis_name)        # all-reduce in sketch space
    est = decompress(table, p.shape[0], cfg).abs()
    tau = 2.0 * torch.linalg.vector_norm(p) / _sqrt_f32(cfg.width)
    kth = torch.topk(est, max(1, cfg.width // 2)).values[-1]
    # the threshold picks well-identified heavy hitters; the top-k fallback
    # guarantees progress; the values applied are exact, not estimated
    mask = (est >= tau) | (est >= kth)
    delta = torch.where(mask, p, 0.0)
    if axis_name is not None:
        delta = torch.where(mask, _pmean(delta, axis_name), 0.0)
    g_scale = flat_grad.abs() + torch.linalg.vector_norm(flat_grad) \
        / _sqrt_f32(flat_grad.shape[0])
    cap = 3.0 * lr * g_scale
    delta = torch.minimum(torch.maximum(delta, -cap), cap)
    return delta, cfg.residual_decay * (p - delta)


# the JAX package's alias of compressed_update
compressed_psum = compressed_update


def compression_ratio(n_params: int, cfg: CompressionConfig) -> float:
    return n_params / float(cfg.width * cfg.reps)
