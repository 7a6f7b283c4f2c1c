"""Sketch-based training telemetry: gradient agreement without moving
gradients (the port of ``repro/train/telemetry.py``).

Estimating the pairwise cosine similarity of per-replica gradients
normally costs a full gradient gather.  With the paper's inner-product
sketches it costs ``O(m)`` per replica: each replica sketches its
flattened gradient, an all-gather over the replica axis moves only the
m-sized sketches, and the R^2 pairwise inner products are estimated from
them.

``method="icws"`` (the default) sketches through ``ops.icws_sketch``
(B1, the CUDA ICWS kernel on a CUDA tensor) and estimates through
``ops.icws_estimate`` (B3's pairwise partials); a CPU tensor takes their
plain versions.  ``method="jl"`` is the hash-sign projection JAX computes
as one ``[m, T]`` product outside any kernel; here it runs over chunks of
T, so that no ``[m, T]`` sign matrix exists (1.1 TB at TinyLlama-1.1B's
T), which changes only the order of the sum (f32 tolerance).

The replica axis is a ``torch.distributed`` process group registered by
name (``repro_torch.launch.register_world_axis``, as
``compressed_update`` uses it).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.distributed.sharding import axis_group
from repro_torch.kernels import ops as kops
from repro_torch.kernels.common import JL_STREAM_SIGN, hash_u32, salt_for
from repro_torch.models.layers import f32_reciprocal

# elements of one [m, chunk] sign block of the JL projection
_JL_BLOCK = 1 << 22


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    m: int = 256                  # sketch size (per replica)
    seed: int = 23
    method: str = "icws"          # icws (weighted minhash) | jl


def _jl_project(flat_grad: torch.Tensor, cfg: TelemetryConfig):
    """``sign @ flat_grad`` with ``sign[t, i] = +1`` where the JL sign hash
    of (i, t) is even, else -1, a block of T at a time."""
    T = flat_grad.shape[0]
    dev = flat_grad.device
    salts = salt_for(cfg.seed, JL_STREAM_SIGN,
                     torch.arange(cfg.m, dtype=torch.int64, device=dev))
    chunk = max(1, _JL_BLOCK // cfg.m)
    proj = torch.zeros(cfg.m, dtype=torch.float32, device=dev)
    for lo in range(0, T, chunk):
        idx = torch.arange(lo, min(T, lo + chunk), dtype=torch.int64,
                           device=dev)
        sign = torch.where((hash_u32(idx[None, :], salts[:, None]) & 1) == 0,
                           1.0, -1.0)
        proj = proj + sign @ flat_grad[lo:lo + chunk].float()
    return proj


def sketch_gradient(flat_grad: torch.Tensor, cfg: TelemetryConfig):
    """``[T]`` gradient -> sketch dict; a ``[R, T]`` stack sketches each
    row (one kernel launch for all R) and gives leaves with a leading R.

    icws: ``{"fp", "val" [m] (or [R, m]), "norm"}`` -- the unit vector
    ``zn = g / max(||g||, 1e-30)`` sketched with weights ``zn^2`` and keys
    ``0..T-1`` (B1 takes at most 2^31 - 1 a row); jl: ``{"proj"
    [m]}``."""
    rows = flat_grad if flat_grad.dim() == 2 else flat_grad[None]
    if cfg.method == "jl":
        # JAX's ``/ jnp.sqrt(m)``, a constant: XLA multiplies by its
        # f32 reciprocal
        proj = torch.stack([_jl_project(g, cfg) for g in rows]) \
            * f32_reciprocal(math.sqrt(cfg.m))
        return {"proj": proj if flat_grad.dim() == 2 else proj[0]}
    norm = torch.linalg.vector_norm(rows, dim=-1)
    zn = rows / torch.clamp(norm, min=1e-30)[:, None]
    keys = torch.arange(rows.shape[1], dtype=torch.int32,
                        device=rows.device).expand_as(rows).contiguous()
    fp, val, _, _ = kops.icws_sketch(zn * zn, keys, zn, m=cfg.m,
                                     seed=cfg.seed)
    if flat_grad.dim() == 1:
        return {"fp": fp[0], "val": val[0], "norm": norm[0]}
    return {"fp": fp, "val": val, "norm": norm}


def estimate_pairwise(sketches, cfg: TelemetryConfig) -> torch.Tensor:
    """Stacked sketches (leaves with leading replica dim R) -> ``[R, R]``
    inner product estimates."""
    if cfg.method == "jl":
        proj = sketches["proj"]                       # [R, m]
        return proj @ proj.T
    fp, val, norm = sketches["fp"], sketches["val"], sketches["norm"]
    R = fp.shape[0]
    est = kops.icws_estimate(fp.repeat_interleave(R, dim=0),
                             val.repeat_interleave(R, dim=0),
                             norm.repeat_interleave(R),
                             fp.repeat(R, 1), val.repeat(R, 1),
                             norm.repeat(R))
    return est.reshape(R, R)


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """``jax.lax.all_gather``: every rank's ``x`` stacked in rank order."""
    parts = [torch.empty_like(x) for _ in range(
        torch.distributed.get_world_size(group))]
    torch.distributed.all_gather(parts, x.contiguous(), group=group)
    return torch.stack(parts)


def gradient_agreement(flat_grad: torch.Tensor, axis_name: str,
                       cfg: TelemetryConfig) -> torch.Tensor:
    """On each rank of the replica axis ``axis_name``: the ``[R, R]``
    cosine-similarity estimate of the R ranks' gradients.

    Only the m-sized sketches cross the axis (all-gather), never
    gradients."""
    group = axis_group(axis_name)
    sk = sketch_gradient(flat_grad, cfg)
    gathered = {k: _all_gather(v, group) for k, v in sk.items()}
    est = estimate_pairwise(gathered, cfg)
    if cfg.method == "jl":
        return est
    norms = gathered["norm"]
    denom = torch.outer(norms, norms)
    return est / torch.clamp(denom, min=1e-30)
