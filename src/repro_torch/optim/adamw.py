"""Memory-efficient AdamW with warmup-cosine schedule and global-norm
clipping: the port of ``repro/optim/adamw.py``.

f32 master parameters and moments in ``moment_dtype`` (bf16 by default).
JAX's formula is written out, not ``torch.optim.AdamW``'s, which decays
the weights as ``p * (1 - lr * wd)`` and corrects the bias otherwise.  The
scalars are f32 as in JAX (its python constants are weakly typed): the
schedule, ``b1 ** step`` and the bias corrections are 0-d f32 tensors on
the step's device, and the schedule's divisions by constants are
multiplies by the f32 reciprocal, as XLA compiles them.  The update is
functional: new tensors, the inputs untouched.

Sums are taken in another order than XLA's, so the global norm, the clip
scale and every update agree with JAX within f32 tolerance, not bit for
bit; the leaves are summed in JAX's order (``repro_torch.tree``).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import tree as tr
from repro_torch.models.layers import f32_reciprocal


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    moment_dtype: str = "bfloat16"   # bf16 moments: 4 bytes/param saved


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at integer ``step`` (a 0-d tensor): linear warmup,
    then a cosine down to ``min_lr_ratio * lr``; 0-d f32."""
    step = step.to(torch.float32)
    warm = torch.clamp(step * f32_reciprocal(max(cfg.warmup_steps, 1)),
                       max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) * f32_reciprocal(
        max(cfg.total_steps - cfg.warmup_steps, 1)), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init_opt_state(params, cfg: AdamWConfig):
    """Zero moments shaped as ``params`` in ``moment_dtype``, and ``step``
    0 (0-d int32), on the parameters' device."""
    dt = getattr(torch, cfg.moment_dtype)
    first = tr.leaves(params)[0]
    return {"mu": tr.tree_map(lambda p: torch.zeros_like(p, dtype=dt),
                              params),
            "nu": tr.tree_map(lambda p: torch.zeros_like(p, dtype=dt),
                              params),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum, over the leaves in JAX's order, of each leaf's sum
    of squares in f32 (python's ``sum``, from 0, as JAX's)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tr.leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """``(grads * min(1, max_norm / max(norm, 1e-9)), norm)``.  The
    constant over the norm is a true division (python's ``c / tensor`` in
    torch multiplies by the tensor's reciprocal)."""
    norm = global_norm(grads)
    scale = torch.clamp(torch.full_like(norm, max_norm)
                        / torch.clamp(norm, min=1e-9), max=1.0)
    return tr.tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def apply_updates(params, grads, state, cfg: AdamWConfig):
    """One AdamW step.  params f32 master; grads any float dtype.  Returns
    ``(new_params, {"mu", "nu", "step"})``."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)
    mdt = getattr(torch, cfg.moment_dtype)

    def upd(p, g, mu, nu):
        g = g.float()
        mu_f = b1 * mu.float() + (1 - b1) * g
        nu_f = b2 * nu.float() + (1 - b2) * g * g
        mu_hat = mu_f / bc1
        nu_hat = nu_f / bc2
        delta = mu_hat / (torch.sqrt(nu_hat) + cfg.eps) \
            + cfg.weight_decay * p.float()
        return ((p.float() - lr * delta).to(p.dtype), mu_f.to(mdt),
                nu_f.to(mdt))

    flat_p = tr.leaves(params)
    out = [upd(p, g, m, n) for p, g, m, n in zip(
        flat_p, tr.leaves(grads), tr.leaves(state["mu"]),
        tr.leaves(state["nu"]))]
    new_p = tr.unflatten(params, [o[0] for o in out])
    new_mu = tr.unflatten(params, [o[1] for o in out])
    new_nu = tr.unflatten(params, [o[2] for o in out])
    return new_p, {"mu": new_mu, "nu": new_nu, "step": step}
