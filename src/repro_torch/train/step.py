"""Training step factory: microbatched gradient accumulation, remat,
AdamW (the port of ``repro/train/step.py``; the model mesh ``ctx`` and
``param_logical`` belong to the sharded model, ROADMAP.md Queue A 18c).

``batch`` leaves are ``[M, B/M, ...]`` tensors on the model's device
(M = microbatches; M = 1 supported).  Each micro-batch's gradients come
from ``torch.autograd.grad`` of ``Model.loss`` (every block recomputed in
the backward, as under ``jax.checkpoint``); for M > 1 they add up in
``accum_dtype`` in micro-batch order from zero, as JAX's ``lax.scan``, and
are multiplied by the f32 reciprocal of M, as XLA compiles JAX's ``/ M``.
Then global-norm clipping and the AdamW update.

Every accumulation is deterministic on the card: the loss selects the
correct logit (no gather) and the embedding's backward is the sorted
``index_put`` (no float atomics), so two runs from one state give the same
bits.
"""
from __future__ import annotations

import torch

from repro_torch import tree as tr
from repro_torch.models.layers import f32_reciprocal
from repro_torch.optim import adamw


def loss_and_grads(model, params, batch, q_chunk: int = 1024,
                   k_chunk: int = 1024, aux_weight: float = 0.01):
    """``(loss, grads)`` of ``Model.loss`` on one micro-batch: the loss
    detached, the gradients a tree shaped as ``params`` (the counterpart of
    ``jax.value_and_grad``); ``params`` itself records nothing."""
    flat = [p.detach().requires_grad_() for p in tr.leaves(params)]
    with torch.enable_grad():
        loss, _ = model.loss(tr.unflatten(params, flat), batch,
                             q_chunk=q_chunk, k_chunk=k_chunk,
                             aux_weight=aux_weight)
        grads = torch.autograd.grad(loss, flat)
    return loss.detach(), tr.unflatten(params, grads)


def make_train_step(model, opt_cfg: adamw.AdamWConfig,
                    q_chunk: int = 1024, k_chunk: int = 1024,
                    aux_weight: float = 0.01,
                    accum_dtype: torch.dtype = torch.float32):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; metrics are 0-d tensors ``loss``, ``grad_norm``, ``lr`` and
    ``step``."""

    def one_micro(params, mb):
        return loss_and_grads(model, params, mb, q_chunk, k_chunk, aux_weight)

    def train_step(params, opt_state, batch):
        M = tr.leaves(batch)[0].shape[0]
        if M == 1:
            loss, grads = one_micro(params, {k: v[0] for k, v in
                                             batch.items()})
        else:
            g_acc = tr.tree_map(lambda p: torch.zeros_like(
                p, dtype=accum_dtype), params)
            l_acc = torch.zeros((), dtype=torch.float32,
                                device=tr.leaves(params)[0].device)
            for i in range(M):
                loss, grads = one_micro(params, {k: v[i] for k, v in
                                                 batch.items()})
                g_acc = tr.tree_map(lambda a, g: a + g.to(accum_dtype),
                                    g_acc, grads)
                l_acc = l_acc + loss
            inv = f32_reciprocal(M)
            grads = tr.tree_map(lambda g: g * inv, g_acc)
            loss = l_acc * inv
        grads, gnorm = adamw.clip_by_global_norm(grads, opt_cfg.clip_norm)
        new_params, new_opt = adamw.apply_updates(params, grads, opt_state,
                                                  opt_cfg)
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "lr": adamw.schedule(opt_cfg, new_opt["step"]),
                   "step": new_opt["step"]}
        return new_params, new_opt, metrics

    return train_step


def make_eval_step(model, q_chunk: int = 1024, k_chunk: int = 1024):
    """``eval_step(params, batch) -> {"loss", "ce", "aux"}``, no grad."""
    @torch.no_grad()
    def eval_step(params, batch):
        loss, parts = model.loss(params, batch, q_chunk=q_chunk,
                                 k_chunk=k_chunk)
        return {"loss": loss, **parts}
    return eval_step
