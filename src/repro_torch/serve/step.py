"""Serving steps: prefill (parallel forward) and single-token decode (the
port of ``repro/serve/step.py``; the model mesh ``ctx`` is not taken)."""
from __future__ import annotations

import torch


def make_prefill_step(model, q_chunk: int = 1024, k_chunk: int = 1024):
    """prefill(params, batch) -> logits [B, T, V], under
    ``torch.inference_mode()`` (``Model.forward`` records for autograd
    where grad is enabled)."""
    @torch.inference_mode()
    def prefill(params, batch):
        logits, _ = model.forward(params, batch, q_chunk=q_chunk,
                                  k_chunk=k_chunk)
        return logits
    return prefill


def make_decode_step(model):
    """decode(params, tokens [B,1], state) -> (logits [B,1,V], state)."""
    def decode(params, tokens, state):
        return model.decode_step(params, tokens, state)
    return decode


def greedy_sample(logits):
    """The next token of each row, ``[B, 1]`` int32: the first index of the
    largest logit, as ``jnp.argmax`` takes it."""
    return torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
