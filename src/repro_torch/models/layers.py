"""Shared model building blocks in PyTorch: the port of
``repro/models/layers.py`` that the dense transformer uses.

Parameters are f32 (one master copy) and each product casts its weight to
the bf16 compute dtype first, as ``.astype(dt)`` does in JAX.  The
activations are written op by op in bf16, each op rounding to bf16 as the
JAX package's bf16 program does (``jax.nn.silu`` and ``jax.nn.gelu``,
which is the tanh approximation, with their constants rounded to bf16), not
as ``torch.nn.functional``'s fused f32 versions.  ``rms_norm`` and
``apply_rope`` work in f32 and round once, and so does
``cross_entropy``, the training loss.  ``layer_norm`` waits for the
families that use it.
"""
from __future__ import annotations

import math

import numpy as np
import torch

COMPUTE_DTYPE = torch.bfloat16
PARAM_DTYPE = torch.float32


def init_normal(generator: torch.Generator, shape, scale: float):
    """f32 ``N(0, scale^2)`` draws on the generator's device."""
    return torch.randn(shape, generator=generator, dtype=PARAM_DTYPE,
                       device=generator.device) * scale


def f32_reciprocal(n: float) -> float:
    """``f32(1) / f32(n)``: the constant XLA multiplies by where the JAX
    program divides by ``n``."""
    return float(np.float32(1.0) / np.float32(n))


def rms_norm(x, gamma, eps: float):
    xf = x.float()
    # jnp.mean's divide by d, as XLA compiles it
    var = (xf * xf).sum(dim=-1, keepdim=True) * f32_reciprocal(x.shape[-1])
    out = xf * torch.rsqrt(var + eps) * (1.0 + gamma.float())
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x, positions, theta: float):
    """x [..., T, H, D]; positions [..., T] integer (broadcastable)."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)           # [half]
    angles = positions[..., :, None].float() * freqs       # [..., T, half]
    cos = torch.cos(angles)[..., :, None, :]               # [..., T, 1, half]
    sin = torch.sin(angles)[..., :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP variants
# ---------------------------------------------------------------------------
def _silu(x):
    """``jax.nn.silu``: ``x * (1 / (1 + exp(-x)))``, each op rounded to
    x's dtype as JAX's program does, not fused in f32 as
    ``torch.nn.functional.silu``."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


# jax.nn.gelu's constants as its bf16 program holds them (exact in f32, so
# a python-scalar multiply rounds as the bf16-constant one)
_GELU_C = float(torch.tensor(0.044715, dtype=COMPUTE_DTYPE))
_GELU_K = float(torch.tensor(math.sqrt(2.0 / math.pi), dtype=COMPUTE_DTYPE))


def _gelu(x):
    """``jax.nn.gelu`` (tanh approximation) on bf16 ``x``, each op rounded
    to bf16, with its constants in bf16 as the JAX program has them."""
    inner = _GELU_K * (x + _GELU_C * (x * x * x))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def init_mlp(generator, d_model: int, d_ff: int, variant: str):
    s_in, s_ff = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_ff)
    if variant in ("swiglu", "geglu"):
        return {"w_gate": init_normal(generator, (d_model, d_ff), s_in),
                "w_up": init_normal(generator, (d_model, d_ff), s_in),
                "w_down": init_normal(generator, (d_ff, d_model), s_ff)}
    return {"w_up": init_normal(generator, (d_model, d_ff), s_in),
            "w_down": init_normal(generator, (d_ff, d_model), s_ff)}


def apply_mlp(params, x, variant: str):
    dt = x.dtype
    if variant in ("swiglu", "geglu"):
        g = x @ params["w_gate"].to(dt)
        u = x @ params["w_up"].to(dt)
        act = _silu(g) if variant == "swiglu" else _gelu(g)
        return (act * u) @ params["w_down"].to(dt)
    return _gelu(x @ params["w_up"].to(dt)) @ params["w_down"].to(dt)


# ---------------------------------------------------------------------------
# Embedding + LM head
# ---------------------------------------------------------------------------
def init_embedding(generator, vocab: int, d_model: int):
    return init_normal(generator, (vocab, d_model), 1.0)


def embed(table, tokens):
    """Rows of ``table`` for ``tokens`` in the compute dtype (gathered,
    then cast: the values of JAX's cast-then-take)."""
    return table[tokens].to(COMPUTE_DTYPE)


def lm_logits(x, table_or_head):
    """x [B,T,d] @ head [d,V] (or embedding.T when tied)."""
    w = table_or_head.to(x.dtype)
    if w.shape[0] != x.shape[-1]:       # tied embedding [V, d] -> transpose
        w = w.t()
    return x @ w


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------
def cross_entropy(logits, labels, mask=None, z_loss: float = 1e-4):
    """Mean next-token cross entropy with JAX's z-loss, ``nll + z_loss *
    lse**2``, as ``repro/models/layers.py::cross_entropy`` computes it.

    logits [B, T, V] (any float dtype), labels [B, T] integer, mask [B, T]
    or None.  ``lse`` is ``jax.nn.logsumexp``'s: the max held out of the
    gradient, ``log(sum(exp(lg - max))) + max``, in f32.  The correct-class
    logit is a select-and-sum over the vocabulary (no gather, whose CUDA
    backward adds with float atomics).  The unmasked mean multiplies by the
    f32 reciprocal of the count, as XLA compiles ``jnp.mean``'s divide; the
    masked one divides by ``max(sum(mask), 1)``."""
    lg = logits.float()
    amax = lg.amax(dim=-1, keepdim=True).detach()
    amax = torch.where(torch.isfinite(amax), amax, 0.0)
    lse = torch.log(torch.exp(lg - amax).sum(dim=-1)) + amax[..., 0]
    vocab = torch.arange(lg.shape[-1], device=lg.device)
    correct = torch.where(vocab == labels[..., None], lg, 0.0).sum(dim=-1)
    nll = lse - correct
    if z_loss:
        nll = nll + z_loss * lse ** 2
    if mask is None:
        return nll.sum() * f32_reciprocal(nll.numel())
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
