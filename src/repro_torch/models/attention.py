"""Chunked (flash-style) attention in plain PyTorch: the port's copy of
``repro/models/attention.py::chunked_attention``, the oracle that the
flash-attention kernel is held against.

Kept as the JAX package computes it: scores accumulate in f32 (bf16 inputs
are widened before each product, which is exact), ``* scale`` comes after
the q k^T product, masked scores are ``NEG = -1e30`` (not -inf), the
running max starts at -inf, and with bf16 inputs ``p`` is cast to the value
dtype before the p v product.  Run it with TF32 off on a card
(``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default).
"""
from __future__ import annotations

import math

import torch

NEG = -1e30


def _pick_chunk(n: int, target: int) -> int:
    """Largest divisor of n that is <= target (falls back to n)."""
    if n <= target:
        return n
    for c in range(target, 0, -1):
        if n % c == 0:
            return c
    return n


def chunked_attention(q, k, v, *, causal: bool, window: int = 0,
                      q_offset: int = 0, k_offset: int = 0,
                      q_chunk: int = 1024, k_chunk: int = 1024):
    """q [B,Tq,H,D], k/v [B,S,K,D] (GQA: H = K*G).  Returns [B,Tq,H,D] in
    q's dtype.  Online softmax over key chunks inside a loop over query
    chunks; ``window > 0`` masks keys older than ``window``."""
    B, Tq, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    qc = _pick_chunk(Tq, q_chunk)
    kc = _pick_chunk(S, k_chunk)
    nq, nk = Tq // qc, S // kc
    dev = q.device
    scale = 1.0 / math.sqrt(D)
    q_r = q.reshape(B, nq, qc, K, G, D).permute(1, 0, 3, 4, 2, 5)  # [nq,B,K,G,qc,D]
    k_r = k.reshape(B, nk, kc, K, D).permute(1, 0, 3, 2, 4)        # [nk,B,K,kc,D]
    v_r = v.reshape(B, nk, kc, K, D).permute(1, 0, 3, 2, 4)
    outs = []
    for qi in range(nq):
        q_blk = q_r[qi].float()
        q_pos = q_offset + qi * qc + torch.arange(qc, device=dev)
        m = torch.full((B, K, G, qc), -math.inf, device=dev)
        l = torch.zeros((B, K, G, qc), device=dev)
        acc = torch.zeros((B, K, G, qc, D), device=dev)
        for ki in range(nk):
            k_blk, v_blk = k_r[ki], v_r[ki]
            k_pos = k_offset + ki * kc + torch.arange(kc, device=dev)
            s = torch.einsum("bkgqd,bkcd->bkgqc", q_blk, k_blk.float()) * scale
            mask = torch.ones((qc, kc), dtype=torch.bool, device=dev)
            if causal:
                mask &= k_pos[None, :] <= q_pos[:, None]
            if window:
                mask &= k_pos[None, :] > q_pos[:, None] - window
            s = torch.where(mask, s, NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqc,bkcd->bkgqd", p.to(v_blk.dtype).float(),
                              v_blk.float())
            acc = acc * corr[..., None] + pv
            m = m_new
        outs.append((acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype))
    out = torch.stack(outs)                                         # [nq,B,K,G,qc,D]
    return out.permute(1, 0, 4, 2, 3, 5).reshape(B, Tq, H, D)
