"""Attention in plain PyTorch, the port of ``repro/models/attention.py``:
GQA projections, the chunked (flash-style) training/prefill path and
single-token decode over a full or circular (sliding-window) KV cache.
``chunked_attention`` is also the oracle that the flash-attention kernel
is held against.

Kept as the JAX package computes it: scores accumulate in f32 (bf16 inputs
are widened before each product, which is exact), ``* scale`` comes after
the q k^T product, masked scores are ``NEG = -1e30`` (not -inf), the
running max starts at -inf, and with bf16 inputs ``p`` is cast to the value
dtype before the p v product.  Run it with TF32 off on a card
(``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default).
Decode's two products widen their bf16 inputs to f32 the same way, and its
``1 / sqrt(hd)`` is the multiply by an f32 reciprocal that XLA compiles
JAX's division into (``_scale_scores``).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .layers import COMPUTE_DTYPE, apply_rope, f32_reciprocal, init_normal

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


def init_attention(generator, cfg):
    d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = 1.0 / math.sqrt(d)
    return {"wq": init_normal(generator, (d, H, hd), s),
            "wk": init_normal(generator, (d, K, hd), s),
            "wv": init_normal(generator, (d, K, hd), s),
            "wo": init_normal(generator, (H, hd, d), 1.0 / math.sqrt(H * hd))}


def _project_qkv(params, x, cfg, positions):
    dt = x.dtype
    q = torch.einsum("btd,dhk->bthk", x, params["wq"].to(dt))
    k = torch.einsum("btd,dhk->bthk", x, params["wk"].to(dt))
    v = torch.einsum("btd,dhk->bthk", x, params["wv"].to(dt))
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _merge_heads(params, o, dt):
    return torch.einsum("bthk,hkd->btd", o, params["wo"].to(dt))


def attention_block(params, x, cfg, *, q_chunk: int = 1024,
                    k_chunk: int = 1024):
    """Full training/prefill self-attention sublayer (pre-norm done by
    the caller), at positions 0..T-1."""
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    q, k, v = _project_qkv(params, x, cfg, positions)
    o = chunked_attention(q, k, v, causal=True, window=cfg.sliding_window,
                          q_chunk=q_chunk, k_chunk=k_chunk)
    return _merge_heads(params, o, x.dtype)


# ---------------------------------------------------------------------------
# Decode (single token) with full or circular KV cache
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CacheLayout:
    size: int          # slots (max_seq for full, window for SWA)
    windowed: bool


def cache_layout(cfg, max_seq: int) -> CacheLayout:
    if cfg.sliding_window and cfg.sliding_window < max_seq:
        return CacheLayout(size=cfg.sliding_window, windowed=True)
    return CacheLayout(size=max_seq, windowed=False)


def init_kv_cache(cfg, layers: int, batch: int, layout: CacheLayout,
                  device):
    shape = (layers, batch, layout.size, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device),
            "v": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device)}


def cache_slot(pos, layout: CacheLayout):
    """The cache slot of global position ``pos`` (a 0-d tensor)."""
    return pos % layout.size if layout.windowed else pos


def _scale_scores(s, hd: int):
    """JAX's ``s / np.sqrt(hd)`` as its jitted program computes it: XLA
    folds a division by a constant into a multiply by the constant's f32
    reciprocal, ``f32(1) / f32(sqrt(hd))``.  A multiply by a python scalar
    rounds alike on the CPU and the card (only a division by one becomes a
    reciprocal multiply on CUDA), so the card gives the CPU's bits."""
    return s * f32_reciprocal(math.sqrt(hd))


def decode_attention(params, x, cfg, layer_k, layer_v, slot_pos, pos,
                     layout: CacheLayout):
    """One-token attention.  x [B,1,d]; layer_k/v [B,S,K,hd]; pos a 0-d
    integer tensor on x's device.

    Returns (out [B,1,d], layer_k, layer_v), the new key and value written
    into ``layer_k``/``layer_v`` in place at ``pos``'s slot, clamped to the
    last slot as ``lax.dynamic_update_slice`` clamps.  ``slot_pos [S]``
    holds the global position stored in each slot (-1 = empty) and is
    maintained by the caller (shared across layers).
    """
    B = x.shape[0]
    dt = x.dtype
    positions = pos.expand(B, 1)
    q, k_new, v_new = _project_qkv(params, x, cfg, positions)

    slot = cache_slot(pos, layout).clamp(max=layer_k.shape[1] - 1)
    slot = slot.view(1).long()
    layer_k.index_copy_(1, slot, k_new)
    layer_v.index_copy_(1, slot, v_new)

    K, hd = cfg.num_kv_heads, cfg.head_dim
    G = cfg.num_heads // K
    qr = q.reshape(B, K, G, hd)
    s = _scale_scores(torch.einsum("bkgd,bskd->bkgs", qr.float(),
                                   layer_k.float()), hd)
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if layout.windowed:
        valid &= slot_pos > pos - layout.size
    s = torch.where(valid, s, NEG)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(dt).float(), layer_v.float())
    o = o.reshape(B, 1, K * G, hd)
    out = _merge_heads(params, o.to(dt), dt)
    return out, layer_k, layer_v
