"""bf16-halfword codec of the packed corpus layout (port of
``repro.kernels.packed``): two f32 samples per i32 word,

    word k = bf16(x[2k]) | bf16(x[2k+1]) << 16

where ``bf16(x)`` truncates (the top 16 bits of the f32: sign, exponent,
seven mantissa bits) rather than rounds, so the decode is exact and the
codec idempotent (``pack(unpack(w)) == w`` for every word); zero packs to
the zero word.  Plain torch on int32 bit views, on any device; the CUDA
kernels decode with ``csrc/packed.cuh``.  torch's ``>>`` on int32 is
arithmetic, so every right shift is masked after.
"""
from __future__ import annotations

import torch

from .common import BIG

_HIGH = -0x10000            # 0xFFFF0000 as an int32


def packed_width(n: int) -> int:
    """i32 words needed for ``n`` halfword samples (rounds up)."""
    return (int(n) + 1) // 2


def pack_halfwords_f32(x: torch.Tensor) -> torch.Tensor:
    """``[..., 2k]`` f32 -> ``[..., k]`` i32; the even sample lands in the
    low halfword.  Raises on an odd last dimension (callers pad one zero
    sample first)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    if x.shape[-1] % 2:
        raise ValueError(f"pack_halfwords_f32 needs an even last dim; got "
                         f"{tuple(x.shape)}")
    bits = x.contiguous().view(torch.int32)
    pairs = bits.reshape(x.shape[:-1] + (x.shape[-1] // 2, 2))
    return ((pairs[..., 0] >> 16) & 0xFFFF) | (pairs[..., 1] & _HIGH)


def unpack_halfwords_f32(w: torch.Tensor) -> torch.Tensor:
    """``[..., k]`` i32 -> ``[..., 2k]`` f32, the exact inverse: each
    halfword becomes the f32 whose top 16 bits it holds."""
    w = torch.as_tensor(w, dtype=torch.int32)
    low = (w & 0xFFFF).to(torch.int64) << 16       # in [0, 2^32)
    even = (low - ((low & 0x80000000) << 1)).to(torch.int32)
    out = torch.stack([even, w & _HIGH], dim=-1)
    return out.reshape(w.shape[:-1] + (2 * w.shape[-1],)).view(torch.float32)


def pack_sketch_vals(val: torch.Tensor, amin: torch.Tensor) -> torch.Tensor:
    """The sketch kernels' ``pack_vals`` plane: ``val [B, m]`` with empty
    rows (``amin >= BIG``) zeroed, one zero sample appended when m is odd,
    packed -> ``[B, (m + m % 2) // 2]`` i32 (what ``pack_rows`` stores)."""
    v = torch.where(amin >= BIG, 0.0, val)
    if v.shape[-1] % 2:
        v = torch.nn.functional.pad(v, (0, 1))
    return pack_halfwords_f32(v)
