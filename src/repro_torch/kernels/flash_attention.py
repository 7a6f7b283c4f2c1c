"""Forward flash attention: CUDA kernels and plain twin.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::_flash_kernel``
(launcher ``flash_attention_pallas``, model-layout wrapper
``flash_attention``).  Contract of :func:`flash_attention_bh`::

    q [BH, T, D], k/v [BH // group, S, D], f32 or bf16 -> o [BH, T, D]

in the input dtype, q head ``bh`` reading kv head ``bh // group``.  Per
row, as the TPU kernel computes it: q scaled by ``1/sqrt(D)`` in f32
*before* the q k^T product, masked scores ``-1e30`` (causal ``k_pos <=
q_pos``, window ``k_pos > q_pos - window``, positions ``q_offset + t`` and
``k_offset + s``), an online softmax over key chunks from a running max of
-inf, all math in f32, and ``acc / max(l, 1e-30)``.  A row that sees no
key returns the mean of v, not NaN.  ``qc``/``kc`` must divide T/S as the
TPU launcher asserts; the plain twin chunks by them, the CUDA kernels by
their own tiles (64 to 256 query rows, 32 or 64 keys), so they agree to f32
tolerance, as the JAX package's block-size invariance test holds different
chunkings.  Head dims 1..256.

The CUDA launcher (``csrc/flash_attention.cu``) routes by dtype alone
(:func:`kernel_route`) to one of two kernels, both on the tensor cores and
both at every head dim up to 256:

- f32 (every D up to 256): ``flash_attention_f32tc_kernel``, on the tensor
  cores.  ``q * (1/sqrt(D))`` in f32, then q·scale, k and v each split
  into three bf16 parts, ``b0 = bf16(x)``, ``b1 = bf16(x - b0)``, ``b2 =
  bf16(x - b0 - b1)`` (for normal values the parts sum to x exactly);
  ``s`` is the sum of the six part-products b0c0, b0c1, b1c0, b0c2, b1c1,
  b2c0 in f32 accumulators; the f32 mask and online softmax as above; p
  split into three parts the same way and ``acc = acc corr + `` the six
  part-products of p and v; ``l`` sums the f32 p.  Within f32 rounding of
  the function above: the f32 gate of 5e-5 holds, where one TF32 pass or
  a two-part split of ``q k^T`` (at larger logits) breaks it
  (``tests/test_torch_flash_attention.py``).  Past D = 128 (head dims
  padded to 256 with zeros) the block's two warpgroups split the head
  dim: each computes the partial ``s`` over its 128 dims, both form ``s_0
  + s_1`` from shared memory (the same bits in both), and each writes its
  half of the output, over key tiles of 32.
- bf16: ``flash_attention_tc_kernel``: ``s = (q k^T) * (1/sqrt(D))``, the
  bf16 products exact in f32 and summed in f32, then scaled; and ``acc =
  acc corr + p_hi v + p_lo v`` with ``p_hi = bf16(p)`` and ``p_lo = bf16(p
  - p_hi)`` (``l`` sums the f32 ``p``).  A single bf16 cast of ``p`` would
  move the output by more than one bf16 rounding step; the split stays
  within it (rtol 2^-7, atol 1e-5).  Head dims are padded with zeros to DP
  = 16, 32, 64, 128 or 256 inside the kernel (exact zeros in ``q k^T``,
  output columns never stored).  Where ``D % 8 == 0`` TMA lands the tiles
  (:func:`tma_loads`); elsewhere (D = 28) the kernel's threads read the
  rows value by value into the same shared layout, and take inputs at any
  alignment.

Every kernel sums in an order fixed by its tiles: a head gives the same
bits alone or in a batch, and repeated runs the same bits.
"""
from __future__ import annotations

import math

import torch

from . import build
from .ops import _route

NEG = -1e30
MAX_HEAD_DIM = 256


def _check_inputs(q, k, v, group: int, qc: int, kc: int):
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"flash attention takes q [BH, T, D] and k/v "
                         f"[BH // group, S, D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k and v must share one dtype, f32 or bf16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError("q, k and v must lie on one device")
    BH, T, D = q.shape
    S = k.shape[1]
    if group < 1 or BH % group or k.shape[0] != BH // group or k.shape[2] != D:
        raise ValueError(f"k/v must be [BH // group, S, D] = [{BH} // "
                         f"{group}, S, {D}]; got {tuple(k.shape)}")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D} is outside 1..{MAX_HEAD_DIM}")
    if T < 1 or S < 1 or T % min(qc, T) or S % min(kc, S):
        raise ValueError(f"qc={qc} and kc={kc} must divide T={T} and S={S}")
    return BH, T, S, D


F32_TC_KERNEL = "flash_attention_f32tc_kernel"
BF16_TC_KERNEL = "flash_attention_tc_kernel"


def kernel_route(dtype, D: int) -> str:
    """The kernel the CUDA launcher runs for inputs of ``dtype`` with head
    dim ``D`` (the launcher's rule, ``launch_flash_attention``)."""
    return F32_TC_KERNEL if dtype == torch.float32 else BF16_TC_KERNEL


def tma_loads(dtype, D: int) -> bool:
    """Whether the bf16 kernel's tiles arrive by TMA (a row is whole
    16-byte chunks) rather than value by value."""
    return dtype == torch.bfloat16 and D % 8 == 0


def flash_attention_plain(q, k, v, *, group: int = 1, causal: bool = True,
                          window: int = 0, qc: int = 512, kc: int = 512,
                          q_offset: int = 0, k_offset: int = 0):
    """Eager-PyTorch flash attention in the TPU kernel's arithmetic: per
    query chunk of ``qc`` rows, the online softmax over key chunks of
    ``kc``.  Run it with TF32 off on a card."""
    BH, T, S, D = _check_inputs(q, k, v, group, qc, kc)
    qc, kc = min(qc, T), min(kc, S)
    dev = q.device
    scale = 1.0 / (D ** 0.5)
    heads = torch.arange(BH, device=dev) // group
    out = torch.empty_like(q)
    for q0 in range(0, T, qc):
        qs = q[:, q0:q0 + qc].float() * scale
        q_pos = q_offset + q0 + torch.arange(qc, device=dev)
        m = torch.full((BH, qc), -math.inf, device=dev)
        l = torch.zeros((BH, qc), device=dev)
        acc = torch.zeros((BH, qc, D), device=dev)
        for k0 in range(0, S, kc):
            kb = k[heads, k0:k0 + kc].float()
            vb = v[heads, k0:k0 + kc].float()
            s = torch.matmul(qs, kb.transpose(1, 2))
            k_pos = k_offset + k0 + torch.arange(kc, device=dev)
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
            acc = acc * corr[..., None] + torch.matmul(p, vb)
            m = m_new
        out[:, q0:q0 + qc] = (acc / torch.clamp(l, min=1e-30)[..., None]
                              ).to(q.dtype)
    return out


def flash_attention_cuda(q, k, v, *, group: int = 1, causal: bool = True,
                         window: int = 0, qc: int = 512, kc: int = 512,
                         q_offset: int = 0, k_offset: int = 0):
    """Launch the CUDA flash-attention kernel on PyTorch's current stream.

    Takes CUDA tensors only and raises on anything else.  Adds one to
    ``flash_attention_cuda.launches`` per launch, to ``.tc_launches`` per
    launch of the bf16 tensor-core kernel and to ``.f32tc_launches`` per
    launch of the f32 one (:func:`kernel_route`)."""
    BH, T, S, D = _check_inputs(q, k, v, group, qc, kc)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda takes CUDA tensors; got "
                         f"{q.device}")
    # TMA and the f32 kernel's vector loads copy 16-byte chunks: a view that
    # starts off that alignment is copied to fresh (aligned) memory; the
    # bf16 kernel's by-value loads take any alignment
    by_value = q.dtype == torch.bfloat16 and not tma_loads(q.dtype, D)
    q, k, v = (t if by_value or t.data_ptr() % 16 == 0 else t.clone()
               for t in (q.contiguous(), k.contiguous(), v.contiguous()))
    out = torch.empty_like(q)
    lib = build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            int(q.dtype == torch.bfloat16), BH, T, S, D, group, int(causal),
            window, q_offset, k_offset, 1.0 / (D ** 0.5), stream)
    build.check(err, "flash_attention")
    route = kernel_route(q.dtype, D)
    flash_attention_cuda.launches += 1
    flash_attention_cuda.tc_launches += route == BF16_TC_KERNEL
    flash_attention_cuda.f32tc_launches += route == F32_TC_KERNEL
    return out


flash_attention_cuda.launches = 0
flash_attention_cuda.tc_launches = 0
flash_attention_cuda.f32tc_launches = 0


def flash_attention_bh(q, k, v, *, group: int = 1, causal: bool = True,
                       window: int = 0, qc: int = 512, kc: int = 512,
                       q_offset: int = 0, k_offset: int = 0):
    """q [BH, T, D]; k/v [BH // group, S, D] -> o [BH, T, D]: the kernel on
    CUDA tensors, the plain twin on CPU tensors."""
    fn = _route(q, flash_attention_plain, flash_attention_cuda)
    return fn(q, k, v, group=group, causal=causal, window=window, qc=qc,
              kc=kc, q_offset=q_offset, k_offset=k_offset)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    qc: int = 512, kc: int = 512, q_offset: int = 0,
                    k_offset: int = 0):
    """Model-layout wrapper: q [B,T,H,D], k/v [B,S,K,D] -> [B,T,H,D]."""
    B, T, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    qf = q.permute(0, 2, 1, 3).reshape(B * H, T, D)
    kf = k.permute(0, 2, 1, 3).reshape(B * K, S, D)
    vf = v.permute(0, 2, 1, 3).reshape(B * K, S, D)
    of = flash_attention_bh(qf, kf, vf, group=H // K, causal=causal,
                            window=window, qc=qc, kc=kc, q_offset=q_offset,
                            k_offset=k_offset)
    return of.reshape(B, H, T, D).permute(0, 2, 1, 3)
