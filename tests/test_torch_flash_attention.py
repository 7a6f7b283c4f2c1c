"""The port's flash attention (B15's plain version behind
``repro_torch.kernels.flash_attention``) and its oracle
``repro_torch.models.attention.chunked_attention`` against the JAX
package, at the JAX tests' tolerances (``tests/test_flash_attention.py``):
2e-4 against ``chunked_attention``, 5e-5 for f32 inputs and 3e-2 for bf16
inputs against the f32 oracle, block sizes within 1e-5 of each other.
The tensor-core kernels' functions are emulated here in plain PyTorch:
the bf16 one (``p v`` as ``p_hi v + p_lo v``), held to the card's gate of
one bf16 step (rtol 2^-7, atol 1e-5), and the f32 one (every operand split
into three bf16 parts, six part-products per product), held to the f32
gate of 5e-5, each against the plain version and the JAX kernel; beside
them the cheaper f32 variants that break that gate."""
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_pallas
from repro.models.attention import chunked_attention as jax_chunked
from repro_torch.kernels.flash_attention import (BF16_TC_KERNEL,
                                                 F32_TC_KERNEL,
                                                 flash_attention,
                                                 flash_attention_bh,
                                                 flash_attention_cuda,
                                                 flash_attention_plain,
                                                 kernel_route, tma_loads)
from repro_torch.models.attention import chunked_attention

# small shapes: one intra-op thread per test process, so that parallel
# test workers do not oversubscribe the cores
torch.set_num_threads(1)

CASES = [
    (2, 64, 4, 2, 16, True, 0, 16, 16),
    (1, 128, 4, 4, 32, True, 0, 64, 32),
    (2, 64, 4, 1, 16, False, 0, 32, 64),
    (1, 96, 6, 2, 16, True, 24, 32, 32),      # sliding window, ragged heads
    (1, 64, 2, 2, 64, True, 0, 64, 64),       # single chunk
]


def _qkv(seed, B, T, H, K, D, S=None):
    rng = np.random.default_rng(seed)
    S = S or T
    return tuple(rng.normal(size=s).astype(np.float32)
                 for s in ((B, T, H, D), (B, S, K, D), (B, S, K, D)))


@functools.lru_cache(maxsize=None)
def _jax_reference(case):
    B, T, H, K, D, causal, window, _, _ = case
    q, k, v = _qkv(B * 100 + T + H, B, T, H, K, D)
    out = jax_chunked(*map(jnp.asarray, (q, k, v)), causal=causal,
                      window=window, q_chunk=32, k_chunk=32)
    return (q, k, v), np.asarray(out)


@pytest.mark.parametrize("case", CASES)
def test_chunked_attention_matches_jax(case):
    (q, k, v), want = _jax_reference(case)
    got = chunked_attention(*map(torch.from_numpy, (q, k, v)),
                            causal=case[5], window=case[6], q_chunk=32,
                            k_chunk=32)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("case", CASES)
def test_flash_attention_matches_jax_chunked(case):
    (q, k, v), want = _jax_reference(case)
    *_, causal, window, qc, kc = case
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                          window=window, qc=qc, kc=kc)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("offsets", [(0, 0), (9, 4)])
@pytest.mark.parametrize("case", CASES)
def test_flash_attention_matches_port_chunked(case, offsets):
    """B15's plain version against its oracle inside the port, offsets
    included (the JAX ``chunked_attention`` takes them too)."""
    B, T, H, K, D, causal, window, qc, kc = case
    tq, tk, tv = map(torch.from_numpy, _qkv(B * 100 + T + H, B, T, H, K, D))
    kw = dict(causal=causal, window=window, q_offset=offsets[0],
              k_offset=offsets[1])
    got = flash_attention(tq, tk, tv, qc=qc, kc=kc, **kw)
    want = chunked_attention(tq, tk, tv, q_chunk=32, k_chunk=32, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 5e-5),
                                        (torch.bfloat16, 3e-2)])
def test_flash_dtypes(dtype, tol):
    q, k, v = _qkv(7, 1, 64, 4, 2, 32)
    want = np.asarray(jax_chunked(*map(jnp.asarray, (q, k, v)), causal=True,
                                  q_chunk=32, k_chunk=32))
    tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    got = flash_attention(tq, tk, tv, causal=True, qc=32, kc=32)
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_chunked_attention_bf16_matches_jax():
    """With bf16 inputs both oracles cast p to bf16 before p v."""
    q, k, v = _qkv(8, 1, 64, 4, 2, 32)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(jax_chunked(jq, jk, jv, causal=True, q_chunk=32,
                                  k_chunk=16), np.float32)
    tq, tk, tv = (torch.from_numpy(np.asarray(a, np.float32))
                  .to(torch.bfloat16) for a in (jq, jk, jv))
    got = chunked_attention(tq, tk, tv, causal=True, q_chunk=32, k_chunk=16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=3e-2,
                               atol=3e-2)


@pytest.mark.parametrize("kw", [
    dict(causal=True, window=7, q_offset=5, k_offset=3),
    # rows 0-19 see no key (k_offset past them): the mean of v, not NaN
    dict(causal=True, q_offset=0, k_offset=20),
])
def test_flash_bh_matches_pallas_interpret(kw):
    rng = np.random.default_rng(3)
    q = rng.normal(size=(4, 32, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 48, 16)).astype(np.float32) for _ in "kv")
    want = np.asarray(flash_attention_pallas(
        *map(jnp.asarray, (q, k, v)), group=2, qc=16, kc=16, interpret=True,
        **kw))
    got = flash_attention_bh(*map(torch.from_numpy, (q, k, v)), group=2,
                             qc=16, kc=16, **kw).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_fully_masked_rows_return_the_mean_of_v():
    """k_offset >= T + q_offset, causal: no row sees a key; the -1e30 masks
    tie, p = 1 on every key, and each row is the mean of its kv head."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.normal(size=(4, 32, 8)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(2, 64, 8)).astype(np.float32))
            for _ in "kv")
    got = flash_attention_bh(q, k, v, group=2, qc=16, kc=16, causal=True,
                             k_offset=40)
    mean = v.mean(dim=1)[torch.arange(4) // 2]
    np.testing.assert_allclose(got.numpy(), mean[:, None].expand(4, 32, 8),
                               rtol=1e-5, atol=1e-6)


def test_flash_block_size_invariance():
    q, k, v = _qkv(9, 1, 128, 4, 2, 16)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    outs = [flash_attention(tq, tk, tv, causal=True, qc=qc, kc=kc).numpy()
            for qc, kc in [(32, 32), (64, 16), (128, 64)]]
    for o in outs[1:]:
        np.testing.assert_allclose(o, outs[0], rtol=1e-5, atol=1e-5)


def test_model_layout_equals_head_by_head():
    """The [B,T,H,D] wrapper is the [BH,T,D] launch with q head h reading
    kv head h // G."""
    q, k, v = _qkv(10, 2, 32, 4, 2, 8)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = flash_attention(tq, tk, tv, causal=False, qc=16, kc=16)
    for b in range(2):
        for h in range(4):
            one = flash_attention_plain(tq[b, :, h][None], tk[b, :, h // 2][None],
                                        tv[b, :, h // 2][None], causal=False,
                                        qc=16, kc=16)
            assert torch.equal(got[b, :, h], one[0])


def test_bad_inputs_raise():
    q = torch.zeros(4, 32, 16)
    kv = torch.zeros(2, 32, 16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_cuda(q, kv, kv, group=2)
    with pytest.raises(ValueError, match="must divide"):
        flash_attention_bh(q, kv, kv, group=2, qc=12)
    with pytest.raises(ValueError, match=r"\[BH // group, S, D\]"):
        flash_attention_bh(q, kv, kv, group=1)
    with pytest.raises(TypeError, match="one dtype"):
        flash_attention_bh(q, kv.bfloat16(), kv, group=2)
    wide = torch.zeros(1, 8, 257)
    with pytest.raises(ValueError, match="outside 1..256"):
        flash_attention_bh(wide, wide, wide)


@pytest.mark.parametrize("dtype, tc_dims", [
    (torch.bfloat16, range(1, 257)),
    (torch.float32, range(1, 257)),
])
def test_kernel_route_by_type_and_head_dim(dtype, tc_dims):
    """bf16 and f32 name their tensor-core kernels at every D from 1 to 256
    (the CUDA launcher routes the same; tests/test_torch_cuda.py reads the
    route from a profiler trace on the card); the bf16 kernel's tiles
    arrive by TMA where D % 8 == 0 and value by value elsewhere."""
    tc = BF16_TC_KERNEL if dtype == torch.bfloat16 else F32_TC_KERNEL
    for D in tc_dims:
        assert kernel_route(dtype, D) == tc
        assert tma_loads(dtype, D) == (dtype == torch.bfloat16 and D % 8 == 0)


# The CUDA tensor-core kernel's function on bf16 inputs, emulated in plain
# PyTorch: s = (q k^T) * scale from bf16 values (products exact in f32),
# the f32 mask and online softmax over its key tiles of 64, and p v as
# bf16(p) v + bf16(p - bf16(p)) v, or with `split=False` as the single
# cast bf16(p) v that a FlashAttention kernel takes.
def _tensor_core_emulation(q, k, v, *, group, causal, window, split=True,
                           kc=64):
    BH, T, D = q.shape
    S = k.shape[1]
    heads = torch.arange(BH) // group
    qf, kf, vf = q.float(), k.float()[heads], v.float()[heads]
    q_pos = torch.arange(T)
    m = torch.full((BH, T), -math.inf)
    l = torch.zeros((BH, T))
    acc = torch.zeros((BH, T, D))
    for k0 in range(0, S, kc):
        kb, vb = kf[:, k0:k0 + kc], vf[:, k0:k0 + kc]
        s = torch.matmul(qf, kb.transpose(1, 2)) * (1.0 / D ** 0.5)
        k_pos = k0 + torch.arange(kb.shape[1])
        mask = torch.ones(s.shape[1:], dtype=torch.bool)
        if causal:
            mask &= k_pos[None, :] <= q_pos[:, None]
        if window:
            mask &= k_pos[None, :] > q_pos[:, None] - window
        s = torch.where(mask, s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        p_hi = p.bfloat16().float()
        acc = acc * corr[..., None] + torch.matmul(p_hi, vb)
        if split:
            acc = acc + torch.matmul((p - p_hi).bfloat16().float(), vb)
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).bfloat16()


# D, T = S, window (causal throughout): bf16 unit-normal inputs, the scale
# at which the gate holds for every f32 variant of the function.  D = 28, 33
# and 150 are the kernel's by-value loads (padded to DP = 32, 64, 256), D =
# 40 its TMA loads with DP = 64 past D
TC_CASES = [(64, 256, 0), (64, 512, 128), (128, 256, 96), (128, 512, 0),
            (256, 256, 0), (256, 512, 128), (28, 512, 0), (33, 256, 0),
            (40, 256, 96), (150, 256, 0)]


@functools.lru_cache(maxsize=None)
def _tensor_core_case(case):
    D, T, window = case
    rng = np.random.default_rng(D + T + window)
    q, k, v = (torch.from_numpy(rng.standard_normal((n, T, D), np.float32))
               .bfloat16() for n in (4, 2, 2))
    kw = dict(group=2, causal=True, window=window)
    plain = flash_attention_plain(q, k, v, qc=128, kc=128, **kw)
    pallas = flash_attention_pallas(
        *(jnp.asarray(a.float().numpy(), jnp.bfloat16) for a in (q, k, v)),
        qc=128, kc=128, interpret=True, **kw)
    pallas = torch.from_numpy(np.asarray(pallas, np.float32))
    return (q, k, v), kw, plain.float(), pallas


@pytest.mark.parametrize("case", TC_CASES)
def test_tensor_core_function_is_one_bf16_step_from_the_f32_one(case):
    """The split keeps p to about 16 bits: within one bf16 rounding step of
    the plain version and of the JAX interpret-mode kernel."""
    (q, k, v), kw, plain, pallas = _tensor_core_case(case)
    got = _tensor_core_emulation(q, k, v, **kw).float()
    for want in (plain, pallas):
        torch.testing.assert_close(got, want, rtol=2 ** -7, atol=1e-5)


@pytest.mark.parametrize("case", TC_CASES)
def test_single_bf16_cast_of_p_breaks_the_gate(case):
    """Why the kernel splits p: one bf16 cast of p before p v moves outputs
    by more than one bf16 step from the f32 function."""
    (q, k, v), kw, plain, _ = _tensor_core_case(case)
    got = _tensor_core_emulation(q, k, v, split=False, **kw).float()
    outside = (got - plain).abs() > 1e-5 + 2 ** -7 * plain.abs()
    assert outside.sum().item() > 0


# The CUDA f32 tensor-core kernel's function, emulated in plain PyTorch:
# q (1/sqrt(D)) in f32; q scale, k, v and p each split into bf16 parts, b0 =
# bf16(x), b1 = bf16(x - b0), b2 = bf16(x - b0 - b1); each product the sum of
# the part-products whose part indices add to less than the number of parts
# (three parts: b0c0, b0c1, b1c0, b0c2, b1c1, b2c0), each exact in f32 and
# summed in f32; the f32 mask and online softmax over key tiles of 64.
# `qk_parts` / `pv_parts` = 2 is the two-part split, 0 one TF32 pass.
def _bf16_parts(x, n):
    parts = []
    for _ in range(n):
        b = x.bfloat16().float()
        parts.append(b)
        x = x - b
    return parts


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits, to nearest even)."""
    i = x.view(torch.int32)
    return ((i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF).view(torch.float32)


def _split_matmul(a, b, parts):
    if parts == 0:
        return torch.matmul(_tf32(a), _tf32(b))
    pa, pb = _bf16_parts(a, parts), _bf16_parts(b, parts)
    out = torch.matmul(pa[0], pb[0])
    for total in range(1, parts):
        for i in range(total + 1):
            out = out + torch.matmul(pa[i], pb[total - i])
    return out


def _f32_split_emulation(q, k, v, *, group, causal, window, qk_parts=3,
                         pv_parts=3):
    BH, T, D = q.shape
    S = k.shape[1]
    # the kernel's key tile, and its two halves of the head dim past D = 128
    # (each warpgroup's partial s over its 128 dims, then s_0 + s_1)
    kc, halves = (32, (slice(0, 128), slice(128, D))) if D > 128 else \
        (64, (slice(0, D),))
    heads = torch.arange(BH) // group
    qs, kf, vf = q * (1.0 / D ** 0.5), k[heads], v[heads]
    q_pos = torch.arange(T)
    m = torch.full((BH, T), -math.inf)
    l = torch.zeros((BH, T))
    acc = torch.zeros((BH, T, D))
    for k0 in range(0, S, kc):
        kb, vb = kf[:, k0:k0 + kc], vf[:, k0:k0 + kc]
        s = sum(_split_matmul(qs[..., h], kb[..., h].transpose(1, 2), qk_parts)
                for h in halves)
        k_pos = k0 + torch.arange(kb.shape[1])
        mask = torch.ones(s.shape[1:], dtype=torch.bool)
        if causal:
            mask &= k_pos[None, :] <= q_pos[:, None]
        if window:
            mask &= k_pos[None, :] > q_pos[:, None] - window
        s = torch.where(mask, s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + _split_matmul(p, vb, pv_parts)
        m = m_new
    return acc / torch.clamp(l, min=1e-30)[..., None]


# D, T = S, window (causal throughout), and the scale of q and k (the
# logits grow by its square): unit-normal inputs, and one case at x3
F32_CASES = [(64, 256, 0, 1.0), (64, 512, 128, 1.0), (128, 256, 96, 1.0),
             (128, 512, 0, 1.0), (256, 256, 0, 1.0), (256, 512, 128, 1.0),
             (256, 256, 0, 3.0), (64, 256, 0, 3.0)]
F32_GATE = dict(rtol=5e-5, atol=5e-5)


@functools.lru_cache(maxsize=None)
def _f32_case(case):
    D, T, window, scale = case
    rng = np.random.default_rng(D + T + window + int(scale))
    q, k, v = (rng.standard_normal((n, T, D), np.float32) for n in (4, 2, 2))
    q, k = q * np.float32(scale), k * np.float32(scale)
    kw = dict(group=2, causal=True, window=window)
    q, k, v = map(torch.from_numpy, (q, k, v))
    plain = flash_attention_plain(q, k, v, qc=128, kc=128, **kw)
    pallas = flash_attention_pallas(*map(jnp.asarray, (q.numpy(), k.numpy(),
                                                       v.numpy())),
                                    qc=128, kc=128, interpret=True, **kw)
    return (q, k, v), kw, plain, torch.from_numpy(np.array(pallas))


def _outside_f32_gate(got, want):
    return int((got - want).abs().gt(F32_GATE["atol"] + F32_GATE["rtol"]
                                     * want.abs()).sum())


@pytest.mark.parametrize("case", F32_CASES)
def test_f32_split_function_holds_the_f32_gate(case):
    """Three bf16 parts and six part-products carry q k^T and p v to f32
    rounding: within 5e-5 of the plain version and of the JAX
    interpret-mode kernel, at unit scale and with logits nine times as
    large."""
    (q, k, v), kw, plain, pallas = _f32_case(case)
    got = _f32_split_emulation(q, k, v, **kw)
    for want in (plain, pallas):
        torch.testing.assert_close(got, want, **F32_GATE)


def _cheaper_split_breaks_the_gate(case, **parts):
    (q, k, v), kw, plain, _ = _f32_case(case)
    assert _outside_f32_gate(_f32_split_emulation(q, k, v, **kw), plain) == 0
    cheaper = _f32_split_emulation(q, k, v, **parts, **kw)
    assert _outside_f32_gate(cheaper, plain) > 0


def test_two_part_split_of_qk_breaks_the_f32_gate_at_larger_logits():
    """Why q and k take three parts: with two (three part-products) the
    error of s grows with the logits and breaks the gate at x3 scale."""
    _cheaper_split_breaks_the_gate(F32_CASES[-1], qk_parts=2)


def test_one_tf32_pass_breaks_the_f32_gate():
    """Why the f32 kernel takes no TF32 pass: one already breaks the gate
    at unit scale."""
    _cheaper_split_breaks_the_gate(F32_CASES[0], qk_parts=0, pv_parts=0)


@pytest.mark.parametrize("case, parts", [
    ((256, 256, 0, 3.0), dict(qk_parts=2)),
    ((256, 256, 0, 1.0), dict(qk_parts=0, pv_parts=0))])
def test_cheaper_split_breaks_the_f32_gate_at_d256(case, parts):
    """The same two witnesses at D = 256, where s is the sum of two
    half-dim partials over key tiles of 32: the three-part function holds
    the gate there and each cheaper split breaks it."""
    _cheaper_split_breaks_the_gate(case, **parts)
