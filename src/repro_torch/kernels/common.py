"""The u32 RNG, salt streams and sentinels shared by the port's kernels.

Twin of the JAX package's ``repro/kernels/common.py`` mixer (murmur3
fmix32 rounds over uint32 lanes) built on int64 torch tensors that hold
uint32 values, masked with ``0xFFFFFFFF`` after every wrapping step.
torch has no uint32 arithmetic, and a product of two u32 values overflows
int64, so every multiply by a 32-bit constant is split into its 16-bit
halves (:func:`mul32`): each partial product stays below 2^49 and the
low 32 bits come out exact.  The CUDA kernels carry the same functions
in ``csrc/u32.cuh`` on native ``uint32_t``.

The stream ids equal the JAX registry's ICWS draws
(``repro/kernels/common.py:34-39``), its CountSketch and JL draws
(``:43-45``), its sample hash (``:48``) and its DMH draws (``:56-63``) one
for one; the port keeps them as ``<FAMILY>_STREAM_<draw>`` (``ICWS_``,
``CS_``, ``JL_``, ``SAMPLE_``, ``DMH_``) so its sources name no constant of
that registry.

:func:`icws_rank`, :func:`level_fingerprint` and :func:`densify_sources`
are the ICWS draw, the (key, level) fingerprint and the DMH densify
sources in torch: the plain ICWS and DMH sketches and the families'
merges share them, so the three stay bit for bit with the kernels.
:func:`stable_top_k` is the serving path's top-k and its tie rule, shared
by the index and ``ops.sharded_top_k``.
"""
from __future__ import annotations

import torch

# salt stream of the TS/PS coordinated sample hash (one draw per key; id
# 41), defined beside the host samplers that draw it
from repro_torch.core.sampling import SAMPLE_STREAM_HASH  # noqa: F401

_MASK = 0xFFFFFFFF
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9

# salt streams of the ICWS draws: r ~ Gamma(2,1) from two uniforms, c ~
# Gamma(2,1) from two more, beta ~ U(0,1), and the (key, level)
# fingerprint salt
ICWS_STREAM_R1 = 1
ICWS_STREAM_R2 = 2
ICWS_STREAM_C1 = 3
ICWS_STREAM_C2 = 4
ICWS_STREAM_BETA = 5
ICWS_STREAM_FP = 9
# salt streams of the linear sketches: CountSketch bucket and sign per
# repetition r, and the JL sign per (sample t, key)
CS_STREAM_BUCKET = 21
CS_STREAM_SIGN = 22
JL_STREAM_SIGN = 31
# salt streams of DMH: the bin of each key, the ICWS-style variates drawn
# at t = bin, the (key, level) fingerprint salt per bin, and the reseeded
# densification probes
DMH_STREAM_BIN = 51
DMH_STREAM_R1 = 52
DMH_STREAM_R2 = 53
DMH_STREAM_C1 = 54
DMH_STREAM_C2 = 55
DMH_STREAM_BETA = 56
DMH_STREAM_FP = 57
DMH_STREAM_DENSIFY = 58

# masked-lane hash value of the sketch argmin (a python float, also the
# empty-row marker: amin >= BIG)
BIG = 3.0e38

# pad sentinels: query padding (-1, also the empty-sketch fingerprint) and
# corpus padding (-2) never equal each other or a live fingerprint (>= 0);
# the estimate guard ``fq >= 0`` keeps both out of every sum
QUERY_PAD_FP = -1
CORPUS_PAD_FP = -2


def stable_top_k(score: torch.Tensor, k: int):
    """Top-k scores + indices over the last dim, equal scores by ascending
    index (as ``jax.lax.top_k``): a stable descending sort keeps the index
    order of ties, which ``torch.topk`` does not promise."""
    scores, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    return scores[..., :k], idx[..., :k]


def densify_probes(m: int) -> int:
    """Probe budget of the DMH densification epilogue, a function of m
    alone (``repro/kernels/common.py:65``): sketches of different vectors
    must probe identically or borrowed bins stop colliding."""
    return min(1024, 128 * -(-4 * int(m) // 128))


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """Integer tensor -> int64 holding its uint32 bit pattern (negative
    int32 keys wrap to 2^32 + k, as ``astype(uint32)`` does)."""
    return x.to(torch.int64) & _MASK


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2^32`` for x in [0, 2^32) held in int64, exact: the
    constant is split into 16-bit halves so no partial product overflows."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def mix32(x: torch.Tensor) -> torch.Tensor:
    """Murmur3 fmix32 over uint32 values held in int64."""
    z = as_u32(x)
    z = z ^ (z >> 16)
    z = mul32(z, _M1)
    z = z ^ (z >> 13)
    z = mul32(z, _M2)
    return z ^ (z >> 16)


def hash_u32(key: torch.Tensor, salt: torch.Tensor) -> torch.Tensor:
    """Mix key with a salt (two rounds; inputs broadcast)."""
    k = as_u32(key)
    s = as_u32(salt)
    return mix32(mix32((k + mul32(s, _GOLDEN)) & _MASK)
                 ^ ((mul32(s, _M2) + 0x27D4EB2F) & _MASK))


def uniform01(key: torch.Tensor, salt: torch.Tensor) -> torch.Tensor:
    """Strictly-interior uniform (0,1) f32 from the top 24 hash bits."""
    bits = hash_u32(key, salt) >> 8
    return bits.to(torch.float32) * (2.0 ** -24) + (2.0 ** -25)


def salt_for(seed: int, stream: int, t: torch.Tensor) -> torch.Tensor:
    """Combine (seed, stream, sample index t) into a uint32 salt (int64)."""
    base = ((seed & _MASK) * 0x9E3779B1 + stream * 0x517CC1B7) & _MASK
    return (base + mul32(as_u32(t), 0x2545F491)) & _MASK


# the five draws of the ICWS variates, (r1, r2, c1, c2, beta), of each
# family
ICWS_DRAWS = (ICWS_STREAM_R1, ICWS_STREAM_R2, ICWS_STREAM_C1,
              ICWS_STREAM_C2, ICWS_STREAM_BETA)
DMH_DRAWS = (DMH_STREAM_R1, DMH_STREAM_R2, DMH_STREAM_C1, DMH_STREAM_C2,
             DMH_STREAM_BETA)
# elements a chunk of the densify probes holds at once: [rows, m, probes]
# for the rows that have a bin to fill
_PROBE_CHUNK = 1 << 27


def icws_rank(keys: torch.Tensor, w: torch.Tensor, seed: int, draws,
              at: torch.Tensor):
    """``(a, level)`` of the ICWS draw of u32 ``keys`` (int64) at weight
    ``w`` and sample index ``at`` (all broadcast) on the five ``draws``
    streams: the kernels' f32 arithmetic op for op.  ``a`` is not masked
    where ``w <= 0``; ``level`` is f32."""
    r1, r2, c1, c2, beta_stream = draws

    def u(stream: int) -> torch.Tensor:
        return uniform01(keys, salt_for(seed, stream, at))

    r = -torch.log(u(r1) * u(r2))
    c = -torch.log(u(c1) * u(c2))
    beta = u(beta_stream)
    logw = torch.log(torch.clamp_min(w, 1e-37))
    lvl = torch.floor(logw / r + beta)
    y = torch.exp(r * (lvl - beta))
    return c / (y * torch.exp(r)), lvl


def level_fingerprint(keys: torch.Tensor, lvl: torch.Tensor, seed: int,
                      stream: int, at: torch.Tensor) -> torch.Tensor:
    """31-bit int32 fingerprint of (key, level) at sample index ``at``;
    ``level * 0x9E3779B9`` wraps in u32."""
    bits = hash_u32(as_u32(keys) ^ mul32(as_u32(lvl.to(torch.int32)),
                                         _GOLDEN),
                    salt_for(seed, stream, at))
    return (bits & 0x7FFFFFFF).to(torch.int32)


def densify_sources(occ: torch.Tensor, seed: int, m: int):
    """``(need, src)`` of the DMH densification over occupancy ``occ [...,
    m]``: the empty bins of rows with an occupied one, and the bin each
    borrows from -- the first probe ``h(t; j) mod m`` (stream
    ``DMH_STREAM_DENSIFY``, j < ``densify_probes(m)``) that lands on an
    occupied bin, else the first occupied bin.  ``src`` is 0 where nothing
    is needed; the probes run a chunk of rows at a time."""
    dev = occ.device
    t = torch.arange(m, device=dev)
    J = densify_probes(m)
    j = torch.arange(J, dtype=torch.int32, device=dev)
    probe = hash_u32(t[:, None], salt_for(seed, DMH_STREAM_DENSIFY,
                                          j)[None, :]) % m        # [m, J]
    need = ~occ & occ.any(-1, keepdim=True)
    flat_occ = occ.reshape(-1, m)
    flat_src = torch.zeros(flat_occ.shape, dtype=torch.int64, device=dev)
    rows = torch.nonzero(need.reshape(-1, m).any(-1)).flatten()
    for chunk in rows.split(max(1, _PROBE_CHUNK // probe.numel())):
        o = flat_occ[chunk]
        firstj = torch.where(o[:, probe], j, J).amin(-1).long()   # [n, m]
        first_occ = torch.where(o, t, m).amin(-1, keepdim=True)
        flat_src[chunk] = torch.where(firstj < J,
                                      probe[t, firstj.clamp_max(J - 1)],
                                      first_occ.clamp_max(m - 1))
    return need, flat_src.reshape(occ.shape)
