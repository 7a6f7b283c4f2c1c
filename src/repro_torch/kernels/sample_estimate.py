"""Key-match estimation for the sampling families (TS/PS): the inclusion
probability prologue, a CUDA kernel and its plain twin.

Replaces the TPU kernel
``repro/kernels/sample_estimate.py::_sample_fields_kernel`` (launcher
``sample_estimate_fields_pallas``).  Contract::

    kq/vq/aq [F, Q, S], kc/vc/ac [C, P, S], static qmap/cmap -> [G, Q, P] f32

    est[g, q, p] = sum_{t, u} 1[kq == kc and kq >= 0 and min(aq, ac) > 0]
                   * vq * vc / min(aq, ac)

for each field pair ``g = (qmap[g], cmap[g])``, with ``a`` the inclusion
probability of a slot (:func:`sample_inclusion_probs`).  Slots are not
aligned: query slot t and corpus slot u hold the same coordinate iff their
keys are equal, wherever they sit.  The plain version takes the corpus
probabilities ``ac``; the CUDA kernel takes the corpus taus ``tc [C, P]``
instead and computes a matched slot's probability where it finds it
(:func:`_inclusion_probs`' order), so the card's path builds no ``[C, P,
S]`` probability plane: its twin is the plain version on
``sample_inclusion_probs(vc, tc)`` (:func:`sample_estimate_fields_taus_plain`).

**Row layout contract** (``repro_torch.core.sampling``,
``data/ingest.pad_sample_batch``): the live keys (``>= 0``, 31-bit) of a
row are unique and strictly ascending in its leading slots, and every slot
after that prefix holds a negative key (query pad -1, corpus pad and spare
rows -2).  The CUDA kernel relies on it: it looks each live corpus key up
once in a shared-memory hash table of the live keys of the (query, pair)
items that read its field, stops reading a corpus row at its first
negative key, and adds a pair's terms in ascending corpus slot, instead of
the TPU kernel's O(S^2) key-equality cross.  :func:`sorted_prefix_ok`
checks the contract.

Port contract: each (g, q, p) sum adds one f32 term per matched slot, in
ascending corpus slot u -- which under the contract is ascending query slot
t -- a separate multiply and an IEEE divide (``vq * vc / p``), from +0.
The plain version evaluates the full cross (no contract needed), sums each
t's row over u, then adds over t in order: with unique keys each t has at
most one non-zero term and adding +0 changes no bit, so the kernel and the
plain version agree bit for bit on the card, and the plain version stays
an independent check of the sorted shortcut.

The packed twin (``_sample_fields_packed_kernel``, launcher
``sample_estimate_fields_packed_pallas``) takes the corpus as the packed
store holds it: keys ``kc [C, P, Se]``, values as bf16-halfword words ``wc
[C, P, Se / 2]`` and one tau per row ``tc [C, P]``; it decodes a matched
value and computes its probability on chip (:func:`_inclusion_probs` with
the scheme's slot count).  Both are one CUDA body
(``csrc/sample_estimate_fields.cu``).
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from .common import CORPUS_PAD_FP, QUERY_PAD_FP
from .estimate import MAX_PAIRS, _check_maps, _launch
from .packed import unpack_halfwords_f32

# sampling rows share the estimate kernels' pad sentinels
SAMPLE_QUERY_PAD_KEY = QUERY_PAD_FP
SAMPLE_CORPUS_PAD_KEY = CORPUS_PAD_FP

# The kernel's geometry, as csrc/sample_estimate_fields.cu fixes it (its
# kMaxItems, kSlotBytes, kSteps; tests/test_torch_sample_estimate.py holds
# the two sources equal).  The launch plan (items_per_block) and the
# lookup count that chip_smoke.py's issue floor rests on are built on them.
# (query, pair) items a block of the kernel serves at most: a lane each
MAX_ITEMS = 32
# table bytes a query slot of an item: a bucket of four keys and four
# entries, so a table is at most a quarter full
SLOT_BYTES = 32
# a warp reads a corpus row STEP_SLOTS keys a step, CHUNK_STEPS steps (a
# chunk) at once, through the chunk that holds the row's first negative key
STEP_SLOTS = 32
CHUNK_STEPS = 4
# query slots the kernel takes: one item's table (SLOT_BYTES a slot) in a
# block's 227 KB of shared memory beside its static shared memory
MAX_SLOTS = 6_144
# shared memory a block may give its tables; the items are grouped so that
# a group's tables fit (one item a group at the least): a search's six
# items at S = 768 in one group, a block an SM
GROUP_BYTES = 220 * 1024
# corpus rows per plain-version chunk: one [Q, rows, S] cross at a time
_PLAIN_ROWS = 1 << 10


def _inclusion_probs(v: torch.Tensor, t: torch.Tensor, s_total: int
                     ) -> torch.Tensor:
    """``min(1, (s_total * v) * v / t)``, 1 where ``t <= 0``, 0 where ``v ==
    0``: f32 values ``v`` and taus ``t`` broadcast against them, with
    ``s_total`` the scheme's slot count (not a padded width).  The one
    definition of the probability: the unpacked prologue, the packed plain
    version and ``csrc/sample_estimate_fields_packed.cu`` all evaluate it in
    this order, ``jnp``'s in ``repro.kernels.sample_estimate``."""
    num = float(s_total) * v * v
    pos = t > 0
    p = torch.where(pos, torch.clamp_max(num / torch.where(pos, t, 1.0), 1.0),
                    1.0)
    return torch.where(v != 0, p, 0.0)


def sample_inclusion_probs(vals: torch.Tensor, tau: torch.Tensor
                           ) -> torch.Tensor:
    """Per-slot inclusion probabilities from the stored row layout:
    ``vals [..., S]`` f32 sampled values (0 marks an empty slot), ``tau
    [...]`` f32 probability scales -> ``[..., S]`` f32, with ``S`` the
    true slot count of the row (:func:`_inclusion_probs`)."""
    return _inclusion_probs(vals.to(torch.float32),
                            tau.to(torch.float32)[..., None], vals.shape[-1])


def sorted_prefix_ok(keys: torch.Tensor) -> bool:
    """Whether every row of ``keys [..., S]`` satisfies the layout contract:
    live keys (``>= 0``) strictly ascending in a leading prefix, negative
    keys after it."""
    live = keys >= 0
    if keys.shape[-1] < 2:
        return True
    no_gap = ~(live[..., 1:] & ~live[..., :-1]).any()
    ascending = ~(live[..., 1:] & (keys[..., 1:] <= keys[..., :-1])).any()
    return bool(no_gap & ascending)


def _check_inputs(kq, vq, aq, kc, vc, ac, qmap, cmap):
    if kq.dim() != 3 or kc.dim() != 3 or vq.shape != kq.shape \
            or aq.shape != kq.shape or vc.shape != kc.shape \
            or ac.shape != kc.shape or kq.shape[2] != kc.shape[2]:
        raise ValueError(f"expected kq/vq/aq [F, Q, S] and kc/vc/ac [C, P, S]; "
                         f"got {tuple(kq.shape)}, {tuple(vq.shape)}, "
                         f"{tuple(aq.shape)}, {tuple(kc.shape)}, "
                         f"{tuple(vc.shape)}, {tuple(ac.shape)}")
    if (kq.dtype, kc.dtype) != (torch.int32, torch.int32) or any(
            x.dtype != torch.float32 for x in (vq, aq, vc, ac)):
        raise TypeError("sample estimate takes int32 keys and f32 values and "
                        "probabilities")
    if len({x.device for x in (kq, vq, aq, kc, vc, ac)}) != 1:
        raise ValueError("query and corpus planes must lie on one device")
    return _check_maps(qmap, cmap, kq.shape[0], kc.shape[0])


def sample_estimate_fields_plain(kq: torch.Tensor, vq: torch.Tensor,
                                 aq: torch.Tensor, kc: torch.Tensor,
                                 vc: torch.Tensor, ac: torch.Tensor, *,
                                 qmap: Sequence[int], cmap: Sequence[int]
                                 ) -> torch.Tensor:
    """Eager-PyTorch key-match estimates: for each field pair and chunk of
    corpus rows, a loop over query slots t evaluates the ``[Q, rows, S]``
    key-equality cross of slot t against every corpus slot, sums it over
    the corpus slots and adds it to the running ``[Q, rows]`` sum."""
    qmap, cmap = _check_inputs(kq, vq, aq, kc, vc, ac, qmap, cmap)
    G, Q, P = len(qmap), kq.shape[1], kc.shape[1]
    out = torch.empty((G, Q, P), dtype=torch.float32, device=kq.device)
    for lo in range(0, P, _PLAIN_ROWS):
        hi = min(P, lo + _PLAIN_ROWS)
        out[:, :, lo:hi] = _cross(kq, vq, aq, kc[:, lo:hi], vc[:, lo:hi],
                                  ac[:, lo:hi], qmap, cmap)
    return out


def _cross(kq, vq, aq, kc, vc, ac, qmap, cmap) -> torch.Tensor:
    """The plain version's key-equality cross over a few corpus rows; the
    query and corpus slot counts may differ."""
    Q, rows, S = kq.shape[1], kc.shape[1], kq.shape[2]
    out = torch.empty((len(qmap), Q, rows), dtype=torch.float32,
                      device=kq.device)
    for g, (qf, cf) in enumerate(zip(qmap, cmap)):
        kcc = kc[cf][None]                             # [1, rows, Sc]
        vcc = vc[cf][None]
        acc_ = ac[cf][None]
        acc = torch.zeros((Q, rows), dtype=torch.float32, device=kq.device)
        for t in range(S):
            k = kq[qf, :, t, None, None]                # [Q, 1, 1]
            p = torch.minimum(aq[qf, :, t, None, None], acc_)
            live = (k == kcc) & (k >= 0) & (p > 0)      # [Q, rows, Sc]
            term = torch.where(
                live, vq[qf, :, t, None, None] * vcc
                / torch.where(live, p, 1.0), 0.0)
            acc = acc + term.sum(2)
        out[g] = acc
    return out


def _check_tau_inputs(kq, vq, aq, kc, vc, tc, qmap, cmap):
    """The plain version's checks, with the taus ``tc [C, P]`` in place of
    the corpus probabilities (a broadcast stand-in: nothing is
    allocated)."""
    if tc.dtype != torch.float32 or tuple(tc.shape) != tuple(kc.shape[:2]):
        raise ValueError(f"expected taus tc [C, P] f32 beside kc "
                         f"{tuple(kc.shape)}; got {tuple(tc.shape)} "
                         f"{tc.dtype}")
    if tc.device != kc.device:
        raise ValueError("query and corpus planes must lie on one device")
    stand_in = torch.zeros((), dtype=torch.float32, device=kc.device)
    return _check_inputs(kq, vq, aq, kc, vc, stand_in.expand(kc.shape), qmap,
                         cmap)


def sample_estimate_fields_taus_plain(kq, vq, aq, kc, vc, tc, *, qmap,
                                      cmap):
    """The CUDA kernel's plain twin: :func:`sample_estimate_fields_plain`
    on the corpus probabilities ``sample_inclusion_probs(vc, tc)``."""
    _check_tau_inputs(kq, vq, aq, kc, vc, tc, qmap, cmap)
    return sample_estimate_fields_plain(kq, vq, aq, kc, vc,
                                        sample_inclusion_probs(vc, tc),
                                        qmap=qmap, cmap=cmap)


def items_per_block(G: int, Q: int, S: int):
    """(items a block serves, groups): the kernel numbers its (query, pair)
    items ``q * G + g`` and gives each block ``per`` consecutive ones, as
    many as ``GROUP_BYTES`` of tables hold (``SLOT_BYTES`` a query slot of
    each item), in balanced groups."""
    items = G * Q
    per = min(MAX_ITEMS, items)
    while per > 1 and SLOT_BYTES * per * S > GROUP_BYTES:
        per -= 1
    groups = -(-items // per)
    return -(-items // groups), groups


def block_items(G: int, Q: int, S: int) -> list[list[tuple[int, int]]]:
    """The (query, pair) items ``(q, g)`` of each block group, as the
    kernel takes them from :func:`items_per_block`'s plan."""
    per, groups = items_per_block(G, Q, S)
    return [[divmod(n, G) for n in range(y * per, min((y + 1) * per, G * Q))]
            for y in range(groups)]


def sample_estimate_fields_cuda(kq: torch.Tensor, vq: torch.Tensor,
                                aq: torch.Tensor, kc: torch.Tensor,
                                vc: torch.Tensor, tc: torch.Tensor, *,
                                qmap: Sequence[int], cmap: Sequence[int]
                                ) -> torch.Tensor:
    """Launch the CUDA key-match kernel on PyTorch's current stream: the
    corpus as keys ``kc``, values ``vc [C, P, S]`` and taus ``tc [C, P]``,
    each matched slot's probability computed in the kernel.

    Rows must satisfy the layout contract of the module docstring (what
    ``pad_sample_batch`` builds); the kernel does not check it.  Takes CUDA
    tensors only; the query planes are made contiguous (they are small),
    the corpus planes are read in place through their field and row
    strides (a tenant slice of the store's ``[3, cap, S]`` buffers is
    passed as is).  Adds one to ``sample_estimate_fields_cuda.launches``
    per launch.
    """
    qmap, cmap = _check_tau_inputs(kq, vq, aq, kc, vc, tc, qmap, cmap)
    if kq.device.type != "cuda":
        raise ValueError(f"sample_estimate_fields_cuda takes CUDA tensors; "
                         f"got {kq.device}")
    if len(qmap) > MAX_PAIRS:
        raise ValueError(f"at most {MAX_PAIRS} field pairs per launch")
    G, Q, P, S = len(qmap), kq.shape[1], kc.shape[1], kq.shape[2]
    if S > MAX_SLOTS:
        raise ValueError(f"sample_estimate_fields_cuda takes at most "
                         f"{MAX_SLOTS} slots per row; got {S}")
    if any(x.stride(2) != 1 for x in (kc, vc)):
        raise ValueError("corpus planes need a contiguous last dimension")
    kq, vq, aq = kq.contiguous(), vq.contiguous(), aq.contiguous()
    out = torch.empty((G, Q, P), dtype=torch.float32, device=kq.device)
    if Q == 0 or P == 0 or S == 0:
        return out.zero_()
    _launch("sample_estimate_fields", kq, kq.data_ptr(), vq.data_ptr(),
            aq.data_ptr(), kc.data_ptr(), vc.data_ptr(), tc.data_ptr(),
            kc.stride(0), kc.stride(1), vc.stride(0), vc.stride(1),
            tc.stride(0), tc.stride(1), (ctypes.c_int * G)(*qmap),
            (ctypes.c_int * G)(*cmap), G, Q, P, S,
            items_per_block(G, Q, S)[0], out.data_ptr())
    sample_estimate_fields_cuda.launches += 1
    return out


sample_estimate_fields_cuda.launches = 0


def _check_packed(kq, vq, aq, kc, wc, tc, qmap, cmap):
    C, P, Sc = kc.shape if kc.dim() == 3 else (0, 0, 1)
    if Sc % 2 or wc.dtype != torch.int32 or tuple(wc.shape) != (C, P, Sc // 2) \
            or tc.dtype != torch.float32 or tuple(tc.shape) != (C, P):
        raise ValueError(f"expected kc [C, P, Se] with Se even, wc [C, P, "
                         f"Se / 2] int32 and tc [C, P] f32; got "
                         f"{tuple(kc.shape)}, {tuple(wc.shape)} {wc.dtype}, "
                         f"{tuple(tc.shape)} {tc.dtype}")
    if kc.shape[2] not in (kq.shape[2], kq.shape[2] + 1):
        raise ValueError(f"{Sc} stored slots do not hold {kq.shape[2]} "
                         "query slots")
    if len({x.device for x in (kc, wc, tc)}) != 1:
        raise ValueError("query and corpus planes must lie on one device")
    # the unpacked launch's checks, with query-shaped stand-ins for the
    # corpus planes (broadcast scalars: nothing is allocated)
    stand_in = torch.zeros((), dtype=torch.float32, device=kc.device)
    shape = (C, P, kq.shape[2])
    return _check_inputs(kq, vq, aq, kc[:, :, :kq.shape[2]],
                         stand_in.expand(shape), stand_in.expand(shape),
                         qmap, cmap)


def sample_estimate_fields_packed_plain(kq, vq, aq, kc, wc, tc, *, qmap,
                                        cmap):
    """The plain key-match estimates over a packed corpus: keys ``kc [C, P,
    Se]``, values ``wc [C, P, Se / 2]`` i32 words, taus ``tc [C, P]``.  A
    chunk of rows at a time, the values are decoded, their probabilities
    computed with the query's slot count (:func:`_inclusion_probs`), and
    the plain cross runs on them."""
    qmap, cmap = _check_packed(kq, vq, aq, kc, wc, tc, qmap, cmap)
    G, Q, P, S = len(qmap), kq.shape[1], kc.shape[1], kq.shape[2]
    out = torch.empty((G, Q, P), dtype=torch.float32, device=kq.device)
    for lo in range(0, P, _PLAIN_ROWS):
        hi = min(P, lo + _PLAIN_ROWS)
        vc = unpack_halfwords_f32(wc[:, lo:hi])
        ac = _inclusion_probs(vc, tc[:, lo:hi, None], S)
        out[:, :, lo:hi] = _cross(kq, vq, aq, kc[:, lo:hi], vc, ac, qmap,
                                  cmap)
    return out


def sample_estimate_fields_packed_cuda(kq, vq, aq, kc, wc, tc, *, qmap,
                                       cmap):
    """Launch the packed key-match kernel
    (``sample_estimate_fields_packed_kernel`` of
    ``csrc/sample_estimate_fields.cu``) on PyTorch's current stream.  Rows
    must keep the layout contract; CUDA tensors only, the corpus read in
    place through its strides.  Adds one to
    ``sample_estimate_fields_packed_cuda.launches`` per launch."""
    qmap, cmap = _check_packed(kq, vq, aq, kc, wc, tc, qmap, cmap)
    if kq.device.type != "cuda":
        raise ValueError(f"sample_estimate_fields_packed_cuda takes CUDA "
                         f"tensors; got {kq.device}")
    if len(qmap) > MAX_PAIRS:
        raise ValueError(f"at most {MAX_PAIRS} field pairs per launch")
    G, Q, P, Sq, Sc = (len(qmap), kq.shape[1], kc.shape[1], kq.shape[2],
                       kc.shape[2])
    if Sq > MAX_SLOTS:
        raise ValueError(f"sample_estimate_fields_packed_cuda takes at most "
                         f"{MAX_SLOTS} slots per row; got {Sq}")
    if kc.stride(2) != 1 or wc.stride(2) != 1:
        raise ValueError("corpus planes need a contiguous last dimension")
    kq, vq, aq = kq.contiguous(), vq.contiguous(), aq.contiguous()
    out = torch.empty((G, Q, P), dtype=torch.float32, device=kq.device)
    if Q == 0 or P == 0:
        return out.zero_()
    _launch("sample_estimate_fields_packed", kq, kq.data_ptr(), vq.data_ptr(),
            aq.data_ptr(), kc.data_ptr(), wc.data_ptr(), tc.data_ptr(),
            kc.stride(0), kc.stride(1), wc.stride(0), wc.stride(1),
            tc.stride(0), tc.stride(1), (ctypes.c_int * G)(*qmap),
            (ctypes.c_int * G)(*cmap), G, Q, P, Sq, Sc,
            items_per_block(G, Q, Sq)[0], out.data_ptr())
    sample_estimate_fields_packed_cuda.launches += 1
    return out


sample_estimate_fields_packed_cuda.launches = 0
