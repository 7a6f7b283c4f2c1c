"""The port's sampling rows and key-match estimate against the JAX package:
``pad_sample_batch`` and ``sample_inclusion_probs`` bit for bit, the rows'
sorted-prefix layout, ``sample_estimate_fields_plain`` against the Pallas
kernel (interpret mode) and the jnp reference, the kernel wrappers' taus
and a numpy emulation of the CUDA kernels' probe order.

Estimate tolerance: rtol 1e-5, with atol 1e-5 times the largest estimate
for sums that cancel -- the port adds one term per matched query slot in
ascending t, the TPU kernel sums (t, u) blocks as trees."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.types import SparseVec as JaxSparseVec
from repro.data.ingest import pad_sample_batch as jax_pad_sample
from repro.kernels import ref as jax_ref
from repro.kernels.sample_estimate import (
    SAMPLE_CORPUS_PAD_KEY as JAX_CORPUS_PAD, SAMPLE_QUERY_PAD_KEY as
    JAX_QUERY_PAD, sample_estimate_fields_packed_pallas,
    sample_estimate_fields_pallas, sample_inclusion_probs as jax_probs)
from repro_torch.core import sampling
from repro_torch.core.types import SparseVec
from repro_torch.data.ingest import pad_sample_batch
from repro_torch.kernels import ops
from repro_torch.kernels import sample_estimate as port_se
from repro_torch.kernels.packed import (pack_halfwords_f32,
                                        unpack_halfwords_f32)

# small shapes: one intra-op thread per test process, so that parallel
# test workers do not oversubscribe the cores
torch.set_num_threads(1)

QMAP = (0, 1, 0, 2, 0, 1)
CMAP = (0, 0, 1, 0, 2, 1)
SLOTS = 40


def _vectors(seed):
    """Vectors whose support overflows the slots, one that fits, keys that
    fold together past 2^31 (aggregated), a single entry and an empty."""
    rng = np.random.default_rng(seed)
    vecs = []
    for nnz in (400, 120, 60, 25):
        idx = rng.choice(3000, size=nnz, replace=False)
        val = rng.normal(size=nnz) * np.where(rng.random(nnz) < 0.1, 20, 1)
        vecs.append(JaxSparseVec.from_pairs(idx, val, 2 ** 34))
    vecs.append(JaxSparseVec.from_pairs([7, 7 + 2 ** 31, 2 ** 33 + 9],
                                        [1.5, 2.0, -3.0], 2 ** 34))
    vecs.append(JaxSparseVec.from_pairs([11], [-4.0], 100))
    vecs.append(JaxSparseVec.from_pairs([], [], 10))
    return vecs


def _port_vec(v):
    return SparseVec(indices=v.indices, values=v.values, n=v.n)


def _overflowing_vector():
    """The first of a fixed sequence of 400-entry, equal-magnitude vectors
    whose threshold sample at the default target overflows the slots (a
    few percent of them do), so that the rank truncation runs."""
    target = sampling.ts_target(SLOTS)
    for seed in range(10_000):
        rng = np.random.default_rng(seed)
        idx = rng.choice(1 << 20, size=400, replace=False)
        val = rng.choice([-1.0, 1.0], size=400)
        keys, v = sampling._fold_aggregate(idx, val)
        p = np.minimum(1.0, target * v * v / (v * v).sum())
        if int((sampling._sample_hash(keys, 3) < p).sum()) > SLOTS:
            return JaxSparseVec.from_pairs(idx, val, 2 ** 34)
    raise AssertionError("no overflowing vector")


@pytest.mark.parametrize("method", ["ts", "ps"])
def test_pad_sample_batch_is_the_jax_rows_bit_for_bit(method):
    """TS and PS at the default target, including a TS sample that
    overflows (truncation to the slots) and the vector whose support
    fits."""
    vecs = _vectors(1) + [_overflowing_vector()]
    got = pad_sample_batch([_port_vec(v) for v in vecs], slots=SLOTS,
                           method=method, seed=3)
    want = jax_pad_sample(vecs, slots=SLOTS, method=method, seed=3)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    keys, _, taus = got
    assert (keys[-1] >= 0).sum() == SLOTS                # truncated
    assert method == "ts" or (keys[0] >= 0).sum() == SLOTS
    assert 0 < (keys[3] >= 0).sum() <= SLOTS        # fits
    assert np.all(keys[-2] == -1) and taus[-2] == 0
    assert port_se.sorted_prefix_ok(torch.from_numpy(keys))


def test_pad_sample_batch_rejects_what_jax_rejects():
    vecs = [_port_vec(v) for v in _vectors(2)]
    with pytest.raises(ValueError, match="unknown sampling method"):
        pad_sample_batch(vecs, slots=SLOTS, method="bogus")


def test_sorted_prefix_check_finds_each_violation():
    ok = torch.tensor([[1, 5, 9, -1], [3, -2, -2, -2], [-1, -1, -1, -1]],
                      dtype=torch.int32)
    assert port_se.sorted_prefix_ok(ok)
    for bad in ([[1, -1, 4, -1]], [[5, 3, -1, -1]], [[2, 2, -1, -1]]):
        assert not port_se.sorted_prefix_ok(torch.tensor(bad))


def _random_rows(rng, F, B, S, pool, pad):
    """Sample rows with random sorted live prefixes over a small key pool
    (so rows match), random values and positive taus; a row with no live
    slot keeps tau 0."""
    keys = np.full((F, B, S), pad, np.int32)
    vals = np.zeros((F, B, S), np.float32)
    taus = np.zeros((F, B), np.float32)
    for f in range(F):
        for b in range(B):
            live = int(rng.integers(0, min(S, pool) + 1))
            keys[f, b, :live] = np.sort(rng.choice(pool, size=live,
                                                   replace=False))
            vals[f, b, :live] = rng.normal(size=live)
            taus[f, b] = rng.uniform(0.1, 5.0) if live else 0.0
    return keys, vals, taus


def test_inclusion_probs_match_jax_bit_for_bit():
    rng = np.random.default_rng(4)
    _, vals, taus = _random_rows(rng, 3, 7, 33, 50, -1)
    vals[0, 0, :5] = [1e-30, -1e30, 3.0, 0.0, 1e-3]
    taus[1, :3] = [0.0, -1.0, 1e-20]
    got = port_se.sample_inclusion_probs(torch.from_numpy(vals),
                                         torch.from_numpy(taus)).numpy()
    want = np.asarray(jax_probs(jnp.asarray(vals), jnp.asarray(taus)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("S, Q, P", [(90, 5, 11), (33, 1, 20)])
def test_plain_estimate_matches_jax_kernel_and_ref(S, Q, P):
    """Spare -2 corpus rows and -1 query pads included."""
    rng = np.random.default_rng(S)
    kq, vq, tq = _random_rows(rng, 3, Q, S, 64, JAX_QUERY_PAD)
    kc, vc, tc = _random_rows(rng, 3, P, S, 64, JAX_CORPUS_PAD)
    kc[:, -2:], vc[:, -2:], tc[:, -2:] = JAX_CORPUS_PAD, 0.0, 0.0
    assert (port_se.SAMPLE_QUERY_PAD_KEY, port_se.SAMPLE_CORPUS_PAD_KEY) == \
        (JAX_QUERY_PAD, JAX_CORPUS_PAD)
    got = ops.sample_estimate_fields(
        *(torch.from_numpy(x) for x in (kq, vq, tq, kc, vc, tc)),
        qmap=QMAP, cmap=CMAP).numpy()
    aq = jax_probs(jnp.asarray(vq), jnp.asarray(tq))
    ac = jax_probs(jnp.asarray(vc), jnp.asarray(tc))
    args = (jnp.asarray(kq), jnp.asarray(vq), aq, jnp.asarray(kc),
            jnp.asarray(vc), ac)
    kernel = np.asarray(sample_estimate_fields_pallas(
        *args, qmap=QMAP, cmap=CMAP, interpret=True))
    ref = np.asarray(jax_ref.sample_estimate_fields_ref(*args, qmap=QMAP,
                                                        cmap=CMAP))
    assert got.shape == (6, Q, P) and np.count_nonzero(got) > 0
    assert np.all(got[:, :, -2:] == 0)
    for want in (kernel, ref):
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


def test_plain_estimate_takes_a_strided_corpus_and_one_query():
    """A tenant slice of the store's buffers and Q = 1 give the same bits
    as a contiguous copy and the full query batch."""
    rng = np.random.default_rng(8)
    q = [torch.from_numpy(x) for x in _random_rows(rng, 3, 4, 24, 40, -1)]
    c = [torch.from_numpy(x) for x in _random_rows(rng, 3, 15, 24, 40, -2)]
    full = ops.sample_estimate_fields(*q, *c, qmap=QMAP, cmap=CMAP)
    part = ops.sample_estimate_fields(*(x[:, 2:3] for x in q),
                                      *(x[:, 3:12] for x in c),
                                      qmap=QMAP, cmap=CMAP)
    assert torch.equal(part, full[:, 2:3, 3:12])


def test_wrapper_routes_by_device_and_refuses_cpu_in_the_kernel():
    k = torch.tensor([[[1, 2, -1]]], dtype=torch.int32)
    v = torch.ones((1, 1, 3))
    with pytest.raises(ValueError, match="CUDA tensors"):
        port_se.sample_estimate_fields_cuda(k, v, v, k, v, torch.ones((1, 1)),
                                            qmap=(0,), cmap=(0,))
    with pytest.raises(TypeError):
        port_se.sample_estimate_fields_plain(k.float(), v, v, k, v, v,
                                             qmap=(0,), cmap=(0,))
    before = port_se.sample_estimate_fields_cuda.launches
    out = ops.sample_estimate_fields(k, v, torch.zeros((1, 1)), k, v,
                                     torch.zeros((1, 1)), qmap=(0,),
                                     cmap=(0,))
    assert port_se.sample_estimate_fields_cuda.launches == before
    assert out.item() == 2.0          # two matches, probability 1 each


@pytest.mark.parametrize("bad", ["shape", "dtype", "device"])
def test_kernel_wrapper_checks_the_taus(bad):
    """The kernel takes the corpus taus ``tc [C, P]`` f32 on the planes'
    device, in place of a probability plane, and says so before it asks
    for a card."""
    k = torch.tensor([[[1, 2, -1]], [[2, -1, -1]]], dtype=torch.int32)
    v = torch.ones((2, 1, 3))
    tc = {"shape": torch.ones((2, 1, 3)), "dtype": torch.ones((2, 1),
                                                              dtype=torch.float64),
          "device": torch.ones((2, 1), device="meta")}[bad]
    with pytest.raises(ValueError, match="taus|one device"):
        port_se.sample_estimate_fields_cuda(k[:1], v[:1], v[:1], k, v, tc,
                                            qmap=(0,), cmap=(1,))
    with pytest.raises(ValueError, match="taus|one device"):
        port_se.sample_estimate_fields_taus_plain(k[:1], v[:1], v[:1], k, v,
                                                  tc, qmap=(0,), cmap=(1,))


def test_cpu_route_is_the_plain_version_on_the_taus_probabilities():
    """On CPU tensors ``ops.sample_estimate_fields`` is the plain version
    on ``sample_inclusion_probs(vc, tc)``, bit for bit, and launches
    nothing."""
    rng = np.random.default_rng(12)
    q = [torch.from_numpy(x) for x in _random_rows(rng, 3, 3, 29, 40, -1)]
    c = [torch.from_numpy(x) for x in _random_rows(rng, 3, 13, 29, 40, -2)]
    aq = port_se.sample_inclusion_probs(q[1], q[2])
    ac = port_se.sample_inclusion_probs(c[1], c[2])
    before = port_se.sample_estimate_fields_cuda.launches
    got = ops.sample_estimate_fields(*q, *c, qmap=QMAP, cmap=CMAP)
    assert port_se.sample_estimate_fields_cuda.launches == before
    want = port_se.sample_estimate_fields_plain(q[0], q[1], aq, c[0], c[1],
                                                ac, qmap=QMAP, cmap=CMAP)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _probe_emulation(kq, vq, aq, kc, vc, tc, qmap, cmap, s_total):
    """The CUDA kernel's accumulation in numpy f32 scalars: for each (g, q,
    p), the corpus row's keys in ascending slot u up to its first negative
    key, each looked up among the query row's live keys; a match forms
    ``x * v / min(aq, ac)`` (ac from the value and the row's tau in
    ``_inclusion_probs``' order) and, where that minimum is positive, adds
    it to a sum that starts at +0, one add a match."""
    f32 = np.float32
    G, Q, P = len(qmap), kq.shape[1], kc.shape[1]
    out = np.zeros((G, Q, P), np.float32)
    for g, (qf, cf) in enumerate(zip(qmap, cmap)):
        for q in range(Q):
            where = {int(k): t for t, k in enumerate(kq[qf, q]) if k >= 0}
            for p in range(P):
                acc, tau = f32(0.0), f32(tc[cf, p])
                for u, k in enumerate(kc[cf, p]):
                    if k < 0:
                        break
                    t = where.get(int(k))
                    if t is None:
                        continue
                    v = f32(vc[cf, p, u])
                    if v == 0:
                        c = f32(0.0)
                    elif not tau > 0:
                        c = f32(1.0)
                    else:
                        c = min(f32(1.0), f32(f32(f32(s_total) * v) * v) / tau)
                    pr = min(f32(aq[qf, q, t]), c)
                    if pr > 0:
                        acc = f32(acc + f32(f32(vq[qf, q, t]) * v) / pr)
                out[g, q, p] = acc
    return out


def _many_match_rows(rng, F, B, S, pool, pad, *, exact):
    """Rows over a pool about as large as S (so pairs share most keys),
    signed values (small dyadic ones with ``exact``: every sum is exact in
    any order), a fifth of the taus <= 0, an empty row first and a live
    prefix that fills all S slots last."""
    keys = np.full((F, B, S), pad, np.int32)
    vals = np.zeros((F, B, S), np.float32)
    taus = np.zeros((F, B), np.float32)
    for f in range(F):
        for b in range(B):
            live = 0 if b == 0 else S if b == B - 1 else \
                int(rng.integers(S // 2, S + 1))
            keys[f, b, :live] = np.sort(rng.choice(pool, live, replace=False))
            vals[f, b, :live] = (rng.choice([-2.0, -1.0, -0.5, 0.5, 1.0, 4.0],
                                            live) if exact
                                 else rng.normal(size=live))
            taus[f, b] = (-1.0 if exact or rng.random() < 0.2
                          else rng.uniform(0.1, 5.0))
    return keys, vals, taus


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("exact", [True, False])
def test_probe_accumulation_matches_plain_and_jax_kernel(exact, packed):
    """The kernels' order -- terms in ascending corpus slot, one add a
    match -- gives the plain version's bits on rows with many matches,
    signed values, taus <= 0, an empty query row and a row whose live keys
    fill every slot; packed, on the decoded values of an odd width with
    its pad slot.  Against the JAX interpret-mode kernel (tree sums): bit
    for bit where every sum is exact, else within this file's
    tolerance."""
    S, Q, P = (23 if packed else 24), 3, 7
    rng = np.random.default_rng(40 + exact + 2 * packed)
    kq, vq, tq = _many_match_rows(rng, 3, Q, S, 30, JAX_QUERY_PAD,
                                  exact=exact)
    kc, vc, tc = _many_match_rows(rng, 3, P, S, 30, JAX_CORPUS_PAD,
                                  exact=exact)
    aq = port_se.sample_inclusion_probs(torch.from_numpy(vq),
                                        torch.from_numpy(tq))
    jq = (jnp.asarray(kq), jnp.asarray(vq),
          jax_probs(jnp.asarray(vq), jnp.asarray(tq)))
    if packed:
        kc = np.pad(kc, ((0, 0), (0, 0), (0, 1)), constant_values=JAX_CORPUS_PAD)
        wc = pack_halfwords_f32(torch.from_numpy(np.pad(
            vc, ((0, 0), (0, 0), (0, 1)))))
        vc = unpack_halfwords_f32(wc).numpy()
        plain = port_se.sample_estimate_fields_packed_plain(
            *(torch.from_numpy(x) for x in (kq, vq)), aq, torch.from_numpy(kc),
            wc, torch.from_numpy(tc), qmap=QMAP, cmap=CMAP).numpy()
        kernel = np.asarray(sample_estimate_fields_packed_pallas(
            *jq, jnp.asarray(kc), jnp.asarray(wc.numpy()), jnp.asarray(tc),
            s_total=S, qmap=QMAP, cmap=CMAP, interpret=True))
    else:
        plain = port_se.sample_estimate_fields_taus_plain(
            *(torch.from_numpy(x) for x in (kq, vq)), aq,
            *(torch.from_numpy(x) for x in (kc, vc, tc)), qmap=QMAP,
            cmap=CMAP).numpy()
        kernel = np.asarray(sample_estimate_fields_pallas(
            *jq, jnp.asarray(kc), jnp.asarray(vc),
            jax_probs(jnp.asarray(vc), jnp.asarray(tc)), qmap=QMAP,
            cmap=CMAP, interpret=True))
    emulated = _probe_emulation(kq, vq, aq.numpy(), kc, vc, tc, QMAP, CMAP, S)
    assert (kc[:, -1, :S] >= 0).all() and (kq[:, 0] < 0).all()
    assert np.count_nonzero(emulated) > Q * P
    np.testing.assert_array_equal(emulated.view(np.int32),
                                  plain.view(np.int32))
    if exact:
        np.testing.assert_array_equal(emulated, kernel)
    else:
        scale = float(np.abs(kernel).max())
        np.testing.assert_allclose(emulated, kernel, rtol=1e-5,
                                   atol=1e-5 * scale)


@pytest.mark.parametrize("py_name, cu_name", [
    ("MAX_ITEMS", "kMaxItems"), ("SLOT_BYTES", "kSlotBytes"),
    ("CHUNK_STEPS", "kSteps")])
def test_kernel_geometry_mirrors_the_cuda_source(py_name, cu_name):
    """The launch plan and the issue floor's lookup count read the kernel's
    geometry from Python constants: each equals its ``constexpr`` in
    ``csrc/sample_estimate_fields.cu``."""
    src = (Path(port_se.__file__).parent / "csrc"
           / "sample_estimate_fields.cu").read_text()
    found = re.findall(rf"constexpr int {cu_name} = (\d+);", src)
    assert found == [str(getattr(port_se, py_name))]


@pytest.mark.parametrize("G, Q, S", [
    (6, 1, 768), (6, 16, 768), (6, 17, 33), (16, 17, 33), (6, 2, 5_000),
    (1, 1, port_se.MAX_SLOTS)])
def test_items_per_block_plans_groups_that_fit(G, Q, S):
    """The kernel's launch plan: at most 32 (query, pair) items a block (a
    lane each), their tables (32 bytes a query slot of each item) within
    ``GROUP_BYTES`` unless one item alone exceeds it, balanced groups that
    cover every item; one item's tables at ``MAX_SLOTS`` fit a block's 227
    KB beside its 2 KB of static shared memory."""
    per, groups = port_se.items_per_block(G, Q, S)
    assert 1 <= per <= port_se.MAX_ITEMS
    assert (groups - 1) * per < G * Q <= groups * per
    assert per == 1 or port_se.SLOT_BYTES * per * S <= port_se.GROUP_BYTES
    assert port_se.SLOT_BYTES * port_se.MAX_SLOTS + 2048 <= 232_448
    items = port_se.block_items(G, Q, S)
    assert len(items) == groups and all(len(x) <= per for x in items)
    assert [q * G + g for x in items for q, g in x] == list(range(G * Q))
    if (G, Q, S) == (6, 1, 768):
        assert (per, groups) == (6, 1)   # a search: one group
