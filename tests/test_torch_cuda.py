"""Card-only checks of the port's CUDA kernels against their plain
versions (``pytest -m cuda``).  This file imports nothing of JAX, so it runs
on a machine that has the card but not the JAX package; it skips here."""
import functools

import numpy as np
import pytest
import torch
from _torch_lm import TOL as LM_TOL
from _torch_lm import (GRAD_TOL, Recorded, near_tie_rows, tiny_cfg,
                       trainer_config)
from _torch_lm import rel as lm_rel

from repro_torch.core.dmh import dmh_replication, replicate_keys
from repro_torch.core.types import SparseVec
from repro_torch.data.ingest import (pad_linear_batch, pad_sample_batch,
                                     pad_sparse_batch)
from repro_torch.kernels import countsketch as port_cs
from repro_torch.kernels import dmh_sketch as port_dmh
from repro_torch.kernels import estimate as port_est
from repro_torch.kernels import icws_sketch as port_sketch
from repro_torch.kernels import jl_sketch as port_jl
from repro_torch.kernels import ops
from repro_torch.kernels import sample_estimate as port_se
from repro_torch.kernels.packed import (pack_halfwords_f32, pack_sketch_vals,
                                        unpack_halfwords_f32)

# small shapes: one intra-op thread per test process, so that parallel
# test workers do not oversubscribe the cores
torch.set_num_threads(1)

QMAP = (0, 1, 0, 2, 0, 1)
CMAP = (0, 0, 1, 0, 2, 1)
M = 128


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _vectors(seed, count=12):
    """Overlapping sparse vectors with a few heavy entries, one empty."""
    rng = np.random.default_rng(seed)
    base = rng.choice(5000, size=400, replace=False)
    vecs = []
    for _ in range(count):
        idx = np.unique(np.concatenate([base[rng.random(400) < 0.5],
                                        rng.integers(5000, 2 ** 33, 100)]))
        val = rng.normal(size=idx.size) * np.where(
            rng.random(idx.size) < 0.1, 25.0, 1.0)
        vecs.append(SparseVec.from_pairs(idx, val, 2 ** 34))
    return vecs + [SparseVec.from_pairs([], [], 10)]


def _batch(seed, device):
    w, keys, vals, norms = pad_sparse_batch(_vectors(seed))
    return [torch.from_numpy(a).to(device) for a in (w, keys, vals)], norms


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 4])
def test_sketch_kernel_matches_plain_version(cuda, seed):
    args, _ = _batch(seed, cuda)
    before = port_sketch.icws_sketch_cuda.launches
    got = ops.icws_sketch(*args, m=M, seed=seed)
    torch.cuda.synchronize()
    assert port_sketch.icws_sketch_cuda.launches == before + 1
    want = port_sketch.icws_sketch_plain(*args, m=M, seed=seed)
    agree = got[0] == want[0]
    assert agree.float().mean().item() >= 0.99
    assert torch.equal(got[1][agree], want[1][agree])
    assert torch.equal(got[3][agree], want[3][agree])
    assert torch.all(got[0][-1] == -1) and torch.all(got[1][-1] == 0)
    # a row does not depend on the launch shape (group size, batch size)
    one = ops.icws_sketch(*(a[:1] for a in args), m=M, seed=seed)
    for x, y in zip(one, got):
        assert torch.equal(x[0], y[0])


def _wide_batch(seed, B, nnz, device):
    """B rows of ``nnz`` non-zeros with keys from a 2^40 domain (the last
    row empty when B > 3), padded as the ingest path pads them."""
    rng = np.random.default_rng(seed)
    vecs = [SparseVec.from_pairs(
        np.unique(rng.integers(0, 2 ** 40, nnz + 64))[:nnz],
        rng.normal(size=nnz), 2 ** 40) for _ in range(B - (B > 3))]
    vecs += [SparseVec.from_pairs([], [], 10)] * (B > 3)
    return [torch.from_numpy(a).to(device)
            for a in pad_sparse_batch(vecs)[:3]]


@pytest.mark.cuda
@pytest.mark.parametrize("B, nnz", [(3, 4500), (48, 1000)])
def test_sketch_rows_do_not_depend_on_group_size(cuda, monkeypatch, B, nnz):
    """Groups of 1, 32, 64 and 256 threads a (row, t) pair (64 and 256 merge
    across warps through shared memory; the row staged in chunks of 2,048
    non-zeros at N >= 4,096) give the same bits, those of the group size
    the launch picks; fingerprints agree with plain on at least 99% of
    slots, values and argkeys bit for bit where they do.  The Pack variant
    at 64 and 256 gives the same planes and the codec of its values."""
    args = _wide_batch(B, B, nnz, cuda)
    m = 512
    want = port_sketch.icws_sketch_cuda(*args, m=m, seed=3)
    want_packed = port_sketch.icws_sketch_packed_cuda(*args, m=m, seed=3)
    for S in (1, 32, 64, 256):
        monkeypatch.setattr(port_sketch, "_group_size", lambda B, m, N: S)
        got = port_sketch.icws_sketch_cuda(*args, m=m, seed=3)
        assert all(_bits_equal(x, y) for x, y in zip(got, want)), S
        if S > 32:
            packed = port_sketch.icws_sketch_packed_cuda(*args, m=m, seed=3)
            assert all(_bits_equal(x, y) for x, y in zip(packed, want_packed))
            assert torch.equal(packed[4], pack_sketch_vals(got[1], got[2]))
    plain = port_sketch.icws_sketch_plain(*args, m=m, seed=3)
    agree = want[0] == plain[0]
    assert agree.float().mean().item() >= 0.99
    assert torch.equal(want[1][agree], plain[1][agree])
    assert torch.equal(want[3][agree], plain[3][agree])
    if B > 3:
        assert torch.all(want[0][-1] == -1) and torch.all(want[1][-1] == 0)


# field maps of B2: the service's six pairs, one pair, five pairs on one
# corpus field (two groups at a 16-query tile), a corpus field no pair
# reads, sixteen pairs
FIELD_MAPS = {"service": (QMAP, CMAP), "one pair": ((0,), (1,)),
              "one corpus field": ((0, 1, 2, 0, 1), (2, 2, 2, 2, 2)),
              "field 1 unread": ((0, 1), (0, 2)),
              "sixteen pairs": (tuple(g % 3 for g in range(16)),
                                tuple(g * 7 % 3 for g in range(16)))}


def _fields_case(m, Q, device):
    """Queries ``[3, Q, m]`` (live sketch rows with some query pads) and a
    ``[3, 320, m]`` corpus of rows that copy the samples of a query row of
    a random field with noise, the last five rows spare (-2)."""
    rng = np.random.default_rng(m + Q)
    args, _ = _batch(1, "cpu")
    fp, val, _, _ = port_sketch.icws_sketch_plain(*args, m=m, seed=1)
    pick = torch.from_numpy(rng.integers(0, fp.shape[0] - 1, size=3 * Q))
    fq, vq = fp[pick].reshape(3, Q, m), val[pick].reshape(3, Q, m)
    fq[torch.from_numpy(rng.random((3, Q, m)) < 0.05)] = -1
    src = torch.from_numpy(rng.integers(0, Q, size=320))
    fld = torch.from_numpy(rng.integers(0, 3, size=(3, 320)))
    fc, vc = fq[fld, src].clone(), vq[fld, src] * 1.5
    noise = torch.from_numpy(rng.random((3, 320, m)) < 0.3)
    fc[noise] = torch.from_numpy(rng.integers(0, 2 ** 31 - 1, int(noise.sum()),
                                              dtype=np.int64)).int()
    fc[fc < 0] = 7
    fc[:, -5:], vc[:, -5:] = -2, 0.0
    return [x.to(device) for x in (fq, vq, fc, vc)]


def _off_by_4(x):
    """A contiguous copy of ``x`` whose data starts 4 bytes past 16-byte
    alignment (the kernels' 4-byte copy route)."""
    return torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:] \
        .view(x.shape).copy_(x)


@pytest.mark.cuda
@pytest.mark.parametrize("maps", FIELD_MAPS)
@pytest.mark.parametrize("m", [48, 200, 512])
def test_fields_kernel_matches_plain_version_bitwise(cuda, m, maps):
    """Same IEEE operations in the same t order: kernel and plain version
    agree bit for bit for every field map, at Q in {1, 2, 16, 17, 33}
    (one query, a short tile, a full one, one and two past it), on P = 300
    rows (not a multiple of the 128-row tile) of a strided tenant slice of
    the corpus planes and of a view 4 bytes off 16-byte alignment (the
    4-byte copy route)."""
    qmap, cmap = FIELD_MAPS[maps]
    for Q in (1, 2, 16, 17, 33):
        fq, vq, fc, vc = _fields_case(m, Q, cuda)
        for fcs, vcs in ((fc[:, 7:307], vc[:, 7:307]),
                         (_off_by_4(fc)[:, 7:307], _off_by_4(vc)[:, 7:307])):
            before = port_est.estimate_fields_cuda.launches
            cnt, sw = ops.estimate_partials_fields(fq, vq, fcs, vcs,
                                                   qmap=qmap, cmap=cmap)
            torch.cuda.synchronize()
            assert port_est.estimate_fields_cuda.launches == before + 1
            cnt_p, sw_p = port_est.estimate_fields_plain(
                fq, vq, fcs, vcs, qmap=qmap, cmap=cmap)
            assert cnt.sum().item() > 0
            assert _bits_equal(cnt, cnt_p) and _bits_equal(sw, sw_p)


def _linear_batch(seed, device):
    keys, vals = pad_linear_batch(_vectors(seed))
    return [torch.from_numpy(a).to(device) for a in (keys, vals)]


def _one_bucket_keys(count, *, width, seed):
    """``count`` distinct int32 keys whose rep-0 bucket (of ``width``, under
    ``seed``) is key 0's, found with the port's own hash."""
    k = torch.arange(2 * count * width, dtype=torch.int64)
    bucket, _ = port_cs._hash(k, torch.zeros(1, dtype=torch.int64),
                              width=width, seed=seed)
    keys = k[bucket == bucket[0]][:count]
    assert keys.numel() == count
    return keys.to(torch.int32)


def _linear_rows(rows, device, *, width=153, seed=2):
    """Padded [B, N] keys and values: the ``_vectors`` batch; or (B, nnz):
    row 0 of ``nnz`` non-zeros, the others of nnz / 2 to nnz, the last
    empty, keys over the int32 range, N = nnz rounded up to 256 as the
    ingest path pads; or "one bucket": (3, 10,000) rows whose row 0 keys
    all share one rep-0 bucket of ``width`` under ``seed``."""
    if rows == "vectors":
        return _linear_batch(5, device)
    B, nnz = (3, 10_000) if rows == "one bucket" else rows
    rng = np.random.default_rng(B * nnz)
    N = -(-nnz // 256) * 256
    keys = rng.integers(-2 ** 31, 2 ** 31, (B, N)).astype(np.int32)
    vals = rng.normal(size=(B, N)).astype(np.float32)
    sizes = rng.integers(nnz // 2, nnz + 1, B)
    sizes[0], sizes[-1] = nnz, 0 if B > 1 else nnz
    for b, n in enumerate(sizes):
        keys[b, n:], vals[b, n:] = 0, 0.0
    if rows == "one bucket":
        keys[0, :nnz] = _one_bucket_keys(nnz, width=width, seed=seed).numpy()
    return [torch.from_numpy(a).to(device) for a in (keys, vals)]


def _alone(fn, keys, vals, b):
    """Row b launched alone, padded to its own non-zeros (256 at least)."""
    live = torch.nonzero(vals[b]).flatten()
    n = int(live.max()) + 1 if live.numel() else 0
    N = max(256, -(-n // 256) * 256)
    return fn(keys[b:b + 1, :N].contiguous(), vals[b:b + 1, :N].contiguous())[0]


# Rows of the linear sketch cases: the small vectors batch; a 10,000-row
# table alone and three (N = 10,240, several staging chunks); micro-batches
# of 48 rows.
@pytest.mark.cuda
@pytest.mark.parametrize("rows, width, reps", [
    ("vectors", 153, 5), ("vectors", 300, 4), ((1, 10_000), 153, 5),
    ((48, 4000), 153, 5), ((3, 10_000), 1500, 5), ((48, 1000), 1500, 5),
    ("one bucket", 153, 5)])
def test_countsketch_kernel_matches_plain_version_bitwise(cuda, rows, width,
                                                          reps):
    """Both sum each bucket over ascending n: the same bits, also for a row
    alone at its own padded N (a batch shape does not enter the order),
    with W past one block (1,500 buckets) and with every key of a row in one
    bucket (one thread's chain of 10,000 adds)."""
    keys, vals = _linear_rows(rows, cuda, width=width, seed=2)
    before = port_cs.countsketch_sparse_cuda.launches
    got = ops.countsketch_sparse(keys, vals, width=width, reps=reps, seed=2)
    torch.cuda.synchronize()
    assert port_cs.countsketch_sparse_cuda.launches == before + 1
    want = port_cs.countsketch_sparse_plain(keys, vals, width=width,
                                            reps=reps, seed=2)
    assert torch.equal(got, want)
    B = keys.shape[0]
    assert B == 1 or torch.all(got[-1] == 0)
    for b in sorted({0, B // 2, max(B - 2, 0)}):
        one = _alone(lambda k, v: ops.countsketch_sparse(
            k, v, width=width, reps=reps, seed=2), keys, vals, b)
        assert torch.equal(one, got[b])
    if rows == "one bucket":
        assert int((got[0, 0] != 0).sum()) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("rows, m", [
    ("vectors", 769), ("vectors", 97), ((1, 10_000), 769), ((3, 10_000), 769),
    ((48, 4000), 769), ((48, 4000), 97), ((48, 1000), 1)])
def test_jl_kernel_matches_plain_version_bitwise(cuda, rows, m):
    """The same bits as plain, and for a row alone at its own padded N, at
    sample tiles of 8 (B = 1 and 3, and m = 1) and 16 (B = 48); no m here
    is a multiple of the tile."""
    keys, vals = _linear_rows(rows, cuda)
    before = port_jl.jl_sketch_cuda.launches
    got = ops.jl_sketch(keys, vals, m=m, seed=4)
    torch.cuda.synchronize()
    assert port_jl.jl_sketch_cuda.launches == before + 1
    want = port_jl.jl_sketch_plain(keys, vals, m=m, seed=4)
    assert torch.equal(got, want)
    B = keys.shape[0]
    assert B == 1 or torch.all(got[-1] == 0)
    for b in sorted({0, B // 2, max(B - 2, 0)}):
        one = _alone(lambda k, v: ops.jl_sketch(k, v, m=m, seed=4), keys, vals,
                     b)
        assert torch.equal(one, got[b])


@pytest.mark.cuda
@pytest.mark.parametrize("rows, m", [((3, 10_000), 769), ((48, 1000), 97)])
def test_jl_rows_do_not_depend_on_the_sample_tile(cuda, monkeypatch, rows, m):
    """Tiles of 8 and 16 samples a block give the same bits."""
    keys, vals = _linear_rows(rows, cuda)
    want = port_jl.jl_sketch_cuda(keys, vals, m=m, seed=4)
    for tile in (8, 16):
        monkeypatch.setattr(port_jl, "_t_tile", lambda B, m: tile)
        assert torch.equal(port_jl.jl_sketch_cuda(keys, vals, m=m, seed=4),
                           want), tile


# Cases of the linear-dots kernels (B8, B12): (Q, qmap, cmap, corpus rows).
# Q = 1, 3 and 16 take the query tiles 1, 4 and 16; Q = 17 and 40 leave a
# ragged tile.  One map has a corpus field that feeds five pairs, so its
# group splits over two blocks; one has sixteen pairs, cmap unsorted; one
# corpus slice has a row stride of two rows.
FIVE_QMAP, FIVE_CMAP = (0, 1, 2, 0, 2, 1, 1), (1, 1, 0, 1, 1, 2, 1)
G16_QMAP = (2, 0, 1, 1, 0, 2, 0, 1, 2, 2, 1, 0, 0, 1, 2, 0)
G16_CMAP = (1, 2, 0, 2, 1, 0, 0, 2, 1, 0, 1, 2, 0, 1, 2, 1)
LINEAR_CASES = {
    "Q1": (1, QMAP, CMAP, slice(7, 290)),
    "Q3": (3, QMAP, CMAP, slice(7, 290)),
    "Q16": (16, QMAP, CMAP, slice(7, 290)),
    "Q17": (17, QMAP, CMAP, slice(7, 290)),
    "Q40": (40, QMAP, CMAP, slice(7, 290)),
    "five-pairs-of-one-field": (16, FIVE_QMAP, FIVE_CMAP, slice(7, 290)),
    "sixteen-pairs-unsorted": (5, G16_QMAP, G16_CMAP, slice(7, 290)),
    "row-strided": (16, QMAP, CMAP, slice(3, 290, 2)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", LINEAR_CASES)
@pytest.mark.parametrize("R, W", [(5, 153), (1, 769)])
def test_linear_fields_kernel_matches_plain_version_bitwise(cuda, R, W, case):
    """An f32 product then an f32 add per w, in order, in both: bit for bit
    at every query tile and map, on a slice of the corpus tables, and one
    query alone equals its row of the batch."""
    Q, qmap, cmap, rows = LINEAR_CASES[case]
    rng = np.random.default_rng(R)
    tq = torch.from_numpy(rng.normal(size=(3, Q, R, W)).astype(np.float32))
    tc = torch.from_numpy(rng.normal(size=(3, 300, R, W)).astype(np.float32))
    tc[:, -5:] = 0.0
    tq, tc = tq.to(cuda), tc.to(cuda)[:, rows]
    before = port_est.linear_estimate_fields_cuda.launches
    got = port_est.linear_estimate_fields_cuda(tq, tc, qmap=qmap, cmap=cmap)
    torch.cuda.synchronize()
    assert port_est.linear_estimate_fields_cuda.launches == before + 1
    want = port_est.linear_estimate_fields_plain(tq, tc, qmap=qmap, cmap=cmap)
    assert torch.equal(got, want)
    one = port_est.linear_estimate_fields_cuda(tq[:, Q - 1:], tc, qmap=qmap,
                                               cmap=cmap)
    assert torch.equal(one[:, :, 0], got[:, :, Q - 1])


def _dmh_rows(m, B, device, n=256):
    """B unreplicated rows of n lanes: random rows, led by a row holding
    one key at lanes 0 and n - 1 with the same weight (equal a for each
    replica, lanes in two blocks of a cluster larger than c: the tie goes
    to lane 0), a row of one live lane, a row of pads only, and a row
    whose live keys all bin to bin 3 (every lane where c = 1)."""
    from repro_torch.kernels.common import DMH_STREAM_BIN, hash_u32, salt_for
    rng = np.random.default_rng(m + B)
    w = (rng.random((B, n)) + 0.05).astype(np.float32)
    w[rng.random((B, n)) < 0.3] = 0.0
    keys = rng.integers(-2 ** 31, 2 ** 31, (B, n)).astype(np.int32)
    vals = rng.normal(size=(B, n)).astype(np.float32)
    w[0] = 0.5 + rng.random(n).astype(np.float32)
    keys[0, n - 1], w[0, n - 1] = keys[0, 0], w[0, 0]
    if B > 1:
        w[1] = 0.0
        w[1, 5] = 2.0
    if B > 2:
        w[2] = 0.0
    if B > 3:
        cand = torch.from_numpy(rng.integers(0, 2 ** 32, 200_000))
        zero = torch.zeros((), dtype=torch.int64)
        bins = hash_u32(cand, salt_for(3, DMH_STREAM_BIN, zero)) % m
        hit = cand[bins == 3][:40].numpy()
        keys[3] = 0
        keys[3, :hit.size] = hit.astype(np.uint32).view(np.int32)
        w[3] = 0.0
        w[3, :hit.size] = 1.0 + rng.random(hit.size)
    return [torch.from_numpy(a).to(device) for a in (w, keys, vals)]


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2, 8, 16])
@pytest.mark.parametrize("m, B", [(127, 1), (200, 3), (512, 3), (512, 48),
                                  (127, 48)])
def test_dmh_kernel_matches_plain_version_bitwise(cuda, monkeypatch, m, B,
                                                  cluster):
    """The packed (a, lane) atomicMin into the owning block of the row's
    cluster and the plain version's two scatter-mins pick the same winner:
    every plane equal, with and without the pack epilogue (odd m: its pad
    slot), at each cluster size (at 16, a block of m = 200 owns no bin),
    with the replicas derived in the kernel equal to host-replicated rows;
    one row alone gives its bits in the batch; the pad row gives the
    sentinels."""
    c = dmh_replication(m)
    rule = port_dmh._launch_shape
    monkeypatch.setattr(port_dmh, "_launch_shape", lambda B_, m_, lanes: (
        cluster, min(1024, max(64, 32 * -(-lanes // (32 * cluster))))))
    args = _dmh_rows(m, B, cuda)
    for pack, kernel, plain in (
            (False, port_dmh.dmh_sketch_cuda, port_dmh.dmh_sketch_plain),
            (True, port_dmh.dmh_sketch_packed_cuda,
             port_dmh.dmh_sketch_packed_plain)):
        before = kernel.launches
        got = ops.dmh_sketch(*args, m=m, seed=3, replicas=c, pack_vals=pack)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        want = plain(*args, m=m, seed=3, replicas=c)
        for x, y in zip(got, want):
            assert _bits_equal(x, y)
    w, keys, vals = (a.cpu().numpy() for a in args)
    rep = [torch.from_numpy(a).to(cuda) for a in (
        np.tile(w, (1, c)),
        replicate_keys(keys.view(np.uint32), c).view(np.int32),
        np.tile(vals, (1, c)))]
    monkeypatch.setattr(port_dmh, "_launch_shape", rule)
    host = ops.dmh_sketch(*rep, m=m, seed=3)
    for x, y in zip(got, host):
        assert _bits_equal(x, y)
    one = ops.dmh_sketch(*(a[B - 1:] for a in args), m=m, seed=3, replicas=c)
    for x, y in zip(one, got):
        assert _bits_equal(x[0], y[B - 1])
    if B > 2:
        assert torch.all(got[0][2] == -1) and torch.all(got[0][:2] >= 0)


def _sample_case(device, method, slots, Q, seed):
    """Queries ``[3, Q, slots]`` and a ``[3, rows, slots]`` corpus picked
    from ``pad_sample_batch`` rows (every row sorted; wide vectors fill
    every slot), the last five corpus rows spare; fewer corpus rows at
    the widest slot count, where the plain version's cross is largest."""
    vecs = _vectors(seed, count=3 * Q + 9)
    keys, vals, taus = (torch.from_numpy(a).to(device) for a in
                        pad_sample_batch(vecs, slots=slots, method=method,
                                         seed=2))
    assert port_se.sorted_prefix_ok(keys)
    q = (keys[:3 * Q].reshape(3, Q, slots), vals[:3 * Q].reshape(3, Q, slots),
         taus[:3 * Q].reshape(3, Q))
    rows = 300 if slots <= 768 else 24
    pick = torch.from_numpy(np.random.default_rng(seed + 1).integers(
        0, keys.shape[0], size=(3, rows))).to(device)
    c = [keys[pick].clone(), vals[pick].clone(), taus[pick].clone()]
    c[0][:, -5:], c[1][:, -5:], c[2][:, -5:] = -2, 0.0, 0.0
    return q, c


SAMPLE_SLOTS = [(1, "ps"), (33, "ts"), (768, "ps"),
                (port_se.MAX_SLOTS, "ts")]


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [1, 2, 17])
@pytest.mark.parametrize("slots, method", SAMPLE_SLOTS)
def test_sample_kernel_matches_plain_version_bitwise(cuda, method, slots, Q):
    """The probe adds each pair's terms in ascending corpus slot, the plain
    version's full cross in ascending query slot: the same order under the
    sorted-prefix layout, so bit for bit -- the kernel on the taus, the
    plain version on their probabilities -- on a strided tenant slice of
    the corpus planes with spare rows, and one query alone equals its row
    of the batch."""
    q, c = _sample_case(cuda, method, slots, Q, 8)
    aq = port_se.sample_inclusion_probs(q[1], q[2])
    ac = port_se.sample_inclusion_probs(c[1], c[2])
    sl = slice(7, c[0].shape[1] - 2)
    before = port_se.sample_estimate_fields_cuda.launches
    got = ops.sample_estimate_fields(*q, *(x[:, sl] for x in c), qmap=QMAP,
                                     cmap=CMAP)
    torch.cuda.synchronize()
    assert port_se.sample_estimate_fields_cuda.launches == before + 1
    want = port_se.sample_estimate_fields_plain(
        q[0], q[1], aq, c[0][:, sl], c[1][:, sl], ac[:, sl], qmap=QMAP,
        cmap=CMAP)
    assert torch.count_nonzero(got).item() > 0
    assert _bits_equal(got, want)
    one = port_se.sample_estimate_fields_cuda(
        q[0][:, Q - 1:], q[1][:, Q - 1:], aq[:, Q - 1:], c[0][:, sl],
        c[1][:, sl], c[2][:, sl], qmap=QMAP, cmap=CMAP)
    assert _bits_equal(one[:, 0], got[:, Q - 1])


@pytest.mark.cuda
@pytest.mark.parametrize("group_bytes", [1, port_se.GROUP_BYTES, 1 << 20])
def test_sample_query_groups_give_the_same_bits(cuda, monkeypatch,
                                                group_bytes):
    """One (query, pair) item a block (one byte of shared memory allowed:
    the launcher still gives each block an item), the default groups or 32
    items a block: each equals the plain twin bit for bit, for both
    kernels."""
    monkeypatch.setattr(port_se, "GROUP_BYTES", group_bytes)
    q, c = _sample_case(cuda, "ts", 97, 17, 21)
    aq = port_se.sample_inclusion_probs(q[1], q[2])
    got = port_se.sample_estimate_fields_cuda(q[0], q[1], aq, *c, qmap=QMAP,
                                              cmap=CMAP)
    want = port_se.sample_estimate_fields_taus_plain(q[0], q[1], aq, *c,
                                                     qmap=QMAP, cmap=CMAP)
    assert torch.count_nonzero(got).item() > 0 and _bits_equal(got, want)
    kc = torch.nn.functional.pad(c[0], (0, 1), value=-2)
    wc = pack_halfwords_f32(torch.nn.functional.pad(c[1], (0, 1)))
    packed = port_se.sample_estimate_fields_packed_cuda(
        q[0], q[1], aq, kc, wc, c[2], qmap=QMAP, cmap=CMAP)
    decoded = port_se.sample_estimate_fields_cuda(
        q[0], q[1], aq, c[0], unpack_halfwords_f32(wc)[..., :97].contiguous(),
        c[2], qmap=QMAP, cmap=CMAP)
    assert _bits_equal(packed, decoded)


@pytest.mark.cuda
def test_sample_estimate_on_the_card_builds_no_corpus_probability_plane(
        cuda):
    """``ops.sample_estimate_fields`` on CUDA tensors takes less peak
    memory than one ``[C, P, S]`` f32 plane: the kernel reads the taus."""
    q, c = _sample_case(cuda, "ps", 768, 2, 30)
    pick = torch.arange(4096, device=cuda) % c[0].shape[1]
    c = [x[:, pick].contiguous() for x in c]
    plane = c[1].numel() * 4
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = ops.sample_estimate_fields(*q, *c, qmap=QMAP, cmap=CMAP)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < plane
    aq = port_se.sample_inclusion_probs(q[1], q[2])
    assert _bits_equal(got, port_se.sample_estimate_fields_taus_plain(
        q[0], q[1], aq, *c, qmap=QMAP, cmap=CMAP))


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["icws", "cs", "jl", "ts", "ps", "dmh"])
def test_service_on_the_card_matches_the_cpu_service(cuda, family):
    rng = np.random.default_rng(3)
    from repro_torch import SketchSearchService
    keys = np.arange(500)
    signal = rng.normal(size=500)
    tables = [("corr", keys, signal + 0.1 * rng.normal(size=500)),
              ("noise", keys, rng.normal(size=500)),
              ("half", np.arange(250, 750), rng.normal(size=500))]
    queries = [(keys, signal), (np.arange(100, 600), rng.normal(size=500))]
    out = []
    for device in ("cpu", "cuda"):
        svc = SketchSearchService(m=M, seed=1, family=family, device=device)
        svc.ingest_many(tables)
        batch = svc.search_batch(queries, top_k=3, min_join=5, micro_batch=4)
        assert batch == [svc.search(k, v, top_k=3, min_join=5)
                         for k, v in queries]
        out.append(batch)
    assert [[r.name for r in q] for q in out[0]] == \
        [[r.name for r in q] for q in out[1]]


def _bits_equal(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("kind, m", [("icws", 127), ("icws", 128),
                                     ("dmh", 127), ("dmh", 512)])
def test_sketch_pack_epilogue_matches_plain_version(cuda, kind, m):
    """The packed plane is the codec of the kernel's own value output, bit
    for bit (odd m: the pad slot zero), and the plain version's on every
    word whose fingerprints agree (all of them for DMH)."""
    w, keys, vals, _ = pad_sparse_batch(_vectors(10))
    args = [torch.from_numpy(a).to(cuda) for a in (w, keys, vals)]
    sketch = ops.icws_sketch if kind == "icws" else functools.partial(
        ops.dmh_sketch, replicas=dmh_replication(m))
    kernel = (port_sketch.icws_sketch_packed_cuda if kind == "icws"
              else port_dmh.dmh_sketch_packed_cuda)
    plain = (port_sketch.icws_sketch_packed_plain if kind == "icws"
             else functools.partial(port_dmh.dmh_sketch_packed_plain,
                                    replicas=dmh_replication(m)))
    before = kernel.launches
    got = sketch(*args, m=m, seed=6, pack_vals=True)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert torch.equal(got[4], pack_sketch_vals(got[1], got[2]))
    for x, y in zip(got[:4], sketch(*args, m=m, seed=6)):
        assert _bits_equal(x, y)
    want = plain(*args, m=m, seed=6)
    ok = torch.nn.functional.pad(got[0] == want[0], (0, m % 2), value=True)
    ok = ok[:, 0::2] & ok[:, 1::2]
    assert ok.float().mean().item() >= (0.99 if kind == "icws" else 1.0)
    assert torch.equal(got[4][ok], want[4][ok])


@pytest.mark.cuda
@pytest.mark.parametrize("maps", FIELD_MAPS)
@pytest.mark.parametrize("m", [48, 200, 512])
def test_packed_fields_kernel_matches_plain_and_unpacked_bitwise(cuda, m, maps):
    """B11 against its plain version and against B2 on the decoded corpus,
    bit for bit, at B2's cases: every field map, Q in {1, 2, 16, 17, 33},
    P = 300 rows of a strided tenant slice and of a view 4 bytes off
    16-byte alignment (the 4-byte copy route)."""
    qmap, cmap = FIELD_MAPS[maps]
    for Q in (1, 2, 16, 17, 33):
        fq, vq, fc, vc = _fields_case(m, Q, cuda)
        wc = pack_halfwords_f32(vc)
        for fcs, wcs in ((fc[:, 7:307], wc[:, 7:307]),
                         (_off_by_4(fc)[:, 7:307], _off_by_4(wc)[:, 7:307])):
            before = port_est.estimate_fields_packed_cuda.launches
            cnt, sw = port_est.estimate_fields_packed_cuda(
                fq, vq, fcs, wcs, qmap=qmap, cmap=cmap)
            torch.cuda.synchronize()
            assert port_est.estimate_fields_packed_cuda.launches == before + 1
            assert cnt.sum().item() > 0
            for want in (port_est.estimate_fields_packed_plain(
                    fq, vq, fcs, wcs, qmap=qmap, cmap=cmap),
                         port_est.estimate_fields_cuda(
                    fq, vq, fcs, unpack_halfwords_f32(wcs), qmap=qmap,
                    cmap=cmap)):
                assert _bits_equal(cnt, want[0]) and _bits_equal(sw, want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", LINEAR_CASES)
@pytest.mark.parametrize("R, W", [(5, 153), (1, 769)])
def test_packed_linear_kernel_matches_plain_and_unpacked_bitwise(cuda, R, W,
                                                                 case):
    """Odd W: the query's zero column and the corpus's pad column add +0
    and leave every sum's bits as the unpacked kernel's over W, at every
    query tile and map of the unpacked kernel's cases."""
    Q, qmap, cmap, rows = LINEAR_CASES[case]
    rng = np.random.default_rng(W)
    tq = torch.from_numpy(rng.normal(size=(3, Q, R, W)).astype(np.float32))
    tc = torch.from_numpy(rng.normal(size=(3, 300, R, W)).astype(np.float32))
    tc[:, -5:] = 0.0
    tc[:, 9] = -0.0             # a row of every case's slice
    wc = pack_halfwords_f32(torch.nn.functional.pad(tc, (0, W % 2)))
    tq, wc = tq.to(cuda), wc.to(cuda)[:, rows]
    tqe = torch.nn.functional.pad(tq, (0, W % 2))
    before = port_est.linear_estimate_fields_packed_cuda.launches
    got = port_est.linear_estimate_fields_packed_cuda(tqe, wc, qmap=qmap,
                                                      cmap=cmap)
    torch.cuda.synchronize()
    assert port_est.linear_estimate_fields_packed_cuda.launches == before + 1
    plain = port_est.linear_estimate_fields_packed_plain(tqe, wc, qmap=qmap,
                                                         cmap=cmap)
    unpacked = port_est.linear_estimate_fields_cuda(
        tq, unpack_halfwords_f32(wc)[..., :W].contiguous(), qmap=qmap,
        cmap=cmap)
    assert _bits_equal(got, plain) and _bits_equal(got, unpacked)


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [1, 2, 17])
@pytest.mark.parametrize("slots, method", [
    (1, "ps"), (33, "ts"), (97, "ts"), (768, "ps"),
    (port_se.MAX_SLOTS - 1, "ts")])
def test_packed_sample_kernel_matches_plain_and_unpacked_bitwise(
        cuda, method, slots, Q):
    """B13 on the packed rows (odd widths store a pad slot) equals its
    plain version and B9 on the unpacked roundtripped rows bit for bit, on
    a strided tenant slice with spare rows."""
    from repro_torch.data.families import make_family
    fam = make_family(method, storage=slots + 1.0)
    q, c = _sample_case(cuda, method, slots, Q, 13)
    c = fam.pack_rows(tuple(c))
    c = tuple(x[:, 7:c[0].shape[1] - 2] for x in c)
    before = port_se.sample_estimate_fields_packed_cuda.launches
    got = ops.sample_estimate_fields_packed(*q, *c, qmap=QMAP, cmap=CMAP)
    torch.cuda.synchronize()
    assert port_se.sample_estimate_fields_packed_cuda.launches == before + 1
    assert torch.count_nonzero(got).item() > 0
    aq = port_se.sample_inclusion_probs(q[1], q[2])
    plain = port_se.sample_estimate_fields_packed_plain(
        q[0], q[1], aq, *c, qmap=QMAP, cmap=CMAP)
    unpacked = ops.sample_estimate_fields(*q, *fam.unpack_rows(c), qmap=QMAP,
                                          cmap=CMAP)
    assert _bits_equal(got, plain) and _bits_equal(got, unpacked)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["icws", "cs", "jl", "ts", "ps", "dmh"])
def test_packed_service_on_the_card_matches_the_cpu_service(cuda, family):
    from repro_torch import SketchSearchService
    rng = np.random.default_rng(15)
    keys = np.arange(500)
    signal = rng.normal(size=500)
    tables = [("corr", keys, signal + 0.1 * rng.normal(size=500)),
              ("noise", keys, rng.normal(size=500)),
              ("half", np.arange(250, 750), rng.normal(size=500))]
    queries = [(keys, signal), (np.arange(100, 600), rng.normal(size=500))]
    out = []
    for device in ("cpu", "cuda"):
        svc = SketchSearchService(m=M - 1, seed=1, family=family, packed=True,
                                  device=device)
        svc.ingest_many(tables)
        batch = svc.search_batch(queries, top_k=3, min_join=5, micro_batch=4)
        assert batch == [svc.search(k, v, top_k=3, min_join=5)
                         for k, v in queries]
        out.append(batch)
    assert [[r.name for r in q] for q in out[0]] == \
        [[r.name for r in q] for q in out[1]]


@pytest.mark.cuda
@pytest.mark.parametrize("m", [M, 200, 510])
def test_pair_and_many_kernels_match_plain_versions_bitwise(cuda, m):
    """B3 (pairwise and one-vs-many) and B4 against their plain versions
    bit for bit on P = 300 rows of field 0 of a [1, cap, m] buffer, the
    last 10 spare (a view read through its row stride; m = 510 takes the
    4-byte copies); on the card, a row of B4, the one-vs-many route, the
    pairwise route on the tiled query and B2 at G = 1 agree.  Both B3
    routes also on a corpus 4 bytes off 16-byte alignment."""
    args, _ = _batch(13, "cpu")
    fp, val, _, _ = port_sketch.icws_sketch_plain(*args, m=m, seed=1)
    fq, vq = fp[:5].to(cuda), val[:5].to(cuda)
    rng = np.random.default_rng(14)
    pick = torch.from_numpy(rng.integers(0, 5, size=300))
    fc = torch.full((1, 320, m), -2, dtype=torch.int32)
    vc = torch.zeros((1, 320, m))
    fc[0, :300], vc[0, :300] = fp[:5][pick], val[:5][pick] * 1.5
    fc[0, :300][torch.from_numpy(rng.random((300, m)) < 0.3)] = 7
    fc, vc = fc.to(cuda)[0, 10:310], vc.to(cuda)[0, 10:310]
    P = fc.shape[0]
    counters = (port_est.estimate_partials_cuda,
                port_est.estimate_one_vs_many_cuda,
                port_est.estimate_many_vs_many_cuda)
    before = [c.launches for c in counters]
    many = ops.estimate_partials_many_vs_many(fq, vq, fc, vc)
    one = ops.estimate_partials_one_vs_many(fq[2], vq[2], fc, vc)
    tiled = ops.estimate_partials(fq[2].expand(P, -1).contiguous(),
                                  vq[2].expand(P, -1).contiguous(), fc, vc)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == [b + 1 for b in before]
    assert many[0].sum().item() > 0 and torch.all(many[0][:, 290:] == 0)
    b2 = port_est.estimate_fields_cuda(fq[None], vq[None], fc[None], vc[None],
                                       qmap=(0,), cmap=(0,))
    for i in range(2):
        assert _bits_equal(many[i], port_est.estimate_many_vs_many_plain(
            fq, vq, fc, vc)[i])
        assert _bits_equal(one[i], port_est.estimate_one_vs_many_plain(
            fq[2], vq[2], fc, vc)[i])
        assert _bits_equal(tiled[i], port_est.estimate_partials_plain(
            fq[2].expand(P, -1), vq[2].expand(P, -1), fc, vc)[i])
        for other in (one[i], tiled[i], b2[i][0, 2]):
            assert _bits_equal(many[i][2], other)
    # both B3 routes on a corpus 4 bytes off alignment (4-byte copies)
    fco, vco = _off_by_4(fc), _off_by_4(vc)
    for got, want in (
            (ops.estimate_partials_one_vs_many(fq[2], vq[2], fco, vco), one),
            (ops.estimate_partials(fq[2].expand(P, -1).contiguous(),
                                   vq[2].expand(P, -1).contiguous(), fco,
                                   vco), tiled)):
        assert _bits_equal(got[0], want[0]) and _bits_equal(got[1], want[1])
    # a strided pairwise side A (every other row of a [2P, m] tensor)
    wide_f = torch.stack([fc, fc], 1).reshape(2 * P, m)[::2]
    wide_v = torch.stack([vc, vc], 1).reshape(2 * P, m)[::2]
    got = ops.estimate_partials(wide_f, wide_v, fc, vc)
    want = port_est.estimate_partials_plain(wide_f, wide_v, fc, vc)
    assert _bits_equal(got[0], want[0]) and _bits_equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("m", [128, 510])
@pytest.mark.parametrize("Q", [1, 5, 16, 17, 40])
def test_many_kernel_equals_b2_and_b3_bitwise(cuda, Q, m):
    """B4 at every query tile (QT = 1 at Q = 1, else 16: Q = 17 and 40 leave
    a ragged tile) on P = 333 rows (not a multiple of 128) of field 0 of a
    [1, cap, m] buffer read through its row stride (m = 510 takes the
    4-byte copies, and so does a corpus 4 bytes off alignment): bit for bit
    its plain version, B2 at G = 1 and, row by row, B3 one-vs-many."""
    rng = np.random.default_rng(Q * 1000 + m)
    P, cap = 333, 350
    fq = rng.integers(0, 40, size=(Q, m)).astype(np.int32)
    vq = rng.normal(size=(Q, m)).astype(np.float32)
    fq[Q // 2, : m // 3] = -1                 # a query with dead slots
    src = rng.integers(0, Q, size=P)
    copy = rng.random((P, m)) < rng.random((P, 1))
    fc = np.full((1, cap, m), -2, dtype=np.int32)
    vc = np.zeros((1, cap, m), dtype=np.float32)
    fc[0, 7:7 + P] = np.where(copy, fq[src], rng.integers(0, 40, (P, m)))
    vc[0, 7:7 + P] = np.where(copy, 1.5 * vq[src], rng.normal(size=(P, m)))
    vc[0, 7:7 + P, :5] = 0.0                  # zero values: the safe denominator
    fq, vq = torch.from_numpy(fq).to(cuda), torch.from_numpy(vq).to(cuda)
    fcb, vcb = torch.from_numpy(fc).to(cuda), torch.from_numpy(vc).to(cuda)
    fc, vc = fcb[0, 7:7 + P], vcb[0, 7:7 + P]
    before = port_est.estimate_many_vs_many_cuda.launches
    many = port_est.estimate_many_vs_many_cuda(fq, vq, fc, vc)
    torch.cuda.synchronize()
    assert port_est.estimate_many_vs_many_cuda.launches == before + 1
    plain = port_est.estimate_many_vs_many_plain(fq, vq, fc, vc)
    b2 = port_est.estimate_fields_cuda(fq[None], vq[None], fc[None], vc[None],
                                       qmap=(0,), cmap=(0,))
    off = port_est.estimate_many_vs_many_cuda(fq, vq, _off_by_4(fc),
                                              _off_by_4(vc))
    assert many[0].sum().item() > 0
    for i in range(2):
        assert many[i].shape == (Q, P)
        for other in (plain[i], b2[i][0], off[i]):
            assert _bits_equal(many[i], other)
    for q in range(Q):
        one = port_est.estimate_one_vs_many_cuda(fq[q], vq[q], fc, vc)
        assert _bits_equal(many[0][q], one[0]) and _bits_equal(many[1][q],
                                                                one[1])


# (T, chunk, width, reps, offset) of the dense CountSketch card cases: a
# ragged last chunk, two and three bucket tiles, and every (T, W) of
# {1, 31, L + 1, 200,000} x {1, 153, 4,096, 10,000} at R = 1 and 5 with
# positions that wrap past 2^32 (R = 1 near the start, R = 5 mid-vector)
_L = port_cs.DENSE_CHUNK
DENSE_CASES = [
    (5000, 1024, 153, 5, 7),                 # five chunks, the last ragged
    (70_000, _L, 4096, 5, 0),
    (3000, 3000, 10_000, 5, 2 ** 32 - 1000),  # three bucket tiles, u32 wrap
] + [(T, _L, W, R, 2 ** 32 - (16 if R == 1 else T // 2 + 1))
     for T in (1, 31, _L + 1, 200_000) for W in (1, 153, 4096, 10_000)
     for R in (1, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("T, chunk, width, reps, offset", DENSE_CASES)
def test_dense_countsketch_kernel_matches_plain_bitwise(cuda, monkeypatch, T,
                                                        chunk, width, reps,
                                                        offset):
    """Each (rep, chunk, bucket) sums in t order and the chunks in order, in
    both versions: bit for bit at every T, W, R and offset; the plain
    version on the card also equals itself on the CPU where its rank loop
    is short (the expected run a bucket at most 5,000 terms)."""
    monkeypatch.setattr(port_cs, "DENSE_CHUNK", chunk)
    rng = np.random.default_rng(T)
    x = torch.from_numpy(rng.standard_t(2, T).astype(np.float32)).to(cuda)
    before = port_cs.countsketch_dense_cuda.launches
    got = port_cs.countsketch_dense_cuda(x, width=width, reps=reps, seed=17,
                                         offset=offset)
    torch.cuda.synchronize()
    assert port_cs.countsketch_dense_cuda.launches == before + 1
    want = port_cs.countsketch_dense_plain(x, width=width, reps=reps,
                                           seed=17, offset=offset)
    assert got.shape == (reps, width) and _bits_equal(got, want)
    if min(T, chunk) * reps <= 5000 * width:
        assert _bits_equal(want.cpu(), port_cs.countsketch_dense_plain(
            x.cpu(), width=width, reps=reps, seed=17, offset=offset))


@pytest.mark.cuda
@pytest.mark.parametrize("T, offset", [(4096, 0), (1000, 2 ** 31 - 500)])
def test_dense_countsketch_equals_sparse_kernel_bitwise(cuda, T, offset):
    """For T <= L, B14 of x at offset o equals B6 of keys o + arange(T)."""
    rng = np.random.default_rng(T)
    x = rng.normal(size=T).astype(np.float32)
    x[rng.random(T) < 0.2] = 0.0
    keys = ((offset + np.arange(T)) % 2 ** 32).astype(np.uint32) \
        .view(np.int32)
    xd = torch.from_numpy(x).to(cuda)
    dense = ops.countsketch(xd, width=311, reps=5, seed=4, offset=offset)
    sparse = ops.countsketch_sparse(torch.from_numpy(keys[None]).to(cuda),
                                    xd[None], width=311, reps=5, seed=4)[0]
    assert _bits_equal(dense, sparse)


@pytest.mark.cuda
def test_compressed_update_on_the_card_launches_the_kernel(cuda):
    from repro_torch.optim.compression import (CompressionConfig,
                                               compressed_update)
    rng = np.random.default_rng(2)
    g = rng.standard_t(2, 50_000).astype(np.float32)
    # both settings of the JAX package's use_kernel field launch B14 on
    # CUDA tensors, the default (False) included, with the same bits
    runs = []
    for use_kernel in (False, True):
        cfg = CompressionConfig(width=512, use_kernel=use_kernel)
        before = port_cs.countsketch_dense_cuda.launches
        runs.append(compressed_update(torch.from_numpy(g).to(cuda),
                                      torch.zeros(50_000, device=cuda), None,
                                      cfg, lr=0.3))
        torch.cuda.synchronize()
        assert port_cs.countsketch_dense_cuda.launches == before + 1
    (delta, res), (delta_k, res_k) = runs
    assert _bits_equal(delta, delta_k) and _bits_equal(res, res_k)
    d_cpu, r_cpu = compressed_update(torch.from_numpy(g),
                                     torch.zeros(50_000), None, cfg, lr=0.3)
    # the card's and the host's norms sum in other orders: a coordinate on
    # the edge of the mask may fall either way
    same = delta.cpu() == d_cpu
    assert (~same).sum().item() <= 4 and delta.abs().sum().item() > 0
    torch.testing.assert_close(res.cpu()[same], r_cpu[same], rtol=1e-5,
                               atol=1e-5)


def _attention_inputs(seed, BH, T, S, D, group, dtype, device):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(BH, T, D)).astype(np.float32)
    k, v = (rng.normal(size=(BH // group, S, D)).astype(np.float32)
            for _ in "kv")
    return [torch.from_numpy(a).to(device=device, dtype=dtype)
            for a in (q, k, v)]


@pytest.mark.cuda
# f32 (every D up to 256; past 128 the two warpgroups split the head dim)
# runs the f32 tensor-core kernel (q scale, k, v and p split into three bf16
# parts, six part-products per product: within f32 rounding, so the f32
# gate); bf16 (every D up to 256) runs the bf16 tensor-core kernel: s from
# exact bf16 products summed in f32, then scaled, and p v as p_hi v + p_lo v
# (p split into two bf16 parts, about 16 bits of p), its tiles by TMA where
# D % 8 == 0 and value by value elsewhere (D = 28, 33, 150).  bf16 output is
# within one bf16 rounding step (2^-7 relative) of the plain version's f32
# function
@pytest.mark.parametrize("dtype, rtol, atol", [(torch.float32, 5e-5, 5e-5),
                                               (torch.bfloat16, 2 ** -7, 1e-5)])
@pytest.mark.parametrize("D, T, S, kw", [
    (64, 256, 256, dict(causal=True)),
    (28, 96, 80, dict(causal=True, window=17, qc=32, kc=16)),
    (128, 128, 192, dict(causal=False, qc=64, kc=64)),
    (256, 64, 64, dict(causal=True, q_offset=5, k_offset=3, qc=32, kc=32)),
    # rows 0-39 see no key: the mean of v
    (16, 64, 64, dict(causal=True, k_offset=40, qc=32, kc=32)),
    # T and S off the kernels' tiles (64 and 128 query rows, 64 keys)
    (32, 200, 328, dict(causal=True, window=50, q_offset=7, k_offset=3,
                        qc=40, kc=41)),
    (64, 200, 328, dict(causal=True, q_offset=128, qc=100, kc=82)),
    # rows 0-49 see no key (k_offset 150 past them): the mean of v
    (128, 200, 328, dict(causal=True, window=90, q_offset=100, k_offset=150,
                         qc=50, kc=41)),
    # shorter than one tile: a single query row (a decode step), few keys
    (64, 1, 40, dict(causal=True, q_offset=39)),
    (128, 40, 24, dict(causal=False, qc=40, kc=24)),
    # D % 4 != 0: the f32 tensor-core kernel reads its rows value by value,
    # and so does the bf16 one (odd D: its output stored value by value)
    (33, 70, 90, dict(causal=True, window=20, qc=35, kc=45)),
    # bf16 at DP = 256 with zero-filled dims (D = 192), and D = 256 with T
    # and S off the tiles, a window, offsets and rows 0-49 that see no key
    (192, 256, 320, dict(causal=True, window=100, q_offset=64, qc=64,
                         kc=64)),
    (256, 200, 328, dict(causal=True, window=90, q_offset=100, k_offset=150,
                         qc=50, kc=41)),
    # past 128 with D % 4 != 0: both kernels' DP = 256 instances read their
    # rows value by value
    (150, 200, 264, dict(causal=True, window=70, q_offset=30, qc=40, kc=44)),
])
def test_flash_kernel_matches_plain_version(cuda, dtype, rtol, atol, D, T, S,
                                           kw):
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _attention_inputs(D + T, 8, T, S, D, 4, dtype, cuda)
    from repro_torch.kernels import flash_attention as port_fa
    before = port_fa.flash_attention_cuda.launches
    got = port_fa.flash_attention_bh(q, k, v, group=4, **kw)
    torch.cuda.synchronize()
    assert port_fa.flash_attention_cuda.launches == before + 1
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    want = port_fa.flash_attention_plain(q, k, v, group=4, **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [28, 33])
def test_flash_bf16_by_value_loads_take_unaligned_views(cuda, D):
    """The bf16 kernel's by-value loads read q, k and v where they lie: a
    view whose storage offset is not 16-byte aligned runs uncopied, within
    one bf16 step of plain and equal to the aligned launch bit for bit."""
    from repro_torch.kernels import flash_attention as port_fa
    q, k, v = _attention_inputs(D, 4, 130, 150, D, 2, torch.bfloat16, cuda)
    kw = dict(group=2, causal=True, window=60, q_offset=20)
    big = torch.zeros(q.numel() + 3, dtype=q.dtype, device=cuda)
    qu = big[3:].view(q.shape)
    qu.copy_(q)
    assert qu.data_ptr() % 16 != 0
    got = port_fa.flash_attention_cuda(qu, k, v, **kw)
    aligned = port_fa.flash_attention_cuda(q, k, v, **kw)
    assert torch.equal(got.view(torch.int16), aligned.view(torch.int16))
    want = port_fa.flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_f32_kernel_holds_the_gate_with_larger_logits(cuda, D):
    """q and k three times as large (logits nine times): the three-way
    split keeps the f32 tensor-core kernel within 5e-5 of plain, where a
    two-part split of q k^T would not (tests/test_torch_flash_attention.py
    shows that on the CPU)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import flash_attention as port_fa
    q, k, v = _attention_inputs(D, 8, 512, 512, D, 2, torch.float32, cuda)
    q, k = 3 * q, 3 * k
    got = port_fa.flash_attention_cuda(q, k, v, group=2)
    want = port_fa.flash_attention_plain(q, k, v, group=2)
    torch.testing.assert_close(got, want, rtol=5e-5, atol=5e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", [(torch.float32, 2e-4),
                                        (torch.bfloat16, 3e-2)])
def test_flash_attention_matches_chunked_attention_on_the_card(cuda, dtype,
                                                               tol):
    """The model-layout entry point against its oracle, both on the card
    (the JAX tests' tolerances; bf16 casts p before p v in the oracle)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.attention import chunked_attention
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 256, n, 64))
                                .astype(np.float32)).to(cuda, dtype)
               for n in (8, 2, 2))
    kw = dict(causal=True, window=100, q_offset=3)
    got = flash_attention(q, k, v, **kw)
    want = chunked_attention(q, k, v, q_chunk=64, k_chunk=128, **kw)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, D", [(torch.float32, 64),
                                      (torch.float32, 128),
                                      (torch.float32, 256),
                                      (torch.bfloat16, 64),
                                      (torch.bfloat16, 128),
                                      (torch.bfloat16, 256),
                                      (torch.bfloat16, 28)])
def test_flash_kernel_per_head_equals_batched_and_repeats(cuda, dtype, D):
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    q, k, v = _attention_inputs(5, 8, 200, 200, D, 2, dtype, cuda)
    kw = dict(group=2, causal=True, window=77, qc=40, kc=40)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    batched = flash_attention_cuda(q, k, v, **kw)
    again = flash_attention_cuda(q, k, v, **kw)
    assert torch.equal(batched.view(bits), again.view(bits))
    for h in range(8):
        one = flash_attention_cuda(q[h:h + 1], k[h // 2:h // 2 + 1],
                                   v[h // 2:h // 2 + 1], **dict(kw, group=1))
        assert torch.equal(one[0].view(bits), batched[h].view(bits))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, D, symbol", [
    (torch.bfloat16, 64, "flash_attention_tc_kernel"),
    (torch.bfloat16, 128, "flash_attention_tc_kernel"),
    (torch.bfloat16, 192, "flash_attention_tc_kernel"),
    (torch.bfloat16, 256, "flash_attention_tc_kernel"),
    (torch.bfloat16, 28, "flash_attention_tc_kernel"),
    (torch.bfloat16, 33, "flash_attention_tc_kernel"),
    (torch.bfloat16, 40, "flash_attention_tc_kernel"),
    (torch.float32, 64, "flash_attention_f32tc_kernel"),
    (torch.float32, 128, "flash_attention_f32tc_kernel"),
    (torch.float32, 192, "flash_attention_f32tc_kernel"),
    (torch.float32, 256, "flash_attention_f32tc_kernel"),
])
def test_flash_route_runs_the_named_kernel(cuda, dtype, D, symbol):
    """The launcher's static route, as the profiler sees it: f32 up to D =
    256 on the f32 tensor-core kernel, bf16 up to 256 on the bf16 one (D =
    28 and 33 by value, 40 by TMA with DP = 64 past D; neither kernel's name
    is part of the other's); ``kernel_route`` names the same kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     kernel_route)
    assert kernel_route(dtype, D) == symbol
    q, k, v = _attention_inputs(8, 4, 128, 128, D, 2, dtype, cuda)
    flash_attention_cuda(q, k, v, group=2)
    torch.cuda.synchronize()
    for _ in range(3):   # a trace can come back without device activity
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            flash_attention_cuda(q, k, v, group=2)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA and "flash" in e.name]
        if names:
            break
    assert names and all(symbol in n for n in names), names
    others = {"flash_attention_f32tc_kernel",
              "flash_attention_tc_kernel"} - {symbol}
    assert not any(other in n for other in others for n in names), names


# ---------------------------------------------------------------------------
# merge_rows on CUDA tensors (torch ops on the card; the sampling merge on
# the host, its rows back on the card)
# ---------------------------------------------------------------------------
def _shard_rows(fam, vecs, shards, device):
    from repro_torch.data.merge import split_by_key
    return [tuple(c[None] for c in fam.sketch_rows(
        [split_by_key(v, shards, s) for v in vecs], device=device))
        for s in range(shards)]


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["icws", "cs", "jl", "ts", "ps", "dmh"])
def test_merge_rows_commutes_bitwise_on_the_card(cuda, family):
    from repro_torch.data import make_family
    fam = make_family(family, storage=193.0, seed=3)
    a, b = _shard_rows(fam, _vectors(5), 2, cuda)
    ab, ba = fam.merge_rows(a, b), fam.merge_rows(b, a)
    for x, y, spec in zip(ab, ba, fam.components):
        assert x.device.type == "cuda" and x.dtype == spec.dtype
        assert torch.equal(x, y), spec.name


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["icws", "dmh"])
def test_card_merge_rows_match_the_host_merge(cuda, family):
    """The card's merge against the port's host ``ICWS.merge`` /
    ``DMH.merge`` on the same rows: fingerprints and argkeys on at least
    99% of slots (the card's ``log``/``exp`` against numpy's), values
    within rtol 1e-5 where the fingerprints agree."""
    from repro_torch.core.icws import ICWSSketch
    from repro_torch.data import make_family
    fam = make_family(family, storage=193.0, seed=3)
    host = fam.host_oracle()
    a, b = _shard_rows(fam, _vectors(6), 2, cuda)
    got = [x[0].cpu().numpy() for x in fam.merge_rows(a, b)]
    (fpa, va, na, ka), (fpb, vb, nb, kb) = ([x[0].cpu().numpy() for x in r]
                                            for r in (a, b))
    want = [host.merge(
        ICWSSketch(fpa[i], va[i].astype(np.float64), float(na[i]), ka[i]),
        ICWSSketch(fpb[i], vb[i].astype(np.float64), float(nb[i]), kb[i]))
        for i in range(fpa.shape[0])]
    wfp = np.stack([s.fingerprints for s in want])
    wkey = np.stack([s.argkeys for s in want])
    wval = np.stack([s.values for s in want])
    assert np.mean(got[0] == wfp) >= 0.99
    assert np.mean(got[3] == wkey) >= 0.99
    same = got[0] == wfp
    np.testing.assert_allclose(got[1][same], wval[same], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got[2], [s.norm for s in want], rtol=1e-6)


# ---------------------------------------------------------------------------
# observability on the card: the same bits on and off, launches counted as
# the kernel wrappers count them, interpret_mode 0
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("family", ["icws", "cs", "jl", "ts", "ps", "dmh"])
def test_observability_on_and_off_rank_bit_for_bit_on_the_card(cuda, family,
                                                               packed):
    from repro_torch import SketchSearchService, obs
    rng = np.random.default_rng(8)
    keys = rng.integers(0, 3000, 300)
    tables = []
    for i in range(8):
        k = np.concatenate([keys[rng.random(300) < 0.8],
                            rng.integers(0, 3000, 50)])
        tables.append((f"t{i}", k, rng.normal(size=k.size)))
    queries = [(keys, rng.normal(size=keys.size)) for _ in range(3)]
    svc = SketchSearchService(m=M, seed=2, family=family, packed=packed,
                              keep_host_oracle=False, device=cuda)
    svc.ingest_many(tables)

    def serve():
        return (svc.search_batch(queries, top_k=4, min_join=3.0,
                                 micro_batch=2),
                [svc.search(k, v, top_k=4, min_join=3.0)
                 for k, v in queries])

    was = obs.enabled()
    off = serve()
    obs.reset_all()
    before = port_est.estimate_fields_cuda.launches
    obs.enable()
    try:
        on = serve()
        torch.cuda.synchronize()
        mode = obs.gauge("ops.interpret_mode").value
        snap = obs.describe_metrics()["metrics"]
    finally:
        (obs.enable if was else obs.disable)()
        obs.reset_all()
    assert on == off and off[0] == off[1] and any(off[1])
    assert mode == 0.0
    ops_seen = {s["labels"]["op"]: s["value"]
                for s in snap["ops.launches_total"]["series"]}
    assert all(s["labels"]["family"] == family
               for s in snap["ops.launches_total"]["series"])
    # two micro-batches and three searches: one estimate launch each
    est_op = {"icws": "icws_estimate_fields", "dmh": "icws_estimate_fields",
              "cs": "linear_estimate_fields", "jl": "linear_estimate_fields",
              "ts": "sample_estimate_fields",
              "ps": "sample_estimate_fields"}[family]
    assert ops_seen[est_op + ("_packed" if packed else "")] == 5
    if family in ("icws", "dmh") and not packed:
        assert port_est.estimate_fields_cuda.launches - before == 5
        assert ops_seen["estimate_partials_fields"] == 5


@pytest.mark.cuda
@pytest.mark.parametrize("m", [266, 512])
def test_norm_epilogue_on_the_card_equals_the_cpu(cuda, m):
    """The ICWS norm epilogue divides by ``m`` as a 0-d device tensor, so
    the card gives the CPU's (and JAX's) bits for every count 0..m."""
    rng = np.random.default_rng(m)
    cnt = torch.arange(m + 1, dtype=torch.float32)
    sw, na, nb = (torch.from_numpy(x.astype(np.float32)) for x in (
        rng.normal(size=m + 1), 10 * rng.random(m + 1), rng.random(m + 1)))
    nb[::7] = 0.0
    want = ops._norm_epilogue(cnt, sw, na, nb, m)
    got = ops._norm_epilogue(*(x.to(cuda) for x in (cnt, sw, na, nb)), m)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


_SHARDED_KERNELS = {"icws": "estimate_fields", "dmh": "estimate_fields",
                    "cs": "linear_estimate_fields",
                    "jl": "linear_estimate_fields",
                    "ts": "sample_estimate_fields",
                    "ps": "sample_estimate_fields"}


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("family", ["icws", "cs", "jl", "ts", "ps", "dmh"])
def test_sharded_estimates_equal_the_single_launch_on_the_card(cuda, family,
                                                               packed):
    """Each family's sharded fields launch over 2 and 3 shards of the card
    (raw rows on the pad path and a sharded store's shards) equals the
    single-device launch bit for bit, one kernel launch a shard; so does
    the sharded service."""
    from repro_torch.data import make_family
    from _torch_sharding import (assert_sharded_family_equal,
                                 assert_sharded_service_equal, small_lake)
    mod = port_se if family in ("ts", "ps") else port_est
    kernel = getattr(mod, _SHARDED_KERNELS[family]
                     + ("_packed" if packed else "") + "_cuda")
    fam = make_family(family, storage=97.0)
    for shards in (2, 3):
        before = kernel.launches
        assert_sharded_family_equal(fam, packed=packed, shards=shards,
                                    device=cuda)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1 + 2 * shards
    tables, queries = small_lake(8)
    assert_sharded_service_equal(tables, queries, shards=2, device=cuda,
                                 family=family, packed=packed)


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [2, 3])
def test_sharded_top_k_equals_top_k_on_the_card(cuda, shards):
    from repro_torch.kernels.common import stable_top_k
    from repro_torch.launch import make_corpus_mesh
    rng = np.random.default_rng(shards)
    mesh = make_corpus_mesh(devices=(cuda,) * shards)
    for n, k in ((11, 6), (8, 3), (5, 5), (16_384, 10)):
        score = torch.from_numpy(
            rng.integers(-1, 3, (16, n)).astype(np.float32)).to(cuda)
        v0, i0 = stable_top_k(score, k)
        v1, i1 = ops.sharded_top_k(score, k, mesh=mesh, axis="data")
        assert torch.equal(v0, v1) and torch.equal(i0, i1)


@pytest.mark.cuda
def test_sharded_estimate_issues_no_host_sync(cuda):
    """A 2-shard ``icws_estimate_fields_sharded``, on raw rows (the pad
    path) and on per-shard rows, runs under ``set_sync_debug_mode("error")``:
    no shard waits on another (the epilogue's divisor is filled on the
    card, not copied from the host); the result equals the single launch."""
    from repro_torch.distributed.sharding import shard_rows
    from repro_torch.launch import make_corpus_mesh
    gen = torch.Generator().manual_seed(7)
    fq, fpc = (torch.randint(0, 6, shape, generator=gen, dtype=torch.int32)
               for shape in ((3, 2, 64), (3, 7, 64)))
    vq, vc = torch.rand(3, 2, 64, generator=gen), torch.rand(3, 7, 64,
                                                              generator=gen)
    nq, nc = torch.rand(3, 2, generator=gen), torch.rand(3, 7, generator=gen)
    fq, vq, nq, fpc, vc, nc = (x.to(cuda) for x in (fq, vq, nq, fpc, vc, nc))
    kw = dict(qmap=(0, 1, 0, 2), cmap=(0, 0, 1, 2))
    devs = (cuda,) * 2
    mesh = make_corpus_mesh(devices=devs)
    parts = tuple(shard_rows(x, devs, fill=f)
                  for x, f in ((fpc, ops.CORPUS_PAD_FP), (vc, 0), (nc, 0)))
    want = ops.icws_estimate_fields(fq, vq, nq, fpc, vc, nc, **kw)
    ops.icws_estimate_fields_sharded(fq, vq, nq, fpc, vc, nc, mesh=mesh, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [ops.icws_estimate_fields_sharded(fq, vq, nq, *corpus,
                                                mesh=mesh, **kw)
               for corpus in ((fpc, vc, nc), parts)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for g in got:
        assert torch.equal(g[..., :7], want)


# ---------------------------------------------------------------------------
# LM serving: the dense transformer and the engine, card against CPU, at two
# layers of tinyllama-1.1b's full width.  Tolerance: test_torch_lm.py's
# (2^-6 of the largest CPU magnitude); greedy picks equal unless the CPU's
# top-2 margin lies within it (a near tie).
# ---------------------------------------------------------------------------


def _lm_pair(cuda, layers=2):
    import dataclasses

    from repro_torch import configs
    from repro_torch.convert import model_params_to
    from repro_torch.models import Model
    cfg = dataclasses.replace(configs.get("tinyllama-1.1b"),
                              num_layers=layers)
    card = Model(cfg, device=cuda)
    params = card.init(torch.Generator(device=cuda).manual_seed(0))
    cpu_params = model_params_to(params, "cpu")
    return cfg, card, params, Model(cfg, device="cpu"), cpu_params


def _assert_lm_close(got, want, what):
    assert lm_rel(got, want) <= LM_TOL, (what, lm_rel(got, want))


@pytest.mark.cuda
def test_score_scale_on_the_card_equals_the_cpu(cuda):
    """Decode's ``1 / sqrt(hd)`` (a multiply by the f32 reciprocal, as
    XLA compiles JAX's division) gives the CPU's (and JAX's) bits on the
    card at every head dim of the dense configs."""
    from repro_torch.models.attention import _scale_scores
    for hd in (16, 32, 64, 128, 256):
        s = 8 * torch.randn(4, 4096, generator=torch.Generator().manual_seed(
            hd))
        want = _scale_scores(s, hd)
        got = _scale_scores(s.to(cuda), hd).cpu()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), hd


@pytest.mark.cuda
def test_model_refuses_tf32_on_the_card(cuda):
    _, card, params, _, _ = _lm_pair(cuda, layers=1)
    toks = torch.zeros((1, 4), dtype=torch.int32, device=cuda)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            card.forward(params, {"tokens": toks})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert card.forward(params, {"tokens": toks})[0].shape == (1, 4, 32000)


@pytest.mark.cuda
def test_decode_attention_on_the_card_matches_the_cpu(cuda):
    from repro_torch.models import attention as attn
    cfg, card, params, _, cpu_params = _lm_pair(cuda, layers=1)
    layer = {k: v[0] for k, v in params["layers"]["attn"].items()}
    cpu_layer = {k: v[0] for k, v in cpu_params["layers"]["attn"].items()}
    g = torch.Generator().manual_seed(1)
    B, S = 4, 64
    x = torch.randn(B, 1, cfg.d_model, generator=g).bfloat16()
    k = torch.randn(B, S, cfg.num_kv_heads, cfg.head_dim, generator=g)
    v = torch.randn(B, S, cfg.num_kv_heads, cfg.head_dim, generator=g)
    k, v = k.bfloat16(), v.bfloat16()
    layout = attn.CacheLayout(S, False)
    for pos in (0, 17, 63):
        slot_pos = torch.where(torch.arange(S) <= pos, torch.arange(S),
                               -1).int()
        p = torch.tensor(pos, dtype=torch.int32)
        want = attn.decode_attention(cpu_layer, x, cfg, k.clone(), v.clone(),
                                     slot_pos, p, layout)
        got = attn.decode_attention(layer, x.to(cuda), cfg, k.to(cuda),
                                    v.to(cuda), slot_pos.to(cuda),
                                    p.to(cuda), layout)
        for a, b, what in zip(got, want, ("out", "k", "v")):
            _assert_lm_close(a, b, f"{what} at pos {pos}")


@pytest.mark.cuda
def test_forward_and_decode_on_the_card_match_the_cpu(cuda):
    _, card, params, cpu, cpu_params = _lm_pair(cuda)
    toks = torch.randint(0, 32000, (2, 16),
                         generator=torch.Generator().manual_seed(2)).int()
    want, _ = cpu.forward(cpu_params, {"tokens": toks})
    got, _ = card.forward(params, {"tokens": toks.to(cuda)})
    _assert_lm_close(got, want, "forward")
    near_tie_rows(got, want)
    state, cpu_state = card.init_decode_state(2, 32), cpu.init_decode_state(
        2, 32)
    for t in range(8):
        want, cpu_state = cpu.decode_step(cpu_params, toks[:, t:t + 1],
                                          cpu_state)
        got, state = card.decode_step(params, toks[:, t:t + 1].to(cuda),
                                      state)
        _assert_lm_close(got, want, f"decode step {t}")
        near_tie_rows(got, want)
    for name in ("k", "v"):
        _assert_lm_close(state["kv"][name], cpu_state["kv"][name], name)
    assert torch.equal(state["slot_pos"].cpu(), cpu_state["slot_pos"])


@pytest.mark.cuda
def test_engine_on_the_card_matches_the_cpu(cuda):
    """Four slots, six requests: every request drains with its
    ``max_new_tokens``; the card's tokens equal the CPU's unless a tick's
    picks differ at a near tie, after which the runs part."""
    from repro_torch.serve import Request, ServeEngine
    _, card, params, cpu, cpu_params = _lm_pair(cuda)
    runs = []
    for model, prm in ((cpu, cpu_params), (card, params)):
        rec = Recorded(ServeEngine(model, prm, batch_slots=4, max_seq=64))
        reqs = [Request(rid=i, prompt=[1 + i, 2 + i], max_new_tokens=4)
                for i in range(6)]
        for r in reqs:
            rec.engine.submit(r)
        rec.engine.run_until_drained(max_ticks=200)
        assert all(r.done and len(r.output) == 4 for r in reqs)
        runs.append((rec.logits, [r.output for r in reqs]))
    (want_logits, want_out), (got_logits, got_out) = runs
    for tick, (w, g) in enumerate(zip(want_logits, got_logits)):
        _assert_lm_close(g, w, f"tick {tick}")
        if near_tie_rows(g, w).size:
            return                               # a near tie: the runs part
    assert got_out == want_out


# ---------------------------------------------------------------------------
# LM training: one train step card against CPU at two layers of
# tinyllama-1.1b's full width (loss at test_torch_lm.py's tolerance, the
# moments, which are gradients, at test_torch_train.py's GRAD_TOL; one
# step, since a second starts from parameters that AdamW moved apart on
# the ill-posed entries), the
# card's bits repeatable (the resume test's ground), and the telemetry's
# B1 launch at B1's gate (fingerprints on 99% of slots, values equal where
# they agree) and B3 bit for bit against their plain versions.
# ---------------------------------------------------------------------------
def _train_steps(model, params, cfg, batch, steps=2):
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.train import make_train_step
    opt_cfg = AdamWConfig(lr=2e-3, warmup_steps=4, total_steps=24)
    step = make_train_step(model, opt_cfg, q_chunk=32, k_chunk=32)
    opt = adamw.init_opt_state(params, opt_cfg)
    for _ in range(steps):
        params, opt, metrics = step(params, opt, batch)
    return params, opt, metrics


def _lm_batch(device, vocab=32000, M=2):
    g = torch.Generator().manual_seed(4)
    toks = torch.randint(0, vocab, (M, 2, 33), generator=g).int()
    return {"tokens": toks[..., :-1].contiguous().to(device),
            "labels": toks[..., 1:].contiguous().to(device)}


@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_cpu(cuda):
    from repro_torch import tree as tr
    cfg, card, params, cpu, cpu_params = _lm_pair(cuda)
    _, opt, got = _train_steps(card, params, cfg, _lm_batch(cuda), steps=1)
    _, cpu_opt, want = _train_steps(cpu, cpu_params, cfg, _lm_batch("cpu"),
                                    steps=1)
    assert abs(float(got["loss"]) - float(want["loss"])) <= LM_TOL * float(
        want["loss"])
    np.testing.assert_allclose(float(got["grad_norm"]),
                               float(want["grad_norm"]), rtol=1e-3)
    assert int(got["step"]) == int(want["step"]) == 1
    for k in ("mu", "nu"):
        for a, b in zip(tr.leaves(opt[k]), tr.leaves(cpu_opt[k])):
            assert lm_rel(a, b) <= GRAD_TOL, k


@pytest.mark.cuda
def test_train_step_repeats_bit_for_bit_on_the_card(cuda):
    from repro_torch import tree as tr
    cfg, card, params, _, _ = _lm_pair(cuda)
    runs = [_train_steps(card, params, cfg, _lm_batch(cuda))
            for _ in range(2)]
    for a, b in zip(tr.leaves(runs[0]), tr.leaves(runs[1])):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_trainer_resume_on_the_card_is_bit_for_bit(cuda, tmp_path):
    from repro_torch import configs
    from repro_torch import tree as tr
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = tiny_cfg(configs)

    def run(ckpt, steps, total_steps=None):
        t = Trainer(cfg, trainer_config(TrainerConfig, AdamWConfig, ckpt,
                                        steps=steps, total_steps=total_steps),
                    log_fn=lambda _: None, device=cuda)
        return t, t.run()
    ta, hist_a = run(tmp_path / "a", 12)
    run(tmp_path / "b", 8, total_steps=12)
    tb, hist_b = run(tmp_path / "b", 12)
    assert hist_b["step"][0] == 8 and hist_a["loss"][8:] == hist_b["loss"]
    for x, y in zip(tr.leaves(ta.state), tr.leaves(tb.state)):
        assert x.device.type == "cuda" and torch.equal(x, y)


@pytest.mark.cuda
def test_telemetry_launches_b1_and_b3_bit_for_bit(cuda):
    from repro_torch.train import telemetry as tel
    cfg = tel.TelemetryConfig(m=256, seed=23)
    g = torch.randn(2, 50_000, generator=torch.Generator().manual_seed(1))
    g[:, ::3] = 0.0
    g = g.to(cuda)
    sketch0 = port_sketch.icws_sketch_cuda.launches
    est0 = port_est.estimate_partials_cuda.launches
    sk = tel.sketch_gradient(g, cfg)
    est = tel.estimate_pairwise(sk, cfg)
    torch.cuda.synchronize()
    assert port_sketch.icws_sketch_cuda.launches == sketch0 + 1
    assert port_est.estimate_partials_cuda.launches == est0 + 1
    zn = g / torch.clamp(torch.linalg.vector_norm(g, dim=-1), min=1e-30)[:, None]
    keys = torch.arange(g.shape[1], dtype=torch.int32,
                        device=cuda).expand_as(g).contiguous()
    fp, val, _, _ = port_sketch.icws_sketch_plain(zn * zn, keys, zn, m=256,
                                                  seed=23)
    agree = sk["fp"] == fp
    assert agree.float().mean().item() >= 0.99
    assert torch.equal(sk["val"][agree], val[agree])
    R = 2
    fp, val = sk["fp"], sk["val"]
    cnt, sw = port_est.estimate_partials_plain(
        fp.repeat_interleave(R, 0), val.repeat_interleave(R, 0),
        fp.repeat(R, 1), val.repeat(R, 1))
    want = ops._norm_epilogue(cnt, sw, sk["norm"].repeat_interleave(R),
                              sk["norm"].repeat(R), 256).reshape(R, R)
    assert torch.equal(est, want)
    exact = (g @ g.T)
    assert (est - exact).abs().max() <= 0.2 * exact.abs().max()


# ---------------------------------------------------------------------------
# The moe family: qwen3-moe-30b-a3b's router and experts at their published
# widths, card against CPU under the routing rule (``_torch_lm.
# route_flips``: a token routed apart sits at a near tie of the CPU's
# routing, within ROUTE_MARGIN; the outputs are compared on the tokens
# routed alike, at LM_TOL), the train step's bits repeated (no float
# atomics on the MoE path), and mixtral-8x22b at one layer of its full
# width (2.9 B parameters with its embedding and head, 11.6 GB f32) for
# decode == forward, at capacity_factor E / k so that the forward drops no
# token (JAX's gate, rel < 0.06).
# ---------------------------------------------------------------------------
def _moe_cfg(arch, **kw):
    """``arch``'s published config with ``kw`` replaced, after the earlier
    tests' garbage is collected (a full-width layer takes up to 11.6 GB)."""
    import dataclasses
    import gc

    from repro_torch import configs
    gc.collect()
    return dataclasses.replace(configs.get(arch), **kw)


@pytest.mark.cuda
def test_moe_routing_on_the_card_follows_the_rule(cuda):
    from _torch_lm import route_flips

    from repro_torch.models import moe
    cfg = _moe_cfg("qwen3-moe-30b-a3b")
    params = moe.init_moe(torch.Generator(device=cuda).manual_seed(0), cfg)
    cpu_params = {k: v.cpu() for k, v in params.items()}
    x = torch.randn(512, cfg.d_model, generator=torch.Generator(
        ).manual_seed(1)).bfloat16()
    with moe.record_routes() as routes:
        want, want_aux = moe.moe_ffn(cpu_params, x, cfg)
        got, got_aux = moe.moe_ffn(params, x.to(cuda), cfg)
    (want_e, want_p), (got_e, got_p) = routes
    flips = route_flips(got_e, want_e, want_p, cfg.num_experts_per_tok)
    alike = torch.ones(512, dtype=torch.bool)
    alike[torch.from_numpy(flips)] = False
    _assert_lm_close(got.cpu()[alike], want[alike], "moe_ffn")
    assert lm_rel(got_p, want_p) <= 1e-5
    if flips.size == 0:
        assert abs(float(got_aux) - float(want_aux)) <= 1e-5 * float(
            want_aux)
    print(f"moe_ffn at full width, 512 tokens: {flips.size} routed apart")


@pytest.mark.cuda
def test_moe_train_step_repeats_bit_for_bit_on_the_card(cuda):
    """One layer of qwen3-moe-30b-a3b's full width, two train steps of two
    micro-batches of 64 tokens (capacity 5 a expert: slots are dropped),
    twice from one state: equal bits."""
    from repro_torch import tree as tr
    from repro_torch.models import Model
    cfg = _moe_cfg("qwen3-moe-30b-a3b", num_layers=1)
    card = Model(cfg, device=cuda)
    params = card.init(torch.Generator(device=cuda).manual_seed(0))
    batch = _lm_batch(cuda, vocab=cfg.vocab_size)
    runs = [_train_steps(card, params, cfg, batch) for _ in range(2)]
    assert torch.isfinite(runs[0][2]["loss"])
    for a, b in zip(tr.leaves(runs[0]), tr.leaves(runs[1])):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_mixtral_full_width_layer_decode_equals_forward(cuda):
    """The layer's decode and forward see bf16-rounded inputs that differ
    by a step: a token they route apart must sit at a near tie of the
    forward's routing, and the logits are compared on the others."""
    from _torch_lm import route_flips

    from repro_torch.models import Model, moe
    cfg = _moe_cfg("mixtral-8x22b", num_layers=1, capacity_factor=4.0)
    model = Model(cfg, device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (1, 12), generator=torch.Generator(
        ).manual_seed(2)).int().to(cuda)
    with moe.record_routes() as routes:
        par, _ = model.forward(params, {"tokens": toks})
        state = model.init_decode_state(1, 32)
        inc = []
        for t in range(12):
            lg, state = model.decode_step(params, toks[:, t:t + 1], state)
            inc.append(lg[:, 0])
    (want_e, want_p), steps = routes[0], routes[1:]
    got_e = torch.cat([e for e, _ in steps])
    flips = route_flips(got_e, want_e, want_p, cfg.num_experts_per_tok)
    alike = torch.ones(12, dtype=torch.bool)
    alike[torch.from_numpy(flips)] = False
    assert torch.isfinite(par.float()).all() and flips.size <= 2
    inc = torch.stack(inc, dim=1)[0].cpu()
    assert lm_rel(inc[alike], par[0].cpu()[alike]) < 0.06
