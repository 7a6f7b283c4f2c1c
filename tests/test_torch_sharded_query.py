"""Sharded serving inside the port: with the corpus rows split over a mesh
of repeated CPU devices (2 and 3 shards), every result equals the
single-device one bit for bit -- results and statistics of every family,
unpacked and packed, raw estimates on the pad path, ``SketchCorpus``,
``sharded_top_k`` on ties, tenants, store growth and the service.
``tests/test_torch_sharded_jax.py`` holds the sharded index against JAX's
sharded index."""
import numpy as np
import pytest
import torch

from repro_torch import DatasetSearchIndex, SketchCorpus
from repro_torch.data import FAMILY_NAMES, synthetic
from repro_torch.data.store import CorpusStore
from repro_torch.kernels import ops
from repro_torch.kernels.common import stable_top_k

from _torch_sharding import (M, assert_sharded_service_equal, repeated_mesh,
                             small_lake)

# small shapes: one intra-op thread per test process, so that parallel
# test workers do not oversubscribe the cores
torch.set_num_threads(1)

SHARDS = (2, 3)


def _index(tables, mesh=None, tenants=None, **kwargs):
    idx = DatasetSearchIndex(m=M, seed=1, keep_host_oracle=False,
                             device="cpu", mesh=mesh, **kwargs)
    for i, t in enumerate(tables):
        idx.add_table(*t, tenant=tenants[i] if tenants else None)
    return idx


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("family", FAMILY_NAMES)
def test_every_family_sharded_equals_single_device(family, packed):
    """``query`` and ``query_batch``: every result and statistic, and the
    arena's raw estimates."""
    tables, queries = small_lake(1)
    one = _index(tables, family=family, packed=packed)
    want = one.query_batch(queries, top_k=5)
    assert want == [one.query(*q, top_k=5) for q in queries] and any(want)
    for shards in SHARDS:
        idx = _index(tables, repeated_mesh(shards), family=family,
                     packed=packed)
        assert idx.query_batch(queries, top_k=5) == want
        assert [idx.query(*q, top_k=5) for q in queries] == want
        vecs = [v for q in queries for v in idx.vectorize(*q)]
        qc = tuple(c.reshape((len(queries), 3) + tuple(c.shape[1:]))
                   .transpose(0, 1)
                   for c in idx.family.sketch_rows(vecs, device="cpu"))
        P = len(tables)
        assert torch.equal(idx._estimate_arena(qc)[:, :, :P],
                           one._estimate_arena(qc)[:, :, :P])


@pytest.mark.parametrize("shards", SHARDS)
def test_raw_many_sharded_pads_rows_that_do_not_split(shards):
    rng = np.random.default_rng(3)
    fpb = torch.from_numpy(rng.integers(0, 30, (1, 5, 64)).astype(np.int32))
    vb = torch.from_numpy(rng.normal(size=(1, 5, 64)).astype(np.float32))
    nb = torch.ones(1, 5)
    fq = torch.from_numpy(rng.integers(0, 30, (2, 64)).astype(np.int32))
    vq = torch.from_numpy(rng.normal(size=(2, 64)).astype(np.float32))
    nq = torch.ones(2)
    want = ops.icws_estimate_many_stacked(fq, vq, nq, fpb, vb, nb)
    got = ops.icws_estimate_many_sharded(fq, vq, nq, fpb, vb, nb,
                                         mesh=repeated_mesh(shards),
                                         axis="data")
    assert got.shape == (2, 5) and torch.equal(got, want)
    assert want.abs().sum() > 0


@pytest.mark.parametrize("shards", SHARDS)
def test_corpus_estimate_vecs_sharded_equals_unsharded(shards):
    rng = np.random.default_rng(3)
    vecs = [synthetic.sparse_pair(rng, n=400, nnz=80, overlap=0.3)[0]
            for _ in range(5)]
    queries = [synthetic.sparse_pair(rng, n=400, nnz=80, overlap=0.3)[0]
               for _ in range(3)]
    plain = SketchCorpus(m=128, seed=2, device="cpu")
    shard = SketchCorpus(m=128, seed=2, device="cpu",
                         mesh=repeated_mesh(shards))
    for c in (plain, shard):
        c.add_batch(vecs)
    want = plain.estimate_vecs(queries)
    assert want.shape == (3, 5)
    assert torch.equal(shard.estimate_vecs(queries), want)
    assert torch.equal(shard.estimate_vec(queries[0]), want[0])
    assert shard.capacity % shards == 0


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("n, k", [(11, 6), (8, 3), (5, 5)])
def test_sharded_top_k_equals_top_k_on_ties(n, k, shards):
    """Integer scores in {-1, 0, 1, 2}: ties everywhere, across shard
    boundaries too, and k larger than a shard at (5, 5)."""
    rng = np.random.default_rng(n * 10 + k)
    score = torch.from_numpy(rng.integers(-1, 3, (4, n)).astype(np.float32))
    v0, i0 = stable_top_k(score, k)
    v1, i1 = ops.sharded_top_k(score, k, mesh=repeated_mesh(shards),
                               axis="data")
    assert torch.equal(v0, v1) and torch.equal(i0, i1)


@pytest.mark.parametrize("shards", SHARDS)
def test_tenants_on_a_sharded_store_equal_dedicated_indexes(shards):
    """A contiguous tenant (one row range) and a fragmented one (rows
    interleaved with another tenant's) on a sharded arena answer as a
    dedicated single-device index over their own tables."""
    tables, queries = small_lake(4, n_tables=9)
    owner = ["solo"] * 3 + ["a", "b"] * 3
    arena = _index(tables, repeated_mesh(shards), tenants=owner)
    assert len(arena.store.tenant_ranges("solo")) == 1
    assert len(arena.store.tenant_ranges("a")) == 3
    for tenant in ("solo", "a", "b"):
        own = _index([t for t, o in zip(tables, owner) if o == tenant])
        for q in queries:
            assert arena.query(*q, top_k=4, tenant=tenant) == \
                own.query(*q, top_k=4)
        assert arena.query_batch(queries, top_k=4, tenant=tenant) == \
            own.query_batch(queries, top_k=4)


@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_store_keeps_global_row_order_across_growth(shards):
    rng = np.random.default_rng(6)
    one = CorpusStore(m=8, fields=3, min_capacity=2, device="cpu")
    shard = CorpusStore(m=8, fields=3, min_capacity=2, device="cpu",
                        mesh=repeated_mesh(shards))
    caps = []
    for b in (1, 3, 5, 2):
        rows = (rng.integers(0, 99, (3, b, 8)).astype(np.int32),
                rng.normal(size=(3, b, 8)).astype(np.float32),
                rng.random((3, b)).astype(np.float32),
                rng.integers(0, 99, (3, b, 8)).astype(np.int32))
        for s in (one, shard):
            s.append(*rows)
        caps.append(shard.capacity)
        assert shard.capacity % shards == 0
        for got, want in zip(shard.field_arrays(), one.field_arrays()):
            assert torch.equal(got, want)
        # spare rows keep the family's fills
        fp = shard.buffers()[0]
        assert (fp[:, len(shard):] == -2).all()
        assert (shard.buffers()[2][:, len(shard):] == 0).all()
    assert len(set(caps)) >= 3              # at least two growths
    for parts in shard.shard_buffers():
        assert len(parts) == shards
        assert {p.shape[1] for p in parts} == {shard.capacity // shards}
    assert shard.slice_rows(2, 9)[0].shape == (3, 7, 8)
    assert torch.equal(shard.slice_rows(2, 9)[1],
                       one.field_arrays()[1][:, 2:9])
    with pytest.raises(ValueError, match="does not split"):
        CorpusStore(m=8, mesh=repeated_mesh(2), row_multiple=3, device="cpu")


@pytest.mark.parametrize("shards", SHARDS)
def test_service_search_batch_and_describe_equal_single_device(shards):
    """``SketchSearchService(mesh=)``: ``search``, ``search_batch`` and
    ``describe()``, and each shard's buffers on its mesh device."""
    tables, queries = small_lake(5)
    assert_sharded_service_equal(tables, queries, shards=shards)
