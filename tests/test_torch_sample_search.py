"""The port's dataset-search path with DMH and the sampling families (TS,
PS), end to end against the JAX package.

TS and PS rows are built on the host, bit for bit the JAX package's; DMH
rows come from each package's own sketch (fingerprints agree on at least
99% of slots, values and argkeys where they do).  Estimates from equal
rows differ only in f32 summation order, so join sizes and sums agree to
``rtol 1e-4`` (``atol 1e-4 x`` the largest magnitude, for cancellation),
the device scores within ``atol 1e-5``, the rankings agree wherever the
port's device scores separate two tables by more than 1e-4, and the served
top 5 hold the same tables.  A JAX index's corpus carried across with
``index_from_numpy`` ranks like the JAX index.  Inside the port: batched == sequential and tenant == dedicated
index bit for bit, and the service accounts for each family's storage."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import DatasetSearchIndex as JaxIndex
from repro.serve import SketchSearchService as JaxService
from repro.data import dataset_search as jax_ds
from repro_torch import DatasetSearchIndex, SketchSearchService
from repro_torch.convert import index_from_numpy
from repro_torch.data import dataset_search as port_ds
from repro_torch.kernels.sample_estimate import sorted_prefix_ok

from _torch_sharding import (assert_sharded_family_equal,
                             assert_sharded_service_equal)

# small shapes: one intra-op thread per test process, so that parallel
# test workers do not oversubscribe the cores
torch.set_num_threads(1)

M = 64          # storage 97: dmh m = 64, ts/ps 96 slots
DOMAIN = 3000
FAMILIES = ("dmh", "ts", "ps")


def _lake(seed, n_random=14, n_planted=3):
    """Random tables over a shared key domain (with duplicate keys), plus
    planted partners that share most of a query's keys with values that
    follow the query's; one more query has no partner."""
    rng = np.random.default_rng(seed)
    tables, queries = [], []
    for i in range(n_planted):
        keys = rng.choice(DOMAIN, size=250, replace=False)
        vals = rng.normal(size=250)
        queries.append((keys, vals))
        keep = rng.random(250) < 0.85
        pk = np.concatenate([keys[keep], rng.integers(0, DOMAIN, 50)])
        pv = np.concatenate([2.0 * vals[keep] + 0.2 * rng.normal(size=keep.sum()),
                             rng.normal(size=50)])
        tables.append((f"partner_{i}", pk, pv))
    for i in range(n_random):
        n = int(np.exp(rng.uniform(np.log(50), np.log(300))))
        tables.append((f"random_{i}", rng.integers(0, DOMAIN, n),
                       rng.normal(size=n)))
    order = rng.permutation(len(tables))
    queries.append((rng.choice(DOMAIN, 200, replace=False),
                    rng.normal(size=200)))
    return [tables[i] for i in order], queries


@pytest.fixture(scope="module")
def lake():
    return _lake(2)


def _build(cls, family, tables, **kwargs):
    idx = cls(m=M, seed=5, family=family, **kwargs)
    for i, (name, keys, vals) in enumerate(tables):
        idx.add_table(name, keys, vals, tenant="even" if i % 2 == 0 else None)
    return idx


@pytest.fixture(scope="module", params=FAMILIES)
def indexes(request, lake):
    tables, _ = lake
    return (request.param,
            _build(JaxIndex, request.param, tables, keep_host_oracle=False),
            _build(DatasetSearchIndex, request.param, tables, device="cpu"))


def _port_scores(idx, keys, values, min_join):
    vecs = list(idx.vectorize(keys, values))
    q = tuple(c[:, None] for c in idx.family.sketch_rows(vecs, device="cpu"))
    est = idx._estimate(q, idx.store.buffers())[:, :, :len(idx.tables)]
    return port_ds._corr_scores(*est, float(min_join))[0].numpy()


def _jax_scores(idx, keys, values, min_join):
    """The JAX index's device ranking scores of one query."""
    vecs = list(idx.vectorize(keys, values))
    q = tuple(jnp.asarray(c)[:, None] for c in idx.family.sketch_rows(vecs))
    est = idx.family.estimate_fields(q, idx.store.buffers(),
                                     qmap=jax_ds.QFIELD, cmap=jax_ds.CFIELD)
    return np.asarray(jax_ds._corr_scores(
        *est[:, :, :len(idx.tables)], jnp.float32(min_join)))[0]


def _same_ranking(port, jax_idx, queries, min_join=3.0):
    """Same tables, join sizes, sums and device scores; equal refined |corr|
    ties keep the JAX device order wherever the port's device scores are
    separated by more than 1e-4; a served top 5 holds the same tables."""
    P = len(jax_idx.tables)
    for keys, values in queries:
        want = jax_idx.query(keys, values, top_k=P, min_join=min_join)
        got = port.query(keys, values, top_k=P, min_join=min_join)
        assert want and {r.name for r in got} == {r.name for r in want}
        by_name = {r.name: r for r in got}
        j_scale = max(abs(r.join_size) for r in want)
        b_scale = max(abs(r.sum_b) for r in want)
        for r in want:
            g = by_name[r.name]
            assert g.corr == r.corr                      # same KMV samples
            np.testing.assert_allclose(g.join_size, r.join_size, rtol=1e-4,
                                       atol=1e-4 * j_scale)
            np.testing.assert_allclose(g.sum_b, r.sum_b, rtol=1e-4,
                                       atol=1e-4 * b_scale)
        score = _port_scores(port, keys, values, min_join)
        np.testing.assert_allclose(
            score, _jax_scores(jax_idx, keys, values, min_join), rtol=0,
            atol=1e-5)
        pos = {t.name: i for i, t in enumerate(port.tables)}
        rank_got = {r.name: i for i, r in enumerate(got)}
        for i, a in enumerate(want):
            for b in want[i + 1:]:
                if abs(a.corr) == abs(b.corr) and abs(
                        score[pos[a.name]] - score[pos[b.name]]) > 1e-4:
                    assert rank_got[a.name] < rank_got[b.name]
        top = {r.name for r in jax_idx.query(keys, values, top_k=5,
                                             min_join=min_join)}
        assert top == {r.name for r in port.query(keys, values, top_k=5,
                                                  min_join=min_join)}


def test_own_sketches_rank_like_the_jax_index(lake, indexes):
    _, queries = lake
    family, jax_idx, port = indexes
    assert port.family.name == family
    assert port.store.bytes_per_row() == jax_idx.store.bytes_per_row()
    assert port.storage_doubles() == jax_idx.storage_doubles()
    got = [b.numpy() for b in port.store.buffers()]
    want = [np.asarray(b) for b in jax_idx.store.buffers()]
    if family == "dmh":
        agree = got[0] == want[0]
        assert agree.mean() >= 0.99
        np.testing.assert_array_equal(got[1][agree], want[1][agree])
        np.testing.assert_array_equal(got[3][agree], want[3][agree])
    else:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert sorted_prefix_ok(port.store.buffers()[0])
    _same_ranking(port, jax_idx, queries)


def test_converted_index_ranks_like_the_jax_index(lake, indexes):
    _, queries = lake
    family, jax_idx, _ = indexes
    port = index_from_numpy(
        [np.asarray(b) for b in jax_idx.store.buffers()], len(jax_idx.store),
        tables=[(t.name, t.n_rows, (t.sample.hashes, t.sample.values))
                for t in jax_idx.tables],
        tenant_ranges={t: jax_idx.store.tenant_ranges(t)
                       for t in jax_idx.store.tenants()},
        m=jax_idx.m, seed=jax_idx.seed, key_space=jax_idx.key_space,
        family=family, device="cpu")
    assert port.store.tenant_ranges("even") == \
        jax_idx.store.tenant_ranges("even")
    for got, want in zip(port.store.buffers(), jax_idx.store.buffers()):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _same_ranking(port, jax_idx, queries)


def test_batched_equals_sequential_bitwise(lake, indexes):
    _, queries = lake
    _, _, port = indexes
    batch = port.query_batch(queries, top_k=5, min_join=3.0)
    assert batch == [port.query(k, v, top_k=5, min_join=3.0)
                     for k, v in queries]
    assert any(batch)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("tenant_first", [False, True])
def test_tenant_queries_equal_a_dedicated_index(lake, family, tenant_first):
    """A fragmented tenant (the gather route) and a contiguous one (the
    slice route) both equal a dedicated index over the same tables."""
    tables, queries = lake
    arena = DatasetSearchIndex(m=M, seed=5, family=family, device="cpu")
    if tenant_first:
        for name, keys, vals in tables[:8]:
            arena.add_table(name, keys, vals, tenant="block")
        for name, keys, vals in tables[8:]:
            arena.add_table(name, keys, vals)
        tenant, mine = "block", tables[:8]
        assert len(arena.store.tenant_ranges("block")) == 1
    else:
        for i, (name, keys, vals) in enumerate(tables):
            arena.add_table(name, keys, vals,
                            tenant="even" if i % 2 == 0 else None)
        tenant, mine = "even", tables[::2]
        assert len(arena.store.tenant_ranges("even")) > 1
    own = DatasetSearchIndex(m=M, seed=5, family=family, device="cpu")
    for name, keys, vals in mine:
        own.add_table(name, keys, vals)
    for keys, values in queries:
        assert arena.query(keys, values, top_k=4, min_join=3.0,
                           tenant=tenant) == \
            own.query(keys, values, top_k=4, min_join=3.0)


@pytest.mark.parametrize("family, shapes, m", [
    ("dmh", ((64,), (64,), (), (64,)), 64),
    ("ts", ((96,), (96,), ()), None),
    ("ps", ((96,), (96,), ()), None)])
def test_service_serves_the_family_storage_matched(lake, family, shapes, m):
    """dmh rows are ICWS rows (12 m + 4 B); ts/ps rows 96 (key, value)
    slots and a tau (8 S + 4 B); each row is 97 doubles, storage-matched."""
    tables, queries = lake
    svc = SketchSearchService(m=M, seed=5, family=family, device="cpu")
    svc.ingest_many(tables[:10])
    batch = svc.search_batch(queries, top_k=3, min_join=3.0, micro_batch=3)
    assert batch == [svc.search(k, v, top_k=3, min_join=3.0)
                     for k, v in queries]
    d = svc.describe()
    assert d["family"] == family and d["tables"] == 10
    assert d["bytes_per_row"] == (12 * 64 + 4 if m else 8 * 96 + 4)
    assert d["storage_doubles"] == 10 * 3 * 97
    assert d["batches_served"] == 2 and d["queries_served"] == len(queries)
    assert svc.index.store.m == m
    bufs = svc.index.store.buffers()
    assert tuple(b.shape[2:] for b in bufs) == shapes
    cap = svc.index.store.capacity
    if m is None:       # spare sample rows stay inert
        assert (bufs[0][:, 10:] == -2).all() and (bufs[1][:, 10:] == 0).all()
        assert (bufs[2][:, 10:] == 0).all() and cap > 10


@pytest.mark.parametrize("family", FAMILIES)
def test_unported_options_raise_for_these_families(lake, family):
    """``mesh``, ported: the family's service over a 2-way CPU mesh equals
    the single-device one bit for bit."""
    tables, queries = lake[0], lake[1]
    assert_sharded_service_equal(tables[:10], queries, shards=2,
                                 family=family)


@pytest.mark.parametrize("family", FAMILIES)
def test_host_backend_is_the_icws_oracle_only(family):
    """``backend="host"`` serves the ICWS family's WeightedMinHash oracle;
    another family raises ``ValueError``, as in the JAX package."""
    with pytest.raises(ValueError, match="oracle path"):
        SketchSearchService(m=M, family=family, backend="host",
                            device="cpu")
    with pytest.raises(ValueError, match="oracle path"):
        JaxService(m=M, family=family, backend="host")


@pytest.mark.parametrize("family", FAMILIES)
def test_unported_family_members_name_their_queue_item(family):
    """The family's sharded members, ported: ``estimate_fields_sharded``
    and its packed twin equal the single-device launches bit for bit."""
    from repro_torch.data import make_family
    fam = make_family(family, storage=97.0)
    for packed in (False, True):
        assert_sharded_family_equal(fam, packed=packed, shards=3)


@pytest.mark.parametrize("family", FAMILIES)
def test_family_merge_rows_and_host_oracle_return(family):
    """``merge_rows`` of two disjoint halves' rows returns rows of the
    family's layout, and ``host_oracle`` the JAX family's sketcher class
    (``tests/test_torch_merge.py`` and ``test_torch_host_oracle.py`` hold
    their values)."""
    from repro.data import make_family as jax_make_family
    from repro_torch.core.types import SparseVec
    from repro_torch.data import make_family
    fam = make_family(family, storage=97.0, seed=5)
    keys = np.arange(0, 600, 3)
    halves = [SparseVec.from_pairs(keys[i::2], np.linspace(1.0, 2.0, 200)[
        i::2], DOMAIN) for i in (0, 1)]
    a, b = (tuple(c[None] for c in fam.sketch_rows([v], device="cpu"))
            for v in halves)
    merged = fam.merge_rows(a, b)
    assert [tuple(c.shape) for c in merged] == [tuple(c.shape) for c in a]
    assert [c.dtype for c in merged] == [s.dtype for s in fam.components]
    assert (type(fam.host_oracle()).__name__ == type(jax_make_family(
        family, storage=97.0, seed=5).host_oracle()).__name__)


def test_make_family_names_and_sizes_match_the_jax_package():
    from repro.data import families as jax_families
    from repro_torch.data import families
    assert families.FAMILY_NAMES == jax_families.FAMILY_NAMES
    for name in families.FAMILY_NAMES:
        for storage in (97.0, 769.0):
            got = families.make_family(name, storage=storage, seed=3)
            want = jax_families.make_family(name, storage=storage, seed=3)
            assert type(got).__name__ == type(want).__name__
            assert got.storage_doubles_per_row() == \
                want.storage_doubles_per_row()
            assert [(c.name, c.trailing, c.fill) for c in got.components] == \
                [(c.name, c.trailing, c.fill) for c in want.components]
