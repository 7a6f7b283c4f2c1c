"""The port's §1.3 serving path end to end, against the JAX package.

Identical sketch rows (carried across with ``repro_torch.convert``) give the
same rankings wherever the scores are separated, and the same join sizes
and sums to f32 tolerance; each package's own sketches find the same
planted partners; inside the port, batched equals sequential bit for bit,
tenant queries equal a dedicated index, and equal scores rank by
ascending table index."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import DatasetSearchIndex as JaxIndex
from repro_torch import DatasetSearchIndex, SketchSearchService
from repro_torch.convert import index_from_numpy
from repro_torch.data import dataset_search as port_ds

from _torch_sharding import (assert_sharded_family_equal,
                             assert_sharded_service_equal)

# small shapes: one intra-op thread per test process, so that parallel
# test workers do not oversubscribe the cores
torch.set_num_threads(1)

M = 64
DOMAIN = 3000


def _lake(seed, n_random=20, n_planted=4):
    """Random tables over a shared key domain (with duplicate keys), plus
    planted partners: each shares most of a query's keys with values that
    follow the query's.  Returns (tables, queries, partner name per query)."""
    rng = np.random.default_rng(seed)
    tables, queries, partners = [], [], []
    for i in range(n_planted):
        keys = rng.choice(DOMAIN, size=300, replace=False)
        vals = rng.normal(size=300)
        queries.append((keys, vals))
        keep = rng.random(300) < 0.85
        pk = np.concatenate([keys[keep], rng.integers(0, DOMAIN, 60)])
        pv = np.concatenate([2.0 * vals[keep] + 0.2 * rng.normal(size=keep.sum()),
                             rng.normal(size=60)])
        tables.append((f"partner_{i}", pk, pv))
        partners.append(f"partner_{i}")
    for i in range(n_random):
        n = int(np.exp(rng.uniform(np.log(50), np.log(400))))
        tables.append((f"random_{i}", rng.integers(0, DOMAIN, n),
                       rng.normal(size=n)))
    order = rng.permutation(len(tables))
    tables = [tables[i] for i in order]
    queries.append((rng.choice(DOMAIN, 200, replace=False),
                    rng.normal(size=200)))       # a query with no partner
    partners.append(None)
    return tables, queries, partners


@pytest.fixture(scope="module")
def lake():
    return _lake(0)


@pytest.fixture(scope="module")
def jax_index(lake):
    tables, _, _ = lake
    idx = JaxIndex(m=M, seed=5, keep_host_oracle=False)
    for i, (name, keys, vals) in enumerate(tables):
        idx.add_table(name, keys, vals, tenant="even" if i % 2 == 0 else None)
    return idx


@pytest.fixture(scope="module")
def port_index(lake):
    tables, _, _ = lake
    idx = DatasetSearchIndex(m=M, seed=5, keep_host_oracle=False,
                             device="cpu")
    for i, (name, keys, vals) in enumerate(tables):
        idx.add_table(name, keys, vals, tenant="even" if i % 2 == 0 else None)
    return idx


def _converted(jax_idx):
    return index_from_numpy(
        [np.asarray(b) for b in jax_idx.store.buffers()], len(jax_idx.store),
        tables=[(t.name, t.n_rows, (t.sample.hashes, t.sample.values))
                for t in jax_idx.tables],
        tenant_ranges={t: jax_idx.store.tenant_ranges(t)
                       for t in jax_idx.store.tenants()},
        m=jax_idx.m, seed=jax_idx.seed, key_space=jax_idx.key_space,
        device="cpu")


def _port_scores(idx, keys, values, min_join):
    """The port's device ranking scores of one query against every table."""
    vecs = list(idx.vectorize(keys, values))
    q = tuple(c[:, None] for c in idx.family.sketch_rows(vecs, device="cpu"))
    est = idx._estimate(q, idx.store.buffers())[:, :, :len(idx.tables)]
    return port_ds._corr_scores(*est, float(min_join))[0].numpy()


def test_converted_index_ranks_like_the_jax_index(lake, jax_index):
    _, queries, _ = lake
    port = _converted(jax_index)
    assert port.store.tenant_ranges("even") == \
        jax_index.store.tenant_ranges("even")
    P = len(jax_index.tables)
    for keys, values in queries:
        want = jax_index.query(keys, values, top_k=P, min_join=3.0)
        got = port.query(keys, values, top_k=P, min_join=3.0)
        assert {r.name for r in got} == {r.name for r in want}
        by_name = {r.name: r for r in got}
        scale = max(abs(r.sum_b) for r in want)
        for r in want:
            g = by_name[r.name]
            assert g.corr == r.corr                  # same KMV samples
            np.testing.assert_allclose(g.join_size, r.join_size, rtol=1e-5)
            np.testing.assert_allclose(g.sum_b, r.sum_b, rtol=1e-5,
                                       atol=1e-5 * scale)
        # equal refined corr ties keep the device ranking order: it must
        # agree wherever the device scores are separated by more than 1e-5
        score = _port_scores(port, keys, values, 3.0)
        pos = {t.name: i for i, t in enumerate(port.tables)}
        rank_got = {r.name: i for i, r in enumerate(got)}
        for i, a in enumerate(want):
            for b in want[i + 1:]:
                if abs(a.corr) == abs(b.corr) and abs(
                        score[pos[a.name]] - score[pos[b.name]]) > 1e-5:
                    assert rank_got[a.name] < rank_got[b.name]


def test_own_sketches_find_the_planted_partners(lake, jax_index, port_index):
    _, queries, partners = lake
    for (keys, values), partner in zip(queries, partners):
        want = jax_index.query(keys, values, top_k=5, min_join=20.0)
        got = port_index.query(keys, values, top_k=5, min_join=20.0)
        if partner is None:
            continue
        assert got[0].name == want[0].name == partner


def test_batched_equals_sequential_bitwise(lake, port_index):
    _, queries, _ = lake
    batch = port_index.query_batch(queries, top_k=6, min_join=3.0)
    seq = [port_index.query(k, v, top_k=6, min_join=3.0) for k, v in queries]
    assert batch == seq
    assert any(batch)


@pytest.mark.parametrize("tenant_first", [False, True])
def test_tenant_queries_equal_a_dedicated_index(lake, port_index, tenant_first):
    """A fragmented tenant (the gather route) and a contiguous one (the
    slice route) both equal a dedicated index over the same tables."""
    tables, queries, _ = lake
    if tenant_first:
        arena = DatasetSearchIndex(m=M, seed=5, device="cpu")
        for name, keys, vals in tables[:10]:
            arena.add_table(name, keys, vals, tenant="block")
        for name, keys, vals in tables[10:]:
            arena.add_table(name, keys, vals)
        tenant, mine = "block", tables[:10]
        assert len(arena.store.tenant_ranges("block")) == 1
    else:
        arena, tenant, mine = port_index, "even", tables[::2]
        assert len(arena.store.tenant_ranges("even")) > 1
    own = DatasetSearchIndex(m=M, seed=5, device="cpu")
    for name, keys, vals in mine:
        own.add_table(name, keys, vals)
    for keys, values in queries:
        assert arena.query(keys, values, top_k=4, min_join=3.0,
                           tenant=tenant) == \
            own.query(keys, values, top_k=4, min_join=3.0)


def test_top_k_breaks_ties_by_ascending_index_like_jax():
    rng = np.random.default_rng(1)
    score = np.where(rng.random((3, 40)) < 0.6, -1.0,
                     rng.integers(0, 3, (3, 40)) / 4.0).astype(np.float32)
    for k in (1, 5, 40):
        v, i = port_ds._top_k(torch.from_numpy(score), k)
        vj, ij = jax.lax.top_k(jnp.asarray(score), k)
        np.testing.assert_array_equal(v.numpy(), np.asarray(vj))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ij))


def test_corr_scores_match_jax():
    from repro.data.dataset_search import _corr_scores as jax_scores
    rng = np.random.default_rng(2)
    est = rng.normal(size=(6, 4, 30)).astype(np.float32)
    est[0] = np.abs(est[0]) * 5
    got = port_ds._corr_scores(*torch.from_numpy(est), 1.0).numpy()
    want = np.asarray(jax_scores(*jnp.asarray(est), jnp.float32(1.0)))
    np.testing.assert_array_equal(got < 0, want < 0)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_corr_scores_round_variances_as_jax():
    """The variances round as XLA's fused multiply-subtract, bit for bit,
    so a table whose variance cancels exactly (``join * sum_b2`` equal to
    ``sum_b * sum_b`` up to rounding) scores as in the JAX package: its
    score follows the sign of the residue, 0 or 1, never a mix."""
    from repro.data.dataset_search import _corr_scores as jax_scores
    rng = np.random.default_rng(3)
    a, b, c, d = (rng.normal(size=20_000).astype(np.float32)
                  for _ in range(4))
    fused = jax.jit(lambda a, b, c, d: a * b - c * d)
    for args in ((a, b, c, d), (a, b, a, b), (a, b, c, c)):
        got = port_ds._mul_sub(*map(torch.from_numpy, args)).numpy()
        np.testing.assert_array_equal(got, np.asarray(fused(*args)))
    est = rng.normal(size=(6, 4, 30)).astype(np.float32)
    est[0] = np.abs(est[0]) * 5 + 1
    est[4] = (est[2].astype(np.float64) ** 2 / est[0]).astype(np.float32)
    got = port_ds._corr_scores(*torch.from_numpy(est), 1.0).numpy()
    want = np.asarray(jax_scores(*jnp.asarray(est), jnp.float32(1.0)))
    assert 0 < (want == 1.0).sum() < want.size
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_service_batch_equals_search_loop_and_accounts(lake):
    tables, queries, _ = lake
    svc = SketchSearchService(m=M, seed=5, device="cpu")
    svc.ingest_many(tables[:12])
    with pytest.raises(ValueError, match="already ingested"):
        svc.ingest(*tables[0])
    # micro_batch=2 leaves a padded tail (5 = 2 + 2 + 1)
    batch = svc.search_batch(queries, top_k=3, min_join=3.0, micro_batch=2)
    seq = [svc.search(k, v, top_k=3, min_join=3.0) for k, v in queries]
    assert batch == seq
    d = svc.describe()
    assert d["tables"] == 12 and d["batches_served"] == 3
    assert d["batch_queries_served"] == 5 and d["queries_served"] == 5
    assert d["bytes_per_row"] == 12 * M + 4 and d["device"] == "cpu"
    assert svc.stats.rows_ingested == sum(len(k) for _, k, _ in tables[:12])


@pytest.mark.parametrize("kwargs, shards", [
    ({"family": "ts"}, 3),
    ({}, 2),
])
def test_unported_options_raise_naming_their_queue_item(lake, kwargs,
                                                        shards):
    """The option that raised until it was ported, ``mesh``: a service
    sharded over a CPU mesh equals the single-device one bit for bit."""
    tables, queries, _ = lake
    assert_sharded_service_equal(tables[:12], queries, shards=shards,
                                 **kwargs)


@pytest.mark.parametrize("kwargs", [{"backend": "host"},
                                    {"keep_host_oracle": True}])
def test_host_oracle_options_serve_the_icws_family(lake, kwargs):
    """``backend="host"`` and ``keep_host_oracle=True`` (the default, as in
    the JAX service) keep three host WeightedMinHash sketches a table and
    answer ``backend="host"`` queries from them."""
    tables, queries, _ = lake
    svc = SketchSearchService(m=M, seed=5, device="cpu", **kwargs)
    svc.ingest_many(tables[:6])
    assert svc.index.keep_host_oracle
    assert all(t.values_sq is not None for t in svc.index.tables)
    assert (svc.index.store is None) == (kwargs.get("backend") == "host")
    host = svc.search(*queries[0], top_k=3, min_join=3.0, backend="host")
    assert host and all(r.name in {t[0] for t in tables[:6]} for r in host)
    assert svc.search_batch(queries[:1], top_k=3, min_join=3.0,
                            backend="host") == [host]


@pytest.mark.parametrize("family", ["icws", "cs", "jl", "ts", "ps", "dmh"])
def test_packed_sharded_serving_names_its_queue_item(lake, family):
    """Packed sharded serving, ported: the packed service over a 3-way CPU
    mesh, and the family's packed sharded launch, equal their
    single-device twins bit for bit."""
    from repro_torch.data import make_family
    tables, queries, _ = lake
    assert_sharded_service_equal(tables[:12], queries, shards=3,
                                 family=family, packed=True)
    assert_sharded_family_equal(make_family(family, storage=97.0),
                                packed=True, shards=2)
