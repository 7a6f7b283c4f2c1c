"""The port's packed serving path end to end, for all six families, against
the JAX package's packed service.

Each package sketches the lake with its own kernels into a packed store
(m = 65: odd ICWS, DMH, CS and TS/PS widths, so the pad slot is served).
The served top 5 hold the same tables, and the rankings agree wherever the
port's device scores separate two tables by more than 1e-4 (join sizes and
sums within rtol 1e-4, the criterion of ``test_torch_sample_search.py``).
A JAX packed index carried across with ``index_from_numpy(packed=True)``
keeps its buffers bit for bit and ranks like the JAX index.  Inside the
port, a packed index equals an unpacked index over the bf16-roundtripped
rows bit for bit, batched equals sequential and a tenant equals a
dedicated index."""
import numpy as np
import pytest
import torch

from repro.serve import SketchSearchService as JaxService
from repro_torch import DatasetSearchIndex, SketchSearchService
from repro_torch.convert import index_from_numpy
from repro_torch.data import dataset_search as port_ds
from repro_torch.data.families import FAMILY_NAMES

# small shapes: one intra-op thread per test process, so that parallel
# test workers do not oversubscribe the cores
torch.set_num_threads(1)

M = 65          # storage 98.5: icws/dmh m 65, cs 5 x 19, jl 98, ts/ps 97
DOMAIN = 3000


def _lake(seed, n_random=12, n_planted=3):
    """Random tables over a shared key domain, planted partners that follow
    a query, and one query without a partner."""
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
    queries.append((rng.choice(DOMAIN, 200, replace=False),
                    rng.normal(size=200)))
    order = rng.permutation(len(tables))
    return [tables[i] for i in order], queries


@pytest.fixture(scope="module")
def lake():
    return _lake(7)


@pytest.fixture(scope="module", params=FAMILY_NAMES)
def services(request, lake):
    """(family, JAX packed service, port packed service) over the lake,
    even-numbered tables in tenant "even"."""
    tables, _ = lake
    out = []
    for svc in (JaxService(m=M, seed=5, family=request.param, packed=True,
                           keep_host_oracle=False),
                SketchSearchService(m=M, seed=5, family=request.param,
                                    packed=True, keep_host_oracle=False,
                                    device="cpu")):
        for i, table in enumerate(tables):
            svc.ingest(*table, tenant="even" if i % 2 == 0 else None)
        out.append(svc)
    return (request.param, *out)


def _scores(index, keys, values, min_join):
    """The port index's device ranking scores of one query."""
    q = tuple(c[:, None] for c in index.family.sketch_rows(
        list(index.vectorize(keys, values)), device="cpu"))
    est = index._estimate(q, index.store.buffers())[:, :, :len(index.tables)]
    return port_ds._corr_scores(*est, float(min_join))[0].numpy()


def _same_ranking(port, jax_idx, queries, min_join=3.0):
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
        score = _scores(port, keys, values, min_join)
        pos = {t.name: i for i, t in enumerate(port.tables)}
        rank = {r.name: i for i, r in enumerate(got)}
        for i, a in enumerate(want):
            for b in want[i + 1:]:
                if abs(a.corr) == abs(b.corr) and abs(
                        score[pos[a.name]] - score[pos[b.name]]) > 1e-4:
                    assert rank[a.name] < rank[b.name]
        top = {r.name for r in jax_idx.query(keys, values, top_k=5,
                                             min_join=min_join)}
        assert top == {r.name for r in port.query(keys, values, top_k=5,
                                                  min_join=min_join)}


def test_packed_service_serves_the_jax_packed_services_top_k(lake, services):
    _, queries = lake
    family, jax_svc, port_svc = services
    d, jd = port_svc.describe(), jax_svc.describe()
    assert d["packed"] and jd["packed"] and d["family"] == family
    assert d["bytes_per_row"] == jd["bytes_per_row"]
    assert d["storage_doubles"] == jd["storage_doubles"]
    _same_ranking(port_svc.index, jax_svc.index, queries)


def _convert(jax_idx, packed, buffers=None):
    return index_from_numpy(
        buffers or [np.asarray(b) for b in jax_idx.store.buffers()],
        len(jax_idx.store),
        tables=[(t.name, t.n_rows, (t.sample.hashes, t.sample.values))
                for t in jax_idx.tables],
        tenant_ranges={t: jax_idx.store.tenant_ranges(t)
                       for t in jax_idx.store.tenants()},
        m=jax_idx.m, seed=jax_idx.seed, key_space=jax_idx.key_space,
        family=jax_idx.family.name, packed=packed, device="cpu")


def test_converted_packed_index_ranks_like_the_jax_index(lake, services):
    _, queries = lake
    _, jax_svc, _ = services
    port = _convert(jax_svc.index, packed=True)
    assert port.store.packed
    assert port.store.tenant_ranges("even") == \
        jax_svc.index.store.tenant_ranges("even")
    for got, want in zip(port.store.buffers(), jax_svc.index.store.buffers()):
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      np.asarray(want).view(np.int32))
    _same_ranking(port, jax_svc.index, queries)


def test_packed_equals_unpacked_over_roundtripped_rows(lake, services):
    """Estimates bit for bit, hence the same served results."""
    _, queries = lake
    _, jax_svc, port_svc = services
    packed = port_svc.index
    size = len(packed.store)
    rows = packed.family.unpack_rows(tuple(b[:, :size]
                                           for b in packed.store.buffers()))
    unpacked = _convert(jax_svc.index, packed=False,
                        buffers=[r.numpy() for r in rows])
    assert not unpacked.store.packed
    for keys, values in queries:
        q = tuple(c[:, None] for c in packed.family.sketch_rows(
            list(packed.vectorize(keys, values)), device="cpu"))
        got = packed._estimate(q, packed.store.buffers())[:, :, :size]
        want = unpacked._estimate(q, unpacked.store.buffers())[:, :, :size]
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      want.numpy().view(np.int32))
        assert packed.query(keys, values, top_k=5, min_join=3.0) == \
            unpacked.query(keys, values, top_k=5, min_join=3.0)


def test_packed_batched_equals_sequential_and_tenant_equals_dedicated(
        lake, services):
    tables, queries = lake
    family, _, port_svc = services
    batch = port_svc.search_batch(queries, top_k=5, min_join=3.0,
                                  micro_batch=3)
    assert batch == [port_svc.search(k, v, top_k=5, min_join=3.0)
                     for k, v in queries]
    assert any(batch)
    own = DatasetSearchIndex(m=M, seed=5, family=family, packed=True,
                             device="cpu")
    for name, keys, vals in tables[::2]:
        own.add_table(name, keys, vals)
    for keys, values in queries:
        assert port_svc.index.query(keys, values, top_k=4, min_join=3.0,
                                    tenant="even") == \
            own.query(keys, values, top_k=4, min_join=3.0)
