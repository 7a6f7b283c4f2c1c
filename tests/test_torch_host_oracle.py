"""The port's host oracle against the JAX package on the CPU.

``progression_min`` equals JAX's and its brute force on random
progressions; ``round_counts``, ``PairHashFamily.block_starts``,
``uniforms_from_key`` and a ``WeightedMinHash`` sketch (hash minima and
values) equal JAX's bit for bit at m = 64, and so do ``estimate`` and
``estimate_batch``.  Each family's ``host_oracle()`` sketches, estimates
and merges as JAX's does, by value.  ``backend="host"`` answers as JAX's
``_query_host`` on ``tests/test_corpus.py``'s lake, and ``describe()`` of
a host service reports JAX's fields."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import hashing as jax_hashing
from repro.core import progmin as jax_progmin
from repro.core import rounding as jax_rounding
from repro.core import wmh as jax_wmh
from repro.core.types import SparseVec as JaxVec
from repro.data import DatasetSearchIndex as JaxIndex
from repro.data.families import make_family as jax_make_family
from repro.serve import SketchSearchService as JaxService
from repro_torch import DatasetSearchIndex, SketchSearchService
from repro_torch.core import hashing, progmin, rounding, wmh
from repro_torch.core.types import SparseVec
from repro_torch.data import make_family

# small shapes: one intra-op thread per test process, so that parallel
# test workers do not oversubscribe the cores
torch.set_num_threads(1)

P = (1 << 31) - 1


def _vec(rng, n=5000, nnz=150):
    idx = np.sort(rng.choice(n, size=nnz, replace=False)).astype(np.int64)
    vals = rng.normal(size=nnz)
    vals[vals == 0.0] = 1.0
    return SparseVec.from_pairs(idx, vals, n)


def _jax_vec(v):
    return JaxVec(indices=v.indices, values=v.values, n=v.n)


def _fields(obj):
    """A sketch's fields as a dict of numpy values."""
    return {k: np.asarray(v) for k, v in vars(obj).items()}


def _rows(results):
    """Search results as tuples: the two packages' ``SearchResult`` classes
    differ, so their dataclass equality does not compare across them."""
    return [dataclasses.astuple(r) for r in results]


def _equal(a, b):
    fa, fb = _fields(a), _fields(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert np.array_equal(fa[k], fb[k]), k


# ---------------------------------------------------------------------------
# the pieces: progression minimum, rounding, pair hash, keyed uniforms
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("modulus", [97, 10_007, P])
def test_progression_min_equals_jax_and_the_brute_force(modulus):
    rng = np.random.default_rng(modulus % 1000)
    a = rng.integers(0, modulus, size=400)
    b = rng.integers(0, modulus, size=400)
    n = rng.integers(1, 300, size=400)
    got = progmin.progression_min(a, b, modulus, n)
    assert np.array_equal(got, jax_progmin.progression_min(a, b, modulus, n))
    for i in range(0, 400, 7):
        want = progmin.progression_min_bruteforce(a[i], b[i], modulus, n[i])
        assert got[i] == want
        assert want == jax_progmin.progression_min_bruteforce(
            a[i], b[i], modulus, n[i])
    with pytest.raises(ValueError):
        progmin.progression_min(modulus, 0, modulus, 1)


def test_round_counts_pair_hash_and_uniforms_equal_jax():
    rng = np.random.default_rng(5)
    for nnz in (1, 7, 300):
        z = rng.normal(size=nnz)
        z /= np.linalg.norm(z)
        for L in (1000, 10 ** 7):
            k = rounding.round_counts(z, L)
            assert np.array_equal(k, jax_rounding.round_counts(z, L))
            assert int(k.sum()) == L
    fam = hashing.PairHashFamily.create(64, 9)
    ref = jax_hashing.PairHashFamily.create(64, 9)
    for x, y in ((fam.a, ref.a), (fam.b, ref.b), (fam.c, ref.c)):
        assert np.array_equal(x, y)
    blocks = rng.integers(0, 2 ** 40, size=50)
    assert np.array_equal(fam.block_starts(blocks), ref.block_starts(blocks))
    assert np.array_equal(fam.hash_pairs_bruteforce(17, np.arange(30)),
                          ref.hash_pairs_bruteforce(17, np.arange(30)))
    keys = rng.integers(0, 2 ** 31, size=40)
    for stream in (0, 3):
        assert np.array_equal(
            hashing.uniforms_from_key(4, stream, keys, 16),
            jax_hashing.uniforms_from_key(4, stream, keys, 16))
    x = rng.normal(size=(5, 64)) * 1e-3
    assert np.array_equal(wmh.compensated_sum(x, axis=1),
                          jax_wmh.compensated_sum(x, axis=1))


# ---------------------------------------------------------------------------
# WeightedMinHash
# ---------------------------------------------------------------------------
def test_weighted_minhash_sketch_and_estimates_equal_jax():
    rng = np.random.default_rng(7)
    port, ref = wmh.WeightedMinHash(m=64, seed=2), jax_wmh.WeightedMinHash(
        m=64, seed=2)
    vecs = [_vec(rng) for _ in range(4)] + [
        SparseVec.from_pairs(np.zeros(0), np.zeros(0), 10)]
    sk = [port.sketch(v) for v in vecs]
    jsk = [ref.sketch(_jax_vec(v)) for v in vecs]
    for a, b in zip(sk, jsk):
        _equal(a, b)
    # a small L: the brute-force expansion of the JAX package agrees
    small = wmh.WeightedMinHash(m=64, seed=2, L=50)
    _equal(small.sketch(vecs[0]), jax_wmh.sketch_bruteforce(
        jax_wmh.WeightedMinHash(m=64, seed=2, L=50), _jax_vec(vecs[0])))
    for i in range(len(vecs)):
        for j in range(len(vecs)):
            assert port.estimate(sk[i], sk[j]) == ref.estimate(jsk[i],
                                                               jsk[j])
    A, B = wmh.stack_wmh(sk), wmh.stack_wmh(sk[::-1])
    want = ref.estimate_batch(jax_wmh.stack_wmh(jsk),
                              jax_wmh.stack_wmh(jsk[::-1]))
    assert np.array_equal(port.estimate_batch(A, B), want)
    with pytest.raises(ValueError):
        wmh.WeightedMinHash(m=0)


# ---------------------------------------------------------------------------
# the families' host oracles
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["icws", "cs", "jl", "ts", "ps", "dmh"])
def test_family_host_oracle_equals_jax(name):
    """Sketches, estimates and the union-merge of disjoint halves, by
    value."""
    host = make_family(name, storage=97.0, seed=4).host_oracle()
    ref = jax_make_family(name, storage=97.0, seed=4).host_oracle()
    assert type(host).__name__ == type(ref).__name__
    rng = np.random.default_rng(8)
    v, w = _vec(rng), _vec(rng)
    lo = SparseVec(indices=v.indices[::2], values=v.values[::2], n=v.n)
    hi = SparseVec(indices=v.indices[1::2], values=v.values[1::2], n=v.n)
    sk = {k: host.sketch(x) for k, x in (("v", v), ("w", w), ("lo", lo),
                                         ("hi", hi))}
    jsk = {k: ref.sketch(_jax_vec(x)) for k, x in (("v", v), ("w", w),
                                                   ("lo", lo), ("hi", hi))}
    for k in sk:
        _equal(sk[k], jsk[k])
    assert host.estimate(sk["v"], sk["w"]) == ref.estimate(jsk["v"],
                                                           jsk["w"])
    _equal(host.merge(sk["lo"], sk["hi"]), ref.merge(jsk["lo"], jsk["hi"]))
    _equal(host.sketch_dense(np.arange(6.0)),
           ref.sketch_dense(np.arange(6.0)))


# ---------------------------------------------------------------------------
# backend="host" through the index and the service
# ---------------------------------------------------------------------------
def _corpus_lake():
    """``tests/test_corpus.py::test_dataset_search_device_vs_host_oracle``'s
    lake."""
    rng = np.random.default_rng(31)
    keys = np.arange(800)
    signal = rng.normal(size=800)
    tables = [("corr", keys, signal + 0.2 * rng.normal(size=800)),
              ("noise", keys, rng.normal(size=800)),
              ("disjoint", np.arange(10_000, 10_800), rng.normal(size=800))]
    return tables, (keys, signal)


def test_query_host_equals_jax_and_shares_the_kmv_refinement():
    tables, (keys, signal) = _corpus_lake()
    port = DatasetSearchIndex(m=768, seed=4, device="cpu")
    ref = JaxIndex(m=768, seed=4)
    for name, k, v in tables:
        port.add_table(name, k, v)
        ref.add_table(name, k, v)
    for t, r in zip(port.tables, ref.tables):
        for field in ("key_indicator", "values", "values_sq"):
            _equal(getattr(t, field), getattr(r, field))
    host = port.query(keys, signal, top_k=3, min_join=40, backend="host")
    assert _rows(host) == _rows(ref.query(keys, signal, top_k=3,
                                          min_join=40, backend="host"))
    assert port.query_batch([(keys, signal)] * 2, top_k=3, min_join=40,
                            backend="host") == [host, host]
    dev = port.query(keys, signal, top_k=3, min_join=40)
    assert [r.name for r in dev] == [r.name for r in host]
    assert dev[0].name == "corr"
    for d, h in zip(dev, host):
        assert abs(d.join_size - h.join_size) < 0.35 * 800
        assert d.corr == h.corr          # the KMV refinement is shared
    lean = DatasetSearchIndex(m=64, seed=4, keep_host_oracle=False,
                              device="cpu")
    lean.add_table(*tables[0])
    assert lean.tables[0].key_indicator is None
    with pytest.raises(ValueError, match="keep_host_oracle"):
        lean.query(keys, signal, backend="host")


def test_host_backend_index_keeps_no_device_store():
    tables, (keys, signal) = _corpus_lake()
    port = DatasetSearchIndex(m=64, seed=4, backend="host", device="cpu")
    ref = JaxIndex(m=64, seed=4, backend="host")
    for i, (name, k, v) in enumerate(tables):
        port.add_table(name, k, v, tenant="a" if i else None)
        ref.add_table(name, k, v, tenant="a" if i else None)
    assert port.store is None and port.keep_host_oracle
    assert port.storage_doubles() == ref.storage_doubles()
    assert _rows(port.query(keys, signal, top_k=3, min_join=40,
                            tenant="a")) == _rows(
        ref.query(keys, signal, top_k=3, min_join=40, tenant="a"))
    with pytest.raises(ValueError, match="device corpus"):
        port.query(keys, signal, backend="device")


def test_host_service_describe_reports_the_jax_fields():
    tables, (keys, signal) = _corpus_lake()
    port = SketchSearchService(m=64, seed=4, backend="host", device="cpu")
    ref = JaxService(m=64, seed=4, backend="host")
    for svc in (port, ref):
        svc.ingest_many(tables[:2], tenant="acme")
        svc.ingest(*tables[2])
        # no padding on the host backend: the tail batch holds 1 query
        svc.search_batch([(keys, signal)] * 3, top_k=3, min_join=40,
                         micro_batch=2)
    got, want = port.describe(), ref.describe()
    for k in ("family", "backend", "packed", "bytes_per_row", "tables",
              "tenants", "storage_doubles", "corpus_rows", "corpus_capacity",
              "batches_served", "batch_queries_served"):
        assert got[k] == want[k], k
    got_t, want_t = port.describe(tenant="acme"), ref.describe(tenant="acme")
    assert got_t.keys() == want_t.keys()
    for k in got_t:
        if not k.startswith("request_ms"):
            assert got_t[k] == want_t[k], k
