"""Mergeable corpora in the port (``repro_torch.data.merge`` and the
families' ``merge_rows``), against the JAX package on the CPU.

The key partitions equal JAX's for 1-5 shards.  ``merge_rows`` on rows the
JAX package sketched equals JAX's ``merge_rows``: CS, JL, TS and PS bit for
bit; ICWS and DMH (torch's ``log``/``exp`` against XLA's) with fingerprints
and argkeys equal on at least 99% of slots, values within rtol 1e-5 where
the fingerprints agree and norms within 1e-6.  The port's ICWS and DMH
``merge_rows`` equal the port's host ``ICWS.merge`` / ``DMH.merge``.  The
JAX merge laws hold as port cases (commutes bit for bit, sampling
associative, shared keys and cross-seed, misaligned or packed stores
rejected, merged spare rows inert, sharded ingest into a tenant
contiguous), and sharded lake builds rank as the port's single-stream
build and as JAX's ``add_tables_sharded``: CS equal, JL within rtol 1e-5,
the top-k sets of ICWS, DMH, TS and PS."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.types import SparseVec as JaxVec
from repro.data import DatasetSearchIndex as JaxIndex
from repro.data import families as jax_families
from repro.data import merge as jax_merge
from repro_torch import DatasetSearchIndex, SketchSearchService
from repro_torch.core import DMH, ICWS
from repro_torch.core.icws import ICWSSketch
from repro_torch.core.types import SparseVec
from repro_torch.data import families, merge
from repro_torch.data.store import CorpusStore

# small shapes: one intra-op thread per test process, so that parallel
# test workers do not oversubscribe the cores
torch.set_num_threads(1)

SEED = 3
FAMILIES = ("icws", "cs", "jl", "ts", "ps", "dmh")
# jl m a power of 4: its 1/sqrt(m) scale is a power of two, so integer
# tables add exactly (as in the JAX merge tests)
PARAMS = {"icws": ("ICWSFamily", {"m": 64}), "dmh": ("DMHFamily", {"m": 64}),
          "cs": ("CSFamily", {"width": 16}), "jl": ("JLFamily", {"m": 64}),
          "ts": ("TSFamily", {"slots": 32}), "ps": ("PSFamily", {"slots": 32})}


def _pair(name, seed=SEED):
    """(port family, JAX family) of one configuration."""
    cls, kw = PARAMS[name]
    return (getattr(families, cls)(seed=seed, **kw),
            getattr(jax_families, cls)(seed=seed, **kw))


def _vec(rng, n=4000, nnz=200, integer=False):
    idx = np.sort(rng.choice(n, size=nnz, replace=False)).astype(np.int64)
    if integer:
        vals = rng.integers(1, 6, size=nnz) * rng.choice([-1.0, 1.0], nnz)
    else:
        vals = rng.normal(size=nnz)
        vals[vals == 0.0] = 1.0
    return SparseVec.from_pairs(idx, vals, n)


def _jax_vec(v):
    return JaxVec(indices=v.indices, values=v.values, n=v.n)


def _jax_shard_rows(jfam, vecs, shards):
    """Per shard, the JAX family's rows of the shard's partitions with the
    [F = 1] axis ``merge_rows`` takes, as numpy."""
    out = []
    for s in range(shards):
        parts = [jax_merge.split_by_key(_jax_vec(v), shards, s) for v in vecs]
        out.append(tuple(np.asarray(c)[None]
                         for c in jfam.sketch_rows(parts)))
    return out


def _port_shard_rows(fam, vecs, shards):
    out = []
    for s in range(shards):
        parts = [merge.split_by_key(v, shards, s) for v in vecs]
        out.append(tuple(c[None] for c in fam.sketch_rows(parts,
                                                          device="cpu")))
    return out


def _t(rows):
    return tuple(torch.from_numpy(np.array(r)) for r in rows)


def _np(rows):
    return tuple(np.asarray(r) for r in rows)


def _slot_agreement(a, b) -> float:
    return float(np.mean(np.asarray(a) == np.asarray(b)))


# ---------------------------------------------------------------------------
# key partitions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shards", [1, 2, 3, 4, 5])
def test_split_and_partition_by_key_equal_jax(shards):
    rng = np.random.default_rng(11)
    v = _vec(rng)
    # raw indices that fold to one 31-bit key land in one shard
    alias = SparseVec.from_pairs(np.array([12345, 12345 + 2 ** 31]),
                                 np.array([1.0, 2.0]), 2 ** 32)
    for vec in (v, alias):
        parts = merge.partition_by_key(vec, shards)
        want = jax_merge.partition_by_key(_jax_vec(vec), shards)
        assert len(parts) == shards
        for s in range(shards):
            got = merge.split_by_key(vec, shards, s)
            ref = jax_merge.split_by_key(_jax_vec(vec), shards, s)
            for p in (got, parts[s]):
                assert np.array_equal(p.indices, ref.indices)
                assert np.array_equal(p.values, ref.values)
                assert np.array_equal(p.indices, want[s].indices)
        sizes = [p.nnz for p in merge.partition_by_key(alias, shards)]
        assert sorted(sizes)[-1] == 2
    with pytest.raises(ValueError):
        merge.split_by_key(v, shards, shards)
    with pytest.raises(ValueError):
        merge.partition_by_key(v, 0)


# ---------------------------------------------------------------------------
# merge_rows against the JAX package and the host oracles
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", FAMILIES)
def test_merge_rows_equals_jax_on_jax_rows(name):
    fam, jfam = _pair(name)
    rng = np.random.default_rng(21)
    vecs = [_vec(rng) for _ in range(6)]
    a, b = _jax_shard_rows(jfam, vecs, 2)
    got = _np(fam.merge_rows(_t(a), _t(b)))
    want = _np(jfam.merge_rows(tuple(map(jnp.asarray, a)),
                               tuple(map(jnp.asarray, b))))
    assert [x.dtype for x in got] == [x.dtype for x in want]
    if name not in ("icws", "dmh"):
        for x, y, spec in zip(got, want, fam.components):
            assert np.array_equal(x, y), (name, spec.name)
        return
    fp, val, norm, key = got
    wfp, wval, wnorm, wkey = want
    assert _slot_agreement(fp, wfp) >= 0.99
    assert _slot_agreement(key, wkey) >= 0.99
    same = fp == wfp
    np.testing.assert_allclose(val[same], wval[same], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(norm, wnorm, rtol=1e-6)


@pytest.mark.parametrize("name, oracle", [("icws", ICWS), ("dmh", DMH)])
def test_cpu_merge_rows_equals_the_port_host_merge(name, oracle):
    """The family's torch merge and the host ``merge`` (numpy) on the same
    rows: fingerprints and argkeys equal, values to f32 rounding."""
    fam, _ = _pair(name)
    host = oracle(m=fam.m, seed=SEED)
    rng = np.random.default_rng(33)
    vecs = [_vec(rng) for _ in range(5)]
    a, b = _port_shard_rows(fam, vecs, 2)
    fp_m, val_m, norm_m, key_m = _np(fam.merge_rows(a, b))
    (fpa, va, na, ka), (fpb, vb, nb, kb) = _np(a), _np(b)
    for i in range(len(vecs)):
        sa = ICWSSketch(fingerprints=fpa[0, i], values=va[0, i].astype(
            np.float64), norm=float(na[0, i]), argkeys=ka[0, i])
        sb = ICWSSketch(fingerprints=fpb[0, i], values=vb[0, i].astype(
            np.float64), norm=float(nb[0, i]), argkeys=kb[0, i])
        ref = host.merge(sa, sb)
        assert np.array_equal(ref.fingerprints, fp_m[0, i]), i
        assert np.array_equal(ref.argkeys, key_m[0, i]), i
        np.testing.assert_allclose(ref.values, val_m[0, i], rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(ref.norm, norm_m[0, i], rtol=1e-6)


@pytest.mark.parametrize("name", FAMILIES)
def test_merge_rows_commutes_bitwise(name):
    fam, _ = _pair(name)
    rng = np.random.default_rng(22)
    a, b = _port_shard_rows(fam, [_vec(rng) for _ in range(6)], 2)
    for x, y, spec in zip(_np(fam.merge_rows(a, b)),
                          _np(fam.merge_rows(b, a)), fam.components):
        assert np.array_equal(x, y), (name, spec.name)


@pytest.mark.parametrize("name", ["cs", "jl"])
def test_linear_merge_associative_bitwise_on_integer_data(name):
    fam, _ = _pair(name)
    rng = np.random.default_rng(23)
    a, b, c = _port_shard_rows(
        fam, [_vec(rng, integer=True) for _ in range(5)], 3)
    left = fam.merge_rows(fam.merge_rows(a, b), c)
    right = fam.merge_rows(a, fam.merge_rows(b, c))
    assert torch.equal(left[0], right[0])


@pytest.mark.parametrize("name", ["ts", "ps"])
def test_sampling_merge_associative(name):
    """Keys and values associate exactly; taus to f32 rounding (the
    intermediate merge stores its tau in f32)."""
    fam, _ = _pair(name)
    rng = np.random.default_rng(24)
    a, b, c = _port_shard_rows(fam, [_vec(rng) for _ in range(5)], 3)
    kl, vl, tl = _np(fam.merge_rows(fam.merge_rows(a, b), c))
    kr, vr, tr = _np(fam.merge_rows(a, fam.merge_rows(b, c)))
    assert np.array_equal(kl, kr) and np.array_equal(vl, vr)
    np.testing.assert_allclose(tl, tr, rtol=1e-5)


@pytest.mark.parametrize("name", ["ts", "ps"])
def test_sampling_merge_rejects_shared_keys(name):
    fam, _ = _pair(name)
    (a,) = _port_shard_rows(fam, [_vec(np.random.default_rng(25))], 1)
    with pytest.raises(ValueError, match="disjoint"):
        fam.merge_rows(a, a)


# ---------------------------------------------------------------------------
# merge_stores and build_sharded
# ---------------------------------------------------------------------------
def _store(fam, vecs, tenant=None, packed=False):
    store = CorpusStore(family=fam, fields=1, packed=packed, device="cpu")
    store.append(*fam.sketch_rows(vecs, device="cpu"), tenant=tenant)
    return store


def test_merge_stores_rejects_mismatched_inputs():
    rng = np.random.default_rng(41)
    vecs = [_vec(rng) for _ in range(4)]
    fam = families.TSFamily(slots=32, seed=SEED)
    a = _store(fam, vecs)
    with pytest.raises(ValueError, match="seed"):
        merge.merge_stores(a, _store(families.TSFamily(slots=32, seed=4),
                                     vecs))
    with pytest.raises(ValueError, match="row-aligned"):
        merge.merge_stores(a, _store(fam, vecs[:2]))
    with pytest.raises(ValueError, match="famil"):
        merge.merge_stores(a, _store(families.PSFamily(slots=32, seed=SEED),
                                     vecs))
    with pytest.raises(ValueError, match="packed"):
        merge.merge_stores(a, _store(fam, vecs, packed=True))
    lo = [merge.split_by_key(v, 2, 0) for v in vecs]
    hi = [merge.split_by_key(v, 2, 1) for v in vecs]
    c = _store(fam, lo, tenant="acme")
    with pytest.raises(ValueError, match="tenant"):
        merge.merge_stores(a, c)
    m = merge.merge_stores(c, _store(fam, hi, tenant="acme"))
    assert m.tenants() == ("acme",)
    assert m.tenant_ranges("acme") == ((0, len(vecs)),)


@pytest.mark.parametrize("name", ["icws", "cs", "ts", "dmh"])
def test_merged_store_spare_rows_stay_inert(name):
    fam, _ = _pair(name)
    rng = np.random.default_rng(43)
    store = merge.build_sharded([_vec(rng) for _ in range(5)], family=fam,
                                shards=2, device="cpu")
    assert store.capacity > len(store)
    for buf, spec in zip(store.buffers(), fam.components):
        assert bool((buf[:, len(store):] == spec.fill).all()), spec.name
    store.append(*fam.sketch_rows([_vec(rng)], device="cpu"))
    assert len(store) == 6


@pytest.mark.parametrize("name, shards", [("cs", 2), ("cs", 3), ("jl", 2),
                                          ("jl", 3), ("ts", 2), ("ts", 3),
                                          ("ps", 2), ("ps", 3)])
def test_build_sharded_matches_single_stream(name, shards):
    """CS and JL bit for bit on integer data; TS and PS keys and values bit
    for bit, taus to f32 rounding."""
    fam, _ = _pair(name)
    rng = np.random.default_rng(31)
    vecs = [_vec(rng, integer=name in ("cs", "jl")) for _ in range(7)]
    single = fam.sketch_rows(vecs, device="cpu")
    store = merge.build_sharded(vecs, family=fam, shards=shards,
                                device="cpu")
    got = tuple(c[0] for c in store.field_arrays())
    for x, y in zip(got[:2], single[:2]):
        assert torch.equal(x, y)
    if name in ("ts", "ps"):
        np.testing.assert_allclose(got[2].numpy(), single[2].numpy(),
                                   rtol=1e-5)


# ---------------------------------------------------------------------------
# sharded lake builds through the index and the service
# ---------------------------------------------------------------------------
def _separated_lake(rng, integer=False):
    """Near-duplicates of the query signal and disjoint-support noise
    tables (``tests/test_merge.py``'s lake)."""
    keys = np.arange(500)
    if integer:
        signal = rng.integers(1, 9, size=500) * rng.choice([-1.0, 1.0], 500)
        jitter = lambda: signal + rng.integers(10, 13, size=500)  # noqa: E731
        noise = lambda: (rng.integers(1, 9, size=500)             # noqa: E731
                         * rng.choice([-1.0, 1.0], size=500))
    else:
        signal = rng.normal(size=500)
        jitter = lambda: signal + 0.01 * rng.normal(size=500)  # noqa: E731
        noise = lambda: rng.normal(size=500)                   # noqa: E731
    tables = [(f"dup{i}", keys, jitter()) for i in range(3)]
    tables += [(f"far{i}", np.arange(9000 + 600 * i, 9500 + 600 * i),
                noise()) for i in range(4)]
    return tables, [(keys, signal),
                    (np.arange(250, 750), rng.normal(size=500))]


def _build(cls, name, tables, sharded, **kwargs):
    idx = cls(m=128, seed=1, keep_host_oracle=False, family=name, **kwargs)
    if sharded:
        idx.add_tables_sharded(tables, shards=3)
    else:
        for nm, k, v in tables:
            idx.add_table(nm, k, v)
    return idx


def _stats(r):
    return [r.join_size, r.sum_b, r.mean_b, r.corr]


@pytest.mark.parametrize("name", FAMILIES)
def test_sharded_ingest_ranks_as_single_stream_and_as_jax(name):
    """Against the port's single-stream build and JAX's sharded build of
    the same lake: CS results equal, JL names equal and statistics within
    rtol 1e-5, the top-3 sets for ICWS, DMH, TS and PS (and the signal
    query's three near-duplicates)."""
    integer = name in ("cs", "jl")
    tables, queries = _separated_lake(np.random.default_rng(51 if integer
                                                            else 52),
                                      integer=integer)
    single = _build(DatasetSearchIndex, name, tables, False, device="cpu")
    sharded = _build(DatasetSearchIndex, name, tables, True, device="cpu")
    jax_sharded = _build(JaxIndex, name, tables, True)
    kw = dict(top_k=3, min_join=20)
    got = sharded.query_batch(queries, **kw)
    for ref in (single.query_batch(queries, **kw),
                jax_sharded.query_batch(queries, **kw)):
        for res_g, res_r in zip(got, ref):
            if name in ("cs", "jl"):
                assert [r.name for r in res_g] == [r.name for r in res_r]
                for a, b in zip(res_g, res_r):
                    np.testing.assert_allclose(_stats(a), _stats(b),
                                               rtol=1e-5, atol=1e-5)
            else:
                assert {r.name for r in res_g} == {r.name for r in res_r}
    if name == "cs":
        assert got == single.query_batch(queries, **kw)
    if not integer:
        assert {r.name for r in got[0]} == {"dup0", "dup1", "dup2"}


def test_sharded_ingest_into_tenant_is_contiguous():
    rng = np.random.default_rng(64)
    idx = DatasetSearchIndex(m=64, seed=2, keep_host_oracle=False,
                             device="cpu")
    keys = np.arange(400)
    tabs = [(f"t{i}", keys, rng.normal(size=400) + 0.5 * i * np.sin(keys))
            for i in range(3)]
    idx.add_tables_sharded(tabs, shards=2, tenant="acme")
    assert idx.store.tenant_ranges("acme") == ((0, 3),)
    res = idx.query(keys, rng.normal(size=400), top_k=3, min_join=5,
                    tenant="acme")
    assert {r.name for r in res} <= {"t0", "t1", "t2"}
    host_only = DatasetSearchIndex(m=64, backend="host", device="cpu")
    with pytest.raises(ValueError, match="device corpus"):
        host_only.add_tables_sharded([("t", keys, np.ones(400))], shards=2)


def test_service_sharded_ingest_checks_names_and_accounts():
    rng = np.random.default_rng(63)
    svc = SketchSearchService(m=64, seed=2, keep_host_oracle=False,
                              device="cpu")
    keys = np.arange(300)
    svc.ingest("sales", keys, rng.normal(size=300), tenant="acme")
    with pytest.raises(ValueError, match="sales"):
        svc.ingest_many_sharded([("sales", keys, rng.normal(size=300))],
                                shards=2, tenant="acme")
    with pytest.raises(ValueError, match="fresh"):
        svc.ingest_many_sharded(
            [("fresh", keys, rng.normal(size=300)),
             ("fresh", keys, rng.normal(size=300))], shards=2,
            tenant="globex")
    svc.ingest_many_sharded([("lake0", keys, rng.normal(size=300)),
                             ("sales", keys, rng.normal(size=300))],
                            shards=2, tenant="globex")
    d = svc.describe()
    assert d["tables"] == 3 and d["tenants"] == 2
    assert svc.stats.tables_ingested == 3
    assert svc.stats.rows_ingested == 900
    assert svc.describe(tenant="globex")["row_ranges"] == 1.0
