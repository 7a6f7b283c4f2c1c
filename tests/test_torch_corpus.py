"""The port's ``SketchCorpus`` (on the CPU: plain kernel versions) and its
host ICWS oracle, against the JAX package's ``SketchCorpus`` and
``repro.core.ICWS``: chunked appends, device estimates against the host
estimator on identical rows, accuracy, validation, batched against
sequential, a JAX corpus carried across, and sketch agreement."""
import numpy as np
import pytest
import torch

from repro.core import ICWS as JaxICWS
from repro.core.icws import StackedICWS as JaxStacked
from repro.core.types import inner_fast
from repro.data import SketchCorpus as JaxCorpus
from repro.data.synthetic import sparse_pair
from repro_torch import SketchCorpus
from repro_torch.convert import corpus_from_numpy
from repro_torch.core import ICWS, SparseVec, StackedICWS
from repro_torch.data.store import CorpusStore

# small shapes: one intra-op thread per test process, so that parallel
# test workers do not oversubscribe the cores
torch.set_num_threads(1)


def _port(v):
    return SparseVec(indices=v.indices, values=v.values, n=v.n)


def _lake(seed, count, n=600, nnz=150):
    rng = np.random.default_rng(seed)
    return [sparse_pair(rng, n=n, nnz=nnz, overlap=0.3)[0]
            for _ in range(count)]


def _corpus(vecs, m, seed):
    corpus = SketchCorpus(m=m, seed=seed, device="cpu")
    corpus.add_batch([_port(v) for v in vecs])
    return corpus


def test_chunked_append_matches_one_shot():
    vecs = [_port(v) for v in _lake(17, 7)]
    one = SketchCorpus(m=128, seed=5, device="cpu")
    one.add_batch(vecs)
    chunked = SketchCorpus(m=128, seed=5, device="cpu")
    for lo, hi in ((0, 3), (3, 5), (5, 7)):
        chunked.add_batch(vecs[lo:hi])
    assert len(one) == len(chunked) == 7 <= chunked.capacity
    for a, b in zip(one.arrays(), chunked.arrays()):
        assert torch.equal(a, b)
    before = chunked.arrays()[0].clone()
    chunked.add_batch(vecs[:1])
    assert len(chunked) == 8
    assert torch.equal(chunked.arrays()[0][:7], before)


@pytest.mark.parametrize("host", ["port", "jax"])
def test_device_estimates_match_host_estimator(host):
    """One-vs-many and many-vs-many estimates on the corpus rows against
    the host ICWS ``estimate_batch`` in f64 on the same rows: < 10 ppm."""
    m, vecs = 256, _lake(23, 9)
    queries = _lake(24, 3)
    corpus = _corpus(vecs, m, 2)
    fpc, vc, nc = (a.numpy() for a in corpus.arrays()[:3])
    fq, vq, nq, _ = (a.numpy() for a in corpus.sketch_query(_port(queries[0])))
    one = corpus.estimate(fq, vq, nq[0]).numpy()
    batch = corpus.estimate_vecs([_port(q) for q in queries]).numpy()
    icws, stacked = ((ICWS, StackedICWS) if host == "port"
                     else (JaxICWS, JaxStacked))
    rows = stacked(fingerprints=fpc, values=vc.astype(np.float64),
                   norm=nc.astype(np.float64))
    tile = stacked(fingerprints=np.repeat(fq, len(vecs), 0),
                   values=np.repeat(vq.astype(np.float64), len(vecs), 0),
                   norm=np.full(len(vecs), float(nq[0])))
    want = icws(m=m, seed=2).estimate_batch(tile, rows)
    for got in (one, batch[0]):
        scale = np.maximum(np.abs(want), np.abs(got))
        rel = np.abs(got - want) / np.where(scale == 0, 1.0, scale)
        assert rel.max() < 1e-5, rel
    assert np.count_nonzero(want) >= 3


def test_estimate_accuracy_end_to_end():
    rng = np.random.default_rng(29)
    m = 2048
    pairs = [sparse_pair(rng, n=800, nnz=200, overlap=0.4) for _ in range(4)]
    corpus = _corpus([b for _, b in pairs], m, 9)
    for qi, (a, b) in enumerate(pairs):
        est = corpus.estimate_vec(_port(a)).numpy()
        bound = 4.0 / np.sqrt(m) * a.norm() * b.norm()
        assert abs(est[qi] - inner_fast(a, b)) < bound


def test_empty_corpus_raises():
    corpus = SketchCorpus(m=64, device="cpu")
    with pytest.raises(ValueError, match="empty"):
        corpus.arrays()
    q = _port(_lake(1, 1)[0])
    with pytest.raises(ValueError, match="empty"):
        corpus.estimate_vec(q)
    with pytest.raises(ValueError, match="empty"):
        corpus.estimate_vecs([q, q])
    assert len(corpus) == 0


def test_add_sketches_validates_all_components():
    rng = np.random.default_rng(3)
    m = 64
    corpus = SketchCorpus(m=m, device="cpu")
    fp = rng.integers(0, 50, size=(4, m)).astype(np.int32)
    val = rng.normal(size=(4, m)).astype(np.float32)
    norm = np.ones(4, np.float32)
    key = rng.integers(0, 2 ** 31 - 1, size=(4, m)).astype(np.int32)
    for bad in ((fp, val[:3], norm, key), (fp, val, norm[:3], key),
                (fp, val, norm, key[:3]), (fp[:, :60], val, norm, key)):
        with pytest.raises(ValueError):
            corpus.add_sketches(*bad)
    assert len(corpus) == 0                        # nothing ingested
    corpus.add_sketches(torch.from_numpy(fp), val, norm, key)
    assert len(corpus) == 4


def test_store_arrays_drop_the_field_axis_of_one_field():
    one = CorpusStore(m=8, fields=1, device="cpu")
    three = CorpusStore(m=8, fields=3, device="cpu")
    for store in (one, three):
        with pytest.raises(ValueError, match="empty"):
            store.arrays()
    rows = (torch.zeros((3, 5, 8), dtype=torch.int32), torch.ones((3, 5, 8)),
            torch.ones((3, 5)), torch.zeros((3, 5, 8), dtype=torch.int32))
    one.append(*(r[0] for r in rows))
    three.append(*rows)
    assert [tuple(a.shape) for a in one.arrays()] == [(5, 8), (5, 8), (5,),
                                                      (5, 8)]
    assert [tuple(a.shape) for a in three.arrays()] == [(3, 5, 8), (3, 5, 8),
                                                        (3, 5), (3, 5, 8)]
    assert one.capacity > 5 and one.arrays()[0].data_ptr() == \
        one.buffers()[0].data_ptr()


def test_estimate_vecs_equals_sequential():
    corpus = _corpus(_lake(19, 9, n=500, nnz=120), 128, 3)
    queries = [_port(q) for q in _lake(20, 5, n=500, nnz=120)]
    batched = corpus.estimate_vecs(queries)
    assert batched.shape == (5, 9)
    for qi, q in enumerate(queries):
        assert torch.equal(batched[qi], corpus.estimate_vec(q))


def test_mesh_and_card_defaults():
    """A corpus sharded over a 2-way CPU mesh (5 rows: not a multiple of 2)
    estimates bit for bit as the single-device one; without ``device`` the
    corpus wants the card."""
    from repro_torch.launch import make_corpus_mesh
    vecs = [_port(v) for v in _lake(21, 5, n=400, nnz=80)]
    queries = [_port(v) for v in _lake(22, 3, n=400, nnz=80)]
    sharded = SketchCorpus(m=64, seed=2, device="cpu",
                           mesh=make_corpus_mesh(devices=("cpu", "cpu")))
    sharded.add_batch(vecs)
    assert torch.equal(sharded.estimate_vecs(queries),
                       _corpus(vecs, 64, 2).estimate_vecs(queries))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SketchCorpus(m=8)


@pytest.mark.parametrize("m", [64, 200])
def test_host_icws_equals_jax_bit_for_bit(m):
    """Fingerprints, values, argkeys, merges and estimates of the port's
    host ICWS equal ``repro.core.ICWS``'s (numpy over one mixer)."""
    port, jax_icws = ICWS(m=m, seed=m), JaxICWS(m=m, seed=m)
    vecs = _lake(m, 3) + [sparse_pair(np.random.default_rng(1), n=50, nnz=0,
                                      overlap=0.0)[0]]
    for v in vecs:
        a, b = port.sketch(_port(v)), jax_icws.sketch(v)
        assert np.array_equal(a.fingerprints, b.fingerprints)
        assert np.array_equal(a.values, b.values) and a.norm == b.norm
        assert np.array_equal(a.argkeys, b.argkeys)
    assert np.all(port.sketch(_port(vecs[-1])).fingerprints == -1)
    # a merge of disjoint halves and the pairwise estimate
    v = vecs[0]
    lo = v.indices < np.median(v.indices)
    halves = [type(v)(indices=v.indices[s], values=v.values[s], n=v.n)
              for s in (lo, ~lo)]
    a = port.merge(*(port.sketch(_port(h)) for h in halves))
    b = jax_icws.merge(*(jax_icws.sketch(h) for h in halves))
    assert np.array_equal(a.fingerprints, b.fingerprints)
    assert np.array_equal(a.values, b.values)
    assert port.estimate(port.sketch(_port(vecs[0])),
                         port.sketch(_port(vecs[1]))) == \
        jax_icws.estimate(jax_icws.sketch(vecs[0]), jax_icws.sketch(vecs[1]))


def test_jax_corpus_carried_across_estimates_the_same():
    m = 128
    vecs, queries = _lake(31, 8), _lake(32, 4)
    jax_corpus = JaxCorpus(m=m, seed=4)
    jax_corpus.add_batch(vecs)
    corpus = corpus_from_numpy(*[np.asarray(a) for a in jax_corpus.arrays()],
                               m=m, seed=4, device="cpu")
    for a, b in zip(corpus.arrays(), jax_corpus.arrays()):
        assert np.array_equal(a.numpy(), np.asarray(b))
    want = np.asarray(jax_corpus.estimate_vecs(queries))
    got = corpus.estimate_vecs([_port(q) for q in queries]).numpy()
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(corpus.estimate_vec(_port(queries[1])).numpy(),
                               np.asarray(jax_corpus.estimate_vec(queries[1])),
                               rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("source", ["kernel", "host"])
def test_port_and_jax_corpora_agree_on_fingerprints(source):
    """A corpus sketched by the port (its kernel's plain version, or its
    host ICWS through ``add_sketches``) and one sketched by the JAX
    package agree on at least 99% of fingerprint slots."""
    m, vecs = 128, _lake(41, 8)
    jax_corpus = JaxCorpus(m=m, seed=6)
    jax_corpus.add_batch(vecs)
    if source == "kernel":
        corpus = _corpus(vecs, m, 6)
    else:
        corpus = SketchCorpus(m=m, seed=6, device="cpu")
        sk = [ICWS(m=m, seed=6).sketch(_port(v)) for v in vecs]
        corpus.add_sketches(np.stack([s.fingerprints for s in sk]),
                            np.stack([s.values for s in sk]),
                            np.array([s.norm for s in sk]),
                            np.stack([s.argkeys for s in sk]))
    fp, fp_j = corpus.arrays()[0].numpy(), np.asarray(jax_corpus.arrays()[0])
    assert np.mean(fp == fp_j) >= 0.99
    assert corpus.storage_doubles() == jax_corpus.storage_doubles()


def _ppm(a, ref):
    scale = np.maximum(np.maximum(np.abs(ref), np.abs(a)), 1e-12)
    return float(np.max(np.abs(a - ref) / scale)) * 1e6


def test_f32_corpus_estimates_match_the_jax_kernel_on_host_sketches():
    """Why f32 corpus estimates sit some ppm from the f64 host estimator:
    the port's plain one-vs-many route (B3) and the JAX package's (the
    Pallas kernel, interpret mode on the CPU) agree within 10 ppm (the
    gate ``chip_smoke.py`` holds the card to against the host) on rows
    sketched by the host ICWS, half of them planted partners of the
    queries, the rest sharing keys with them by chance.  Run with ``-s``
    to print each route's distance from the host."""
    import jax.numpy as jnp
    from repro.kernels import ops as jax_ops
    from repro_torch.kernels import ops
    # a domain small enough that unrelated rows share keys with the
    # queries: weak, cancelling estimates, where f32 rounding shows most
    m, domain = 512, 1 << 13
    rng = np.random.default_rng(4)
    queries = [np.unique(rng.integers(0, domain, 600)) for _ in range(4)]
    queries = [(k, rng.normal(size=k.size)) for k in queries]
    rows = []
    for i in range(48):
        if i % 2 == 0:
            keys, vals = queries[(i // 2) % 4]
            keep = rng.random(keys.size) < 0.85
            extra = np.setdiff1d(rng.integers(0, domain, 150), keys)
            k = np.concatenate([keys[keep], extra])
            v = np.concatenate([3.0 * vals[keep]
                                + 0.3 * rng.normal(size=keep.sum()),
                                rng.normal(0.0, 3.0, extra.size)])
        else:
            k = np.unique(rng.integers(0, domain, int(rng.integers(100, 1500))))
            v = rng.normal(100.0, 15.0, k.size)
        order = np.argsort(k)
        rows.append((k[order], v[order]))
    icws = ICWS(m=m, seed=0)

    def stored(pairs):
        sk = [icws.sketch(SparseVec.from_pairs(k, v, domain))
              for k, v in pairs]
        return (np.stack([s.fingerprints for s in sk]),
                np.stack([s.values for s in sk]).astype(np.float32),
                np.array([s.norm for s in sk], np.float32))

    (fq, vq, nq), (fc, vc, nc) = stored(queries), stored(rows)
    rows_h = StackedICWS(fingerprints=fc, values=vc.astype(np.float64),
                         norm=nc.astype(np.float64))
    host, port, jax = [], [], []
    for q in range(len(queries)):
        host.append(icws.estimate_batch(StackedICWS(
            fingerprints=np.repeat(fq[q:q + 1], len(rows), 0),
            values=np.repeat(vq[q:q + 1].astype(np.float64), len(rows), 0),
            norm=np.full(len(rows), float(nq[q]))), rows_h))
        port.append(ops.icws_estimate_corpus(
            *map(torch.from_numpy, (fq[q], vq[q])), float(nq[q]),
            *map(torch.from_numpy, (fc, vc, nc))).numpy())
        jax.append(np.asarray(jax_ops.icws_estimate_corpus(
            jnp.asarray(fq[q]), jnp.asarray(vq[q]), jnp.float32(nq[q]),
            *map(jnp.asarray, (fc, vc, nc)))))
    host, port, jax = (np.stack(a).astype(np.float64)
                       for a in (host, port, jax))
    # every planted partner collides with its query
    assert np.count_nonzero(host) >= len(rows) // 2
    port_jax = _ppm(port, jax)
    print(f"port vs host {_ppm(port, host):.4f} ppm, JAX vs host "
          f"{_ppm(jax, host):.4f} ppm, port vs JAX {port_jax:.4f} ppm")
    assert port_jax < 10.0
