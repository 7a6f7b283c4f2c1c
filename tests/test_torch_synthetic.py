"""The port's copies of the paper's synthetic generators
(``repro_torch.data.synthetic``) against ``repro.data.synthetic`` on the
CPU: equal seeds give equal ``SparseVec``s (indices, values, n), equal
``kurtosis`` and equal token arrays, at small sizes."""
import numpy as np
import pytest
import torch

import repro_torch.data as port_data
from repro.data import synthetic as ref
from repro_torch.data import synthetic as port

# small shapes: one intra-op thread per test process, so that parallel
# test workers do not oversubscribe the cores
torch.set_num_threads(1)

NAMES = ("sparse_pair", "worldbank_like_pair", "kurtosis", "tfidf_corpus",
         "token_stream")


def _same_vec(a, b):
    assert a.n == b.n
    assert a.indices.dtype == b.indices.dtype
    assert np.array_equal(a.indices, b.indices)
    assert np.array_equal(a.values, b.values)


# (generator, keyword arguments): each case draws from a fresh
# default_rng(seed) in both packages
CASES = [
    ("sparse_pair", dict(n=2_000, nnz=150, overlap=0.05)),
    ("sparse_pair", dict(n=2_000, nnz=150, overlap=0.5, outlier_frac=0.3)),
    ("sparse_pair", dict(n=400, nnz=200, overlap=1.0)),
    ("worldbank_like_pair", dict(n=3_000, nnz=150, overlap=0.2)),
    ("worldbank_like_pair", dict(n=3_000, nnz=150, overlap=0.0,
                                 outlier_rate=0.2)),
    ("tfidf_corpus", dict(n_docs=6, vocab=2 ** 12,
                          doc_len_range=(20, 200))),
]


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("name, kwargs", CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_generators_equal_jax(name, kwargs, seed):
    got = getattr(port, name)(np.random.default_rng(seed), **kwargs)
    want = getattr(ref, name)(np.random.default_rng(seed), **kwargs)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _same_vec(a, b)
        assert port.kurtosis(a) == ref.kurtosis(b)


@pytest.mark.parametrize("step", [0, 5])
def test_token_stream_equals_jax(step):
    got = port.token_stream(seed=4, step=step, batch=3, seq=16, vocab=1_000)
    want = ref.token_stream(seed=4, step=step, batch=3, seq=16, vocab=1_000)
    assert got.shape == (3, 17)
    assert got.dtype == want.dtype
    assert np.array_equal(got, want)
    assert np.array_equal(got, port.token_stream(4, step, 3, 16, 1_000))


def test_kurtosis_of_short_and_flat_vectors_is_zero():
    from repro_torch.core import SparseVec
    for vals in ([1.0, 2.0, 3.0], [2.0] * 6):
        v = SparseVec.from_pairs(np.arange(len(vals)), vals, 10)
        assert port.kurtosis(v) == ref.kurtosis(v) == 0.0


def test_generators_are_exported_from_the_data_package():
    for name in NAMES:
        assert getattr(port_data, name) is getattr(port, name)
