"""The paper's synthetic inputs (copy of ``repro.data.synthetic``), numpy
on the host, equal by value to the JAX package's on equal seeds.

* :func:`sparse_pair` -- Section 5.1: length-n vectors, fixed nnz, a set
  overlap ratio, U(-1, 1) values with 10% outliers in U(20, 30).
* :func:`worldbank_like_pair` -- the Section 5.2 stand-in for World Bank
  columns: heavy-tailed values (log-normal body, Pareto outliers), a set
  overlap, normalised to unit norm as the paper does.
* :func:`tfidf_corpus` -- the Section 5.2 stand-in for 20 Newsgroups:
  Zipf term draws with TF-IDF weights over a large vocabulary.
* :func:`token_stream` -- LM training tokens (Zipf unigrams), fixed by
  (seed, step) so an input pipeline can resume.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from repro_torch.core.types import SparseVec


def sparse_pair(rng: np.random.Generator, n: int = 10000, nnz: int = 2000,
                overlap: float = 0.1, outlier_frac: float = 0.1
                ) -> Tuple[SparseVec, SparseVec]:
    """The paper's Fig. 4 protocol."""
    n_ov = int(round(overlap * nnz))
    idx = rng.choice(n, size=2 * nnz - n_ov, replace=False)
    ia = idx[:nnz]
    ib = np.concatenate([idx[:n_ov], idx[nnz:]])

    def values(k):
        v = rng.uniform(-1.0, 1.0, size=k)
        out = rng.random(k) < outlier_frac
        v[out] = rng.uniform(20.0, 30.0, size=int(out.sum()))
        return v

    a = np.zeros(n)
    b = np.zeros(n)
    a[ia] = values(nnz)
    b[ib] = values(len(ib))
    return SparseVec.from_dense(a), SparseVec.from_dense(b)


def worldbank_like_pair(rng: np.random.Generator, n: int = 20000,
                        nnz: int = 1500, overlap: float = 0.2,
                        outlier_rate: float = 0.02, outlier_scale: float = 50.0
                        ) -> Tuple[SparseVec, SparseVec]:
    """Heavy-tailed column pairs with a set overlap and kurtosis.  Outliers
    on shared keys are large in both columns (a country total is large in
    both tables), so the joined inner product sits on a few co-located
    heavy rows."""
    n_ov = int(round(overlap * nnz))
    idx = rng.choice(n, size=2 * nnz - n_ov, replace=False)
    shared = idx[:n_ov]
    ia, ib = idx[:nnz], np.concatenate([shared, idx[nnz:]])

    def body(k):
        return (rng.lognormal(mean=0.0, sigma=1.0, size=k)
                * rng.choice([-1, 1], k))

    a = np.zeros(n)
    b = np.zeros(n)
    a[ia] = body(nnz)
    b[ib] = body(len(ib))
    # independent outliers of each column
    for vec, own in ((a, ia), (b, ib)):
        out = own[rng.random(len(own)) < outlier_rate]
        vec[out] *= outlier_scale * (1 + rng.pareto(2.0, size=len(out)))
    # co-located outliers on shared keys: one row scale in both columns
    if n_ov:
        hot = shared[rng.random(n_ov) < outlier_rate]
        scale = outlier_scale * (1 + rng.pareto(2.0, size=len(hot)))
        a[hot] *= scale
        b[hot] *= scale
    a /= max(np.linalg.norm(a), 1e-12)   # unit-norm columns, as the paper
    b /= max(np.linalg.norm(b), 1e-12)
    return SparseVec.from_dense(a), SparseVec.from_dense(b)


def kurtosis(v: SparseVec) -> float:
    x = v.values
    if x.size < 4:
        return 0.0
    mu, sd = x.mean(), x.std()
    if sd == 0:
        return 0.0
    return float(np.mean(((x - mu) / sd) ** 4) - 3.0)


def tfidf_corpus(rng: np.random.Generator, n_docs: int = 200,
                 vocab: int = 2 ** 18, doc_len_range=(50, 2000),
                 zipf_a: float = 1.3, topic_frac: float = 0.5
                 ) -> List[SparseVec]:
    """Zipf term draws to TF-IDF sparse vectors (the Fig. 6 stand-in).  A
    ``topic_frac`` share of a document's tokens comes from a vocabulary
    block of its own (the paper's mostly unique bigrams: sparse vectors of
    low overlap), the rest from shared Zipf vocabulary."""
    lengths = rng.integers(doc_len_range[0], doc_len_range[1], size=n_docs)
    term_lists = []
    df = {}
    block = vocab // (2 * max(n_docs, 1))
    stopwords = 20          # the Zipf head a preprocessing drops
    for d, L in enumerate(lengths):
        L = int(L)
        n_topic = int(L * topic_frac)
        shared = stopwords + ((rng.zipf(zipf_a, size=L - n_topic) - 1)
                              % (vocab // 2 - stopwords))
        topic_lo = vocab // 2 + d * block
        topic = topic_lo + ((rng.zipf(zipf_a, size=n_topic) - 1) % block)
        terms = np.concatenate([shared, topic])
        uniq, counts = np.unique(terms, return_counts=True)
        term_lists.append((uniq, counts, int(L)))
        for t in uniq:
            df[int(t)] = df.get(int(t), 0) + 1
    docs = []
    for uniq, counts, L in term_lists:
        idf = np.array([np.log(n_docs / (1 + df[int(t)])) + 1.0
                        for t in uniq])
        tf = 1.0 + np.log(counts)    # sublinear tf
        docs.append(SparseVec.from_pairs(uniq.astype(np.int64), tf * idf,
                                         vocab))
    return docs


def token_stream(seed: int, step: int, batch: int, seq: int,
                 vocab: int) -> np.ndarray:
    """(seed, step) -> tokens [batch, seq + 1]; restarting at step k
    regenerates the same batch."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    z = rng.zipf(1.3, size=(batch, seq + 1))
    return (z - 1) % vocab
