"""The paper's host baselines and the storage-matched registry of the port
(``repro_torch.core``) against ``repro.core`` on the CPU, bit for bit.

For all nine ``FACTORIES`` at storage 100 and 400 on two seeds the
sketches are equal array for array, and ``estimate``, ``estimate_batch``
and ``estimate_pairs`` equal.  So are the MH and KMV union merges, the f64
JL and CountSketch merges, both CountSketch ``decode``s, the exact ground
truth (``inner``, ``inner_fast``, ``intersection_norms``, the bounds of
Fact 1 and Theorem 2, ``densify``), ``hash_unit``, ``round_unit``,
``rounded_values``, ``sketch_bruteforce`` and every sketcher's hash
coefficients: a sketcher is fixed by its size and seed.  The identities
``chip_smoke.py``'s ``paper baselines`` phase gates on hold here too, and
``examples/quickstart_torch.py`` prints ``examples/quickstart.py``'s
numbers.  ``repro_torch.core`` exports every name of ``repro.core``."""
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch.core as port
from repro.core.types import SparseVec as JaxVec
from repro_torch.data.synthetic import sparse_pair

# small shapes: one intra-op thread per test process, so that parallel
# test workers do not oversubscribe the cores
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
STACKS = {"mh": "stack_mh", "wmh": "stack_wmh", "icws": "stack_icws",
          "dmh": "stack_icws"}


def _jax(v):
    return JaxVec(indices=v.indices, values=v.values, n=v.n)


def _vecs(seed):
    """Two ``sparse_pair`` pairs at nnz 150 (overlaps 0.2 and 0.6) and an
    empty vector."""
    rng = np.random.default_rng(seed)
    vecs = [v for ov in (0.2, 0.6)
            for v in sparse_pair(rng, n=3_000, nnz=150, overlap=ov)]
    return vecs + [port.SparseVec.from_pairs(np.zeros(0), np.zeros(0), 3_000)]


def _equal(a, b):
    """Two sketches (or sketchers' hash families) equal field by field."""
    fa, fb = vars(a), vars(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert np.array_equal(np.asarray(fa[k]), np.asarray(fb[k])), k


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("storage", [100, 400])
@pytest.mark.parametrize("method", list(ref.FACTORIES))
def test_registry_sketches_and_estimates_equal_jax(method, storage, seed):
    assert list(port.FACTORIES) == list(ref.FACTORIES)
    assert port.PAPER_METHODS == ref.PAPER_METHODS
    assert set(ref.__all__) <= set(port.__all__)
    assert all(getattr(port, name) is not None for name in ref.__all__)
    sk, rk = port.make(method, storage, seed=seed), ref.make(method, storage,
                                                            seed=seed)
    assert type(sk).__name__ == type(rk).__name__
    assert sk.name == rk.name
    vecs = _vecs(seed)
    got = [sk.sketch(v) for v in vecs]
    want = [rk.sketch(_jax(v)) for v in vecs]
    for a, b in zip(got, want):
        assert type(a).__name__ == type(b).__name__
        _equal(a, b)
        assert a.storage_doubles() == b.storage_doubles()
    pairs = [(0, 1), (2, 3), (0, 3), (1, 4)]
    for i, j in pairs:
        assert sk.estimate(got[i], got[j]) == rk.estimate(want[i], want[j])
    if method in STACKS:
        stack, rstack = getattr(port, STACKS[method]), getattr(ref,
                                                               STACKS[method])
        A = stack([got[i] for i, _ in pairs])
        B = stack([got[j] for _, j in pairs])
        est = sk.estimate_batch(A, B)
        assert np.array_equal(est, rk.estimate_batch(
            rstack([want[i] for i, _ in pairs]),
            rstack([want[j] for _, j in pairs])))
        assert np.array_equal(est, [sk.estimate(got[i], got[j])
                                    for i, j in pairs])
    if hasattr(rk, "estimate_pairs"):
        assert np.array_equal(
            sk.estimate_pairs([got[i] for i, _ in pairs],
                              [got[j] for _, j in pairs]),
            rk.estimate_pairs([want[i] for i, _ in pairs],
                              [want[j] for _, j in pairs]))
    dense = np.arange(-3.0, 5.0)
    _equal(sk.sketch_dense(dense), rk.sketch_dense(dense))


def _halves(v):
    return (port.SparseVec(indices=v.indices[::2], values=v.values[::2],
                           n=v.n),
            port.SparseVec(indices=v.indices[1::2], values=v.values[1::2],
                           n=v.n))


@pytest.mark.parametrize("method", ["mh", "kmv", "jl", "cs"])
def test_merges_equal_jax_and_the_sketch_of_the_whole(method):
    """MH and KMV ``merge_union`` of a vector's two disjoint halves is the
    sketch of the whole; the f64 JL and CountSketch ``merge`` is within
    1e-12 of the table's largest magnitude of the sketch of the sum."""
    sk, rk = port.make(method, 400, seed=5), ref.make(method, 400, seed=5)
    v = _vecs(5)[0]
    lo, hi = _halves(v)
    merge = "merge_union" if method in ("mh", "kmv") else "merge"
    got = getattr(sk, merge)(sk.sketch(lo), sk.sketch(hi))
    _equal(got, getattr(rk, merge)(rk.sketch(_jax(lo)), rk.sketch(_jax(hi))))
    whole = sk.sketch(v)
    if method in ("mh", "kmv"):
        _equal(got, whole)
    else:
        arr = "proj" if method == "jl" else "table"
        x, y = getattr(got, arr), getattr(whole, arr)
        assert np.max(np.abs(x - y)) <= 1e-12 * np.max(np.abs(y))


@pytest.mark.parametrize("cls", ["CountSketch", "CountSketchU32"])
def test_countsketch_decode_equals_jax(cls):
    sk, rk = getattr(port, cls)(width=64, seed=2), getattr(ref, cls)(
        width=64, seed=2)
    v = _vecs(2)[1]
    s = sk.sketch(v)
    _equal(s, rk.sketch(_jax(v)))
    keys = np.concatenate([v.indices[:40], np.arange(5_000, 5_010)])
    assert np.array_equal(sk.decode(s, keys), rk.decode(s, keys))


@pytest.mark.parametrize("overlap", [0.0, 0.05, 0.5, 1.0])
def test_exact_inner_products_and_bounds_equal_jax(overlap):
    a, b = sparse_pair(np.random.default_rng(9), n=2_000, nnz=120,
                       overlap=overlap)
    ja, jb = _jax(a), _jax(b)
    assert port.inner(a, b) == ref.inner(ja, jb)
    assert port.inner_fast(a, b) == ref.inner_fast(ja, jb)
    assert port.intersection_norms(a, b) == ref.intersection_norms(ja, jb)
    assert port.intersection_norms(a, b)[0] == round(overlap * 120)
    for eps in (1.0, 0.1):
        assert port.theorem2_bound(a, b, eps) == ref.theorem2_bound(ja, jb,
                                                                    eps)
        assert port.fact1_bound(a, b, eps) == ref.fact1_bound(ja, jb, eps)
    assert port.theorem2_bound(a, b) <= port.fact1_bound(a, b)
    assert np.array_equal(a.densify(), ja.densify())
    assert np.array_equal(port.SparseVec.from_dense(a.densify()).values,
                          a.values)


@pytest.mark.parametrize("seed", [0, 7])
def test_hash_coefficients_rounding_and_bruteforce_equal_jax(seed):
    """Equal seeds give equal coefficients (the JL ``_coeffs``, the
    CountSketch bucket and sign coefficients, MinHash's and KMV's ``c1``,
    ``c2``), hashes, rounding and brute-force WeightedMinHash sketches."""
    _equal(port.AffineHashFamily.create(16, seed),
           ref.AffineHashFamily.create(16, seed))
    for method, fields in (("jl", ["_coeffs"]),
                           ("cs", ["_bucket_coeffs", "_sign_coeffs"])):
        sk, rk = port.make(method, 100, seed), ref.make(method, 100, seed)
        for f in fields:
            assert np.array_equal(getattr(sk, f), getattr(rk, f))
    for method in ("mh", "kmv"):
        _equal(port.make(method, 100, seed)._hash,
               ref.make(method, 100, seed)._hash)
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2 ** 40, size=30)
    fam = port.AffineHashFamily.create(8, seed)
    u = fam.hash_unit(x)
    assert np.array_equal(u, ref.AffineHashFamily.create(8, seed).hash_unit(x))
    assert u.min() >= 0.0 and u.max() < 1.0
    z = rng.normal(size=40)
    z /= np.linalg.norm(z)
    for L in (1_000, 10 ** 7):
        k = port.round_counts(z, L)
        assert np.array_equal(port.rounded_values(z, k, L),
                              ref.rounded_values(z, k, L))
        r = port.round_unit(z, L)
        assert np.array_equal(r, ref.round_unit(z, L))
        assert abs(np.linalg.norm(r) - 1.0) <= 1e-12
    v = port.SparseVec.from_pairs(rng.choice(1_000, 40, replace=False),
                                  rng.normal(size=40), 1_000)
    sk = port.WeightedMinHash(m=32, seed=seed, L=1_000)
    brute = port.sketch_bruteforce(sk, v)
    _equal(brute, ref.sketch_bruteforce(
        ref.WeightedMinHash(m=32, seed=seed, L=1_000), _jax(v)))
    _equal(brute, sk.sketch(v))


def _numbers(text):
    return [re.findall(r"-?\d+(?:\.\d+)?", line)
            for line in text.splitlines()]


def test_quickstart_prints_the_jax_numbers():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = {}
    for name in ("quickstart.py", "quickstart_torch.py"):
        run = subprocess.run([sys.executable, str(ROOT / "examples" / name)],
                             env=env, capture_output=True, text=True,
                             timeout=300)
        assert run.returncode == 0, run.stderr
        out[name] = run.stdout
    assert "TPU" not in out["quickstart_torch.py"]
    got, want = (_numbers(out[n]) for n in ("quickstart_torch.py",
                                             "quickstart.py"))
    assert len(got) == len(want) >= 10
    assert got == want
