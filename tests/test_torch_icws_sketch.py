"""The port's plain ICWS sketch against the JAX package's ``ops.icws_sketch``
(the Pallas kernel, in interpret mode on the CPU) on identical padded
batches, plus the padding copy and the device-routing contract."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.types import SparseVec as JaxSparseVec
from repro.data.ingest import pad_sparse_batch as jax_pad
from repro.data.synthetic import sparse_pair
from repro.kernels import ops as jax_ops
from repro_torch.core.types import SparseVec
from repro_torch.data.ingest import pad_sparse_batch
from repro_torch.kernels import icws_sketch as port_sketch
from repro_torch.kernels import ops

# small shapes: one intra-op thread per test process, so that parallel
# test workers do not oversubscribe the cores
torch.set_num_threads(1)

M = 128


def _vectors(seed, count=6, nnz=150):
    rng = np.random.default_rng(seed)
    vecs = []
    for _ in range(count // 2):
        a, b = sparse_pair(rng, n=4000, nnz=nnz, overlap=0.4)
        vecs += [a, b]
    # keys past 2^31 fold into negative int32s; a single-entry row too
    wide = JaxSparseVec.from_pairs(
        np.array([5, 2 ** 31 + 3, 2 ** 32 - 1, 2 ** 33 + 9]),
        np.array([1.5, -2.0, 0.25, 3.0]), 2 ** 34)
    one = JaxSparseVec.from_pairs(np.array([42]), np.array([-7.0]), 100)
    return vecs + [wide, one]


def _port_vec(v):
    return SparseVec(indices=v.indices, values=v.values, n=v.n)


def _sketch_both(vecs, m=M, seed=3):
    w, keys, vals, _ = jax_pad(vecs)
    jax_out = [np.asarray(x) for x in jax_ops.icws_sketch(
        jnp.asarray(w), jnp.asarray(keys), jnp.asarray(vals), m=m, seed=seed)]
    port_out = [x.numpy() for x in ops.icws_sketch(
        torch.from_numpy(w), torch.from_numpy(keys), torch.from_numpy(vals),
        m=m, seed=seed)]
    return jax_out, port_out


def test_pad_sparse_batch_is_the_jax_padding_bit_for_bit():
    vecs = _vectors(1) + [JaxSparseVec.from_pairs([], [], 10)]
    for got, want in zip(pad_sparse_batch([_port_vec(v) for v in vecs]),
                         jax_pad(vecs)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 11])
def test_plain_sketch_matches_jax_kernel(seed):
    (fp_j, val_j, amin_j, key_j), (fp, val, amin, key) = _sketch_both(
        _vectors(seed), seed=seed)
    agree = fp == fp_j
    # log/exp may differ in the last ulp and flip a floor or an argmin
    assert agree.mean() >= 0.99, agree.mean()
    np.testing.assert_allclose(val[agree], val_j[agree], rtol=1e-5)
    np.testing.assert_array_equal(key[agree], key_j[agree])
    # amin = c / (exp(r (lvl - beta)) exp(r)) carries a last-ulp difference
    # of r multiplied by |r (lvl - beta)|; it only marks empty rows
    np.testing.assert_allclose(amin[agree], amin_j[agree], rtol=1e-3)


def test_empty_rows_give_sentinels():
    vecs = [_vectors(2)[0], JaxSparseVec.from_pairs([], [], 10)]
    (fp_j, val_j, _, key_j), (fp, val, amin, key) = _sketch_both(vecs)
    assert np.all(fp[1] == -1) and np.all(val[1] == 0) and np.all(key[1] == 0)
    assert np.all(amin[1] >= port_sketch.BIG)
    np.testing.assert_array_equal(fp[1], fp_j[1])
    assert np.all(fp[0] >= 0)


def test_rows_are_independent_of_batch_and_chunking(monkeypatch):
    """A row's sketch does not depend on its neighbours or on how many rows
    the plain version holds at once (the kernel's launch-shape rule)."""
    vecs = [_port_vec(v) for v in _vectors(5)]
    w, keys, vals, _ = pad_sparse_batch(vecs)
    args = [torch.from_numpy(a) for a in (w, keys, vals)]
    full = ops.icws_sketch(*args, m=M, seed=1)
    monkeypatch.setattr(port_sketch, "_PLAIN_CHUNK", 1)
    for b in (0, 3, len(vecs) - 1):
        one = ops.icws_sketch(*(a[b:b + 1] for a in args), m=M, seed=1)
        for x, y in zip(one, full):
            assert torch.equal(x[0], y[b])


def test_group_size_fills_the_card_within_limits():
    """Single-table ingest (B = 3) takes half a block per (row, t) pair, a
    query micro-batch (B = 48) 16 threads; never more threads than
    non-zeros or than half a block, never fewer than one."""
    assert port_sketch._group_size(3, 512, 4096) == 128
    assert port_sketch._group_size(3, 512, 1024) == 128
    assert port_sketch._group_size(48, 512, 4096) == 16
    assert port_sketch._group_size(3, 512, 100) == 64
    assert port_sketch._group_size(3, 512, 1) == 1
    assert port_sketch._group_size(10 ** 6, 512, 4096) == 1
    for B in (1, 3, 48, 1000):
        for N in (1, 5, 100, 1024, 10_240):
            S = port_sketch._group_size(B, 512, N)
            assert 1 <= S <= min(max(N, 1), 128) and S & (S - 1) == 0


def test_wrappers_route_by_device_and_refuse_cpu_in_the_kernel():
    w = torch.ones((1, 4))
    k = torch.arange(4, dtype=torch.int32)[None]
    with pytest.raises(ValueError, match="CUDA tensors"):
        port_sketch.icws_sketch_cuda(w, k, w, m=8, seed=0)
    with pytest.raises(TypeError):
        ops.icws_sketch(w, k.float(), w, m=8)
    before = port_sketch.icws_sketch_cuda.launches
    ops.icws_sketch(w, k, w, m=8)
    assert port_sketch.icws_sketch_cuda.launches == before

