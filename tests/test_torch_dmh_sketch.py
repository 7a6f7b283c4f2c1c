"""The port's plain DMH sketch against the JAX package's scatter-min lowering
(``dmh_sketch_scatter``) and its Pallas kernel in interpret mode, on
identical padded (replicated) batches; the port's in-sketch replicas
against host-replicated rows; plus the device ingest end to end.

Tolerances: bin occupancy bit for bit (it depends only on ``w > 0`` and
the integer bin hash); fingerprints on at least 99% of slots (``log`` /
``exp`` may differ in the last ulp and flip a floor or a winner, as for
ICWS); argkeys and values equal where the fingerprints are; ``amin`` at
rtol 1e-3 there (it only marks empty rows, as in the ICWS tests)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dmh import dmh_replication as jax_replication
from repro.core.types import SparseVec as JaxSparseVec
from repro.data.ingest import dmh_sketch_batch as jax_dmh_batch
from repro.kernels import ops as jax_ops
from repro.kernels.dmh_sketch import dmh_sketch_pallas, dmh_sketch_scatter
from repro_torch.core.dmh import dmh_replication, replicate_keys
from repro_torch.core.types import SparseVec
from repro_torch.data.ingest import dmh_sketch_batch, pad_sparse_batch
from repro_torch.kernels import dmh_sketch as port_dmh
from repro_torch.kernels import ops
from repro_torch.kernels.common import (BIG, DMH_STREAM_BIN, as_u32,
                                        hash_u32, salt_for)

# small shapes: one intra-op thread per test process, so that parallel
# test workers do not oversubscribe the cores
torch.set_num_threads(1)


def _vectors(seed, count=5):
    """Sparse vectors of varied support (keys past 2^31 fold into negative
    int32 lanes), a single-entry vector and an empty one."""
    rng = np.random.default_rng(seed)
    vecs = []
    for _ in range(count):
        nnz = int(rng.integers(3, 180))
        idx = rng.choice(2 ** 33, size=nnz, replace=False)
        vecs.append(JaxSparseVec.from_pairs(idx, rng.normal(size=nnz), 2 ** 34))
    vecs.append(JaxSparseVec.from_pairs([2 ** 32 - 5], [4.0], 2 ** 34))
    vecs.append(JaxSparseVec.from_pairs([], [], 10))
    return vecs


def _port_vec(v):
    return SparseVec(indices=v.indices, values=v.values, n=v.n)


def _replicated_batch(vecs, m):
    """The padded batch the DMH kernel takes: the ICWS padding, keys
    expanded into ``dmh_replication(m)`` pseudo-keys replica-major."""
    w, keys, vals, _ = pad_sparse_batch([_port_vec(v) for v in vecs],
                                        bucket=64)
    c = dmh_replication(m)
    keys = replicate_keys(keys.view(np.uint32), c).view(np.int32)
    return np.tile(w, (1, c)), keys, np.tile(vals, (1, c))


def _occupied(fp, argkey, m, seed):
    """Origin bins: a live row's bin t holds its own winner iff the bin of
    its argkey is t (a borrowed bin carries another bin's key)."""
    k = torch.from_numpy(np.array(argkey))
    zero = torch.zeros((), dtype=torch.int64)
    bins = (hash_u32(as_u32(k), salt_for(seed, DMH_STREAM_BIN, zero))
            % m).numpy()
    return (bins == np.arange(m)) & (fp >= 0)


def _assert_close(got, want, m, seed):
    fp, val, amin, key = got
    fp_w, val_w, amin_w, key_w = want
    np.testing.assert_array_equal(_occupied(fp, key, m, seed),
                                  _occupied(fp_w, key_w, m, seed))
    np.testing.assert_array_equal(fp < 0, fp_w < 0)        # empty rows
    agree = fp == fp_w
    assert agree.mean() >= 0.99, agree.mean()
    np.testing.assert_array_equal(key[agree], key_w[agree])
    np.testing.assert_array_equal(val[agree], val_w[agree])
    np.testing.assert_allclose(amin[agree], amin_w[agree], rtol=1e-3)


@pytest.mark.parametrize("m, seed", [(48, 0), (128, 5), (200, 9)])
def test_plain_sketch_matches_jax_scatter_and_kernel(m, seed):
    """m in {48, 128, 200} replicates c = 1, 2, 3; one row is empty, keys
    past 2^31 arrive negative, and m = 48 and 200 are not lane multiples
    (the JAX kernel pads its bins to a multiple of 128)."""
    assert dmh_replication(m) == jax_replication(m) == {48: 1, 128: 2,
                                                        200: 3}[m]
    w, keys, vals = _replicated_batch(_vectors(seed), m)
    assert (keys < 0).any()
    got = [x.numpy() for x in ops.dmh_sketch(
        torch.from_numpy(w), torch.from_numpy(keys), torch.from_numpy(vals),
        m=m, seed=seed)]
    args = (jnp.asarray(w), jnp.asarray(keys), jnp.asarray(vals))
    scatter = [np.asarray(x) for x in dmh_sketch_scatter(*args, m=m,
                                                         seed=seed)]
    kernel = [np.asarray(x) for x in dmh_sketch_pallas(
        *args, m=m, seed=seed, bm=128 * -(-m // 128))]
    _assert_close(got, scatter, m, seed)
    _assert_close(got, kernel, m, seed)
    # the empty row: sentinels; a single-entry row: every bin borrows one
    # of its c pseudo-keys' bins
    fp, val, amin, key = got
    assert np.all(fp[-1] == -1) and np.all(val[-1] == 0)
    assert np.all(key[-1] == 0) and np.all(amin[-1] >= BIG)
    assert 1 <= len(set(fp[-2])) <= dmh_replication(m) and fp[-2, 0] >= 0


@pytest.mark.parametrize("pack_vals", [False, True])
@pytest.mark.parametrize("m, seed", [(64, 1), (200, 6), (512, 8)])
def test_replicas_derived_in_the_sketch_equal_host_replicated_rows(
        m, seed, pack_vals):
    """``replicas=c`` on the unreplicated rows (c = 1, 3, 4 at m = 64, 200,
    512) is, bit for bit, the sketch of the rows replicated on the host,
    and agrees with JAX's ``ops.dmh_sketch`` on those rows."""
    c = dmh_replication(m)
    assert c == {64: 1, 200: 3, 512: 4}[m]
    vecs = _vectors(seed)
    w, keys, vals, _ = pad_sparse_batch([_port_vec(v) for v in vecs],
                                        bucket=64)
    rep = _replicated_batch(vecs, m)
    got = [x.numpy() for x in ops.dmh_sketch(
        *(torch.from_numpy(a) for a in (w, keys, vals)), m=m, seed=seed,
        replicas=c, pack_vals=pack_vals)]
    host = [x.numpy() for x in ops.dmh_sketch(
        *(torch.from_numpy(a) for a in rep), m=m, seed=seed,
        pack_vals=pack_vals)]
    for x, y in zip(got, host):
        np.testing.assert_array_equal(x.view(np.int32), y.view(np.int32))
    want = [np.asarray(x) for x in jax_ops.dmh_sketch(
        *(jnp.asarray(a) for a in rep), m=m, seed=seed, pack_vals=pack_vals)]
    _assert_close(got[:4], want[:4], m, seed)


@pytest.mark.parametrize("B", [1, 5])
def test_rows_do_not_depend_on_the_batch(B):
    """A row sketches to the same bits alone (B = 1) or in a batch of 5."""
    m, seed = 128, 2
    w, keys, vals = (torch.from_numpy(a) for a in _replicated_batch(
        _vectors(7), m))
    full = ops.dmh_sketch(w, keys, vals, m=m, seed=seed)
    for lo in range(0, w.shape[0] - B + 1, B):
        part = ops.dmh_sketch(w[lo:lo + B], keys[lo:lo + B], vals[lo:lo + B],
                              m=m, seed=seed)
        for x, y in zip(part, full):
            assert torch.equal(x, y[lo:lo + B])


@pytest.mark.parametrize("m", [64, 200, 512])
def test_dmh_sketch_batch_matches_the_jax_ingest(m):
    vecs = _vectors(3)
    got = [x.numpy() for x in dmh_sketch_batch(
        [_port_vec(v) for v in vecs], m=m, seed=4, device="cpu")]
    want = [np.asarray(x) for x in jax_dmh_batch(vecs, m=m, seed=4)]
    fp, val, norm, key = got
    np.testing.assert_array_equal(norm, want[2])
    _assert_close((fp, val, np.zeros_like(val), key),
                  (want[0], want[1], np.zeros_like(val), want[3]), m, 4)


def test_wrapper_routes_by_device_and_refuses_cpu_in_the_kernel():
    w = torch.ones((1, 4))
    k = torch.arange(4, dtype=torch.int32)[None]
    with pytest.raises(ValueError, match="CUDA tensors"):
        port_dmh.dmh_sketch_cuda(w, k, w, m=8, seed=0)
    with pytest.raises(TypeError):
        ops.dmh_sketch(w, k.float(), w, m=8)
    before = port_dmh.dmh_sketch_cuda.launches
    ops.dmh_sketch(w, k, w, m=8)
    assert port_dmh.dmh_sketch_cuda.launches == before
