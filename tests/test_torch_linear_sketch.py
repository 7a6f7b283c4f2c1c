"""The port's linear sketches (CountSketch and JL of a padded sparse batch)
against the JAX package: the plain PyTorch versions agree with the Pallas
kernels (interpret mode) and the jnp references to f32 tolerance, and the
port's own fixed-order sums give a row the same bits at any batch size and
padded width.

Tolerance: ``rtol = 1e-4, atol = 1e-4 * max|ref|`` as the JAX package's
own kernel-vs-reference tests take it (``tests/test_families.py``): every
term is an exact ``+-val``, and the sums only differ in order (the MXU's
blocked order against the port's ascending n)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.ingest import pad_linear_batch as jax_pad_linear_batch
from repro.kernels import ref
from repro.kernels.countsketch import countsketch_sparse_pallas
from repro.kernels.jl_sketch import jl_sketch_pallas
from repro_torch.core.types import SparseVec
from repro_torch.data.ingest import linear_sketch_batch, pad_linear_batch
from repro_torch.kernels import ops
from repro_torch.kernels.countsketch import _hash, countsketch_sparse_plain
from repro_torch.kernels.jl_sketch import _t_tile, jl_sketch_plain

# small shapes: one intra-op thread per test process, so that parallel
# test workers do not oversubscribe the cores
torch.set_num_threads(1)


def _batch(seed, B=5, N=300, pad_from=240):
    """Keys over the whole int32 range (negative ones included), normal
    values, zero-valued padding past ``pad_from`` and one empty row."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(-2 ** 31, 2 ** 31 - 1, (B, N)).astype(np.int32)
    vals = rng.normal(size=(B, N)).astype(np.float32)
    vals[:, pad_from:] = 0.0
    vals[1] = 0.0                                        # an empty row
    keys[2, :40] = keys[0, :40]                          # shared keys
    assert (keys < 0).any()
    return keys, vals


def _close(got, want):
    want = np.asarray(want)
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)


def _one_bucket_keys(count, *, width, seed):
    """``count`` distinct int32 keys whose rep-0 bucket (of ``width``, under
    ``seed``) is key 0's, found with the port's own hash."""
    k = torch.arange(2 * count * width, dtype=torch.int64)
    bucket, _ = _hash(k, torch.zeros(1, dtype=torch.int64), width=width,
                      seed=seed)
    return k[bucket == bucket[0]][:count].to(torch.int32).numpy()


@pytest.mark.parametrize("seed, width, reps, one_bucket", [
    (0, 77, 5, False), (1, 153, 5, False), (2, 19, 4, False), (3, 1, 1, False),
    (4, 153, 5, True)])
def test_countsketch_plain_matches_pallas_and_ref(seed, width, reps,
                                                  one_bucket):
    """With ``one_bucket``, row 0's 240 keys all land in one bucket of rep 0
    (the kernel's worst case: one thread adds every term)."""
    keys, vals = _batch(seed)
    if one_bucket:
        keys[0, :240] = _one_bucket_keys(240, width=width, seed=seed)
        bucket, _ = _hash(torch.from_numpy(keys[0, :240]).long() & 0xFFFFFFFF,
                          torch.zeros(1, dtype=torch.int64), width=width,
                          seed=seed)
        assert len(set(bucket.tolist())) == 1
    got = countsketch_sparse_plain(torch.from_numpy(keys),
                                   torch.from_numpy(vals), width=width,
                                   reps=reps, seed=seed).numpy()
    assert got.shape == (5, reps, width) and got.dtype == np.float32
    jk, jv = jnp.asarray(keys), jnp.asarray(vals)
    _close(got, countsketch_sparse_pallas(jk, jv, width=width, reps=reps,
                                          seed=seed, interpret=True))
    _close(got, ref.countsketch_sparse_ref(jk, jv, width, reps, seed))
    assert np.all(got[1] == 0.0)
    if one_bucket:
        assert np.count_nonzero(got[0, 0]) == 1


@pytest.mark.parametrize("seed, m", [(0, 200), (1, 769), (2, 1)])
def test_jl_plain_matches_pallas_and_ref(seed, m):
    keys, vals = _batch(seed)
    got = jl_sketch_plain(torch.from_numpy(keys), torch.from_numpy(vals),
                          m=m, seed=seed).numpy()
    assert got.shape == (5, m) and got.dtype == np.float32
    jk, jv = jnp.asarray(keys), jnp.asarray(vals)
    _close(got, jl_sketch_pallas(jk, jv, m=m, seed=seed, interpret=True))
    _close(got, ref.jl_sketch_ref(jk, jv, m, seed))
    assert np.all(got[1] == 0.0)


@pytest.mark.parametrize("B, m, tile", [(3, 769, 8), (1, 769, 8),
                                         (48, 769, 16), (48, 97, 16),
                                         (6, 769, 16), (5, 769, 8),
                                         (3, 1, 8)])
def test_jl_sample_tile_fills_the_card(B, m, tile):
    """16 samples a block where that launch gives each of the 132 SMs two
    blocks, else 8."""
    assert _t_tile(B, m) == tile
    assert (B * -(-m // 16) >= 264) == (tile == 16)


def _sketches(keys, vals):
    k, v = torch.from_numpy(keys), torch.from_numpy(vals)
    return (ops.countsketch_sparse(k, v, width=153, reps=5, seed=9),
            ops.jl_sketch(k, v, m=97, seed=9))


def test_a_row_gets_the_same_bits_alone_in_a_batch_and_padded():
    """The sums run over ascending n, so neither the batch size nor the
    padded width changes a bit: batched and sequential queries agree."""
    keys, vals = _batch(4, B=5, N=256, pad_from=200)
    whole = _sketches(keys, vals)
    wide_k = np.zeros((5, 768), np.int32)
    wide_v = np.zeros((5, 768), np.float32)
    wide_k[:, :256], wide_v[:, :256] = keys, vals
    wide = _sketches(wide_k, wide_v)
    for b in range(5):
        alone = _sketches(keys[b:b + 1, :200], vals[b:b + 1, :200])
        for x, y, z in zip(whole, wide, alone):
            assert torch.equal(x[b], y[b]) and torch.equal(x[b], z[0])


def _vectors(seed):
    rng = np.random.default_rng(seed)
    vecs = []
    for n in (0, 1, 250, 600):
        idx = rng.choice(2 ** 34, size=n, replace=False)
        vecs.append(SparseVec.from_pairs(idx, rng.normal(size=n) * 40.0,
                                         2 ** 34))
    return vecs


def test_pad_linear_batch_is_bit_for_bit_the_jax_padding():
    from repro.core.types import SparseVec as JaxSparseVec
    vecs = _vectors(5)
    got = pad_linear_batch(vecs)
    want = jax_pad_linear_batch([JaxSparseVec(indices=v.indices,
                                              values=v.values, n=v.n)
                                 for v in vecs])
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (4, 768) and np.all(got[1][0] == 0)


@pytest.mark.parametrize("method, width, reps", [("cs", 21, 5), ("jl", 64, 1)])
def test_linear_sketch_batch_matches_the_jax_family(method, width, reps):
    """One launch per batch, raw (un-normalized) values, as the JAX
    family's ``sketch_rows`` does."""
    from repro.core.types import SparseVec as JaxSparseVec
    from repro.data.families import CSFamily, JLFamily
    vecs = _vectors(6)
    got = linear_sketch_batch(vecs, method=method, width=width, reps=reps,
                              seed=3, device="cpu")
    fam = (CSFamily(width=width, reps=reps, seed=3) if method == "cs"
           else JLFamily(m=width, seed=3))
    (want,) = fam.sketch_rows([JaxSparseVec(indices=v.indices,
                                            values=v.values, n=v.n)
                               for v in vecs])
    assert got.shape == (4, reps, width)
    _close(got.numpy(), want)
    assert np.all(got[0].numpy() == 0)
    with pytest.raises(ValueError, match="one rep"):
        linear_sketch_batch(vecs, method="jl", width=8, reps=2, device="cpu")
    with pytest.raises(ValueError, match="unknown linear sketch"):
        linear_sketch_batch(vecs, method="ts", width=8, device="cpu")


def test_wrappers_reject_bad_inputs_and_the_cpu_in_the_kernel():
    from repro_torch.kernels.countsketch import countsketch_sparse_cuda
    from repro_torch.kernels.jl_sketch import jl_sketch_cuda
    k = torch.zeros((2, 8), dtype=torch.int32)
    v = torch.zeros((2, 8), dtype=torch.float32)
    with pytest.raises(TypeError):
        ops.countsketch_sparse(k.long(), v, width=4)
    with pytest.raises(ValueError, match="shape"):
        ops.jl_sketch(k, v[:, :4], m=4)
    with pytest.raises(ValueError, match=">= 1"):
        ops.countsketch_sparse(k, v, width=0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        countsketch_sparse_cuda(k, v, width=4, reps=5, seed=0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        jl_sketch_cuda(k, v, m=4, seed=0)
