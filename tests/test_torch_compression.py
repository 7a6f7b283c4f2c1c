"""The port's gradient compression (``repro_torch.optim.compression``) and
dense CountSketch (B14's plain version, ``ops.countsketch``) against the
JAX package.

Tolerances: a table agrees with JAX to rtol/atol 1e-5, the JAX package's
own (``tests/test_substrate.py``): every term is an exact ``+-x`` and the
sums only differ in order (the MXU's blocked one against the port's
chunked t order).  The decode of one f32 table is bit for bit: a gather,
an exact sign product and the median of five.  One update step agrees
within 1e-5 except on coordinates whose ``|est|`` lies within 1e-5
relative of ``tau`` or of the k-th largest ``|est|``, where the two norms'
summation orders may put a coordinate on either side of the mask."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.countsketch import countsketch_pallas
from repro.optim import compression as jax_comp
from repro_torch.kernels import countsketch as port_cs
from repro_torch.kernels import ops
from repro_torch.kernels.countsketch import (DENSE_CHUNK,
                                             countsketch_dense_cuda,
                                             countsketch_dense_plain,
                                             countsketch_sparse_plain)
from repro_torch.optim import compression as comp

# small shapes: one intra-op thread per test process, so that parallel
# test workers do not oversubscribe the cores
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _configs(**kw):
    return jax_comp.CompressionConfig(**kw), comp.CompressionConfig(**kw)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.int32)


def test_config_matches_jax_field_for_field():
    assert dataclasses.asdict(comp.CompressionConfig()) == \
        dataclasses.asdict(jax_comp.CompressionConfig())
    assert comp.compression_ratio(4096, comp.CompressionConfig(width=512)) \
        == jax_comp.compression_ratio(4096,
                                      jax_comp.CompressionConfig(width=512))
    assert comp.compressed_psum is comp.compressed_update


@pytest.mark.parametrize("use_kernel", [False, True])
def test_compress_matches_jax_on_both_paths(use_kernel):
    """Each port path against each JAX path (JAX's kernel path runs the
    interpret-mode Pallas kernel)."""
    g = np.random.default_rng(7).normal(size=600).astype(np.float32)
    _, cfg = _configs(width=64, reps=5, seed=11, use_kernel=use_kernel)
    got = comp.compress(torch.from_numpy(g), cfg).numpy()
    assert got.shape == (5, 64) and got.dtype == np.float32
    for jax_kernel in (False, True):
        jcfg = jax_comp.CompressionConfig(width=64, reps=5, seed=11,
                                          use_kernel=jax_kernel)
        want = np.asarray(jax_comp.compress(jnp.asarray(g), jcfg))
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("T, chunk, offset, width", [
    (1000, 256, 0, 37),                 # four chunks, the last ragged
    (1000, 96, 7, 64),
    (4099, 1024, 2 ** 32 - 300, 64),    # positions wrap past 2^32
])
def test_dense_plain_across_chunks_matches_jax(monkeypatch, T, chunk, offset,
                                              width):
    monkeypatch.setattr(port_cs, "DENSE_CHUNK", chunk)
    x = np.random.default_rng(T + chunk).normal(size=T).astype(np.float32)
    got = countsketch_dense_plain(torch.from_numpy(x), width=width, reps=3,
                                  seed=5, offset=offset).numpy()
    jx = jnp.asarray(x)
    np.testing.assert_allclose(
        got, np.asarray(ref.countsketch_ref(jx, width, 3, 5, offset=offset)),
        **TOL)
    if T > 2000:
        np.testing.assert_allclose(got, np.asarray(countsketch_pallas(
            jx, width=width, reps=3, seed=5, offset=offset, interpret=True)),
            **TOL)


@pytest.mark.parametrize("T, chunk, offset", [
    (700, DENSE_CHUNK, 12345),
    (512, 512, 2 ** 31 - 200),          # T = L; keys cross the i32 sign
    (300, 300, 2 ** 32 - 100),          # the u32 position wraps to 0
])
def test_dense_plain_equals_sparse_plain_bitwise(monkeypatch, T, chunk,
                                                 offset):
    """For T <= L the dense sketch at offset o is B6's sketch of keys
    o + arange(T) (their i32 bits) and values x, bit for bit: both add
    each bucket's terms in t order from +0."""
    monkeypatch.setattr(port_cs, "DENSE_CHUNK", chunk)
    rng = np.random.default_rng(T)
    x = rng.normal(size=T).astype(np.float32)
    x[rng.random(T) < 0.2] = 0.0
    keys = ((offset + np.arange(T)) % 2 ** 32).astype(np.uint32) \
        .view(np.int32)
    dense = countsketch_dense_plain(torch.from_numpy(x), width=53, reps=4,
                                    seed=3, offset=offset)
    sparse = countsketch_sparse_plain(torch.from_numpy(keys[None]),
                                      torch.from_numpy(x[None]), width=53,
                                      reps=4, seed=3)[0]
    np.testing.assert_array_equal(_bits(dense), _bits(sparse))


@pytest.mark.parametrize("width, reps", [(1, 1), (1, 5), (153, 1),
                                         (4096, 5)])
def test_dense_plain_equals_sparse_plain_at_every_width(monkeypatch, width,
                                                        reps):
    """The widths and rep counts of the card's B14 cases (one bucket: every
    term in one run; W = 4,096: CompressionConfig's), at T = L with the
    positions wrapping past 2^32: the dense plain version is B6's plain
    version on keys o + arange(T), bit for bit."""
    T, offset = 400, 2 ** 32 - 150
    monkeypatch.setattr(port_cs, "DENSE_CHUNK", T)
    x = np.random.default_rng(width + reps).standard_t(2, T).astype(np.float32)
    keys = ((offset + np.arange(T)) % 2 ** 32).astype(np.uint32) \
        .view(np.int32)
    dense = countsketch_dense_plain(torch.from_numpy(x), width=width,
                                    reps=reps, seed=17, offset=offset)
    sparse = countsketch_sparse_plain(torch.from_numpy(keys[None]),
                                      torch.from_numpy(x[None]), width=width,
                                      reps=reps, seed=17)[0]
    assert dense.shape == (reps, width)
    np.testing.assert_array_equal(_bits(dense), _bits(sparse))


def test_dense_sketch_is_the_sum_of_its_chunks_in_order(monkeypatch):
    """The partials of each chunk, added in chunk order, give the table."""
    monkeypatch.setattr(port_cs, "DENSE_CHUNK", 300)
    x = np.random.default_rng(3).normal(size=900).astype(np.float32)
    whole = countsketch_dense_plain(torch.from_numpy(x), width=29, reps=2,
                                    seed=1)
    acc = torch.zeros(2, 29)
    for lo in range(0, 900, 300):
        acc += countsketch_dense_plain(torch.from_numpy(x[lo:lo + 300]),
                                       width=29, reps=2, seed=1, offset=lo)
    np.testing.assert_array_equal(_bits(whole), _bits(acc))


def test_ops_countsketch_routes_cpu_tensors_to_the_plain_version():
    x = torch.from_numpy(np.random.default_rng(1).normal(size=300)
                         .astype(np.float32))
    got = ops.countsketch(x, width=32, reps=3, seed=4, offset=9)
    np.testing.assert_array_equal(_bits(got), _bits(countsketch_dense_plain(
        x, width=32, reps=3, seed=4, offset=9)))
    with pytest.raises(ValueError, match="CUDA tensor"):
        countsketch_dense_cuda(x, width=32, reps=3, seed=4)
    with pytest.raises(TypeError, match=r"\[T\] f32"):
        ops.countsketch(x[None], width=32)
    assert torch.equal(ops.countsketch(x[:0], width=8, reps=2),
                       torch.zeros(2, 8))


@pytest.mark.parametrize("reps", [5, 4])
def test_decompress_matches_jax_bitwise(reps):
    """The same f32 table decodes to the same bits (an even rep count takes
    ``jnp.median``'s mean of the two middle values)."""
    rng = np.random.default_rng(reps)
    table = rng.normal(size=(reps, 128)).astype(np.float32)
    jcfg, cfg = _configs(width=128, reps=reps, seed=11)
    got = comp.decompress(torch.from_numpy(table), 1500, cfg).numpy()
    want = np.asarray(jax_comp.decompress(jnp.asarray(table), 1500, jcfg))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_ef_decode_matches_jax():
    rng = np.random.default_rng(5)
    g = np.zeros(2048, np.float32)
    g[rng.choice(2048, 40, replace=False)] = rng.standard_t(2, 40) * 4
    g += 0.05 * rng.normal(size=2048).astype(np.float32)
    jcfg, cfg = _configs(width=256, reps=5, seed=2)
    tab = comp.compress(torch.from_numpy(g), cfg)
    norm = float(np.linalg.norm(g))
    for mult in (2.0, 0.5):
        got = comp.ef_decode(tab, 2048, cfg, torch.tensor(norm),
                             noise_mult=mult).numpy()
        want = np.asarray(jax_comp.ef_decode(
            jnp.asarray(tab.numpy()), 2048, jcfg, jnp.float32(norm),
            noise_mult=mult))
        np.testing.assert_allclose(got, want, **TOL)
        assert np.count_nonzero(got) >= 2


@pytest.mark.parametrize("seed", [0, 1])
def test_one_update_step_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = 4096
    target = np.zeros(n, np.float32)
    target[rng.choice(n, 128, replace=False)] = rng.standard_t(2, 128) * 3
    x = 0.1 * rng.normal(size=n).astype(np.float32)
    residual = 0.05 * rng.normal(size=n).astype(np.float32)
    grad = x - target
    jcfg, cfg = _configs(width=256, reps=5, seed=2)
    d_j, r_j = jax_comp.compressed_update(jnp.asarray(grad),
                                          jnp.asarray(residual), None, jcfg,
                                          lr=0.3)
    tg, tr = torch.from_numpy(grad), torch.from_numpy(residual)
    d_t, r_t = comp.compressed_update(tg, tr, None, cfg, lr=0.3)
    # coordinates on the edge of the mask may fall either way
    p = tr + 0.3 * tg
    est = comp.decompress(comp.compress(p, cfg), n, cfg).abs()
    tau = float(2.0 * torch.linalg.vector_norm(p) / 16.0)
    kth = float(torch.topk(est, 128).values[-1])
    edge = ((est - tau).abs() <= 1e-5 * tau) | ((est - kth).abs()
                                                <= 1e-5 * kth)
    keep = ~edge.numpy()
    assert keep.sum() >= n - 4
    np.testing.assert_allclose(d_t.numpy()[keep], np.asarray(d_j)[keep],
                               **TOL)
    np.testing.assert_allclose(r_t.numpy()[keep], np.asarray(r_j)[keep],
                               **TOL)
    assert np.count_nonzero(d_t.numpy()) >= 128


def test_named_axis_is_not_ported():
    """A named axis needs a registered process group: without
    ``torch.distributed`` it raises instead of running as one replica
    (``tests/test_torch_replica_axis.py`` runs the registered forms)."""
    cfg = comp.CompressionConfig(width=64)
    with pytest.raises(RuntimeError, match="not initialised"):
        comp.compressed_update(torch.zeros(256), torch.zeros(256), "data",
                               cfg, lr=0.1)


def _quadratic(target, cfg, steps, *, use_kernel=False):
    x = torch.zeros_like(target)
    residual = torch.zeros_like(target)
    cfg = dataclasses.replace(cfg, use_kernel=use_kernel)
    for _ in range(steps):
        delta, residual = comp.compressed_update(x - target, residual, None,
                                                 cfg, lr=0.3)
        x = x - delta
    return float(torch.linalg.vector_norm(x - target)
                 / torch.linalg.vector_norm(target))


def _sparse_target(n=4096):
    rng = np.random.default_rng(1)
    t0 = np.zeros(n)
    t0[rng.choice(n, 128, replace=False)] = rng.standard_t(2, size=128) * 3
    return torch.from_numpy(t0.astype(np.float32))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_error_feedback_converges_on_quadratic_sparse(use_kernel):
    """EF-compressed SGD reaches the optimum of a quadratic with a heavy-
    tailed sparse target (``test_substrate.py``'s law)."""
    cfg = comp.CompressionConfig(width=256, reps=5, seed=2)
    assert _quadratic(_sparse_target(), cfg, 120,
                      use_kernel=use_kernel) < 1e-3


def test_error_feedback_converges_on_quadratic_dense():
    """The top-k fallback with exact values: a dense Gaussian target (no
    heavy hitters) converges too, more slowly."""
    cfg = comp.CompressionConfig(width=256, reps=5, seed=3)
    target = torch.from_numpy(np.random.default_rng(2).normal(size=2048)
                              .astype(np.float32))
    assert _quadratic(target, cfg, 400) < 0.05


def test_naive_ef_with_estimated_values_does_not_converge():
    """Subtracting the noisy *estimated* values instead of the exact ones
    stalls or diverges (the failure the exact extraction repairs)."""
    cfg = comp.CompressionConfig(width=256, reps=5, seed=2)
    target = _sparse_target()
    n = target.shape[0]
    x = torch.zeros(n)
    residual = torch.zeros(n)
    for _ in range(200):
        p = residual + 0.3 * (x - target)
        approx = comp.ef_decode(comp.compress(p, cfg), n, cfg,
                                norm_bound=torch.linalg.vector_norm(p))
        residual = p - approx
        x = x - approx
    assert float(torch.linalg.vector_norm(x - target)
                 / torch.linalg.vector_norm(target)) > 0.05
