"""The port's plain fused-fields estimate against the JAX package's
``estimate_fields_pallas`` (interpret mode on the CPU) on identical rows,
its pad guards, the m~ norm epilogue, and its order-fixed sums."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.ingest import sketch_batch as jax_sketch_batch
from repro.data.synthetic import sparse_pair
from repro.kernels import ops as jax_ops
from repro.kernels.estimate import estimate_fields_pallas
from repro_torch.kernels import estimate as port_est
from repro_torch.kernels import ops

# small shapes: one intra-op thread per test process, so that parallel
# test workers do not oversubscribe the cores
torch.set_num_threads(1)

QMAP = (0, 1, 0, 2, 0, 1)
CMAP = (0, 0, 1, 0, 2, 1)
M = 128


def _rows(seed, Q=4, P=21, m=M):
    """[3, Q, m] query and [3, P, m] corpus ICWS rows sketched by the JAX
    package from overlapping sparse vectors (the serving regime), with
    pad sentinels: a padded query row (-1) and spare corpus rows (-2)."""
    rng = np.random.default_rng(seed)
    vecs = [v for _ in range((3 * (Q + P) + 1) // 2)
            for v in sparse_pair(rng, n=600, nnz=80, overlap=0.5)]
    fp, val, norm, _ = (np.array(x) for x in
                        jax_sketch_batch(vecs[:3 * (Q + P)], m=m, seed=seed))
    fq, vq, nq = (x[:3 * Q].reshape((3, Q) + x.shape[1:])
                  for x in (fp, val, norm))
    fc, vc, nc = (x[3 * Q:].reshape((3, P) + x.shape[1:])
                  for x in (fp, val, norm))
    fq[:, -1], vq[:, -1], nq[:, -1] = -1, 0.0, 0.0
    fc[:, -3:], vc[:, -3:], nc[:, -3:] = -2, 0.0, 0.0
    return [np.ascontiguousarray(x) for x in (fq, vq, nq, fc, vc, nc)]


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_partials_match_jax_kernel(seed):
    fq, vq, _, fc, vc, _ = _rows(seed)
    cnt_j, sw_j = (np.asarray(x) for x in estimate_fields_pallas(
        *(jnp.asarray(a) for a in (fq, vq, fc, vc)), qmap=QMAP, cmap=CMAP,
        interpret=True))
    cnt, sw = (x.numpy() for x in ops.estimate_partials_fields(
        *(torch.from_numpy(a) for a in (fq, vq, fc, vc)), qmap=QMAP,
        cmap=CMAP))
    assert cnt.shape == (6, fq.shape[1], fc.shape[1])
    assert cnt.sum() > 0, "rows must collide for the check to bite"
    np.testing.assert_array_equal(cnt, cnt_j)
    # both sum the same f32 terms in different orders
    np.testing.assert_allclose(sw, sw_j, rtol=1e-5)


def test_pads_are_inert():
    fq, vq, _, fc, vc, _ = _rows(2)
    cnt, sw = ops.estimate_partials_fields(
        *(torch.from_numpy(a) for a in (fq, vq, fc, vc)), qmap=QMAP, cmap=CMAP)
    assert torch.all(cnt[:, -1] == 0) and torch.all(sw[:, -1] == 0)
    assert torch.all(cnt[:, :, -3:] == 0) and torch.all(sw[:, :, -3:] == 0)
    # query pads (-1) never match each other either
    neg = np.full_like(fq, -1)
    cnt, _ = ops.estimate_partials_fields(
        torch.from_numpy(neg), torch.from_numpy(vq),
        torch.from_numpy(np.full_like(fc, -1)), torch.from_numpy(vc),
        qmap=QMAP, cmap=CMAP)
    assert torch.all(cnt == 0)


def test_norm_epilogue_matches_jax():
    fq, vq, nq, fc, vc, nc = _rows(3)
    est_j = np.asarray(jax_ops.icws_estimate_fields(
        *(jnp.asarray(a) for a in (fq, vq, nq, fc, vc, nc)), qmap=QMAP,
        cmap=CMAP))
    est = ops.icws_estimate_fields(
        *(torch.from_numpy(a) for a in (fq, vq, nq, fc, vc, nc)), qmap=QMAP,
        cmap=CMAP).numpy()
    assert est.dtype == np.float32 and est.shape == est_j.shape
    assert np.all(est[:, -1] == 0) and np.all(est[:, :, -3:] == 0)
    # zero-norm guard: the pad rows' estimates are exactly zero on both sides
    np.testing.assert_array_equal(est == 0, est_j == 0)
    scale = 1e-5 * np.abs(est_j).max()
    np.testing.assert_allclose(est, est_j, rtol=1e-5, atol=scale)


def test_sums_do_not_depend_on_batch_or_chunking(monkeypatch):
    """Each (q, p) sum runs over t in one fixed order: a query alone, a
    corpus slice, a strided view and a chunked run give the same bits."""
    fq, vq, _, fc, vc, _ = (torch.from_numpy(a) for a in _rows(4))
    cnt, sw = ops.estimate_partials_fields(fq, vq, fc, vc, qmap=QMAP,
                                           cmap=CMAP)
    for q in range(fq.shape[1]):
        c1, s1 = ops.estimate_partials_fields(
            fq[:, q:q + 1], vq[:, q:q + 1], fc, vc, qmap=QMAP, cmap=CMAP)
        assert torch.equal(c1[:, 0], cnt[:, q]) and torch.equal(s1[:, 0], sw[:, q])
    # a [3, cap, m] buffer sliced to rows [5, 17) is passed as a strided view
    c2, s2 = ops.estimate_partials_fields(fq, vq, fc[:, 5:17], vc[:, 5:17],
                                          qmap=QMAP, cmap=CMAP)
    assert torch.equal(c2, cnt[:, :, 5:17]) and torch.equal(s2, sw[:, :, 5:17])
    monkeypatch.setattr(port_est, "_PLAIN_ROWS", 4)
    c3, s3 = ops.estimate_partials_fields(fq, vq, fc, vc, qmap=QMAP, cmap=CMAP)
    assert torch.equal(c3, cnt) and torch.equal(s3, sw)


def test_field_map_and_device_checks():
    fq, vq, _, fc, vc, _ = (torch.from_numpy(a) for a in _rows(5, Q=2, P=3))
    with pytest.raises(ValueError, match="out of range"):
        ops.estimate_partials_fields(fq, vq, fc, vc, qmap=(3,), cmap=(0,))
    with pytest.raises(ValueError, match="mismatch"):
        ops.estimate_partials_fields(fq, vq, fc, vc, qmap=(0, 1), cmap=(0,))
    with pytest.raises(ValueError, match="CUDA tensors"):
        port_est.estimate_fields_cuda(fq, vq, fc, vc, qmap=QMAP, cmap=CMAP)

