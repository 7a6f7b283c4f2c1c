"""The port's linear-family estimate (per-rep sketch dots of every field
pair, then the median over reps) against the JAX package.

Dots: the plain version against ``linear_estimate_fields_pallas``
(interpret mode) and the jnp reference at ``rtol = 1e-4, atol = 1e-4 *
max|ref|`` (``tests/test_families.py``'s tolerance: same f32 products,
other summation order).  Median: on identical dots the port's epilogue is
``jnp.median`` bit for bit, for odd and even rep counts; end to end it
matches ``repro.kernels.ops.linear_estimate_fields`` to the dots'
tolerance."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref
from repro.kernels.estimate import linear_estimate_fields_pallas
from repro_torch.kernels import ops
from repro_torch.kernels.estimate import (linear_estimate_fields_cuda,
                                          linear_estimate_fields_plain)

# small shapes: one intra-op thread per test process, so that parallel
# test workers do not oversubscribe the cores
torch.set_num_threads(1)

QMAP = (0, 1, 0, 2, 0, 1)
CMAP = (0, 0, 1, 0, 2, 1)


def _tables(seed, Q=5, P=11, R=5, W=77):
    rng = np.random.default_rng(seed)
    tq = rng.normal(size=(3, Q, R, W)).astype(np.float32)
    tc = rng.normal(size=(3, P, R, W)).astype(np.float32)
    tc[:, -2:] = 0.0                                     # inert spare rows
    return tq, tc


def _close(got, want):
    want = np.asarray(want)
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("seed, R, W", [(0, 5, 77), (1, 1, 130), (2, 4, 33)])
def test_dots_match_pallas_and_ref(seed, R, W):
    tq, tc = _tables(seed, R=R, W=W)
    got = linear_estimate_fields_plain(torch.from_numpy(tq),
                                       torch.from_numpy(tc), qmap=QMAP,
                                       cmap=CMAP).numpy()
    assert got.shape == (6, R, 5, 11) and got.dtype == np.float32
    jq, jc = jnp.asarray(tq), jnp.asarray(tc)
    _close(got, linear_estimate_fields_pallas(jq, jc, qmap=QMAP, cmap=CMAP,
                                              interpret=True))
    _close(got, ref.linear_estimate_fields_ref(jq, jc, qmap=QMAP, cmap=CMAP))
    assert np.all(got[..., -2:] == 0.0)


@pytest.mark.parametrize("qmap, cmap", [
    ((0, 1, 2, 0, 2, 1, 1), (1, 1, 0, 1, 1, 2, 1)),
    ((2, 0, 1, 1, 0, 2, 0, 1, 2, 2, 1, 0, 0, 1, 2, 0),
     (1, 2, 0, 2, 1, 0, 0, 2, 1, 0, 1, 2, 0, 1, 2, 1))],
    ids=["five-pairs-of-one-field", "sixteen-pairs-unsorted"])
def test_dots_match_pallas_on_uneven_field_maps(qmap, cmap):
    """Maps that the CUDA kernel groups unevenly by corpus field (a group
    of five pairs splits over two blocks; sixteen pairs, cmap unsorted):
    the plain version, which the card tests hold the kernel to bit for
    bit on these maps, against the interpret-mode Pallas kernel."""
    tq, tc = _tables(6, Q=3, P=9, R=2, W=40)
    got = linear_estimate_fields_plain(torch.from_numpy(tq),
                                       torch.from_numpy(tc), qmap=qmap,
                                       cmap=cmap).numpy()
    assert got.shape == (len(qmap), 2, 3, 9)
    _close(got, linear_estimate_fields_pallas(
        jnp.asarray(tq), jnp.asarray(tc), qmap=qmap, cmap=cmap,
        interpret=True))


@pytest.mark.parametrize("R", [5, 4, 2, 1])
def test_median_epilogue_is_jnp_median_bit_for_bit(R):
    rng = np.random.default_rng(R)
    dots = rng.normal(size=(6, R, 4, 9)).astype(np.float32)
    dots[0, :, 0, 0] = 1.5                               # ties across reps
    got = ops._median_reps(torch.from_numpy(dots)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.median(
        jnp.asarray(dots), axis=1)))


@pytest.mark.parametrize("R", [5, 4, 1])
def test_estimates_match_the_jax_op(R):
    tq, tc = _tables(3, R=R, W=40)
    got = ops.linear_estimate_fields(torch.from_numpy(tq),
                                     torch.from_numpy(tc), qmap=QMAP,
                                     cmap=CMAP).numpy()
    want = jax_ops.linear_estimate_fields(jnp.asarray(tq), jnp.asarray(tc),
                                          qmap=QMAP, cmap=CMAP)
    assert got.shape == (6, 5, 11)
    _close(got, want)


def test_dots_do_not_depend_on_the_query_batch_or_a_strided_corpus():
    """A fixed w order per (q, p): one query alone equals its row of a
    batch, and a strided slice of the corpus equals a contiguous copy."""
    tq, tc = (torch.from_numpy(x) for x in _tables(4, Q=6, P=20))
    whole = linear_estimate_fields_plain(tq, tc, qmap=QMAP, cmap=CMAP)
    for q in range(6):
        one = linear_estimate_fields_plain(tq[:, q:q + 1], tc, qmap=QMAP,
                                           cmap=CMAP)
        assert torch.equal(one[:, :, 0], whole[:, :, q])
    sl = tc[:, 3:17]
    assert not sl.is_contiguous()
    assert torch.equal(
        linear_estimate_fields_plain(tq, sl, qmap=QMAP, cmap=CMAP),
        linear_estimate_fields_plain(tq, sl.contiguous(), qmap=QMAP,
                                     cmap=CMAP))


def test_wrappers_reject_bad_inputs_and_the_cpu_in_the_kernel():
    tq, tc = (torch.from_numpy(x) for x in _tables(5))
    with pytest.raises(ValueError, match="expected tq"):
        ops.linear_estimate_fields(tq, tc[..., :5], qmap=QMAP, cmap=CMAP)
    with pytest.raises(TypeError):
        ops.linear_estimate_fields(tq.double(), tc, qmap=QMAP, cmap=CMAP)
    with pytest.raises(ValueError, match="out of range"):
        ops.linear_estimate_fields(tq, tc, qmap=(3,), cmap=(0,))
    with pytest.raises(ValueError, match="length mismatch"):
        ops.linear_estimate_fields(tq, tc, qmap=(0, 1), cmap=(0,))
    with pytest.raises(ValueError, match="CUDA tensors"):
        linear_estimate_fields_cuda(tq, tc, qmap=QMAP, cmap=CMAP)
