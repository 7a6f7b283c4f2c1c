"""The packed estimate kernels' plain versions (B11, B12, B13) and the
sketch kernels' pack epilogue (B10) against the JAX package.

B11, B12 and B13 are held against the interpret-mode Pallas kernels at the
unpacked parity tests' tolerances (the sums run in other orders): ``cnt``
exact and ``sw`` within rtol 1e-5 (B11), rtol 1e-4 with atol 1e-4 x the
largest dot (B12), rtol 1e-5 with atol 1e-5 x the largest estimate (B13).
Inside the port, every family's packed estimate equals its unpacked
estimate on ``unpack_rows(pack_rows(rows))`` bit for bit.  B10's packed
plane equals the JAX kernel's on every word whose two slots' fingerprints
agree (``log``/``exp`` may flip a rare argmin)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels.dmh_sketch import dmh_sketch_pallas
from repro.kernels.estimate import (estimate_fields_packed_pallas,
                                    linear_estimate_fields_packed_pallas)
from repro.kernels.icws_sketch import icws_sketch_pallas
from repro.kernels.sample_estimate import (sample_estimate_fields_packed_pallas,
                                           sample_inclusion_probs as jax_probs)
from repro_torch.core.dmh import dmh_replication, replicate_keys
from repro_torch.core.types import SparseVec
from repro_torch.data.families import FAMILY_NAMES, make_family
from repro_torch.data.ingest import pad_sparse_batch
from repro_torch.kernels import estimate as port_est
from repro_torch.kernels import ops
from repro_torch.kernels import sample_estimate as port_se
from repro_torch.kernels.packed import pack_halfwords_f32, pack_sketch_vals

# small shapes: one intra-op thread per test process, so that parallel
# test workers do not oversubscribe the cores
torch.set_num_threads(1)

QMAP = (0, 1, 0, 2, 0, 1)
CMAP = (0, 0, 1, 0, 2, 1)


def _bits(x):
    return np.asarray(x).view(np.int32)


def _vectors(seed, count):
    """Overlapping sparse vectors (the serving regime) and an empty one."""
    rng = np.random.default_rng(seed)
    base = rng.choice(4000, size=120, replace=False)
    vecs = []
    for _ in range(count - 1):
        idx = np.unique(np.concatenate([base[rng.random(120) < 0.6],
                                        rng.integers(4000, 2 ** 31, 30)]))
        vecs.append(SparseVec.from_pairs(idx, rng.normal(size=idx.size) * 3,
                                         2 ** 31))
    return vecs + [SparseVec.from_pairs([], [], 10)]


# B11's field maps: the service's six pairs, one pair, five pairs reading
# one corpus field
FIELD_MAPS = {"service": (QMAP, CMAP), "one pair": ((0,), (1,)),
              "one corpus field": ((0, 1, 2, 0, 1), (2, 2, 2, 2, 2))}


@pytest.mark.parametrize("maps", FIELD_MAPS)
@pytest.mark.parametrize("Q", [1, 3, 17])
def test_packed_fields_partials_match_the_jax_kernel(Q, maps):
    qmap, cmap = FIELD_MAPS[maps]
    rng = np.random.default_rng(0)
    m, P = 40, 19
    fq = rng.integers(0, 50, size=(3, Q, m)).astype(np.int32)
    vq = rng.normal(size=(3, Q, m)).astype(np.float32)
    fc = np.where(rng.random((3, P, m)) < 0.5, fq[:, rng.integers(0, Q, P)],
                  rng.integers(0, 50, size=(3, P, m))).astype(np.int32)
    fq[:, -1, -5:] = -1
    fc[:, -2:] = -2
    wc = pack_halfwords_f32(torch.from_numpy(
        rng.normal(size=(3, P, m)).astype(np.float32))).numpy()
    wc[:, -2:] = 0
    cnt_j, sw_j = estimate_fields_packed_pallas(
        *(jnp.asarray(a) for a in (fq, vq, fc, wc)), qmap=qmap, cmap=cmap,
        interpret=True)
    cnt, sw = port_est.estimate_fields_packed_plain(
        *(torch.from_numpy(a) for a in (fq, vq, fc, wc)), qmap=qmap,
        cmap=cmap)
    assert cnt.sum() > 0 and torch.all(cnt[:, :, -2:] == 0)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_j))
    np.testing.assert_allclose(sw.numpy(), np.asarray(sw_j), rtol=1e-5)


@pytest.mark.parametrize("R, W", [(5, 20), (1, 34)])
def test_packed_linear_dots_match_the_jax_kernel(R, W):
    rng = np.random.default_rng(W)
    tq = rng.normal(size=(3, 4, R, W)).astype(np.float32)
    wc = pack_halfwords_f32(torch.from_numpy(
        rng.normal(size=(3, 13, R, W)).astype(np.float32))).numpy()
    wc[:, -2:] = 0
    want = np.asarray(linear_estimate_fields_packed_pallas(
        jnp.asarray(tq), jnp.asarray(wc), qmap=QMAP, cmap=CMAP,
        interpret=True))
    got = port_est.linear_estimate_fields_packed_plain(
        torch.from_numpy(tq), torch.from_numpy(wc), qmap=QMAP,
        cmap=CMAP).numpy()
    assert np.all(got[..., -2:] == 0)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)


def _sample_rows(rng, F, B, S, Se, pad):
    """Sample rows with sorted live prefixes over a small key pool, values
    and positive taus; ``Se - S`` pad slots of key ``pad`` at the end."""
    keys = np.full((F, B, Se), pad, np.int32)
    vals = np.zeros((F, B, Se), np.float32)
    taus = np.zeros((F, B), np.float32)
    for f in range(F):
        for b in range(B):
            live = int(rng.integers(0, S + 1))
            keys[f, b, :live] = np.sort(rng.choice(60, live, replace=False))
            vals[f, b, :live] = rng.normal(size=live)
            taus[f, b] = rng.uniform(0.1, 5.0) if live else 0.0
    return keys, vals, taus


@pytest.mark.parametrize("S", [33, 40])
def test_packed_sample_estimate_matches_the_jax_kernel(S):
    """Odd S stores one pad slot; probabilities use the true S."""
    rng = np.random.default_rng(S)
    Se = S + S % 2
    kq, vq, tq = _sample_rows(rng, 3, 4, S, S, -1)
    kc, vc, tc = _sample_rows(rng, 3, 11, S, Se, -2)
    wc = pack_halfwords_f32(torch.from_numpy(vc)).numpy()
    aq = jax_probs(jnp.asarray(vq), jnp.asarray(tq))
    want = np.asarray(sample_estimate_fields_packed_pallas(
        jnp.asarray(kq), jnp.asarray(vq), aq, jnp.asarray(kc),
        jnp.asarray(wc), jnp.asarray(tc), s_total=S, qmap=QMAP, cmap=CMAP,
        interpret=True))
    got = ops.sample_estimate_fields_packed(
        *(torch.from_numpy(a) for a in (kq, vq, tq, kc, wc, tc)),
        qmap=QMAP, cmap=CMAP).numpy()
    assert np.count_nonzero(got) > 0
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("name", FAMILY_NAMES)
@pytest.mark.parametrize("storage", [97.0, 98.5])
def test_packed_estimates_equal_unpacked_on_roundtripped_rows(name, storage):
    """The port contract's fourth identity, on each family's own rows at
    odd and even widths; also held against the JAX op within tolerance."""
    fam = make_family(name, storage=storage, seed=2)
    rows = fam.sketch_rows(_vectors(3, 3 * 7), device="cpu")
    q = tuple(r[:9].reshape((3, 3) + r.shape[1:]) for r in rows)
    c = tuple(r[9:].reshape((3, 4) + r.shape[1:]) for r in rows)
    packed = fam.pack_rows(c)
    got = fam.estimate_fields_packed(q, packed, qmap=QMAP, cmap=CMAP)
    want = fam.estimate_fields(q, fam.unpack_rows(packed), qmap=QMAP,
                               cmap=CMAP)
    assert got.shape == (6, 3, 4) and torch.count_nonzero(got) > 0
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want.numpy()))
    jax_op = {"icws": jax_ops.icws_estimate_fields_packed,
              "dmh": jax_ops.icws_estimate_fields_packed,
              "cs": jax_ops.linear_estimate_fields_packed,
              "jl": jax_ops.linear_estimate_fields_packed}.get(
                  name, jax_ops.sample_estimate_fields_packed)
    args = q[:len(packed)] + packed            # the ICWS argkeys stay out
    ref = np.asarray(jax_op(*(jnp.asarray(x.numpy()) for x in args),
                            qmap=QMAP, cmap=CMAP))
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4 * scale)


def _agreeing_words(fp_a, fp_b):
    """Words whose two slots' fingerprints agree in both sketches."""
    agree = np.asarray(fp_a) == np.asarray(fp_b)
    if agree.shape[1] % 2:
        agree = np.pad(agree, ((0, 0), (0, 1)), constant_values=True)
    return agree[:, 0::2] & agree[:, 1::2]


@pytest.mark.parametrize("m", [31, 64])
def test_icws_pack_epilogue_matches_the_jax_kernel(m):
    w, keys, vals, _ = pad_sparse_batch(_vectors(5, 6), bucket=64)
    got = ops.icws_sketch(*(torch.from_numpy(a) for a in (w, keys, vals)),
                          m=m, seed=4, pack_vals=True)
    want = icws_sketch_pallas(*(jnp.asarray(a) for a in (w, keys, vals)),
                              m=m, seed=4, pack_vals=True, interpret=True)
    assert len(got) == 5 and got[4].shape == (6, (m + 1) // 2)
    ok = _agreeing_words(got[0], want[0])
    assert ok.mean() >= 0.99 and np.all(got[4][-1].numpy() == 0)
    np.testing.assert_array_equal(got[4].numpy()[ok], np.asarray(want[4])[ok])
    assert torch.equal(got[4], pack_sketch_vals(got[1], got[2]))


@pytest.mark.parametrize("m", [31, 64])
def test_dmh_pack_epilogue_matches_the_jax_kernel(m):
    w, keys, vals, _ = pad_sparse_batch(_vectors(6, 6), bucket=64)
    c = dmh_replication(m)
    keys = replicate_keys(keys.view(np.uint32), c).view(np.int32)
    w, vals = np.tile(w, (1, c)), np.tile(vals, (1, c))
    got = ops.dmh_sketch(*(torch.from_numpy(a) for a in (w, keys, vals)),
                         m=m, seed=5, pack_vals=True)
    want = dmh_sketch_pallas(*(jnp.asarray(a) for a in (w, keys, vals)),
                             m=m, seed=5, pack_vals=True, interpret=True)
    ok = _agreeing_words(got[0], want[0])
    assert ok.mean() >= 0.99 and np.all(got[4][-1].numpy() == 0)
    np.testing.assert_array_equal(got[4].numpy()[ok], np.asarray(want[4])[ok])
    assert torch.equal(got[4], pack_sketch_vals(got[1], got[2]))


def test_packed_wrappers_check_layouts_and_refuse_the_cpu_in_the_kernel():
    fq = torch.zeros((3, 2, 8), dtype=torch.int32)
    vq = torch.zeros((3, 2, 8))
    wc = torch.zeros((3, 5, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="me even"):
        port_est.estimate_fields_packed_plain(fq, vq, fq[:, :, :7], wc,
                                              qmap=QMAP, cmap=CMAP)
    with pytest.raises(ValueError, match="CUDA"):
        port_est.estimate_fields_packed_cuda(fq, vq, fq, wc[:, :2],
                                             qmap=QMAP, cmap=CMAP)
    with pytest.raises(ValueError, match="CUDA"):
        port_est.linear_estimate_fields_packed_cuda(
            vq[:, :, None], wc[:, :, None], qmap=QMAP, cmap=CMAP)
    with pytest.raises(ValueError, match="CUDA"):
        port_se.sample_estimate_fields_packed_cuda(
            fq, vq, vq, fq, wc[:, :2], vq[:, :, 0], qmap=QMAP, cmap=CMAP)


@pytest.mark.parametrize("bad", ["shape", "dtype", "device"])
def test_packed_sample_wrappers_check_the_taus(bad):
    """The packed key-match kernel and its plain version take the taus ``tc
    [C, P]`` f32 on the planes' device."""
    kq = torch.tensor([[[1, 2, -1]]], dtype=torch.int32)
    vq = torch.ones((1, 1, 3))
    kc = torch.tensor([[[1, 2, -2, -2]], [[2, -2, -2, -2]]], dtype=torch.int32)
    wc = torch.zeros((2, 1, 2), dtype=torch.int32)
    tc = {"shape": torch.ones((2, 2)),
          "dtype": torch.ones((2, 1), dtype=torch.float64),
          "device": torch.ones((2, 1), device="meta")}[bad]
    for fn in (port_se.sample_estimate_fields_packed_cuda,
               port_se.sample_estimate_fields_packed_plain):
        with pytest.raises(ValueError, match="tc|one device"):
            fn(kq, vq, vq, kc, wc, tc, qmap=(0,), cmap=(1,))
