"""The port's pair, one-vs-many and many-vs-many ICWS estimate launches
(B3, B4: plain versions on the CPU) against the JAX package's Pallas
kernels in interpret mode and its jnp references, on the same numpy rows;
the norm epilogues against ``repro.kernels.ops``; the empty-query and
zero-norm guards; and the port's bitwise identities between the routes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref
from repro.kernels.estimate import (estimate_many_vs_many_pallas,
                                    estimate_one_vs_many_pallas,
                                    estimate_partials_pallas)
from repro_torch.kernels import estimate as port_est
from repro_torch.kernels import ops

# small shapes: one intra-op thread per test process, so that parallel
# test workers do not oversubscribe the cores
torch.set_num_threads(1)

P, Q = 37, 5
MS = (50, 128, 200)
ROUTES = ("pairs", "one_vs_many", "many_vs_many")


def _rows(seed, m):
    """Query rows [Q, m] and corpus rows [P, m] with planted collisions:
    each corpus row copies a random query's fingerprints on a per-row share
    of its slots and draws the rest from a small range, so chance hits
    happen too; query row 1 is empty (-1), the last three corpus rows are
    spare (-2); norms with zeros on both sides."""
    rng = np.random.default_rng(seed)
    fq = rng.integers(0, 60, size=(Q, m)).astype(np.int32)
    vq = rng.normal(size=(Q, m)).astype(np.float32)
    src = rng.integers(0, Q, size=P)
    copy = rng.random((P, m)) < rng.random((P, 1))
    fc = np.where(copy, fq[src], rng.integers(0, 60, size=(P, m)))
    vc = np.where(copy, 1.5 * vq[src], rng.normal(size=(P, m)))
    fc, vc = fc.astype(np.int32), vc.astype(np.float32)
    vc[0, :7] = 0.0                        # zero values: the safe denominator
    fq[1], vq[1] = -1, 0.0
    fc[-3:], vc[-3:] = -2, 0.0
    nq = rng.uniform(0.5, 3.0, size=Q).astype(np.float32)
    nc = rng.uniform(0.5, 3.0, size=P).astype(np.float32)
    nq[3], nc[[2, -3, -2, -1]] = 0.0, 0.0
    return fq, vq, nq, fc, vc, nc


def _route_args(route, fq, vq, nq, fc, vc, nc, qi=0):
    """The arguments of one route: pairs (query qi tiled to P rows, a
    per-row norm), one-vs-many (query qi, its norm) or many-vs-many."""
    if route == "pairs":
        return (np.repeat(fq[qi:qi + 1], P, 0), np.repeat(vq[qi:qi + 1], P, 0),
                np.repeat(nq[qi], P), fc, vc, nc)
    if route == "one_vs_many":
        return fq[qi:qi + 1], vq[qi:qi + 1], nq[qi], fc, vc, nc
    return fq, vq, nq, fc, vc, nc


_PORT_PARTIALS = {"pairs": ops.estimate_partials,
                  "one_vs_many": ops.estimate_partials_one_vs_many,
                  "many_vs_many": ops.estimate_partials_many_vs_many}
_PALLAS = {"pairs": estimate_partials_pallas,
           "one_vs_many": estimate_one_vs_many_pallas,
           "many_vs_many": estimate_many_vs_many_pallas}
_REF = {"pairs": ref.estimate_partials_ref,
        "one_vs_many": ref.estimate_one_vs_many_ref,
        "many_vs_many": ref.estimate_many_vs_many_ref}
_PORT_EST = {"pairs": ops.icws_estimate,
             "one_vs_many": ops.icws_estimate_corpus,
             "many_vs_many": ops.icws_estimate_many}
_JAX_EST = {"pairs": jax_ops.icws_estimate,
            "one_vs_many": jax_ops.icws_estimate_corpus,
            "many_vs_many": jax_ops.icws_estimate_many}


def _close(got, want):
    """rtol 1e-5 with atol 1e-5 of the largest |value|: the JAX kernels sum
    t in bm = 128 blocks, the port in order one add at a time."""
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * max(1e-30, np.abs(want).max()))


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("route", ROUTES)
def test_plain_partials_match_jax_kernels(route, m):
    fa, va, _, fb, vb, _ = _route_args(route, *_rows(m, m))
    cnt, sw = (x.numpy() for x in _PORT_PARTIALS[route](
        *(torch.from_numpy(np.asarray(a)) for a in (fa, va, fb, vb))))
    lead = {"pairs": (P,), "one_vs_many": (P,), "many_vs_many": (Q, P)}
    assert cnt.shape == sw.shape == lead[route]
    assert cnt.dtype == sw.dtype == np.float32
    assert cnt.sum() > m, "rows must collide for the check to bite"
    jargs = [jnp.asarray(a) for a in (fa, va, fb, vb)]
    for cnt_j, sw_j in (_PALLAS[route](*jargs, interpret=True),
                        _REF[route](*jargs)):
        np.testing.assert_array_equal(cnt, np.asarray(cnt_j))
        _close(sw, sw_j)


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("route", ROUTES)
def test_estimates_match_jax_epilogue(route, m):
    args = _route_args(route, *_rows(m + 1, m))
    est = _PORT_EST[route](*(torch.as_tensor(np.asarray(a))
                             for a in args)).numpy()
    est_j = np.asarray(_JAX_EST[route](*(jnp.asarray(a) for a in args)))
    assert est.dtype == np.float32 and est.shape == est_j.shape
    # the zero-norm and pad guards give exact zeros on both sides
    np.testing.assert_array_equal(est == 0, est_j == 0)
    _close(est, est_j)


def test_empty_query_and_zero_norm_guards():
    fq, vq, nq, fc, vc, nc = (torch.from_numpy(np.asarray(a))
                              for a in _rows(7, 128))
    # query 1 is empty (all -1): no collision on any route
    cnt, sw = ops.estimate_partials_one_vs_many(fq[1], vq[1], fc, vc)
    assert torch.all(cnt == 0) and torch.all(sw == 0)
    cnt, sw = ops.estimate_partials(fq[1].expand(P, -1), vq[1].expand(P, -1),
                                    fc, vc)
    assert torch.all(cnt == 0) and torch.all(sw == 0)
    est = ops.icws_estimate_many(fq, vq, nq, fc, vc, nc)
    assert torch.all(est[1] == 0)
    # zero norms (query 3, corpus rows 2 and the spare rows) estimate to 0
    assert torch.all(est[3] == 0) and torch.all(est[:, [2, -3, -2, -1]] == 0)
    assert torch.count_nonzero(est[0]) > P // 2
    assert torch.all(ops.icws_estimate_corpus(fq[3], vq[3], nq[3], fc, vc,
                                              nc) == 0)
    # an all-empty corpus (-1 on both sides) collides with nothing
    neg = torch.full_like(fc, -1)
    cnt, _ = ops.estimate_partials_many_vs_many(fq, vq, neg, vc)
    assert torch.all(cnt == 0)


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("m", MS)
def test_routes_agree_bit_for_bit(m):
    """A row of B4, the one-vs-many route, the pairwise route on the tiled
    query and B2 at G = 1 give the same bits; field 0 of a [1, cap, m]
    buffer with spare rows gives the sliced corpus's bits."""
    fq, vq, nq, fc, vc, nc = (torch.from_numpy(np.asarray(a))
                              for a in _rows(m + 2, m))
    many = ops.estimate_partials_many_vs_many(fq, vq, fc, vc)
    fields = port_est.estimate_fields_plain(fq[None], vq[None], fc[None],
                                            vc[None], qmap=(0,), cmap=(0,))
    for q in range(Q):
        one = ops.estimate_partials_one_vs_many(fq[q], vq[q], fc, vc)
        tiled = ops.estimate_partials(fq[q].expand(P, -1),
                                      vq[q].expand(P, -1), fc, vc)
        for i in range(2):
            for other in (one[i], tiled[i], fields[i][0, q]):
                assert torch.equal(_bits(many[i][q]), _bits(other))
    # stacked [1, cap, m] store buffers: spare rows are inert, the view is
    # read in place, and batched == sequential after the epilogue
    cap = P + 11
    fpb = torch.full((1, cap, m), -2, dtype=torch.int32)
    vb = torch.zeros((1, cap, m))
    nb = torch.zeros((1, cap))
    fpb[0, :P], vb[0, :P], nb[0, :P] = fc, vc, nc
    batched = ops.icws_estimate_many_stacked(fq, vq, nq, fpb, vb, nb)
    assert batched.shape == (Q, cap) and torch.all(batched[:, P:] == 0)
    assert torch.equal(_bits(batched[:, :P]),
                       _bits(ops.icws_estimate_many(fq, vq, nq, fc, vc, nc)))
    for q in range(Q):
        seq = ops.icws_estimate_corpus_stacked(fq[q:q + 1], vq[q:q + 1],
                                               nq[q], fpb, vb, nb)
        assert seq.shape == (cap,)
        assert torch.equal(_bits(seq), _bits(batched[q]))
        # nq as a python float gives the same bits as the 0-d tensor
        flt = ops.icws_estimate_corpus(fq[q], vq[q], float(nq[q]), fc, vc, nc)
        assert torch.equal(_bits(flt), _bits(batched[q, :P]))


@pytest.mark.parametrize("m", [50, 127])
@pytest.mark.parametrize("nq", [1, 16, 17])
def test_many_vs_many_plain_is_fields_and_one_vs_many_bitwise(nq, m):
    """B4's plain version at the card kernel's query tiles (one query, a full
    tile of 16, a ragged 17th) on field 0 of a [1, cap, m] buffer read
    through its row stride, m not a multiple of 4: B2's plain version at
    G = 1 and, row by row, B3's one-vs-many plain version, bit for bit."""
    fq, vq, _, fc, vc, _ = _rows(nq * 7 + m, m)
    rng = np.random.default_rng(nq)
    fq = np.concatenate([fq] * 4)[:nq]
    vq = np.concatenate([vq * s for s in rng.uniform(0.5, 2.0, 4)])[:nq]
    cap = P + 9
    fpb = torch.full((1, cap, m), -2, dtype=torch.int32)
    vb = torch.zeros((1, cap, m))
    fpb[0, 4:4 + P], vb[0, 4:4 + P] = torch.from_numpy(fc), torch.from_numpy(vc)
    fc, vc = fpb[0, 4:4 + P], vb[0, 4:4 + P]
    fq, vq = torch.from_numpy(fq), torch.from_numpy(vq.astype(np.float32))
    many = port_est.estimate_many_vs_many_plain(fq, vq, fc, vc)
    fields = port_est.estimate_fields_plain(fq[None], vq[None], fc[None],
                                            vc[None], qmap=(0,), cmap=(0,))
    assert many[0].shape == (nq, P) and many[0].sum() > 0
    for i in range(2):
        assert torch.equal(_bits(many[i]), _bits(fields[i][0]))
    for q in range(nq):
        one = port_est.estimate_one_vs_many_plain(fq[q], vq[q], fc, vc)
        for i in range(2):
            assert torch.equal(_bits(many[i][q]), _bits(one[i]))


def test_checks_and_unported_options():
    fq, vq, nq, fc, vc, nc = (torch.from_numpy(np.asarray(a))
                              for a in _rows(9, 50))
    for fn, args in (
            (port_est.estimate_partials_cuda, (fc, vc, fc, vc)),
            (port_est.estimate_one_vs_many_cuda, (fq[0], vq[0], fc, vc)),
            (port_est.estimate_many_vs_many_cuda, (fq, vq, fc, vc))):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(*args)
    with pytest.raises(ValueError, match="differ in rows"):
        ops.estimate_partials(fq, vq, fc, vc)
    with pytest.raises(ValueError, match="one query sketch"):
        ops.estimate_partials_one_vs_many(fq, vq, fc, vc)
    with pytest.raises(ValueError, match="expected"):
        ops.estimate_partials_many_vs_many(fq[:, :40], vq[:, :40], fc, vc)
    with pytest.raises(TypeError, match="int32 fingerprints"):
        ops.estimate_partials_many_vs_many(fq.long(), vq, fc, vc)
    # the sharded many-vs-many launch over 3 CPU shards (37 rows: the pad
    # path) equals the single-device one bit for bit
    from repro_torch.launch import CorpusMesh
    mesh = CorpusMesh(("c",), (torch.device("cpu"),) * 3)
    assert torch.equal(
        ops.icws_estimate_many_sharded(fq, vq, nq, fc[None], vc[None],
                                       nc[None], mesh=mesh, axis="c"),
        ops.icws_estimate_many_stacked(fq, vq, nq, fc[None], vc[None],
                                       nc[None]))
