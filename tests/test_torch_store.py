"""The port's field-stacked corpus store: in-place append, amortized
doubling, inert spare rows, tenant ranges -- and buffers equal to the JAX
package's store after the same appends."""
import numpy as np
import pytest
import torch

from repro.data.families import CSFamily as JaxCSFamily
from repro.data.families import make_family as jax_make_family
from repro.data.store import CorpusStore as JaxCorpusStore
from repro_torch.data.families import CSFamily, JLFamily, make_family
from repro_torch.data.store import CorpusStore

# small shapes: one intra-op thread per test process, so that parallel
# test workers do not oversubscribe the cores
torch.set_num_threads(1)

M = 16


def _batch(rng, b, fields=3, m=M):
    return (rng.integers(0, 2 ** 31 - 1, size=(fields, b, m)).astype(np.int32),
            rng.normal(size=(fields, b, m)).astype(np.float32),
            rng.random(size=(fields, b)).astype(np.float32),
            rng.integers(-2 ** 31, 2 ** 31 - 1,
                         size=(fields, b, m)).astype(np.int32))


def test_buffers_equal_the_jax_store_after_the_same_appends():
    rng = np.random.default_rng(0)
    port = CorpusStore(m=M, fields=3, min_capacity=4, device="cpu")
    ref = JaxCorpusStore(m=M, fields=3, min_capacity=4)
    for b, tenant in ((3, "a"), (2, "a"), (6, None), (1, "b"), (9, "a")):
        rows = _batch(rng, b)
        port.append(*rows, tenant=tenant)
        ref.append(*rows, tenant=tenant)
        assert port.size == ref.size and port.capacity == ref.capacity
        for got, want in zip(port.buffers(), ref.buffers()):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for t in ("a", "b"):
        assert port.tenant_ranges(t) == ref.tenant_ranges(t)
        np.testing.assert_array_equal(port.tenant_rows(t), ref.tenant_rows(t))
    assert port.describe_tenants() == ref.describe_tenants()
    assert port.bytes_per_row() == ref.bytes_per_row() == 12 * M + 4
    assert port.storage_doubles() == ref.storage_doubles()


def test_append_writes_in_place_and_doubles_capacity():
    rng = np.random.default_rng(1)
    store = CorpusStore(m=M, fields=3, min_capacity=4, device="cpu")
    store.append(*_batch(rng, 3))
    bufs = store.buffers()
    ptrs = [b.data_ptr() for b in bufs]
    store.append(*_batch(rng, 1))                 # fits: same storage
    assert [b.data_ptr() for b in store.buffers()] == ptrs
    assert store.capacity == 4
    store.append(*_batch(rng, 1))                 # grows 4 -> 8
    assert store.capacity == 8 and store.size == 5
    store.append(*_batch(rng, 20))                # 25 rows -> 32
    assert store.capacity == 32 and len(store) == 25


def test_spare_rows_hold_inert_fills():
    rng = np.random.default_rng(2)
    store = CorpusStore(m=M, fields=3, min_capacity=8, device="cpu")
    store.append(*_batch(rng, 3))
    fp, val, norm, argkey = store.buffers()
    assert torch.all(fp[:, 3:] == -2) and torch.all(val[:, 3:] == 0)
    assert torch.all(norm[:, 3:] == 0) and torch.all(argkey[:, 3:] == 0)
    assert fp.dtype == torch.int32 and val.dtype == torch.float32


def test_append_validates_before_writing():
    rng = np.random.default_rng(3)
    store = CorpusStore(m=M, fields=3, device="cpu")
    fp, val, norm, argkey = _batch(rng, 2)
    with pytest.raises(ValueError, match="components"):
        store.append(fp, val, norm)
    with pytest.raises(ValueError, match="do not match"):
        store.append(fp, val[:, :1], norm, argkey)
    with pytest.raises(ValueError, match="rows must be"):
        store.append(fp[:2], val, norm, argkey)
    assert store.size == 0
    with pytest.raises(ValueError, match="empty corpus"):
        store.buffers()
    with pytest.raises(KeyError):
        store.tenant_ranges("nobody")


def test_single_field_store_takes_rows_without_field_axis():
    rng = np.random.default_rng(4)
    store = CorpusStore(m=M, device="cpu")
    fp, val, norm, argkey = (x[0] for x in _batch(rng, 5, fields=1))
    store.append(fp, val, norm, argkey)
    np.testing.assert_array_equal(store.buffers()[0][0, :5].numpy(), fp)


def test_linear_family_store_grows_with_inert_zero_tables():
    """A CountSketch family has no sample count ``m``: the store takes it
    as None, holds one ``[F, cap, R, W]`` table buffer, grows it with zero
    (inert) rows, and equals the JAX store after the same appends."""
    rng = np.random.default_rng(5)
    port = CorpusStore(family=CSFamily(width=7, reps=5), fields=3,
                       min_capacity=4, device="cpu")
    ref = JaxCorpusStore(family=JaxCSFamily(width=7, reps=5), fields=3,
                         min_capacity=4)
    assert port.m is None and port.bytes_per_row() == 4 * 5 * 7
    for b in (3, 2, 6):
        rows = rng.normal(size=(3, b, 5, 7)).astype(np.float32)
        port.append(rows)
        ref.append(rows)
        (got,), (want,) = port.buffers(), ref.buffers()
        assert port.capacity == ref.capacity
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    (tables,) = port.buffers()
    assert port.size == 11 and port.capacity == 16
    assert tables.shape == (3, 16, 5, 7) and torch.all(tables[:, 11:] == 0)
    assert port.storage_doubles() == ref.storage_doubles() == 11 * 3 * 35
    jl = CorpusStore(family=JLFamily(m=9), fields=3, device="cpu")
    assert jl.m == 9 and jl.bytes_per_row() == 36


@pytest.mark.parametrize("family", ["ts", "ps"])
def test_sampling_family_store_grows_with_inert_rows(family):
    """TS/PS rows count ``slots``, not ``m``: the store takes m as None,
    holds keys/values ``[F, cap, S]`` and taus ``[F, cap]``, grows with
    pad keys -2, zero values and zero taus, and equals the JAX store after
    the same appends.  At the serving budget a row is 8 S + 4 = 6,148 B,
    as an m = 512 DMH (ICWS) row is 12 m + 4."""
    rng = np.random.default_rng(6)
    port = CorpusStore(family=make_family(family, storage=13.0), fields=3,
                       min_capacity=4, device="cpu")
    ref = JaxCorpusStore(family=jax_make_family(family, storage=13.0),
                         fields=3, min_capacity=4)
    assert port.m is None and port.bytes_per_row() == 8 * 12 + 4
    for b in (3, 2, 6):
        keys = np.sort(rng.integers(0, 99, (3, b, 12)), axis=2).astype(np.int32)
        rows = (keys, rng.normal(size=(3, b, 12)).astype(np.float32),
                rng.random((3, b)).astype(np.float32))
        port.append(*rows)
        ref.append(*rows)
        assert port.capacity == ref.capacity
        for got, want in zip(port.buffers(), ref.buffers()):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    keys, vals, taus = port.buffers()
    assert keys.shape == (3, 16, 12) and taus.shape == (3, 16)
    assert torch.all(keys[:, 11:] == -2) and torch.all(vals[:, 11:] == 0)
    assert torch.all(taus[:, 11:] == 0)
    assert port.storage_doubles() == ref.storage_doubles() == 11 * 3 * 13
    serving = {f: CorpusStore(family=make_family(f, storage=769.0),
                              device="cpu") for f in (family, "dmh")}
    assert serving[family].bytes_per_row() == 6_148
    assert serving["dmh"].bytes_per_row() == 6_148
    assert serving["dmh"].m == 512
