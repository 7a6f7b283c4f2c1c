"""The port's packed corpus layout against the JAX package: the
bf16-halfword codec and every family's ``pack_rows`` / ``unpack_rows`` bit
for bit, the codec's fixpoint, the packed store's bytes per row and its
inert spare rows."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.families import make_family as jax_make_family
from repro.data.store import CorpusStore as JaxCorpusStore
from repro.kernels import packed as jax_packed
from repro_torch.data.families import FAMILY_NAMES, make_family, wmh_storage
from repro_torch.data.store import CorpusStore
from repro_torch.kernels import packed

# small shapes: one intra-op thread per test process, so that parallel
# test workers do not oversubscribe the cores
torch.set_num_threads(1)

# budgets giving odd and even widths: icws/dmh m 64, 65, 66; cs width 19,
# 19, 20; jl m 97, 98, 101; ts/ps 96, 97, 100 slots
STORAGES = (97.0, 98.5, 101.0)


def _bits(x):
    return np.asarray(x).view(np.int32)


def _special_f32(rng, shape):
    """Random f32 over the whole exponent range, with ±0, subnormals, ±inf
    and NaNs (payloads included) mixed in."""
    x = rng.integers(-2 ** 31, 2 ** 31, size=shape).astype(np.int64)
    x = x.astype(np.uint32).view(np.float32).copy()
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-40,
                        3.4e38, 1.0, -2.5], np.float32)
    special = np.append(special, np.uint32(0x7FC12345).view(np.float32))
    flat = x.reshape(-1)
    n = min(flat.size, special.size)
    flat[:n] = special[:n]
    return x


def test_codec_is_the_jax_codec_bit_for_bit():
    rng = np.random.default_rng(0)
    x = _special_f32(rng, (3, 5, 40))
    got = packed.pack_halfwords_f32(torch.from_numpy(x))
    want = jax_packed.pack_halfwords_f32(jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    w = rng.integers(-2 ** 31, 2 ** 31, size=(4, 33)).astype(np.int32)
    got = packed.unpack_halfwords_f32(torch.from_numpy(w))
    want = jax_packed.unpack_halfwords_f32(jnp.asarray(w))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    # the fixpoint, on every word
    np.testing.assert_array_equal(
        packed.pack_halfwords_f32(got).numpy(), w)
    assert packed.packed_width(7) == jax_packed.packed_width(7) == 4
    with pytest.raises(ValueError, match="even"):
        packed.pack_halfwords_f32(torch.zeros(3, 5))


def _unpacked_rows(fam, rng, b=7):
    """Random rows of the family's unpacked layout [3, b, ...], values over
    the whole f32 range; an ICWS row gets query-pad fingerprints."""
    rows = []
    for spec in fam.components:
        shape = (3, b) + spec.trailing
        if spec.dtype == torch.int32:
            rows.append(rng.integers(-2, 2 ** 31 - 1, size=shape)
                        .astype(np.int32))
        else:
            rows.append(_special_f32(rng, shape))
    return rows


@pytest.mark.parametrize("name", FAMILY_NAMES)
@pytest.mark.parametrize("storage", STORAGES)
def test_pack_and_unpack_rows_are_the_jax_familys(name, storage):
    fam = make_family(name, storage=storage, seed=1)
    jfam = jax_make_family(name, storage=storage, seed=1)
    assert [(c.name, c.trailing, c.fill) for c in fam.packed_components] == \
        [(c.name, c.trailing, c.fill) for c in jfam.packed_components]
    rows = _unpacked_rows(fam, np.random.default_rng(2))
    got = fam.pack_rows(tuple(torch.from_numpy(r) for r in rows))
    want = jfam.pack_rows(tuple(jnp.asarray(r) for r in rows))
    assert len(got) == len(want) == len(fam.packed_components)
    for g, w, spec in zip(got, want, fam.packed_components):
        assert g.dtype == spec.dtype and tuple(g.shape[2:]) == spec.trailing
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))
    back = fam.unpack_rows(got)
    for g, w in zip(back, jfam.unpack_rows(want)):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))
    # pack(unpack(p)) == p
    for g, w in zip(fam.pack_rows(back), got):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w.numpy()))


@pytest.mark.parametrize("name, per_row", [
    ("icws", 3076), ("dmh", 3076), ("cs", 1540), ("jl", 1540), ("ts", 4612),
    ("ps", 4612)])
def test_packed_bytes_per_row_is_the_jax_stores(name, per_row):
    """At the service's budget (m = 512)."""
    storage = wmh_storage(512)
    port = CorpusStore(family=make_family(name, storage=storage), fields=3,
                       packed=True, device="cpu")
    ref = JaxCorpusStore(family=jax_make_family(name, storage=storage),
                         fields=3, packed=True)
    assert port.bytes_per_row() == ref.bytes_per_row() == per_row
    assert port.packed and not CorpusStore(
        family=make_family(name, storage=storage), device="cpu").packed


@pytest.mark.parametrize("name", FAMILY_NAMES)
def test_packed_store_equals_the_jax_store_and_spare_rows_stay_inert(name):
    fam = make_family(name, storage=98.5, seed=3)
    jfam = jax_make_family(name, storage=98.5, seed=3)
    port = CorpusStore(family=fam, fields=3, min_capacity=4, packed=True,
                       device="cpu")
    ref = JaxCorpusStore(family=jfam, fields=3, min_capacity=4, packed=True)
    rng = np.random.default_rng(4)
    for b, tenant in ((3, "a"), (2, None), (6, "a")):
        rows = _unpacked_rows(fam, rng, b)
        port.append(*rows, tenant=tenant)
        ref.append(*rows, tenant=tenant)
    assert (port.size, port.capacity) == (ref.size, ref.capacity) == (11, 16)
    assert port.tenant_ranges("a") == ref.tenant_ranges("a")
    assert port.storage_doubles() == ref.storage_doubles()
    for got, want, spec in zip(port.buffers(), ref.buffers(),
                               fam.packed_components):
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
        assert torch.all(got[:, 11:] == spec.fill)
    # a packed row written as it is lands bit for bit
    more = fam.pack_rows(tuple(torch.from_numpy(r) for r in
                               _unpacked_rows(fam, rng, 2)))
    port.append_packed(*more)
    for got, want in zip(port.buffers(), more):
        np.testing.assert_array_equal(_bits(got[:, 11:13].numpy()),
                                      _bits(want.numpy()))
    with pytest.raises(ValueError, match="components"):
        port.append_packed(*more[:-1] if len(more) > 1 else ())
    with pytest.raises(ValueError, match="packed store"):
        CorpusStore(family=fam, device="cpu").append_packed(*more)
