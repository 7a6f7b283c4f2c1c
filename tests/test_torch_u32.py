"""The port's u32 RNG is bit-exact against the JAX package's device mixer
(``repro.kernels.common``) and its numpy host twin (``repro.core.u32``);
so is the port's own numpy copy (``repro_torch.core.u32``), which the
host samplers and the DMH replica salts use."""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import u32 as host_u32
from repro.kernels import common as jax_common
from repro_torch.core import dmh as port_dmh
from repro_torch.core import u32 as port_host_u32
from repro_torch.kernels import common

# small shapes: one intra-op thread per test process, so that parallel
# test workers do not oversubscribe the cores
torch.set_num_threads(1)

EDGE = np.array([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1, 0x9E3779B9,
                 0xFFFF, 0x10000], np.uint64)


def _keys():
    rng = np.random.default_rng(3)
    rand = rng.integers(0, 2 ** 32, size=4096, dtype=np.uint64)
    return np.concatenate([EDGE, rand]).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def test_mul32_keeps_low_bits_exact():
    x = _keys().astype(np.int64)
    for c in (0x85EBCA6B, 0xC2B2AE35, 0x9E3779B9, 0x2545F491, 0xFFFFFFFF):
        got = common.mul32(_t(x), c).numpy()
        want = np.array([(int(v) * c) & 0xFFFFFFFF for v in x], np.int64)
        np.testing.assert_array_equal(got, want)


def test_mix32_matches_jax_and_host():
    k = _keys()
    got = common.mix32(_t(k)).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, np.asarray(jax_common.mix32(jnp.asarray(k))))
    np.testing.assert_array_equal(got, host_u32.mix32(k))


@pytest.mark.parametrize("seed", [0, 7, 2 ** 32 - 1])
def test_hash_uniform_salt_match_jax_and_host(seed):
    k = _keys()
    t = np.arange(k.size, dtype=np.int32) % 1000
    for stream in sorted(common_streams().values()):
        salt = common.salt_for(seed, stream, torch.from_numpy(t))
        salt_j = jax_common.salt_for(seed, stream, jnp.asarray(t))
        np.testing.assert_array_equal(salt.numpy().astype(np.uint32),
                                      np.asarray(salt_j))
        h = common.hash_u32(_t(k), salt).numpy().astype(np.uint32)
        np.testing.assert_array_equal(
            h, np.asarray(jax_common.hash_u32(jnp.asarray(k), salt_j)))
        np.testing.assert_array_equal(
            h, host_u32.hash_u32(k, np.asarray(salt_j)))
        u = common.uniform01(_t(k), salt).numpy()
        assert u.dtype == np.float32
        np.testing.assert_array_equal(
            u, np.asarray(jax_common.uniform01(jnp.asarray(k), salt_j)))
        assert np.all((u > 0) & (u < 1))


def test_negative_int32_keys_wrap_like_uint32():
    """``_keys_i32`` folds keys >= 2^31 into negative int32s; the port's
    ``as_u32`` must read them back as the same uint32 pattern."""
    k = np.array([-1, -2 ** 31, -12345, 0, 2 ** 31 - 1], np.int32)
    got = common.hash_u32(torch.from_numpy(k), torch.tensor(77)).numpy()
    want = np.asarray(jax_common.hash_u32(jnp.asarray(k), jnp.uint32(77)))
    np.testing.assert_array_equal(got.astype(np.uint32), want)
    np.testing.assert_array_equal(
        common.as_u32(torch.from_numpy(k)).numpy(),
        k.astype(np.uint32).astype(np.int64))


def common_streams():
    """The port's stream ids (``<FAMILY>_STREAM_<draw>``), keyed by the JAX
    registry's names (``<FAMILY>_<draw>_STREAM``)."""
    out = {}
    for name, value in vars(common).items():
        family, sep, draw = name.partition("_STREAM_")
        if sep and family in ("ICWS", "CS", "JL", "SAMPLE", "DMH"):
            out[f"{family}_{draw}_STREAM"] = value
    return out


def test_stream_ids_and_sentinels_mirror_the_jax_registry():
    ported = common_streams()
    assert len(ported) == 18
    registry = jax_common.streams()
    for name, value in ported.items():
        assert registry[name] == value, name
    from repro.kernels.estimate import CORPUS_PAD_FP, QUERY_PAD_FP
    from repro.kernels.ref import BIG
    assert (common.QUERY_PAD_FP, common.CORPUS_PAD_FP) == (QUERY_PAD_FP,
                                                           CORPUS_PAD_FP)
    assert common.BIG == BIG


def test_linear_stream_ids_equal_the_registry_by_value():
    """The CountSketch bucket/sign and JL sign draws keep the registry's ids
    21, 22 and 31 (checked by value: a port source spelling a registry name
    would be listed in the generated stream table)."""
    registry = jax_common.streams()
    for port_name, draw in (("CS_STREAM_BUCKET", "CS_BUCKET"),
                            ("CS_STREAM_SIGN", "CS_SIGN"),
                            ("JL_STREAM_SIGN", "JL_SIGN")):
        assert getattr(common, port_name) == registry[draw + "_STREAM"]
    assert (common.CS_STREAM_BUCKET, common.CS_STREAM_SIGN,
            common.JL_STREAM_SIGN) == (21, 22, 31)


def test_dmh_and_sample_stream_ids_equal_the_registry_by_value():
    """The DMH draws keep the registry's ids 51-58 and the sample hash 41,
    in the kernels' map, the CUDA header and the host sampler alike."""
    registry = jax_common.streams()
    draws = ("BIN", "R1", "R2", "C1", "C2", "BETA", "FP", "DENSIFY")
    for i, draw in enumerate(draws):
        assert getattr(common, f"DMH_STREAM_{draw}") == \
            registry[f"DMH_{draw}_STREAM"] == 51 + i
    from repro.core import sampling as jax_sampling
    from repro_torch.core import sampling as port_sampling
    assert common.SAMPLE_STREAM_HASH == port_sampling.SAMPLE_STREAM_HASH \
        == registry["SAMPLE_HASH" + "_STREAM"] == 41
    assert port_sampling.SAMPLE_KEY_MASK == jax_sampling.SAMPLE_KEY_MASK
    header = (pathlib.Path(common.__file__).parent / "csrc" / "u32.cuh"
              ).read_text()
    for name, value in common_streams().items():
        family, draw = name[:-len("_STREAM")].split("_", 1)
        assert f"{family}_STREAM_{draw} = {value}u;" in header, name


@pytest.mark.parametrize("m", [1, 31, 64, 128, 200, 512, 4096])
def test_densify_probes_and_replication_match_jax(m):
    from repro.core import dmh as jax_dmh
    assert common.densify_probes(m) == jax_common.densify_probes(m)
    assert port_dmh.dmh_replication(m) == jax_dmh.dmh_replication(m)
    c = port_dmh.dmh_replication(m)
    k = _keys()[:100].reshape(4, 25)
    np.testing.assert_array_equal(port_dmh.replicate_keys(k, c),
                                  jax_dmh.replicate_keys(k, c))


def test_replica_salt_in_the_cuda_header_equals_the_port_and_jax():
    """The DMH kernels derive replica keys with ``u32.cuh``'s copy of the
    salt: the same value as ``repro_torch.core.dmh`` and the JAX package."""
    from repro.core import dmh as jax_dmh
    header = (pathlib.Path(common.__file__).parent / "csrc" / "u32.cuh"
              ).read_text()
    assert f"REPLICA_SALT = 0x{port_dmh.REPLICA_SALT:08X}u;" in header
    assert port_dmh.REPLICA_SALT == jax_dmh.REPLICA_SALT


@pytest.mark.parametrize("seed", [0, 2 ** 32 - 1])
def test_port_numpy_mixers_match_the_jax_host_twins(seed):
    k = _keys()
    t = np.arange(k.size, dtype=np.uint32) % 700
    salt = port_host_u32.salt_for(seed, 41, t)
    np.testing.assert_array_equal(salt, host_u32.salt_for(seed, 41, t))
    np.testing.assert_array_equal(port_host_u32.mix32(k), host_u32.mix32(k))
    np.testing.assert_array_equal(port_host_u32.hash_u32(k, salt),
                                  host_u32.hash_u32(k, salt))
    u = port_host_u32.uniform01(k, salt)
    assert u.dtype == np.float32
    np.testing.assert_array_equal(u, host_u32.uniform01(k, salt))
