"""The port's corpus-sharding rules and meshes against the JAX package:
``DEFAULT_RULES`` equal by value, ``corpus_axis``, ``axis_size`` and
``make_rules`` equal to JAX's on the same mesh shapes (JAX's functions
read only ``mesh.shape``), the mesh helpers' shapes, and the row-shard
helper's split, pad and gather."""
import types

import pytest
import torch

from repro.distributed import sharding as jax_sharding
from repro_torch.distributed import sharding
from repro_torch.launch import CorpusMesh, make_corpus_mesh, make_host_mesh

torch.set_num_threads(1)


def test_default_rules_equal_jax_by_value():
    assert sharding.DEFAULT_RULES == jax_sharding.DEFAULT_RULES
    assert sharding.make_rules(corpus="model", seq="data") == \
        jax_sharding.make_rules(corpus="model", seq="data")


@pytest.mark.parametrize("shape, rules, want", [
    (None, None, None),                                   # no mesh
    ({"data": 1}, None, None),                            # size 1
    ({"data": 1, "model": 4}, None, None),
    ({"data": 2}, None, "data"),
    ({"model": 4}, None, None),                           # axis absent
    ({"pod": 1, "data": 3}, {"corpus": ("pod", "data")}, "data"),
    ({"pod": 2, "data": 2}, {"corpus": ("pod", "data")}, "pod"),
    ({"data": 2}, {"corpus": None}, None),                # unmapped
    ({"data": 2, "model": 4}, {"corpus": "model"}, "model"),
])
def test_corpus_axis_resolves_as_jax(shape, rules, want):
    mesh = None if shape is None else types.SimpleNamespace(shape=shape)
    port_rules = sharding.make_rules(**rules) if rules else None
    jax_rules = jax_sharding.make_rules(**rules) if rules else None
    assert sharding.corpus_axis(mesh, port_rules) == want
    assert jax_sharding.corpus_axis(mesh, jax_rules) == want
    if mesh is not None:
        for axes in (None, "data", ("pod", "data"), ("data", "model")):
            assert sharding.axis_size(mesh, axes) == \
                jax_sharding.axis_size(mesh, axes)


def test_meshes_of_repeated_cpu_devices():
    cpu = torch.device("cpu")
    one = make_corpus_mesh(devices=("cpu",))
    assert one.shape == {"data": 1} and sharding.corpus_axis(one) is None
    three = make_corpus_mesh(devices=("cpu",) * 3)
    assert three.shape == {"data": 3} and three.axis_devices("data") == \
        (cpu,) * 3
    assert make_corpus_mesh(2, devices=("cpu",) * 3).shape == {"data": 2}
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_corpus_mesh(4, devices=("cpu",) * 2)
    host = make_host_mesh(2, 2, devices=("cpu",) * 4)
    assert host.shape == {"data": 2, "model": 2}
    assert sharding.corpus_axis(host) == "data"
    assert len(host.axis_devices("model")) == 2
    # more than there are: every device on the data axis, as in JAX
    assert make_host_mesh(4, 2, devices=("cpu",) * 3).shape == \
        {"data": 3, "model": 1}
    with pytest.raises(ValueError, match="grid"):
        CorpusMesh(("data",), ((cpu,), (cpu, cpu)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_corpus_mesh()


@pytest.mark.parametrize("rows, shards", [(7, 3), (8, 2), (5, 5)])
def test_shard_rows_pads_with_the_fill_and_gathers_back(rows, shards):
    x = torch.arange(2 * rows * 3, dtype=torch.int32).reshape(2, rows, 3)
    devs = (torch.device("cpu"),) * shards
    parts = sharding.shard_rows(x, devs, fill=-2)
    per = -(-rows // shards)
    assert [p.shape for p in parts] == [(2, per, 3)] * shards
    assert all(p.is_contiguous() for p in parts)
    back = sharding.gather_rows(parts, "cpu")
    assert torch.equal(back[:, :rows], x)
    assert (back[:, rows:] == -2).all()
    assert torch.equal(sharding.gather_rows(
        sharding.shard_rows(x, devs, fill=0, rows=4 * shards), "cpu")
        [:, :rows], x)
    with pytest.raises(ValueError, match="do not split"):
        sharding.shard_rows(x, devs, rows=shards * per + 1)
