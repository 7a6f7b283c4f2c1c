"""The port's model configs (``repro_torch.configs``) and parameter
counts (``repro_torch.models.counting``) against the JAX package's, by
value: every architecture's published and reduced config, the registry,
the shape suite and which (arch, shape) cells apply."""
import dataclasses

import pytest
import torch

from repro import configs as jax_configs
from repro.models import counting as jax_counting
from repro_torch import configs
from repro_torch.models import counting

# small shapes: one intra-op thread per test process, so that parallel
# test workers do not oversubscribe the cores
torch.set_num_threads(1)


def test_registry_lists_the_same_architectures_in_order():
    assert configs.ARCHS == jax_configs.ARCHS
    assert len(configs.ARCHS) == 10
    assert list(configs.all_configs()) == list(jax_configs.all_configs())


@pytest.mark.parametrize("arch", jax_configs.ARCHS)
def test_configs_equal_by_value(arch):
    for mine, theirs in ((configs.get(arch), jax_configs.get(arch)),
                         (configs.reduced(arch), jax_configs.reduced(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert type(mine).__name__ == type(theirs).__name__ == "ModelConfig"
        for prop in ("dt_rank", "q_per_kv", "attention_free",
                     "subquadratic"):
            assert getattr(mine, prop) == getattr(theirs, prop), prop
    assert configs.all_configs()[arch] == configs.get(arch)


@pytest.mark.parametrize("arch", jax_configs.ARCHS)
def test_param_counts_equal_jax(arch):
    for mine, theirs in ((configs.get(arch), jax_configs.get(arch)),
                         (configs.reduced(arch), jax_configs.reduced(arch))):
        assert counting.count_params(mine) == jax_counting.count_params(
            theirs) == mine.param_count()
        assert counting.count_active_params(
            mine) == jax_counting.count_active_params(
                theirs) == mine.active_param_count()


def test_shapes_and_cells_equal_jax():
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jax_configs.SHAPES.items()}
    for arch in jax_configs.ARCHS:
        for name in jax_configs.SHAPES:
            assert configs.cell_applicable(
                configs.get(arch), configs.SHAPES[name]
            ) == jax_configs.cell_applicable(jax_configs.get(arch),
                                             jax_configs.SHAPES[name])
    # tinyllama is pure full attention: no 500k decode cell
    ok, why = configs.cell_applicable(configs.get("tinyllama-1.1b"),
                                      configs.SHAPES["long_500k"])
    assert not ok and "sub-quadratic" in why
