"""The port's checkpoints (``repro_torch.checkpoint``) on the CPU: JAX's
checkpoint cases run on the port, and checkpoints cross both ways between
the packages -- the port restores what JAX's ``Trainer`` wrote and
continues the run within the training tests' tolerance of JAX's own
continuation, and JAX's ``restore`` reads what the port wrote, bf16
moments included, bit for bit."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_lm import as_f32, tiny_cfg, trainer_config

from repro import checkpoint as jax_ckpt
from repro import configs as jax_configs
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw as jax_adamw
from repro.train.trainer import Trainer as JaxTrainer
from repro.train.trainer import TrainerConfig as JaxTrainerConfig
from repro_torch import configs
from repro_torch import tree as tr
from repro_torch.checkpoint import (AsyncCheckpointer, all_steps, latest_step,
                                    restore, save)
from repro_torch.optim import AdamWConfig, adamw
from repro_torch.train.trainer import Trainer, TrainerConfig

# small shapes: one intra-op thread per test process, so that parallel
# test workers do not oversubscribe the cores
torch.set_num_threads(1)

# losses of a continued run, as in tests/test_torch_train.py
LOSS_RTOL = 2e-3


def quiet(_):
    pass


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((4, 8), generator=g),
            "opt": {"mu": torch.zeros((4, 8), dtype=torch.bfloat16),
                    "step": torch.tensor(7, dtype=torch.int32)}}


def _zeros_like(tree):
    return tr.tree_map(torch.zeros_like, tree)


def test_checkpoint_roundtrip(tmp_path):
    tree = _tree()
    tree["opt"]["mu"] += torch.randn((4, 8)).to(torch.bfloat16)
    save(tmp_path, 10, tree, extra={"data_step": 10})
    restored, extra = restore(tmp_path, 10, _zeros_like(tree))
    assert extra["data_step"] == 10
    for a, b in zip(tr.leaves(tree), tr.leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_atomicity_ignores_partial(tmp_path):
    save(tmp_path, 1, _tree())
    (tmp_path / "step_2.tmp").mkdir()
    (tmp_path / "step_2.tmp" / "garbage.npy").write_bytes(b"xx")
    assert latest_step(tmp_path) == 1


def test_checkpoint_gc_and_async(tmp_path):
    ck = AsyncCheckpointer(tmp_path, keep=2)
    tree = _tree()
    for s in (1, 2, 3, 4):
        ck.save(s, tree)
    ck.wait()
    assert all_steps(tmp_path) == [3, 4]


def test_async_save_snapshots_before_returning(tmp_path):
    """The tree is copied when ``save`` returns: writing to the tensors
    afterwards changes nothing on disk."""
    ck = AsyncCheckpointer(tmp_path)
    tree = _tree()
    want = tree["w"].clone()
    ck.save(1, tree)
    tree["w"].zero_()
    ck.wait()
    got, _ = restore(tmp_path, 1, _zeros_like(tree))
    assert torch.equal(got["w"], want)


def test_checkpoint_shape_mismatch_raises(tmp_path):
    save(tmp_path, 1, {"w": torch.zeros((2, 2))})
    with pytest.raises(ValueError, match="shape mismatch"):
        restore(tmp_path, 1, {"w": torch.zeros((3, 3))})


def test_manifest_equals_jax_manifest(tmp_path):
    """The same (params, opt_state) tree saved by both packages: the same
    keys, files, shapes and dtypes, in the same order."""
    rng = np.random.default_rng(0)
    params = {"b": rng.normal(size=(3,)).astype(np.float32),
              "a": {"w": rng.normal(size=(2, 3)).astype(np.float32)}}
    jp = jax.tree.map(jnp.asarray, params)
    jtree = (jp, jax_adamw.init_opt_state(jp, JaxAdamWConfig()))
    tp = tr.tree_map(torch.from_numpy, params)
    ttree = (tp, adamw.init_opt_state(tp, AdamWConfig()))
    jax_ckpt.save(tmp_path / "jax", 3, jtree, extra={"data_step": 3})
    save(tmp_path / "port", 3, ttree, extra={"data_step": 3})
    j, p = (json.loads((tmp_path / d / "step_3" / "manifest.json").read_text())
            for d in ("jax", "port"))
    assert j == p
    assert [l["key"] for l in p["leaves"]] == [
        "0/a/w", "0/b", "1/mu/a/w", "1/mu/b", "1/nu/a/w", "1/nu/b", "1/step"]


def test_jax_restore_reads_a_port_checkpoint(tmp_path):
    cfg = tiny_cfg(configs)
    t = Trainer(cfg, trainer_config(TrainerConfig, AdamWConfig, tmp_path,
                                    steps=3), log_fn=quiet, device="cpu")
    t.run()
    jm_cfg = tiny_cfg(jax_configs)
    from repro.models import Model as JaxModel
    jp, _ = JaxModel(jm_cfg).init(jax.random.PRNGKey(0))
    target = (jp, jax_adamw.init_opt_state(jp, JaxAdamWConfig()))
    (rp, ro), extra = jax_ckpt.restore(tmp_path, 3, target)
    assert extra == {"data_step": 3}
    for want, got in zip(tr.leaves(t.state), jax.tree.leaves((rp, ro))):
        if want.dtype == torch.bfloat16:
            assert str(got.dtype) == "bfloat16"
        assert np.array_equal(as_f32(want), as_f32(got))


def test_port_continues_a_jax_checkpoint(tmp_path):
    """JAX's Trainer runs 4 of 8 steps and checkpoints; the port's
    Trainer restores that checkpoint and runs steps 4..7, within
    ``LOSS_RTOL`` of JAX's own continuation."""
    jcfg = tiny_cfg(jax_configs)
    JaxTrainer(jcfg, trainer_config(JaxTrainerConfig, JaxAdamWConfig,
                                    tmp_path / "jax", steps=4, total_steps=8),
               log_fn=quiet).run()
    import shutil
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    want = JaxTrainer(jcfg, trainer_config(
        JaxTrainerConfig, JaxAdamWConfig, tmp_path / "jax", steps=8),
        log_fn=quiet).run()
    got = Trainer(tiny_cfg(configs), trainer_config(
        TrainerConfig, AdamWConfig, tmp_path / "port", steps=8),
        log_fn=quiet, device="cpu").run()
    assert got["step"] == want["step"] == [4, 5, 6, 7]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
