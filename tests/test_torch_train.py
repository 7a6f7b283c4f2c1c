"""The port's training path (``repro_torch.train``, ``optim.adamw``,
``data.pipeline``, ``Model.loss``, the launcher) against the JAX package's
on the CPU, at ``tests/test_train_serve.py``'s tiny config.

Weights come from JAX's ``Model.init`` through
``convert.model_params_from_numpy``; batches from the shared
``token_stream``.  Tolerances, each with its reason:

* loss: ``TOL`` = 2^-6 of JAX's (``tests/test_torch_lm.py``'s tier; it
  agrees to about 1e-7 in practice);
* gradients: each leaf within ``GRAD_TOL`` = 2^-5 of its largest JAX
  magnitude (``tests/_torch_lm.py`` says why);
* two train steps: the bf16 moments within ``GRAD_TOL`` (they are
  gradients); each leaf's update (new parameters less the old) within
  ``GRAD_TOL`` of its largest JAX update on the entries whose first moment
  is at least ``WELL_POSED`` = 2^-4 of the leaf's largest -- AdamW divides
  the first moment by the root of the second, so where the moment is no
  larger than its own rounding (``GRAD_TOL`` of the largest) the move may
  go either way -- and at most ``ILL_SHARE`` = 5% of the other entries
  beyond it; ``grad_norm`` within 1e-3 relative,
  ``lr`` within ``LR_RTOL`` = 1e-6 relative (XLA's ``cos`` and torch's
  differ by a few f32 ulps), ``step`` exactly;
* eight ``Trainer`` steps: each loss within ``LOSS_RTOL`` relative.

The port's own resume runs bit for bit (JAX's test allows 2e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_lm import GRAD_TOL, TOL, as_f32, rel, tiny_cfg, trainer_config

from repro import configs as jax_configs
from repro.data.pipeline import TokenPipeline as JaxPipeline
from repro.data.synthetic import token_stream
from repro.models import Model as JaxModel
from repro.models import layers as jax_layers
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw as jax_adamw
from repro.train.step import make_train_step as jax_make_train_step
from repro.train.trainer import Trainer as JaxTrainer
from repro.train.trainer import TrainerConfig as JaxTrainerConfig
from repro_torch import configs
from repro_torch import tree as tr
from repro_torch.convert import model_params_from_numpy, opt_state_from_numpy
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models import Model
from repro_torch.models import layers
from repro_torch.optim import AdamWConfig, adamw
from repro_torch.train import loss_and_grads, make_eval_step, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig

# small shapes: one intra-op thread per test process, so that parallel
# test workers do not oversubscribe the cores
torch.set_num_threads(1)

LR_RTOL = 1e-6
WELL_POSED = 2 ** -4
ILL_SHARE = 0.05
LOSS_RTOL = 2e-3
OPT = dict(lr=2e-3, warmup_steps=4, total_steps=24)


def quiet(_):
    pass


class Pair:
    """The tiny config's JAX model and port model on JAX's weights."""

    def __init__(self, seed: int = 0):
        self.jcfg, self.cfg = tiny_cfg(jax_configs), tiny_cfg(configs)
        self.jm = JaxModel(self.jcfg)
        self.jp, _ = self.jm.init(jax.random.PRNGKey(seed))
        self.model = Model(self.cfg, device="cpu")
        self.params = model_params_from_numpy(
            self.cfg, jax.tree.map(np.asarray, self.jp), device="cpu")

    def batch(self, B=4, T=32, step=0, mask=False, M=None):
        toks = token_stream(0, step, B, T, self.cfg.vocab_size)
        b = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
        if mask:
            b["mask"] = (np.random.default_rng(step).random((B, T)) < 0.7
                         ).astype(np.float32)
        if M is not None:
            b = {k: v.reshape((M, B // M) + v.shape[1:]) for k, v in b.items()}
        return b


def tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def jax_tree(batch):
    return jax.tree.map(jnp.asarray, batch)


@pytest.fixture(scope="module")
def pair():
    return Pair()


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(dtype, masked):
    rng = np.random.default_rng(4)
    logits = (rng.normal(size=(3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.5).astype(np.float32) if masked else None
    jl = jnp.asarray(logits).astype(dtype)
    want = jax.jit(jax_layers.cross_entropy)(
        jl, jnp.asarray(labels), None if mask is None else jnp.asarray(mask))
    got = layers.cross_entropy(
        torch.from_numpy(np.array(jl, np.float32)).to(getattr(torch, dtype)),
        torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_cross_entropy_all_masked_is_zero():
    logits = torch.zeros((1, 2, 5))
    got = layers.cross_entropy(logits, torch.zeros((1, 2), dtype=torch.int32),
                               torch.zeros((1, 2)))
    assert float(got) == 0.0


@pytest.mark.parametrize("masked", [False, True])
def test_model_loss_matches_jax(pair, masked):
    b = pair.batch(mask=masked)
    want, wparts = jax.jit(lambda p, bb: pair.jm.loss(p, bb, q_chunk=32,
                                                      k_chunk=32))(
        pair.jp, jax_tree(b))
    with torch.no_grad():
        got, parts = pair.model.loss(pair.params, tensors(b), q_chunk=32,
                                     k_chunk=32)
    assert abs(float(got) - float(want)) <= TOL * abs(float(want))
    assert float(parts["ce"]) == float(got) and float(parts["aux"]) == 0.0


@pytest.mark.parametrize("masked", [False, True])
def test_gradients_per_leaf_match_jax_grad(pair, masked):
    b = pair.batch(mask=masked, step=1)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, bb: pair.jm.loss(p, bb, q_chunk=32, k_chunk=32)[0]))(
        pair.jp, jax_tree(b))
    loss, grads = loss_and_grads(pair.model, pair.params, tensors(b),
                                 q_chunk=32, k_chunk=32)
    assert abs(float(loss) - float(jl)) <= TOL * float(jl)
    grads = tr.leaves(grads)
    jflat = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert len(jflat) == len(grads)
    for (path, want), got in zip(jflat, grads):
        assert got.dtype == torch.float32
        assert rel(got, want) <= GRAD_TOL, (jax.tree_util.keystr(path),
                                            rel(got, want))


def test_init_tensors_take_requires_grad():
    model = Model(tiny_cfg(configs), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    for p in tr.leaves(params):
        assert not p.is_inference()
        p.requires_grad_()
    loss, _ = model.loss(params, {
        "tokens": torch.zeros((1, 4), dtype=torch.int32),
        "labels": torch.ones((1, 4), dtype=torch.int32)})
    loss.backward()
    assert all(p.grad is not None for p in tr.leaves(params))


def test_remat_recomputes_each_block(pair, monkeypatch):
    """Every block runs once forward and once more in the backward (the
    counterpart of ``jax.checkpoint``), and the gradients equal those of
    the same blocks run without checkpointing bit for bit."""
    from repro_torch.models import transformer
    calls = []
    block = Model._block

    def counted(self, *a):
        calls.append(torch.is_grad_enabled())
        return block(self, *a)
    monkeypatch.setattr(Model, "_block", counted)
    b = tensors(pair.batch(step=2))

    def grads():
        flat = [p.detach().requires_grad_() for p in tr.leaves(pair.params)]
        loss, _ = pair.model.loss(tr.unflatten(pair.params, flat), b,
                                  q_chunk=32, k_chunk=32)
        return torch.autograd.grad(loss, flat)
    remat = grads()
    L = pair.cfg.num_layers
    assert len(calls) == 2 * L
    monkeypatch.setattr(transformer, "checkpoint",
                        lambda fn, *a, **kw: fn(*a))
    plain = grads()
    assert all(torch.equal(x, y) for x, y in zip(remat, plain))


# ---------------------------------------------------------------------------
# AdamW and the train step
# ---------------------------------------------------------------------------
def test_schedule_and_global_norm_match_jax():
    jcfg, cfg = JaxAdamWConfig(**OPT), AdamWConfig(**OPT)
    sched = jax.jit(lambda s: jax_adamw.schedule(jcfg, s))
    for step in range(0, 30):
        want = float(sched(jnp.int32(step)))
        got = float(adamw.schedule(cfg, torch.tensor(step, dtype=torch.int32)))
        assert abs(got - want) <= LR_RTOL * want, step
    rng = np.random.default_rng(0)
    tree = {"b": rng.normal(size=(5, 3)).astype(np.float32),
            "a": {"y": rng.normal(size=7).astype(np.float32),
                  "x": rng.normal(size=(2, 2)).astype(np.float32)}}
    want = float(jax.jit(jax_adamw.global_norm)(tree))
    got = adamw.global_norm(tr.tree_map(torch.from_numpy, tree))
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


@pytest.mark.parametrize("M", [1, 2])
def test_train_step_matches_jax(pair, M):
    jcfg, cfg = JaxAdamWConfig(**OPT), AdamWConfig(**OPT)
    b = pair.batch(M=M, step=3)
    jstep = jax.jit(jax_make_train_step(pair.jm, jcfg, q_chunk=32, k_chunk=32))
    jopt = jax_adamw.init_opt_state(pair.jp, jcfg)
    step = make_train_step(pair.model, cfg, q_chunk=32, k_chunk=32)
    opt = adamw.init_opt_state(pair.params, cfg)
    jp, jo, tp, to = pair.jp, jopt, pair.params, opt
    for _ in range(2):
        jp, jo, jm = jstep(jp, jo, jax_tree(b))
        tp, to, tm = step(tp, to, tensors(b))
    for (path, want), got, p0, mu in zip(
            jax.tree_util.tree_flatten_with_path(jp)[0], tr.leaves(tp),
            tr.leaves(pair.params), jax.tree.leaves(jo["mu"])):
        want_up = as_f32(want) - as_f32(p0)
        off = np.abs(as_f32(got - p0) - want_up) > GRAD_TOL * np.abs(
            want_up).max()
        mu = np.abs(as_f32(mu))
        posed = mu >= WELL_POSED * mu.max()
        where = jax.tree_util.keystr(path)
        assert not (off & posed).any(), where
        assert off.mean() <= ILL_SHARE, (where, off.mean())
    for k in ("mu", "nu"):
        for want, got in zip(jax.tree.leaves(jo[k]), tr.leaves(to[k])):
            assert got.dtype == torch.bfloat16
            assert rel(got, want) <= GRAD_TOL, k
    assert int(to["step"]) == int(jo["step"]) == 2
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= TOL * float(jm["loss"])
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-3)
    assert abs(float(tm["lr"]) - float(jm["lr"])) <= LR_RTOL * float(jm["lr"])
    assert int(tm["step"]) == 2


def test_eval_step_is_the_loss(pair):
    b = tensors(pair.batch(step=4))
    out = make_eval_step(pair.model, q_chunk=32, k_chunk=32)(pair.params, b)
    with torch.no_grad():
        loss, _ = pair.model.loss(pair.params, b, q_chunk=32, k_chunk=32)
    assert set(out) == {"loss", "ce", "aux"}
    assert torch.equal(out["loss"], loss) and not out["loss"].requires_grad


def test_opt_state_carries_across(pair):
    jcfg = JaxAdamWConfig(**OPT)
    jstep = jax.jit(jax_make_train_step(pair.jm, jcfg, q_chunk=32, k_chunk=32))
    _, jo, _ = jstep(pair.jp, jax_adamw.init_opt_state(pair.jp, jcfg),
                     jax_tree(pair.batch(M=2)))
    opt = opt_state_from_numpy(pair.cfg, jax.tree.map(np.asarray, jo),
                               device="cpu")
    assert int(opt["step"]) == 1 and opt["step"].dtype == torch.int32
    for k in ("mu", "nu"):
        for want, got in zip(jax.tree.leaves(jo[k]), tr.leaves(opt[k])):
            assert got.dtype == torch.bfloat16
            assert np.array_equal(as_f32(got), as_f32(want))
    with pytest.raises(ValueError, match="keys"):
        opt_state_from_numpy(pair.cfg, {"mu": {}}, device="cpu")


# ---------------------------------------------------------------------------
# the pipeline: a copy over the port's token_stream
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(seed=3, global_batch=8, seq=16, vocab=100),
    dict(seed=5, global_batch=8, seq=8, vocab=50, num_hosts=2, host_id=1),
    dict(seed=1, global_batch=8, seq=12, vocab=64, microbatches=2,
         start_step=5)])
def test_pipeline_equals_jax_batch_for_batch(kw):
    pa, pb = JaxPipeline(**kw), TokenPipeline(**kw)
    try:
        for _ in range(4):
            a, b = next(pa), next(pb)
            assert a.keys() == b.keys() and a["step"] == b["step"]
            for k in ("tokens", "labels"):
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    finally:
        pa.close(), pb.close()


def test_pipeline_deterministic_and_resumable():
    kw = dict(seed=3, global_batch=8, seq=16, vocab=100)
    p1 = TokenPipeline(**kw)
    b1 = [next(p1) for _ in range(4)]
    p1.close()
    p2 = TokenPipeline(**kw, start_step=2)
    b2 = [next(p2) for _ in range(2)]
    p2.close()
    assert np.array_equal(b1[2]["tokens"], b2[0]["tokens"])
    assert np.array_equal(b1[3]["labels"], b2[1]["labels"])
    pa = TokenPipeline(**kw, num_hosts=2, host_id=0)
    pb = TokenPipeline(**kw, num_hosts=2, host_id=1)
    a, b = next(pa), next(pb)
    pa.close(), pb.close()
    assert a["tokens"].shape == (4, 16)
    assert np.array_equal(np.concatenate([a["tokens"], b["tokens"]]),
                          b1[0]["tokens"])


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------
def _port_trainer(cfg, tcfg, params=None):
    """A port Trainer; with ``params`` (a port tree) its initial weights
    are those instead of its own generator's draws."""
    trainer = Trainer(cfg, tcfg, log_fn=quiet, device="cpu")
    if params is not None:
        trainer.init_state = lambda generator=None: (
            params, adamw.init_opt_state(params, tcfg.opt))
    return trainer


def test_eight_trainer_steps_match_jax(pair):
    jt = JaxTrainer(pair.jcfg, trainer_config(JaxTrainerConfig,
                                              JaxAdamWConfig, steps=8),
                    log_fn=quiet)
    want = jt.run()["loss"]
    got = _port_trainer(pair.cfg, trainer_config(TrainerConfig, AdamWConfig,
                                                 steps=8),
                        pair.params).run()["loss"]
    assert len(got) == len(want) == 8
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_trainer_loss_decreases():
    hist = Trainer(tiny_cfg(configs), trainer_config(
        TrainerConfig, AdamWConfig, steps=30), log_fn=quiet,
        device="cpu").run()
    first = np.mean(hist["loss"][:5])
    last = np.mean(hist["loss"][-5:])
    assert last < first - 0.1, (first, last)
    assert np.isfinite(hist["grad_norm"]).all()


def test_trainer_checkpoint_resume_bitexact(tmp_path):
    """Crash/restart: resuming from a checkpoint replays the identical
    data stream and gives the identical losses and final state, bit for
    bit."""
    cfg = tiny_cfg(configs)

    def run(ckpt, steps, total_steps=None):
        t = Trainer(cfg, trainer_config(TrainerConfig, AdamWConfig, ckpt,
                                        steps=steps, total_steps=total_steps),
                    log_fn=quiet, device="cpu")
        return t, t.run()
    ta, hist_a = run(tmp_path / "a", 16)
    run(tmp_path / "b", 8, total_steps=16)
    tb, hist_b = run(tmp_path / "b", 16)
    assert hist_b["step"][0] == 8
    assert hist_a["loss"][8:] == hist_b["loss"]
    for x, y in zip(tr.leaves(ta.state), tr.leaves(tb.state)):
        assert torch.equal(x, y)


def test_trainer_preemption_checkpoints_and_stops(tmp_path):
    from repro_torch.checkpoint import latest_step
    trainer = Trainer(tiny_cfg(configs), trainer_config(
        TrainerConfig, AdamWConfig, tmp_path, steps=1000), log_fn=quiet,
        device="cpu")
    trainer.preemption.trigger_for_test()
    hist = trainer.run()
    assert len(hist["loss"]) <= 2
    assert latest_step(tmp_path) is not None


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def test_launcher_trains_the_reduced_config(capsys):
    from repro_torch.launch.train import main
    main(["--arch", "tinyllama-1.1b", "--steps", "3", "--global-batch", "4",
          "--seq", "16", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "final loss" in out and out.rstrip().endswith("on cpu")


@pytest.mark.parametrize("arch,error,match", [
    ("whisper-base", SystemExit, "token-stream trainer"),
    ("internvl2-1b", SystemExit, "token-stream trainer"),
    ("jamba-1.5-large-398b", NotImplementedError, "18c"),
    ("rwkv6-1.6b", NotImplementedError, "18c")])
def test_launcher_refuses_what_it_cannot_train(arch, error, match):
    from repro_torch.launch.train import main
    with pytest.raises(error, match=match):
        main(["--arch", arch, "--steps", "1", "--device", "cpu"])


def test_launcher_dry_run_raises():
    from repro_torch.launch.train import main
    with pytest.raises(NotImplementedError, match="XLA HLO"):
        main(["--arch", "tinyllama-1.1b", "--dry-run"])
