"""The port's MoE family (``repro_torch.models.moe``, ``Model`` with
``family="moe"``) against the JAX package's jitted program on the CPU, at
the reduced configs of qwen3-moe-30b-a3b and mixtral-8x22b: ``moe_ffn``
(ample capacity, dropped slots, router ties, the load-balance loss), the
router at qwen3-moe-30b-a3b's full widths, forward, loss and gradients,
the KV-cache decode (full and windowed), decode against the port's own
forward, the ``ServeEngine``, the ``Trainer``, checkpoints both ways, the
weight carry and the launchers.

Weights come from JAX's ``init`` through ``convert.model_params_from_numpy``;
inputs from numpy seeds.  Tolerances (``tests/_torch_lm.py``'s tiers): the
MoE output and the logits within ``TOL`` = 2^-6 of the largest JAX
magnitude with ``SHARE`` of the values bit for bit (the port follows
XLA's compiled rounding: nearly every value is JAX's); the load-balance
loss within ``AUX_RTOL`` = 1e-6 relative (f32 sums in another order); the
loss within ``TOL`` relative; each gradient leaf within ``GRAD_TOL`` =
2^-5 of its largest JAX magnitude; Trainer losses within ``LOSS_RTOL`` =
2e-3 relative (``tests/test_torch_train.py``'s); expert choices equal to
JAX's except at near ties (``route_flips``: the reference's k-th and
(k+1)-th probabilities within ``ROUTE_MARGIN`` = 2^-6 of the k-th),
counted and printed; the dropped-slot set equal.
"""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_lm import (GRAD_TOL, TOL, Recorded, as_f32, assert_close,
                       near_tie_rows, rel, route_flips, to_torch)

from repro import checkpoint as jax_ckpt
from repro import configs as jax_configs
from repro.models import Model as JaxModel
from repro.models import moe as jax_moe
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw as jax_adamw
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro.train.trainer import Trainer as JaxTrainer
from repro.train.trainer import TrainerConfig as JaxTrainerConfig
from repro_torch import configs
from repro_torch import tree as tr
from repro_torch.convert import model_params_from_numpy, opt_state_from_numpy
from repro_torch.models import Model, count_params, moe
from repro_torch.models.transformer import check_fits
from repro_torch.optim import AdamWConfig, adamw
from repro_torch.serve import Request, ServeEngine
from repro_torch.train import loss_and_grads
from repro_torch.train.trainer import Trainer, TrainerConfig

# small shapes: one intra-op thread per test process, so that parallel
# test workers do not oversubscribe the cores
torch.set_num_threads(1)

MOE = ("qwen3-moe-30b-a3b", "mixtral-8x22b")
VLM = "internvl2-1b"
AUX_RTOL = 1e-6
LOSS_RTOL = 2e-3
STEPS = 12


def quiet(_):
    pass


def both_cfgs(arch: str, **kw):
    return (dataclasses.replace(jax_configs.reduced(arch), **kw),
            dataclasses.replace(configs.reduced(arch), **kw))


def jax_route(params, x, cfg):
    """JAX's router as ``repro/models/moe.py::moe_ffn`` computes it (its
    first lines, jitted): ``(probs, top_e)``."""
    def f(w, x):
        logits = (x @ w.astype(x.dtype)).astype(jnp.float32)
        probs = jax.nn.softmax(logits, axis=-1)
        return probs, jax.lax.top_k(probs, cfg.num_experts_per_tok)[1]
    return jax.jit(f)(params["w_router"], x)


def moe_inputs(cfg, N: int, seed: int, scale: float = 1.0):
    x = scale * np.random.default_rng(seed).standard_normal((N, cfg.d_model))
    return jnp.asarray(x, jnp.bfloat16)


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,cf", [
    ("qwen3-moe-30b-a3b", 1.25), ("qwen3-moe-30b-a3b", 16.0),
    ("mixtral-8x22b", 1.25)])
def test_moe_ffn_matches_jax(arch, cf):
    jcfg, cfg = both_cfgs(arch, capacity_factor=cf)
    jp, _ = jax_moe.init_moe(jax.random.PRNGKey(0), jcfg)
    x = moe_inputs(cfg, 64, 1)
    want, jaux = jax.jit(lambda p, x: jax_moe.moe_ffn(p, x, jcfg))(jp, x)
    params = {k: to_torch(v) for k, v in jp.items()}
    with moe.record_routes() as routes:
        got, aux = moe.moe_ffn(params, to_torch(x), cfg)
    assert got.dtype == torch.bfloat16 and aux.dtype == torch.float32
    assert_close(got, want, "moe_ffn", 0.99)
    assert abs(float(aux) - float(jaux)) <= AUX_RTOL * float(jaux)
    probs, top_e = jax_route(jp, x, jcfg)
    (got_e, got_probs), = routes
    assert len(route_flips(got_e, top_e, probs, cfg.num_experts_per_tok)) == 0
    assert rel(got_probs, probs) <= 1e-6


def test_moe_matches_dense_computation_when_capacity_ample():
    """The counterpart of ``tests/test_models.py``'s dense oracle: f32
    tokens (the whole FFN then runs in f32, as JAX's test runs it), every
    token through its top-k experts, weighted (JAX's tolerance, 2e-2)."""
    _, cfg = both_cfgs("qwen3-moe-30b-a3b", capacity_factor=16.0)
    params = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    xf = torch.from_numpy(np.random.default_rng(1).normal(
        size=(24, cfg.d_model)).astype(np.float32))
    y, aux = moe.moe_ffn(params, xf, cfg)
    assert y.dtype == torch.float32
    probs = torch.softmax(xf @ params["w_router"], dim=-1)
    top_p, top_e = torch.topk(probs, cfg.num_experts_per_tok)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    want = torch.zeros_like(xf)
    for i in range(xf.shape[0]):
        for j in range(cfg.num_experts_per_tok):
            e = int(top_e[i, j])
            h = xf[i] @ params["w_gate"][e]
            u = xf[i] @ params["w_up"][e]
            want[i] += top_p[i, j] * ((h * torch.sigmoid(h) * u)
                                      @ params["w_down"][e])
    np.testing.assert_allclose(y.float().numpy(), want.numpy(), rtol=2e-2,
                               atol=2e-2)
    assert float(aux) > 0


def _jax_keep(jp, x, jcfg):
    """JAX's kept-slot mask ``[N * k]`` from its own ``_dispatch_block``,
    on its router's choices."""
    E, k = jcfg.num_experts, jcfg.num_experts_per_tok
    C = max(int(np.ceil(x.shape[0] * k / E * jcfg.capacity_factor)), 4)

    def f(p, x):
        probs, top_e = jax_route(p, x, jcfg)
        top_p = jnp.take_along_axis(probs, top_e, axis=-1)
        return jax_moe._dispatch_block(x, top_p, top_e, E, k, C)[1][3]
    return np.asarray(jax.jit(f)(jp, x)), C


@pytest.mark.parametrize("case", ["identical tokens", "random tokens"])
def test_dropped_slot_set_equals_jax(case):
    """Capacity overflow drops the same slots as JAX's (GShard's position
    priority: the later tokens of a hot expert), and a token whose every
    slot is dropped gets a zero output in both (``tests/test_models.py``'s
    identical-token case)."""
    jcfg, cfg = both_cfgs("qwen3-moe-30b-a3b", capacity_factor=0.25)
    jp, _ = jax_moe.init_moe(jax.random.PRNGKey(0), jcfg)
    if case == "identical tokens":
        x = jnp.ones((64, cfg.d_model), jnp.bfloat16)
    else:
        x = moe_inputs(cfg, 64, 7, scale=3.0)
    want, _ = jax.jit(lambda p, x: jax_moe.moe_ffn(p, x, jcfg))(jp, x)
    keep_jax, C = _jax_keep(jp, x, jcfg)
    params = {k: to_torch(v) for k, v in jp.items()}
    got, _ = moe.moe_ffn(params, to_torch(x), cfg)
    _, _, top_e = moe.route(params, to_torch(x), cfg)
    pos = moe._positions_in_expert(top_e.reshape(-1), cfg.num_experts)
    keep = (pos < moe.capacity(x.shape[0], cfg)).numpy()
    assert moe.capacity(x.shape[0], cfg) == C
    assert not keep.all() and np.array_equal(keep, keep_jax)
    zero_jax = np.abs(as_f32(want)).max(-1) == 0
    assert np.array_equal(got.float().abs().amax(-1).numpy() == 0, zero_jax)
    if case == "identical tokens":
        assert zero_jax.sum() > 0
    assert_close(got, want, "moe_ffn with drops", 0.99)


def test_router_ties_go_to_the_lower_expert():
    """Exactly tied router probabilities: ``lax.top_k`` keeps the lower
    expert index, and so does the port (``torch.topk`` does not promise
    it).  All-zero router weights tie every expert; equal columns tie two
    of them across the k-th place."""
    jcfg, cfg = both_cfgs("qwen3-moe-30b-a3b")
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    x = moe_inputs(cfg, 16, 3)
    rng = np.random.default_rng(4)
    w = rng.standard_normal((cfg.d_model, E)).astype(np.float32) / 8
    w[:, 6] = w[:, 2]                    # experts 2 and 6 tie on every row
    w[:, 4] = w[:, 2] + 1.0              # expert 4 first on most rows
    for router in (np.zeros((cfg.d_model, E), np.float32), w):
        p = {"w_router": jnp.asarray(router)}
        probs, want = jax_route(p, x, jcfg)
        _, _, got = moe.route({"w_router": torch.from_numpy(router)},
                              to_torch(x), cfg)
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(moe.route({"w_router": torch.zeros(
        (cfg.d_model, E))}, to_torch(x), cfg)[2].numpy(),
        np.tile(np.arange(k), (16, 1)))
    ties = np.asarray(probs)[:, 2] == np.asarray(probs)[:, 6]
    assert ties.all() and (np.asarray(want) == 2).any()


def test_router_at_full_width_matches_jax():
    """qwen3-moe-30b-a3b's router at its published widths (d 2,048, 128
    experts, top 8) on 512 tokens: the f32 logits of bf16 inputs, as the
    jitted program keeps them, choose JAX's experts on every row but near
    ties (none expected: an f32 product summed in another order moves a
    logit by about 1e-7 of itself)."""
    cfg = configs.get("qwen3-moe-30b-a3b")
    rng = np.random.default_rng(5)
    w = (rng.standard_normal((cfg.d_model, cfg.num_experts))
         / np.sqrt(cfg.d_model)).astype(np.float32)
    x = moe_inputs(cfg, 512, 6)
    probs, want = jax_route({"w_router": jnp.asarray(w)}, x, cfg)
    got_probs, _, got = moe.route({"w_router": torch.from_numpy(w)},
                                  to_torch(x), cfg)
    flips = route_flips(got, want, probs, cfg.num_experts_per_tok)
    print(f"router at full width: {len(flips)} of 512 rows routed apart, "
          "each at a near tie")
    assert len(flips) <= 2
    assert rel(got_probs, probs) <= 1e-5


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
class Pair:
    """One architecture's JAX model and port model on the same weights."""

    def __init__(self, arch: str, seed: int = 1, **kw):
        self.jcfg, self.cfg = both_cfgs(arch, **kw)
        self.jm = JaxModel(self.jcfg)
        self.jp, _ = self.jm.init(jax.random.PRNGKey(seed))
        self.model = Model(self.cfg, device="cpu")
        self.params = model_params_from_numpy(
            self.cfg, jax.tree.map(np.asarray, self.jp), device="cpu")

    def tokens(self, B: int, T: int, seed: int = 2) -> np.ndarray:
        rng = np.random.default_rng(seed)
        return rng.integers(0, self.cfg.vocab_size, (B, T)).astype(np.int32)


@pytest.fixture(scope="module")
def pair():
    cache = {}

    def get(arch, **kw):
        key = (arch, tuple(sorted(kw.items())))
        if key not in cache:
            cache[key] = Pair(arch, **kw)
        return cache[key]
    return get


@pytest.mark.parametrize("arch", MOE)
def test_forward_loss_and_gradients_match_jax(pair, arch):
    p = pair(arch)
    toks = p.tokens(2, 17)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    want, jaux = jax.jit(lambda prm, bb: p.jm.forward(prm, bb))(
        p.jp, {"tokens": jnp.asarray(b["tokens"])})
    with torch.no_grad():
        got, aux = p.model.forward(p.params,
                                   {"tokens": torch.from_numpy(b["tokens"])})
    assert_close(got, want, "forward logits")
    assert abs(float(aux) - float(jaux)) <= AUX_RTOL * float(jaux)
    (jl, jparts), jg = jax.jit(jax.value_and_grad(
        lambda prm, bb: p.jm.loss(prm, bb, q_chunk=16, k_chunk=16),
        has_aux=True))(p.jp, jax.tree.map(jnp.asarray, b))
    loss, grads = loss_and_grads(p.model, p.params, {
        k: torch.from_numpy(v) for k, v in b.items()}, q_chunk=16, k_chunk=16)
    assert abs(float(loss) - float(jl)) <= TOL * float(jl)
    _, parts = p.model.loss(p.params, {k: torch.from_numpy(v)
                                       for k, v in b.items()})
    assert abs(float(parts["aux"]) - float(jparts["aux"])) <= \
        AUX_RTOL * float(jparts["aux"])
    jflat = jax.tree_util.tree_flatten_with_path(jg)[0]
    grads = tr.leaves(grads)
    assert len(jflat) == len(grads)
    for (path, want_g), got_g in zip(jflat, grads):
        assert rel(got_g, want_g) <= GRAD_TOL, (jax.tree_util.keystr(path),
                                                rel(got_g, want_g))


def test_vlm_forward_loss_and_gradients_match_jax(pair):
    """internvl2-1b's reduced config: the patch embeddings projected and
    put before the tokens, logits over both, the loss on the text
    positions only; logits within ``TOL`` with ``SHARE`` bit for bit, the
    loss within ``TOL`` relative, each gradient leaf (``patch_proj``'s
    included) within ``GRAD_TOL``."""
    p = pair(VLM)
    toks = p.tokens(2, 17)
    patches = np.random.default_rng(3).standard_normal(
        (2, p.cfg.num_patches, p.cfg.d_model)).astype(np.float32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "patches": patches}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    want, jaux = jax.jit(lambda prm, bb: p.jm.forward(prm, bb))(
        p.jp, jax.tree.map(jnp.asarray, b))
    with torch.no_grad():
        got, aux = p.model.forward(p.params, tb)
    assert got.shape == (2, p.cfg.num_patches + 16, p.cfg.vocab_size)
    assert_close(got, want, "vlm logits")
    assert float(aux) == float(jaux) == 0.0
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda prm, bb: p.jm.loss(prm, bb, q_chunk=8, k_chunk=8),
        has_aux=True))(p.jp, jax.tree.map(jnp.asarray, b))
    loss, grads = loss_and_grads(p.model, p.params, tb, q_chunk=8, k_chunk=8)
    assert abs(float(loss) - float(jl)) <= TOL * float(jl)
    jflat = jax.tree_util.tree_flatten_with_path(jg)[0]
    grads = tr.leaves(grads)
    assert len(jflat) == len(grads)
    for (path, want_g), got_g in zip(jflat, grads):
        assert rel(got_g, want_g) <= GRAD_TOL, (jax.tree_util.keystr(path),
                                                rel(got_g, want_g))


def test_replayed_routes_give_the_recorded_run(pair):
    """``replay_routes`` makes a run take a recorded run's experts, the
    forward's and the backward's recomputed ones (the card's gradient step
    in ``chip_smoke.py`` replays the CPU's): replaying a run's own routes
    gives its loss and gradients bit for bit; replaying other routes moves
    the loss, and the replayed experts are the ones taken."""
    p = pair("qwen3-moe-30b-a3b")
    toks = torch.from_numpy(p.tokens(2, 17))
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    with moe.record_routes() as routes:
        loss, grads = loss_and_grads(p.model, p.params, b)
    assert len(routes) == 2 * p.cfg.num_layers     # forward, recomputed
    with moe.replay_routes(routes), moe.record_routes() as again:
        loss2, grads2 = loss_and_grads(p.model, p.params, b)
    assert torch.equal(loss, loss2)
    assert all(torch.equal(x, y) for x, y in zip(tr.leaves(grads),
                                                 tr.leaves(grads2)))
    other = [((e + 1) % p.cfg.num_experts, q) for e, q in routes]
    with moe.replay_routes(other), moe.record_routes() as taken:
        loss3, _ = loss_and_grads(p.model, p.params, b)
    assert all(torch.equal(e, t) for (e, _), (t, _) in zip(other, taken))
    assert len(again) == len(taken) == len(routes)
    assert float(loss3) != float(loss)


def _decode_both(p, B: int, max_seq: int, steps: int):
    """``steps`` decode steps of both models on the same tokens: each
    step's logits within ``TOL`` and ``SHARE`` of all of them bit for bit
    (one bf16 step of one value in a step's last layer moves most of that
    step's logits: mixtral-8x22b has a step at 0.727 between steps at
    1.0), each step's caches within ``TOL`` with ``SHARE`` bit for bit,
    positions and slot tables exactly."""
    toks = p.tokens(B, steps, seed=6)
    jstep = jax.jit(lambda prm, t, s: p.jm.decode_step(prm, t, s))
    jstate, _ = p.jm.init_decode_state(B, max_seq)
    state = p.model.init_decode_state(B, max_seq)
    wants, gots = [], []
    for t in range(steps):
        want, jstate = jstep(p.jp, jnp.asarray(toks[:, t:t + 1]), jstate)
        got, state = p.model.decode_step(
            p.params, torch.from_numpy(toks[:, t:t + 1]), state)
        assert_close(got, want, f"logits at step {t}", 0.0)
        wants.append(as_f32(want))
        gots.append(as_f32(got))
        for name in ("k", "v"):
            assert_close(state["kv"][name], jstate["kv"][name],
                         f"{name} cache at step {t}")
        assert int(state["pos"]) == int(jstate["pos"]) == t + 1
        assert np.array_equal(state["slot_pos"].numpy(),
                              np.asarray(jstate["slot_pos"]))
    assert_close(np.stack(gots), np.stack(wants), "logits of every step")
    return state


@pytest.mark.parametrize("arch", MOE + (VLM,))
def test_decode_matches_jax(pair, arch):
    state = _decode_both(pair(arch), B=2, max_seq=32, steps=STEPS)
    size = state["slot_pos"].shape[0]
    assert state["slot_pos"].tolist() == list(range(STEPS)) + \
        [-1] * (size - STEPS)


def test_windowed_decode_matches_jax(pair):
    """mixtral-8x22b's reduced sliding window of 16 under ``max_seq`` 32:
    the circular cache of 16 slots, decoded 20 steps, past its window."""
    state = _decode_both(pair("mixtral-8x22b"), B=2, max_seq=32, steps=20)
    assert state["kv"]["k"].shape[2] == 16
    assert sorted(state["slot_pos"].tolist()) == list(range(4, 20))


@pytest.mark.parametrize("arch", MOE)
def test_decode_equals_parallel_forward(pair, arch):
    """The port's incremental decode == its parallel forward within JAX's
    own gate (``tests/test_models.py``: rel < 0.06, capacity_factor 8 so
    that the forward drops no token)."""
    p = pair(arch, capacity_factor=8.0)
    toks = torch.from_numpy(p.tokens(1, STEPS))
    par, _ = p.model.forward(p.params, {"tokens": toks})
    state = p.model.init_decode_state(1, 32)
    inc = []
    for t in range(STEPS):
        lg, state = p.model.decode_step(p.params, toks[:, t:t + 1], state)
        inc.append(lg[:, 0])
    pa, pi = as_f32(par), as_f32(torch.stack(inc, dim=1))
    assert np.abs(pa - pi).max() / (np.abs(pa).max() + 1e-9) < 0.06


@pytest.mark.parametrize("arch", MOE + (VLM,))
def test_init_matches_the_param_count(arch):
    cfg = configs.reduced(arch)
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    ffn = "moe" if cfg.family == "moe" else "mlp"
    assert set(params["layers"]) == {"attn", "norm1", "norm2", ffn}
    assert ("patch_proj" in params) == (cfg.family == "vlm")
    leaves = tr.leaves(params)
    assert all(a.dtype == torch.float32 for a in leaves)
    assert sum(a.numel() for a in leaves) == count_params(cfg)
    if cfg.family == "moe":
        assert params["layers"]["moe"]["w_gate"].shape == (
            cfg.num_layers, cfg.num_experts, cfg.d_model, cfg.d_ff)
    else:
        assert params["patch_proj"].shape == (cfg.d_model, cfg.d_model)


def test_params_from_numpy_carries_moe_leaves_and_rejects_a_wrong_tree():
    cfg = configs.reduced("qwen3-moe-30b-a3b")
    tree = jax.tree.map(np.asarray, JaxModel(jax_configs.reduced(
        "qwen3-moe-30b-a3b")).init(jax.random.PRNGKey(0))[0])
    params = model_params_from_numpy(cfg, tree, device="cpu")
    assert torch.equal(params["layers"]["moe"]["w_down"],
                       torch.from_numpy(np.array(tree["layers"]["moe"][
                           "w_down"])))
    with pytest.raises(ValueError, match="keys"):
        model_params_from_numpy(configs.reduced("tinyllama-1.1b"), tree,
                                device="cpu")
    with pytest.raises(ValueError, match="keys"):
        model_params_from_numpy(configs.reduced("mixtral-8x22b"), {
            **tree, "patch_proj": np.zeros((64, 64), np.float32)},
            device="cpu")
    tree["layers"]["moe"]["w_up"] = tree["layers"]["moe"]["w_up"][:, :3]
    with pytest.raises(ValueError, match="layers/moe/w_up: shape"):
        model_params_from_numpy(cfg, tree, device="cpu")


def test_full_configs_are_refused_where_their_parameters_do_not_fit():
    """``Model.init`` on the card checks the f32 parameters against the
    free memory before it allocates: all 48 layers of qwen3-moe-30b-a3b
    (30.5 B parameters, 122 GB) do not fit an 80 GB card, 8 of them do."""
    full = configs.get("qwen3-moe-30b-a3b")
    with pytest.raises(MemoryError, match=f"{4 * count_params(full):,} bytes"):
        check_fits(full, 80 * 10 ** 9)
    check_fits(dataclasses.replace(full, num_layers=8), 80 * 10 ** 9)
    check_fits(configs.get("tinyllama-1.1b"), 80 * 10 ** 9)


# ---------------------------------------------------------------------------
# serving, training, checkpoints
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", VLM])
def test_engine_tokens_equal_jax(pair, arch):
    """6 requests on 4 slots (the card run's shape) through both engines on
    the reduced config (a vlm's engine decodes text only, as JAX's):
    logits within ``TOL`` each tick, tokens equal but at a near tie."""
    p = pair(arch)
    recs = (Recorded(JaxEngine(p.jm, p.jp, batch_slots=4, max_seq=64)),
            Recorded(ServeEngine(p.model, p.params, batch_slots=4,
                                 max_seq=64)))
    outs = []
    for rec, make in zip(recs, (JaxRequest, Request)):
        reqs = [make(rid=i, prompt=[1 + i, 2 + i], max_new_tokens=8)
                for i in range(6)]
        for r in reqs:
            rec.engine.submit(r)
        for _ in range(200):
            if all(r.done for r in reqs):
                break
            rec.engine.tick()
        assert all(r.done and len(r.output) == 8 for r in reqs)
        outs.append([r.output for r in reqs])
    assert len(recs[0].logits) == len(recs[1].logits)
    for tick, (want, got) in enumerate(zip(recs[0].logits, recs[1].logits)):
        assert rel(got, want) <= TOL, (tick, rel(got, want))
        if near_tie_rows(got, want).size:
            print(f"near tie at tick {tick}: tokens compared up to it")
            return
    assert outs[0] == outs[1]


def _trainer_cfg(make, AdamW, tmp=None, steps=8, total_steps=None):
    return make(steps=steps, global_batch=4, seq=32, microbatches=2,
                ckpt_dir=str(tmp) if tmp else None, ckpt_every=4,
                log_every=100, opt=AdamW(lr=2e-3, warmup_steps=4,
                                         total_steps=total_steps or steps))


def test_eight_trainer_steps_match_jax(pair):
    """qwen3-moe-30b-a3b's reduced config through both Trainers from JAX's
    weights (its ``init`` at the Trainer's seed, 0): the eight losses
    (cross entropy plus the load-balance loss) within ``LOSS_RTOL``."""
    p = pair("qwen3-moe-30b-a3b", seed=0)
    want = JaxTrainer(p.jcfg, _trainer_cfg(JaxTrainerConfig, JaxAdamWConfig),
                      log_fn=quiet).run()["loss"]
    tcfg = _trainer_cfg(TrainerConfig, AdamWConfig)
    trainer = Trainer(p.cfg, tcfg, log_fn=quiet, device="cpu")
    trainer.init_state = lambda generator=None: (
        p.params, adamw.init_opt_state(p.params, tcfg.opt))
    got = trainer.run()["loss"]
    assert len(got) == len(want) == 8
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_moe_checkpoints_cross_both_ways(tmp_path):
    """mixtral-8x22b's reduced config: JAX's ``restore`` reads the port's
    checkpoint bit for bit (the moe leaves, bf16 moments included), and
    the port continues JAX's checkpoint within ``LOSS_RTOL`` of JAX's own
    continuation."""
    jcfg, cfg = both_cfgs("mixtral-8x22b")
    t = Trainer(cfg, _trainer_cfg(TrainerConfig, AdamWConfig,
                                  tmp_path / "port", steps=2),
                log_fn=quiet, device="cpu")
    t.run()
    jp, _ = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    target = (jp, jax_adamw.init_opt_state(jp, JaxAdamWConfig()))
    (rp, ro), extra = jax_ckpt.restore(tmp_path / "port", 2, target)
    assert extra == {"data_step": 2}
    assert set(rp["layers"]) == {"attn", "norm1", "norm2", "moe"}
    for want, got in zip(tr.leaves(t.state), jax.tree.leaves((rp, ro))):
        assert np.array_equal(as_f32(want), as_f32(got))
    opt = opt_state_from_numpy(cfg, jax.tree.map(np.asarray, ro),
                               device="cpu")
    assert torch.equal(opt["mu"]["layers"]["moe"]["w_router"],
                       t.state[1]["mu"]["layers"]["moe"]["w_router"])

    JaxTrainer(jcfg, _trainer_cfg(JaxTrainerConfig, JaxAdamWConfig,
                                  tmp_path / "jax", steps=4, total_steps=8),
               log_fn=quiet).run()
    shutil.copytree(tmp_path / "jax", tmp_path / "cont")
    want = JaxTrainer(jcfg, _trainer_cfg(JaxTrainerConfig, JaxAdamWConfig,
                                         tmp_path / "jax"),
                      log_fn=quiet).run()
    got = Trainer(cfg, _trainer_cfg(TrainerConfig, AdamWConfig,
                                    tmp_path / "cont"),
                  log_fn=quiet, device="cpu").run()
    assert got["step"] == want["step"] == [4, 5, 6, 7]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("arch", MOE + (VLM,))
def test_launchers_serve_and_train_moe_on_the_cpu(arch, capsys):
    """Both launchers on the reduced config; a vlm is served (text only),
    and the training launcher refuses it, as JAX's does."""
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.launch import train as train_launcher
    serve_launcher.main(["--arch", arch, "--requests", "3", "--slots", "2",
                         "--max-new-tokens", "4", "--device", "cpu"])
    assert f"{arch}: served 3 requests / 12 tokens" in \
        capsys.readouterr().out
    argv = ["--arch", arch, "--steps", "3", "--global-batch", "4", "--seq",
            "16", "--device", "cpu"]
    if arch == VLM:
        with pytest.raises(SystemExit, match="token-stream trainer"):
            train_launcher.main(argv)
        return
    train_launcher.main(argv)
    out = capsys.readouterr().out
    assert "final loss" in out and out.rstrip().endswith("on cpu")
