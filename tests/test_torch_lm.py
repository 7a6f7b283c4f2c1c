"""The port's dense transformer (``repro_torch.models``) against the JAX
package's on the CPU, at the four dense architectures' reduced configs:
layers, the parallel forward, the KV-cache decode (full and windowed
cache), and the port's own decode against its forward.

Weights come from JAX's ``Model.init`` through
``convert.model_params_from_numpy``; inputs from numpy seeds.

Tolerance, stated once: the port rounds as the JAX program compiled by
XLA on the CPU does (bf16 products of bf16-cast weights, the activations
op by op in bf16, the attention residual fed to the second norm in f32),
so nearly every value is bit for bit JAX's.  A rare one-step difference
(a product summed in another order, a libm ulp) moves its neighbours one
bf16 step too: logits and caches are held within ``TOL`` = 2^-6 of the
largest JAX magnitude (two bf16 steps of it), with at least ``SHARE`` of
the values bit for bit equal; positions and slot tables exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_lm import as_f32 as f32
from _torch_lm import assert_close, to_torch

from repro import configs as jax_configs
from repro.models import Model as JaxModel
from repro.models import layers as jax_layers
from repro_torch import configs
from repro_torch.convert import model_params_from_numpy
from repro_torch.models import Model, count_params
from repro_torch.models import layers
from repro_torch.serve.step import (greedy_sample, make_decode_step,
                                    make_prefill_step)

# small shapes: one intra-op thread per test process, so that parallel
# test workers do not oversubscribe the cores
torch.set_num_threads(1)

DENSE = ("tinyllama-1.1b", "codeqwen1.5-7b", "mistral-nemo-12b", "gemma-7b")
OTHER = tuple(a for a in configs.ARCHS if a not in DENSE)
STEPS = 12


class Pair:
    """One architecture's JAX model and port model on the same weights."""

    def __init__(self, arch: str, window: int = 0):
        self.jcfg = jax_configs.reduced(arch)
        self.cfg = configs.reduced(arch)
        if window:
            self.jcfg = dataclasses.replace(self.jcfg, sliding_window=window)
            self.cfg = dataclasses.replace(self.cfg, sliding_window=window)
        self.jm = JaxModel(self.jcfg)
        self.jp, _ = self.jm.init(jax.random.PRNGKey(1))
        self.model = Model(self.cfg, device="cpu")
        self.params = model_params_from_numpy(
            self.cfg, jax.tree.map(np.asarray, self.jp), device="cpu")
        self.jstep = jax.jit(lambda p, t, s: self.jm.decode_step(p, t, s))

    def tokens(self, B: int, T: int, seed: int = 2) -> np.ndarray:
        rng = np.random.default_rng(seed)
        return rng.integers(0, self.cfg.vocab_size, (B, T)).astype(np.int32)


@pytest.fixture(scope="module")
def pair():
    cache = {}

    def get(arch, window=0):
        if (arch, window) not in cache:
            cache[arch, window] = Pair(arch, window)
        return cache[arch, window]
    return get


@pytest.mark.parametrize("arch", DENSE)
def test_layers_match_jax(pair, arch):
    p = pair(arch)
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((2, 12, p.cfg.d_model)), jnp.bfloat16)
    gamma = jnp.asarray(0.1 * rng.standard_normal(p.cfg.d_model), jnp.float32)
    assert_close(layers.rms_norm(to_torch(x), to_torch(gamma), p.cfg.norm_eps),
                 jax.jit(lambda x, g: jax_layers.rms_norm(
                     x, g, p.jcfg.norm_eps))(x, gamma), "rms_norm", 1.0)
    # a width that is not a power of 2 (gemma-7b's 3,072, mistral's 5,120)
    x96 = jnp.asarray(rng.standard_normal((2, 12, 96)), jnp.bfloat16)
    assert_close(layers.rms_norm(to_torch(x96), torch.zeros(96), 1e-6),
                 jax.jit(lambda x: jax_layers.rms_norm(
                     x, jnp.zeros(96), 1e-6))(x96), "rms_norm d=96", 0.99)
    q = jnp.asarray(rng.standard_normal((2, 12, p.cfg.num_heads,
                                         p.cfg.head_dim)), jnp.bfloat16)
    pos = np.arange(12)[None, :]
    assert_close(layers.apply_rope(to_torch(q), torch.from_numpy(pos),
                                   p.cfg.rope_theta),
                 jax.jit(lambda q: jax_layers.apply_rope(
                     q, jnp.asarray(pos), p.jcfg.rope_theta))(q), "rope", 0.99)
    # tied (gemma) or untied head
    head = p.jp["embed"] if p.cfg.tie_embeddings else p.jp["lm_head"]
    assert_close(layers.lm_logits(to_torch(x), to_torch(head)),
                 jax.jit(jax_layers.lm_logits)(x, head), "lm_logits", 0.99)
    toks = p.tokens(2, 12)
    assert_close(layers.embed(to_torch(p.jp["embed"]), torch.from_numpy(toks)),
                 jax_layers.embed(p.jp["embed"], jnp.asarray(toks)), "embed",
                 1.0)


@pytest.mark.parametrize("variant", ["swiglu", "geglu", "gelu"])
def test_mlp_variants_match_jax(variant):
    """JAX's silu and gelu (tanh) round op by op in bf16: so does the port
    (``torch.nn.functional``'s fused f32 versions differ on about half of
    the outputs)."""
    jparams, _ = jax_layers.init_mlp(jax.random.PRNGKey(4), 64, 128, variant)
    x = jnp.asarray(2 * np.random.default_rng(5).standard_normal((2, 12, 64)),
                    jnp.bfloat16)
    want = jax.jit(lambda p, x: jax_layers.apply_mlp(p, x, variant))(
        jparams, x)
    got = layers.apply_mlp({k: to_torch(v) for k, v in jparams.items()},
                           to_torch(x), variant)
    assert_close(got, want, variant, 0.99)


@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_jax(pair, arch):
    p = pair(arch)
    toks = p.tokens(2, 16)
    want, _ = jax.jit(lambda prm, b: p.jm.forward(prm, b))(
        p.jp, {"tokens": jnp.asarray(toks)})
    got, aux = p.model.forward(p.params, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.bfloat16 and float(aux) == 0.0
    assert_close(got, want, "forward logits")


def _decode_both(p, B: int, max_seq: int, steps: int):
    """``steps`` decode steps of both models on the same tokens; checks
    logits, caches and positions after every step."""
    toks = p.tokens(B, steps, seed=6)
    jstate, _ = p.jm.init_decode_state(B, max_seq)
    state = p.model.init_decode_state(B, max_seq)
    assert state["kv"]["k"].shape == jstate["kv"]["k"].shape
    for t in range(steps):
        want, jstate = p.jstep(p.jp, jnp.asarray(toks[:, t:t + 1]), jstate)
        got, state = p.model.decode_step(
            p.params, torch.from_numpy(toks[:, t:t + 1]), state)
        assert_close(got, want, f"logits at step {t}")
        for name in ("k", "v"):
            assert_close(state["kv"][name], jstate["kv"][name],
                         f"{name} cache at step {t}")
        assert int(state["pos"]) == int(jstate["pos"]) == t + 1
        assert np.array_equal(state["slot_pos"].numpy(),
                              np.asarray(jstate["slot_pos"]))
    return state


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_jax(pair, arch):
    state = _decode_both(pair(arch), B=2, max_seq=32, steps=STEPS)
    assert state["slot_pos"].tolist() == list(range(STEPS)) + [-1] * 20


@pytest.mark.parametrize("arch", DENSE)
def test_windowed_cache_matches_jax(pair, arch):
    """A sliding window of 8 under ``max_seq`` 32: the circular cache of 8
    slots, decoded 20 steps, past its window."""
    state = _decode_both(pair(arch, window=8), B=2, max_seq=32, steps=20)
    assert state["kv"]["k"].shape[2] == 8
    assert sorted(state["slot_pos"].tolist()) == list(range(12, 20))


@pytest.mark.parametrize("arch", DENSE)
def test_decode_equals_parallel_forward(pair, arch):
    """The port's incremental decode == its parallel forward, within JAX's
    own gate for the same check (``tests/test_models.py``: rel < 0.06)."""
    p = pair(arch)
    toks = p.tokens(1, STEPS)
    # through the serving steps, each the model's own call
    prefill, decode = make_prefill_step(p.model), make_decode_step(p.model)
    batch = {"tokens": torch.from_numpy(toks)}
    par = prefill(p.params, batch)
    assert torch.equal(par, p.model.forward(p.params, batch)[0])
    state = p.model.init_decode_state(1, 32)
    inc = []
    for t in range(STEPS):
        lg, state = decode(p.params, torch.from_numpy(toks[:, t:t + 1]),
                           state)
        inc.append(lg[:, 0])
    pa, pi = f32(par), f32(torch.stack(inc, dim=1))
    assert np.abs(pa - pi).max() / (np.abs(pa).max() + 1e-9) < 0.06


@pytest.mark.parametrize("arch", DENSE)
def test_init_matches_the_param_count(arch):
    cfg = configs.reduced(arch)
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    leaves = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), params))
    assert all(a.dtype == np.float32 for a in leaves)
    assert sum(a.size for a in leaves) == count_params(cfg)
    again = model.init(torch.Generator().manual_seed(0))
    assert torch.equal(again["layers"]["mlp"]["w_down"],
                       params["layers"]["mlp"]["w_down"])


def test_params_from_numpy_rejects_a_wrong_tree():
    cfg = configs.reduced("tinyllama-1.1b")
    tree = jax.tree.map(np.asarray, JaxModel(
        jax_configs.reduced("tinyllama-1.1b")).init(jax.random.PRNGKey(0))[0])
    with pytest.raises(ValueError, match="keys"):
        model_params_from_numpy(configs.reduced("gemma-7b"), tree,
                                device="cpu")
    tree["layers"]["attn"]["wq"] = tree["layers"]["attn"]["wq"][:1]
    with pytest.raises(ValueError, match="layers/attn/wq: shape"):
        model_params_from_numpy(cfg, tree, device="cpu")


@pytest.mark.parametrize("arch", OTHER)
def test_other_families_raise_naming_the_queue(arch):
    """ssm, hybrid and encdec raise, naming the queue; moe and vlm, which
    JAX runs on the dense family's block stack, build and run: a forward
    (a vlm's with its patches), the loss and a decode step, finite and of
    the expected shapes (their values against JAX's are in
    ``tests/test_torch_moe.py``)."""
    cfg = configs.reduced(arch)
    if cfg.family not in ("moe", "vlm"):
        with pytest.raises(NotImplementedError, match="Queue A 18c"):
            Model(cfg, device="cpu")
        return
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 9)).astype(np.int32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    P = cfg.num_patches if cfg.family == "vlm" else 0
    if P:
        batch["patches"] = torch.randn((2, P, cfg.d_model), generator=
                                       torch.Generator().manual_seed(2))
    with torch.no_grad():
        logits, aux = model.forward(params, batch)
        loss, parts = model.loss(params, batch)
    assert logits.shape == (2, P + 8, cfg.vocab_size)
    assert bool(torch.isfinite(logits.float()).all())
    assert bool(torch.isfinite(loss)) and torch.equal(parts["aux"], aux)
    assert (float(aux) > 0) == (cfg.family == "moe")
    state = model.init_decode_state(2, 16)
    lg, state = model.decode_step(params, toks[:, :1], state)
    assert lg.shape == (2, 1, cfg.vocab_size) and int(state["pos"]) == 1


def test_model_runs_on_the_card_by_default():
    cfg = configs.reduced("tinyllama-1.1b")
    if torch.cuda.is_available():
        assert Model(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Model(cfg)


def test_greedy_argmax_takes_the_first_of_tied_logits():
    """bf16 logits tie often (8 bits of mantissa over a vocabulary): both
    packages take the first index of the largest value."""
    logits = np.zeros((3, 1, 32000), np.float32)
    logits[0, 0, [7, 19, 31999]] = 4.0
    logits[1, 0, [0, 5]] = 1.5
    logits[2, 0, 31998:] = -1.0
    logits[2, 0, :31998] = -2.0
    # values one bf16 step apart at 4.0 tie once rounded
    logits[0, 0, 3] = 4.0 + 2 ** -8
    jl = jnp.asarray(logits, jnp.bfloat16)
    want = np.asarray(jnp.argmax(jl[:, -1], axis=-1))
    got = greedy_sample(to_torch(jl))
    assert got.dtype == torch.int32 and got.shape == (3, 1)
    assert got[:, 0].tolist() == want.tolist() == [3, 0, 31998]


@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
def test_score_scale_divides_as_jax(hd):
    """Decode's ``s / sqrt(hd)`` equals JAX's jitted one bit for bit: XLA
    folds the division into a multiply by an f32 reciprocal, which differs
    from a true division on about 40% of the scores at hd 32 and 128,
    where the root is not a power of 2."""
    from repro_torch.models.attention import _scale_scores
    s = (8 * np.random.default_rng(hd).standard_normal((4, 4096))).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda s: s / np.sqrt(hd))(jnp.asarray(s)))
    got = _scale_scores(torch.from_numpy(s), hd).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    if hd in (32, 128):
        assert not np.array_equal(s / np.float32(np.sqrt(hd)), want)
