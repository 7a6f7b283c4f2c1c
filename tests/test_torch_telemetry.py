"""The port's sketch gradient telemetry (``repro_torch.train.telemetry``)
against the JAX package's on the CPU, where ``ops.icws_sketch`` (B1) and
``ops.icws_estimate`` (B3) take their plain versions.

Tiers: a sketch equals JAX's (interpret-mode Pallas) on at least 99% of
its fingerprint slots, the values equal where the fingerprints do (a
float's last bit can move a level floor, as in every port sketch test);
the estimate of JAX's own sketches within 1e-6 relative of JAX's;
``gradient_agreement`` over 4 gloo ranks against JAX's ``shard_map`` over
4 forced host devices on ``tests/test_substrate.py``'s inputs, every
rank's matrix equal bit for bit, each within ``AGREE_TOL`` of JAX's, and
JAX's criterion (healthy replicas above the diverged one by 0.2); the JL
branch, summed over chunks of T, within f32 tolerance."""
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_sharding import run_script

from repro.train import telemetry as jax_tel
from repro_torch.train import telemetry as tel

torch.set_num_threads(1)

T = 3000
# cosines of two sketches whose fingerprints agree on 99% of slots
AGREE_TOL = 0.02


def _grads(seed: int, R: int = 3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    base = rng.normal(size=T)
    g = np.stack([base + 0.4 * rng.normal(size=T) for _ in range(R)])
    g[:, rng.choice(T, T // 3, replace=False)] = 0.0
    return g.astype(np.float32)


def _f32(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("m", [64, 256])
def test_sketch_gradient_matches_jax(m):
    cfg = tel.TelemetryConfig(m=m, seed=5)
    jcfg = jax_tel.TelemetryConfig(m=m, seed=5)
    g = _grads(m)[0]
    want = jax_tel.sketch_gradient(jnp.asarray(g), jcfg)
    got = tel.sketch_gradient(torch.from_numpy(g), cfg)
    same = got["fp"].numpy() == np.asarray(want["fp"])
    assert same.mean() >= 0.99, same.mean()
    assert np.array_equal(got["val"].numpy()[same], _f32(want["val"])[same])
    np.testing.assert_allclose(float(got["norm"]), float(want["norm"]),
                               rtol=1e-6)


def test_stacked_rows_sketch_as_one_row_each():
    cfg = tel.TelemetryConfig(m=64, seed=2)
    g = torch.from_numpy(_grads(1))
    stacked = tel.sketch_gradient(g, cfg)
    for r in range(g.shape[0]):
        one = tel.sketch_gradient(g[r], cfg)
        for k in ("fp", "val", "norm"):
            assert torch.equal(stacked[k][r], one[k])


def test_estimate_pairwise_matches_jax_on_the_same_sketches():
    jcfg = jax_tel.TelemetryConfig(m=128, seed=3)
    g = _grads(4)
    sk = [jax_tel.sketch_gradient(jnp.asarray(x), jcfg) for x in g]
    stacked = {k: jnp.stack([s[k] for s in sk]) for k in sk[0]}
    want = np.asarray(jax_tel.estimate_pairwise(stacked, jcfg))
    got = tel.estimate_pairwise(
        {k: torch.from_numpy(np.array(v)) for k, v in stacked.items()},
        tel.TelemetryConfig(m=128, seed=3))
    assert got.shape == (3, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_jl_branch_matches_jax():
    cfg = tel.TelemetryConfig(m=48, seed=7, method="jl")
    jcfg = jax_tel.TelemetryConfig(m=48, seed=7, method="jl")
    g = _grads(5)
    want = [np.asarray(jax_tel.sketch_gradient(jnp.asarray(x), jcfg)["proj"])
            for x in g]
    got = tel.sketch_gradient(torch.from_numpy(g), cfg)["proj"]
    scale = np.abs(g).sum(axis=1).max() / np.sqrt(48)
    np.testing.assert_allclose(got.numpy(), np.stack(want), rtol=1e-5,
                               atol=1e-6 * scale)
    est = tel.estimate_pairwise({"proj": got}, cfg)
    want_est = np.asarray(jax_tel.estimate_pairwise(
        {"proj": jnp.stack(want)}, jcfg))
    np.testing.assert_allclose(est.numpy(), want_est, rtol=1e-5,
                               atol=1e-5 * np.abs(want_est).max())


def test_jl_chunks_change_only_the_order_of_the_sum(monkeypatch):
    cfg = tel.TelemetryConfig(m=16, seed=1, method="jl")
    g = torch.from_numpy(_grads(6)[0])
    whole = tel.sketch_gradient(g, cfg)["proj"]
    monkeypatch.setattr(tel, "_JL_BLOCK", 16 * 7)
    chunked = tel.sketch_gradient(g, cfg)["proj"]
    torch.testing.assert_close(chunked, whole, rtol=1e-5, atol=1e-4)


def test_b1_refuses_a_row_past_its_32_bit_index():
    """The telemetry's row is a whole model's gradient: B1's wrapper raises
    past 2^31 - 1 entries instead of overflowing the kernel's int."""
    from repro_torch.kernels import icws_sketch as ks
    w = torch.empty((1, 2 ** 31), device="meta")
    keys = torch.empty((1, 2 ** 31), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="at most 2147483647"):
        ks.icws_sketch_cuda(w, keys, w, m=8, seed=0)


def test_agreement_needs_a_registered_axis():
    with pytest.raises((RuntimeError, ValueError)):
        tel.gradient_agreement(torch.ones(8), "telemetry-unregistered",
                               tel.TelemetryConfig(m=8))


_SUBSTRATE = textwrap.dedent("""
    import numpy as np
    rng = np.random.default_rng(2)
    base = rng.normal(size=2048)
    grads = np.stack([base + 0.3 * rng.normal(size=2048) for _ in range(3)]
                     + [rng.normal(size=2048)])      # replica 3 diverges
    grads = grads.astype(np.float32)
""")

_RANKS = textwrap.dedent("""
    import datetime, pathlib, sys
    import numpy as np, torch

    def worker(rank, world, out):
        torch.set_num_threads(1)
        torch.distributed.init_process_group(
            "gloo", init_method=(out / "rendezvous").as_uri(),
            world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=120))
        from repro_torch.launch import register_world_axis
        from repro_torch.train.telemetry import (TelemetryConfig,
                                                 gradient_agreement)
        register_world_axis("data")
        g = torch.from_numpy(np.load(out / "grads.npy")[rank])
        sim = gradient_agreement(g, "data", TelemetryConfig(m=512, seed=5))
        np.save(out / f"sim{rank}.npy", sim.numpy())
        torch.distributed.destroy_process_group()

    if __name__ == "__main__":
        out, world = pathlib.Path(sys.argv[1]), int(sys.argv[2])
        torch.multiprocessing.spawn(worker, args=(world, out), nprocs=world)
""")

_JAX = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, "src")
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.compat import make_mesh, shard_map
    from repro.train.telemetry import TelemetryConfig, gradient_agreement

    cfg = TelemetryConfig(m=512, seed=5)
    grads = jnp.asarray(np.load(sys.argv[1] + "/grads.npy"))

    def worker(g):
        return gradient_agreement(g[0], "data", cfg)[None]

    f = shard_map(worker, mesh=make_mesh((4,), ("data",)),
                  in_specs=(P("data", None),),
                  out_specs=P("data", None, None), check=False)
    np.save(sys.argv[1] + "/jax_sim.npy", np.asarray(f(grads)))
""")


def test_four_gloo_ranks_agree_and_match_jax_shard_map(tmp_path):
    scope = {}
    exec(_SUBSTRATE, scope)
    grads = scope["grads"]
    np.save(tmp_path / "grads.npy", grads)
    run_script(tmp_path, _RANKS, 4, name="ranks.py")
    sims = [np.load(tmp_path / f"sim{r}.npy") for r in range(4)]
    for s in sims[1:]:
        assert np.array_equal(s.view(np.int32), sims[0].view(np.int32))
    sim = sims[0]
    healthy = [sim[i, j] for i in range(3) for j in range(3) if i != j]
    bad = [sim[i, 3] for i in range(3)]
    assert min(healthy) > max(bad) + 0.2, (healthy, bad)
    run_script(tmp_path, _JAX, name="jax_shard_map.py")
    want = np.load(tmp_path / "jax_sim.npy")
    for r in range(4):
        np.testing.assert_allclose(sim, want[r], atol=AGREE_TOL)
