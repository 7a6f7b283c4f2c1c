"""``compressed_update`` over a named replica axis: ``torch.distributed``
gloo ranks (spawned in a subprocess, rendezvous through a ``file://``
store) against JAX's ``shard_map`` over forced host devices
(``tests/test_substrate.py``'s form).

Two ranks: every rank's delta equal bit for bit, and each within the
tolerance of ``tests/test_torch_compression.py`` of JAX's on the
coordinates off the edge of the mask.  One rank: equal bit for bit to
``axis_name=None``; an axis with no registered group raises."""
import textwrap

import numpy as np
import pytest
import torch
from _torch_sharding import run_script

from repro_torch.optim import compression as comp

torch.set_num_threads(1)

CFG = dict(width=256, reps=5, seed=3)
TOL = dict(rtol=1e-5, atol=1e-5)

_RANKS = textwrap.dedent("""
    import datetime, pathlib, sys
    import numpy as np, torch

    def worker(rank, world, out):
        torch.set_num_threads(1)
        # a stuck rendezvous or collective raises here, inside the
        # script's time limit
        torch.distributed.init_process_group(
            "gloo", init_method=(out / "rendezvous").as_uri(),
            world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=120))
        from repro_torch.launch import register_world_axis
        from repro_torch.optim import compression as comp
        cfg = comp.CompressionConfig(width=256, reps=5, seed=3)
        g = torch.from_numpy(np.load(out / "grads.npy")[rank])
        r0 = torch.zeros_like(g)
        try:
            comp.compressed_update(g, r0, "data", cfg, lr=1.0)
        except ValueError as e:
            assert "no process group" in str(e)
        else:
            raise AssertionError("an unregistered axis ran")
        register_world_axis("data")
        delta, res = comp.compressed_update(g, r0, "data", cfg, lr=1.0)
        np.save(out / f"delta{rank}.npy", delta.numpy())
        np.save(out / f"res{rank}.npy", res.numpy())
        if world == 1:
            d1, r1 = comp.compressed_update(g, r0, None, cfg, lr=1.0)
            assert torch.equal(delta, d1) and torch.equal(res, r1)
            (out / "one_rank_ok").touch()
        torch.distributed.destroy_process_group()

    if __name__ == "__main__":
        out, world = pathlib.Path(sys.argv[1]), int(sys.argv[2])
        torch.multiprocessing.spawn(worker, args=(world, out), nprocs=world)
""")

_JAX = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    sys.path.insert(0, "src")
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.compat import make_mesh, shard_map
    from repro.optim.compression import CompressionConfig, compressed_update

    cfg = CompressionConfig(width=256, reps=5, seed=3)
    grads = jnp.asarray(np.load(sys.argv[1] + "/grads.npy"))

    def worker(g, r):
        d, new_r = compressed_update(g[0], r[0], "data", cfg, lr=1.0)
        return d[None], new_r[None]

    f = shard_map(worker, mesh=make_mesh((2,), ("data",)),
                  in_specs=(P("data", None), P("data", None)),
                  out_specs=(P("data", None), P("data", None)), check=False)
    delta, _ = jax.jit(f)(grads, jnp.zeros_like(grads))
    np.save(sys.argv[1] + "/jax_delta.npy", np.asarray(delta))
""")


def _grads(world: int) -> np.ndarray:
    """``tests/test_substrate.py``'s gradients: a heavy-tailed shared
    signal on 64 of 2,048 coordinates plus per-replica noise."""
    rng = np.random.default_rng(0)
    base = np.zeros(2048)
    base[rng.choice(2048, 64, replace=False)] = rng.standard_t(2, 64) * 5
    return (base[None] + 0.05 * rng.normal(size=(world, 2048))
            ).astype(np.float32)


def test_two_gloo_ranks_agree_and_match_jax_shard_map(tmp_path):
    grads = _grads(2)
    np.save(tmp_path / "grads.npy", grads)
    run_script(tmp_path, _RANKS, 2, name="ranks.py")
    deltas = [np.load(tmp_path / f"delta{r}.npy") for r in range(2)]
    assert np.array_equal(deltas[0].view(np.int32), deltas[1].view(np.int32))
    run_script(tmp_path, _JAX, name="jax_shard_map.py")
    want = np.load(tmp_path / "jax_delta.npy")
    # the coordinates whose |est| lies within 1e-5 of tau or of the k-th
    # largest may fall either way of the mask (summation order)
    cfg = comp.CompressionConfig(**CFG)
    p = torch.from_numpy(grads)
    table = sum(comp.compress(x, cfg) for x in p) / torch.tensor(2.0)
    est = comp.decompress(table, 2048, cfg).abs()
    kth = torch.topk(est, 128).values[-1]
    edge = (est - kth).abs() <= 1e-5 * kth
    for r in range(2):
        tau = 2.0 * torch.linalg.vector_norm(p[r]) / 16.0
        edge |= (est - tau).abs() <= 1e-5 * tau
    keep = ~edge.numpy()
    assert keep.sum() >= 2048 - 4
    for r in range(2):
        np.testing.assert_allclose(deltas[r][keep], want[r][keep], **TOL)
    nz = deltas[0] != 0
    assert nz.sum() > 32
    np.testing.assert_allclose(deltas[0][nz], grads.mean(0)[nz], **TOL)


def test_one_rank_group_equals_no_axis_and_unregistered_raises(tmp_path):
    np.save(tmp_path / "grads.npy", _grads(1))
    run_script(tmp_path, _RANKS, 1, name="ranks.py")
    assert (tmp_path / "one_rank_ok").exists()


def test_mesh_register_needs_an_initialised_group():
    from repro_torch.launch import register_world_axis
    if not torch.distributed.is_initialized():
        with pytest.raises(RuntimeError, match="init_process_group"):
            register_world_axis("data")
