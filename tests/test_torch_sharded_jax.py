"""The port's sharded ICWS index against JAX's, on 2 forced host devices.

JAX's ``DatasetSearchIndex(mesh=make_corpus_mesh())`` (unpacked and
packed) serves a small lake; its rows are carried into a port index over a
2-shard CPU mesh (``convert.index_from_numpy(mesh=)``), and both answer the
same queries at the tier of ``tests/test_torch_search.py``: the same
tables, corr equal (the same KMV samples), join sizes and sums within
1e-5, and the ranking equal wherever the device scores are separated.
``sharded_top_k`` equals JAX's in values and indices on tie-heavy scores.
With observability on in both packages, the sharded ops count alike; the
inner ``icws_estimate_fields`` counts once a shard in the port and only
while tracing in JAX (``repro_torch/obs/instrument.py``).  Runs in a
subprocess: the forced device count must be set before jax starts."""
import os
import pathlib
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parents[1]

_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import sys
    sys.path[:0] = ["src", "tests"]
    import numpy as np, jax, jax.numpy as jnp, torch
    torch.set_num_threads(1)
    from repro import obs as jax_obs
    from repro.data import DatasetSearchIndex as JaxIndex
    from repro.kernels import ops as jax_ops
    from repro.launch.mesh import make_corpus_mesh as jax_mesh
    from repro_torch import obs
    from repro_torch.convert import index_from_numpy
    from repro_torch.data import dataset_search as port_ds
    from repro_torch.kernels import ops
    from _torch_sharding import repeated_mesh, small_lake

    jmesh = jax_mesh()
    assert jmesh.shape["data"] == 2, jmesh
    rng = np.random.default_rng(3)
    for n, k in ((11, 6), (8, 3), (5, 5)):
        score = rng.integers(-1, 3, size=(4, n)).astype(np.float32)
        v0, i0 = jax_ops.sharded_top_k(jnp.asarray(score), k, mesh=jmesh,
                                       axis="data")
        v1, i1 = ops.sharded_top_k(torch.from_numpy(score), k,
                                   mesh=repeated_mesh(2), axis="data")
        assert np.array_equal(np.asarray(v0), v1.numpy()), (n, k)
        assert np.array_equal(np.asarray(i0), i1.numpy()), (n, k)

    def launches(o):
        s = o.describe_metrics()["metrics"]["ops.launches_total"]["series"]
        out = {}
        for x in s:
            op = x["labels"]["op"]
            out[op] = out.get(op, 0) + x["value"]
        return out

    tables, queries = small_lake(7, n_tables=9, n_queries=3)
    for packed in (False, True):
        jidx = JaxIndex(m=64, seed=1, keep_host_oracle=False, mesh=jmesh,
                        packed=packed)
        for t in tables:
            jidx.add_table(*t)
        port = index_from_numpy(
            [np.asarray(b) for b in jidx.store.buffers()], len(jidx.store),
            tables=[(t.name, t.n_rows, (t.sample.hashes, t.sample.values))
                    for t in jidx.tables],
            m=64, seed=1, packed=packed, mesh=repeated_mesh(2), device="cpu")
        assert port.store.corpus_axis == "data"
        P = len(tables)
        obs.reset_all(); jax_obs.reset_all()
        obs.enable(); jax_obs.enable()
        want = jidx.query_batch(queries, top_k=P, min_join=2.0)
        got = port.query_batch(queries, top_k=P, min_join=2.0)
        obs.disable(); jax_obs.disable()
        op = "icws_estimate_fields" + ("_packed" if packed else "")
        lp, lj = launches(obs), launches(jax_obs)
        for name in (op + "_sharded", "sharded_top_k"):
            assert lp[name] == lj[name] == 1, (name, lp, lj)
        assert lp[op] == 2, lp
        assert any(want)
        vecs = [v for q in queries for v in port.vectorize(*q)]
        qc = tuple(c.reshape((len(queries), 3) + tuple(c.shape[1:]))
                   .transpose(0, 1)
                   for c in port.family.sketch_rows(vecs, device="cpu"))
        est = port._estimate_arena(qc)[:, :, :P]
        scores = port_ds._corr_scores(*est, 2.0).numpy()
        pos = {t.name: i for i, t in enumerate(port.tables)}
        for w, g, score in zip(want, got, scores):
            assert {r.name for r in g} == {r.name for r in w}
            by = {r.name: r for r in g}
            scale = max([abs(r.sum_b) for r in w] + [1.0])
            for r in w:
                assert by[r.name].corr == r.corr
                np.testing.assert_allclose(by[r.name].join_size,
                                           r.join_size, rtol=1e-5)
                np.testing.assert_allclose(by[r.name].sum_b, r.sum_b,
                                           rtol=1e-5, atol=1e-5 * scale)
            # equal refined corr keeps the device order: it must agree
            # wherever the device scores are separated by more than 1e-5
            rank = {r.name: i for i, r in enumerate(g)}
            for i, a in enumerate(w):
                for b in w[i + 1:]:
                    if abs(a.corr) == abs(b.corr) and abs(
                            score[pos[a.name]] - score[pos[b.name]]) > 1e-5:
                        assert rank[a.name] < rank[b.name]
        print("SHARDED_PARITY_OK", packed)
""")


def test_sharded_index_and_top_k_match_jax_on_two_host_devices():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("SHARDED_PARITY_OK") == 2, out.stdout
