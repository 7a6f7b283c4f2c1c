"""Shared setup of the port's sharded-serving tests: meshes whose device
repeats (``("cpu",) * d`` here, the port's counterpart of JAX's forced
host devices; ``("cuda",) * d`` in the card tests), the checks that a
sharded service, or a family's sharded launch, equals its single-device
twin bit for bit, and ``run_script``, which runs a test's script (gloo
ranks, or JAX over forced host devices) in a fresh interpreter with a
bounded time and a loud failure.  Imports nothing of JAX."""
import os
import pathlib
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import SketchSearchService
from repro_torch.launch import make_corpus_mesh

M = 64
ROOT = pathlib.Path(__file__).resolve().parents[1]
# the tail of a failed script's output that a failure shows
TAIL = 3000


def _tail(text) -> str:
    if isinstance(text, bytes):
        text = text.decode(errors="replace")
    return (text or "")[-TAIL:]


def run_script(tmp_path, script: str, *args, timeout: float = 240,
               name: str = "run.py"):
    """Runs ``script`` (written to ``tmp_path / name``) as ``python name
    tmp_path *args`` from the repository root, in a session of its own.

    Its gloo ranks find each other on the loopback device
    (``GLOO_SOCKET_IFNAME=lo``, ``MASTER_ADDR=127.0.0.1``), not through
    the host name.  Past ``timeout`` seconds the whole session is killed,
    the ranks that ``torch.multiprocessing.spawn`` started included, and
    the test fails with how long it ran and the tails of both streams; so
    does a nonzero exit."""
    path = tmp_path / name
    path.write_text(script)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               GLOO_SOCKET_IFNAME="lo", MASTER_ADDR="127.0.0.1")
    proc = subprocess.Popen([sys.executable, str(path), str(tmp_path),
                             *map(str, args)], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        pytest.fail(f"{name} {' '.join(map(str, args))} ran past {timeout} s"
                    f"; stdout tail:\n{_tail(out)}\nstderr tail:\n"
                    f"{_tail(err)}")
    if proc.returncode != 0:
        pytest.fail(f"{name} {' '.join(map(str, args))} exited "
                    f"{proc.returncode}; stdout tail:\n{_tail(out)}\n"
                    f"stderr tail:\n{_tail(err)}")
    return out


def repeated_mesh(shards: int, device="cpu"):
    """A ``shards``-way data axis over one repeated device."""
    return make_corpus_mesh(devices=(device,) * shards)


def small_lake(seed: int = 0, n_tables: int = 7, n_queries: int = 3):
    """Tables and queries over a 300-key domain: every query joins most
    tables, so many estimates and ties reach the ranking."""
    rng = np.random.default_rng(seed)
    tables = [(f"t{i}", rng.integers(0, 300, 60), rng.normal(size=60))
              for i in range(n_tables)]
    queries = [(rng.integers(0, 300, 50), rng.normal(size=50))
               for _ in range(n_queries)]
    return tables, queries


def _described(svc) -> dict:
    """``describe()`` without latencies and capacity (a sharded store's
    rounds up to a multiple of its shard count)."""
    return {k: v for k, v in svc.describe().items()
            if "_ms" not in k and k != "corpus_capacity"}


def assert_sharded_service_equal(tables, queries, *, shards: int,
                                 device="cpu", **kwargs):
    """A service over a ``shards``-way CPU mesh answers ``search`` and
    ``search_batch`` (micro-batches of 2) exactly as a single-device one,
    describes itself alike and keeps each shard on its mesh device.
    Returns the (single, sharded) services."""
    mesh = repeated_mesh(shards, device)
    svcs = [SketchSearchService(m=M, seed=5, keep_host_oracle=False,
                                device=device, mesh=mh, **kwargs)
            for mh in (None, mesh)]
    got = []
    for svc in svcs:
        svc.ingest_many(tables)
        got.append((svc.search_batch(queries, top_k=4, min_join=1.0,
                                     micro_batch=2),
                    [svc.search(k, v, top_k=4, min_join=1.0)
                     for k, v in queries]))
    assert got[0] == got[1]
    assert got[0][0] == got[0][1] and any(got[0][0])
    assert _described(svcs[0]) == _described(svcs[1])
    assert svcs[1].index.store.capacity % shards == 0
    for parts in svcs[1].index.store.shard_buffers():
        assert [p.device for p in parts] == list(mesh.axis_devices("data"))
    return svcs


def assert_sharded_family_equal(family, *, packed: bool, shards: int,
                                rows: int = 7, device="cpu"):
    """The family's sharded fields launch on raw corpus tensors whose
    ``rows`` do not split evenly (the pad path), and on a sharded store's
    per-shard buffers, equals the single-device launch bit for bit."""
    from repro_torch.core.types import SparseVec
    from repro_torch.data.store import CorpusStore
    rng = np.random.default_rng(rows)

    def vecs(n):
        return [SparseVec(indices=np.sort(rng.choice(300, 40, replace=False)),
                          values=rng.normal(size=40), n=300)
                for _ in range(n)]

    def stacked(comps, f):
        return tuple(c.reshape((-1, f) + tuple(c.shape[1:])).transpose(0, 1)
                     for c in comps)

    q = stacked(family.sketch_rows(vecs(6), device=device), 3)
    mesh = repeated_mesh(shards, device)
    store = CorpusStore(family=family, fields=3, packed=packed, device=device,
                        mesh=mesh, min_capacity=1)
    store.append(*stacked(family.sketch_rows(vecs(3 * rows), device=device),
                          3))
    plain = store.field_arrays()
    est = family.estimate_fields_packed if packed else family.estimate_fields
    sharded = (family.estimate_fields_packed_sharded if packed
               else family.estimate_fields_sharded)
    kw = dict(qmap=(0, 1, 0, 2, 0, 1), cmap=(0, 0, 1, 0, 2, 1))
    want = est(q, plain, **kw)
    assert want.shape == (6, 2, rows)
    for corpus in (plain, store.shard_buffers()):
        got = sharded(q, corpus, mesh=mesh, axis="data", **kw)[:, :, :rows]
        assert torch.equal(got, want)
