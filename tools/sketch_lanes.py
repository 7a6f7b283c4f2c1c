"""The ICWS sketch kernel's lane groups against one thread per (row, t).

    python3 tools/sketch_lanes.py

``icws_sketch_cuda`` gives each (row, t) pair a group of S lanes, S picked
by ``_group_size`` from the launch shape.  This runs the kernel with that S
and with S forced to 1 (one thread per (row, t), 256 pairs per block):

* the kernel alone at the four sketch shapes of ``chip_smoke.py``: CUDA-event
  median of each, and a check that both give the same bits;
* the service end to end over the lake of ``chip_smoke.py``: after 12,384
  tables are ingested, four rounds each ingest 1,000 more tables and run the
  64 queries through ``search``, in the order chosen S, 1, 1, chosen S.
  Prints each round's ingest rate and ``search`` p50.

Needs one card.
"""
from __future__ import annotations

import contextlib
import pathlib
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
ROUND_TABLES = 1_000


@contextlib.contextmanager
def one_lane():
    """Force S = 1 in every ``icws_sketch_cuda`` launch inside the block."""
    from repro_torch.kernels import icws_sketch as ks
    chosen = ks._group_size
    ks._group_size = lambda B, m, N: 1
    try:
        yield
    finally:
        ks._group_size = chosen


def kernel_rounds(time_ms, M, KEY_DOMAIN) -> None:
    from repro_torch.data.dataset_search import DatasetSearchIndex
    from repro_torch.data.ingest import pad_sparse_batch
    from repro_torch.kernels import icws_sketch as ks
    rng = np.random.default_rng(1)
    index = DatasetSearchIndex(m=M, seed=0)
    for B in (3, 48):
        for nnz in (1000, 4000):
            vecs = []
            while len(vecs) < B:
                keys = rng.integers(0, KEY_DOMAIN, nnz + nnz // 64)
                vecs.extend(index.vectorize(keys, rng.normal(0.0, 1.0, keys.size)))
            w, keys, vals, _ = pad_sparse_batch(vecs[:B])
            args = [torch.from_numpy(a).cuda() for a in (w, keys, vals)]

            def run():
                return ks.icws_sketch_cuda(*args, m=M, seed=0)
            chosen = run()
            with one_lane():
                single = run()
            same = all(torch.equal(a, b) for a, b in zip(chosen, single))
            if not same:
                raise AssertionError(f"B={B} N={w.shape[1]}: S = 1 changes the sketch")
            S = ks._group_size(B, M, w.shape[1])
            ms_s = time_ms(run, reps=20)
            with one_lane():
                ms_1 = time_ms(run, reps=20)
            print(f"kernel B={B} N={w.shape[1]} m={M}: S={S} {ms_s:.4f} ms, "
                  f"S=1 {ms_1:.4f} ms ({ms_1 / ms_s:.2f}x); same bits")


def service_rounds(cs) -> None:
    from repro_torch import SketchSearchService
    rng = np.random.default_rng(4)
    tables, queries, _ = cs.make_lake(rng, cs.LAKE_TABLES, cs.QUERIES)
    base = cs.LAKE_TABLES - 4 * ROUND_TABLES
    svc = SketchSearchService(m=cs.M, seed=0)
    svc.ingest_many(tables[:base])
    torch.cuda.synchronize()
    for i, lanes in enumerate(("chosen", "1", "1", "chosen")):
        batch = tables[base + i * ROUND_TABLES:base + (i + 1) * ROUND_TABLES]
        with one_lane() if lanes == "1" else contextlib.nullcontext():
            t0 = time.perf_counter()
            svc.ingest_many(batch)
            torch.cuda.synchronize()
            ingest_s = time.perf_counter() - t0
            lat = []
            for k, v in queries:
                t0 = time.perf_counter()
                svc.search(k, v, top_k=10, min_join=cs.QUERY_ROWS / 4)
                lat.append(time.perf_counter() - t0)
        print(f"service round {i} S={lanes}: ingest {ROUND_TABLES / ingest_s:.1f} "
              f"tables/s, search p50 {1e3 * float(np.median(lat)):.3f} ms "
              f"({len(lat)} queries, {len(svc.index.tables)} tables)")


def main() -> int:
    if not torch.cuda.is_available():
        print("sketch_lanes: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    print(cs.card_identity())
    kernel_rounds(cs.time_ms, cs.M, cs.KEY_DOMAIN)
    service_rounds(cs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
