"""The ICWS sketch kernel's group sizes, and the chosen one against one
thread per (row, t) end to end.

    python3 tools/sketch_lanes.py [--kernel-only]

``icws_sketch_cuda`` gives each (row, t) pair a group of S threads, S picked
by ``_group_size`` from the launch shape.  This runs the kernel with every
S of ``GROUP_SIZES`` that the row's non-zeros allow, and the chosen one:

* the kernel alone at the four sketch shapes of ``chip_smoke.py``: the
  device time per launch of each S (``chip_smoke.device_ms``, in the order
  of ``GROUP_SIZES`` and then in reverse), and a check that every S gives
  the chosen S's bits;
* unless ``--kernel-only``, the service end to end over the lake of
  ``chip_smoke.py``: after 12,384 tables are ingested, four rounds each
  ingest 1,000 more tables and run the 64 queries through ``search``, in
  the order chosen S, 1, 1, chosen S.  Prints each round's ingest rate and
  ``search`` p50.

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
GROUP_SIZES = (1, 8, 16, 32, 64, 128, 256)


@contextlib.contextmanager
def lanes(S: int):
    """Force S in every ``icws_sketch_cuda`` launch inside the block."""
    from repro_torch.kernels import icws_sketch as ks
    chosen = ks._group_size
    ks._group_size = lambda B, m, N: S
    try:
        yield
    finally:
        ks._group_size = chosen


def kernel_rounds(cs) -> None:
    from repro_torch.data.dataset_search import DatasetSearchIndex
    from repro_torch.data.ingest import pad_sparse_batch
    from repro_torch.kernels import icws_sketch as ks
    rng = np.random.default_rng(1)
    index = DatasetSearchIndex(m=cs.M, seed=0)
    for B in (3, 48):
        for nnz in (1000, 4000):
            w, keys, vals, _ = pad_sparse_batch(
                cs.field_vectors(index, rng, B, nnz))
            args = [torch.from_numpy(a).cuda() for a in (w, keys, vals)]
            N = w.shape[1]

            def run():
                return ks.icws_sketch_cuda(*args, m=cs.M, seed=0)
            chosen = ks._group_size(B, cs.M, N)
            want = run()
            sizes = [S for S in GROUP_SIZES if S <= N]
            ms = {S: [] for S in sizes}
            for S in sizes + sizes[::-1]:
                with lanes(S):
                    if not all(torch.equal(a, b) for a, b in zip(run(), want)):
                        raise AssertionError(f"B={B} N={N}: S={S} changes the "
                                             "sketch")
                    ms[S].append(cs.device_ms(run, "icws_sketch_kernel",
                                              reps=20)[0])
            print(f"kernel B={B} N={N} m={cs.M}: chosen S={chosen}; device ms "
                  "per launch, two turns: " + "; ".join(
                      f"S={S} {a:.4f} {b:.4f}" for S, (a, b) in ms.items())
                  + "; every S the same bits", flush=True)


def service_rounds(cs) -> None:
    from repro_torch import SketchSearchService
    rng = np.random.default_rng(4)
    tables, queries, _ = cs.make_lake(rng, cs.LAKE_TABLES, cs.QUERIES)
    base = cs.LAKE_TABLES - 4 * ROUND_TABLES
    svc = SketchSearchService(m=cs.M, seed=0, keep_host_oracle=False)
    svc.ingest_many(tables[:base])
    torch.cuda.synchronize()
    for i, which in enumerate(("chosen", "1", "1", "chosen")):
        batch = tables[base + i * ROUND_TABLES:base + (i + 1) * ROUND_TABLES]
        with lanes(1) if which == "1" else contextlib.nullcontext():
            t0 = time.perf_counter()
            svc.ingest_many(batch)
            torch.cuda.synchronize()
            ingest_s = time.perf_counter() - t0
            lat = []
            for k, v in queries:
                t0 = time.perf_counter()
                svc.search(k, v, top_k=10, min_join=cs.QUERY_ROWS / 4)
                lat.append(time.perf_counter() - t0)
        print(f"service round {i} S={which}: ingest {ROUND_TABLES / ingest_s:.1f} "
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
    kernel_rounds(cs)
    if "--kernel-only" not in sys.argv[1:]:
        service_rounds(cs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
