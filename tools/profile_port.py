"""Where the port's serving time goes on the card: a torch.profiler trace
of table ingest, of query micro-batches and of single searches through
``repro_torch``.

    python3 tools/profile_port.py [--packed] [--family NAME]

Builds the 16,384-table lake ``chip_smoke.py`` builds and, for each of the
six families (icws, cs, jl, dmh, ts, ps, as ``chip_smoke.py`` serves them),
ingests it through ``SketchSearchService.ingest``; the last 2,000 tables
are traced.  The 64
queries of ``chip_smoke.py`` then run ``search_batch`` in micro-batches of
16 against the whole lake, traced, and then one by one through
``search`` (Q = 1), traced.  The service's own
methods run, each step of ingest and query under a profiler label of its
method's name (the label wraps the method the service calls; nothing of
the path is copied here).  Prints, per phase, the wall time, the host time
per label, the device time per kernel and the device's busy share (kernel
and copy time over wall time).  With ``--packed`` every service keeps its
store packed (``packed=True``); ``--family`` profiles that family alone.
Needs one card.
"""
from __future__ import annotations

import pathlib
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

ROOT = pathlib.Path(__file__).resolve().parents[1]
TRACED = 2_000      # ingested tables under the profiler, the lake's last


def label_calls(obj, names) -> list:
    """Make each method ``names`` of ``obj`` run under a profiler label
    ``Class.method``; the service's calls reach the wrapped methods because
    the instance attribute shadows the class's (set past a frozen
    dataclass's guard).  Returns the labels."""
    labels = []
    for name in names:
        label = f"{type(obj).__name__}.{name}"

        def labelled(*args, _fn=getattr(obj, name), _label=label, **kwargs):
            with record_function(_label):
                return _fn(*args, **kwargs)
        object.__setattr__(obj, name, labelled)
        labels.append(label)
    return labels


def report(title: str, prof, wall_s: float, labels) -> None:
    """Wall time, host time per label, device time per kernel or copy, and
    the device's busy share (the union of its activity over wall time).
    Device-side copies of the labels (user annotations) are not activity."""
    host = dict.fromkeys(labels, 0.0)
    spans, by_name = [], {}
    for e in prof.events():
        ms = e.time_range.elapsed_us() / 1e3
        if e.device_type == DeviceType.CPU:
            if e.name in host:
                host[e.name] += ms
        elif not e.is_user_annotation:
            spans.append((e.time_range.start, e.time_range.end))
            total, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (total + ms, n + 1)
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    wall_ms = wall_s * 1e3
    print(f"== {title}: wall {wall_ms:.1f} ms, device busy "
          f"{busy_us / 1e3:.2f} ms ({100 * busy_us / 1e3 / wall_ms:.2f}%)")
    for k in labels:
        print(f"   host {k:<36} {host[k]:10.2f} ms")
    for k, (ms, n) in sorted(by_name.items(), key=lambda x: -x[1][0])[:8]:
        print(f"   device {ms:10.3f} ms  x{n:<6} {k[:70]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_port: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (FAMILIES, LAKE_TABLES, M, MICRO_BATCH, QUERIES,
                            QUERY_ROWS, card_identity, make_lake)
    from repro_torch import SketchSearchService

    args = sys.argv[1:]
    packed = "--packed" in args
    families = ((args[args.index("--family") + 1],) if "--family" in args
                else FAMILIES)
    print(card_identity() + (", packed stores" if packed else ""))
    rng = np.random.default_rng(4)
    tables, queries, _ = make_lake(rng, LAKE_TABLES, QUERIES)
    for family in families:
        svc = SketchSearchService(m=M, seed=0, family=family, packed=packed,
                                  keep_host_oracle=False)
        idx = svc.index
        split = len(tables) - TRACED
        svc.ingest_many(tables[:split])          # builds and warms up
        svc.search_batch(queries[:MICRO_BATCH], top_k=10,
                         min_join=QUERY_ROWS / 4)
        torch.cuda.synchronize()

        labels = (label_calls(svc, ["ingest"])
                  + label_calls(idx, ["add_table", "query", "query_batch",
                                      "vectorize", "_register_table",
                                      "_estimate", "_assemble_results"])
                  + label_calls(idx.family, ["sketch_rows", "estimate_fields",
                                             "estimate_fields_packed"])
                  + label_calls(idx.store, ["append"])
                  + label_calls(idx.kmv, ["sketch"]))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            svc.ingest_many(tables[split:])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        report(f"{family}: ingest of {TRACED} tables", prof, wall, labels)

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            svc.search_batch(queries, top_k=10, min_join=QUERY_ROWS / 4,
                             micro_batch=MICRO_BATCH)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        report(f"{family}: {QUERIES // MICRO_BATCH} micro-batches of "
               f"{MICRO_BATCH} queries against {len(idx.tables)} tables",
               prof, wall, labels)

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for keys, values in queries:
                svc.search(keys, values, top_k=10, min_join=QUERY_ROWS / 4)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        report(f"{family}: {QUERIES} searches (Q = 1) against "
               f"{len(idx.tables)} tables", prof, wall, labels)
        del svc, idx
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
