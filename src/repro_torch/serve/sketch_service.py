"""Serving front end for corpus-scale dataset search (port of
``repro.serve.sketch_service``).

Wraps :class:`repro_torch.data.DatasetSearchIndex` in the shape a query
service needs: named-table ingestion, ``search`` / ``search_batch``
endpoints and request accounting.  Every query, single or batched, builds
its ``3Q`` field rows with the index's family (one sketch launch for ICWS,
DMH, CountSketch and JL; host-built sample rows for TS and PS) plus one
fused multi-field estimate launch off the index's store buffers;
``search_batch`` amortizes both across a micro-batch.  ``ingest_many_sharded``
ingests a batch through a shard-and-merge lake build, and
``backend="host"`` serves the ICWS index's WeightedMinHash host oracle
(kept by default, ``keep_host_oracle=True``, as in the JAX service).  The
JAX service's observability spans, counters and estimator audit
(``audit_every``) are not ported yet (``ROADMAP.md`` Queue A 15).
"""
from __future__ import annotations

import collections
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.data import DatasetSearchIndex, SearchResult


# Histogram bucket layout, copied from ``repro.obs.metrics`` so that the
# service's quantiles equal the JAX service's value for value.
BUCKET_LO_EXP = -7          # first finite bucket starts at 1e-7
BUCKET_HI_EXP = 3           # last finite bucket ends at 1e3
BUCKETS_PER_DECADE = 4
N_FINITE = (BUCKET_HI_EXP - BUCKET_LO_EXP) * BUCKETS_PER_DECADE
RECENT_WINDOW = 128

_LOG_SCALE = BUCKETS_PER_DECADE
_LOG_SHIFT = -BUCKET_LO_EXP * BUCKETS_PER_DECADE


def bucket_index(value: float) -> int:
    """Map a value to [0, N_FINITE+1]: 0 = underflow, N_FINITE+1 = overflow."""
    if value < 1e-7:            # includes 0 and negatives: underflow
        return 0
    i = math.floor(math.log10(value) * _LOG_SCALE) + _LOG_SHIFT
    if i < 0:
        return 0
    if i >= N_FINITE:
        return N_FINITE + 1
    return i + 1


def bucket_bounds(i: int) -> Tuple[float, float]:
    """(lo, hi) of finite bucket slot ``i`` in [1, N_FINITE]."""
    e = (i - 1 - _LOG_SHIFT) / _LOG_SCALE
    return 10.0 ** e, 10.0 ** (e + 1.0 / _LOG_SCALE)


class LatencyHistogram:
    """Log-scale bucket histogram with exact count, sum, min, max and last
    value and a window of the ``RECENT_WINDOW`` most recent values.

    Quantiles are exact order statistics while the window holds every
    observation; beyond that, the geometric midpoint of the bucket that
    holds the quantile, clamped to the exact min and max.
    """

    def __init__(self) -> None:
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.last = 0.0
        self.buckets = [0] * (N_FINITE + 2)
        self.recent = collections.deque(maxlen=RECENT_WINDOW)

    def record(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        self.last = v
        self.buckets[bucket_index(v)] += 1
        self.recent.append(v)

    def quantile(self, q: float) -> float:
        if self.count == 0:
            return 0.0
        if len(self.recent) == self.count:
            xs = sorted(self.recent)
            k = min(len(xs) - 1, max(0, int(math.ceil(q * len(xs))) - 1))
            return xs[k]
        target = q * self.count
        cum = 0
        for i, n in enumerate(self.buckets):
            cum += n
            if cum >= target and n:
                if i == 0:
                    return self.min
                if i == N_FINITE + 1:
                    return self.max
                lo, hi = bucket_bounds(i)
                return min(max(math.sqrt(lo * hi), self.min), self.max)
        return self.max


class ServiceStats:
    """Request accounting: tables and rows ingested, and latency
    histograms of single searches, micro-batches and per-query batched
    latency (micro-batch wall time / its size)."""

    def __init__(self) -> None:
        self.tables_ingested = 0
        self.rows_ingested = 0
        self.batch_queries_served = 0
        self.query_hist = LatencyHistogram()
        self.batch_hist = LatencyHistogram()
        self.batched_query_hist = LatencyHistogram()

    @property
    def queries_served(self) -> int:
        return self.query_hist.count

    @property
    def total_query_ms(self) -> float:
        return self.query_hist.sum * 1e3

    @property
    def last_query_ms(self) -> float:
        return self.query_hist.last * 1e3

    @property
    def batches_served(self) -> int:
        return self.batch_hist.count

    @property
    def total_batch_ms(self) -> float:
        return self.batch_hist.sum * 1e3

    @property
    def last_batch_ms(self) -> float:
        return self.batch_hist.last * 1e3

    @property
    def mean_query_ms(self) -> float:
        return self.total_query_ms / max(self.queries_served, 1)

    @property
    def mean_batch_ms(self) -> float:
        return self.total_batch_ms / max(self.batches_served, 1)

    @property
    def mean_batched_query_ms(self) -> float:
        """Per-query latency through the batched endpoint."""
        return self.total_batch_ms / max(self.batch_queries_served, 1)


class SketchSearchService:
    """Sketch-index serving: ingest tables once, answer joinability/corr
    queries against the whole corpus from sketches alone.

    Runs on the card (``device="cuda"``, the default) unless the caller
    passes ``device="cpu"``.  Ported: ``family`` in ``("icws", "cs",
    "jl", "ts", "ps", "dmh")`` (``FAMILY_NAMES``), each sized to the
    storage of an ``m``-sample ICWS sketch, unpacked or ``packed=True``;
    ``backend="device"`` or, for ICWS, ``"host"``; ``mesh=None``.  A
    ``mesh`` or ``audit_every`` raises ``NotImplementedError`` naming its
    ROADMAP.md item.
    """

    def __init__(self, m: int = 256, seed: int = 0,
                 backend: str = "device", keep_host_oracle: bool = True,
                 mesh=None, family: str = "icws", packed: bool = False,
                 audit_every: int = 0, device="cuda"):
        if audit_every:
            raise NotImplementedError(
                "audit_every (the estimator-quality audit) is not ported "
                "yet (Queue A 15 in ROADMAP.md)")
        self.index = DatasetSearchIndex(m=m, seed=seed, backend=backend,
                                        keep_host_oracle=keep_host_oracle,
                                        mesh=mesh, family=family,
                                        packed=packed, device=device)
        self.stats = ServiceStats()
        self._tenant_hists: Dict[str, LatencyHistogram] = {}

    # -- ingestion ----------------------------------------------------------
    def ingest(self, name: str, keys: np.ndarray, values: np.ndarray, *,
               tenant: Optional[str] = None) -> None:
        """Ingest one named table; ``tenant`` scopes it to a logical corpus
        of the shared arena.  Names are unique per tenant."""
        if any(t.name == name
               for t in self._tenant_tables_or_empty(tenant)):
            raise ValueError(f"table {name!r} already ingested"
                             + (f" for tenant {tenant!r}"
                                if tenant is not None else ""))
        self.index.add_table(name, keys, values, tenant=tenant)
        self.stats.tables_ingested += 1
        self.stats.rows_ingested += len(keys)

    def _tenant_tables_or_empty(self, tenant: Optional[str]):
        if tenant is not None and str(tenant) not in self.index.tenants():
            return []
        return self.index._tenant_table_list(tenant)

    def ingest_many(self, tables: Sequence[Tuple[str, np.ndarray, np.ndarray]],
                    *, tenant: Optional[str] = None) -> None:
        for name, keys, values in tables:
            self.ingest(name, keys, values, tenant=tenant)

    def ingest_many_sharded(self,
                            tables: Sequence[Tuple[str, np.ndarray,
                                                   np.ndarray]],
                            *, shards: int,
                            tenant: Optional[str] = None) -> None:
        """Ingest a batch of tables through a ``shards``-way lake build
        (:meth:`DatasetSearchIndex.add_tables_sharded`); names must be new
        to the tenant and unique within the batch."""
        tables = list(tables)
        seen = {t.name for t in self._tenant_tables_or_empty(tenant)}
        for name, _, _ in tables:
            if name in seen:
                raise ValueError(f"table {name!r} already ingested"
                                 + (f" for tenant {tenant!r}"
                                    if tenant is not None else ""))
            seen.add(name)
        self.index.add_tables_sharded(tables, shards=shards, tenant=tenant)
        self.stats.tables_ingested += len(tables)
        self.stats.rows_ingested += sum(len(k) for _, k, _ in tables)

    # -- queries ------------------------------------------------------------
    def search(self, keys: np.ndarray, values: np.ndarray, *,
               top_k: int = 10, min_join: float = 1.0,
               backend: Optional[str] = None,
               tenant: Optional[str] = None) -> List[SearchResult]:
        """Rank tables by |corr|; ``tenant`` searches one logical corpus."""
        t0 = time.perf_counter()
        results = self.index.query(keys, values, top_k=top_k,
                                   min_join=min_join, backend=backend,
                                   tenant=tenant)
        dt = time.perf_counter() - t0
        self.stats.query_hist.record(dt)
        self._record_tenant(dt, tenant)
        return results

    def _record_tenant(self, dt: float, tenant: Optional[str]) -> None:
        if tenant is not None:
            self._tenant_hists.setdefault(str(tenant),
                                          LatencyHistogram()).record(dt)

    _EMPTY_QUERY = (np.zeros(0, np.int64), np.zeros(0, np.float64))

    def search_batch(self, queries: Sequence[Tuple[np.ndarray, np.ndarray]],
                     *, top_k: int = 10, min_join: float = 1.0,
                     backend: Optional[str] = None, micro_batch: int = 16,
                     tenant: Optional[str] = None
                     ) -> List[List[SearchResult]]:
        """Batched search: Q ``(keys, values)`` queries, Q result lists.

        Queries run in micro-batches of ``micro_batch``; on the device
        backend the tail micro-batch is padded with empty queries so every
        launch sees the same batch shape (empty queries sketch to ``fp ==
        -1``, estimate to zero, and are dropped).  Results equal a loop of
        :meth:`search`.
        """
        if micro_batch < 1:
            raise ValueError("micro_batch must be >= 1")
        queries = list(queries)
        pad = (backend or self.index.backend) == "device"
        results: List[List[SearchResult]] = []
        for lo in range(0, len(queries), micro_batch):
            chunk = queries[lo:lo + micro_batch]
            t0 = time.perf_counter()
            padded = chunk + [self._EMPTY_QUERY] * (
                (micro_batch - len(chunk)) if pad else 0)
            out = self.index.query_batch(padded, top_k=top_k,
                                         min_join=min_join, backend=backend,
                                         tenant=tenant)
            results.extend(out[:len(chunk)])
            dt = time.perf_counter() - t0
            self.stats.batch_hist.record(dt)
            self.stats.batched_query_hist.record(dt / len(chunk))
            self.stats.batch_queries_served += len(chunk)
            self._record_tenant(dt, tenant)
        return results

    def describe(self, tenant: Optional[str] = None) -> Dict[str, object]:
        """Service accounting; with ``tenant``, scoped to that logical
        corpus (tables, rows, row ranges, storage-doubles share)."""
        store = self.index.store
        if tenant is not None:
            tables = self.index._tenant_table_list(tenant)
            if store is not None:
                acct = store.describe_tenants()[str(tenant)]
                rows, ranges = acct["rows"], acct["ranges"]
                storage = acct["storage_doubles"]
            else:
                rows, ranges = float(len(tables)), 1.0
                storage = float(len(tables) * 3
                                * self.index.family.storage_doubles_per_row())
            report = {
                "tenant": tenant,
                "family": self.index.family.name,
                "backend": self.index.backend,
                "tables": len(tables),
                "corpus_rows": rows,
                "row_ranges": ranges,
                "storage_doubles": storage,
            }
            hist = self._tenant_hists.get(str(tenant))
            if hist is not None and hist.count:
                report.update(_latency_fields("request_ms", hist))
            return report
        # a host-only index has no device store: one exact-size row per
        # table and field, as the JAX service reports
        n = len(self.index.tables)
        report = {
            "family": self.index.family.name,
            "backend": self.index.backend,
            "device": str(self.index.device),
            "packed": store.packed if store is not None else False,
            "bytes_per_row": float(store.bytes_per_row()
                                   if store is not None else 0),
            "tables": n,
            "tenants": len(self.index.tenants()),
            "storage_doubles": self.index.storage_doubles(),
            "corpus_rows": int(store.size if store is not None else n),
            "corpus_capacity": int(store.capacity if store is not None
                                   else n),
            "queries_served": self.stats.queries_served,
            "mean_query_ms": self.stats.mean_query_ms,
            "batches_served": self.stats.batches_served,
            "batch_queries_served": self.stats.batch_queries_served,
            "mean_batch_ms": self.stats.mean_batch_ms,
            "mean_batched_query_ms": self.stats.mean_batched_query_ms,
        }
        report.update(_latency_fields("query_ms", self.stats.query_hist))
        report.update(_latency_fields("batch_ms", self.stats.batch_hist))
        report.update(_latency_fields("batched_query_ms",
                                      self.stats.batched_query_hist))
        return report


def _latency_fields(prefix: str, hist: LatencyHistogram) -> Dict[str, float]:
    """p50/p95/p99 (ms) of one latency histogram, keyed ``<prefix>_p50``..."""
    return {
        prefix + "_p50": hist.quantile(0.50) * 1e3,
        prefix + "_p95": hist.quantile(0.95) * 1e3,
        prefix + "_p99": hist.quantile(0.99) * 1e3,
    }
