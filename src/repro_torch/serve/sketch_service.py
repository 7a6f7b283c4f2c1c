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
(kept by default, ``keep_host_oracle=True``, as in the JAX service).

Request accounting is always on, in private
:class:`repro_torch.obs.metrics.Histogram` instances.  With observability
on (``REPRO_OBS=1`` or ``repro_torch.obs.enable()``) the service also
records the JAX service's spans (``serve.ingest``, ``serve.ingest_sharded``,
``serve.search``, ``serve.search_batch``), counters and registered
histograms (``serve.*``), and with ``audit_every=N`` every N-th
``search`` of an ICWS device index that kept its host oracle re-scores
its results against that oracle into ``quality.ppm_error``.  None of it
changes what an endpoint returns.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs as _obs
from repro_torch.data import DatasetSearchIndex, SearchResult
from repro_torch.obs.metrics import Histogram


class ServiceStats:
    """Request accounting: tables and rows ingested, and latency
    histograms of single searches, micro-batches and per-query batched
    latency (micro-batch wall time / its size)."""

    def __init__(self) -> None:
        self.tables_ingested = 0
        self.rows_ingested = 0
        self.batch_queries_served = 0
        self.query_hist = Histogram("serve.query_seconds")
        self.batch_hist = Histogram("serve.batch_seconds")
        self.batched_query_hist = Histogram("serve.batched_query_seconds")

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
    ``backend="device"`` or, for ICWS, ``"host"``; ``mesh`` (a
    :class:`repro_torch.launch.CorpusMesh`) shards the index's corpus rows
    over its corpus axis, bit for bit the single-device results.
    ``audit_every=N > 0``, with observability on, re-scores every N-th
    single search against the host oracle (:meth:`_maybe_audit`).
    """

    def __init__(self, m: int = 256, seed: int = 0,
                 backend: str = "device", keep_host_oracle: bool = True,
                 mesh=None, family: str = "icws", packed: bool = False,
                 audit_every: int = 0, device="cuda"):
        self.index = DatasetSearchIndex(m=m, seed=seed, backend=backend,
                                        keep_host_oracle=keep_host_oracle,
                                        mesh=mesh, family=family,
                                        packed=packed, device=device)
        self.stats = ServiceStats()
        self._tenant_hists: Dict[str, Histogram] = {}
        self.audit_every = int(audit_every)

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
        with _obs.span("serve.ingest", table=name, tenant=tenant):
            self.index.add_table(name, keys, values, tenant=tenant)
        self.stats.tables_ingested += 1
        self.stats.rows_ingested += len(keys)
        if _obs.enabled():
            _obs.counter("serve.tables_ingested_total").inc()
            _obs.counter("serve.rows_ingested_total").inc(len(keys))

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
        with _obs.span("serve.ingest_sharded", shards=shards, tenant=tenant,
                       tables=len(tables)):
            self.index.add_tables_sharded(tables, shards=shards,
                                          tenant=tenant)
        rows = sum(len(k) for _, k, _ in tables)
        self.stats.tables_ingested += len(tables)
        self.stats.rows_ingested += rows
        if _obs.enabled():
            _obs.counter("serve.tables_ingested_total").inc(len(tables))
            _obs.counter("serve.rows_ingested_total").inc(rows)

    # -- queries ------------------------------------------------------------
    def search(self, keys: np.ndarray, values: np.ndarray, *,
               top_k: int = 10, min_join: float = 1.0,
               backend: Optional[str] = None,
               tenant: Optional[str] = None) -> List[SearchResult]:
        """Rank tables by |corr|; ``tenant`` searches one logical corpus."""
        t0 = time.perf_counter()
        with _obs.span("serve.search", tenant=tenant,
                       family=self.index.family.name,
                       backend=backend or self.index.backend):
            results = self.index.query(keys, values, top_k=top_k,
                                       min_join=min_join, backend=backend,
                                       tenant=tenant)
        dt = time.perf_counter() - t0
        self.stats.query_hist.record(dt)
        self._record_request("search", dt, tenant)
        if self.audit_every:
            self._maybe_audit(keys, values, results, top_k, min_join,
                              backend, tenant)
        return results

    # -- telemetry ----------------------------------------------------------
    def _record_request(self, endpoint: str, dt: float,
                        tenant: Optional[str]) -> None:
        if tenant is not None:
            hist = self._tenant_hists.get(str(tenant))
            if hist is None:
                hist = Histogram("serve.tenant_seconds",
                                 {"tenant": str(tenant)})
                self._tenant_hists[str(tenant)] = hist
            hist.record(dt)
        if not _obs.enabled():
            return
        _obs.histogram("serve.request_seconds", endpoint=endpoint).record(dt)
        if endpoint == "search":
            _obs.counter("serve.queries_total").inc()
        if tenant is not None:
            _obs.histogram("serve.tenant_request_seconds",
                           tenant=str(tenant)).record(dt)

    def _maybe_audit(self, keys, values, results, top_k, min_join,
                     backend, tenant) -> None:
        """Every ``audit_every``-th search, re-score the results against the
        host oracle (``backend="host"``) and feed each matched table's join
        size pair to ``quality.ppm_error``.  Skips unless observability is
        on, the search ran on the device, the family is ICWS, the index
        kept its host oracle and the results are not empty; it never
        changes what the endpoint returns."""
        if not _obs.enabled() or not results:
            return
        if (backend or self.index.backend) != "device":
            return
        if self.index.family.name != "icws" or not self.index.keep_host_oracle:
            return
        if self.stats.queries_served % self.audit_every != 0:
            return
        ref = self.index.query(keys, values, top_k=top_k, min_join=min_join,
                               backend="host", tenant=tenant)
        ref_by_name = {r.name: r for r in ref}
        for r in results:
            mate = ref_by_name.get(r.name)
            if mate is None or mate.join_size == 0:
                continue
            _obs.record_sample(self.index.family.name, r.join_size,
                               mate.join_size)

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
            with _obs.span("serve.search_batch", tenant=tenant,
                           family=self.index.family.name,
                           batch=len(chunk)):
                out = self.index.query_batch(padded, top_k=top_k,
                                             min_join=min_join,
                                             backend=backend, tenant=tenant)
            results.extend(out[:len(chunk)])
            dt = time.perf_counter() - t0
            self.stats.batch_hist.record(dt)
            self.stats.batched_query_hist.record(dt / len(chunk))
            self.stats.batch_queries_served += len(chunk)
            self._record_request("search_batch", dt, tenant)
            if _obs.enabled():
                _obs.counter("serve.batches_total").inc()
                _obs.counter("serve.batch_queries_total").inc(len(chunk))
                _obs.histogram("serve.batched_query_seconds").record(
                    dt / len(chunk))
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


def _latency_fields(prefix: str, hist: Histogram) -> Dict[str, float]:
    """p50/p95/p99 (ms) of one latency histogram, keyed ``<prefix>_p50``..."""
    return {
        prefix + "_p50": hist.quantile(0.50) * 1e3,
        prefix + "_p95": hist.quantile(0.95) * 1e3,
        prefix + "_p99": hist.quantile(0.99) * 1e3,
    }
