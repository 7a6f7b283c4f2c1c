"""Declared metric registry: every metric name the port may emit (a copy
of ``repro.obs.registry``).

``SPECS`` is a **pure literal** tuple of dicts, equal by value to the JAX
package's (a test holds them equal), help strings included, so the repo's
generated ``METRICS.md`` describes both packages.  It adds no metric name:
keep every entry a plain dict of strings and tuples, no computed values.

The runtime side (:mod:`repro_torch.obs.metrics`) validates every
``counter()`` / ``gauge()`` / ``histogram()`` call against this table: an
undeclared metric name, a wrong kind, or a wrong label set raises at the
call site.

Fields per spec: ``name`` (dotted, counters end in ``_total``), ``type``
("counter" | "gauge" | "histogram"), ``labels`` (the label keys every
series carries), ``unit`` and ``help`` (one line, the Prometheus HELP
line).
"""
from __future__ import annotations

SPECS = (
    # -- kernels / ops layer -------------------------------------------------
    {"name": "ops.launches_total", "type": "counter",
     "labels": ("op", "family"), "unit": "launches",
     "help": "Calls through a public repro.kernels.ops launch wrapper, by "
             "op and ambient serving family ('-' outside a family "
             "context)."},
    {"name": "ops.launch_seconds", "type": "histogram",
     "labels": ("op", "family"), "unit": "s",
     "help": "Steady-state wall time per public ops launch (dispatch time "
             "on async backends; end-to-end under the CPU interpreter). "
             "The first observed call per op lands in "
             "ops.first_call_seconds instead."},
    {"name": "ops.first_call_seconds", "type": "histogram",
     "labels": ("op",), "unit": "s",
     "help": "Wall time of the first observed call per op -- jit trace + "
             "compile + execute -- split out so compile cost never "
             "pollutes the steady-state latency histogram."},
    {"name": "ops.autotune_resolved_total", "type": "counter",
     "labels": ("kernel", "source"), "unit": "resolutions",
     "help": "Autotune block-size resolutions at trace time: "
             "source='tuned' when the roofline cache supplied blocks, "
             "'default' when the kernel's declared defaults ran."},
    {"name": "ops.interpret_mode", "type": "gauge",
     "labels": (), "unit": "bool",
     "help": "1 when Pallas launches run under the interpreter (non-TPU "
             "backend), 0 for compiled TPU launches."},
    # -- data / store layer --------------------------------------------------
    {"name": "store.resident_bytes", "type": "gauge",
     "labels": ("family",), "unit": "B",
     "help": "Allocated device bytes (capacity x fields x bytes/row) of "
             "the most recently touched CorpusStore of each family."},
    {"name": "store.rows", "type": "gauge",
     "labels": ("family",), "unit": "rows",
     "help": "Live rows (per field) of the most recently touched "
             "CorpusStore of each family."},
    {"name": "store.appends_total", "type": "counter",
     "labels": ("family",), "unit": "appends",
     "help": "CorpusStore.append batches written, by family."},
    {"name": "store.grows_total", "type": "counter",
     "labels": ("family",), "unit": "growths",
     "help": "Capacity-doubling buffer growths, by family."},
    {"name": "merge.merges_total", "type": "counter",
     "labels": ("family",), "unit": "merges",
     "help": "merge_stores calls (pairwise shard-merge steps), by family."},
    # -- serving layer -------------------------------------------------------
    {"name": "serve.request_seconds", "type": "histogram",
     "labels": ("endpoint",), "unit": "s",
     "help": "Per-request latency by endpoint: 'search' times one query, "
             "'search_batch' times one micro-batch."},
    {"name": "serve.batched_query_seconds", "type": "histogram",
     "labels": (), "unit": "s",
     "help": "Per-query latency through the batched endpoint: micro-batch "
             "wall time / batch size, one observation per micro-batch."},
    {"name": "serve.tenant_request_seconds", "type": "histogram",
     "labels": ("tenant",), "unit": "s",
     "help": "Per-request latency of tenant-scoped queries, by tenant."},
    {"name": "serve.queries_total", "type": "counter",
     "labels": (), "unit": "queries",
     "help": "Single-query search requests served."},
    {"name": "serve.batches_total", "type": "counter",
     "labels": (), "unit": "batches",
     "help": "Micro-batches served through search_batch."},
    {"name": "serve.batch_queries_total", "type": "counter",
     "labels": (), "unit": "queries",
     "help": "Individual queries served through search_batch."},
    {"name": "serve.tables_ingested_total", "type": "counter",
     "labels": (), "unit": "tables",
     "help": "Tables ingested into the serving index."},
    {"name": "serve.rows_ingested_total", "type": "counter",
     "labels": (), "unit": "rows",
     "help": "Raw table rows ingested into the serving index."},
    # -- estimator quality ---------------------------------------------------
    {"name": "quality.ppm_error", "type": "gauge",
     "labels": ("family",), "unit": "ppm",
     "help": "Rolling (EWMA, alpha=0.2) normalized estimator error in "
             "parts-per-million, from sampled query pairs re-scored "
             "against the host oracle or ground truth, by family."},
    {"name": "quality.samples_total", "type": "counter",
     "labels": ("family",), "unit": "samples",
     "help": "Quality-channel re-score samples recorded, by family."},
)
