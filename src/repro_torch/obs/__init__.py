"""Opt-in, standard-library-only observability for the port's serving
stack (a copy of ``repro.obs``, with the same public names and dump
schema).

Enable with ``REPRO_OBS=1`` in the environment (read at import) or
:func:`enable` at run time.  While disabled -- the default -- every
instrumented path is a strict no-op: one bool read a call, no metric
writes, no spans, and what the card computes is bit for bit the same.

Pieces:

* :mod:`repro_torch.obs.metrics` -- counters, gauges, mergeable log-bucket
  latency histograms; ``describe_metrics()`` and the Prometheus text.
* :mod:`repro_torch.obs.trace` -- structured spans, Chrome-trace and
  JSONL export.
* :mod:`repro_torch.obs.quality` -- sampled estimator re-scores, a
  rolling ppm-error gauge a family.
* :mod:`repro_torch.obs.instrument` -- ``@instrumented``, on every public
  launch of ``repro_torch.kernels.ops``.
* ``python -m repro_torch.obs show|diff`` -- print a metrics dump or diff
  two.

Every metric name is declared in :mod:`repro_torch.obs.registry`, equal by
value to the JAX package's registry.
"""
from __future__ import annotations

import os

from repro_torch.obs.instrument import instrumented
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    counter,
    current_family,
    describe_metrics,
    disable,
    enable,
    enabled,
    family_context,
    gauge,
    histogram,
    prometheus_text,
    reset,
    save_metrics,
)
from repro_torch.obs.quality import record_sample, reset_quality, rolling_ppm
from repro_torch.obs.registry import SPECS
from repro_torch.obs.trace import (
    chrome_trace,
    events,
    reset_trace,
    save_chrome_trace,
    save_jsonl,
    span,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "SPECS",
    "chrome_trace", "counter", "current_family", "describe_metrics",
    "disable", "enable", "enabled", "events", "export_snapshot",
    "family_context", "gauge", "histogram", "instrumented",
    "prometheus_text", "record_sample", "reset", "reset_all",
    "reset_quality", "reset_trace", "rolling_ppm", "save_chrome_trace",
    "save_jsonl", "save_metrics", "span",
]


def reset_all() -> None:
    """Clear metrics, the trace ring, and the quality EWMA state."""
    reset()
    reset_trace()
    reset_quality()


def export_snapshot(directory: str | None = None) -> dict:
    """Write metrics.json + trace.json (Chrome) + trace.jsonl to a directory.

    ``directory`` defaults to ``$REPRO_OBS_DIR`` or ``obs_snapshot``.
    Returns the written paths keyed by artifact name.
    """
    directory = directory or os.environ.get("REPRO_OBS_DIR") or "obs_snapshot"
    os.makedirs(directory, exist_ok=True)
    paths = {
        "metrics": os.path.join(directory, "metrics.json"),
        "chrome_trace": os.path.join(directory, "trace.json"),
        "jsonl": os.path.join(directory, "trace.jsonl"),
    }
    save_metrics(paths["metrics"])
    save_chrome_trace(paths["chrome_trace"])
    save_jsonl(paths["jsonl"])
    return paths
