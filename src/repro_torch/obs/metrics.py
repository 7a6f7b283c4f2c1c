"""Counters, gauges, and log-scale latency histograms (stdlib only; a copy
of ``repro.obs.metrics``).

1. **Strict no-op when disabled.**  Instrumented paths guard on
   :func:`enabled` before touching any metric, so with ``REPRO_OBS`` unset
   the cost a call is one module-level bool read and nothing the card
   computes changes.
2. **O(1) record, no locks.**  Every ``record``/``inc``/``set`` is a
   handful of arithmetic ops on Python ints and floats.
3. **Mergeable.**  Histograms use one fixed bucket layout (log10,
   exponents [-7, 3), 4 buckets a decade), so they merge by bucketwise
   addition; min/max/sum/count merge exactly.
4. **Declared namespace.**  Registered metrics must appear in
   :data:`repro_torch.obs.registry.SPECS` with the exact kind and label
   keys; anything else raises at the call site.  Private (unregistered)
   ``Histogram`` instances serve the service's always-on latency stats.

Quantiles: each histogram keeps a window of the ``RECENT_WINDOW`` = 128
most recent values.  While it holds every observation, quantiles are exact
order statistics; beyond that, the geometric midpoint of the bucket that
holds the quantile, clamped to the exact min and max.  The arithmetic is
JAX's value for value.
"""
from __future__ import annotations

import json
import math
import os
import threading
from collections import deque

from repro_torch.obs.registry import SPECS

# --------------------------------------------------------------------------
# enable/disable
# --------------------------------------------------------------------------

_ENABLED = os.environ.get("REPRO_OBS", "") not in ("", "0", "false", "no")


def enabled() -> bool:
    """True when the opt-in observability layer is recording."""
    return _ENABLED


def enable() -> None:
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


# --------------------------------------------------------------------------
# ambient label context (family attribution for ops-layer launches)
# --------------------------------------------------------------------------

_TLS = threading.local()


def current_family() -> str:
    stack = getattr(_TLS, "family", None)
    return stack[-1] if stack else "-"


class family_context:
    """Push an ambient ``family`` label for the duration of a block.

    The ops-layer decorator reads :func:`current_family` so that launches
    issued on behalf of a sketch family (via ``data/families.py``) are
    attributed to it without threading a label through every call site.
    Reentrant and thread-local; usable as decorator sugar is deliberately
    omitted -- call sites are explicit ``with`` blocks.
    """

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = str(name)

    def __enter__(self):
        stack = getattr(_TLS, "family", None)
        if stack is None:
            stack = []
            _TLS.family = stack
        stack.append(self.name)
        return self

    def __exit__(self, *exc):
        _TLS.family.pop()
        return False


# --------------------------------------------------------------------------
# histogram bucket layout (fixed, global, so all histograms merge)
# --------------------------------------------------------------------------

BUCKET_LO_EXP = -7          # first finite bucket starts at 1e-7
BUCKET_HI_EXP = 3           # last finite bucket ends at 1e3
BUCKETS_PER_DECADE = 4
N_FINITE = (BUCKET_HI_EXP - BUCKET_LO_EXP) * BUCKETS_PER_DECADE
LAYOUT = "log10[%d,%d)x%d" % (BUCKET_LO_EXP, BUCKET_HI_EXP, BUCKETS_PER_DECADE)

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


def bucket_bounds(i: int) -> tuple[float, float]:
    """(lo, hi) of finite bucket slot ``i`` in [1, N_FINITE]."""
    e = (i - 1 - _LOG_SHIFT) / _LOG_SCALE
    return 10.0 ** e, 10.0 ** (e + 1.0 / _LOG_SCALE)


# --------------------------------------------------------------------------
# metric kinds
# --------------------------------------------------------------------------

class Counter:
    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: dict | None = None):
        self.name = name
        self.labels = dict(labels or {})
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def as_dict(self) -> dict:
        return {"labels": self.labels, "value": self.value}

    def merge(self, other: "Counter") -> None:
        self.value += other.value


class Gauge:
    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: dict | None = None):
        self.name = name
        self.labels = dict(labels or {})
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def as_dict(self) -> dict:
        return {"labels": self.labels, "value": self.value}


class Histogram:
    """Fixed-bucket log-scale histogram with exact min/max/sum and a bounded
    exact-quantile window.  Construct directly for a private (unregistered)
    histogram, or via :func:`histogram` for a registered series."""

    __slots__ = ("name", "labels", "count", "sum", "min", "max", "last",
                 "buckets", "recent")

    def __init__(self, name: str = "", labels: dict | None = None):
        self.name = name
        self.labels = dict(labels or {})
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.last = 0.0
        self.buckets = [0] * (N_FINITE + 2)
        self.recent = deque(maxlen=RECENT_WINDOW)

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

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        if self.count == 0:
            return 0.0
        if len(self.recent) == self.count:
            # window covers every observation: exact order statistic
            xs = sorted(self.recent)
            k = min(len(xs) - 1, max(0, int(math.ceil(q * len(xs))) - 1))
            return xs[k]
        # bucket interpolation: geometric midpoint, clamped to exact extremes
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
                mid = math.sqrt(lo * hi)
                return min(max(mid, self.min), self.max)
        return self.max

    def merge(self, other: "Histogram") -> None:
        """Bucketwise in-place merge; exact for count/sum/min/max, and the
        recent windows concatenate (still exact while the union fits)."""
        if len(other.buckets) != len(self.buckets):
            raise ValueError("histogram bucket layouts differ; cannot merge")
        self.count += other.count
        self.sum += other.sum
        if other.count:
            self.min = min(self.min, other.min)
            self.max = max(self.max, other.max)
            self.last = other.last
        for i, n in enumerate(other.buckets):
            self.buckets[i] += n
        self.recent.extend(other.recent)

    def as_dict(self) -> dict:
        d = {
            "labels": self.labels,
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            "last": self.last,
            "p50": self.quantile(0.50),
            "p90": self.quantile(0.90),
            "p99": self.quantile(0.99),
            "layout": LAYOUT,
            "buckets": list(self.buckets),
        }
        return d


# --------------------------------------------------------------------------
# registry of live series
# --------------------------------------------------------------------------

_SPEC_BY_NAME = {s["name"]: s for s in SPECS}
_KIND_CLS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}
_SERIES: dict = {}


def _series(kind: str, name: str, labels: dict):
    spec = _SPEC_BY_NAME.get(name)
    if spec is None:
        raise KeyError("undeclared metric %r; add it to repro_torch.obs.registry.SPECS" % name)
    if spec["type"] != kind:
        raise TypeError("metric %r is declared as %s, not %s" % (name, spec["type"], kind))
    if set(labels) != set(spec["labels"]):
        raise ValueError("metric %r requires labels %r, got %r"
                         % (name, spec["labels"], tuple(sorted(labels))))
    ordered = {k: str(labels[k]) for k in spec["labels"]}
    key = (name, tuple(ordered.values()))
    obj = _SERIES.get(key)
    if obj is None:
        obj = _KIND_CLS[kind](name, ordered)
        _SERIES[key] = obj
    return obj


def counter(name: str, **labels) -> Counter:
    return _series("counter", name, labels)


def gauge(name: str, **labels) -> Gauge:
    return _series("gauge", name, labels)


def histogram(name: str, **labels) -> Histogram:
    return _series("histogram", name, labels)


def reset() -> None:
    """Drop every registered series (trace ring is separate; see obs.trace)."""
    _SERIES.clear()


# --------------------------------------------------------------------------
# exporters
# --------------------------------------------------------------------------

def describe_metrics() -> dict:
    """Snapshot of every live series, grouped by declared metric."""
    metrics: dict = {}
    for (name, _), obj in sorted(_SERIES.items(), key=lambda kv: kv[0]):
        spec = _SPEC_BY_NAME[name]
        entry = metrics.setdefault(name, {
            "type": spec["type"], "unit": spec["unit"], "help": spec["help"],
            "series": [],
        })
        entry["series"].append(obj.as_dict())
    return {"version": 1, "enabled": enabled(), "metrics": metrics}


def save_metrics(path: str) -> None:
    with open(path, "w") as fh:
        json.dump(describe_metrics(), fh, indent=1, sort_keys=True)
        fh.write("\n")


def _prom_name(name: str) -> str:
    return "repro_" + name.replace(".", "_")


def _prom_labels(labels: dict, extra: dict | None = None) -> str:
    items = dict(labels)
    if extra:
        items.update(extra)
    if not items:
        return ""
    body = ",".join('%s="%s"' % (k, str(v).replace('"', '\\"'))
                    for k, v in items.items())
    return "{" + body + "}"


def prometheus_text() -> str:
    """Prometheus exposition format (text/plain; version 0.0.4)."""
    out: list[str] = []
    snap = describe_metrics()["metrics"]
    for spec in SPECS:
        name = spec["name"]
        entry = snap.get(name)
        if entry is None:
            continue
        pname = _prom_name(name)
        out.append("# HELP %s %s" % (pname, spec["help"]))
        out.append("# TYPE %s %s" % (pname, spec["type"]))
        for s in entry["series"]:
            labels = s["labels"]
            if spec["type"] in ("counter", "gauge"):
                out.append("%s%s %s" % (pname, _prom_labels(labels), s["value"]))
                continue
            cum = 0
            for i, n in enumerate(s["buckets"]):
                cum += n
                if i == 0:
                    le = "%g" % (10.0 ** BUCKET_LO_EXP)
                elif i <= N_FINITE:
                    le = "%g" % bucket_bounds(i)[1]
                else:
                    le = "+Inf"
                out.append("%s_bucket%s %d"
                           % (pname, _prom_labels(labels, {"le": le}), cum))
            out.append("%s_sum%s %g" % (pname, _prom_labels(labels), s["sum"]))
            out.append("%s_count%s %d" % (pname, _prom_labels(labels), s["count"]))
    return "\n".join(out) + "\n"
