"""Structured spans in an in-memory ring buffer (stdlib only; a copy of
``repro.obs.trace``).

``span("store.append", family="icws", rows=3)`` times a block and, when
observability is enabled, appends one *complete* event to a bounded ring
(``REPRO_OBS_RING`` events, default 4,096).  The ring exports as Chrome
trace-event JSON (:func:`chrome_trace` / :func:`save_chrome_trace`:
``chrome://tracing`` / Perfetto ``X`` events, microsecond timestamps from
process start) and as one JSON object a line (:func:`save_jsonl`).  Times
are host wall times (``time.perf_counter``): a span around work that
launches kernels covers their dispatch, not their run on the card.

When observability is disabled, :func:`span` returns a shared null
context: no allocation, no clock reads, no ring append.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

from repro_torch.obs import metrics as _m

RING_CAPACITY = int(os.environ.get("REPRO_OBS_RING", "4096"))

_EPOCH = time.perf_counter()
_RING: deque = deque(maxlen=RING_CAPACITY)
_PID = os.getpid()


class _NullSpan:
    """Shared no-op span for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, key, value):
        pass


_NULL = _NullSpan()


class Span:
    __slots__ = ("name", "args", "_t0")

    def __init__(self, name: str, args: dict):
        self.name = name
        self.args = args
        self._t0 = 0.0

    def set(self, key: str, value) -> None:
        """Attach an attribute discovered mid-span (e.g. a result size)."""
        self.args[key] = value

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        event = {
            "name": self.name,
            "ph": "X",
            "cat": self.name.split(".", 1)[0],
            "ts": (self._t0 - _EPOCH) * 1e6,
            "dur": (t1 - self._t0) * 1e6,
            "pid": _PID,
            "tid": threading.get_ident() % 1_000_000,
            "args": {k: _jsonable(v) for k, v in self.args.items()},
        }
        if exc_type is not None:
            event["args"]["error"] = exc_type.__name__
        _RING.append(event)
        return False


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


def span(name: str, **attrs):
    """Time a block as a structured span; a strict no-op when disabled."""
    if not _m.enabled():
        return _NULL
    return Span(name, attrs)


def add_complete_event(name: str, t0: float, t1: float, args: dict) -> None:
    """Append a complete event from already-taken perf_counter readings.

    Used by the ops instrumentation decorator, which times the launch once
    and feeds both the latency histogram and the trace ring from the same
    clock pair.
    """
    _RING.append({
        "name": name,
        "ph": "X",
        "cat": name.split(".", 1)[0],
        "ts": (t0 - _EPOCH) * 1e6,
        "dur": (t1 - t0) * 1e6,
        "pid": _PID,
        "tid": threading.get_ident() % 1_000_000,
        "args": {k: _jsonable(v) for k, v in args.items()},
    })


def events() -> list:
    """Current ring contents, oldest first."""
    return list(_RING)


def reset_trace() -> None:
    _RING.clear()


def chrome_trace() -> dict:
    return {"traceEvents": events(), "displayTimeUnit": "ms"}


def save_chrome_trace(path: str) -> None:
    with open(path, "w") as fh:
        json.dump(chrome_trace(), fh)
        fh.write("\n")


def save_jsonl(path: str) -> None:
    with open(path, "w") as fh:
        for event in _RING:
            fh.write(json.dumps(event, sort_keys=True))
            fh.write("\n")
