"""Instrumentation decorator for the public launch wrappers of
``repro_torch.kernels.ops`` (a copy of ``repro.obs.instrument``).

``@instrumented("icws_sketch")`` wraps one public op.  With observability
disabled the wrapper is a strict pass-through: one module-level bool read,
then a tail call.  When enabled, each call records

* ``ops.launches_total{op, family}``, under the ambient
  :func:`repro_torch.obs.metrics.family_context` (``-`` outside one);
* ``ops.first_call_seconds{op}``, the first call of each op (the
  kernels' ``nvcc`` build and load land here);
* ``ops.launch_seconds{op, family}``, every later call;
* one complete trace event ``ops.<op>``.

The times are host wall time of the call: on a CUDA tensor that is the
dispatch of the launch, not its run on the card (kernel launches are
asynchronous, and the wrapper adds no ``torch.cuda.synchronize()``, which
would change what a request's latency measures); on a CPU tensor the
plain version runs inside the call.  Device time per kernel comes from
``chip_smoke.py``'s CUDA events.

An op that calls another public op (``icws_estimate_fields`` calls
``estimate_partials_fields``) counts both, on every call: the port has no
jit, so nothing is counted only while tracing.  So does a sharded op: a
call of ``icws_estimate_fields_sharded`` counts once under its own name and
once a shard under ``icws_estimate_fields`` (and that op's inner one),
where JAX counts the op inside ``shard_map`` only while it traces.
"""
from __future__ import annotations

import functools
import time

from repro_torch.obs import metrics as _m
from repro_torch.obs import trace as _t


def instrumented(op: str):
    """Decorate a public launch wrapper with telemetry under name ``op``."""

    def deco(fn):
        state = {"first_seen": False}

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _m.enabled():
                return fn(*args, **kwargs)
            family = _m.current_family()
            _m.counter("ops.launches_total", op=op, family=family).inc()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            t1 = time.perf_counter()
            dt = t1 - t0
            if state["first_seen"]:
                _m.histogram("ops.launch_seconds", op=op, family=family).record(dt)
            else:
                state["first_seen"] = True
                _m.histogram("ops.first_call_seconds", op=op).record(dt)
            _t.add_complete_event("ops." + op, t0, t1, {"family": family})
            return out

        wrapper.obs_op = op
        wrapper.__wrapped__ = fn
        return wrapper

    return deco
