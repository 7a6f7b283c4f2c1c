"""Estimator-quality telemetry channel (a copy of ``repro.obs.quality``).

Serving has no ground truth, but it has a slower reference: the host
oracle an ICWS ``DatasetSearchIndex`` keeps.  Sampled re-scores against it
become a rolling error gauge a family:

* ``quality.samples_total{family}`` counts samples;
* ``quality.ppm_error{family}`` holds an exponentially weighted moving
  average (alpha = 0.2) of the normalized absolute error in parts per
  million.

The service's ``audit_every`` feeds it; recording is gated on
:func:`repro_torch.obs.metrics.enabled`, so the channel is free when
observability is off.
"""
from __future__ import annotations

from repro_torch.obs import metrics as _m

EWMA_ALPHA = 0.2

_EWMA: dict = {}


def record_sample(family: str, estimate: float, reference: float,
                  scale: float | None = None) -> float | None:
    """Record one re-scored pair; returns the updated rolling ppm or None.

    ``scale`` overrides the normalization denominator (use the norm product
    or value range when references can be near zero); it defaults to
    ``|reference|``, with a floor of 1.0 to keep tiny references from
    exploding the ratio.
    """
    if not _m.enabled():
        return None
    denom = abs(float(reference)) if scale is None else float(scale)
    denom = max(denom, 1.0) if scale is None else max(denom, 1e-30)
    ppm = abs(float(estimate) - float(reference)) / denom * 1e6
    prev = _EWMA.get(family)
    cur = ppm if prev is None else EWMA_ALPHA * ppm + (1.0 - EWMA_ALPHA) * prev
    _EWMA[family] = cur
    _m.counter("quality.samples_total", family=family).inc()
    _m.gauge("quality.ppm_error", family=family).set(cur)
    return cur


def rolling_ppm(family: str) -> float | None:
    """Current EWMA ppm error for ``family``, or None if never sampled."""
    return _EWMA.get(family)


def reset_quality() -> None:
    _EWMA.clear()
