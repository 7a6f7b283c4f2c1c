"""The port's latency histogram (``repro_torch.obs.metrics``, which the
service records into) against ``repro.obs.metrics``.

The same seeded lognormal latencies, recorded into the port's
``Histogram`` and into the JAX package's ``Histogram``, give equal
quantiles, exact while the 128-value window holds every value and from log
buckets beyond it; ``describe()`` of both services reports the same
latency fields."""
import numpy as np
import pytest
import torch

from repro.obs import metrics
from repro.serve import SketchSearchService as JaxService
from repro_torch import SketchSearchService
from repro_torch.obs import metrics as port_metrics

torch.set_num_threads(1)

QUANTILES = (0.50, 0.95, 0.99)


def _latencies(n, seed=0):
    """``n`` lognormal(-6, 0.5) draws; past one value, a 0 (the underflow
    bucket) and, past two, a value above 1e3 (the overflow bucket)."""
    xs = np.random.default_rng(seed).lognormal(-6.0, 0.5, size=n)
    if n > 1:
        xs[n // 3] = 0.0
    if n > 2:
        xs[2 * n // 3] = 2.5e3
    return [float(x) for x in xs]


def test_histogram_constants_equal_the_jax_ones():
    for name in ("BUCKET_LO_EXP", "BUCKET_HI_EXP", "BUCKETS_PER_DECADE",
                 "N_FINITE", "RECENT_WINDOW"):
        assert getattr(port_metrics, name) == getattr(metrics, name), name
    for i in range(1, metrics.N_FINITE + 1):
        assert port_metrics.bucket_bounds(i) == metrics.bucket_bounds(i)
    for v in (0.0, -1.0, 1e-8, 1e-7, 3.3e-3, 999.0, 1e3, 5e4):
        assert port_metrics.bucket_index(v) == metrics.bucket_index(v)


@pytest.mark.parametrize("n", [1, 128, 129, 2000])
def test_quantiles_equal_the_jax_histogram(n):
    port, ref = port_metrics.Histogram(), metrics.Histogram()
    for x in _latencies(n):
        port.record(x)
        ref.record(x)
    assert (port.count, port.sum, port.last) == (ref.count, ref.sum, ref.last)
    for q in QUANTILES:
        assert port.quantile(q) == ref.quantile(q), q


def test_describe_latency_fields_equal_the_jax_service():
    port = SketchSearchService(m=16, device="cpu")
    ref = JaxService(m=16)
    xs = _latencies(300, seed=1)
    for svc in (port, ref):
        for x in xs:
            svc.stats.query_hist.record(x)
            svc.stats.batch_hist.record(2.0 * x)
            svc.stats.batched_query_hist.record(x / 4.0)
    got, want = port.describe(), ref.describe()
    keys = [k for k in want
            if k.startswith(("query_ms_", "batch_ms_", "batched_query_ms_"))]
    assert len(keys) == 9
    for k in keys:
        assert got[k] == want[k], k
    assert got["mean_query_ms"] == want["mean_query_ms"]
