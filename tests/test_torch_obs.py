"""The port's observability layer (``repro_torch.obs``) against ``repro.obs``.

The copies: ``SPECS`` equal by value, the bucket layout, ``Histogram``
quantiles, merges and dumps, the Prometheus text byte for byte, the
quality EWMA, registry validation, ``family_context``, the strict no-op
when disabled, ``@instrumented`` and the Chrome-trace schema, snapshots
read by both CLIs, OB001 on the port's ``ops.py`` and a standard-library
import check.  The serving path: rankings bit for bit equal with
observability on and off for all six families, unpacked and packed, on
both endpoints; the ``serve.*``, ``store.*``, ``merge.*`` and
``ops.launches_total`` series equal JAX's after the same requests; the
``audit_every`` estimator audit samples as JAX's does and changes no
result."""
import ast
import dataclasses
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro import obs as jax_obs
from repro.analysis.obs import _decorator_op
from repro.obs import metrics as jax_metrics
from repro.obs import registry as jax_registry
from repro.obs.__main__ import main as jax_cli
from repro.serve import SketchSearchService as JaxService
from repro_torch import SketchSearchService
from repro_torch import obs
from repro_torch.obs import metrics as port_metrics
from repro_torch.obs.__main__ import main as port_cli

# small shapes: one intra-op thread per test process, so that parallel
# test workers do not oversubscribe the cores
torch.set_num_threads(1)

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
FAMILIES = ("icws", "cs", "jl", "ts", "ps", "dmh")
M = 32
DOMAIN = 1500
MIN_JOIN = 3.0


@pytest.fixture(autouse=True)
def _clean_obs_state():
    """Every test starts with both packages disabled and empty, and leaves
    them so."""
    was = (obs.enabled(), jax_obs.enabled())
    for pkg in (obs, jax_obs):
        pkg.disable()
        pkg.reset_all()
    yield
    for pkg, on in zip((obs, jax_obs), was):
        (pkg.enable if on else pkg.disable)()
        pkg.reset_all()


def _both(fn):
    """``fn(pkg)`` for the port's package, then the JAX one's."""
    return fn(obs), fn(jax_obs)


def _values(n, seed=0):
    """``n`` lognormal(-6, 0.5) draws with a 0 (the underflow bucket) and
    a value past 1e3 (the overflow bucket) once there is room."""
    xs = np.random.default_rng(seed).lognormal(-6.0, 0.5, size=n)
    if n > 2:
        xs[n // 3], xs[2 * n // 3] = 0.0, 2.5e3
    return [float(x) for x in xs]


# ---------------------------------------------------------------------------
# the copies: registry, buckets, histograms, exporters, quality, validation
# ---------------------------------------------------------------------------
def test_specs_equal_the_jax_registry_by_value():
    assert obs.SPECS == jax_registry.SPECS
    assert len({s["name"] for s in obs.SPECS}) == len(obs.SPECS)
    assert sorted(obs.__all__) == sorted(jax_obs.__all__)


def test_bucket_layout_index_and_bounds_equal_jax():
    for name in ("BUCKET_LO_EXP", "BUCKET_HI_EXP", "BUCKETS_PER_DECADE",
                 "N_FINITE", "LAYOUT", "RECENT_WINDOW"):
        assert getattr(port_metrics, name) == getattr(jax_metrics, name)
    for i in range(1, jax_metrics.N_FINITE + 1):
        assert port_metrics.bucket_bounds(i) == jax_metrics.bucket_bounds(i)
    for v in [0.0, -1.0, 1e-8, 1e-7, 3.3e-3, 999.0, 1e3, 5e4] + \
            [10.0 ** e for e in np.linspace(-8, 4, 97)]:
        assert port_metrics.bucket_index(v) == jax_metrics.bucket_index(v)


@pytest.mark.parametrize("n", [5, 128, 129, 700])
def test_histogram_quantiles_merge_and_dump_equal_jax(n):
    """Inside the 128-value window (exact order statistics) and past it
    (bucket midpoints); a merge of two histograms, and the dump."""
    port = (port_metrics.Histogram("h", {"k": "v"}), port_metrics.Histogram())
    ref = (jax_metrics.Histogram("h", {"k": "v"}), jax_metrics.Histogram())
    for h, xs in zip((0, 1), (_values(n), _values(n // 2 + 1, seed=1))):
        for x in xs:
            port[h].record(x)
            ref[h].record(x)
    for q in (0.0, 0.25, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert port[0].quantile(q) == ref[0].quantile(q), q
    assert port[0].as_dict() == ref[0].as_dict()
    assert port[0].mean == ref[0].mean
    port[0].merge(port[1])
    ref[0].merge(ref[1])
    assert port[0].as_dict() == ref[0].as_dict()
    port[1].buckets = port[1].buckets[:-1]
    with pytest.raises(ValueError, match="layout"):
        port[0].merge(port[1])


def _record_series(pkg):
    pkg.enable()
    pkg.counter("serve.queries_total").inc(5)
    pkg.counter("ops.launches_total", op="icws_sketch", family="icws").inc(3)
    pkg.counter("ops.launches_total", op="jl_sketch", family="-").inc()
    pkg.gauge("store.rows", family="ts").set(17)
    pkg.gauge("ops.interpret_mode").set(1.0)
    for endpoint, xs in (("search", _values(40)),
                         ("search_batch", _values(300, seed=2))):
        h = pkg.histogram("serve.request_seconds", endpoint=endpoint)
        for x in xs:
            h.record(x)
    pkg.histogram("serve.tenant_request_seconds", tenant='a"b').record(0.01)
    return pkg.prometheus_text(), pkg.describe_metrics()


def test_prometheus_text_and_describe_equal_jax_byte_for_byte():
    (text, snap), (want_text, want_snap) = _both(_record_series)
    assert text == want_text
    assert 'repro_serve_request_seconds_count{endpoint="search"} 40' in text
    assert json.dumps(snap, sort_keys=True) == json.dumps(want_snap,
                                                          sort_keys=True)


def test_record_sample_ewma_equals_jax():
    rng = np.random.default_rng(3)
    obs.enable()
    jax_obs.enable()
    assert obs.record_sample("icws", 1.0, 2.0) == \
        jax_obs.record_sample("icws", 1.0, 2.0)
    for _ in range(50):
        est, ref = rng.normal(100, 20), rng.normal(100, 1)
        scale = None if rng.random() < 0.5 else float(rng.uniform(0, 300))
        family = "jl" if rng.random() < 0.3 else "icws"
        assert obs.record_sample(family, est, ref, scale) == \
            jax_obs.record_sample(family, est, ref, scale)
    for family in ("icws", "jl", "cs"):
        assert obs.rolling_ppm(family) == jax_obs.rolling_ppm(family)
        assert obs.describe_metrics() == jax_obs.describe_metrics()
    assert obs.quality.EWMA_ALPHA == jax_obs.quality.EWMA_ALPHA == 0.2


@pytest.mark.parametrize("kind, name, labels", [
    ("counter", "no.such_metric", {}),
    ("gauge", "ops.launches_total", {"op": "x", "family": "y"}),
    ("histogram", "serve.queries_total", {}),
    ("counter", "ops.launches_total", {"op": "x"}),
    ("counter", "ops.launches_total", {"op": "x", "family": "y", "z": 1}),
    ("gauge", "store.rows", {}),
    ("counter", "ops.launches_total", {"family": "y", "op": "x"}),
])
def test_registry_validation_raises_where_jax_does(kind, name, labels):
    def call(pkg):
        try:
            return type(getattr(pkg, kind)(name, **labels)).__name__
        except (KeyError, TypeError, ValueError) as e:
            return type(e)
    assert call(obs) == call(jax_obs)
    c1 = obs.counter("ops.launches_total", op="x", family="y")
    assert c1 is obs.counter("ops.launches_total", family="y", op="x")


def test_family_context_nests_and_off_is_a_strict_noop():
    assert obs.current_family() == "-"
    with obs.family_context("icws"):
        with obs.family_context("ts"):
            assert obs.current_family() == "ts"
        assert obs.current_family() == "icws"
    assert obs.current_family() == "-"
    calls = []
    wrapped = obs.instrumented("icws_estimate")(lambda x: calls.append(x) or x)
    assert wrapped(7) == 7 and calls == [7]
    assert wrapped.obs_op == "icws_estimate"
    assert obs.record_sample("icws", 1.0, 2.0) is None
    assert obs.span("store.append") is obs.span("merge.merge_stores")
    with obs.span("store.append", family="icws") as sp:
        sp.set("rows", 3)
    assert obs.events() == [] and obs.describe_metrics()["metrics"] == {}


def _instrumented_trace(pkg):
    pkg.enable()
    wrapped = pkg.instrumented("icws_estimate")(lambda: 42)
    with pkg.family_context("ts"):
        assert wrapped() == 42 and wrapped() == 42
    with pkg.span("store.append", family="icws", rows=4) as sp:
        sp.set("tenant", "a")
    with pytest.raises(RuntimeError):
        with pkg.span("merge.merge_stores", family="ts"):
            raise RuntimeError("boom")
    counts = (pkg.counter("ops.launches_total", op="icws_estimate",
                          family="ts").value,
              pkg.histogram("ops.first_call_seconds",
                            op="icws_estimate").count,
              pkg.histogram("ops.launch_seconds", op="icws_estimate",
                            family="ts").count)
    return counts, pkg.chrome_trace()


def test_instrumented_records_and_the_chrome_trace_schema_equal_jax():
    (counts, trace), (want_counts, want_trace) = _both(_instrumented_trace)
    assert counts == want_counts == (2, 1, 1)
    assert trace["displayTimeUnit"] == want_trace["displayTimeUnit"] == "ms"
    evts, want = trace["traceEvents"], want_trace["traceEvents"]
    assert [e["name"] for e in evts] == [e["name"] for e in want] == [
        "ops.icws_estimate", "ops.icws_estimate", "store.append",
        "merge.merge_stores"]
    for e, w in zip(evts, want):
        assert e.keys() == w.keys() and e["args"] == w["args"]
        assert e["ph"] == "X" and e["cat"] == e["name"].split(".")[0]
        assert isinstance(e["ts"], float) and isinstance(e["dur"], float)
        json.dumps(e)
    assert evts[1]["args"] == {"family": "ts"}
    assert evts[3]["args"]["error"] == "RuntimeError"


def test_export_snapshot_is_read_by_both_clis(tmp_path, capsys,
                                              monkeypatch):
    _record_series(obs)
    with obs.span("store.append", family="icws"):
        pass
    monkeypatch.setenv("REPRO_OBS_DIR", str(tmp_path / "snap"))
    paths = obs.export_snapshot()
    assert paths["metrics"] == str(tmp_path / "snap" / "metrics.json")
    snap = json.loads(pathlib.Path(paths["metrics"]).read_text())
    assert snap["version"] == 1 and snap["enabled"] is True
    trace = json.loads(pathlib.Path(paths["chrome_trace"]).read_text())
    assert trace["traceEvents"][0]["name"] == "store.append"
    assert pathlib.Path(paths["jsonl"]).read_text().count("\n") == 1
    obs.counter("serve.queries_total").inc(3)
    after = str(tmp_path / "after.json")
    obs.save_metrics(after)
    outs = []
    for cli in (port_cli, jax_cli):
        assert cli(["show", paths["metrics"]]) == 0
        assert cli(["diff", paths["metrics"], after]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert "serve.request_seconds{endpoint=search}" in outs[0]
    assert "+3 (5 -> 8)" in outs[0]


def test_every_public_op_is_instrumented_under_its_own_name():
    """OB001 (``repro.analysis.obs``), which checks only the JAX package's
    ``ops.py``, applied to the port's."""
    tree = ast.parse((SRC / "repro_torch/kernels/ops.py").read_text())
    public = [n for n in tree.body if isinstance(n, ast.FunctionDef)
              and not n.name.startswith("_")]
    assert len(public) == 29
    for node in public:
        ops = [op for dec in node.decorator_list
               for hit, op in (_decorator_op(dec),) if hit]
        assert ops == [node.name], node.name


def test_obs_modules_import_only_the_standard_library():
    files = sorted((SRC / "repro_torch/obs").glob("*.py"))
    assert len(files) == 7
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if not node.level else []
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert (top in sys.stdlib_module_names
                        or name.startswith("repro_torch.obs")), (path, name)


# ---------------------------------------------------------------------------
# the serving path
# ---------------------------------------------------------------------------
def _lake(seed=0, n_random=6, n_planted=3):
    """Random tables over a shared key domain plus planted partners of
    the first queries; a last query has no partner."""
    rng = np.random.default_rng(seed)
    tables, queries = [], []
    for i in range(n_planted):
        keys = rng.choice(DOMAIN, size=150, replace=False)
        vals = rng.normal(size=150)
        queries.append((keys, vals))
        keep = rng.random(150) < 0.85
        pk = np.concatenate([keys[keep], rng.integers(0, DOMAIN, 30)])
        pv = np.concatenate([2.0 * vals[keep]
                             + 0.2 * rng.normal(size=keep.sum()),
                             rng.normal(size=30)])
        tables.append((f"partner_{i}", pk, pv))
    for i in range(n_random):
        n = int(rng.integers(40, 200))
        tables.append((f"random_{i}", rng.integers(0, DOMAIN, n),
                       rng.normal(size=n)))
    order = rng.permutation(len(tables))
    queries.append((rng.choice(DOMAIN, 100, replace=False),
                    rng.normal(size=100)))
    return [tables[i] for i in order], queries


LAKE = _lake()


def _serve(svc, queries, **kw):
    """Both endpoints: a padded micro-batch run and a loop of search."""
    batch = svc.search_batch(queries, top_k=4, min_join=MIN_JOIN,
                             micro_batch=3, **kw)
    seq = [svc.search(k, v, top_k=4, min_join=MIN_JOIN, **kw)
           for k, v in queries]
    return batch, seq


def _rows(results):
    """Result lists as tuples (the two packages' ``SearchResult`` classes
    do not compare equal across them)."""
    return [[dataclasses.astuple(r) for r in res] for res in results]


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("family", FAMILIES)
def test_rankings_bitwise_equal_with_observability_on_and_off(family, packed):
    tables, queries = LAKE
    svc = SketchSearchService(m=M, seed=3, family=family, packed=packed,
                              keep_host_oracle=False, device="cpu")
    svc.ingest_many(tables)
    off = _serve(svc, queries)
    obs.enable()
    on = _serve(svc, queries)
    assert on == off and off[0] == off[1] and any(off[1])
    snap = obs.describe_metrics()["metrics"]
    launched = {s["labels"]["family"]
                for s in snap["ops.launches_total"]["series"]}
    assert launched == {family}
    assert obs.gauge("ops.interpret_mode").value == 1.0
    assert obs.counter("serve.queries_total").value == len(queries)
    assert obs.counter("serve.batch_queries_total").value == len(queries)
    assert {e["name"] for e in obs.events()} >= {"serve.search",
                                                 "serve.search_batch"}


def _requests(svc):
    """One service's requests: ingest (one table a tenant's), a sharded
    ingest, both endpoints and a tenant search."""
    tables, queries = LAKE
    svc.ingest_many(tables[:4])
    svc.ingest(*tables[4], tenant="acme")
    svc.ingest_many_sharded(tables[5:], shards=2)
    svc.search_batch(queries, top_k=4, min_join=MIN_JOIN, micro_batch=3)
    for k, v in queries[:2]:
        svc.search(k, v, top_k=4, min_join=MIN_JOIN)
    svc.search(*queries[0], top_k=4, min_join=MIN_JOIN, tenant="acme")


def _series(pkg):
    """Every live series as ``{(name, labels): value or count}``."""
    out = {}
    for name, entry in pkg.describe_metrics()["metrics"].items():
        for s in entry["series"]:
            key = (name, tuple(sorted(s["labels"].items())))
            out[key] = s["count"] if entry["type"] == "histogram" \
                else s["value"]
    return out


@pytest.mark.parametrize("family", FAMILIES)
def test_metric_series_equal_jax_after_the_same_requests(family):
    obs.enable()
    jax_obs.enable()
    _requests(SketchSearchService(m=M, seed=3, family=family,
                                  keep_host_oracle=False, device="cpu"))
    _requests(JaxService(m=M, seed=3, family=family, keep_host_oracle=False))
    got, want = _series(obs), _series(jax_obs)

    def layer(series, prefixes):
        return {k: v for k, v in series.items() if k[0].startswith(prefixes)}
    same = ("serve.", "store.", "merge.", "ops.launches_total")
    # estimate_partials_fields runs inside JAX's jitted icws_estimate_fields,
    # so JAX counts it only while tracing a new shape; the port has no jit
    # and counts it on every call, once a call of icws_estimate_fields
    inner = [k for k in layer(got, ("ops.launches_total",))
             if ("op", "estimate_partials_fields") in k[1]]
    for k in inner:
        outer = (k[0], tuple(("op", "icws_estimate_fields") if p[0] == "op"
                             else p for p in k[1]))
        assert got.pop(k) == got[outer] > 0
        want.pop(k, None)
    assert bool(inner) == (family in ("icws", "dmh"))
    assert layer(got, same) == layer(want, same)
    assert got[("merge.merges_total", (("family", family),))] == 1
    assert got[("serve.queries_total", ())] == 3


def test_store_series_equal_jax_through_growths():
    from repro.data.store import CorpusStore as JaxStore
    from repro_torch.data.store import CorpusStore
    rng = np.random.default_rng(5)
    obs.enable()
    jax_obs.enable()
    stores = (CorpusStore(m=8, fields=3, min_capacity=2, device="cpu"),
              JaxStore(m=8, fields=3, min_capacity=2))
    for b in (1, 3, 5):
        rows = (rng.integers(-1, 99, (3, b, 8)).astype(np.int32),
                rng.normal(size=(3, b, 8)).astype(np.float32),
                rng.random((3, b)).astype(np.float32),
                rng.integers(0, 99, (3, b, 8)).astype(np.int32))
        for store in stores:
            store.append(*rows, tenant="t" if b == 3 else None)
    got, want = _series(obs), _series(jax_obs)
    assert got == want
    assert got[("store.grows_total", (("family", "icws"),))] == 2
    assert got[("store.resident_bytes", (("family", "icws"),))] == \
        16 * 3 * (12 * 8 + 4)
    assert [e["name"] for e in obs.events()].count("store.grow") == 2


def _audit_service(pkg_service, **kw):
    tables, _ = LAKE
    svc = pkg_service(m=M, seed=3, **kw)
    svc.ingest_many(tables)
    return svc


def test_audit_samples_as_jax_and_its_rolling_ppm_agrees():
    """``audit_every=2`` over own sketches (the port's ICWS rows equal the
    JAX kernel's here, and the host oracles are bit for bit equal): the
    same samples, and a rolling ppm within 1 ppm of JAX's."""
    _, queries = LAKE
    obs.enable()
    jax_obs.enable()
    port = _audit_service(SketchSearchService, audit_every=2, device="cpu")
    ref = _audit_service(JaxService, audit_every=2)
    for _ in range(3):
        for k, v in queries:
            got = port.search(k, v, top_k=4, min_join=MIN_JOIN)
            want = ref.search(k, v, top_k=4, min_join=MIN_JOIN)
            assert [r.name for r in got] == [r.name for r in want]
    n = obs.counter("quality.samples_total", family="icws").value
    assert n == jax_obs.counter("quality.samples_total",
                                family="icws").value > 0
    assert abs(obs.rolling_ppm("icws") - jax_obs.rolling_ppm("icws")) <= 1.0
    assert obs.gauge("quality.ppm_error", family="icws").value == \
        obs.rolling_ppm("icws")


def test_audit_changes_no_result():
    _, queries = LAKE
    plain = _audit_service(SketchSearchService, device="cpu")
    audited = _audit_service(SketchSearchService, audit_every=1,
                             device="cpu")
    want = [plain.search(k, v, top_k=4, min_join=MIN_JOIN)
            for k, v in queries]
    assert [audited.search(k, v, top_k=4, min_join=MIN_JOIN)
            for k, v in queries] == want         # observability off
    obs.enable()
    assert [audited.search(k, v, top_k=4, min_join=MIN_JOIN)
            for k, v in queries] == want
    assert obs.counter("quality.samples_total", family="icws").value > 0
    assert audited.search_batch(queries, top_k=4, min_join=MIN_JOIN) == want


@pytest.mark.parametrize("kw, search_kw", [
    ({"family": "dmh"}, {}), ({"family": "cs"}, {}), ({"family": "ts"}, {}),
    ({"backend": "host"}, {}), ({}, {"backend": "host"}),
    ({"keep_host_oracle": False}, {}),
])
def test_audit_skips_where_jax_skips(kw, search_kw):
    """Other families, the host backend (the index's or the request's) and
    an index without its host oracle: neither package samples."""
    _, queries = LAKE
    obs.enable()
    jax_obs.enable()
    port = _audit_service(SketchSearchService, audit_every=1, device="cpu",
                          **kw)
    ref = _audit_service(JaxService, audit_every=1, **kw)
    for k, v in queries:
        got = port.search(k, v, top_k=4, min_join=MIN_JOIN, **search_kw)
        want = ref.search(k, v, top_k=4, min_join=MIN_JOIN, **search_kw)
        assert [r.name for r in got] == [r.name for r in want]
    for pkg in (obs, jax_obs):
        assert "quality.samples_total" not in pkg.describe_metrics()[
            "metrics"]
        assert pkg.rolling_ppm("icws") is None
