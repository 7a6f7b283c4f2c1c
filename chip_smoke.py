"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``, holds
each against its plain PyTorch version on the card at the serving path's
shapes, then drives the §1.3 dataset-search service
(``repro_torch.SketchSearchService``, ICWS, m = 512) over a synthetic lake of
16,384 tables and checks its answers.  Imports nothing of JAX and nothing of
the JAX package.  Exits non-zero on any failure, and at once when no card
is present.  The line before the last is a JSON object with each kernel's
launches on the serving run, its error against the plain version, its time,
the plain version's time and its bound; the last line is the run's device.
"""
from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

SRC = pathlib.Path(__file__).resolve().parent / "src"

# published peaks of one H100 SXM (the bound of a kernel is the larger of
# its bytes over the memory rate and its operations over the FP32 rate of
# the CUDA cores, which every 32-bit lane operation here is counted at)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# lane operations of one (row, t, non-zero) ICWS draw: ten murmur rounds
# (8 each), five salted hash prologues (5), five uniforms (4), and the
# r / c / beta / level / exp / divide chain (19, one per log, exp, divide)
ICWS_OPS_PER_DRAW = 10 * 8 + 5 * 5 + 5 * 4 + 19
# lane operations of one (g, q, p, t) collision test (compare, guard), and
# of one collision's weight (two squares, min, select, product, divide,
# two adds)
EST_OPS_PER_TEST = 2
EST_OPS_PER_HIT = 8

M = 512
LAKE_TABLES = 16_384
QUERIES = 64
MICRO_BATCH = 16
QUERY_ROWS = 2_000
KEY_DOMAIN = 1 << 20
EST_P = 131_072


def log(msg: str) -> None:
    print(msg, flush=True)


def card_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


# --------------------------------------------------------------------------
# synthetic lake: tables over a shared key domain with duplicate keys
# --------------------------------------------------------------------------
def make_lake(rng, n_tables: int, n_queries: int):
    """``n_tables`` tables, sizes log-uniform in [100, 10,000] rows, keys
    drawn with replacement from a 2^20 domain; queries of 2,000 rows, the
    first half each with a planted partner table that shares ~85% of its
    rows with values that follow the query's.  Returns (tables, queries,
    partner name per query or None)."""
    tables = []
    sizes = np.exp(rng.uniform(np.log(100), np.log(10_000), n_tables))
    for i, n in enumerate(sizes.astype(np.int64)):
        tables.append((f"t{i:05d}", rng.integers(0, KEY_DOMAIN, n),
                       rng.normal(100.0, 15.0, n)))
    queries, partners = [], []
    slots = rng.choice(n_tables, size=n_queries // 2, replace=False)
    for qi in range(n_queries):
        keys = rng.integers(0, KEY_DOMAIN, QUERY_ROWS)
        vals = rng.normal(0.0, 1.0, QUERY_ROWS)
        queries.append((keys, vals))
        if qi < n_queries // 2:
            keep = rng.random(QUERY_ROWS) < 0.85
            extra = int(rng.integers(100, 2_000))
            pk = np.concatenate([keys[keep], rng.integers(0, KEY_DOMAIN, extra)])
            pv = np.concatenate([3.0 * vals[keep] + 0.3 * rng.normal(size=keep.sum()),
                                 rng.normal(0.0, 3.0, extra)])
            name = f"partner{qi:02d}"
            tables[slots[qi]] = (name, pk, pv)
            partners.append(name)
        else:
            partners.append(None)
    return tables, queries, partners


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------
def build_phase():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.library()
    log(f"build: {build.library_path()} built or loaded in "
        f"{time.perf_counter() - t0:.1f} s")


def sketch_case(index, rng, B: int, nnz: int, dev):
    """One sketch launch at the path's shapes: B field rows (3 per table or
    query) of about ``nnz`` non-zeros each, N = nnz rounded to 256."""
    from repro_torch.data.ingest import pad_sparse_batch
    from repro_torch.kernels import icws_sketch as ks
    vecs = []
    while len(vecs) < B:
        keys = rng.integers(0, KEY_DOMAIN, nnz + nnz // 64)
        vecs.extend(index.vectorize(keys, rng.normal(0.0, 1.0, keys.size)))
    w, keys, vals, _ = pad_sparse_batch(vecs[:B])
    args = [torch.from_numpy(a).to(dev) for a in (w, keys, vals)]
    got = ks.icws_sketch_cuda(*args, m=M, seed=0)
    torch.cuda.synchronize()
    want = ks.icws_sketch_plain(*args, m=M, seed=0)
    agree = got[0] == want[0]
    share = agree.float().mean().item()
    err = float((got[1] - want[1])[agree].abs().max().item())
    if share < 0.99:
        raise AssertionError(f"sketch B={B}: fingerprints agree on {share:.4f} < 0.99")
    if err != 0.0 or not torch.equal(got[3][agree], want[3][agree]):
        raise AssertionError(f"sketch B={B}: values/argkeys differ where "
                             f"fingerprints agree (max |dval| {err})")
    live = int((args[0] > 0).sum().item())
    ops = ICWS_OPS_PER_DRAW * live * M
    bytes_moved = w.nbytes * 3 + B * M * 16
    bound = max(ops / FP32_OPS_PER_S, bytes_moved / HBM_BYTES_PER_S) * 1e3
    ms = time_ms(lambda: ks.icws_sketch_cuda(*args, m=M, seed=0), reps=20)
    plain = time_ms(lambda: ks.icws_sketch_plain(*args, m=M, seed=0), reps=3,
                    warmup=1)
    shape = f"B={B} N={w.shape[1]} m={M}"
    log(f"sketch {shape}: fp agree {share:.6f}, max |dval| {err}, "
        f"kernel {ms:.4f} ms, plain {plain:.3f} ms, bound {bound:.4f} ms "
        f"(operations, {live} live non-zeros)")
    return {"shape": shape, "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "fp_agree": share}


def estimate_case(fq, vq, fc, vc):
    """One estimate launch against its plain version: ``cnt`` equal
    exactly, ``sw`` within rtol 1e-5 (atol 1e-6) on every (g, q, p)."""
    from repro_torch.data.dataset_search import CFIELD, QFIELD
    from repro_torch.kernels import estimate as ke
    cnt, sw = ke.estimate_fields_cuda(fq, vq, fc, vc, qmap=QFIELD, cmap=CFIELD)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cnt_p, sw_p = ke.estimate_fields_plain(fq, vq, fc, vc, qmap=QFIELD,
                                           cmap=CFIELD)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3
    G, Q, P = len(QFIELD), fq.shape[1], fc.shape[1]
    shape = f"G={G} Q={Q} P={P} m={M}"
    if not torch.equal(cnt, cnt_p):
        raise AssertionError(f"estimate {shape}: collision counts differ from plain")
    err = float((sw - sw_p).abs().max().item())
    tol = 1e-5 * sw_p.abs() + 1e-6
    if not bool(((sw - sw_p).abs() <= tol).all()):
        raise AssertionError(f"estimate {shape}: sw outside rtol 1e-5 (max |d| {err})")
    hits = float(cnt.double().sum().item())
    tests = G * Q * P * M
    ops = EST_OPS_PER_TEST * tests + EST_OPS_PER_HIT * hits
    bytes_moved = (fq.numel() + vq.numel() + fc.numel() + vc.numel()) * 4 \
        + 2 * G * Q * P * 4
    bound_bytes, bound_ops = bytes_moved / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    bound = max(bound_bytes, bound_ops) * 1e3
    bound_by = "bytes" if bound_bytes >= bound_ops else "operations"
    ms = time_ms(lambda: ke.estimate_fields_cuda(fq, vq, fc, vc, qmap=QFIELD,
                                                 cmap=CFIELD), reps=10)
    log(f"estimate {shape}: {hits:.0f} collisions of {tests} tests, cnt "
        f"equal, max |dsw| {err}, kernel {ms:.4f} ms, plain {plain:.1f} ms "
        f"(one run), bound {bound:.4f} ms ({bound_by}: "
        f"{bytes_moved / 1e9:.3f} GB, {ops:.3e} ops)")
    return {"shape": shape, "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": bound_by}


def kernel_phase(dev):
    from repro_torch.data.dataset_search import DatasetSearchIndex
    from repro_torch.data.ingest import pad_sparse_batch
    from repro_torch.kernels import icws_sketch as ks
    rng = np.random.default_rng(1)
    index = DatasetSearchIndex(m=M, seed=0, device=dev)
    sketch = [sketch_case(index, rng, B, nnz, dev)
              for B in (3, 48) for nnz in (1000, 4000)]

    # estimate: 16 queries' real sketch rows against P = 131,072 corpus rows
    # per field that copy a random query's samples with a per-row share and
    # draw the rest at random; the last 1,024 rows are spare (pad -2)
    keys_q = [rng.integers(0, KEY_DOMAIN, QUERY_ROWS) for _ in range(16)]
    vecs = [v for k in keys_q for v in index.vectorize(
        k, rng.normal(0.0, 1.0, k.size))]
    fp, val, _, _ = ks.icws_sketch_cuda(
        *[torch.from_numpy(a).to(dev) for a in pad_sparse_batch(vecs)[:3]],
        m=M, seed=0)
    fq = fp.reshape(16, 3, M).transpose(0, 1).contiguous()
    vq = val.reshape(16, 3, M).transpose(0, 1).contiguous()
    g = torch.Generator(device=dev).manual_seed(2)
    src = torch.randint(0, 16, (EST_P,), device=dev, generator=g)
    share = torch.rand((EST_P, 1), device=dev, generator=g) ** 3
    copy = torch.rand((3, EST_P, M), device=dev, generator=g) < share
    fc = torch.where(copy, fq[:, src], torch.randint(
        0, 2 ** 31 - 1, (3, EST_P, M), device=dev, generator=g,
        dtype=torch.int32))
    vc = torch.where(copy, vq[:, src] * 1.5,
                     torch.randn((3, EST_P, M), device=dev, generator=g) * 0.05)
    del copy
    fc[:, -1024:] = -2
    vc[:, -1024:] = 0.0
    # the batched launch at P = 131,072, then the shapes the service gives
    # the kernel: Q = 1 (`search`) and P = 16,384 (the lake's store
    # capacity), the latter over the last rows so that spare rows are in it
    estimate = [estimate_case(fq[:, :q], vq[:, :q], fc[:, -p:], vc[:, -p:])
                for q, p in ((16, EST_P), (1, EST_P), (16, LAKE_TABLES),
                             (1, LAKE_TABLES))]
    del fc, vc
    torch.cuda.empty_cache()
    return sketch, estimate


def small_reference_phase(dev):
    """The service on the card against the same service on the CPU (plain
    kernels) on a small lake: same rankings, estimates within f32 tolerance."""
    from repro_torch import SketchSearchService
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 5_000, 800)
    signal = rng.normal(size=800)
    tables = [("corr", keys, 2 * signal + 0.1 * rng.normal(size=800)),
              ("noise", keys, rng.normal(size=800)),
              ("half", np.concatenate([keys[:400], rng.integers(0, 5_000, 400)]),
               rng.normal(size=800))]
    tables += [(f"r{i}", rng.integers(0, 5_000, 300), rng.normal(size=300))
               for i in range(9)]
    queries = [(keys, signal), (keys[:500], rng.normal(size=500))]
    out = []
    for device in ("cpu", dev):
        svc = SketchSearchService(m=M, seed=0, device=device)
        svc.ingest_many(tables)
        out.append(svc.search_batch(queries, top_k=5, min_join=20,
                                    micro_batch=2))
    for a, b in zip(*out):
        if [r.name for r in a] != [r.name for r in b]:
            raise AssertionError(f"card ranking {[r.name for r in b]} != "
                                 f"cpu ranking {[r.name for r in a]}")
        for x, y in zip(a, b):
            if not (math.isfinite(y.join_size) and math.isfinite(y.sum_b)):
                raise AssertionError("non-finite estimate on the card")
            if abs(x.join_size - y.join_size) > 1e-4 * max(1.0, abs(x.join_size)):
                raise AssertionError(f"join size {y.join_size} != {x.join_size}")
    if out[1][0][0].name != "corr":
        raise AssertionError(f"small lake: top hit {out[1][0][0].name}")
    log(f"small lake: card ranking equals the cpu ranking {[r.name for r in out[1][0]]}")


def service_phase(dev):
    from repro_torch import SketchSearchService
    from repro_torch.kernels import estimate as ke
    from repro_torch.kernels import icws_sketch as ks
    rng = np.random.default_rng(4)
    t0 = time.perf_counter()
    tables, queries, partners = make_lake(rng, LAKE_TABLES, QUERIES)
    rows = sum(len(k) for _, k, _ in tables)
    log(f"lake: {len(tables)} tables, {rows} rows, made in "
        f"{time.perf_counter() - t0:.1f} s")
    svc = SketchSearchService(m=M, seed=0)

    ks.icws_sketch_cuda.launches = 0
    ke.estimate_fields_cuda.launches = 0
    t0 = time.perf_counter()
    svc.ingest_many(tables)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    min_join = QUERY_ROWS / 4
    batched = svc.search_batch(queries, top_k=10, min_join=min_join,
                               micro_batch=MICRO_BATCH)
    sequential = [svc.search(k, v, top_k=10, min_join=min_join)
                  for k, v in queries]
    torch.cuda.synchronize()
    launches = {"icws_sketch": ks.icws_sketch_cuda.launches,
                "estimate_fields": ke.estimate_fields_cuda.launches}

    d = svc.describe()
    log(f"ingest: {LAKE_TABLES / ingest_s:.1f} tables/s ({ingest_s:.1f} s); "
        f"store {d['corpus_rows']} rows x 3 fields, capacity "
        f"{d['corpus_capacity']}, {3 * d['corpus_capacity'] * d['bytes_per_row'] / 1e6:.1f} MB")
    log(f"query p50 {d['query_ms_p50']:.2f} ms (search, {d['queries_served']} "
        f"queries); batch p50 {d['batch_ms_p50']:.2f} ms (micro-batch of "
        f"{MICRO_BATCH}, {d['batches_served']} batches; "
        f"{d['batched_query_ms_p50']:.2f} ms per query)")
    if sequential != batched:
        raise AssertionError("batched results differ from sequential search")
    found = 0
    for res, partner in zip(batched, partners):
        for r in res:
            if not (math.isfinite(r.join_size) and math.isfinite(r.corr)):
                raise AssertionError(f"non-finite result {r}")
        if partner is not None:
            names = [r.name for r in res]
            if partner not in names:
                raise AssertionError(f"planted {partner} not in top 10: {names}")
            found += names.index(partner) == 0
    log(f"planted partners: {QUERIES // 2} of {QUERIES // 2} in the top 10, "
        f"{found} ranked first; batched == sequential on {QUERIES} queries")
    n_batches = math.ceil(QUERIES / MICRO_BATCH)
    need_sketch = LAKE_TABLES + n_batches + QUERIES
    need_est = n_batches + QUERIES
    log(f"launches on the serving run: {launches}")
    if launches["icws_sketch"] < need_sketch or launches["estimate_fields"] < need_est:
        raise AssertionError(f"launch counters {launches} below "
                             f"{need_sketch} sketch / {need_est} estimate")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()
    identity = card_identity()
    log(identity)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda")
    build_phase()
    sketch, estimate = kernel_phase(dev)
    small_reference_phase(dev)
    launches = service_phase(dev)

    rep = sketch[3]   # the query micro-batch launch: B = 48, N = 4096
    kernels = [
        {"name": "icws_sketch", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/icws_sketch.cu",
         "replaces": "src/repro/kernels/icws_sketch.py:40",
         "launches": launches["icws_sketch"], "max_abs_err": rep["max_abs_err"],
         "ms": rep["ms"], "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
         "bound_by": "operations", "library_ms": None, "shape": rep["shape"],
         "all_shapes": sketch},
        {"name": "estimate_fields", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/estimate_fields.cu",
         "replaces": "src/repro/kernels/estimate.py:215",
         "launches": launches["estimate_fields"],
         "max_abs_err": estimate[0]["max_abs_err"], "ms": estimate[0]["ms"],
         "plain_ms": estimate[0]["plain_ms"],
         "bound_ms": estimate[0]["bound_ms"],
         "bound_by": estimate[0]["bound_by"], "library_ms": None,
         "shape": estimate[0]["shape"], "all_shapes": estimate},
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s on {identity}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
