"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``, holds
each against its plain PyTorch version on the card at the serving path's
shapes, then drives the §1.3 dataset-search service
(``repro_torch.SketchSearchService``, m = 512) with each of the six
families -- ICWS, CountSketch, JL, DMH, threshold and priority sampling,
storage-matched -- over one synthetic lake of 16,384 tables and checks its
answers; it prints each family's planted-partner recall side by side (the
paper's head-to-head).  Imports nothing of JAX and nothing of the JAX
package.  Exits non-zero on any failure, and at once when no card is
present.  Each phase prints its wall time.  The line before the last is a
JSON object with each kernel's launches on the serving runs, its error
against the plain version, its time, the plain version's time, its bound
and the time of one PyTorch call that computes the same function (where
there is one); the last line is the run's device.
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
# lane operations of one keyed hash (two murmur rounds and the prologue);
# one CountSketch term per (row, rep, live non-zero) takes two hashes, the
# bucket's modulo, the sign's select, its product and the add; one JL term
# per (row, t, live non-zero) one hash, select, product and add
HASH_OPS = 2 * 8 + 5
CS_OPS_PER_TERM = 2 * HASH_OPS + 4
JL_OPS_PER_TERM = HASH_OPS + 3
# DMH: per lane one bin hash and its modulo, the five salted ICWS variates
# and the level chain, and the atomicMin; per occupied bin the winner's
# level again and its fingerprint hash; per densify probe a hash, the
# modulo and the occupancy test
DMH_OPS_PER_LANE = HASH_OPS + 1 + ICWS_OPS_PER_DRAW + 1
DMH_OPS_PER_BIN = ICWS_OPS_PER_DRAW + HASH_OPS
DMH_OPS_PER_PROBE = HASH_OPS + 2
# key-match merge: per step (one query slot or one corpus slot passed) a
# compare and an advance; per match the min, the guard, the product, the
# divide and the add
SAMPLE_OPS_PER_STEP = 2
SAMPLE_OPS_PER_MATCH = 5

M = 512
LAKE_TABLES = 16_384
QUERIES = 64
MICRO_BATCH = 16
QUERY_ROWS = 2_000
KEY_DOMAIN = 1 << 20
EST_P = 131_072
FAMILIES = ("icws", "cs", "jl", "dmh", "ts", "ps")
# the kernels each family's serving path launches: its sketch kernel (none
# for TS/PS, whose rows are built on the host) and its estimate kernel
PATH_KERNELS = {"icws": ("icws_sketch", "estimate_fields"),
                "cs": ("countsketch_sparse", "linear_estimate_fields"),
                "jl": ("jl_sketch", "linear_estimate_fields"),
                "dmh": ("dmh_sketch", "estimate_fields"),
                "ts": ("sample_estimate_fields",),
                "ps": ("sample_estimate_fields",)}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def phase(name: str, fn, *args):
    """Run one phase and print its wall time on a line of its own."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    return out


def launch_counters():
    """Each kernel wrapper's launch counter, by kernel name."""
    from repro_torch.kernels import (countsketch, dmh_sketch, estimate,
                                     icws_sketch, jl_sketch, sample_estimate)
    return {"icws_sketch": icws_sketch.icws_sketch_cuda,
            "estimate_fields": estimate.estimate_fields_cuda,
            "countsketch_sparse": countsketch.countsketch_sparse_cuda,
            "jl_sketch": jl_sketch.jl_sketch_cuda,
            "linear_estimate_fields": estimate.linear_estimate_fields_cuda,
            "dmh_sketch": dmh_sketch.dmh_sketch_cuda,
            "sample_estimate_fields":
                sample_estimate.sample_estimate_fields_cuda}


def family_for(name: str):
    from repro_torch.data.families import make_family, wmh_storage
    return make_family(name, storage=wmh_storage(M), seed=0)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Milliseconds per call of ``fn``: CUDA events around a run of ``reps``
    calls, over the count.  A call that is shorter on the device than on
    the host (the wrapper's Python) reads as the host's time per call."""
    for _ in range(warmup):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, symbol: str, reps: int = 10) -> float:
    """Device milliseconds per launch of the kernel whose name contains
    ``symbol``, from a ``torch.profiler`` trace of ``reps`` calls: the
    kernel alone, without the host's launch cost (the mean over the
    launches the trace recorded)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and symbol in e.name]
    if not spans:
        raise AssertionError(f"the profiler recorded no launch of {symbol}")
    return sum(spans) / len(spans) / 1e3


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


def field_vectors(index, rng, B: int, nnz: int):
    """B field vectors (3 per table) of about ``nnz`` non-zeros each."""
    vecs = []
    while len(vecs) < B:
        keys = rng.integers(0, KEY_DOMAIN, nnz + nnz // 64)
        vecs.extend(index.vectorize(keys, rng.normal(0.0, 1.0, keys.size)))
    return vecs[:B]


def sketch_case(index, rng, B: int, nnz: int, dev):
    """One sketch launch at the path's shapes: B field rows (3 per table or
    query) of about ``nnz`` non-zeros each, N = nnz rounded to 256."""
    from repro_torch.data.ingest import pad_sparse_batch
    from repro_torch.kernels import icws_sketch as ks
    w, keys, vals, _ = pad_sparse_batch(field_vectors(index, rng, B, nnz))
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
    dev_ms = device_ms(lambda: ks.icws_sketch_cuda(*args, m=M, seed=0),
                       "icws_sketch_kernel")
    plain = time_ms(lambda: ks.icws_sketch_plain(*args, m=M, seed=0), reps=3,
                    warmup=1)
    shape = f"B={B} N={w.shape[1]} m={M}"
    log(f"sketch {shape}: fp agree {share:.6f}, max |dval| {err}, "
        f"kernel {ms:.4f} ms per call ({dev_ms:.4f} ms on the device), plain "
        f"{plain:.3f} ms, bound {bound:.4f} ms (operations, {live} live "
        f"non-zeros)")
    return {"shape": shape, "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain, "bound_ms": bound, "fp_agree": share}


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
    dev_ms = device_ms(lambda: ke.estimate_fields_cuda(
        fq, vq, fc, vc, qmap=QFIELD, cmap=CFIELD), "estimate_fields_kernel")
    log(f"estimate {shape}: {hits:.0f} collisions of {tests} tests, cnt "
        f"equal, max |dsw| {err}, kernel {ms:.4f} ms per call ({dev_ms:.4f} "
        f"ms on the device), plain {plain:.1f} ms (one run), bound "
        f"{bound:.4f} ms ({bound_by}: {bytes_moved / 1e9:.3f} GB, "
        f"{ops:.3e} ops)")
    return {"shape": shape, "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain, "bound_ms": bound, "bound_by": bound_by}


def linear_sketch_case(index, rng, name: str, B: int, nnz: int, dev):
    """One CountSketch or JL launch at the path's shapes against its plain
    version: equal bit for bit (both sum over ascending n)."""
    from repro_torch.data.ingest import pad_linear_batch
    from repro_torch.kernels import countsketch as kc
    from repro_torch.kernels import jl_sketch as kj
    fam = family_for(name)
    keys, vals = (torch.from_numpy(a).to(dev) for a in pad_linear_batch(
        field_vectors(index, rng, B, nnz)))
    if name == "cs":
        kw = dict(width=fam.width, reps=fam.reps, seed=0)
        kernel, plain = kc.countsketch_sparse_cuda, kc.countsketch_sparse_plain
        ops_per_term, terms_per_nz = CS_OPS_PER_TERM, fam.reps
        symbol = "countsketch_sparse_kernel"
    else:
        kw = dict(m=fam.m, seed=0)
        kernel, plain = kj.jl_sketch_cuda, kj.jl_sketch_plain
        ops_per_term, terms_per_nz = JL_OPS_PER_TERM, fam.m
        symbol = "jl_sketch_kernel"
    got = kernel(keys, vals, **kw)
    torch.cuda.synchronize()
    want = plain(keys, vals, **kw)
    err = float((got - want).abs().max().item())
    shape = f"B={B} N={keys.shape[1]} R={fam.reps} W={fam.width}"
    if not torch.equal(got, want):
        raise AssertionError(f"{name} sketch {shape}: kernel differs from "
                             f"plain (max |d| {err})")
    live = int((vals != 0).sum().item())
    ops = ops_per_term * live * terms_per_nz
    bytes_moved = (keys.numel() + vals.numel()) * 4 + got.numel() * 4
    bound_b, bound_o = bytes_moved / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    bound = max(bound_b, bound_o) * 1e3
    bound_by = "bytes" if bound_b >= bound_o else "operations"
    ms = time_ms(lambda: kernel(keys, vals, **kw), reps=20)
    dev_ms = device_ms(lambda: kernel(keys, vals, **kw), symbol)
    plain_ms = time_ms(lambda: plain(keys, vals, **kw), reps=3, warmup=1)
    log(f"{name} sketch {shape}: equal to plain, kernel {ms:.4f} ms per call "
        f"({dev_ms:.4f} ms on the device), plain {plain_ms:.3f} ms, bound "
        f"{bound:.5f} ms ({bound_by}, {live} live non-zeros)")
    return {"shape": shape, "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by}


def linear_estimate_case(name: str, tq, tc):
    """One linear-fields launch against its plain version (equal bit for
    bit: an f32 product then an f32 add per w, in order, in both) and
    against ``torch.bmm`` in f32 with TF32 off over the (pair, rep)-gathered
    tables (the gather is outside the timing; the port never calls it)."""
    from repro_torch.data.dataset_search import CFIELD, QFIELD
    from repro_torch.kernels import estimate as ke
    G, (Q, R, W), P = len(QFIELD), tq.shape[1:], tc.shape[1]
    shape = f"{name} G={G} R={R} Q={Q} P={P} W={W}"
    got = ke.linear_estimate_fields_cuda(tq, tc, qmap=QFIELD, cmap=CFIELD)
    torch.cuda.synchronize()
    plain_ms = time_ms(lambda: ke.linear_estimate_fields_plain(
        tq, tc, qmap=QFIELD, cmap=CFIELD), reps=1, warmup=0)
    want = ke.linear_estimate_fields_plain(tq, tc, qmap=QFIELD, cmap=CFIELD)
    err = float((got - want).abs().max().item())
    if not torch.equal(got, want):
        raise AssertionError(f"linear estimate {shape}: kernel differs from "
                             f"plain (max |d| {err})")
    del want
    ms = time_ms(lambda: ke.linear_estimate_fields_cuda(
        tq, tc, qmap=QFIELD, cmap=CFIELD), reps=10)
    dev_ms = device_ms(lambda: ke.linear_estimate_fields_cuda(
        tq, tc, qmap=QFIELD, cmap=CFIELD), "linear_estimate_fields_kernel")
    torch.backends.cuda.matmul.allow_tf32 = False
    a = torch.stack([tq[qf] for qf in QFIELD]).permute(0, 2, 1, 3).reshape(
        G * R, Q, W).contiguous()
    b = torch.stack([tc[cf] for cf in CFIELD]).permute(0, 2, 1, 3).reshape(
        G * R, P, W).contiguous()
    lib = torch.bmm(a, b.transpose(1, 2))
    lib_err = float((lib.reshape(G, R, Q, P) - got).abs().max().item())
    lib_ms = time_ms(lambda: torch.bmm(a, b.transpose(1, 2)), reps=10)
    del a, b, lib
    bytes_moved = (tq.numel() + tc.numel() + got.numel()) * 4
    ops = 2 * G * R * Q * P * W
    bound_b, bound_o = bytes_moved / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    bound = max(bound_b, bound_o) * 1e3
    bound_by = "bytes" if bound_b >= bound_o else "operations"
    log(f"linear estimate {shape}: equal to plain, kernel {ms:.4f} ms per "
        f"call ({dev_ms:.4f} ms on the device), plain {plain_ms:.1f} ms (one "
        f"run), torch.bmm {lib_ms:.4f} ms (max |d| "
        f"{lib_err:.3g} against the kernel), bound {bound:.4f} ms "
        f"({bound_by}: {bytes_moved / 1e9:.3f} GB, {ops:.3e} ops)")
    return {"shape": shape, "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": lib_ms}


def linear_kernel_phase(dev):
    """B6 and B7 at the ingest (B = 3) and query-batch (B = 48) shapes, each
    at N = 1024 and 4096; B8 at G = 6, Q in {16, 1}, P in {131,072, 16,384}
    for CS (R = 5, W = 153) and JL (R = 1, W = 769), over real query
    tables and random corpus tables whose last 1,024 rows are spare."""
    from repro_torch.data.dataset_search import DatasetSearchIndex
    rng = np.random.default_rng(5)
    index = DatasetSearchIndex(m=M, seed=0, device=dev)
    sketch = {name: [linear_sketch_case(index, rng, name, B, nnz, dev)
                     for B in (3, 48) for nnz in (1000, 4000)]
              for name in ("cs", "jl")}
    estimate = []
    g = torch.Generator(device=dev).manual_seed(6)
    for name in ("cs", "jl"):
        fam = family_for(name)
        (tables,) = fam.sketch_rows(field_vectors(index, rng, 48, QUERY_ROWS),
                                    device=dev)
        tq = tables.reshape(16, 3, fam.reps, fam.width).transpose(0, 1)
        tc = torch.randn((3, EST_P, fam.reps, fam.width), device=dev,
                         generator=g)
        tc[:, -1024:] = 0.0
        estimate += [linear_estimate_case(name, tq[:, :q], tc[:, -p:])
                     for q, p in ((16, EST_P), (1, EST_P), (16, LAKE_TABLES),
                                  (1, LAKE_TABLES))]
        del tc
        torch.cuda.empty_cache()
    return sketch, estimate


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


def dmh_sketch_case(index, rng, B: int, nnz: int, dev, b1):
    """One DMH launch at the path's shapes (B field rows of about ``nnz``
    non-zeros, each key replicated c = 4 times at m = 512) against its
    plain version: fingerprints, argkeys and values equal on every slot,
    ``amin`` bitwise or its largest difference printed.  ``b1`` is the ICWS
    sketch case at the same (B, nnz), printed beside."""
    from repro_torch.core.dmh import dmh_replication, replicate_keys
    from repro_torch.data.ingest import pad_sparse_batch
    from repro_torch.kernels import dmh_sketch as kd
    from repro_torch.kernels.common import (BIG, DMH_STREAM_BIN,
                                            DMH_STREAM_DENSIFY, as_u32,
                                            densify_probes, hash_u32,
                                            salt_for)
    w, keys, vals, _ = pad_sparse_batch(field_vectors(index, rng, B, nnz))
    n_pre = w.shape[1]
    c = dmh_replication(M)
    keys = replicate_keys(keys.view(np.uint32), c).view(np.int32)
    args = [torch.from_numpy(a).to(dev) for a in (
        np.tile(w, (1, c)), keys, np.tile(vals, (1, c)))]
    got = kd.dmh_sketch_cuda(*args, m=M, seed=0)
    torch.cuda.synchronize()
    want = kd.dmh_sketch_plain(*args, m=M, seed=0)
    shape = f"B={B} N={n_pre}x{c} m={M}"
    for name, i in (("fingerprints", 0), ("values", 1), ("argkeys", 3)):
        if not torch.equal(got[i], want[i]):
            bad = int((got[i] != want[i]).sum().item())
            raise AssertionError(f"dmh sketch {shape}: {name} differ from "
                                 f"plain on {bad} slots")
    err = float((got[2] - want[2]).abs().max().item())
    amin_equal = torch.equal(got[2], want[2])
    # the work this run's data needs: live lanes, occupied bins and the
    # densify probes each empty bin of a live row takes
    live = int((args[0] > 0).sum().item())
    t = torch.arange(M, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    occ = (hash_u32(as_u32(got[3]), salt_for(0, DMH_STREAM_BIN, zero)) % M
           == t) & (got[0] >= 0)
    J = densify_probes(M)
    j = torch.arange(J, device=dev)
    probe = hash_u32(t[:, None], salt_for(0, DMH_STREAM_DENSIFY, j)[None]) % M
    firstj = torch.where(occ[:, probe], j, J - 1).amin(2)
    need = ~occ & occ.any(1, keepdim=True)
    probes = int((firstj + 1)[need].sum().item())
    ops = (DMH_OPS_PER_LANE * live + DMH_OPS_PER_BIN * int(occ.sum().item())
           + DMH_OPS_PER_PROBE * probes)
    # every lane's weight, the keys of live lanes, the winners' values, the
    # four output planes
    bytes_moved = 4 * (args[0].numel() + live + int(occ.sum().item())) \
        + B * M * 16
    bound_b, bound_o = bytes_moved / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    bound = max(bound_b, bound_o) * 1e3
    bound_by = "bytes" if bound_b >= bound_o else "operations"
    ms = time_ms(lambda: kd.dmh_sketch_cuda(*args, m=M, seed=0), reps=20)
    dev_ms = device_ms(lambda: kd.dmh_sketch_cuda(*args, m=M, seed=0),
                       "dmh_sketch_kernel")
    plain = time_ms(lambda: kd.dmh_sketch_plain(*args, m=M, seed=0), reps=3,
                    warmup=1)
    log(f"dmh sketch {shape}: fingerprints, values and argkeys equal to "
        f"plain, amin {'equal' if amin_equal else f'max |d| {err}'}; kernel "
        f"{ms:.4f} ms per call ({dev_ms:.4f} ms on the device), plain "
        f"{plain:.3f} ms, bound {bound:.5f} ms ({bound_by}: {live} live "
        f"lanes, {int(occ.sum().item())} occupied bins, {probes} densify "
        f"probes); ICWS B1 at B={B} N={n_pre}: {b1['device_ms']:.4f} ms on "
        f"the device, {b1['device_ms'] / dev_ms:.1f}x B5")
    return {"shape": shape, "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain, "bound_ms": bound, "bound_by": bound_by,
            "amin_equal": amin_equal, "b1_device_ms": b1["device_ms"]}


def dmh_kernel_phase(dev, b1_cases):
    """B5 at the ingest (B = 3) and query-batch (B = 48) shapes, each at
    N = 1024 and 4096 before replication: the shapes of the B1 cases."""
    from repro_torch.data.dataset_search import DatasetSearchIndex
    rng = np.random.default_rng(1)
    index = DatasetSearchIndex(m=M, seed=0, device=dev)
    return [dmh_sketch_case(index, rng, B, nnz, dev, b1)
            for (B, nnz), b1 in zip(((3, 1000), (3, 4000), (48, 1000),
                                     (48, 4000)), b1_cases)]


def sample_estimate_case(q, c, hits, *, check: bool):
    """One key-match launch: timed against its bound; with ``check`` also
    held bit for bit against its plain version.  ``hits [6, Q, P]`` counts
    the key matches of each (pair, query, row)."""
    from repro_torch.data.dataset_search import CFIELD, QFIELD
    from repro_torch.kernels import sample_estimate as ks
    kq, vq, aq = q
    kc, vc, ac = c
    G, Q, P, S = len(QFIELD), kq.shape[1], kc.shape[1], kq.shape[2]
    shape = f"G={G} Q={Q} P={P} S={S}"

    def kernel():
        return ks.sample_estimate_fields_cuda(kq, vq, aq, kc, vc, ac,
                                              qmap=QFIELD, cmap=CFIELD)
    got = kernel()
    torch.cuda.synchronize()
    err, plain_ms = None, None
    if check:
        t0 = time.perf_counter()
        want = ks.sample_estimate_fields_plain(kq, vq, aq, kc, vc, ac,
                                               qmap=QFIELD, cmap=CFIELD)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = float((got - want).abs().max().item())
        if not torch.equal(got, want):
            raise AssertionError(f"sample estimate {shape}: kernel differs "
                                 f"from plain (max |d| {err})")
        if not bool(torch.isfinite(got).all()) or \
                int(torch.count_nonzero(got).item()) == 0:
            raise AssertionError(f"sample estimate {shape}: no finite "
                                 "non-zero estimate")
    live_q = (kq >= 0).sum(2).double()                 # [F, Q]
    live_c = (kc >= 0).sum(2).double()                 # [C, P]
    steps = sum(float(live_q[qf].sum()) * P + float(live_c[cf].sum()) * Q
                for qf, cf in zip(QFIELD, CFIELD))
    matches = float(hits.double().sum().item())
    ops = SAMPLE_OPS_PER_STEP * steps + SAMPLE_OPS_PER_MATCH * matches
    # what the join needs: each used field's live corpus keys (and the key
    # that ends a row's prefix) read once, value and probability of each
    # corpus slot some query matches, the queries' live slots, the output
    corpus_bytes = 0.0
    for cf in sorted(set(CFIELD)):
        qkeys = torch.cat([kq[qf][kq[qf] >= 0] for qf in
                           {qf for qf, c in zip(QFIELD, CFIELD) if c == cf}])
        matched = int(torch.isin(kc[cf], qkeys.unique()).sum().item())
        corpus_bytes += 4 * (float(live_c[cf].sum())
                             + int((live_c[cf] < S).sum().item())) \
            + 8 * matched
    bytes_moved = corpus_bytes + 12 * sum(
        float(live_q[qf].sum()) for qf in set(QFIELD)) + 4 * G * Q * P
    bound_b, bound_o = bytes_moved / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    bound = max(bound_b, bound_o) * 1e3
    bound_by = "bytes" if bound_b >= bound_o else "operations"
    ms = time_ms(kernel, reps=10)
    dev_ms = device_ms(kernel, "sample_estimate_fields_kernel")
    log(f"sample estimate {shape}: "
        + (f"equal to plain (plain {plain_ms:.1f} ms, one run), " if check
           else "")
        + f"kernel {ms:.4f} ms per call ({dev_ms:.4f} ms on the device), "
        f"bound {bound:.4f} ms ({bound_by}: {bytes_moved / 1e9:.3f} GB, "
        f"{ops:.3e} ops, {matches:.0f} matches)")
    return {"shape": shape, "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by}


def sample_kernel_phase(dev):
    """B9 over 16 queries' real TS rows (S = 768) against P = 131,072
    synthetic corpus rows per field that copy a random query's live keys
    with a per-row share and fill the rest with fresh keys, sorted, cut to
    a random live length; the last 1,024 rows are spare.  At the service's
    shape, Q in {16, 1} against the last 16,384 rows (the store's capacity
    on the lake, spare rows included), checked bit for bit against the
    plain version and timed; timed also at P = 131,072."""
    from repro_torch.data.dataset_search import (CFIELD, QFIELD,
                                                 DatasetSearchIndex)
    from repro_torch.kernels.sample_estimate import (sample_inclusion_probs,
                                                     sorted_prefix_ok)
    rng = np.random.default_rng(7)
    index = DatasetSearchIndex(m=M, seed=0, device=dev, family="ts")
    kq, vq, tq = index.family.sketch_rows(
        field_vectors(index, rng, 48, QUERY_ROWS), device=dev)
    S = kq.shape[1]
    kq, vq = (x.reshape(16, 3, S).transpose(0, 1).contiguous()
              for x in (kq, vq))
    tq = tq.reshape(16, 3).t().contiguous()
    aq = sample_inclusion_probs(vq, tq)

    g = torch.Generator(device=dev).manual_seed(8)
    P = EST_P
    src = torch.randint(0, 16, (P,), device=dev, generator=g)
    share = torch.rand((1, P, 1), device=dev, generator=g) ** 3
    copy = (torch.rand((3, P, S), device=dev, generator=g) < share) \
        & (kq[:, src] >= 0)
    fresh = KEY_DOMAIN + torch.arange(P, device=dev)[:, None] * S \
        + torch.arange(S, device=dev)
    kc = torch.where(copy, kq[:, src].long(), fresh)
    vc = torch.where(copy, vq[:, src] * 1.5, 0.05 + torch.rand(
        (3, P, S), device=dev, generator=g))
    del copy, fresh
    kc, order = torch.sort(kc, dim=2)
    vc = torch.gather(vc, 2, order)
    del order
    cut = torch.arange(S, device=dev) >= torch.randint(
        S // 8, S + 1, (3, P, 1), device=dev, generator=g)
    kc = torch.where(cut, -2, kc).int()
    vc = torch.where(cut, 0.0, vc)
    tc = torch.where(torch.rand((3, P), device=dev, generator=g) < 0.2, 0.0,
                     S * torch.rand((3, P), device=dev, generator=g))
    kc[:, -1024:], vc[:, -1024:], tc[:, -1024:] = -2, 0.0, 0.0
    del cut
    if not sorted_prefix_ok(kc):
        raise AssertionError("synthetic corpus rows break the sorted-prefix "
                             "contract")
    ac = sample_inclusion_probs(vc, tc)
    # key matches per (pair, query, corpus row), for the bound
    hits = torch.zeros((len(QFIELD), 16, P), dtype=torch.int32, device=dev)
    for gi, (qf, cf) in enumerate(zip(QFIELD, CFIELD)):
        for qi in range(16):
            live = kq[qf, qi][kq[qf, qi] >= 0]
            hits[gi, qi] = torch.isin(kc[cf], live).sum(1)
    torch.cuda.empty_cache()
    q = (kq, vq, aq)
    checked = [sample_estimate_case(tuple(x[:, :qn] for x in q),
                                    tuple(x[:, -p:] for x in (kc, vc, ac)),
                                    hits[:, :qn, -p:], check=p < EST_P)
               for qn, p in ((16, LAKE_TABLES), (1, LAKE_TABLES),
                             (16, EST_P), (1, EST_P))]
    del kc, vc, ac, tc, hits
    torch.cuda.empty_cache()
    return checked


def small_reference_phase(dev, family: str):
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
        svc = SketchSearchService(m=M, seed=0, family=family, device=device)
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
        raise AssertionError(f"small lake ({family}): top hit "
                             f"{out[1][0][0].name}")
    log(f"small lake ({family}): card ranking equals the cpu ranking "
        f"{[r.name for r in out[1][0]]}")


def lake_phase():
    rng = np.random.default_rng(4)
    tables, queries, partners = make_lake(rng, LAKE_TABLES, QUERIES)
    rows = sum(len(k) for _, k, _ in tables)
    log(f"lake: {len(tables)} tables, {rows} rows")
    return tables, queries, partners


def service_phase(family: str, lake):
    """One family's service over the lake: ingest every table, answer the
    64 queries through ``search_batch`` (micro-batches of 16) and through
    ``search``, with the launch counters set to 0 just before and read just
    after.  Gates: batched == sequential bit for bit, finite results, the
    launches the run needs (TS/PS build their rows on the host: only the
    estimate kernel), for TS/PS the stored rows' sorted-prefix layout; for
    ICWS also every planted partner in the top 10 (the other families'
    recall is printed, not gated: losing partners is the paper's finding).
    Returns (launches, recall)."""
    from repro_torch import SketchSearchService
    tables, queries, partners = lake
    svc = SketchSearchService(m=M, seed=0, family=family)
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
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
    launches = {name: fn.launches for name, fn in counters.items()}

    if family in ("ts", "ps"):
        from repro_torch.kernels.sample_estimate import sorted_prefix_ok
        if not sorted_prefix_ok(svc.index.store.buffers()[0]):
            raise AssertionError(f"{family}: stored rows break the "
                                 "sorted-prefix contract")
        log(f"{family}: every stored row keeps the sorted-prefix contract")
    d = svc.describe()
    log(f"{family} ingest: {LAKE_TABLES / ingest_s:.1f} tables/s "
        f"({ingest_s:.1f} s); store {d['corpus_rows']} rows x 3 fields, "
        f"capacity {d['corpus_capacity']}, {d['bytes_per_row']:.0f} B per "
        f"row, {3 * d['corpus_capacity'] * d['bytes_per_row'] / 1e6:.1f} MB")
    log(f"{family} query p50 {d['query_ms_p50']:.2f} ms (search, "
        f"{d['queries_served']} queries); batch p50 {d['batch_ms_p50']:.2f} "
        f"ms (micro-batch of {MICRO_BATCH}, {d['batches_served']} batches; "
        f"{d['batched_query_ms_p50']:.2f} ms per query)")
    if sequential != batched:
        raise AssertionError(f"{family}: batched results differ from "
                             "sequential search")
    in_top, first = 0, 0
    for res, partner in zip(batched, partners):
        for r in res:
            if not (math.isfinite(r.join_size) and math.isfinite(r.corr)):
                raise AssertionError(f"{family}: non-finite result {r}")
        if partner is not None:
            names = [r.name for r in res]
            if family == "icws" and partner not in names:
                raise AssertionError(f"planted {partner} not in top 10: {names}")
            in_top += partner in names
            first += bool(names) and names[0] == partner
    returned = sum(len(res) for res in batched) / len(batched)
    log(f"{family} planted partners: {in_top} of {QUERIES // 2} in the top "
        f"10, {first} ranked first; {returned:.2f} tables returned per query "
        f"(each refined on the host); batched == sequential on {QUERIES} "
        f"queries")
    n_batches = math.ceil(QUERIES / MICRO_BATCH)
    # one sketch launch per ingested table and per query batch or search
    # (none for TS/PS, built on the host), one estimate launch per batch or
    # search
    *sketch_k, est_k = PATH_KERNELS[family]
    need = {k: LAKE_TABLES + n_batches + QUERIES for k in sketch_k}
    need[est_k] = n_batches + QUERIES
    log(f"{family} launches on the serving run: {launches}")
    if any(launches[k] < n for k, n in need.items()):
        raise AssertionError(f"{family}: launch counters {launches} below "
                             f"{need}")
    return launches, {"in_top10": in_top, "first": first,
                      "planted": QUERIES // 2}


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
    phase("build", build_phase)
    sketch, estimate = phase("icws kernels", kernel_phase, dev)
    lin_sketch, lin_estimate = phase("linear kernels", linear_kernel_phase,
                                     dev)
    dmh = phase("dmh kernel", dmh_kernel_phase, dev, sketch)
    sample = phase("sample estimate kernel", sample_kernel_phase, dev)
    for family in FAMILIES:
        phase(f"small lake {family}", small_reference_phase, dev, family)
    lake = phase("lake", lake_phase)
    runs = {family: phase(f"service {family}", service_phase, family, lake)
            for family in FAMILIES}
    log("planted-partner recall, top 10 / ranked first, of "
        f"{QUERIES // 2}: " + ", ".join(
            f"{f} {r['in_top10']}/{r['first']}" for f, (_, r) in runs.items()))
    # a kernel's launches: the sum over the family runs whose path it is on
    launches = {name: sum(runs[f][0][name] for f in FAMILIES
                          if name in PATH_KERNELS[f])
                for name in launch_counters()}

    rep = sketch[3]   # the query micro-batch launch: B = 48, N = 4096
    lin_rep = {"countsketch_sparse": lin_sketch["cs"][3],
               "jl_sketch": lin_sketch["jl"][3],
               "linear_estimate_fields": lin_estimate[0],
               "dmh_sketch": dmh[3],
               "sample_estimate_fields": sample[0]}
    kernels = [
        {"name": "icws_sketch", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/icws_sketch.cu",
         "replaces": "src/repro/kernels/icws_sketch.py:40",
         "launches": launches["icws_sketch"], "max_abs_err": rep["max_abs_err"],
         "ms": rep["ms"], "device_ms": rep["device_ms"],
         "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
         "bound_by": "operations", "library_ms": None, "shape": rep["shape"],
         "all_shapes": sketch},
        {"name": "estimate_fields", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/estimate_fields.cu",
         "replaces": "src/repro/kernels/estimate.py:215",
         "launches": launches["estimate_fields"],
         "max_abs_err": estimate[0]["max_abs_err"], "ms": estimate[0]["ms"],
         "device_ms": estimate[0]["device_ms"],
         "plain_ms": estimate[0]["plain_ms"],
         "bound_ms": estimate[0]["bound_ms"],
         "bound_by": estimate[0]["bound_by"], "library_ms": None,
         "shape": estimate[0]["shape"], "all_shapes": estimate},
    ]
    for name, source, replaces, shapes in (
            ("countsketch_sparse", "countsketch_sparse.cu",
             "countsketch.py:91", lin_sketch["cs"]),
            ("jl_sketch", "jl_sketch.cu", "jl_sketch.py:28", lin_sketch["jl"]),
            ("linear_estimate_fields", "linear_estimate_fields.cu",
             "estimate.py:407", lin_estimate),
            ("dmh_sketch", "dmh_sketch.cu", "dmh_sketch.py:92", dmh),
            ("sample_estimate_fields", "sample_estimate_fields.cu",
             "sample_estimate.py:86", sample)):
        r = lin_rep[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
            "shape": r["shape"], "all_shapes": shapes})
    log(f"total {time.perf_counter() - t_start:.1f} s on {identity}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
