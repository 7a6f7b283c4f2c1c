"""Device time of the estimate kernels (B2, B11, B8, B12) of checkouts.

    python3 tools/time_estimate_kernels.py SRC [SRC ...]

Each SRC is the ``src`` directory of a checkout (its own ``repro_torch``).
For each one in turn, a fresh process builds that checkout's kernels (under
``build/time_estimate/`` at the repository root, keyed by their sources,
so a checkout given twice builds once) and times, with CUDA events, median
of 5 runs of 10 launches, on the same seeded inputs and the service's G = 6
field pairs: B2 (``estimate_fields_cuda``) and B11
(``estimate_fields_packed_cuda``) on 16 queries against P = 131,072 corpus
rows per field at m = 512, with the collision share of ``chip_smoke.py``'s
estimate phase, then Q = 1 against P = 16,384; B8
(``linear_estimate_fields_cuda``) and B12
(``linear_estimate_fields_packed_cuda``, over the packed corpus) on
CountSketch (R = 5, W = 153) and JL (R = 1, W = 769) tables at the same two
shapes.  One line per (checkout, kernel, shape) and the card's name and
power limit.  Give the checkouts in turns (A B B A) to compare two
versions on one card.  Needs one card.
"""
from __future__ import annotations

import json
import os
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
QMAP = (0, 1, 0, 2, 0, 1)
CMAP = (0, 0, 1, 0, 2, 1)
M, P, Q = 512, 131_072, 16
SHAPES = ((Q, P), (1, 16_384))
# (R, W) of the linear families' tables at m = 512
LINEAR = {"cs": (5, 153), "jl": (1, 769)}


def rows(torch, dev):
    """[3, Q, M] queries and [3, P, M] corpus rows copying a random query's
    samples with a per-row share (cubed uniform), the rest random."""
    g = torch.Generator(device=dev).manual_seed(2)
    fq = torch.randint(0, 2 ** 31 - 1, (3, Q, M), device=dev, generator=g,
                       dtype=torch.int32)
    vq = torch.randn((3, Q, M), device=dev, generator=g)
    src = torch.randint(0, Q, (P,), device=dev, generator=g)
    share = torch.rand((P, 1), device=dev, generator=g) ** 3
    copy = torch.rand((3, P, M), device=dev, generator=g) < share
    fc = torch.where(copy, fq[:, src], torch.randint(
        0, 2 ** 31 - 1, (3, P, M), device=dev, generator=g, dtype=torch.int32))
    vc = torch.where(copy, vq[:, src] * 1.5,
                     torch.randn((3, P, M), device=dev, generator=g) * 0.05)
    return fq, vq, fc, vc


def median_ms(torch, run) -> float:
    """Median over 5 runs of the mean time of 10 calls of ``run``."""
    run()
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(10):
            run()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / 10)
    return statistics.median(times)


def child() -> None:
    import torch
    from repro_torch.kernels import estimate as ke
    from repro_torch.kernels.packed import pack_halfwords_f32
    dev = torch.device("cuda")
    fq, vq, fc, vc = rows(torch, dev)
    wc = pack_halfwords_f32(vc)
    out = {}
    for kernel, fn, corpus in (("B2", ke.estimate_fields_cuda, vc),
                               ("B11", ke.estimate_fields_packed_cuda, wc)):
        for q, p in SHAPES:
            out[f"{kernel} G=6 Q={q} P={p}"] = median_ms(torch, lambda: fn(
                fq[:, :q], vq[:, :q], fc[:, -p:], corpus[:, -p:], qmap=QMAP,
                cmap=CMAP))
    del fq, vq, fc, vc, wc
    g = torch.Generator(device=dev).manual_seed(3)
    for name, (R, W) in LINEAR.items():
        tq = torch.randn((3, Q, R, W), device=dev, generator=g)
        tc = torch.randn((3, P, R, W), device=dev, generator=g)
        pad = (0, W % 2)   # the packed layout's even width
        tqe = torch.nn.functional.pad(tq, pad).contiguous()
        wl = pack_halfwords_f32(torch.nn.functional.pad(tc, pad))
        for kernel, fn, qt, corpus in (
                ("B8", ke.linear_estimate_fields_cuda, tq, tc),
                ("B12", ke.linear_estimate_fields_packed_cuda, tqe, wl)):
            for q, p in SHAPES:
                out[f"{kernel} {name} G=6 Q={q} P={p}"] = median_ms(
                    torch, lambda: fn(qt[:, :q], corpus[:, -p:], qmap=QMAP,
                                      cmap=CMAP))
        del tq, tc, tqe, wl
    print(json.dumps(out))


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        sys.path.insert(0, sys.argv[2])
        child()
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    env = dict(os.environ, REPRO_TORCH_BUILD_DIR=str(
        ROOT / "build" / "time_estimate"))
    for n, src in enumerate(sys.argv[1:]):
        res = subprocess.run([sys.executable, __file__, "--child",
                              str(pathlib.Path(src).resolve())], env=env,
                             capture_output=True, text=True, check=True)
        for shape, ms in json.loads(res.stdout.splitlines()[-1]).items():
            print(f"turn {n} {src}: {shape} {ms:.4f} ms on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
