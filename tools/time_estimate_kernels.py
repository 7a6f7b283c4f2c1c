"""Device time of the estimate kernels (B2, B11, B3, B4, B8, B12; with
``--sample`` B9 and B13) of checkouts.

    python3 tools/time_estimate_kernels.py [--sample] SRC [SRC ...]

Each SRC is the ``src`` directory of a checkout (its own ``repro_torch``).
For each one in turn, a fresh process builds that checkout's kernels (under
``build/time_estimate/`` at the repository root, keyed by their sources,
so a checkout given twice builds once) and times, with CUDA events, median
of 5 runs of 10 launches, on the same seeded inputs and the service's G = 6
field pairs: B2 (``estimate_fields_cuda``) and B11
(``estimate_fields_packed_cuda``) on 16 queries against P = 131,072 corpus
rows per field at m = 512, with the collision share of ``chip_smoke.py``'s
estimate phase, then Q = 1 and Q = 16 against P = 16,384 (the service's
`search` and micro-batch); B3 on field 0 of those rows: the one-vs-many
route (``estimate_one_vs_many_cuda``, query 0) at P = 131,072 and at the
corpus path's P (``chip_smoke.CORPUS_P``, 65,536: the capacity of the
store ``estimate_vec`` runs over) and the pairwise route
(``estimate_partials_cuda``, query 0 tiled) at P = 131,072; B4
(``estimate_many_vs_many_cuda``) on field 0's queries at Q = 16 and 1
against P = 131,072, with B2 at G = 1 (``qmap = cmap = (0,)``, the same
function: equal digests) at both beside it as the control; B8
(``linear_estimate_fields_cuda``) and B12
(``linear_estimate_fields_packed_cuda``, over the packed corpus) on
CountSketch (R = 5, W = 153) and JL (R = 1, W = 769) tables at the same
three shapes.  One line per (checkout, kernel, shape) with the first 16
hex digits of the SHA-256 of the output's bits, and the card's name and
power limit.  Give the checkouts in turns (A B B A) to compare two
versions on one card.  Needs one card.

With ``--sample`` each run takes instead the TS/PS key-match kernels on
``chip_smoke.py``'s rows (``sample_rows`` of this tree: 16 queries' real TS
rows, S = 768, against synthetic corpus rows): B9
(``sample_estimate_fields_cuda``) at Q in {16, 1} x P in {16,384,
131,072}, B13 (``sample_estimate_fields_packed_cuda``) at Q in {16, 1}, P
= 16,384, each kernel alone (device ms from ``chip_smoke.device_ms``: a
profiler trace), B9 also at two more group sizes (``GROUP_BYTES``, where
the checkout has it) at Q = 16; then the ops call
(``ops.sample_estimate_fields`` / ``ops.sample_estimate_fields_packed``,
the signature both kinds of checkout share: median of 5 runs of 10 calls,
CUDA events, host time included).  A kernel whose wrapper takes the
corpus probabilities ``ac`` gets them from the prologue outside the
timing; one that takes the taus ``tc`` gets those.  Each case prints the
first 16 hex digits of the SHA-256 of its output's bits, so that equal
bits show.
"""
from __future__ import annotations

import hashlib
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
SHAPES = ((Q, P), (1, 16_384), (Q, 16_384))
CORPUS_P = 65_536   # chip_smoke.CORPUS_P
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


def timed(torch, run):
    """(:func:`median_ms` of ``run``, :func:`digest` of its output)."""
    return median_ms(torch, run), digest(run())


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
            out[f"{kernel} G=6 Q={q} P={p}"] = timed(torch, lambda: fn(
                fq[:, :q], vq[:, :q], fc[:, -p:], corpus[:, -p:], qmap=QMAP,
                cmap=CMAP))
    del wc
    fq, vq, fc, vc = fq[0], vq[0], fc[0], vc[0]
    for p in (P, CORPUS_P):
        out[f"B3 one-vs-many P={p}"] = timed(torch, lambda: (
            ke.estimate_one_vs_many_cuda(fq[0], vq[0], fc[-p:], vc[-p:])))
    ta, tv = fq[0].expand(P, M).contiguous(), vq[0].expand(P, M).contiguous()
    out[f"B3 pairwise P={P}"] = timed(
        torch, lambda: ke.estimate_partials_cuda(ta, tv, fc, vc))
    del ta, tv
    for q in (Q, 1):
        out[f"B4 Q={q} P={P}"] = timed(torch, lambda: (
            ke.estimate_many_vs_many_cuda(fq[:q], vq[:q], fc, vc)))
        out[f"B2 G=1 Q={q} P={P} (control)"] = timed(torch, lambda: tuple(
            x[0] for x in ke.estimate_fields_cuda(
                fq[None, :q], vq[None, :q], fc[None], vc[None], qmap=(0,),
                cmap=(0,))))
    del fq, vq, fc, vc
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
                out[f"{kernel} {name} G=6 Q={q} P={p}"] = timed(
                    torch, lambda: fn(qt[:, :q], corpus[:, -p:], qmap=QMAP,
                                      cmap=CMAP))
        del tq, tc, tqe, wl
    print(json.dumps(out))


def digest(x) -> str:
    """The first 16 hex digits of the SHA-256 of the bits of a tensor or of
    a tuple of them."""
    h = hashlib.sha256()
    for t in x if isinstance(x, tuple) else (x,):
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


SAMPLE_SHAPES = ((16, 16_384), (1, 16_384), (16, 131_072), (1, 131_072))
PACKED_SAMPLE_Q = (16, 1)
# B9's group sizes timed beside the default at Q = 16
SAMPLE_GROUP_BYTES = (110 * 1024, 150 * 1024)


def sample_child() -> None:
    import inspect
    import torch
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.data.dataset_search import CFIELD, QFIELD
    from repro_torch.kernels import ops
    from repro_torch.kernels import sample_estimate as ks
    from repro_torch.kernels.packed import pack_halfwords_f32
    dev = torch.device("cuda")
    cs.build_phase()
    (kq, vq, aq), tq, (kc, vc, tc) = cs.sample_rows(dev)
    takes_taus = list(inspect.signature(
        ks.sample_estimate_fields_cuda).parameters)[5] == "tc"
    corpus = tc if takes_taus else ks.sample_inclusion_probs(vc, tc)
    maps = dict(qmap=QFIELD, cmap=CFIELD)
    out = {}

    def kernel_case(label, fn, symbol):
        got = fn()
        ms, _ = cs.device_ms(fn, symbol)
        out[label] = (ms, digest(got))

    for qn, p in SAMPLE_SHAPES:
        q = (kq[:, :qn], vq[:, :qn], aq[:, :qn])
        c = (kc[:, -p:], vc[:, -p:], corpus[:, -p:])
        kernel_case(f"B9 Q={qn} P={p}",
                    lambda: ks.sample_estimate_fields_cuda(*q, *c, **maps),
                    "sample_estimate_fields_kernel")
        if qn == 16 and hasattr(ks, "GROUP_BYTES"):
            base = ks.GROUP_BYTES
            for gb in SAMPLE_GROUP_BYTES:
                ks.GROUP_BYTES = gb
                kernel_case(f"B9 group {gb} B Q={qn} P={p}",
                            lambda: ks.sample_estimate_fields_cuda(*q, *c,
                                                                   **maps),
                            "sample_estimate_fields_kernel")
            ks.GROUP_BYTES = base
        call = (lambda: ops.sample_estimate_fields(
            kq[:, :qn], vq[:, :qn], tq[:, :qn], kc[:, -p:], vc[:, -p:],
            tc[:, -p:], **maps))
        out[f"ops B9 Q={qn} P={p}"] = timed(torch, call)
    p = SAMPLE_SHAPES[0][1]
    kc, tc = kc[:, -p:], tc[:, -p:]
    wc = pack_halfwords_f32(vc[:, -p:])
    del vc, corpus
    for qn in PACKED_SAMPLE_Q:
        q = (kq[:, :qn], vq[:, :qn], aq[:, :qn])
        kernel_case(f"B13 Q={qn} P={p}",
                    lambda: ks.sample_estimate_fields_packed_cuda(
                        *q, kc, wc, tc, **maps),
                    "sample_estimate_fields_packed_kernel")
        call = (lambda: ops.sample_estimate_fields_packed(
            kq[:, :qn], vq[:, :qn], tq[:, :qn], kc, wc, tc, **maps))
        out[f"ops B13 Q={qn} P={p}"] = timed(torch, call)
    print(json.dumps(out))


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] in ("--child", "--sample-child"):
        sys.path.insert(0, sys.argv[2])
        (child if sys.argv[1] == "--child" else sample_child)()
        return 0
    sample = sys.argv[1:2] == ["--sample"]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    env = dict(os.environ, REPRO_TORCH_BUILD_DIR=str(
        ROOT / "build" / "time_estimate"))
    for n, src in enumerate(sys.argv[1 + sample:]):
        res = subprocess.run([sys.executable, __file__,
                              "--sample-child" if sample else "--child",
                              str(pathlib.Path(src).resolve())], env=env,
                             capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            return res.returncode
        out = json.loads(res.stdout.splitlines()[-1])
        for shape, (ms, dig) in out.items():
            print(f"turn {n} {src}: {shape} {ms:.4f} ms digest {dig} "
                  f"on {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
