"""B1 and B10 (the ICWS sketch kernel and its Pack variant), B6 and B7 (the
CountSketch and JL sketch kernels), B5 and its Pack variant (the DMH
sketch), or B14 (the dense CountSketch), of several checkouts, in turns on
one card.

    python3 tools/time_icws_sketch.py [--linear | --dmh | --dense] ROOT ...

Each ROOT is the root of a checkout (``.`` for the working tree; a parent
unpacked with ``git archive`` into a git-ignored directory such as
``build/parent``).  The roots run in the order given and then in reverse
(A B, B A), each in a fresh process that builds that checkout's kernels
(under its own ``build/``) and runs its ``chip_smoke.py`` cases of the
sketch at the four shapes of the icws kernel phase (``sketch_case``: B = 3
and 48 rows of about 1,000 and 4,000 non-zeros, each held against the
plain version, device ms per launch) and of the Pack variant at B = 48
and 3 (``b10_case``).  Each case also digests the kernel's five outputs on
its own inputs, so that checkouts whose kernels should agree bit for bit
can be seen to.  With ``--linear`` each run takes instead its
``chip_smoke.py`` cases of B6 and B7 (``linear_sketch_case``: B = 3 and
48 rows of about 1,000 and 4,000 non-zeros, and B = 3 rows of about
10,000, the lake's largest table) and digests each kernel's output on the
case's inputs.  With ``--dmh`` each run takes B5 and its Pack variant at
``DMH_SHAPES`` (B = 3 and 48 rows of about 1,000 and 4,000 non-zeros, B = 3
of about 10,000; c = 4 replicas a key at m = 512): a checkout whose DMH
sketch takes ``replicas`` gets the unreplicated rows, an older one the
rows replicated on the host, so both sketch the same lanes; each kernel is
held bit for bit against its plain version, timed alone (device ms from
``chip_smoke.device_ms``) and digested.  Where the checkout has the
launch rule ``_launch_shape``, each shape also runs at other cluster sizes
and block sizes (``DMH_VARIANTS``), each against the same digest.  With
``--dense`` each run takes B14 at ``chip_smoke.py``'s two shapes (the
inputs of ``compression_kernel_phase``: one TinyLlama-1.1B layer's
gradient, T = 44,044,288, and its first chunk, T = L = 65,536 at offset
2^20; W = 4,096, R = 5, seed 17), each held bit for bit against its plain
version, timed alone (device ms of its kernels from
``chip_smoke.device_ms``) and digested.  Prints the card's name and power
limit, each run's lines, and a table of device ms, group size, sample
tile or launch shape, and digest per case and run.  Needs one card.
"""
from __future__ import annotations

import functools
import hashlib
import json
import pathlib
import sys

TAG = "SKETCH_CASES_JSON "
# (B, non-zeros) of the B6 / B7 cases: chip_smoke.py's linear kernel phase
LINEAR_SHAPES = ((3, 1000), (3, 4000), (48, 1000), (48, 4000), (3, 10_000))


def digest(outs):
    """The first 16 hex digits of the SHA-256 of the outputs' bits."""
    h = hashlib.sha256()
    for o in outs:
        h.update(o.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def child(root: pathlib.Path) -> None:
    sys.path[:0] = [str(root / "src"), str(root)]
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.data.dataset_search import DatasetSearchIndex
    from repro_torch.data.ingest import pad_sparse_batch
    from repro_torch.kernels import icws_sketch as ks
    cs.build_phase()
    dev = torch.device("cuda")
    reports = []
    for B, nnz in ((3, 1000), (3, 4000), (48, 1000), (48, 4000)):
        # the inputs sketch_case draws next, drawn again for the digest
        rng = np.random.default_rng((B, nnz))
        index = DatasetSearchIndex(m=cs.M, seed=0, device=dev)
        rep = cs.sketch_case(index, rng, B, nnz, dev)
        rng = np.random.default_rng((B, nnz))
        args = [torch.from_numpy(a).to(dev) for a in pad_sparse_batch(
            cs.field_vectors(index, rng, B, nnz))[:3]]
        rep["bits"] = digest(ks.icws_sketch_cuda(*args, m=cs.M, seed=0))
        rep["bits_packed"] = digest(ks.icws_sketch_packed_cuda(
            *args, m=cs.M, seed=0))
        rep["group_size"] = ks._group_size(B, cs.M, args[0].shape[1])
        reports.append(rep)
    rng = np.random.default_rng(7)
    index = DatasetSearchIndex(m=cs.M, seed=0, device=dev)
    for B in (48, 3):
        rep = cs.b10_case(index, rng, "icws", B, 4000, dev)
        rep["shape"] = "pack " + rep["shape"]
        reports.append(rep)
    print(TAG + json.dumps(reports), flush=True)


def linear_child(root: pathlib.Path) -> None:
    sys.path[:0] = [str(root / "src"), str(root)]
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.data.dataset_search import DatasetSearchIndex
    from repro_torch.data.ingest import pad_linear_batch
    from repro_torch.kernels import countsketch as kc
    from repro_torch.kernels import jl_sketch as kj
    cs.build_phase()
    dev = torch.device("cuda")
    index = DatasetSearchIndex(m=cs.M, seed=0, device=dev)
    reports = []
    for name in ("cs", "jl"):
        fam = cs.family_for(name)
        kernel = (functools.partial(kc.countsketch_sparse_cuda,
                                    width=fam.width, reps=fam.reps, seed=0)
                  if name == "cs" else
                  functools.partial(kj.jl_sketch_cuda, m=fam.m, seed=0))
        for B, nnz in LINEAR_SHAPES:
            # the inputs linear_sketch_case draws next, drawn again
            rng = np.random.default_rng((B, nnz))
            rep = cs.linear_sketch_case(index, rng, name, B, nnz, dev)
            rng = np.random.default_rng((B, nnz))
            args = [torch.from_numpy(a).to(dev) for a in pad_linear_batch(
                cs.field_vectors(index, rng, B, nnz))]
            rep["bits"] = digest([kernel(*args)])
            rep["shape"] = f"{name} {rep['shape']}"
            reports.append(rep)
    print(TAG + json.dumps(reports), flush=True)


# (B, non-zeros) of the B5 cases: chip_smoke.py's dmh kernel phase
DMH_SHAPES = ((3, 1000), (3, 4000), (48, 1000), (48, 4000), (3, 10_000))
# launch rules timed beside a checkout's own: (label, largest cluster,
# lanes a thread)
DMH_VARIANTS = (("cluster<=8", 8, 1), ("cluster<=2", 2, 1),
                ("cluster<=1", 1, 1), ("2 lanes a thread", None, 2))


def dmh_child(root: pathlib.Path) -> None:
    sys.path[:0] = [str(root / "src"), str(root)]
    import inspect
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.core.dmh import dmh_replication, replicate_keys
    from repro_torch.data.dataset_search import DatasetSearchIndex
    from repro_torch.data.ingest import pad_sparse_batch
    from repro_torch.kernels import dmh_sketch as kd
    cs.build_phase()
    dev = torch.device("cuda")
    index = DatasetSearchIndex(m=cs.M, seed=0, device=dev)
    c = dmh_replication(cs.M)
    derived = "replicas" in inspect.signature(kd.dmh_sketch_cuda).parameters
    rule = getattr(kd, "_launch_shape", None)
    top_rule = getattr(kd, "MAX_CLUSTER", None)
    reports = []
    for B, nnz in DMH_SHAPES:
        w, keys, vals, _ = pad_sparse_batch(cs.field_vectors(
            index, np.random.default_rng((B, nnz)), B, nnz))
        n = w.shape[1]
        if derived:
            kw = {"replicas": c}
        else:
            keys = replicate_keys(keys.view(np.uint32), c).view(np.int32)
            w, vals, kw = np.tile(w, (1, c)), np.tile(vals, (1, c)), {}
        args = [torch.from_numpy(a).to(dev) for a in (w, keys, vals)]
        for pack in (False, True):
            kernel = functools.partial(
                kd.dmh_sketch_packed_cuda if pack else kd.dmh_sketch_cuda,
                *args, m=cs.M, seed=0, **kw)
            plain = (kd.dmh_sketch_packed_plain if pack
                     else kd.dmh_sketch_plain)(*args, m=cs.M, seed=0, **kw)
            variants = [("", None)] + [
                (f" {label}", (top, per)) for label, top, per in DMH_VARIANTS
                if rule and not pack]
            for label, variant in variants:
                if variant:
                    top, per = variant
                    kd.MAX_CLUSTER = top or top_rule

                    def shape_of(B_, m_, lanes, per=per):
                        cl, th = rule(B_, m_, lanes)
                        return cl, max(64, th // per)
                    kd._launch_shape = shape_of
                got = kernel()
                torch.cuda.synchronize()
                if not all(torch.equal(x.view(torch.int32),
                                       y.view(torch.int32))
                           for x, y in zip(got, plain)):
                    raise AssertionError(f"dmh B={B} N={n}x{c}{label}: "
                                         "differs from plain")
                ms, _ = cs.device_ms(kernel, "dmh_sketch_kernel")
                shape = kd._launch_shape(B, cs.M, n * c) if rule else (1, 1024)
                kind = "pack " if pack else ""
                reports.append({
                    "shape": f"{kind}B={B} N={n}x{c}{label}",
                    "device_ms": ms, "launch": f"{shape[0]}x{shape[1]}",
                    "bits": digest(got)})
                if variant:
                    kd.MAX_CLUSTER, kd._launch_shape = top_rule, rule
    print(TAG + json.dumps(reports), flush=True)


def dense_child(root: pathlib.Path) -> None:
    sys.path[:0] = [str(root / "src"), str(root)]
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import countsketch as kcs
    from repro_torch.optim.compression import CompressionConfig
    cs.build_phase()
    cfg = CompressionConfig()
    kw = dict(width=cfg.width, reps=cfg.reps, seed=cfg.seed)
    x = torch.from_numpy(np.random.default_rng(17).standard_t(
        3, cs.GRAD_T).astype(np.float32)).cuda()
    L = kcs.DENSE_CHUNK
    reports = []
    for label, xs, offset in ((f"T={cs.GRAD_T}", x, 0),
                              (f"T=L={L}", x[:L], 1 << 20)):
        kernel = functools.partial(kcs.countsketch_dense_cuda, xs, **kw,
                                   offset=offset)
        got = kernel()
        torch.cuda.synchronize()
        want = kcs.countsketch_dense_plain(xs, **kw, offset=offset)
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"dense {label}: differs from plain")
        del want
        ms, _ = cs.device_ms(kernel, ("countsketch_dense_partial",
                                      "countsketch_dense_reduce")
                             if xs.shape[0] > L
                             else "countsketch_dense_partial")
        reports.append({"shape": f"dense {label} W={cfg.width} R={cfg.reps}",
                        "device_ms": ms, "bits": digest([got])})
    print(TAG + json.dumps(reports), flush=True)


def main(argv) -> int:
    from time_flash_attention import turns
    flag = argv[0] if argv[:1] in (["--linear"], ["--dmh"], ["--dense"]) \
        else None
    return turns(__file__, argv[bool(flag):], TAG, lambda root, r: (
        f"{root.name} {r['device_ms']:.4f}"
        + (f" S={r['group_size']}" if "group_size" in r else "")
        + (f" tile={r['tile']}" if "tile" in r else "")
        + (f" launch={r['launch']}" if "launch" in r else "")
        + (f" {r['bits']}" if "bits" in r else "")
        + (f" {r['bits_packed']}" if "bits_packed" in r else "")),
        child_args=(flag,) if flag else ())


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        {"--linear": linear_child, "--dmh": dmh_child,
         "--dense": dense_child}.get(
            (sys.argv[3:4] or [None])[0], child)(
            pathlib.Path(sys.argv[2]).resolve())
    else:
        sys.exit(main(sys.argv[1:]))
