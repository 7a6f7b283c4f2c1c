"""B1 and B10 (the ICWS sketch kernel and its Pack variant), or B6 and B7
(the CountSketch and JL sketch kernels), of several checkouts, in turns on
one card.

    python3 tools/time_icws_sketch.py [--linear] ROOT [ROOT ...]

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
case's inputs.  Prints the card's name and power limit, each run's lines,
and a table of device ms, group size or sample tile, and digest per case
and run.  Needs one card.
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


def main(argv) -> int:
    from time_flash_attention import turns
    linear = argv[:1] == ["--linear"]
    return turns(__file__, argv[linear:], TAG, lambda root, r: (
        f"{root.name} {r['device_ms']:.4f}"
        + (f" S={r['group_size']}" if "group_size" in r else "")
        + (f" tile={r['tile']}" if "tile" in r else "")
        + (f" {r['bits']}" if "bits" in r else "")
        + (f" {r['bits_packed']}" if "bits_packed" in r else "")),
        child_args=("--linear",) if linear else ())


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        (linear_child if sys.argv[3:4] == ["--linear"] else child)(
            pathlib.Path(sys.argv[2]).resolve())
    else:
        sys.exit(main(sys.argv[1:]))
