"""B1 and B10 (the ICWS sketch kernel and its Pack variant) of several
checkouts, in turns on one card.

    python3 tools/time_icws_sketch.py ROOT [ROOT ...]

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
can be seen to.  Prints the card's name and power limit, each run's lines,
and a table of device ms, group size and digest per case and run.  Needs
one card.
"""
from __future__ import annotations

import hashlib
import json
import pathlib
import sys

TAG = "SKETCH_CASES_JSON "


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


def main(roots) -> int:
    from time_flash_attention import turns
    return turns(__file__, roots, TAG, lambda root, r: (
        f"{root.name} {r['device_ms']:.4f}"
        + (f" S={r['group_size']} {r['bits']} {r['bits_packed']}"
           if "bits" in r else "")))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(pathlib.Path(sys.argv[2]).resolve())
    else:
        sys.exit(main(sys.argv[1:]))
