"""The JL sketch kernel (B7) at both of its sample tiles, in turns.

    python3 tools/jl_tiles.py

``jl_sketch_cuda`` gives a block a tile of 8 or 16 samples, picked by
``_t_tile`` from the launch shape.  This runs the kernel at both tiles on
``chip_smoke.py``'s field rows at B = 3 and 48 rows of about 1,000 and
4,000 non-zeros and 48 rows of about 2,000 (a query micro-batch), in the
order 8, 16, 16, 8, and prints each tile's device ms per launch
(``chip_smoke.device_ms``) and whether both tiles give the same bits.
Needs one card.
"""
from __future__ import annotations

import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPES = ((3, 1000), (3, 4000), (48, 1000), (48, 4000), (48, 2000))


def main() -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.data.dataset_search import DatasetSearchIndex
    from repro_torch.data.ingest import pad_linear_batch
    from repro_torch.kernels import jl_sketch as kj
    cs.build_phase()
    print(cs.card_identity(), flush=True)
    dev = torch.device("cuda")
    index = DatasetSearchIndex(m=cs.M, seed=0, device=dev)
    m = cs.family_for("jl").m
    chosen = kj._t_tile
    try:
        for B, nnz in SHAPES:
            rng = np.random.default_rng((B, nnz))
            keys, vals = (torch.from_numpy(a).to(dev) for a in
                          pad_linear_batch(cs.field_vectors(index, rng, B,
                                                            nnz)))
            times, outs = {}, {}
            for tile in (8, 16, 16, 8):
                kj._t_tile = lambda B, m, tile=tile: tile
                outs[tile] = kj.jl_sketch_cuda(keys, vals, m=m, seed=0)
                times.setdefault(tile, []).append(cs.device_ms(
                    lambda: kj.jl_sketch_cuda(keys, vals, m=m, seed=0),
                    "jl_sketch_kernel")[0])
            print(f"B={B} N={keys.shape[1]} (chosen tile "
                  f"{chosen(B, m)}): tile 8 "
                  + ", ".join(f"{t:.4f}" for t in times[8]) + "; tile 16 "
                  + ", ".join(f"{t:.4f}" for t in times[16])
                  + f"; same bits {torch.equal(outs[8], outs[16])}",
                  flush=True)
    finally:
        kj._t_tile = chosen
    return 0


if __name__ == "__main__":
    sys.exit(main())
