"""Quickstart on the PyTorch port: sketch two sparse vectors, estimate
their inner product with each of the paper's methods at equal storage.

Run:  PYTHONPATH=src python examples/quickstart_torch.py

The sketchers are the port's host numpy copies (``repro_torch.core``);
its card's serving path (``repro_torch.SketchSearchService``,
``repro_torch.SketchCorpus``) runs the ICWS variant below.
"""
import numpy as np

from repro_torch.core import (PAPER_METHODS, fact1_bound, inner_fast, make,
                              theorem2_bound)
from repro_torch.data.synthetic import sparse_pair


def main():
    rng = np.random.default_rng(0)
    # two sparse vectors with 5% overlapping support -- the paper's regime
    a, b = sparse_pair(rng, n=10_000, nnz=2_000, overlap=0.05)
    true = inner_fast(a, b)
    storage = 400  # total 64-bit words per sketch, the paper's Fig 5 setting

    print(f"true <a,b> = {true:.4f}")
    print(f"Fact 1 scale  eps*||a||*||b||                = {fact1_bound(a, b):.2f}")
    print(f"Theorem 2 scale eps*max(||a_I||||b||, ...)   = {theorem2_bound(a, b):.2f}")
    print("(the gap is the paper's advantage: sqrt(gamma) with gamma = overlap)\n")

    scale = a.norm() * b.norm()
    print(f"{'method':<8}{'estimate':>12}{'err/(|a||b|)':>14}  note")
    for method in PAPER_METHODS + ("icws",):
        sk = make(method, storage, seed=1)
        est = sk.estimate(sk.sketch(a), sk.sketch(b))
        note = {"wmh": "the paper's method",
                "icws": "the serving path's WMH variant"}.get(method,
                                                               "baseline")
        print(f"{method:<8}{est:>12.1f}{abs(est - true) / scale:>14.5f}  {note}")
    print("\n(err/(|a||b|) is the paper's Section-5 error metric; smaller is "
          "better.\n The sampling sketches' wins grow as overlap shrinks.)")


if __name__ == "__main__":
    main()
