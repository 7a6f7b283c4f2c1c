"""The ICWS serving family (port of ``repro.data.families.ICWSFamily``).

A family tells the corpus store and the index what a sketch row is: its
per-row buffers with the fill that keeps unused rows inert, its storage
accounting, the sketch launch and the fused estimate launch.  This slice
ports the paper's own method, ICWS weighted MinHash; the other families
of the JAX package wait for later slices (``ROADMAP.md`` Queue A 9-11).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

from repro_torch.core.types import SparseVec
from repro_torch.kernels import ops
from repro_torch.kernels.common import CORPUS_PAD_FP

from .ingest import sketch_batch

# families of the JAX package and the ROADMAP.md queue item that ports each
_QUEUED = {"dmh": "Queue A 9", "cs": "Queue A 10", "jl": "Queue A 10",
           "ts": "Queue A 11", "ps": "Queue A 11"}
FAMILY_NAMES = ("icws",)


@dataclasses.dataclass(frozen=True)
class ComponentSpec:
    """One per-row buffer: allocated ``[fields, capacity, *trailing]`` and
    filled with ``fill``, the value that keeps unused rows inert."""

    name: str
    trailing: Tuple[int, ...]
    dtype: torch.dtype
    fill: float


@dataclasses.dataclass(frozen=True)
class ICWSFamily:
    """ICWS (weighted MinWise) serving family -- the paper's method.

    Rows are (fingerprints, sampled values, norm, argkeys); estimation is
    the fused collision kernel.
    """

    m: int
    seed: int = 0
    name: str = dataclasses.field(default="icws", init=False)

    @property
    def components(self) -> Tuple[ComponentSpec, ...]:
        # argkeys (the winning key per sample, the merge sidecar) rides last
        # and is never read by an estimate; spare rows fill it with 0
        return (ComponentSpec("fingerprints", (self.m,), torch.int32,
                              CORPUS_PAD_FP),
                ComponentSpec("values", (self.m,), torch.float32, 0.0),
                ComponentSpec("norms", (), torch.float32, 0.0),
                ComponentSpec("argkeys", (self.m,), torch.int32, 0))

    def storage_doubles_per_row(self) -> float:
        """Paper accounting: 1.5 doubles per sample + 1 norm (argkeys is
        not charged: it prices no estimation state)."""
        return 1.5 * self.m + 1.0

    def sketch_rows(self, vecs: Sequence[SparseVec], *, bucket: int = 256,
                    device="cuda"):
        """One ICWS kernel launch: B sparse vectors -> (fp, val, norm,
        argkey) rows on ``device``."""
        return sketch_batch(vecs, m=self.m, seed=self.seed, bucket=bucket,
                            device=device)

    def estimate_fields(self, q, c, *, qmap, cmap):
        """All field pairs of a query batch against corpus buffers in one
        launch: ``q = (fq, vq, nq)`` [F, Q, ...], ``c = (fc, vc, nc)``
        [C, P, ...] -> [G, Q, P] f32 estimates."""
        return ops.icws_estimate_fields(q[0], q[1], q[2], c[0], c[1], c[2],
                                        qmap=qmap, cmap=cmap)


def make_family(name: str, *, storage: float, seed: int = 0) -> ICWSFamily:
    """The serving family sized to a storage budget (icws: ``m = (storage
    - 1) / 1.5``, as ``repro.core.registry.make_icws``)."""
    if name == "icws":
        return ICWSFamily(m=max(1, int((storage - 1) / 1.5)), seed=seed)
    if name in _QUEUED:
        raise NotImplementedError(
            f"family {name!r} is not ported yet ({_QUEUED[name]} in "
            "ROADMAP.md); this port serves 'icws'")
    raise ValueError(f"unknown sketch family {name!r}; choose from "
                     f"{FAMILY_NAMES}")


def wmh_storage(m: int) -> float:
    """The storage budget an m-sample ICWS sketch occupies: the anchor the
    index sizes its family from."""
    return ICWSFamily(m=m).storage_doubles_per_row()
