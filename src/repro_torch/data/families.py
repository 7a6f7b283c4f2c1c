"""Serving families (port of ``repro.data.families``): ICWS, CS and JL.

A family tells the corpus store and the index what a sketch row is: its
per-row buffers with the fill that keeps unused rows inert, its storage
accounting, the sketch launch and the fused estimate launch.  The port
serves the paper's own method, ICWS weighted MinHash, and the two linear
sketches it is compared with, CountSketch and JL, each sized to the same
storage budget by :func:`make_family`; the other families of the JAX
package wait for later slices (``ROADMAP.md`` Queue A 9 and 11).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

from repro_torch.core.types import SparseVec
from repro_torch.kernels import ops
from repro_torch.kernels.common import CORPUS_PAD_FP

from .ingest import linear_sketch_batch, sketch_batch

# families of the JAX package and the ROADMAP.md queue item that ports each
_QUEUED = {"dmh": "Queue A 9", "ts": "Queue A 11", "ps": "Queue A 11"}
FAMILY_NAMES = ("icws", "cs", "jl")
# CountSketch repetitions (``repro.core.linear.REPS``): the median of five
REPS = 5


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


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet ({item} in "
                              "ROADMAP.md)")


class _LinearFamily:
    """Shared serving plumbing of the linear families (``S(a) = Pi a``).

    A row is one dense ``[R, W]`` f32 table; estimation is per-rep dots and
    the median over reps (R = 1 for JL, where the median is the dot).
    Everything is zero-fill inert: empty sketches, spare capacity and
    padding all estimate to exactly zero.
    """

    reps: int
    width: int
    seed: int
    name: str

    @property
    def components(self) -> Tuple[ComponentSpec, ...]:
        return (ComponentSpec("tables", (self.reps, self.width),
                              torch.float32, 0.0),)

    def storage_doubles_per_row(self) -> float:
        """Paper accounting: every table cell is one double equivalent."""
        return float(self.reps * self.width)

    def sketch_rows(self, vecs: Sequence[SparseVec], *, bucket: int = 256,
                    device="cuda"):
        """One linear-sketch kernel launch: B sparse vectors -> ``([B, R,
        W] tables,)`` on ``device``."""
        return (linear_sketch_batch(vecs, method=self.name, width=self.width,
                                    reps=self.reps, seed=self.seed,
                                    bucket=bucket, device=device),)

    def estimate_fields(self, q, c, *, qmap, cmap):
        """All field pairs of a query batch against the corpus tables in
        one launch: ``q = (tq,)`` [F, Q, R, W], ``c = (tc,)`` [C, P, R, W]
        -> [G, Q, P] f32 estimates."""
        return ops.linear_estimate_fields(q[0], c[0], qmap=qmap, cmap=cmap)

    def merge_rows(self, a, b):
        _not_ported("merging linear sketch rows", "Queue A 13")

    def host_oracle(self):
        _not_ported("the host oracle", "Queue A 19")

    @property
    def packed_components(self):
        _not_ported("packed storage", "Queue A 12")

    def pack_rows(self, rows):
        _not_ported("packed storage", "Queue A 12")

    def unpack_rows(self, rows):
        _not_ported("packed storage", "Queue A 12")

    def estimate_fields_packed(self, q, c, *, qmap, cmap):
        _not_ported("packed storage", "Queue A 12")

    def estimate_fields_sharded(self, q, c, *, qmap, cmap, mesh, axis):
        _not_ported("sharded serving", "Queue A 14")

    def estimate_fields_packed_sharded(self, q, c, *, qmap, cmap, mesh,
                                       axis):
        _not_ported("sharded serving", "Queue A 14")


@dataclasses.dataclass(frozen=True)
class CSFamily(_LinearFamily):
    """CountSketch serving family (median of ``reps`` repetitions)."""

    width: int
    reps: int = REPS
    seed: int = 0
    name: str = dataclasses.field(default="cs", init=False)


@dataclasses.dataclass(frozen=True)
class JLFamily(_LinearFamily):
    """JL / AMS projection serving family (a single ``[1, m]`` table row)."""

    m: int
    seed: int = 0
    name: str = dataclasses.field(default="jl", init=False)

    @property
    def reps(self) -> int:
        return 1

    @property
    def width(self) -> int:
        return self.m


def make_family(name: str, *, storage: float, seed: int = 0):
    """The serving family sized to a storage budget, as
    ``repro.core.registry`` sizes it: icws ``m = (storage - 1) / 1.5``; cs
    ``width = storage // reps`` with five reps; jl ``m = storage``.
    Families built from one budget are storage-matched."""
    if name == "icws":
        return ICWSFamily(m=max(1, int((storage - 1) / 1.5)), seed=seed)
    if name == "cs":
        return CSFamily(width=max(1, int(storage // REPS)), reps=REPS,
                        seed=seed)
    if name == "jl":
        return JLFamily(m=max(1, int(storage)), seed=seed)
    if name in _QUEUED:
        raise NotImplementedError(
            f"family {name!r} is not ported yet ({_QUEUED[name]} in "
            f"ROADMAP.md); this port serves {', '.join(FAMILY_NAMES)}")
    raise ValueError(f"unknown sketch family {name!r}; choose from "
                     f"{FAMILY_NAMES}")


def wmh_storage(m: int) -> float:
    """The storage budget an m-sample ICWS sketch occupies: the anchor the
    index sizes its family from."""
    return ICWSFamily(m=m).storage_doubles_per_row()
