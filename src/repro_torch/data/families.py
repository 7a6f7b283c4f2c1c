"""Serving families (port of ``repro.data.families``): all six of the JAX
package -- ICWS, DMH, CountSketch, JL, TS and PS.

A family tells the corpus store and the index what a sketch row is: its
per-row buffers with the fill that keeps unused rows inert, its storage
accounting, the sketch build and the fused estimate launch.  The port
serves the paper's own method, ICWS weighted MinHash, its constant-time
ingest variant DMH (same wire layout and estimate), the two linear
sketches it is compared with, CountSketch and JL, and the two sampling
sketches, threshold (TS) and priority (PS) sampling, each sized to the
same storage budget by :func:`make_family`.  Each family also has the
packed layout of the JAX package (``packed_components``, ``pack_rows``,
``unpack_rows``, ``estimate_fields_packed``): every f32 value lane as
bf16-halfword pairs in i32 words (:mod:`repro_torch.kernels.packed`), an
odd width gaining one inert pad slot.  Members not ported yet (merging,
the host oracle, sharded serving) raise ``NotImplementedError`` naming
their ``ROADMAP.md`` item.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

from repro_torch.core.types import SparseVec
from repro_torch.kernels import ops
from repro_torch.kernels.common import CORPUS_PAD_FP
from repro_torch.kernels.packed import pack_halfwords_f32, unpack_halfwords_f32

from .ingest import (dmh_sketch_batch, linear_sketch_batch,
                     sample_sketch_batch, sketch_batch)

FAMILY_NAMES = ("icws", "cs", "jl", "ts", "ps", "dmh")
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


def _pad_last(x, n: int, value=0) -> torch.Tensor:
    """``x`` with its last dim padded by ``n`` elements of ``value``."""
    x = torch.as_tensor(x)
    return torch.nn.functional.pad(x, (0, n), value=value) if n else x


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet ({item} in "
                              "ROADMAP.md)")


class _Unported:
    """The JAX family members the port does not serve yet; each raises
    ``NotImplementedError`` naming its ``ROADMAP.md`` item."""

    def merge_rows(self, a, b):
        _not_ported(f"merging {self.name} sketch rows", "Queue A 13")

    def host_oracle(self):
        _not_ported("the host oracle", "Queue A 19")

    def estimate_fields_sharded(self, q, c, *, qmap, cmap, mesh, axis):
        _not_ported("sharded serving", "Queue A 14")

    def estimate_fields_packed_sharded(self, q, c, *, qmap, cmap, mesh,
                                       axis):
        _not_ported("sharded serving", "Queue A 14")


@dataclasses.dataclass(frozen=True)
class ICWSFamily(_Unported):
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

    @property
    def packed_components(self) -> Tuple[ComponentSpec, ...]:
        """Fingerprints stay i32 (exact-match state), values pack two per
        word (me = m rounded up to even), norms stay f32; the argkeys
        sidecar is dropped: 6 me + 4 bytes per row."""
        me = self.m + self.m % 2
        return (ComponentSpec("fingerprints", (me,), torch.int32,
                              CORPUS_PAD_FP),
                ComponentSpec("packed_values", (me // 2,), torch.int32, 0.0),
                ComponentSpec("norms", (), torch.float32, 0.0))

    def pack_rows(self, rows):
        """(fp, val, norm[, argkey]) -> packed components, any leading
        dims: values bf16-truncated, argkeys dropped."""
        fp = _pad_last(torch.as_tensor(rows[0]).to(torch.int32), self.m % 2,
                       CORPUS_PAD_FP)
        val = _pad_last(torch.as_tensor(rows[1]).to(torch.float32),
                        self.m % 2)
        return (fp, pack_halfwords_f32(val),
                torch.as_tensor(rows[2]).to(torch.float32))

    def unpack_rows(self, rows):
        """Packed components -> unpacked rows (``pack(unpack(p)) == p``);
        the argkeys come back zeroed."""
        fp, w, norm = (torch.as_tensor(x) for x in rows)
        return (fp[..., :self.m].to(torch.int32),
                unpack_halfwords_f32(w)[..., :self.m], norm.to(torch.float32),
                torch.zeros(fp.shape[:-1] + (self.m,), dtype=torch.int32,
                            device=fp.device))

    def estimate_fields_packed(self, q, c, *, qmap, cmap):
        """:meth:`estimate_fields` over packed corpus buffers ``c = (fc, wc,
        nc)``."""
        return ops.icws_estimate_fields_packed(q[0], q[1], q[2], c[0], c[1],
                                               c[2], qmap=qmap, cmap=cmap)


@dataclasses.dataclass(frozen=True)
class DMHFamily(ICWSFamily):
    """DMH (densified one-permutation weighted MinHash) serving family.

    The ICWS wire layout, storage accounting and fused estimate launch;
    only the build differs: one DMH kernel launch, O(c * nnz + m) per
    vector (``c = dmh_replication(m) <= 4`` pseudo-key replicas) against
    ICWS's O(nnz * m).
    """

    name: str = dataclasses.field(default="dmh", init=False)

    def sketch_rows(self, vecs: Sequence[SparseVec], *, bucket: int = 256,
                    device="cuda"):
        """One DMH kernel launch: B sparse vectors -> (fp, val, norm,
        argkey) rows on ``device``."""
        return dmh_sketch_batch(vecs, m=self.m, seed=self.seed,
                                bucket=bucket, device=device)


class _LinearFamily(_Unported):
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

    @property
    def packed_components(self) -> Tuple[ComponentSpec, ...]:
        """Every cell bf16-truncated, two per word (an odd width gains one
        zero column): half the unpacked bytes."""
        we = self.width + self.width % 2
        return (ComponentSpec("packed_tables", (self.reps, we // 2),
                              torch.int32, 0.0),)

    def pack_rows(self, rows):
        t = torch.as_tensor(rows[0]).to(torch.float32)
        return (pack_halfwords_f32(_pad_last(t, self.width % 2)),)

    def unpack_rows(self, rows):
        return (unpack_halfwords_f32(rows[0])[..., :self.width],)

    def estimate_fields_packed(self, q, c, *, qmap, cmap):
        """:meth:`estimate_fields` over packed corpus tables ``c = (wc,)``."""
        return ops.linear_estimate_fields_packed(q[0], c[0], qmap=qmap,
                                                 cmap=cmap)


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


class _SamplingFamily(_Unported):
    """Shared serving plumbing of the sampling families (TS/PS).

    A row is a fixed-slot coordinate sample ``(keys [S] i32, values [S]
    f32, tau [] f32)`` (``repro_torch.core.sampling``); estimation is the
    unaligned key-match launch, matches reweighted by inverse inclusion
    probability.  Spare rows hold corpus-pad keys (-2), zero values and
    zero tau (probability 0 on every slot) and estimate to exactly zero.
    Rows are built on the host (weighted sampling is per-vector select
    work); the device holds them and runs the estimate.
    """

    slots: int
    seed: int
    name: str

    @property
    def components(self) -> Tuple[ComponentSpec, ...]:
        return (ComponentSpec("keys", (self.slots,), torch.int32,
                              CORPUS_PAD_FP),
                ComponentSpec("values", (self.slots,), torch.float32, 0.0),
                ComponentSpec("taus", (), torch.float32, 0.0))

    def storage_doubles_per_row(self) -> float:
        """A key (i32) + value (f32) pair per slot is one double
        equivalent, plus one double for tau."""
        return float(self.slots) + 1.0

    def sketch_rows(self, vecs: Sequence[SparseVec], *, bucket: int = 256,
                    device="cuda"):
        """Host-build B sample rows and move them to ``device`` (``bucket``
        is a padding knob of the kernel-built families; sampling rows are
        fixed-slot already)."""
        del bucket
        return sample_sketch_batch(vecs, slots=self.slots, method=self.name,
                                   seed=self.seed, device=device)

    def estimate_fields(self, q, c, *, qmap, cmap):
        """All field pairs of a query batch against the corpus samples in
        one launch: ``q = (kq, vq, tq)`` [F, Q, ...], ``c = (kc, vc, tc)``
        [C, P, ...] -> [G, Q, P] f32 estimates."""
        return ops.sample_estimate_fields(q[0], q[1], q[2], c[0], c[1], c[2],
                                          qmap=qmap, cmap=cmap)

    @property
    def packed_components(self) -> Tuple[ComponentSpec, ...]:
        """Keys stay i32 (exact-match state), values pack two per word (an
        odd slot count gains one pad slot, key -2), taus stay f32: 6 Se + 4
        bytes per row."""
        se = self.slots + self.slots % 2
        return (ComponentSpec("keys", (se,), torch.int32, CORPUS_PAD_FP),
                ComponentSpec("packed_values", (se // 2,), torch.int32, 0.0),
                ComponentSpec("taus", (), torch.float32, 0.0))

    def pack_rows(self, rows):
        k = _pad_last(torch.as_tensor(rows[0]).to(torch.int32),
                      self.slots % 2, CORPUS_PAD_FP)
        v = _pad_last(torch.as_tensor(rows[1]).to(torch.float32),
                      self.slots % 2)
        return (k, pack_halfwords_f32(v),
                torch.as_tensor(rows[2]).to(torch.float32))

    def unpack_rows(self, rows):
        k, w, t = (torch.as_tensor(x) for x in rows)
        return (k[..., :self.slots].to(torch.int32),
                unpack_halfwords_f32(w)[..., :self.slots], t.to(torch.float32))

    def estimate_fields_packed(self, q, c, *, qmap, cmap):
        """:meth:`estimate_fields` over packed corpus buffers ``c = (kc, wc,
        tc)``."""
        return ops.sample_estimate_fields_packed(q[0], q[1], q[2], c[0], c[1],
                                                 c[2], qmap=qmap, cmap=cmap)


@dataclasses.dataclass(frozen=True)
class TSFamily(_SamplingFamily):
    """Threshold-sampling serving family."""

    slots: int
    seed: int = 0
    name: str = dataclasses.field(default="ts", init=False)


@dataclasses.dataclass(frozen=True)
class PSFamily(_SamplingFamily):
    """Priority-sampling serving family."""

    slots: int
    seed: int = 0
    name: str = dataclasses.field(default="ps", init=False)


def make_family(name: str, *, storage: float, seed: int = 0):
    """The serving family sized to a storage budget, as
    ``repro.core.registry`` sizes it: icws and dmh ``m = (storage - 1) /
    1.5``; cs ``width = storage // reps`` with five reps; jl ``m =
    storage``; ts and ps ``slots = storage - 1``.  Families built from one
    budget are storage-matched."""
    if name in ("icws", "dmh"):
        cls = ICWSFamily if name == "icws" else DMHFamily
        return cls(m=max(1, int((storage - 1) / 1.5)), seed=seed)
    if name == "cs":
        return CSFamily(width=max(1, int(storage // REPS)), reps=REPS,
                        seed=seed)
    if name == "jl":
        return JLFamily(m=max(1, int(storage)), seed=seed)
    if name in ("ts", "ps"):
        cls = TSFamily if name == "ts" else PSFamily
        return cls(slots=max(1, int(storage - 1)), seed=seed)
    raise ValueError(f"unknown sketch family {name!r}; choose from "
                     f"{FAMILY_NAMES}")


def wmh_storage(m: int) -> float:
    """The storage budget an m-sample ICWS sketch occupies: the anchor the
    index sizes its family from."""
    return ICWSFamily(m=m).storage_doubles_per_row()
