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
odd width gaining one inert pad slot.

``merge_rows`` combines row-aligned rows that sketch disjoint key
partitions of the same vectors (:mod:`.merge`): CS and JL tables add;
ICWS and DMH re-score both winners of a slot under the merged norm on the
shared u32 streams, as torch ops where the rows lie; TS and PS re-subsample
the pooled slots on the host in float64.  ``host_oracle`` returns the
numpy sketcher on the same RNG contract (:mod:`repro_torch.core`).
``estimate_fields_sharded`` and ``estimate_fields_packed_sharded`` run
the same launches over corpus rows split across a mesh axis
(``ops.*_sharded``); a corpus component there may be a tensor or a
sharded store's per-shard tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import registry, u32
from repro_torch.core.dmh import DMH
from repro_torch.core.icws import ICWS
from repro_torch.core.linear import REPS, CountSketchU32, JLU32
from repro_torch.core.sampling import (SAMPLE_STREAM_HASH,
                                       PrioritySamplingU32,
                                       ThresholdSamplingU32)
from repro_torch.core.types import SparseVec
from repro_torch.kernels import ops
from repro_torch.kernels.common import (BIG, CORPUS_PAD_FP, DMH_DRAWS,
                                        DMH_STREAM_BIN, DMH_STREAM_FP,
                                        ICWS_DRAWS, ICWS_STREAM_FP, as_u32,
                                        densify_sources, hash_u32,
                                        icws_rank, level_fingerprint,
                                        salt_for)
from repro_torch.kernels.packed import pack_halfwords_f32, unpack_halfwords_f32

from .ingest import (dmh_sketch_batch, linear_sketch_batch,
                     sample_sketch_batch, sketch_batch)

FAMILY_NAMES = ("icws", "cs", "jl", "ts", "ps", "dmh")


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


def _merged_norm(na: torch.Tensor, nb: torch.Tensor) -> torch.Tensor:
    """The norm of a disjoint union; a side with norm 0 passes the other
    through untouched (``sqrt(n^2)`` may round)."""
    norm_q = torch.sqrt(na * na + nb * nb)
    return torch.where(na == 0, nb, torch.where(nb == 0, na, norm_q))


def _pick_b(aa, ab, ka, kb) -> torch.Tensor:
    """Where the b side wins a slot: the smaller hash value, ties toward
    the smaller u32 key, so the merge commutes bit for bit."""
    return (ab < aa) | ((ab == aa) & (as_u32(kb) < as_u32(ka)))


def _to_numpy(x) -> np.ndarray:
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


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

    def estimate_fields_sharded(self, q, c, *, qmap, cmap, mesh, axis):
        """:meth:`estimate_fields` over corpus rows split across mesh axis
        ``axis``."""
        return ops.icws_estimate_fields_sharded(
            q[0], q[1], q[2], c[0], c[1], c[2], qmap=qmap, cmap=cmap,
            mesh=mesh, axis=axis)

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

    def estimate_fields_packed_sharded(self, q, c, *, qmap, cmap, mesh,
                                       axis):
        return ops.icws_estimate_fields_packed_sharded(
            q[0], q[1], q[2], c[0], c[1], c[2], qmap=qmap, cmap=cmap,
            mesh=mesh, axis=axis)

    def merge_rows(self, a, b):
        """Coordinated per-slot min-merge of row-aligned ``(fp, val, norm,
        argkey)`` rows (any leading dims) that sketch disjoint partitions
        of the same vectors; the device twin of :meth:`ICWS.merge`.  Both
        winners of a slot are re-scored under the merged norm on the
        shared u32 streams, the smaller hash wins (ties toward the smaller
        key) and its fingerprint is re-derived at the re-levelled weight.
        Runs where the rows lie."""
        fpa, va, na, ka = (torch.as_tensor(x) for x in a)
        fpb, vb, nb, kb = (torch.as_tensor(x) for x in b)
        t = torch.arange(self.m, device=fpa.device)
        norm_c = _merged_norm(na, nb)
        safe_c = torch.clamp_min(norm_c, 1e-37)[..., None]

        def rescore(fp, val, norm, key):
            z = val * (norm[..., None] / safe_c)
            w = z * z
            av, lvl = icws_rank(as_u32(key), w, self.seed, ICWS_DRAWS, t)
            return z, torch.where((fp < 0) | (w <= 0), BIG, av), lvl

        za, aa, la = rescore(fpa, va, na, ka)
        zb, ab, lb = rescore(fpb, vb, nb, kb)
        pick_b = _pick_b(aa, ab, ka, kb)
        key_c = torch.where(pick_b, kb, ka)
        fp_c = level_fingerprint(key_c, torch.where(pick_b, lb, la),
                                 self.seed, ICWS_STREAM_FP, t)
        dead = torch.minimum(aa, ab) >= BIG
        return (torch.where(dead, -1, fp_c).to(torch.int32),
                torch.where(dead, 0.0, torch.where(pick_b, zb, za))
                .to(torch.float32),
                norm_c.to(torch.float32),
                torch.where(dead, 0, key_c).to(torch.int32))

    def host_oracle(self) -> ICWS:
        return ICWS(m=self.m, seed=self.seed)


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

    def merge_rows(self, a, b):
        """Coordinated union-merge of row-aligned DMH rows; the device twin
        of :meth:`DMH.merge`.  Bin t holds its own minimum iff
        ``bin(argkey[t]) == t``; those origins re-score under the merged
        norm (DMH streams at t = bin), the smaller hash wins (ties toward
        the smaller key), and bins with no origin on either side re-densify
        from the merged occupancy through the sketch kernel's probes."""
        fpa, va, na, ka = (torch.as_tensor(x) for x in a)
        fpb, vb, nb, kb = (torch.as_tensor(x) for x in b)
        t = torch.arange(self.m, device=fpa.device)
        norm_c = _merged_norm(na, nb)
        safe_c = torch.clamp_min(norm_c, 1e-37)[..., None]
        bin_salt = salt_for(self.seed, DMH_STREAM_BIN,
                            torch.zeros((), dtype=torch.int64,
                                        device=fpa.device))

        def rescore(fp, val, norm, key):
            kk = as_u32(key)
            origin = (fp >= 0) & (hash_u32(kk, bin_salt) % self.m == t)
            z = val * (norm[..., None] / safe_c)
            w = z * z
            av, lvl = icws_rank(kk, w, self.seed, DMH_DRAWS, t)
            return z, torch.where(origin & (w > 0), av, BIG), lvl

        za, aa, la = rescore(fpa, va, na, ka)
        zb, ab, lb = rescore(fpb, vb, nb, kb)
        pick_b = _pick_b(aa, ab, ka, kb)
        key_c = torch.where(pick_b, kb, ka)
        fp_c = level_fingerprint(key_c, torch.where(pick_b, lb, la),
                                 self.seed, DMH_STREAM_FP, t)
        occ = torch.minimum(aa, ab) < BIG
        fp_c = torch.where(occ, fp_c, -1).to(torch.int32)
        val_c = torch.where(occ, torch.where(pick_b, zb, za),
                            0.0).to(torch.float32)
        key_c = torch.where(occ, key_c, 0).to(torch.int32)
        need, src = densify_sources(occ, self.seed, self.m)

        def borrow(x):
            return torch.where(need, torch.gather(x, -1, src), x)

        return (borrow(fp_c), borrow(val_c), norm_c.to(torch.float32),
                borrow(key_c))

    def host_oracle(self) -> DMH:
        return DMH(m=self.m, seed=self.seed)


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

    def estimate_fields_sharded(self, q, c, *, qmap, cmap, mesh, axis):
        return ops.linear_estimate_fields_sharded(q[0], c[0], qmap=qmap,
                                                  cmap=cmap, mesh=mesh,
                                                  axis=axis)

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

    def estimate_fields_packed_sharded(self, q, c, *, qmap, cmap, mesh,
                                       axis):
        return ops.linear_estimate_fields_packed_sharded(
            q[0], c[0], qmap=qmap, cmap=cmap, mesh=mesh, axis=axis)

    def merge_rows(self, a, b):
        """Exact by linearity, ``S(x + y) = S(x) + S(y)``: the row-aligned
        tables add (bit for bit associative on integer-valued data)."""
        return (torch.as_tensor(a[0]) + torch.as_tensor(b[0]),)


@dataclasses.dataclass(frozen=True)
class CSFamily(_LinearFamily):
    """CountSketch serving family (median of ``reps`` repetitions)."""

    width: int
    reps: int = REPS
    seed: int = 0
    name: str = dataclasses.field(default="cs", init=False)

    def host_oracle(self) -> CountSketchU32:
        return CountSketchU32(width=self.width, seed=self.seed,
                              reps=self.reps)


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

    def host_oracle(self) -> JLU32:
        return JLU32(m=self.m, seed=self.seed)


class _SamplingFamily:
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

    def estimate_fields_sharded(self, q, c, *, qmap, cmap, mesh, axis):
        return ops.sample_estimate_fields_sharded(
            q[0], q[1], q[2], c[0], c[1], c[2], qmap=qmap, cmap=cmap,
            mesh=mesh, axis=axis)

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

    def estimate_fields_packed_sharded(self, q, c, *, qmap, cmap, mesh,
                                       axis):
        return ops.sample_estimate_fields_packed_sharded(
            q[0], q[1], q[2], c[0], c[1], c[2], qmap=qmap, cmap=cmap,
            mesh=mesh, axis=axis)

    def _merge_keep(self, live, h, vals, ta, tb):
        raise NotImplementedError

    def merge_rows(self, a, b):
        """Union re-subsampling of row-aligned ``(key, val, tau)`` rows
        that sample disjoint partitions of the same vectors: the kept
        slots are pooled, the scheme's threshold recomputed (TS: taus add;
        PS: ``min(T_a, T_b, T_cand)``), the coordinated hash re-decides
        every pooled slot, and the survivors repack ascending by key.  On
        the host in float64, decision for decision the builders of
        :mod:`repro_torch.core.sampling`; the rows go back to ``a``'s
        device."""
        dev = a[0].device if isinstance(a[0], torch.Tensor) else "cpu"
        ka, va, ta = (_to_numpy(x) for x in a)
        kb, vb, tb = (_to_numpy(x) for x in b)
        S = self.slots
        keys = np.concatenate([ka, kb], axis=-1).astype(np.int64)
        vals = np.concatenate([va, vb], axis=-1).astype(np.float64)
        live = keys >= 0                       # slot pads are negative
        vals = np.where(live, vals, 0.0)
        lane = np.arange(2 * S, dtype=np.int64)
        big = np.int64(1) << 33                # above any 31-bit key
        srt = np.sort(np.where(live, keys, big + lane), axis=-1)
        if np.any((srt[..., 1:] == srt[..., :-1]) & (srt[..., 1:] < big)):
            raise ValueError("union-merge requires disjoint supports "
                             "(shared keys found in both rows)")
        salt = u32.salt_for(self.seed, SAMPLE_STREAM_HASH,
                            np.zeros(1, np.uint32))
        h = u32.uniform01(keys.astype(np.uint64).astype(np.uint32),
                          salt).astype(np.float64)
        keep, tau_c = self._merge_keep(live, h, vals, ta.astype(np.float64),
                                       tb.astype(np.float64))
        order = np.argsort(np.where(keep, keys, big + lane), axis=-1,
                           kind="stable")
        k_s = np.take_along_axis(keys, order, -1)[..., :S]
        v_s = np.take_along_axis(vals, order, -1)[..., :S]
        kept = np.take_along_axis(keep, order, -1)[..., :S]
        return tuple(torch.from_numpy(x).to(dev) for x in (
            np.where(kept, k_s, -1).astype(np.int32),
            np.where(kept, v_s, 0.0).astype(np.float32),
            tau_c.astype(np.float32)))


@dataclasses.dataclass(frozen=True)
class TSFamily(_SamplingFamily):
    """Threshold-sampling serving family."""

    slots: int
    seed: int = 0
    name: str = dataclasses.field(default="ts", init=False)

    def _merge_keep(self, live, h, vals, ta, tb):
        # disjoint-support norms add, so the merged tau is the sum and p_c
        # = min(1, S v^2 / tau_c) only shrinks: the same coordinated coin
        # on the pooled slots gives the build-once sample (modulo a
        # shard's overflow truncation)
        S = self.slots
        tau_c = ta + tb
        denom = np.where(tau_c > 0, tau_c, 1.0)[..., None]
        p = np.where(tau_c[..., None] > 0,
                     np.minimum(1.0, S * vals * vals / denom), 1.0)
        p = np.where(live, p, 0.0)
        keep = h < p
        over = keep.sum(axis=-1) > S
        if np.any(over):
            rank = np.where(keep, h / np.where(p > 0, p, 1.0), np.inf)
            pos = np.argsort(np.argsort(rank, axis=-1, kind="stable"),
                             axis=-1)
            keep = keep & (~over[..., None] | (pos < S))
        return keep, tau_c

    def host_oracle(self) -> ThresholdSamplingU32:
        return ThresholdSamplingU32(slots=self.slots, seed=self.seed)


@dataclasses.dataclass(frozen=True)
class PSFamily(_SamplingFamily):
    """Priority-sampling serving family."""

    slots: int
    seed: int = 0
    name: str = dataclasses.field(default="ps", init=False)

    def _merge_keep(self, live, h, vals, ta, tb):
        # T = S / tau is each side's threshold rank (infinite when the
        # support fit); the union's is min(T_a, T_b, T_cand), T_cand the
        # (S+1)-th smallest pooled rank: exactly the build-once sample
        S = self.slots
        t_a = np.where(ta > 0, S / np.where(ta > 0, ta, 1.0), np.inf)
        t_b = np.where(tb > 0, S / np.where(tb > 0, tb, 1.0), np.inf)
        sq = np.where(live, vals * vals, 1.0)
        rank = np.where(live, h / sq, np.inf)
        t_cand = np.sort(rank, axis=-1)[..., S]
        t_c = np.minimum(np.minimum(t_a, t_b), t_cand)
        keep = rank < t_c[..., None]
        tau_c = np.where(np.isinf(t_c), 0.0,
                         S / np.where(np.isinf(t_c), 1.0, t_c))
        return keep, tau_c

    def host_oracle(self) -> PrioritySamplingU32:
        return PrioritySamplingU32(slots=self.slots, seed=self.seed)


def make_family(name: str, *, storage: float, seed: int = 0):
    """The serving family sized to a storage budget by
    :mod:`repro_torch.core.registry` (icws and dmh ``m = (storage - 1) /
    1.5``; cs ``width = storage // reps`` with five reps; jl ``m =
    storage``; ts and ps ``slots = storage - 1``).  Families built from one
    budget are storage-matched."""
    if name in ("icws", "dmh"):
        cls = ICWSFamily if name == "icws" else DMHFamily
        return cls(m=registry.make(name, storage).m, seed=seed)
    if name == "cs":
        host = registry.make_cs(storage)
        return CSFamily(width=host.width, reps=host.reps, seed=seed)
    if name == "jl":
        return JLFamily(m=registry.make_jl(storage).m, seed=seed)
    if name in ("ts", "ps"):
        cls = TSFamily if name == "ts" else PSFamily
        return cls(slots=registry.make(name, storage).slots, seed=seed)
    raise ValueError(f"unknown sketch family {name!r}; choose from "
                     f"{FAMILY_NAMES}")


def wmh_storage(m: int) -> float:
    """The storage budget an m-sample ICWS sketch occupies: the anchor the
    index sizes its family from."""
    return ICWSFamily(m=m).storage_doubles_per_row()
