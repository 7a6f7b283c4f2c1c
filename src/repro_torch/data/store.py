"""Field-stacked sketch store with amortized in-place append (port of
``repro.data.store.CorpusStore``).

All F field corpora of an index (F = 3 for the §1.3 fields) live in one
set of preallocated per-component buffers ``[F, capacity, *trailing]``,
one per component the sketch family declares: for ICWS and DMH,
fingerprints ``[F, cap, m]`` i32, values ``[F, cap, m]`` f32, norms
``[F, cap]`` f32 and argkeys ``[F, cap, m]`` i32; for CountSketch and JL,
one table buffer ``[F, cap, R, W]`` f32; for TS and PS, sample keys
``[F, cap, S]`` i32, values ``[F, cap, S]`` f32 and taus ``[F, cap]`` f32.  ``append`` writes the new rows into the buffers in
place (the JAX store donates its buffers to get the same effect), so an
append costs O(rows appended); when the corpus outgrows its capacity the
buffers double, so the total copy work over any append sequence is
O(final size).

Unused capacity rows hold the family's fills -- for ICWS and DMH the
corpus pad sentinel ``-2`` (never equal to a query fingerprint) and zero
norms, for the linear families zero tables, for TS and PS pad keys ``-2``
with zero values and taus (probability 0 on every slot) -- and are inert
under the estimate launch, so queries run on the full-capacity buffers and slice the
*estimates* to the live row count.

``packed=True`` keeps the family's packed layout resident
(``family.packed_components``: f32 values as bf16-halfword pairs in i32
words, ICWS argkeys dropped): ``append`` still takes unpacked rows,
validates them against the unpacked contract and packs them with
``family.pack_rows`` before the write; the estimate launches decode the
words inside the kernel, so the f32 values never exist on the device.
``append_packed`` writes rows already in the packed layout as they are.

Multi-tenant arena: ``append(..., tenant=...)`` records the written row
range per tenant, so many logical corpora share one set of buffers while
queries address one tenant's rows (by slicing a contiguous tenant, or by
gathering a fragmented one's estimate columns).

Row sharding: with a ``mesh`` whose corpus axis
(``distributed.sharding.corpus_axis``) spans d > 1 devices, each
component is held as d per-shard tensors ``[F, cap / d, *trailing]``,
shard ``s`` on the axis's ``s``-th device with global rows ``[s cap / d,
(s + 1) cap / d)``.  Every capacity is a multiple of ``row_multiple`` (by
default d, which must divide it), so the rows split evenly; a growth
re-splits them at the new boundaries.  ``shard_buffers()`` hands the
query path the per-shard tensors; ``buffers()``, ``arrays()`` and
``slice_rows()`` gather rows onto ``device`` for callers off that path.

With observability on, each write is a ``store.append`` span and updates
``store.appends_total``, ``store.rows`` and ``store.resident_bytes``
(capacity x fields x bytes a row); each growth is a ``store.grow`` span
and counts in ``store.grows_total``, as in the JAX store.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch import obs as _obs
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import corpus_axis, gather_rows

from .families import ICWSFamily

_ELEMENT_BYTES = {torch.int32: 4, torch.float32: 4}


class CorpusStore:
    """Growable field-stacked device store of one family's sketch rows.

    Args: ``m`` (an ICWS sample count) or ``family`` (any serving family),
    ``fields`` (F), ``min_capacity``, ``mesh`` and ``row_multiple`` (row
    sharding, see the module docstring), ``packed`` (the resident layout),
    and ``device`` (default ``"cuda"``; raises if no card is present), where
    gathered rows and an unsharded store's buffers live.
    ``self.m`` is the family's sample count where it has one (ICWS, DMH,
    JL) and None otherwise (CountSketch; TS and PS, which count
    ``slots``).
    """

    def __init__(self, m: "int | None" = None, fields: int = 1,
                 min_capacity: int = 64, mesh=None, row_multiple: int = 0,
                 family=None, packed: bool = False, device="cuda"):
        if family is None:
            if m is None:
                raise ValueError("provide a family or an ICWS sample count m")
            family = ICWSFamily(m=int(m))
        elif m is not None:
            raise ValueError("m and family are mutually exclusive: the "
                             "family defines its own sketch size")
        if fields < 1:
            raise ValueError("fields must be >= 1")
        if min_capacity < 1:
            raise ValueError("min_capacity must be >= 1")
        self.family = family
        self.device = resolve_device(device)
        self.packed = bool(packed)
        # append validates against the unpacked rows; the buffers hold the
        # packed layout when packed=True
        self._row_specs = tuple(family.components)
        self._specs = (tuple(family.packed_components) if self.packed
                       else self._row_specs)
        self.m = getattr(family, "m", None)
        self.fields = int(fields)
        self.mesh = mesh
        self.corpus_axis = corpus_axis(mesh)
        self._devices = (mesh.axis_devices(self.corpus_axis)
                         if self.corpus_axis is not None else (self.device,))
        if row_multiple < 1:
            row_multiple = len(self._devices)
        if row_multiple % len(self._devices):
            raise ValueError(f"row_multiple {row_multiple} does not split "
                             f"over {len(self._devices)} shards")
        self.row_multiple = int(row_multiple)
        self.min_capacity = (-(-int(min_capacity) // self.row_multiple)
                             * self.row_multiple)
        # per component, the per-shard buffers (one shard when unsharded)
        self._parts: "Tuple[Tuple[torch.Tensor, ...], ...] | None" = None
        self._size = 0
        self._cap = 0
        # tenant id -> ordered [start, stop) row ranges, coalesced when
        # consecutive appends land back to back
        self._tenant_ranges: Dict[str, List[Tuple[int, int]]] = {}

    def __len__(self) -> int:
        return self._size

    @property
    def size(self) -> int:
        """Live rows per field."""
        return self._size

    @property
    def capacity(self) -> int:
        """Allocated rows per field (size <= capacity < 2 * max(size, min))."""
        return self._cap

    # -- ingestion -----------------------------------------------------------
    def append(self, *rows, tenant: "str | None" = None) -> None:
        """Append sketch rows, one tensor (or array) per component, each
        ``[F, b, *trailing]`` (the F axis may be omitted when ``fields ==
        1``).  Rows are validated against each other before any write, and
        packed first when the store is packed.  The write goes into the
        existing buffers in place."""
        rows = self._validate(rows, self._row_specs)
        if self.packed:
            rows = self._validate(self.family.pack_rows(tuple(rows)),
                                  self._specs)
        self._write(rows, tenant)

    def append_packed(self, *rows, tenant: "str | None" = None) -> None:
        """Append rows already in the packed layout (one tensor per
        ``family.packed_components``), written as they are."""
        if not self.packed:
            raise ValueError("append_packed needs a packed store")
        self._write(self._validate(rows, self._specs), tenant)

    def _validate(self, rows, specs) -> List[torch.Tensor]:
        if len(rows) != len(specs):
            raise ValueError(
                f"{self.family.name} rows have {len(specs)} "
                f"components ({', '.join(s.name for s in specs)}); "
                f"got {len(rows)}")
        rows = [torch.as_tensor(r).to(device=self.device, dtype=s.dtype)
                for r, s in zip(rows, specs)]
        if self.fields == 1:
            rows = [r[None] if r.dim() == 1 + len(s.trailing) else r
                    for r, s in zip(rows, specs)]
        lead = specs[0]
        if (rows[0].dim() != 2 + len(lead.trailing)
                or rows[0].shape[0] != self.fields
                or tuple(rows[0].shape[2:]) != lead.trailing):
            raise ValueError(
                f"{lead.name} rows must be [{self.fields}, b, "
                f"{', '.join(map(str, lead.trailing))}]; "
                f"got {tuple(rows[0].shape)}")
        b = int(rows[0].shape[1])
        for r, s in zip(rows[1:], specs[1:]):
            if tuple(r.shape) != (self.fields, b) + s.trailing:
                raise ValueError(
                    f"{s.name} rows {tuple(r.shape)} do not match "
                    f"{lead.name} rows {(self.fields, b) + s.trailing}")
        return rows

    def _write(self, rows, tenant) -> None:
        b = int(rows[0].shape[1])
        if b == 0:
            return
        with _obs.span("store.append", family=self.family.name, rows=b,
                       tenant=tenant):
            self._reserve(self._size + b)
            for parts, r in zip(self._parts, rows):
                _put(parts, r, self._size)
        if tenant is not None:
            ranges = self._tenant_ranges.setdefault(str(tenant), [])
            if ranges and ranges[-1][1] == self._size:
                ranges[-1] = (ranges[-1][0], self._size + b)
            else:
                ranges.append((self._size, self._size + b))
        self._size += b
        if _obs.enabled():
            fam = self.family.name
            _obs.counter("store.appends_total", family=fam).inc()
            _obs.gauge("store.rows", family=fam).set(self._size)
            _obs.gauge("store.resident_bytes", family=fam).set(
                self._cap * self.fields * self.bytes_per_row())

    def _reserve(self, n: int) -> None:
        if n <= self._cap:
            return
        cap = max(self._cap, self.min_capacity)
        while cap < n:
            cap *= 2
        d = len(self._devices)
        new = tuple(tuple(torch.full((self.fields, cap // d) + s.trailing,
                                     s.fill, dtype=s.dtype, device=dev)
                          for dev in self._devices)
                    for s in self._specs)
        if self._parts is not None:
            # a growth, not the first allocation: the live rows move to
            # the new shard boundaries
            with _obs.span("store.grow", family=self.family.name,
                           capacity=cap):
                for dst, src in zip(new, self._parts):
                    _put(dst, self._rows(src, 0, self._size), 0)
            if _obs.enabled():
                _obs.counter("store.grows_total",
                             family=self.family.name).inc()
        self._parts = new
        self._cap = cap

    # -- tenancy -------------------------------------------------------------
    def tenants(self) -> Tuple[str, ...]:
        """Tenant ids in first-append order."""
        return tuple(self._tenant_ranges)

    def tenant_ranges(self, tenant: str) -> Tuple[Tuple[int, int], ...]:
        """The tenant's ordered, coalesced ``[start, stop)`` row ranges."""
        try:
            return tuple(self._tenant_ranges[str(tenant)])
        except KeyError:
            raise KeyError(f"unknown tenant {tenant!r}; "
                           f"have {list(self._tenant_ranges)}") from None

    def tenant_rows(self, tenant: str) -> np.ndarray:
        """Global row indices of the tenant's rows, ascending."""
        return np.concatenate(
            [np.arange(a, b, dtype=np.int64)
             for a, b in self.tenant_ranges(tenant)] or
            [np.zeros(0, np.int64)])

    def tenant_size(self, tenant: str) -> int:
        return int(sum(b - a for a, b in self.tenant_ranges(tenant)))

    def describe_tenants(self) -> Dict[str, Dict[str, float]]:
        """Per-tenant rows, row ranges and storage-doubles share."""
        per_row = self.fields * self.family.storage_doubles_per_row()
        return {
            t: {"rows": float(self.tenant_size(t)),
                "ranges": float(len(self.tenant_ranges(t))),
                "storage_doubles": float(self.tenant_size(t) * per_row)}
            for t in self._tenant_ranges}

    # -- views ---------------------------------------------------------------
    def _rows(self, parts, lo: int, hi: int) -> torch.Tensor:
        """Global rows ``[lo, hi)`` of one component on ``device``: a view
        when the store has one shard, else the shards' pieces gathered."""
        if len(parts) == 1:
            return parts[0][:, lo:hi]
        per = self._cap // len(parts)
        return gather_rows([p[:, max(lo - s * per, 0):hi - s * per]
                            for s, p in enumerate(parts)
                            if s * per < hi and lo < (s + 1) * per],
                           self.device)

    def _checked(self):
        if self._size == 0:
            raise ValueError("empty corpus")
        return self._parts

    def shard_buffers(self) -> Tuple[Tuple[torch.Tensor, ...], ...]:
        """Per component, the per-shard full-capacity buffers on their
        mesh devices (one shard when unsharded): what the sharded query
        path launches on, without a gather."""
        return self._checked()

    def slice_rows(self, lo: int, hi: int) -> Tuple[torch.Tensor, ...]:
        """Rows ``[lo, hi)`` of every component, ``[F, hi - lo, ...]`` on
        ``device`` (views when unsharded): a contiguous tenant's corpus."""
        return tuple(self._rows(p, lo, hi) for p in self._checked())

    def buffers(self) -> Tuple[torch.Tensor, ...]:
        """The full-capacity device buffers, one per component of the
        family: ICWS/DMH ``(fp [F, cap, m], val [F, cap, m], norm [F,
        cap], argkey [F, cap, m])``, CS/JL ``(tables [F, cap, R, W],)``,
        TS/PS ``(keys [F, cap, S], values [F, cap, S], taus [F, cap])``; a
        packed store holds ``family.packed_components`` instead.

        Unused rows are inert under the estimate launch; callers slice the
        estimates, never the corpus.  A growth replaces the buffers, so
        re-fetch them after every append.  A sharded store gathers its
        shards onto ``device`` (a copy).
        """
        return self.slice_rows(0, self._cap)

    def arrays(self) -> Tuple[torch.Tensor, ...]:
        """Exact-size ``[F, P, *trailing]`` component slices (the leading F
        axis is dropped when ``fields == 1``): views of the buffers, for
        host cross-checks and tests; query paths use :meth:`buffers`."""
        out = self.slice_rows(0, self._size)
        if self.fields == 1:
            return tuple(o[0] for o in out)
        return out

    def field_arrays(self) -> Tuple[torch.Tensor, ...]:
        """Exact-size component slices, always ``[F, P, *trailing]`` (no
        ``fields == 1`` drop): the layout the merge layer and the
        families' ``merge_rows`` take."""
        return self.slice_rows(0, self._size)

    def bytes_per_row(self) -> int:
        """Resident device bytes per stored row (one field)."""
        return int(sum(_ELEMENT_BYTES[s.dtype]
                       * int(np.prod(s.trailing, dtype=np.int64))
                       for s in self._specs))

    def storage_doubles(self) -> float:
        """Paper accounting: the family's doubles per row, times rows and
        fields."""
        return self._size * self.fields * self.family.storage_doubles_per_row()


def _put(parts, rows: torch.Tensor, lo: int) -> None:
    """Copy ``rows`` ``[F, b, ...]`` into per-shard buffers at global row
    ``lo``, each shard taking the piece inside its row range."""
    per = parts[0].shape[1]
    hi = lo + rows.shape[1]
    for s, buf in enumerate(parts):
        a, z = max(lo, s * per), min(hi, (s + 1) * per)
        if a < z:
            buf[:, a - s * per:z - s * per].copy_(rows[:, a - lo:z - lo])
