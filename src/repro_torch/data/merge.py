"""Mergeable corpora: shard-and-merge lake builds (port of
``repro.data.merge``).

A lake arrives partitioned (per machine, per day, per source), so the
corpus layer merges sketches of disjoint partitions:

  * :func:`split_by_key` and :func:`partition_by_key` split a sparse
    vector by ``mix32(key) % shards`` of its 31-bit folded key, so a folded
    key lands wholly in one shard -- what the sampling merges require.
  * :func:`merge_stores` combines two row-aligned
    :class:`~repro_torch.data.store.CorpusStore` arenas through the
    family's ``merge_rows``: CS and JL exact (tables add), ICWS and DMH a
    coordinated per-slot re-scoring (approximate against a build-once
    sketch), TS and PS union re-subsampling (PS exactly build-once, TS up
    to a shard's rare overflow truncation).
  * :func:`build_sharded` partitions every input vector, sketches each
    shard with one ``sketch_rows`` launch a field, and compacts the shard
    stores through a pairwise merge tree.

Tenancy survives merging: the inputs must carry identical per-tenant row
ranges, which the merged store inherits.  With observability on, a build
is a ``merge.build_sharded`` span over one ``merge.sketch_shard`` span a
shard, and each merge a ``merge.merge_stores`` span counted in
``merge.merges_total``, as in the JAX package.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs as _obs
from repro_torch.core import u32
from repro_torch.core.sampling import SAMPLE_KEY_MASK
from repro_torch.core.types import SparseVec

from .store import CorpusStore


def _shard_ids(v: SparseVec, shards: int) -> np.ndarray:
    keys = (np.asarray(v.indices, np.int64)
            & np.int64(SAMPLE_KEY_MASK)).astype(np.uint32)
    return u32.mix32(keys) % np.uint32(shards)


def split_by_key(v: SparseVec, shards: int, shard: int) -> SparseVec:
    """The ``shard``-th of ``shards`` disjoint key partitions of ``v``: a
    coordinate goes to shard ``mix32(key) % shards`` of its 31-bit folded
    key, so raw indices that fold to one key share a shard."""
    shards = int(shards)
    if shards < 1:
        raise ValueError("shards must be >= 1")
    if not 0 <= int(shard) < shards:
        raise ValueError(f"shard {shard} out of range for {shards} shards")
    if shards == 1:
        return v
    keep = _shard_ids(v, shards) == np.uint32(shard)
    return SparseVec(indices=v.indices[keep], values=v.values[keep], n=v.n)


def partition_by_key(v: SparseVec, shards: int) -> Tuple[SparseVec, ...]:
    """All ``shards`` partitions of ``v`` in one hash pass: element ``s``
    equals ``split_by_key(v, shards, s)``."""
    shards = int(shards)
    if shards < 1:
        raise ValueError("shards must be >= 1")
    if shards == 1:
        return (v,)
    sid = _shard_ids(v, shards)
    return tuple(
        SparseVec(indices=v.indices[sid == s], values=v.values[sid == s],
                  n=v.n)
        for s in range(shards))


def merge_stores(a: CorpusStore, b: CorpusStore) -> CorpusStore:
    """Merge two row-aligned stores whose row i sketch disjoint key
    partitions of one vector; row i of the result sketches their union.

    Both stores must be unpacked and share the family, seed included (the
    merges re-decide winners on the coordinated hash streams), the field
    count, the row count and the per-tenant row ranges, which the result
    inherits.  Returns a fresh store on ``a``'s device and mesh.
    """
    if a.packed or b.packed:
        raise ValueError(
            "cannot merge packed stores: the packed layout is frozen (ICWS "
            "drops the argkeys sidecar and values are bf16-truncated) -- "
            "merge unpacked stores, then pack the result")
    if a.family != b.family:
        raise ValueError(
            "cannot merge stores of different families or seeds: "
            f"{a.family!r} vs {b.family!r} -- coordinated merges need "
            "identical family parameters, seed included")
    if a.fields != b.fields:
        raise ValueError(f"field count mismatch: {a.fields} vs {b.fields}")
    if len(a) != len(b):
        raise ValueError(
            f"stores must be row-aligned: {len(a)} vs {len(b)} rows")
    tenants_a = {t: a.tenant_ranges(t) for t in a.tenants()}
    tenants_b = {t: b.tenant_ranges(t) for t in b.tenants()}
    if tenants_a != tenants_b:
        raise ValueError(
            "tenant row-range tables differ; merge inputs must assign "
            f"identical rows to identical tenants ({tenants_a} vs "
            f"{tenants_b})")
    with _obs.span("merge.merge_stores", family=a.family.name,
                   rows=len(a), fields=a.fields):
        merged = a.family.merge_rows(a.field_arrays(), b.field_arrays())
        out = CorpusStore(family=a.family, fields=a.fields, mesh=a.mesh,
                          device=a.device)
        out.append(*merged)
    if _obs.enabled():
        _obs.counter("merge.merges_total", family=a.family.name).inc()
    for t, ranges in tenants_a.items():
        out._tenant_ranges[t] = [tuple(r) for r in ranges]
    return out


def _field_rows(rows) -> "list[tuple]":
    """``rows`` as a list of per-row field tuples."""
    rows = list(rows)
    if rows and isinstance(rows[0], SparseVec):
        return [(r,) for r in rows]
    return [tuple(r) for r in rows]


def build_sharded(rows: Sequence, *, family, shards: int, mesh=None,
                  device="cuda") -> CorpusStore:
    """A store of ``rows`` built through ``shards`` partitions.

    ``rows`` is a sequence of :class:`SparseVec` (one field) or of per-row
    field tuples.  Each row is key-partitioned across the shards in one
    pass, each shard sketched with one ``family.sketch_rows`` call a field
    (the part a parallel build distributes), and the shard stores merge
    pairwise, ``(0, 1), (2, 3), ...``, until one is left, on ``device``
    (its rows split over ``mesh``'s corpus axis, if it has one).  With
    ``shards=1`` this is the single-stream build.
    """
    shards = int(shards)
    if shards < 1:
        raise ValueError("shards must be >= 1")
    field_rows = _field_rows(rows)
    if not field_rows:
        raise ValueError("build_sharded needs at least one row")
    F = len(field_rows[0])
    with _obs.span("merge.build_sharded", family=family.name, shards=shards,
                   rows=len(field_rows)):
        parted = [tuple(partition_by_key(v, shards) for v in fr)
                  for fr in field_rows]
        stores = []
        for s in range(shards):
            with _obs.span("merge.sketch_shard", family=family.name,
                           shard=s):
                per_field = [family.sketch_rows([pr[f][s] for pr in parted],
                                                device=device)
                             for f in range(F)]
                store = CorpusStore(family=family, fields=F, mesh=mesh,
                                    device=device)
                store.append(*(torch.stack([comps[i] for comps in per_field])
                               for i in range(len(family.components))))
            stores.append(store)
        while len(stores) > 1:
            merged = [merge_stores(stores[i], stores[i + 1])
                      for i in range(0, len(stores) - 1, 2)]
            if len(stores) % 2:
                merged.append(stores[-1])
            stores = merged
    return stores[0]
