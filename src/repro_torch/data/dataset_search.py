"""Dataset search, the paper's motivating application (§1.3), on PyTorch.

Port of ``repro.data.dataset_search.DatasetSearchIndex``.  Tables are
(key column, value column) pairs; per table the index sketches three
field vectors -- key multiplicities ``x^{1[K]}``,
values summed at their key ``x^V``, and squared values ``x^{V^2}`` -- into
one field-stacked :class:`~repro_torch.data.store.CorpusStore` on the
device, and keeps a KMV keyed sample of the values on the host.

The sketch family is any of the JAX package's six -- ICWS (the paper's
method, the default), DMH, CountSketch, JL, TS or PS -- each sized to the
storage an ``m``-sample ICWS sketch occupies.  Every query, single or
batched, builds its 3Q field rows with one call of the family's
``sketch_rows`` (one sketch launch for ICWS, DMH, CS and JL; host-built
sample rows for TS and PS) and runs ONE fused multi-field estimate launch
straight off the store buffers (a single query is the Q = 1 case).
``packed=True`` keeps the store in the family's packed layout and routes
the launch to ``family.estimate_fields_packed``; its rankings equal an
unpacked index over the bf16-roundtripped rows bit for bit.  The index
itself has no family-specific branch.  ``_corr_scores`` and
``_top_k`` rank the tables on the device; the host then refines the k
survivors' correlation from the matched KMV samples.  Per-query results of
``query_batch`` equal a loop of ``query`` bit for bit.  The device paths
of ingest and query run in ``obs.family_context(family)``, so that with
observability on each ``ops`` launch counts under its family.

``add_tables_sharded`` builds a batch of tables through a shard-and-merge
lake build (:func:`repro_torch.data.merge.build_sharded`) before one
append.  The host oracle (``backend="host"``, the ICWS family only) is the
paper's numpy WeightedMinHash (:class:`repro_torch.core.WeightedMinHash`):
with ``keep_host_oracle=True``, the default as in the JAX package, an ICWS
index also keeps three host sketches a table and answers
``backend="host"`` queries from them; a ``backend="host"`` index keeps no
device store.

Sharded serving: with a ``mesh`` whose corpus axis spans 2+ devices the
store's rows are split over it, the fused launch runs once a shard
(``family.estimate_fields_sharded``) and ``ops.sharded_top_k`` ranks, bit
for bit the single-device results.  A contiguous tenant gathers its row
range and runs the single-device launch; a fragmented one runs the
sharded launch and gathers its columns, as the JAX index does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs as _obs
from repro_torch.core import (KMV, KMVSketch, SparseVec, WeightedMinHash,
                              WMHSketch, stack_wmh)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.common import stable_top_k as _top_k

from .families import FAMILY_NAMES, make_family, wmh_storage
from .merge import build_sharded
from .store import CorpusStore

FIELDS = ("key_indicator", "values", "values_sq")

# Field-pair maps of the fused estimate launch, in _corr_scores argument
# order (join, sum_a, sum_b, sum_a2, sum_b2, prod): estimate g pairs query
# field QFIELD[g] with corpus field CFIELD[g].
_IND, _VAL, _SQ = 0, 1, 2
QFIELD = (_IND, _VAL, _IND, _SQ, _IND, _VAL)
CFIELD = (_IND, _IND, _VAL, _IND, _SQ, _VAL)


@dataclasses.dataclass
class TableSketch:
    name: str
    key_indicator: Optional[WMHSketch]  # host oracle sketches, None when
    values: Optional[WMHSketch]         # the index keeps none
    values_sq: Optional[WMHSketch]
    sample: KMVSketch            # KMV keyed sample of (key -> summed value)
    n_rows: int


@dataclasses.dataclass
class SearchResult:
    name: str
    join_size: float
    joinability: float           # join size / query rows
    sum_b: float
    mean_b: float
    corr: float


def _mul_sub(a, b, c, d) -> torch.Tensor:
    """``a * b - c * d`` in f32 as XLA compiles it: one fused multiply-add,
    ``fma(a, b, -(c * d))``, with ``a * b`` exact and ``c * d`` rounded.
    Emulated in f64, where the product of two f32 is exact."""
    return (a.double() * b.double() - (c * d).double()).float()


def _corr_scores(join, sum_a, sum_b, sum_a2, sum_b2, prod,
                 min_join: float) -> torch.Tensor:
    """Ranking scores: |sketch-estimated corr| among joinable rows, in f32.

    All inputs are [Q, P] estimates.  Rows failing ``join >= min_join``
    score -1 so the host can drop them.  The variances and the covariance
    round as the JAX package's jitted ``_corr_scores`` does
    (:func:`_mul_sub`), so a table whose variance cancels exactly gets the
    same sign of residue, and the same score, in both packages.
    """
    var_a = _mul_sub(join, sum_a2, sum_a, sum_a)
    var_b = _mul_sub(join, sum_b2, sum_b, sum_b)
    cov = _mul_sub(join, prod, sum_a, sum_b)
    ok = (var_a > 0) & (var_b > 0)
    corr = torch.where(ok, cov * torch.rsqrt(torch.where(ok, var_a * var_b,
                                                         1.0)), 0.0)
    corr = torch.clamp(corr, -1.0, 1.0)
    return torch.where(join >= min_join, corr.abs(), -1.0)


class DatasetSearchIndex:
    """Sketch once, query many times -- the data-lake discovery pattern.

    ``device`` defaults to ``"cuda"`` and raises when no card is present;
    pass ``device="cpu"`` for the plain PyTorch kernels.  ``mesh``: see
    the module docstring (queries are sketched on ``device``).
    """

    def __init__(self, m: int = 256, seed: int = 0, key_space: int = 2 ** 31,
                 backend: str = "device", keep_host_oracle: bool = True,
                 mesh=None, family: str = "icws", packed: bool = False,
                 device="cuda"):
        if backend not in ("device", "host"):
            raise ValueError(f"unknown backend {backend!r}")
        if family not in FAMILY_NAMES:
            raise ValueError(f"unknown sketch family {family!r}; choose "
                             f"from {FAMILY_NAMES}")
        if family != "icws" and backend == "host":
            raise ValueError(
                "backend='host' is the WMH/ICWS oracle path; the other "
                "families (cs, jl, ts, ps, dmh) serve on the device path "
                "only")
        self.device = resolve_device(device)
        self.m = m
        self.seed = seed
        self.key_space = key_space
        self.backend = backend
        self.packed = bool(packed)
        self.mesh = mesh
        # every family sized to the storage an m-sample ICWS sketch
        # occupies (icws: exactly m), so the comparison is storage-matched
        self.family = make_family(family, storage=wmh_storage(m), seed=seed)
        # only an ICWS index keeps the host oracle sketches (the other
        # families cannot serve the WMH host path), and only a device
        # index keeps the device store
        self.keep_host_oracle = ((keep_host_oracle or backend == "host")
                                 and family == "icws")
        self.sketcher = WeightedMinHash(m=m, seed=seed)
        self.kmv = KMV(k=m, seed=seed)
        self.tables: List[TableSketch] = []
        # tenant id -> global table positions, ascending (table i IS store
        # row i); the store keeps the same assignment as row ranges
        self._tenant_tables: Dict[str, List[int]] = {}
        self.store: Optional[CorpusStore] = (
            CorpusStore(family=self.family, fields=len(FIELDS), mesh=mesh,
                        packed=self.packed, device=self.device)
            if backend == "device" else None)
        self._corpus_axis = (self.store.corpus_axis
                             if self.store is not None else None)

    # -- ingestion ----------------------------------------------------------
    def vectorize(self, keys: np.ndarray, values: np.ndarray
                  ) -> Tuple[SparseVec, SparseVec, SparseVec]:
        """A table's three field vectors, keys folded into [0, key_space)
        first and repeated keys aggregated (multiplicity, summed values,
        summed squared values); zero values are nudged to 1e-9 so their key
        stays represented."""
        keys = np.asarray(keys, dtype=np.int64)
        values = np.asarray(values, dtype=np.float64)
        keys = keys % np.int64(self.key_space)
        safe = np.where(values == 0.0, 1e-9, values)
        ind = SparseVec.from_pairs(keys, np.ones_like(safe), self.key_space,
                                   sum_duplicates=True)
        sq = SparseVec.from_pairs(keys, safe ** 2, self.key_space,
                                  sum_duplicates=True)
        uniq, inverse = np.unique(keys, return_inverse=True)
        vsum = np.zeros(uniq.size, np.float64)
        np.add.at(vsum, inverse, safe)
        val = SparseVec.from_pairs(uniq, np.where(vsum == 0.0, 1e-9, vsum),
                                   self.key_space)
        return ind, val, sq

    def add_table(self, name: str, keys: np.ndarray, values: np.ndarray,
                  tenant: Optional[str] = None):
        """Sketch one table into the corpus (one ``sketch_rows`` call for
        its three field vectors, rows appended in place); ``tenant`` scopes
        it to a logical corpus inside the shared arena."""
        ind, val, sq = self.vectorize(keys, values)
        if self.store is not None:
            with _obs.family_context(self.family.name):
                comps = self.family.sketch_rows([ind, val, sq],
                                                device=self.device)
                self.store.append(*(c[:, None] for c in comps),
                                  tenant=tenant)
        self._register_table(name, len(keys), self.kmv.sketch(val),
                             self._host_sketches(ind, val, sq),
                             tenant=tenant)

    def add_tables_sharded(self, tables: Sequence[Tuple[str, np.ndarray,
                                                        np.ndarray]],
                           *, shards: int, tenant: Optional[str] = None):
        """Ingest many tables through a ``shards``-way lake build: every
        table's three field vectors are key-partitioned, each shard is
        sketched apart, and the shard stores merge pairwise
        (:func:`~repro_torch.data.merge.build_sharded`) before one append
        into this index's store.  The KMV samples and, when kept, the host
        oracle sketches are built single-stream.  Rankings match the
        single-stream build: bit for bit for CS on integer-valued data, to
        the final rounding for JL, and as top-k sets for ICWS, DMH, TS and
        PS on a separated lake."""
        if self.store is None:
            raise ValueError("sharded builds target the device corpus "
                             "(index constructed with backend='host')")
        tables = list(tables)
        if not tables:
            return
        rows = [self.vectorize(keys, values) for _, keys, values in tables]
        with _obs.family_context(self.family.name):
            merged = build_sharded(rows, family=self.family, shards=shards,
                                   device=self.device)
            self.store.append(*merged.field_arrays(), tenant=tenant)
        for (name, keys, _), (ind, val, sq) in zip(tables, rows):
            self._register_table(name, len(keys), self.kmv.sketch(val),
                                 self._host_sketches(ind, val, sq),
                                 tenant=tenant)

    def _host_sketches(self, ind: SparseVec, val: SparseVec, sq: SparseVec
                       ) -> Optional[Tuple[WMHSketch, ...]]:
        """The table's three host oracle sketches, when the index keeps
        them."""
        if not self.keep_host_oracle:
            return None
        return tuple(self.sketcher.sketch(v) for v in (ind, val, sq))

    def _register_table(self, name: str, n_rows: int, sample: KMVSketch,
                        host: Optional[Tuple[WMHSketch, ...]] = None,
                        tenant: Optional[str] = None):
        if tenant is not None:
            self._tenant_tables.setdefault(str(tenant), []).append(
                len(self.tables))
        self.tables.append(TableSketch(name, *(host or (None,) * 3),
                                       sample=sample, n_rows=n_rows))

    # -- tenancy -------------------------------------------------------------
    def tenants(self) -> Tuple[str, ...]:
        return tuple(self._tenant_tables)

    def _tenant_table_list(self, tenant: Optional[str]) -> List[TableSketch]:
        if tenant is None:
            return self.tables
        try:
            sel = self._tenant_tables[str(tenant)]
        except KeyError:
            raise KeyError(f"unknown tenant {tenant!r}; "
                           f"have {list(self._tenant_tables)}") from None
        return [self.tables[i] for i in sel]

    # -- queries ------------------------------------------------------------
    def query(self, keys: np.ndarray, values: np.ndarray,
              top_k: int = 10, min_join: float = 1.0,
              backend: Optional[str] = None,
              tenant: Optional[str] = None) -> List[SearchResult]:
        """Rank corpus tables by |corr| among sufficiently-joinable tables.

        ``tenant`` restricts the search to one logical corpus of the shared
        arena, bit for bit what a dedicated index over its tables returns.
        ``backend`` overrides the index's for this query.
        """
        if not self.tables:
            return []
        if (backend or self.backend) == "host":
            return self._query_host(keys, values, top_k, min_join,
                                    tenant=tenant)
        with _obs.family_context(self.family.name):
            return self._query_batch_device(
                [(np.asarray(keys), np.asarray(values))], top_k, min_join,
                tenant=tenant)[0]

    def query_batch(self, queries: Sequence[Tuple[np.ndarray, np.ndarray]],
                    top_k: int = 10, min_join: float = 1.0,
                    backend: Optional[str] = None,
                    tenant: Optional[str] = None) -> List[List[SearchResult]]:
        """Answer Q ``(keys, values)`` queries with ONE ``sketch_rows`` call
        for the 3Q field vectors and ONE fused estimate launch; per-query
        results equal ``[self.query(k, v) for k, v in queries]``.  The host
        backend loops the host oracle."""
        queries = list(queries)
        if not self.tables or not queries:
            return [[] for _ in queries]
        if (backend or self.backend) == "host":
            return [self._query_host(np.asarray(k), np.asarray(v), top_k,
                                     min_join, tenant=tenant)
                    for k, v in queries]
        with _obs.family_context(self.family.name):
            return self._query_batch_device(queries, top_k, min_join,
                                            tenant=tenant)

    def _assemble_results(self, scores, idx, join_h, sum_b_h, q_sample,
                          n_q: int, tables: List[TableSketch]
                          ) -> List[SearchResult]:
        """Host epilogue: drop min_join failures, refine corr from the
        matched KMV samples, re-rank the k survivors by refined |corr|."""
        results = []
        for score, i in zip(scores, idx):
            if score < 0:                    # failed the min_join filter
                continue
            t = tables[int(i)]
            js = max(float(join_h[i]), 0.0)
            mean_b = float(sum_b_h[i]) / js if js > 0 else 0.0
            corr = self._sample_corr(q_sample, t.sample)
            results.append(SearchResult(
                name=t.name, join_size=js, joinability=js / n_q,
                sum_b=float(sum_b_h[i]), mean_b=mean_b, corr=corr))
        results.sort(key=lambda r: abs(r.corr), reverse=True)
        return results

    def _query_batch_device(self, queries, top_k: int, min_join: float,
                            tenant: Optional[str] = None
                            ) -> List[List[SearchResult]]:
        if self.store is None:
            raise ValueError("device corpus was not built at ingest "
                             "(index constructed with backend='host')")
        Q = len(queries)
        field_vecs: List[SparseVec] = []
        samples: List[KMVSketch] = []
        for keys, values in queries:
            ind, val, sq = self.vectorize(keys, values)
            field_vecs.extend((ind, val, sq))
            samples.append(self.kmv.sketch(val))
        # one call sketches all 3Q query field vectors; each component
        # reshapes [3Q, ...] -> [3, Q, ...] for the fields launch
        qcomps = tuple(
            c.reshape((Q, 3) + tuple(c.shape[1:])).transpose(0, 1)
            for c in self.family.sketch_rows(field_vecs,
                                             device=self.device))
        tables = self.tables
        axis = self._corpus_axis
        if tenant is not None:
            ranges = self.store.tenant_ranges(tenant)
            tables = self._tenant_table_list(tenant)
            if len(ranges) == 1:
                # contiguous tenant: slice the arena before the launch, so
                # the cost scales with this tenant's rows
                est = self._estimate(qcomps, self.store.slice_rows(*ranges[0]))
            else:
                # fragmented tenant: full-arena launch, gather its columns
                est = self._estimate_arena(qcomps)
                rows = torch.from_numpy(self.store.tenant_rows(tenant))
                est = est[:, :, rows.to(est.device)]
            axis = None
        else:
            est = self._estimate_arena(qcomps)           # [6, Q, cap]
        P = len(tables)
        est = est[:, :, :P]
        k = min(top_k, P)
        score = _corr_scores(est[0], est[1], est[2], est[3], est[4], est[5],
                             float(min_join))
        scores, idx = (_top_k(score, k) if axis is None else
                       ops.sharded_top_k(score, k, mesh=self.mesh, axis=axis))
        scores, idx = scores.cpu().numpy(), idx.cpu().numpy()
        join_h, sum_b_h = est[0].cpu().numpy(), est[2].cpu().numpy()
        return [
            self._assemble_results(scores[qi], idx[qi], join_h[qi],
                                   sum_b_h[qi], samples[qi],
                                   n_q=max(len(queries[qi][0]), 1),
                                   tables=tables)
            for qi in range(Q)]

    def _estimate(self, qcomps, cbufs) -> torch.Tensor:
        """The fused fields launch, its packed twin over a packed store."""
        est = (self.family.estimate_fields_packed if self.packed
               else self.family.estimate_fields)
        return est(qcomps, cbufs, qmap=QFIELD, cmap=CFIELD)

    def _estimate_sharded(self, qcomps, cbufs) -> torch.Tensor:
        """:meth:`_estimate` once a shard of the corpus axis (a separate op,
        as in JAX, so ``ops.launches_total`` names JAX's ops)."""
        est = (self.family.estimate_fields_packed_sharded if self.packed
               else self.family.estimate_fields_sharded)
        return est(qcomps, cbufs, qmap=QFIELD, cmap=CFIELD, mesh=self.mesh,
                   axis=self._corpus_axis)

    def _estimate_arena(self, qcomps) -> torch.Tensor:
        """The whole arena's estimates ``[6, Q, cap]``, sharded or not."""
        if self._corpus_axis is None:
            return self._estimate(qcomps, self.store.buffers())
        return self._estimate_sharded(qcomps, self.store.shard_buffers())

    # -- host oracle ---------------------------------------------------------
    def _query_host(self, keys, values, top_k: int, min_join: float,
                    tenant: Optional[str] = None) -> List[SearchResult]:
        """The WeightedMinHash oracle: join size and SUM from host sketch
        estimates, corr from the shared KMV refinement."""
        if self.family.name != "icws":
            raise ValueError(
                "backend='host' is the WMH/ICWS oracle path; this index "
                f"serves the {self.family.name!r} family on the device path "
                "only")
        if not self.keep_host_oracle or self.tables[0].key_indicator is None:
            raise ValueError("host oracle sketches were not kept at ingest "
                             "(keep_host_oracle=False)")
        ind, val, _ = self.vectorize(keys, values)
        q_ind = self.sketcher.sketch(ind)
        q_sample = self.kmv.sketch(val)
        tables = self._tenant_table_list(tenant)
        P = len(tables)

        def est(field: str) -> np.ndarray:
            return self.sketcher.estimate_batch(
                stack_wmh([q_ind] * P),
                stack_wmh([getattr(t, field) for t in tables]))

        join = est("key_indicator")                     # <1A, 1B>
        sum_b = est("values")                           # <1A, VB>
        results = []
        for i, t in enumerate(tables):
            js = max(join[i], 0.0)
            if js < min_join:
                continue
            mean_b = sum_b[i] / js if js > 0 else 0.0
            results.append(SearchResult(
                name=t.name, join_size=float(js),
                joinability=float(js / max(len(keys), 1)),
                sum_b=float(sum_b[i]), mean_b=float(mean_b),
                corr=self._sample_corr(q_sample, t.sample)))
        results.sort(key=lambda r: abs(r.corr), reverse=True)
        return results[:top_k]

    def _sample_corr(self, sa: KMVSketch, sb: KMVSketch,
                     min_pairs: int = 8) -> float:
        """Sample Pearson correlation over the join from matched KMV
        samples (Santos et al. 2021 correlation sketches)."""
        if sa.hashes.size == 0 or sb.hashes.size == 0:
            return 0.0
        union_h = np.union1d(sa.hashes, sb.hashes)
        kk = min(self.kmv.k, union_h.size)
        tau = union_h[kk - 1]
        common, ia, ib = np.intersect1d(sa.hashes, sb.hashes,
                                        return_indices=True)
        keep = common <= tau
        va, vb = sa.values[ia[keep]], sb.values[ib[keep]]
        if va.size < min_pairs or va.std() == 0 or vb.std() == 0:
            return 0.0
        return float(np.clip(np.corrcoef(va, vb)[0, 1], -1.0, 1.0))

    def storage_doubles(self) -> float:
        """Serving-sketch storage (three fields per table, paper
        accounting); a host-only index counts its oracle sketches."""
        if self.store is not None:
            return self.store.storage_doubles()
        return (len(self.tables) * len(FIELDS)
                * self.family.storage_doubles_per_row())
