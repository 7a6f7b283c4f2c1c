"""Device-resident ICWS sketch corpus: sketch once, query many times (port
of ``repro.data.corpus.SketchCorpus``).

The paper's §1.3 regime sketches every column of a data lake once, then
estimates each query sketch against the whole corpus.  Ingest pads sparse
vectors into ``[B, N]`` batches and sketches them with one ICWS launch per
batch (``ingest.sketch_batch``); the rows live in a single-field
:class:`~repro_torch.data.store.CorpusStore` (preallocated, appended in
place, capacity doubling, every component validated at ingest); queries
run the one-vs-many (B3) and many-vs-many (B4) estimate kernels on the
store's buffers, whose unused rows are inert.  Host sketches from
:class:`repro_torch.core.ICWS` share the kernel's fingerprint contract, so
a corpus may be filled from either path.  With a ``mesh`` whose corpus
axis spans 2+ devices the store's rows are sharded over it and
``estimate_batch`` runs ``ops.icws_estimate_many_sharded``, bit for bit
the single-device launch.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.core.types import SparseVec
from repro_torch.kernels import ops

from .ingest import sketch_batch
from .store import CorpusStore


class SketchCorpus:
    """A growing corpus of ICWS sketches resident on one device.

    A single-field view over :class:`CorpusStore`: appends write into the
    store's buffers in place, queries launch the estimate kernels on them.
    ``device`` defaults to the card and raises when there is none; pass
    ``"cpu"`` for the plain PyTorch versions.  ``mesh``: see the module
    docstring.
    """

    def __init__(self, m: int, seed: int = 0, bucket: int = 256, mesh=None,
                 device="cuda"):
        self.m = int(m)
        self.seed = int(seed)
        self.bucket = int(bucket)
        self.mesh = mesh
        self._store = CorpusStore(m=m, fields=1, mesh=mesh, device=device)
        self._axis = self._store.corpus_axis
        self.device = self._store.device

    def __len__(self) -> int:
        return len(self._store)

    @property
    def capacity(self) -> int:
        return self._store.capacity

    # -- ingestion ----------------------------------------------------------
    def add_batch(self, vecs: Sequence[SparseVec]) -> None:
        """Sketch ``vecs`` on the device (one kernel launch) and append."""
        if not vecs:
            return
        self.add_sketches(*sketch_batch(vecs, m=self.m, seed=self.seed,
                                        bucket=self.bucket,
                                        device=self.device))

    def add_sketches(self, fp, val, norm, argkeys) -> None:
        """Append precomputed sketch rows (``[b, m]``, ``[b, m]``, ``[b]``,
        ``[b, m]``), numpy or tensors; host ICWS sketches interoperate
        (``argkeys`` is :attr:`repro_torch.core.ICWSSketch.argkeys`).  The
        store validates every component and raises ``ValueError`` at
        ingest, before any write."""
        self._store.append(fp, val, norm, argkeys)

    # -- the device-resident view -------------------------------------------
    def arrays(self) -> Tuple[torch.Tensor, ...]:
        """Exact-size ``(fp [P, m], val [P, m], norm [P], argkey [P, m])``
        views of the store, for host cross-checks; queries run on the
        full-capacity buffers."""
        return self._store.arrays()

    # -- queries ------------------------------------------------------------
    def sketch_query(self, v: SparseVec):
        """Sketch one query vector on the device:
        ``(fq [1, m], vq [1, m], nq [1], kq [1, m])``."""
        return sketch_batch([v], m=self.m, seed=self.seed, bucket=self.bucket,
                            device=self.device)

    def _as_queries(self, fq, vq, nq):
        dev = self.device
        return (torch.as_tensor(fq).to(dev, torch.int32).reshape(-1, self.m),
                torch.as_tensor(vq).to(dev, torch.float32).reshape(-1, self.m),
                torch.as_tensor(nq).to(dev, torch.float32))

    def estimate(self, fq, vq, nq) -> torch.Tensor:
        """Inner-product estimates of one query sketch against every corpus
        row: the query stays ``[1, m]`` (the one-vs-many kernel broadcasts
        it), ``nq`` a scalar.  Returns ``[P]`` f32."""
        fpb, vb, nb = self._store.buffers()[:3]
        fq, vq, nq = self._as_queries(fq, vq, nq)
        est = ops.icws_estimate_corpus_stacked(fq, vq, nq.reshape(()), fpb,
                                               vb, nb)
        return est[:len(self)]

    def estimate_batch(self, fq, vq, nq) -> torch.Tensor:
        """Inner-product estimates of Q query sketches against every corpus
        row in one many-vs-many launch (no ``[Q, P, m]`` intermediate).
        Returns ``[Q, P]`` f32; one launch a shard when sharded."""
        fq, vq, nq = self._as_queries(fq, vq, nq)
        if self._axis is not None:
            fpb, vb, nb = self._store.shard_buffers()[:3]
            est = ops.icws_estimate_many_sharded(
                fq, vq, nq.reshape(-1), fpb, vb, nb, mesh=self.mesh,
                axis=self._axis)
        else:
            fpb, vb, nb = self._store.buffers()[:3]
            est = ops.icws_estimate_many_stacked(fq, vq, nq.reshape(-1), fpb,
                                                 vb, nb)
        return est[:, :len(self)]

    def estimate_vec(self, v: SparseVec) -> torch.Tensor:
        """Sketch ``v`` and estimate it against the whole corpus."""
        fq, vq, nq, _ = self.sketch_query(v)
        return self.estimate(fq, vq, nq[0])

    def estimate_vecs(self, vecs: Sequence[SparseVec]) -> torch.Tensor:
        """Sketch a batch of queries (one launch) and estimate all of them
        against the whole corpus (one launch).  Returns ``[Q, P]`` f32."""
        fq, vq, nq, _ = sketch_batch(vecs, m=self.m, seed=self.seed,
                                     bucket=self.bucket, device=self.device)
        return self.estimate_batch(fq, vq, nq)

    def storage_doubles(self) -> float:
        """Paper accounting: 1.5 doubles per sample + 1 norm, per sketch."""
        return self._store.storage_doubles()
