"""Sharded, prefetching, deterministically-resumable input pipeline: a copy
of ``repro/data/pipeline.py`` over the port's ``token_stream`` (the same
batches, bit for bit).

Each host generates only its own shard of the global batch (indexed by
``host_id``/``num_hosts``), prefetches ahead on a worker thread, and is
exactly resumable: batch content is a pure function of (seed, step), so a
job restarted from a step-k checkpoint sees the same stream it would have --
no data-loader state in the checkpoint at all.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np

from .synthetic import token_stream


class TokenPipeline:
    def __init__(self, *, seed: int, global_batch: int, seq: int, vocab: int,
                 host_id: int = 0, num_hosts: int = 1, microbatches: int = 1,
                 prefetch: int = 2, start_step: int = 0):
        assert global_batch % num_hosts == 0
        self.seed = seed
        self.global_batch = global_batch
        self.seq = seq
        self.vocab = vocab
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.microbatches = microbatches
        self._step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _make(self, step: int) -> Dict[str, np.ndarray]:
        toks = token_stream(self.seed, step, self.global_batch, self.seq,
                            self.vocab)
        per_host = self.global_batch // self.num_hosts
        lo = self.host_id * per_host
        shard = toks[lo:lo + per_host]
        tokens, labels = shard[:, :-1], shard[:, 1:]
        M = self.microbatches
        if M > 1:
            tokens = tokens.reshape(M, per_host // M, self.seq)
            labels = labels.reshape(M, per_host // M, self.seq)
        return {"tokens": tokens.astype(np.int32),
                "labels": labels.astype(np.int32), "step": step}

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = self._make(step)
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        return self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
