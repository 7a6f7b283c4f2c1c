"""Batched serving engine: continuous batching over a decode step (the port
of ``repro/serve/engine.py``, its semantics kept exactly).

Requests (prompt token lists) are admitted into a fixed-size slot batch;
every engine tick runs one decode step for all slots; finished slots (EOS
or max_tokens) retire and free capacity for queued requests.  Prefill steps
the prompt tokens through the decode path.

As in JAX, the decode step advances one position shared by the whole
batch each tick: idle slots are fed token 0 and their cache rows are
written, ``slot_pos`` is shared by every slot, so a request admitted into a
reused slot still attends to its previous occupant's keys, and
``run_until_drained`` returns an empty list.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from .step import greedy_sample


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 16
    eos: Optional[int] = None
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Serves ``model`` (a port ``Model``, on its device) with ``params``."""

    def __init__(self, model, params, batch_slots: int = 4,
                 max_seq: int = 256):
        self.model = model
        self.params = params
        self.slots = batch_slots
        self.max_seq = max_seq
        self.state = model.init_decode_state(batch_slots, max_seq)
        self._queue: deque = deque()
        self._active: Dict[int, Request] = {}       # slot -> request
        self._pending_prompt: Dict[int, deque] = {}
        self._step = model.decode_step

    def submit(self, req: Request):
        self._queue.append(req)

    def _admit(self):
        for slot in range(self.slots):
            if slot not in self._active and self._queue:
                req = self._queue.popleft()
                self._active[slot] = req
                self._pending_prompt[slot] = deque(req.prompt)

    def tick(self) -> int:
        """One decode step for the whole batch.  Returns #active slots."""
        self._admit()
        if not self._active:
            return 0
        toks = np.zeros((self.slots, 1), np.int32)
        for slot, req in self._active.items():
            pend = self._pending_prompt.get(slot)
            if pend:
                toks[slot, 0] = pend.popleft()
            elif req.output:
                toks[slot, 0] = req.output[-1]
            elif req.prompt:
                toks[slot, 0] = req.prompt[-1]
        logits, self.state = self._step(
            self.params, torch.from_numpy(toks).to(self.model.device),
            self.state)
        nxt = greedy_sample(logits)[:, 0].cpu().numpy()
        for slot, req in list(self._active.items()):
            if self._pending_prompt.get(slot):
                continue                       # still prefilling this slot
            req.output.append(int(nxt[slot]))
            hit_eos = req.eos is not None and int(nxt[slot]) == req.eos
            if hit_eos or len(req.output) >= req.max_new_tokens:
                req.done = True
                del self._active[slot]
                self._pending_prompt.pop(slot, None)
        return len(self._active)

    def run_until_drained(self, max_ticks: int = 10_000) -> List[Request]:
        """Ticks until no request is active or queued; returns an empty
        list, as JAX's does (the requests hold their outputs)."""
        for _ in range(max_ticks):
            self.tick()
            if not self._active and not self._queue:
                break
        return []
