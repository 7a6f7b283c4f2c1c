"""Training loop: pipeline + train step + checkpoint + FT hooks (the port
of ``repro/train/trainer.py``).

Composes the training substrate: deterministic resumable data
(``TokenPipeline``), the microbatched train step, async atomic checkpoints
in JAX's format, preemption handling and the heartbeat/straggler monitors,
with JAX's loop, logging, checkpoint cadence and preemption exit.  There
is no ``jit``: the step runs eagerly on the model's device, each batch
copied there as int32 tensors (``embed`` takes them).  The model mesh
(``mesh``, ``rules``) belongs to the sharded model (ROADMAP.md Queue A
18c) and is not taken.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.ft import (HeartbeatRegistry, PreemptionHandler,
                            StragglerDetector)
from repro_torch.models import Model
from repro_torch.optim import adamw
from repro_torch.train.step import make_train_step


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    global_batch: int = 8
    seq: int = 128
    microbatches: int = 1
    seed: int = 0
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    log_every: int = 10
    opt: adamw.AdamWConfig = dataclasses.field(default_factory=adamw.AdamWConfig)


class Trainer:
    def __init__(self, model_cfg, tcfg: TrainerConfig,
                 log_fn: Callable[[str], None] = print, device="cuda"):
        self.model_cfg = model_cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.model = Model(model_cfg, device=self.device)
        self.log = log_fn
        self.preemption = PreemptionHandler()
        self.heartbeats = HeartbeatRegistry(num_hosts=1, timeout=600)
        self.stragglers = StragglerDetector(num_hosts=1)
        self._ckpt = (AsyncCheckpointer(tcfg.ckpt_dir)
                      if tcfg.ckpt_dir else None)

    # ------------------------------------------------------------------
    def init_state(self, generator: Optional[torch.Generator] = None):
        """Parameters drawn from ``generator`` (a generator on the model's
        device seeded ``tcfg.seed`` by default; torch's draws, not
        ``jax.random``'s) and zero AdamW state."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(
                self.tcfg.seed)
        params = self.model.init(generator)
        return params, adamw.init_opt_state(params, self.tcfg.opt)

    def maybe_restore(self, params, opt_state):
        start = 0
        if self._ckpt is not None:
            step = latest_step(self.tcfg.ckpt_dir)
            if step is not None:
                (params, opt_state), extra = restore(
                    self.tcfg.ckpt_dir, step, (params, opt_state))
                start = int(extra.get("data_step", step))
                self.log(f"[trainer] restored checkpoint step={step}")
        return params, opt_state, start

    # ------------------------------------------------------------------
    def run(self) -> Dict[str, list]:
        """JAX's loop; the history also records each step's
        ``grad_norm``, and the final ``(params, opt_state)`` stay on
        ``self.state``."""
        t = self.tcfg
        params, opt_state = self.init_state()
        params, opt_state, start_step = self.maybe_restore(params, opt_state)

        step_fn = make_train_step(self.model, t.opt,
                                  q_chunk=min(1024, t.seq),
                                  k_chunk=min(1024, t.seq))

        pipe = TokenPipeline(seed=t.seed, global_batch=t.global_batch,
                             seq=t.seq, vocab=self.model_cfg.vocab_size,
                             microbatches=t.microbatches,
                             start_step=start_step)
        history = {"loss": [], "step_time": [], "step": [], "grad_norm": []}
        try:
            for i in range(start_step, t.steps):
                batch = next(pipe)
                batch.pop("step")
                batch = {k: torch.from_numpy(v).to(self.device)
                         for k, v in batch.items()}
                if t.microbatches == 1:
                    batch = {k: v[None] for k, v in batch.items()}
                t0 = time.time()
                params, opt_state, metrics = step_fn(params, opt_state, batch)
                loss = float(metrics["loss"])
                dt = time.time() - t0
                history["loss"].append(loss)
                history["step_time"].append(dt)
                history["step"].append(i)
                history["grad_norm"].append(float(metrics["grad_norm"]))
                self.heartbeats.post(0, i)
                self.stragglers.record(0, dt)
                if i % t.log_every == 0:
                    self.log(f"[trainer] step={i} loss={loss:.4f} "
                             f"dt={dt*1e3:.0f}ms lr={float(metrics['lr']):.2e}")
                want_ckpt = self._ckpt is not None and (
                    (i + 1) % t.ckpt_every == 0 or self.preemption.should_save()
                    or i + 1 == t.steps)
                if want_ckpt:
                    self._ckpt.save(i + 1, (params, opt_state),
                                    extra={"data_step": i + 1})
                if self.preemption.should_save():
                    self.log("[trainer] preemption requested; checkpointed and exiting")
                    break
        finally:
            pipe.close()
            if self._ckpt is not None:
                self._ckpt.wait()
        self.state = (params, opt_state)
        return history
