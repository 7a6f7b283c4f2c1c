"""Fault tolerance: heartbeats, straggler detection, preemption, elasticity.

A host-only copy of ``repro/ft/monitor.py`` (numpy and the standard
library; its code below this docstring is the original's, which a test
holds), designed for the multi-controller deployment model (one process
per host, thousands of hosts):

  * :class:`HeartbeatRegistry` -- hosts post (host_id, step, timestamp);
    a monitor flags hosts silent for > ``timeout`` as suspected-dead.
    On real clusters the transport is the cluster KV store; here it is an
    in-process dict with the same API so the logic is testable.
  * :class:`StragglerDetector` -- robust per-step-time statistics (median +
    MAD); a host whose step time exceeds median + k*MAD for ``patience``
    consecutive steps is flagged.  The mitigation hook is pluggable
    (re-shard away, checkpoint-and-evict, or just alert).
  * :class:`PreemptionHandler` -- SIGTERM handler that requests a final
    synchronous checkpoint before the allocator kills the job.
  * :func:`elastic_plan` -- given a dead-host set, computes the largest
    rectangular (data, model) mesh over surviving hosts and the restore
    plan (which checkpoint step, which new mesh) -- paired with the elastic
    restore in :mod:`repro_torch.checkpoint.store`.
  * Gradient-divergence detection plugs in via repro_torch.train.telemetry: a
    replica whose sketch-estimated gradient cosine vs the fleet median
    drops below threshold is treated like a failed health check (silent
    data/hardware corruption).
"""
from __future__ import annotations

import dataclasses
import signal
import threading
import time
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np


@dataclasses.dataclass
class Heartbeat:
    host_id: int
    step: int
    wall_time: float


class HeartbeatRegistry:
    def __init__(self, num_hosts: int, timeout: float = 60.0):
        self.num_hosts = num_hosts
        self.timeout = timeout
        self._beats: Dict[int, Heartbeat] = {}
        self._lock = threading.Lock()

    def post(self, host_id: int, step: int, now: Optional[float] = None):
        with self._lock:
            self._beats[host_id] = Heartbeat(host_id, step,
                                             now if now is not None else time.time())

    def dead_hosts(self, now: Optional[float] = None) -> Set[int]:
        now = now if now is not None else time.time()
        with self._lock:
            dead = set()
            for h in range(self.num_hosts):
                hb = self._beats.get(h)
                if hb is None or now - hb.wall_time > self.timeout:
                    dead.add(h)
            return dead

    def healthy(self, now: Optional[float] = None) -> bool:
        return not self.dead_hosts(now)


class StragglerDetector:
    def __init__(self, num_hosts: int, k_mad: float = 6.0, patience: int = 3,
                 window: int = 50):
        self.num_hosts = num_hosts
        self.k_mad = k_mad
        self.patience = patience
        self.window = window
        self._times: Dict[int, List[float]] = {h: [] for h in range(num_hosts)}
        self._strikes: Dict[int, int] = {h: 0 for h in range(num_hosts)}

    def record(self, host_id: int, step_time: float):
        buf = self._times[host_id]
        buf.append(step_time)
        if len(buf) > self.window:
            buf.pop(0)

    def stragglers(self) -> Set[int]:
        latest = {h: t[-1] for h, t in self._times.items() if t}
        if len(latest) < max(2, self.num_hosts // 2):
            return set()
        vals = np.array(list(latest.values()))
        med = np.median(vals)
        mad = np.median(np.abs(vals - med)) + 1e-9
        out = set()
        for h, t in latest.items():
            if t > med + self.k_mad * mad:
                self._strikes[h] += 1
            else:
                self._strikes[h] = 0
            if self._strikes[h] >= self.patience:
                out.add(h)
        return out


class PreemptionHandler:
    """SIGTERM -> request checkpoint; the train loop polls should_save()."""

    def __init__(self):
        self._flag = threading.Event()

    def install(self):
        signal.signal(signal.SIGTERM, self._on_signal)
        return self

    def _on_signal(self, signum, frame):
        self._flag.set()

    def should_save(self) -> bool:
        return self._flag.is_set()

    def trigger_for_test(self):
        self._flag.set()


def elastic_plan(num_hosts: int, devices_per_host: int, dead: Set[int],
                 model_parallel: int) -> Tuple[int, int]:
    """Largest (data, model) mesh over survivors.

    Keeps model-parallel size fixed (param layout unchanged within a shard
    group) and shrinks data-parallel width to the largest multiple that
    survivors support -- restore then reshards via the elastic checkpoint.
    """
    alive = num_hosts - len(dead)
    total = alive * devices_per_host
    if total < model_parallel:
        raise RuntimeError("not enough survivors for one model replica")
    data = total // model_parallel
    return data, model_parallel


@dataclasses.dataclass
class RecoveryAction:
    kind: str          # 'none' | 'evict_and_rescale' | 'alert_straggler'
    dead_hosts: Set[int]
    stragglers: Set[int]
    new_mesh: Optional[Tuple[int, int]] = None


def plan_recovery(hb: HeartbeatRegistry, sd: StragglerDetector,
                  devices_per_host: int, model_parallel: int,
                  now: Optional[float] = None) -> RecoveryAction:
    dead = hb.dead_hosts(now)
    stragglers = sd.stragglers() - dead
    if dead:
        mesh = elastic_plan(hb.num_hosts, devices_per_host, dead, model_parallel)
        return RecoveryAction("evict_and_rescale", dead, stragglers, mesh)
    if stragglers:
        return RecoveryAction("alert_straggler", dead, stragglers, None)
    return RecoveryAction("none", dead, stragglers, None)
