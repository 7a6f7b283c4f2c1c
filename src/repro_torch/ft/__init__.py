"""Fault tolerance: heartbeats, stragglers, preemption, elastic recovery
(host copies of ``repro.ft``)."""
from .monitor import (HeartbeatRegistry, PreemptionHandler, RecoveryAction,
                      StragglerDetector, elastic_plan, plan_recovery)

__all__ = ["HeartbeatRegistry", "PreemptionHandler", "RecoveryAction",
           "StragglerDetector", "elastic_plan", "plan_recovery"]
