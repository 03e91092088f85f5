"""Rehearsable fault tolerance (counterpart of ``repro/resilience/``):
``faults.FaultPlan``, the seeded, step-addressed fault injection of
``--chaos`` / ``$REPRO_CHAOS``, and ``supervisor``, the exit-code-aware
``--auto-restart`` loop with ``AnomalyEscalator``, which turns persistent
anomalies (obs/anomaly.py) into a watchdog exit."""
from repro_torch.resilience.faults import FaultPlan
from repro_torch.resilience.supervisor import (AnomalyEscalator,
                                               classify_exit, supervise)

__all__ = ["AnomalyEscalator", "FaultPlan", "classify_exit", "supervise"]
