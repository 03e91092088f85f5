"""Rehearsable fault tolerance (counterpart of ``repro/resilience/``):
``faults.FaultPlan``, the seeded, step-addressed fault injection of
``--chaos`` / ``$REPRO_CHAOS``, and ``supervisor``, the exit-code-aware
``--auto-restart`` loop.  ``AnomalyEscalator`` needs ``obs/anomaly.py``
(ROADMAP Queue 1 item 8)."""
from repro_torch.resilience.faults import FaultPlan
from repro_torch.resilience.supervisor import classify_exit, supervise

__all__ = ["FaultPlan", "classify_exit", "supervise"]
