"""Observability of the port (counterpart of ``repro/obs/``), off by
default; ``configs.base.ObsConfig.enabled`` turns on the parts that run
inside the step.

  * ``obs.metrics``: ``MetricBag``, the in-graph metrics the MoE layer
    hands through the blocks into the step's ``obs_*`` metrics.
  * ``obs.tracing``: gated ``record_function`` ranges of the paper's
    phases; ``obs.timeline``: the host-side step timer, its per-phase
    attribution by the cost model, and the live comm share.
  * ``obs.events`` / ``obs.export``: typed events with console and JSONL
    sinks, and the Chrome trace-event exporter.
  * ``obs.profile``: the measured per-phase device time, parsed from the
    ``torch.profiler`` trace of a ``--profile`` run; ``obs.reconcile``:
    modeled against measured (``model_drift`` events, the tune cache's
    stale signal); ``obs.anomaly``: rolling-window detectors over the
    step metrics (``anomaly`` events, which the resilience supervisor's
    escalator consumes).
  * ``obs.benchrow``: the ``BENCH_*.json`` trajectory rows.

Launch surface: ``--metrics-dir`` / ``--profile`` / ``--anomaly-exit`` on
launch/train.py; ``--metrics-dir`` / ``--bench-json`` on launch/serve.py.
"""
from repro_torch.obs import (anomaly, benchrow, events, metrics, profile,
                             reconcile, tracing)
from repro_torch.obs.events import EventLog, emit, global_log
from repro_torch.obs.metrics import MOE_SCHEMA, MetricBag

__all__ = ["anomaly", "benchrow", "events", "metrics", "profile",
           "reconcile", "tracing", "EventLog", "emit", "global_log",
           "MOE_SCHEMA", "MetricBag"]
