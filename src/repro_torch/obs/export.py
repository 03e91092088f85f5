"""Exporters: Chrome trace-event JSON (loadable in Perfetto) and the
metrics summary (counterpart of ``repro/obs/export.py``).

The Chrome trace-event format (the ``{"traceEvents": [...]}`` JSON that
``chrome://tracing`` and https://ui.perfetto.dev load) holds the step
timeline: each step and its phase spans from ``obs/timeline.py`` become
complete ("ph": "X") events, the 1F1B grid of a pipelined step one row
a stage (tid 100 + stage) with its ``a2a`` marks, and the structured
events instant ("ph": "i") markers.  Timestamps are microseconds (the
format's unit) from the first span.  This is the host-side attribution;
the measured device trace of ``--profile`` is ``torch.profiler``'s own,
under ``<metrics-dir>/torch_trace/``.

``write_metrics_json`` writes the scalar summary (live comm share, mean
step seconds, phase weights, the final step metrics, and with
``--profile`` the measured phases and the drift) beside the trace.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Optional

from repro_torch.obs import events as events_lib
from repro_torch.obs import timeline as timeline_lib

TRACE_NAME = "trace.json"
EVENTS_NAME = "events.jsonl"
METRICS_NAME = "metrics.json"

_PID = 0
TID_PHASES = 0
TID_EVENTS = 1
TID_STAGE0 = 100                        # the pipeline stages' rows


def _us(seconds: float, origin: float) -> float:
    return (seconds - origin) * 1e6


def chrome_trace(tl: Optional[timeline_lib.StepTimeline] = None,
                 events: Iterable[events_lib.Event] = (),
                 schedule=None) -> Dict:
    """The trace-event JSON dict of the timeline's steps and ``events``;
    ``schedule`` (a 1F1B ``runtime/pipeline_schedule.Schedule``) adds
    the reconstructed grid of every step and its exchange marks."""
    evs: List[Dict] = []
    records = tl.records if tl is not None else []
    origin = records[0].start if records else \
        (min((e.ts for e in events), default=0.0))

    def meta(tid: int, name: str) -> Dict:
        return {"ph": "M", "name": "thread_name", "pid": _PID, "tid": tid,
                "args": {"name": name}}

    evs.append({"ph": "M", "name": "process_name", "pid": _PID,
                "args": {"name": "repro_torch"}})
    evs.append(meta(TID_PHASES, "phases"))
    for rec in records:
        evs.append({"ph": "X", "name": f"step {rec.step}", "pid": _PID,
                    "tid": TID_PHASES, "ts": _us(rec.start, origin),
                    "dur": rec.duration * 1e6,
                    "args": {"step": rec.step}})
        for sp in rec.spans:
            evs.append({"ph": "X", "name": sp.name, "pid": _PID,
                        "tid": TID_PHASES, "ts": _us(sp.start, origin),
                        "dur": sp.duration * 1e6,
                        "args": {"step": rec.step}})
    if schedule is not None and records:
        evs += _pipeline_rows(schedule, records, origin, meta)
    emitted = list(events)
    if emitted:
        evs.append(meta(TID_EVENTS, "events"))
        for e in emitted:
            rec = {"ph": "i", "s": "g", "name": e.kind, "pid": _PID,
                   "tid": TID_EVENTS, "ts": max(0.0, _us(e.ts, origin)),
                   "args": dict(e.data)}
            if e.step is not None:
                rec["args"]["step"] = e.step
            evs.append(rec)
    return {"traceEvents": evs, "displayTimeUnit": "ms"}


def _pipeline_rows(schedule, records, origin: float, meta) -> List[Dict]:
    """One row a stage: each step's F / B units and an ``a2a`` mark a
    forward unit, with its slot's status."""
    evs = [meta(TID_STAGE0 + s, f"pipe stage {s}")
           for s in range(schedule.stages)]
    slots = timeline_lib.classify_a2a(schedule)
    for rec in records:
        tick_s = rec.duration / max(1, schedule.ticks)
        for u in timeline_lib.reconstruct_grid(schedule, rec.start,
                                               rec.duration):
            evs.append({"ph": "X", "name": f"{u.phase}{u.microbatch}",
                        "pid": _PID, "tid": TID_STAGE0 + u.stage,
                        "ts": _us(u.start, origin), "dur": u.duration * 1e6,
                        "args": {"step": rec.step, "phase": u.phase,
                                 "microbatch": u.microbatch}})
        for a in slots:
            ts = rec.start + max(0, a.tick) * tick_s
            evs.append({"ph": "i", "s": "t",
                        "name": f"a2a mb{a.microbatch} [{a.status}]",
                        "pid": _PID, "tid": TID_STAGE0 + a.stage,
                        "ts": _us(ts, origin),
                        "args": {"step": rec.step, "stage": a.stage,
                                 "microbatch": a.microbatch,
                                 "tick": a.tick, "status": a.status,
                                 "hidden": a.hidden}})
    return evs


def write_chrome_trace(path: str,
                       tl: Optional[timeline_lib.StepTimeline] = None,
                       events: Iterable[events_lib.Event] = (),
                       schedule=None) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(chrome_trace(tl, events, schedule), f, default=str)
    return path


def load_chrome_trace(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def span_coverage(trace: Dict) -> float:
    """Share of the step spans' time that the phase spans cover (1.0 by
    construction for the proportional attribution); only the phase row
    (tid 0) counts."""
    steps = [e for e in trace["traceEvents"]
             if e.get("ph") == "X" and e.get("tid") == TID_PHASES
             and str(e.get("name", "")).startswith("step ")]
    phases = [e for e in trace["traceEvents"]
              if e.get("ph") == "X" and e.get("tid") == TID_PHASES
              and not str(e.get("name", "")).startswith("step ")]
    total = sum(e["dur"] for e in steps)
    if total <= 0.0:
        return 0.0
    return min(1.0, sum(e["dur"] for e in phases) / total)


def write_metrics_json(path: str, tl: timeline_lib.StepTimeline,
                       extra: Optional[Dict] = None) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = tl.summary()
    if extra:
        payload.update(extra)
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True, default=str)
    return path
