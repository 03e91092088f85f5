"""Structured events: typed records, a process-local log and its sinks
(counterpart of part of ``repro/obs/events.py``).

The planner emits ``comm_plan`` when a resolution changes; tune emits
``tune_probe``, ``tune_result``, ``tune_cache_reject`` and
``tune_stale``.  Sinks subscribe to the log: ``ConsoleSink`` prints one
line an event, ``JsonlSink`` appends one JSON object an event to a file,
``MemorySink`` keeps them for tests.  With no sink attached ``emit`` is a
no-op, so library code emits unconditionally.  The rest of ``obs/``
(metrics, traces, reconciliation) is ROADMAP Queue 1 item 8.
"""
from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional


@dataclass(frozen=True)
class Event:
    """One observation: ``kind`` names the schema of ``data``; ``step``
    the step it belongs to (None: out of band); ``ts`` host seconds."""
    kind: str
    ts: float
    step: Optional[int] = None
    data: Dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> str:
        rec = {"kind": self.kind, "ts": self.ts}
        if self.step is not None:
            rec["step"] = self.step
        rec.update(self.data)
        return json.dumps(rec, default=str, sort_keys=True)


# ------------------------------------------------------------------ sinks --

class MemorySink:
    """Keeps every event in memory."""

    def __init__(self):
        self.events: List[Event] = []

    def __call__(self, ev: Event) -> None:
        self.events.append(ev)

    def of_kind(self, kind: str) -> List[Event]:
        return [e for e in self.events if e.kind == kind]


class JsonlSink:
    """Appends one JSON line an event, flushed a line."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a", buffering=1)
        self._lock = threading.Lock()

    def __call__(self, ev: Event) -> None:
        with self._lock:
            self._f.write(ev.to_json() + "\n")

    def close(self) -> None:
        with self._lock:
            self._f.close()


def _fmt_comm_plan(e: Event) -> str:
    d = e.data
    tag = "[comm] degraded:" if d.get("degraded") else "[comm] plan:"
    return (f"{tag} {d.get('algorithm')} on axis "
            f"{d.get('axis', 'model')!r} ({d.get('reason', '')})")


def _fmt_tune_probe(e: Event) -> str:
    d = e.data
    extra = f" chunks={d['chunks']}" if (d.get("chunks") or 1) > 1 else ""
    return (f"[tune] probe {d.get('row_kind')} {d.get('name')}/"
            f"{d.get('wire_format')} {d.get('msg_bytes', 0) / 2**20:.2f}MiB"
            f"{extra}: {d.get('seconds', 0.0) * 1e6:.0f}us")


_RENDERERS: Dict[str, Callable[[Event], str]] = {
    "comm_plan": _fmt_comm_plan,
    "tune_probe": _fmt_tune_probe,
    "tune_cache_reject": lambda e: (
        f"[tune] cache reject: {e.data.get('reason', '')}"),
    "tune_stale": lambda e: (
        f"[tune] calibration STALE (comm drift "
        f"{e.data.get('comm_drift', 0.0):.0%}): re-run the probe "
        f"({e.data.get('path', '')})"),
    "error": lambda e: "error: " + str(e.data.get("message", "")),
}


def render(ev: Event) -> str:
    fn = _RENDERERS.get(ev.kind)
    if fn is not None:
        return fn(ev)
    body = " ".join(f"{k}={v}" for k, v in sorted(ev.data.items()))
    step = f" step {ev.step}" if ev.step is not None else ""
    return f"[{ev.kind}]{step} {body}".rstrip()


class ConsoleSink:
    """One human-readable line an event (``kinds`` None: every kind);
    "error" events go to stderr."""

    def __init__(self, kinds: Optional[set] = None, stream: Any = None):
        self.kinds = kinds
        self.stream = stream

    def __call__(self, ev: Event) -> None:
        if self.kinds is not None and ev.kind not in self.kinds:
            return
        out = self.stream or (sys.stderr if ev.kind == "error"
                              else sys.stdout)
        print(render(ev), file=out, flush=True)


# --------------------------------------------------------------- the log --

class EventLog:
    """Hands each emitted event to every sink.  A sink's exception is
    logged and dropped: observing must not stop a step."""

    def __init__(self):
        self._sinks: List[Callable[[Event], None]] = []

    def add_sink(self, sink: Callable[[Event], None]) -> Callable:
        self._sinks.append(sink)
        return sink

    def remove_sink(self, sink: Callable[[Event], None]) -> None:
        if sink in self._sinks:
            self._sinks.remove(sink)

    def emit(self, kind: str, step: Optional[int] = None,
             **data: Any) -> Optional[Event]:
        if not self._sinks:
            return None
        ev = Event(kind=kind, ts=time.time(), step=step, data=data)
        for sink in list(self._sinks):
            try:
                sink(ev)
            except Exception:
                logging.getLogger(__name__).exception(
                    "event sink %r failed on %r", sink, kind)
        return ev


_GLOBAL = EventLog()


def global_log() -> EventLog:
    return _GLOBAL


def emit(kind: str, step: Optional[int] = None, **data: Any
         ) -> Optional[Event]:
    """Emit on the process's log (the library code's entry point)."""
    return _GLOBAL.emit(kind, step=step, **data)
