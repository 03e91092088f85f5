"""Measured per-phase device time parsed from a ``torch.profiler`` trace
(counterpart of ``repro/obs/profile.py``, which parses ``jax.profiler``
traces).

``obs/timeline.StepTimeline`` splits each host step over the phases in
proportion to the cost model; this module measures the split.
``launch/train.py --profile N`` exports the Chrome trace of N steady steps
(``<metrics-dir>/torch_trace/``), and ``parse_torch_trace`` attributes
every device event in it to a phase of obs/tracing.py:

 * A **device event** (``cat`` "kernel", "gpu_memcpy" or "gpu_memset")
   takes the phase of the host call that launched it, found by
   ``args["correlation"]`` among the "cuda_runtime" / "cuda_driver"
   events.  That covers the port's kernels, cuBLAS, the elementwise ops
   and NCCL's kernels alike.
 * A **host event** takes its own phase when it is an ``obs/<phase>``
   range, and otherwise the phase of the innermost event enclosing it on
   its thread (by time): a launch inside an op inside a range takes the
   range's phase.
 * A **backward op** ran outside every range, under
   ``autograd::engine::evaluate_function: <Op>Backward0``, on the
   autograd engine's thread.  It takes the phase of the forward op that
   made its autograd node: the trace links the two with a ``fwdbwd``
   flow (``ph`` "s" at the forward op, "f" at the backward one), and both
   carry the node's ``Sequence number``, which links a node without a
   flow (``_backward_phases``).  Custom ``autograd.Function``s (the port's
   kernel wrappers, the all-to-all transfers) appear under their class
   names and link the same way.  Ops that a checkpointed block
   recomputes in the backward run inside the ranges again.
 * Anything else is ``other``.

On a trace without device events (a CPU run, as in the tests) the host
ops' self times (each op's duration less its children's) stand in for
device time, so the phases are host seconds there.  Durations are
summed over the capture and divided by the profiled steps and by the
ranks whose traces were summed (``reduce_over_ranks`` sums the ranks' totals of a mesh).
NCCL's kernels include the time they wait for the slowest rank, and the
pipelined transport overlaps them with the expert MLP on another stream,
so over a mesh the phases can sum to more than the wall time, as they
can in the JAX parser, which sums event durations in the same way.
"""
from __future__ import annotations

import glob
import gzip
import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.obs import timeline as timeline_lib
from repro_torch.obs.timeline import PHASE_ORDER, PhaseSpan, StepRecord

OTHER = "other"
_PHASE_NAMES = tuple(p for p in PHASE_ORDER if p != OTHER)
PHASE_RE = re.compile("^obs/(%s)$" % "|".join(_PHASE_NAMES))

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# host events that count as ops (the profiler's own span and the device
# side's mirror of the ranges are neither host ops nor device work)
_HOST_SKIP_CATS = DEVICE_CATS + ("gpu_user_annotation", "Trace", "ac2g",
                                 "fwdbwd")
_BACKWARD_PREFIX = "autograd::engine::evaluate_function"
_SEQ = "Sequence number"
_FWD_TID = "Fwd thread id"


# -------------------------------------------------------- trace loading ---

def find_trace_file(path: str) -> str:
    """Resolve a ``--profile`` output directory (``<metrics-dir>/
    torch_trace``) to its newest ``*.json[.gz]`` trace; a file passes
    through."""
    if os.path.isfile(path):
        return path
    candidates: List[str] = []
    for pat in ("*.json.gz", "*.json", os.path.join("**", "*.json.gz"),
                os.path.join("**", "*.json")):
        candidates = glob.glob(os.path.join(path, pat), recursive=True)
        if candidates:
            break
    if not candidates:
        raise FileNotFoundError(
            f"no *.json[.gz] trace under {path!r}: did the profiler write "
            f"a capture?")
    return max(candidates, key=os.path.getmtime)


def load_trace(path: str) -> Dict:
    """The Chrome-trace dict of ``path`` (a trace file or a directory;
    ``.gz`` decompressed)."""
    path = find_trace_file(path)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


# --------------------------------------------------------- attribution ---

def _phase_of_name(name: str) -> Optional[str]:
    m = PHASE_RE.match(name)
    return m.group(1) if m else None


def _is_backward(e: Dict, args: Dict) -> bool:
    return (str(e.get("name", "")).startswith(_BACKWARD_PREFIX)
            or int(args.get(_FWD_TID, 0) or 0) > 0)


class _Host:
    """The host events of one trace, grouped and sorted by thread."""

    def __init__(self, events: List[Dict]):
        by_thread: Dict[Tuple, List[Dict]] = {}
        for e in events:
            by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(e)
        for evs in by_thread.values():
            evs.sort(key=lambda e: (float(e["ts"]), -float(e["dur"])))
        self.threads = by_thread
        self.self_us: Dict[int, float] = {}
        self.phase: Dict[int, Optional[str]] = {}

    def resolve(self, backward: Dict[int, str]) -> None:
        """Each event's phase: its own (an obs range, or ``backward``'s
        for a backward node, keyed by id(event)), else the innermost
        enclosing event's on its thread."""
        phase: Dict[int, Optional[str]] = {}
        self_us: Dict[int, float] = {}
        for evs in self.threads.values():
            stack: List[Tuple[float, Dict]] = []
            for e in evs:
                ts = float(e["ts"])
                end = ts + float(e["dur"])
                while stack and stack[-1][0] <= ts:
                    stack.pop()
                parent = stack[-1][1] if stack else None
                if parent is not None:
                    self_us[id(parent)] -= float(e["dur"])
                own = _phase_of_name(str(e.get("name", "")))
                if own is None:
                    own = backward.get(id(e))
                if own is None and parent is not None:
                    own = phase[id(parent)]
                phase[id(e)] = own
                self_us[id(e)] = float(e["dur"])
                stack.append((end, e))
        self.phase, self.self_us = phase, self_us


def _backward_phases(host: _Host, flows: List[Dict],
                     ops: List[Dict]) -> Dict[int, str]:
    """id(backward event) -> the phase of its forward op (none when that op
    ran outside every range).  A ``fwdbwd`` flow links the two directly;
    the flows also name each forward thread's id (the backward event's
    ``Fwd thread id``), and a backward event without a flow (the
    ``evaluate_function`` wrapper around a node) is linked by (forward
    thread, sequence number).  Sequence numbers count per thread (a
    checkpointed block's recompute runs on the autograd thread), so a
    backward event whose forward thread no flow names (every one, in a
    trace without flows) links by number to the ops of the threads no
    flow names, never to a named thread's op of the same number."""
    by_start: Dict[Tuple, Dict] = {}
    for e in ops:
        if _SEQ in (e.get("args") or {}):
            by_start[(e.get("pid"), e.get("tid"), float(e["ts"]))] = e
    starts: Dict = {}
    ends: Dict = {}
    for f in flows:
        key = (f.get("pid"), f.get("tid"), float(f["ts"]))
        (starts if f.get("ph") == "s" else ends)[f.get("id")] = key
    out: Dict[int, str] = {}
    fwd_thread: Dict[Tuple, object] = {}     # (pid, tid) -> its id
    for fid, skey in starts.items():
        fwd, bwd = by_start.get(skey), by_start.get(ends.get(fid))
        if fwd is None or bwd is None:
            continue
        fwd_thread.setdefault(skey[:2], (bwd.get("args") or {}).get(_FWD_TID))
        ph = host.phase.get(id(fwd))
        if ph is not None:
            out[id(bwd)] = ph
    key_phase: Dict[Tuple, str] = {}      # (fwd thread id, seq) -> phase
    for e in ops:
        a = e.get("args") or {}
        if _SEQ in a and not _is_backward(e, a):
            ph = host.phase.get(id(e))
            if ph is not None:
                thread = fwd_thread.get((e.get("pid"), e.get("tid")))
                key_phase.setdefault((thread, a[_SEQ]), ph)
    named = set(fwd_thread.values())
    for e in ops:
        a = e.get("args") or {}
        if _SEQ not in a or id(e) in out or not _is_backward(e, a):
            continue
        # a named thread's number means its op alone: another thread's
        # op of the same number is a coincidence of two counters
        thread = a.get(_FWD_TID)
        ph = key_phase.get((thread if thread in named else None, a[_SEQ]))
        if ph is not None:
            out[id(e)] = ph
    return out


@dataclass(frozen=True)
class MeasuredTimeline:
    """Per-phase durations measured from a trace: the span schema of the
    modeled ``StepTimeline``, every duration a sum of real events."""
    phase_seconds: Dict[str, float]     # per profiled step, per rank
    total_phase_seconds: Dict[str, float]   # whole capture, all ranks
    steps: int                          # profiled steps the totals cover
    n_devices: int                      # ranks whose events were summed
    n_events: int                       # events attributed
    source: str                         # trace file(s) read
    records: Tuple[StepRecord, ...]
    phase_events: Dict[str, int] = field(default_factory=dict)  # totals
    device: bool = True                 # False: host self times stood in
    other_names: Dict[str, int] = field(default_factory=dict)
    # the NCCL kernels' part of phase_seconds (their transfers and their
    # waits for the slowest rank), per step and rank
    phase_nccl_seconds: Dict[str, float] = field(default_factory=dict)

    def comm_share(self) -> float:
        return timeline_lib.comm_share(self.phase_seconds)

    def step_seconds(self) -> float:
        return sum(self.phase_seconds.values())

    def launches_per_step(self) -> Dict[str, float]:
        d = max(1, self.steps * self.n_devices)
        return {k: v / d for k, v in self.phase_events.items()}

    def summary(self) -> Dict[str, float]:
        out: Dict[str, float] = {
            "measured_steps": float(self.steps),
            "measured_devices": float(self.n_devices),
            "measured_events": float(self.n_events),
            "measured_step_s": self.step_seconds(),
            "measured_comm_share": self.comm_share(),
            "measured_on_device": float(self.device),
        }
        launches = self.launches_per_step()
        for name in PHASE_ORDER:
            if name in self.phase_seconds:
                out[f"measured_{name}_s"] = self.phase_seconds[name]
                out[f"measured_{name}_launches"] = launches.get(name, 0.0)
            if name in self.phase_nccl_seconds:
                out[f"measured_{name}_nccl_s"] = \
                    self.phase_nccl_seconds[name]
        return out


def _synth_records(phase_seconds: Dict[str, float], steps: int
                   ) -> Tuple[StepRecord, ...]:
    """Per-step records tiling the measured phase durations in the order
    they run (the starts are filler, not a host timeline)."""
    records = []
    t = 0.0
    for s in range(max(1, steps)):
        spans: List[PhaseSpan] = []
        start = t
        for name in PHASE_ORDER:
            d = phase_seconds.get(name, 0.0)
            if d > 0.0:
                spans.append(PhaseSpan(name, t, d))
                t += d
        records.append(StepRecord(step=s, start=start, duration=t - start,
                                  spans=tuple(spans)))
    return tuple(records)


def _timeline(totals: Dict[str, float], counts: Dict[str, int],
              nccl: Dict[str, float], *, steps: int, ranks: int,
              n_events: int, source: str, device: bool,
              other_names: Dict[str, int]) -> MeasuredTimeline:
    steps, ranks = max(1, int(steps)), max(1, int(ranks))
    per_step = {k: v / (steps * ranks) for k, v in totals.items()}
    return MeasuredTimeline(
        phase_seconds=per_step, total_phase_seconds=dict(totals),
        steps=steps, n_devices=ranks, n_events=n_events, source=source,
        records=_synth_records(per_step, steps), phase_events=dict(counts),
        device=device, other_names=dict(other_names),
        phase_nccl_seconds={k: v / (steps * ranks)
                            for k, v in nccl.items()})


def parse_trace_events(trace: Dict, *, steps: int = 1, ranks: int = 1,
                       source: str = "<dict>") -> MeasuredTimeline:
    """Attribute a loaded Chrome-trace dict's device events (or, without
    any, its host ops' self times) to the phases; see the module
    docstring."""
    host_evs, device_evs, flows = [], [], []
    for e in trace.get("traceEvents", []):
        ph, cat = e.get("ph"), e.get("cat", "")
        if ph == "X" and "ts" in e and "dur" in e:
            if cat in DEVICE_CATS:
                device_evs.append(e)
            elif cat not in _HOST_SKIP_CATS:
                host_evs.append(e)
        elif ph in ("s", "f") and cat == "fwdbwd":
            flows.append(e)
    host = _Host(host_evs)
    backward: Dict[int, str] = {}
    for _ in range(3):          # a backward node's phase can need its
        host.resolve(backward)  # forward op resolved through another one
        nxt = _backward_phases(host, flows, host_evs)
        if nxt == backward:
            break
        backward = nxt

    totals: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    nccl: Dict[str, float] = {}
    other: Dict[str, int] = {}

    def add(phase: Optional[str], e: Dict, us: float) -> None:
        phase = phase or OTHER
        name = str(e.get("name", ""))
        totals[phase] = totals.get(phase, 0.0) + us * 1e-6
        counts[phase] = counts.get(phase, 0) + 1
        if name.startswith("nccl"):
            nccl[phase] = nccl.get(phase, 0.0) + us * 1e-6
        if phase == OTHER:
            other[name] = other.get(name, 0) + 1

    if device_evs:
        launch = {}
        for e in host_evs:
            if e.get("cat") in LAUNCH_CATS:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launch[corr] = host.phase.get(id(e))
        for e in device_evs:
            add(launch.get((e.get("args") or {}).get("correlation")), e,
                float(e["dur"]))
        n = len(device_evs)
    else:
        ops = [e for e in host_evs if e.get("cat", "cpu_op") == "cpu_op"]
        for e in ops:
            add(host.phase.get(id(e)), e, max(0.0, host.self_us[id(e)]))
        n = len(ops)
    return _timeline(totals, counts, nccl, steps=steps, ranks=ranks,
                     n_events=n, source=source, device=bool(device_evs),
                     other_names=other)


def parse_torch_trace(path: str, *, steps: int = 1, ranks: int = 1
                      ) -> MeasuredTimeline:
    """Parse the trace a ``--profile`` run wrote under ``path`` (the
    ``torch_trace`` directory or a trace file)."""
    trace_file = find_trace_file(path)
    return parse_trace_events(load_trace(trace_file), steps=steps,
                              ranks=ranks, source=trace_file)


def reduce_over_ranks(measured: MeasuredTimeline, group,
                      device) -> MeasuredTimeline:
    """Every rank's parse of its own trace summed over ``group`` (a
    process group; one all-reduce of a float64 vector on ``device``), per
    step and per rank: the mesh's mean phase split.  A group of one rank
    returns ``measured``."""
    import torch

    from repro_torch.comm import collectives
    if collectives.group_size(group) == 1:
        return measured
    n = collectives.group_size(group)
    vec = torch.tensor(
        [measured.total_phase_seconds.get(p, 0.0) for p in PHASE_ORDER]
        + [float(measured.phase_events.get(p, 0)) for p in PHASE_ORDER]
        + [measured.phase_nccl_seconds.get(p, 0.0) * measured.steps
           for p in PHASE_ORDER]
        + [float(measured.n_events), float(measured.device)],
        dtype=torch.float64, device=device)
    got = collectives.raw_all_reduce_sum(vec, group).cpu().tolist()
    k = len(PHASE_ORDER)
    totals = {p: got[i] for i, p in enumerate(PHASE_ORDER) if got[i] > 0.0}
    counts = {p: int(got[k + i]) for i, p in enumerate(PHASE_ORDER)
              if got[k + i] > 0}
    nccl = {p: got[2 * k + i] for i, p in enumerate(PHASE_ORDER)
            if got[2 * k + i] > 0.0}
    return _timeline(totals, counts, nccl, steps=measured.steps, ranks=n,
                     n_events=int(got[3 * k]),
                     source=f"{measured.source} (+{n - 1} ranks)",
                     device=got[3 * k + 1] == n,
                     other_names=measured.other_names)
