"""Host-side step timeline: per-phase attribution of each step's wall time
and the live comm-share estimate (counterpart of ``repro/obs/timeline.py``).

The host sees one wall interval a step.  ``StepTimeline`` splits it over
the MoE phases in proportion to a modeled cost per phase
(``model_phase_seconds``: analytic FLOPs for the compute phases priced at
the H100's bf16 peak, hw.py, and the comm planner's topology cost model,
calibrated when a tuning-cache entry matched, for the all-to-all legs).
The spans tile the step, so their proportions are the model's; the
measured counterpart comes from a device trace (obs/profile.py), and
obs/reconcile.py diffs the two.

On a mesh with a pipe axis ``reconstruct_grid`` lays the 1F1B timetable
(``runtime/pipeline_schedule.build_1f1b``) over the measured step: one
span a (stage, microbatch) F or B unit, and ``classify_a2a`` one mark a
forward unit at ``Schedule.a2a_slot``: ``bubble`` (the slot is an idle
tick: the exchange hides in a bubble), ``overlap`` (the slot computes
another microbatch) or ``cold_start`` (the pipeline's first unit, with
nothing to hide behind).  Pure schedule arithmetic, as the reference's
(obs/export.py draws them).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.hw import DEVICE_FLOPS

# Bare phase names (obs/tracing.py's PH_* without the prefix), in the
# order they run, and the residual bucket.
PHASE_ORDER = ("gate", "hash_compress", "dispatch_a2a", "expert_mlp",
               "combine_a2a", "decompress", "stage_transfer", "other")
COMM_PHASES = ("dispatch_a2a", "combine_a2a", "stage_transfer")


@dataclass(frozen=True)
class PhaseSpan:
    name: str
    start: float                        # host wall-clock seconds
    duration: float


@dataclass(frozen=True)
class StepRecord:
    step: int
    start: float
    duration: float
    spans: Tuple[PhaseSpan, ...]

    def phase_seconds(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for sp in self.spans:
            out[sp.name] = out.get(sp.name, 0.0) + sp.duration
        return out


def model_phase_seconds(cfg, mesh, *, batch: int, seq: int,
                        device_flops: float = DEVICE_FLOPS,
                        stage_msg_bytes: int = 0) -> Dict[str, float]:
    """Modeled seconds per phase of one training step of ``cfg`` on
    ``mesh`` (None: one card), the JAX function's terms: the step is
    6 x active params x tokens FLOPs over the mesh's peak; the
    all-to-all legs price the true wire bytes (scales sidecar included)
    through the planner's cost model (``CommPlan.wire_cost``); gate, hash,
    expert MLP and decompress their analytic FLOPs; on a pipe axis of P
    ranks, P - 1 stage hand-offs of ``stage_msg_bytes`` through
    ``topology.stage_transfer_cost`` (the ``pipe`` plan's topology).
    Call it after the first step, so that ``comm.planner.last_plan()``
    is the step's."""
    from repro_torch.comm import planner as comm_planner
    from repro_torch.comm import topology as topo_lib
    from repro_torch.configs.base import MOE, active_param_count
    from repro_torch.core import clustering
    from repro_torch.core.moe import (expert_capacity, num_lsh_slots,
                                      padded_num_experts)
    from repro_torch.models.model import torch_dtype
    from repro_torch.runtime import sharding

    n_dev = sharding.num_ranks(mesh)
    tokens = batch * seq
    total_s = 6.0 * active_param_count(cfg) * tokens / (device_flops * n_dev)
    out = {name: 0.0 for name in PHASE_ORDER}

    n_moe = sum(1 for _, f in cfg.layout if f == MOE) * cfg.num_super_blocks
    if n_moe and cfg.moe.num_experts:
        moe, h = cfg.moe, cfg.d_model
        model_r = sharding.axis_size(mesh, "model")
        n_dp = sharding.axis_size(mesh, "data")
        e_pad = padded_num_experts(moe.num_experts, model_r)
        t_loc = max(1, (batch // n_dp) * (seq // max(1, model_r)))
        capacity = expert_capacity(t_loc, e_pad, moe.top_k,
                                   moe.capacity_factor)
        use_lsh = moe.lsh.enabled
        c_wire = num_lsh_slots(capacity, moe.lsh.compression_rate) \
            if use_lsh else capacity
        wire_fmt = moe.lsh.wire_format if use_lsh else None
        wire_dtype = torch_dtype(moe.lsh.wire_dtype if use_lsh
                                 else cfg.dtype)
        msg = clustering.wire_bytes(e_pad, c_wire, h, wire_fmt,
                                    wire_dtype=wire_dtype)
        plan = comm_planner.last_plan("model")
        if plan is None:
            plan = comm_planner.plan_collectives(
                mesh, moe.comm, axis_name="model", msg_bytes=msg,
                chunk_extent=c_wire)
        leg_s = topo_lib.estimate_seconds(plan.wire_cost(msg))
        out["dispatch_a2a"] = leg_s * n_moe
        out["combine_a2a"] = leg_s * n_moe

        # analytic FLOPs of the per-token MoE phases (matmuls 2 x MACs,
        # elementwise phases 2 a element)
        flops = device_flops * n_dev
        n_mat = 3 if cfg.mlp_act == "swiglu" else 2
        out["gate"] = 2.0 * tokens * h * moe.num_experts * n_moe / flops
        if use_lsh:
            rot = 2.0 * tokens * moe.top_k * h * moe.lsh.rotation_dim \
                * moe.lsh.num_hashes
            out["hash_compress"] = rot * n_moe / flops
            out["decompress"] = 2.0 * tokens * moe.top_k * h * n_moe / flops
        out["expert_mlp"] = (2.0 * tokens * moe.top_k
                             * n_mat * h * moe.expert_ffn_dim
                             * n_moe / flops)

    pipe_r = sharding.axis_size(mesh, "pipe")
    if pipe_r > 1 and stage_msg_bytes:
        plan = comm_planner.last_plan("pipe")
        topo = plan.topology if plan is not None else \
            topo_lib.build_topology(mesh, axis_name="pipe")
        hop = topo_lib.estimate_seconds(
            topo_lib.stage_transfer_cost(topo, stage_msg_bytes))
        out["stage_transfer"] = hop * (pipe_r - 1)

    spent = sum(v for k, v in out.items()
                if k not in COMM_PHASES and k != "other")
    out["other"] = max(0.0, total_s - spent)
    return out


def comm_share(phase_seconds: Dict[str, float]) -> float:
    """Comm fraction of a phase split: the live Fig. 3 number."""
    total = sum(phase_seconds.values())
    if total <= 0.0:
        return 0.0
    return sum(phase_seconds.get(p, 0.0) for p in COMM_PHASES) / total


class StepTimeline:
    """Start / stop bracket around each host step; the attribution is made
    at ``stop`` with the current phase weights (set once the first step
    has resolved its comm plan)."""

    def __init__(self, phase_seconds: Optional[Dict[str, float]] = None,
                 clock=time.perf_counter, wall=time.time):
        self._weights: Optional[Dict[str, float]] = None
        self._clock = clock
        self._wall = wall
        self._t0: Optional[float] = None
        self._w0: Optional[float] = None
        self._step: Optional[int] = None
        self.records: List[StepRecord] = []
        if phase_seconds:
            self.set_phase_seconds(phase_seconds)

    def set_phase_seconds(self, phase_seconds: Dict[str, float]) -> None:
        total = sum(max(0.0, v) for v in phase_seconds.values())
        if total <= 0.0:
            self._weights = None
            return
        self._weights = {k: max(0.0, v) / total
                         for k, v in phase_seconds.items() if v > 0.0}

    @property
    def weights(self) -> Optional[Dict[str, float]]:
        return self._weights

    def start(self, step: int) -> None:
        self._step = step
        self._t0 = self._clock()
        self._w0 = self._wall()

    def stop(self, step: Optional[int] = None) -> StepRecord:
        if self._t0 is None:
            raise RuntimeError("StepTimeline.stop() without start()")
        dt = max(1e-9, self._clock() - self._t0)
        start = self._w0
        step = self._step if step is None else step
        spans: List[PhaseSpan] = []
        if self._weights:
            t = start
            ordered = [p for p in PHASE_ORDER if p in self._weights]
            ordered += [p for p in self._weights if p not in PHASE_ORDER]
            for name in ordered:
                d = self._weights[name] * dt
                spans.append(PhaseSpan(name, t, d))
                t += d
        else:
            spans.append(PhaseSpan("step", start, dt))
        rec = StepRecord(step=int(step or 0), start=start, duration=dt,
                         spans=tuple(spans))
        self.records.append(rec)
        self._t0 = self._w0 = self._step = None
        return rec

    def comm_share(self) -> float:
        return comm_share(self._weights or {})

    def comm_seconds(self) -> float:
        """Estimated comm seconds over the recorded steps (the share times
        the measured wall time)."""
        return self.comm_share() * sum(r.duration for r in self.records)

    def mean_step_seconds(self) -> float:
        if not self.records:
            return 0.0
        return sum(r.duration for r in self.records) / len(self.records)

    def summary(self) -> Dict[str, float]:
        out: Dict[str, float] = {
            "steps": float(len(self.records)),
            "mean_step_s": self.mean_step_seconds(),
            "comm_share": self.comm_share(),
            "comm_s": self.comm_seconds(),
        }
        if self._weights:
            for name, w in sorted(self._weights.items()):
                out[f"weight_{name}"] = w
        return out


# ------------------------------------------------- 1F1B reconstruction ----

A2A_BUBBLE = "bubble"                   # the slot is an idle tick
A2A_OVERLAP = "overlap"                 # the slot computes another microbatch
A2A_COLD_START = "cold_start"           # the first unit: nothing to hide it


@dataclass(frozen=True)
class A2ASlot:
    stage: int
    microbatch: int
    tick: int                           # Schedule.a2a_slot(stage, mb)
    status: str                         # A2A_BUBBLE | A2A_OVERLAP | ...

    @property
    def hidden(self) -> bool:
        return self.status in (A2A_BUBBLE, A2A_OVERLAP)


def classify_a2a(sched) -> List[A2ASlot]:
    """One record a (stage, microbatch) forward unit: the tick
    ``Schedule.a2a_slot`` gives its MoE exchange and what that tick holds.
    By the schedule's contract it is never the unit's own tick."""
    out = []
    for s in range(sched.stages):
        for mb in range(sched.microbatches):
            t = sched.a2a_slot(s, mb)
            if t < 0:
                status = A2A_COLD_START
            elif sched.grid[s][t] is None:
                status = A2A_BUBBLE
            else:
                status = A2A_OVERLAP
            out.append(A2ASlot(s, mb, t, status))
    return out


@dataclass(frozen=True)
class PipelineUnit:
    stage: int
    tick: int
    phase: str                          # "F" | "B"
    microbatch: int
    start: float
    duration: float


def reconstruct_grid(sched, start: float, duration: float
                     ) -> List[PipelineUnit]:
    """Lay the 1F1B timetable over a measured step: every occupied
    (stage, tick) becomes a span one tick wide.  The ticks are uniform:
    the schedule's shape (bubbles, warm-up and cool-down) at the step's
    scale, not per-tick times, which the host does not see."""
    tick_s = duration / max(1, sched.ticks)
    units = []
    for s in range(sched.stages):
        for t, unit in enumerate(sched.grid[s]):
            if unit is None:
                continue
            ph, mb = unit
            units.append(PipelineUnit(stage=s, tick=t, phase=ph,
                                      microbatch=mb,
                                      start=start + t * tick_s,
                                      duration=tick_s))
    return units
