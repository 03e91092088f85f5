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

The 1F1B grid reconstruction of the JAX module (``classify_a2a``,
``reconstruct_grid``) needs the pipeline schedule, ROADMAP Queue 1 item
6, and waits for it.
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
                        device_flops: float = DEVICE_FLOPS
                        ) -> Dict[str, float]:
    """Modeled seconds per phase of one training step of ``cfg`` on
    ``mesh`` (None: one card), the JAX function's terms: the step is
    6 x active params x tokens FLOPs over the mesh's peak; the
    all-to-all legs price the true wire bytes (scales sidecar included)
    through the planner's cost model (``CommPlan.wire_cost``); gate, hash,
    expert MLP and decompress their analytic FLOPs.  Call it after the
    first step, so that ``comm.planner.last_plan()`` is the step's."""
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
