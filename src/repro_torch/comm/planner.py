"""Collective planner (counterpart of ``repro/comm/planner.py``).

``plan_collectives`` resolves the transport of a step's MoE exchange once
a layer call, in the reference's order:
  1. an explicit ``CommConfig.a2a_impl`` (anything but "auto"),
  2. ``$REPRO_COMM_IMPL``,
  3. the auto rule.  With a matching tuning-cache entry
     (``CommConfig.tuning`` > ``$REPRO_TUNE`` > off; tune/) it ranks the
     transports the mesh can run by measured time (the probe's rows where
     that leg was timed, the fitted link constants otherwise) and takes
     the measured-best pipelined chunk count.  Without one (tuning off, a
     miss, another fingerprint) the static rule: pipelined when
     ``overlap_chunks`` > 1 divides the slot axis; else hierarchical when
     the model axis factors into nodes and the message clears
     ``min_hierarchical_bytes``; else flat.
Inside a 1F1B pipeline (``pipeline``) the auto rule picks the bubble
variant, which rides the 1F1B schedule of ROADMAP Queue 1 item 6 and so
raises here.  What the mesh cannot run then degrades to flat (an axis of
one rank, a bubble without a pipeline, an axis that does not factor, a
slot axis the chunks do not divide); ``CommPlan.reason`` says why, a
``comm_plan`` event (obs/events.py) reports each change, and
``last_plan`` keeps the latest plan of each axis.

``CommPlan``'s methods are the only collectives core/moe.py calls.  They
run over the mesh's process groups: the model axis's group for the flat
and pipelined transports, its 2-hop subgroups (``Mesh.hop_groups``) for
the hierarchical one.  ``mesh`` None is one card: every collective is the
identity.
"""
from __future__ import annotations

import dataclasses
import logging
import os
from dataclasses import dataclass
from typing import Callable, Optional

import torch
from torch.profiler import record_function

from repro_torch.comm import collectives
from repro_torch.comm import topology as topo_lib
from repro_torch.comm import wire as wire_lib
from repro_torch.comm.hierarchical import (hierarchical_all_to_all,
                                           hierarchical_moe_exchange)
from repro_torch.comm.pipeline import (pipelined_all_to_all,
                                       pipelined_moe_exchange)
from repro_torch.comm.topology import Topology, build_topology
from repro_torch.configs.base import CommConfig
from repro_torch.obs import events as obs_events
from repro_torch.runtime import sharding

FLAT = "flat"
HIERARCHICAL = "hierarchical"
PIPELINED = "pipelined"
BUBBLE = "bubble"
AUTO = "auto"
ALGORITHMS = (FLAT, HIERARCHICAL, PIPELINED, BUBBLE)
ENV_VAR = "REPRO_COMM_IMPL"
LATER = "ROADMAP Queue 1 item 6"

# Codes of the per-step comm metrics, as the reference's.
WIRE_FORMAT_IDS = {None: -1, "bf16": 0, "int8": 1, "fp8": 2}

log = logging.getLogger(__name__)

_LAST_PLANS: dict = {}


def last_plan(axis_name: str = "model") -> Optional["CommPlan"]:
    """The latest resolution for the axis."""
    return _LAST_PLANS.get(axis_name)


@dataclass(frozen=True)
class PipelineContext:
    """The fact that a 1F1B pipeline step is being built (the reference's
    ``pipeline_context``), under which its auto rule picks the bubble
    variant."""
    stages: int
    microbatches: int
    bubble_fraction: float


def algorithm_name(i: int) -> str:
    return ALGORITHMS[i] if 0 <= int(i) < len(ALGORITHMS) else "unplanned"


def wire_format_name(i: int) -> str:
    names = {v: k for k, v in WIRE_FORMAT_IDS.items() if k is not None}
    return names.get(int(i), "raw")


def describe_comm_metrics(algorithm, degraded=0, calibrated=0,
                          wire_format=-1) -> str:
    """A step's comm metrics in words, e.g. 'hierarchical+cal/int8'."""
    s = algorithm_name(int(algorithm))
    if int(degraded):
        s += "(degraded)"
    if int(calibrated):
        s += "+cal"
    return f"{s}/{wire_format_name(int(wire_format))}"


@dataclass(frozen=True)
class CommPlan:
    """The resolved transport of a step's collectives."""
    algorithm: str                      # one of ALGORITHMS (post-degrade)
    axis_name: str                      # the wire axis ("model")
    intra: int                          # ranks a node (hierarchical)
    chunks: int                         # slot chunks (pipelined)
    reason: str                         # how and why it was picked
    topology: Topology                  # calibrated link constants when
    #                                     a tuning-cache entry matched
    calibrated: bool = False
    base: str = ""                      # transport a BUBBLE plan rides
    mesh: object = None

    @property
    def degraded(self) -> bool:
        return self.reason.startswith("degraded")

    @property
    def transport(self) -> str:
        """The transport that moves the bytes (a bubble plan's base)."""
        if self.algorithm == BUBBLE:
            return self.base or FLAT
        return self.algorithm

    @property
    def group(self):
        return sharding.group(self.mesh, self.axis_name)

    @property
    def hop_groups(self):
        """This rank's (intra, inter) 2-hop subgroups."""
        return self.mesh.hop_groups(self.intra)

    # -- collectives -------------------------------------------------------

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """Differentiable planned all-to-all of x [R, ...] over the wire
        axis; a tensor the planned chunks cannot slice moves flat."""
        if self.transport == HIERARCHICAL:
            return hierarchical_all_to_all(x, self.hop_groups)
        if self.transport == PIPELINED and x.ndim > 2 \
                and x.shape[2] % self.chunks == 0:
            return pipelined_all_to_all(x, self.group, self.chunks)
        return collectives.all_to_all(x, self.group)

    def leaf_transports(self):
        """(fwd, bwd) movers of one wire leaf for the fused codec
        transfers (comm/wire.py): flat or 2-hop.  The pipelined transport
        slices the float tensor before it encodes, so fused callers gate
        on ``transport != PIPELINED`` and take ``moe_exchange``."""
        if self.transport == HIERARCHICAL:
            return wire_lib.hierarchical_leaves(self.hop_groups)
        return wire_lib.flat_leaves(self.group)

    def all_gather(self, x: torch.Tensor, axis_name: str,
                   axis: int) -> torch.Tensor:
        """Tiled all-gather over ``axis_name`` (the FSDP weight gathers);
        transpose: the reduce-scatter of the gradients."""
        return collectives.all_gather(x, sharding.group(self.mesh,
                                                        axis_name), axis)

    def reduce_scatter(self, x: torch.Tensor, axis_name: str,
                       axis: int) -> torch.Tensor:
        return collectives.reduce_scatter(x, sharding.group(self.mesh,
                                                            axis_name), axis)

    def moe_exchange(self, send: torch.Tensor, compute_fn: Callable,
                     codec: Optional[wire_lib.WireCodec] = None
                     ) -> torch.Tensor:
        """dispatch all-to-all -> compute_fn -> combine all-to-all of the
        wire tensor send [R, e_local, c, H]; compute_fn maps a received
        tensor (or slot chunk, pipelined) to the same shape.  With a
        codec each leg encodes in transit (comm/wire.py), each chunk on
        its own when pipelined; without one the tensor moves as is.  The
        legs run under the profiler ranges "dispatch" and "combine"."""
        if self.transport == PIPELINED:
            return pipelined_moe_exchange(
                send, compute_fn, self.group, self.chunks,
                transfer=None if codec is None
                else wire_lib.transfer_fn(codec, self.group))
        if codec is None and self.transport == HIERARCHICAL:
            return hierarchical_moe_exchange(send, compute_fn,
                                             self.hop_groups)
        if codec is not None:
            fwd, bwd = self.leaf_transports()

            def leg(v):
                return wire_lib.coded_transfer(v, codec, fwd, bwd)
        else:
            def leg(v):
                return collectives.all_to_all(v, self.group)
        with record_function("dispatch"):
            recv = leg(send)
        out = compute_fn(recv)
        with record_function("combine"):
            return leg(out)

    # -- diagnostics -------------------------------------------------------

    def wire_cost(self, msg_bytes: float):
        """Modeled per-hop cost of one planned all-to-all (a bubble plan
        priced as its base)."""
        return topo_lib.a2a_cost(self.topology, self.axis_name, msg_bytes,
                                 self.transport, chunks=self.chunks)


def flat_plan(axis_name: str = "model", mesh=None) -> CommPlan:
    """An always-flat plan (one card, tests)."""
    return CommPlan(FLAT, axis_name, intra=1, chunks=1,
                    reason="flat_plan()",
                    topology=Topology(axis_sizes=((axis_name, 1),)),
                    mesh=mesh)


def _validate(name: str) -> str:
    if name not in ALGORITHMS + (AUTO,):
        raise ValueError(f"unknown comm algorithm {name!r}; "
                         f"available: {sorted(ALGORITHMS + (AUTO,))}")
    return name


def _lookup_calibration(mesh, topo, comm, axis_name):
    """The tuning cache's entry for this mesh (None unless tuning is on
    and an entry matches its fingerprint)."""
    from repro_torch.tune import runtime as tune_runtime
    return tune_runtime.calibration_for(mesh, topo, comm, axis_name)


def _ranked_seconds(calib, topo, axis_name, msg_bytes, algorithm, *,
                    chunks: int = 1) -> float:
    """The probe's time where this leg was timed; the fitted link
    constants' otherwise."""
    s = calib.measured_seconds(
        algorithm, msg_bytes,
        chunks=chunks if algorithm == PIPELINED else None)
    if s is None:
        s = topo_lib.estimate_seconds(topo_lib.a2a_cost(
            topo, axis_name, msg_bytes, algorithm, chunks=chunks))
    return s


def _chunk_candidates(cfg_chunks: int, chunk_extent: int):
    return [k for k in sorted({cfg_chunks, 2, 4, 8})
            if k > 1 and chunk_extent > 0 and chunk_extent % k == 0]


def _tuned_chunks(calib, topo, axis_name, msg_bytes, chunk_extent,
                  cfg_chunks: int) -> int:
    """The measured-best chunk count among the divisors; the configured
    one when the probe timed none of them."""
    best = calib.best_chunks(msg_bytes,
                             _chunk_candidates(cfg_chunks, chunk_extent))
    return best if best is not None else cfg_chunks


def _auto_calibrated(calib, topo, axis_name, msg_bytes, cfg_chunks,
                     chunk_extent):
    """Rank every transport the mesh can run by measured (else fitted)
    time.  Pipelined competes only when overlap was configured: the wire
    cost cannot price the overlap, so without measured rows its K times
    the messages lose to flat."""
    cands = {FLAT: (_ranked_seconds(calib, topo, axis_name, msg_bytes,
                                    FLAT), 1)}
    if topo.can_factor(axis_name):
        cands[HIERARCHICAL] = (_ranked_seconds(
            calib, topo, axis_name, msg_bytes, HIERARCHICAL), 1)
    if cfg_chunks > 1:
        ks = _chunk_candidates(cfg_chunks, chunk_extent)
        scored = [(_ranked_seconds(calib, topo, axis_name, msg_bytes,
                                   PIPELINED, chunks=k), k) for k in ks]
        if scored:
            cands[PIPELINED] = min(scored)
    name = min(cands, key=lambda n: cands[n][0])
    ranked = " ".join(f"{n}={cands[n][0] * 1e6:.0f}us"
                      for n in sorted(cands))
    return name, f"auto(calibrated {calib.key[:8]}): {ranked}", \
        cands[name][1]


def plan_collectives(mesh=None, comm: Optional[CommConfig] = None, *,
                     axis_name: str = "model", msg_bytes: int = 0,
                     chunk_extent: int = 0,
                     pipeline: Optional[PipelineContext] = None,
                     topology: Optional[Topology] = None,
                     calibration=None) -> CommPlan:
    """Resolve the transport of this step's exchange over ``axis_name``
    (module docstring).  ``msg_bytes`` is one rank's wire buffer (the
    scales sidecar included), ``chunk_extent`` the slot axis a pipelined
    exchange would chunk, ``pipeline`` the 1F1B step being built, if
    any.  ``topology`` replaces the mesh's (its node size still yields
    to ``comm.node_size``) and ``calibration`` (a
    ``tune.model.CalibratedCostModel``) the cache lookup.  Raises
    NotImplementedError where the bubble variant would run."""
    comm = comm or CommConfig()
    topo = topology if topology is not None else build_topology(
        mesh, axis_name=axis_name, node_size=comm.node_size)
    if topology is not None and comm.node_size:
        topo = dataclasses.replace(topo, node_size=comm.node_size)
    calib = calibration if calibration is not None \
        else _lookup_calibration(mesh, topo, comm, axis_name)
    if calib is not None:
        # the same topology with measured link constants: every cost
        # downstream prices calibrated
        topo = calib.apply(topo)
    pipelining = pipeline is not None and pipeline.stages > 1 \
        and pipeline.microbatches > 1

    requested = _validate(comm.a2a_impl or AUTO)
    reason = f"config a2a_impl={requested!r}"
    if requested == AUTO:
        requested = _validate(os.environ.get(ENV_VAR, AUTO) or AUTO)
        reason = f"${ENV_VAR}={requested!r}"
    chunks = max(1, int(comm.overlap_chunks))
    if requested == AUTO:
        if pipelining and topo.axis_size(axis_name) > 1:
            requested, reason = BUBBLE, (
                f"auto: a2a of microbatch k issues in the 1F1B bubble of "
                f"k-1 (stages={pipeline.stages}, "
                f"microbatches={pipeline.microbatches})")
        elif calib is not None:
            requested, reason, chunks = _auto_calibrated(
                calib, topo, axis_name, msg_bytes, chunks, chunk_extent)
        elif chunks > 1 and chunk_extent > 0 \
                and chunk_extent % chunks == 0:
            requested, reason = PIPELINED, \
                f"auto: overlap_chunks={chunks} divides slot axis"
        elif topo.can_factor(axis_name) \
                and msg_bytes >= comm.min_hierarchical_bytes:
            requested, reason = HIERARCHICAL, (
                f"auto: axis factors {topo.factor(axis_name)} and "
                f"msg {msg_bytes}B >= {comm.min_hierarchical_bytes}B")
        else:
            requested, reason = FLAT, "auto: no hierarchy/overlap to exploit"
    elif requested == PIPELINED and calib is not None:
        tuned = _tuned_chunks(calib, topo, axis_name, msg_bytes,
                              chunk_extent, chunks)
        if tuned != chunks:
            reason += f"; tuned overlap_chunks {chunks}->{tuned}"
            chunks = tuned

    # -- degrade whatever cannot run on this mesh to flat -----------------
    r = topo.axis_size(axis_name)
    inter, intra = topo.factor(axis_name)
    chunkable = chunks > 1 and chunk_extent > 0 \
        and chunk_extent % chunks == 0
    if r <= 1 and requested != FLAT:
        requested, reason = FLAT, f"degraded: axis {axis_name!r} has size 1"
    elif requested == BUBBLE and not pipelining:
        requested, reason = FLAT, (
            "degraded: bubble-overlapped a2a requested without an active "
            "1F1B pipeline (no pipe axis, 1 stage, or 1 microbatch)")
    elif requested == HIERARCHICAL and not topo.can_factor(axis_name):
        requested, reason = FLAT, (
            f"degraded: axis {axis_name!r} (size {r}) does not factor at "
            f"node_size={topo.node_size}")
    elif requested == PIPELINED and not chunkable:
        requested, reason = FLAT, (
            f"degraded: overlap_chunks={chunks} cannot chunk slot axis "
            f"of {chunk_extent}")
    if requested == BUBBLE:
        raise NotImplementedError(
            f"the bubble-overlapped all-to-all ({reason}) rides the 1F1B "
            f"schedule, {LATER}")
    if reason.startswith("degraded"):
        # comm/pipeline.py raises on chunkings that do not divide, so the
        # plan is where a mis-sized request is rescued: say so
        log.warning("comm planner: %s -> running flat", reason)
    plan = CommPlan(algorithm=requested, axis_name=axis_name, intra=intra,
                    chunks=chunks if requested == PIPELINED else 1,
                    reason=reason, topology=topo,
                    calibrated=calib is not None, mesh=mesh)
    _emit_plan_event(axis_name, plan, msg_bytes)
    _LAST_PLANS[axis_name] = plan
    return plan


def _emit_plan_event(axis_name: str, plan: CommPlan, msg_bytes: int) -> None:
    """A ``comm_plan`` event when the plan of the axis changes (each layer
    call plans, and the same plan again is not news)."""
    prev = _LAST_PLANS.get(axis_name)
    ident = (plan.algorithm, plan.reason, plan.chunks, plan.calibrated,
             plan.base)
    if prev is not None and ident == (prev.algorithm, prev.reason,
                                      prev.chunks, prev.calibrated,
                                      prev.base):
        return
    obs_events.emit("comm_plan", axis=axis_name, algorithm=plan.algorithm,
                    degraded=plan.degraded, calibrated=plan.calibrated,
                    chunks=plan.chunks, base=plan.base,
                    msg_bytes=int(msg_bytes), reason=plan.reason)
