"""Collective planner, flat transport only (counterpart of
``repro/comm/planner.py``).

``plan_collectives`` resolves the transport of a step's MoE exchange once,
in the JAX package's order: an explicit ``CommConfig.a2a_impl`` (anything
but "auto"), else ``$REPRO_COMM_IMPL``, else the static auto rule
(pipelined when ``overlap_chunks`` > 1 divides the slot axis; else
hierarchical when the model axis factors into nodes and the message
clears ``min_hierarchical_bytes``; else flat), then degrades what the
mesh cannot run to flat (an axis of one rank, a bubble without a 1F1B
pipeline, an axis that does not factor, a slot axis the chunks do not
divide).  Where the reference would then run the hierarchical 2-hop, the
chunk-pipelined exchange, the bubble variant or a calibrated ranking
(``CommConfig.tuning`` / ``$REPRO_TUNE``), the port raises: those are
ROADMAP Queue 1 item 3b.  It never runs flat in their place.  With the
default ``CommConfig`` the plan is flat.

``CommPlan``'s methods are the only collectives core/moe.py calls.
"""
from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.comm import collectives
from repro_torch.comm import wire as wire_lib
from repro_torch.configs.base import CommConfig
from repro_torch.runtime import sharding

FLAT = "flat"
HIERARCHICAL = "hierarchical"
PIPELINED = "pipelined"
BUBBLE = "bubble"
AUTO = "auto"
ALGORITHMS = (FLAT, HIERARCHICAL, PIPELINED, BUBBLE)
ENV_VAR = "REPRO_COMM_IMPL"
ENV_TUNE = "REPRO_TUNE"
TUNING_MODES = ("off", "cache", "probe")
LATER = "ROADMAP Queue 1 item 3b"

log = logging.getLogger(__name__)


@dataclass(frozen=True)
class PipelineContext:
    """The fact that a 1F1B pipeline step is being built (the reference's
    ``pipeline_context``), under which its auto rule picks the bubble
    variant."""
    stages: int
    microbatches: int
    bubble_fraction: float


def _validate(name: str) -> str:
    if name not in ALGORITHMS + (AUTO,):
        raise ValueError(f"unknown comm algorithm {name!r}; "
                         f"available: {sorted(ALGORITHMS + (AUTO,))}")
    return name


def tuning_mode(comm: CommConfig) -> str:
    """CommConfig.tuning > $REPRO_TUNE > off."""
    name = comm.tuning or "off"
    if name == "off":
        name = os.environ.get(ENV_TUNE, "") or "off"
    if name not in TUNING_MODES:
        raise ValueError(f"unknown tuning mode {name!r}; "
                         f"available: {sorted(TUNING_MODES)}")
    return name


def _factor(r: int, node_size: int):
    """(inter, intra) of an axis of ``r`` ranks at ``node_size`` a node;
    (1, r) when it fits in a node or the node size does not divide it."""
    if node_size <= 1 or node_size >= r or r % node_size:
        return 1, r
    return r // node_size, node_size


@dataclass(frozen=True)
class CommPlan:
    """The resolved transport of a step's collectives: flat, over the
    mesh's process groups (``mesh`` None: one card, every collective the
    identity)."""
    algorithm: str
    axis_name: str
    reason: str
    mesh: object = None

    @property
    def degraded(self) -> bool:
        return self.reason.startswith("degraded")

    @property
    def group(self):
        return sharding.group(self.mesh, self.axis_name)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """Differentiable all-to-all of x [R, ...] over the wire axis."""
        return collectives.all_to_all(x, self.group)

    def leaf_transports(self):
        """(fwd, bwd) movers of one wire leaf (comm/wire.py)."""
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
        wire tensor send [R, e_local, c, H]; with a codec each leg encodes
        in transit (comm/wire.py), without one the tensor moves as is."""
        if codec is not None:
            fwd, bwd = self.leaf_transports()
            return wire_lib.coded_moe_exchange(send, compute_fn, codec, fwd,
                                               bwd)
        return self.all_to_all(compute_fn(self.all_to_all(send)))


def flat_plan(axis_name: str = "model", mesh=None) -> CommPlan:
    """An always-flat plan (one card, tests)."""
    return CommPlan(FLAT, axis_name, reason="flat_plan()", mesh=mesh)


def _node_size(mesh, comm: CommConfig) -> int:
    """CommConfig.node_size > $REPRO_NODE_SIZE > the mesh's hint."""
    n = int(comm.node_size)
    if n <= 0:
        n = int(os.environ.get("REPRO_NODE_SIZE", "0") or 0)
    if n <= 0 and mesh is not None:
        n = int(getattr(mesh, "node_size", 0))
    return n


def plan_collectives(mesh=None, comm: Optional[CommConfig] = None, *,
                     axis_name: str = "model", msg_bytes: int = 0,
                     chunk_extent: int = 0,
                     pipeline: Optional[PipelineContext] = None) -> CommPlan:
    """Resolve the transport of this step's exchange over ``axis_name``
    (module docstring).  ``msg_bytes`` is one rank's wire buffer (the
    scales sidecar included), ``chunk_extent`` the slot axis a pipelined
    exchange would chunk, ``pipeline`` the 1F1B step being built, if
    any.  Raises NotImplementedError where the reference would run a
    transport other than flat."""
    comm = comm or CommConfig()
    if tuning_mode(comm) != "off":
        raise NotImplementedError(
            f"the calibrated planner (tuning={tuning_mode(comm)!r}) is "
            f"{LATER}")
    pipelining = pipeline is not None and pipeline.stages > 1 \
        and pipeline.microbatches > 1
    r = sharding.axis_size(mesh, axis_name)
    inter, _ = _factor(r, _node_size(mesh, comm))
    can_factor = inter > 1

    requested = _validate(comm.a2a_impl or AUTO)
    reason = f"config a2a_impl={requested!r}"
    if requested == AUTO:
        requested = _validate(os.environ.get(ENV_VAR, AUTO) or AUTO)
        reason = f"${ENV_VAR}={requested!r}"
    chunks = max(1, int(comm.overlap_chunks))
    chunkable = chunks > 1 and chunk_extent > 0 \
        and chunk_extent % chunks == 0
    if requested == AUTO:
        if pipelining and r > 1:
            requested, reason = BUBBLE, "auto: a 1F1B pipeline is active"
        elif chunkable:
            requested, reason = PIPELINED, \
                f"auto: overlap_chunks={chunks} divides slot axis"
        elif can_factor and msg_bytes >= comm.min_hierarchical_bytes:
            requested, reason = HIERARCHICAL, (
                f"auto: axis factors and msg {msg_bytes}B >= "
                f"{comm.min_hierarchical_bytes}B")
        else:
            requested, reason = FLAT, "auto: no hierarchy/overlap to exploit"

    if r <= 1 and requested != FLAT:
        requested, reason = FLAT, f"degraded: axis {axis_name!r} has size 1"
    elif requested == BUBBLE and not pipelining:
        requested, reason = FLAT, (
            "degraded: bubble-overlapped a2a requested without an active "
            "1F1B pipeline")
    elif requested == HIERARCHICAL and not can_factor:
        requested, reason = FLAT, (
            f"degraded: axis {axis_name!r} (size {r}) does not factor")
    elif requested == PIPELINED and not chunkable:
        requested, reason = FLAT, (
            f"degraded: overlap_chunks={chunks} cannot chunk slot axis of "
            f"{chunk_extent}")
    if requested != FLAT:
        raise NotImplementedError(
            f"the {requested} all-to-all ({reason}) is {LATER}; the port "
            "runs the flat transport only")
    if reason.startswith("degraded"):
        log.warning("comm planner: %s -> running flat", reason)
    return CommPlan(FLAT, axis_name, reason=reason, mesh=mesh)
