"""The model axis's node factoring and the per-hop wire cost model
(counterpart of ``repro/comm/topology.py``).

A mesh names its axes but not the links that carry them.  ``Topology``
adds the one physical fact the planner needs: how many ranks along the
wire axis share a node (the fast intra-node links), so that an axis of R
ranks factors as

    R = inter * intra        (ranks node-major: rank = node * intra + local)

and its all-to-all can run as an intra-node hop followed by an
inter-node hop of fewer, larger messages (comm/hierarchical.py).

Node size, first hit wins:
  1. ``CommConfig.node_size``,
  2. ``$REPRO_NODE_SIZE``,
  3. the mesh's ``node_size`` (launch/mesh.py: the ``make_mesh`` argument,
     else torchrun's LOCAL_WORLD_SIZE when the mesh spans several hosts).

The cost model is the reference's, term for term: per hop
``bytes / bandwidth + messages * latency``, for ranking transports, not
for absolute times.  Its link constants below are priors for an H100 SXM
node with one InfiniBand NIC per GPU; a tuning-cache entry
(tune/model.py) replaces all four with fitted ones.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Tuple

# Link constants (bytes/s, s).  Priors; the calibrated model replaces them.
# NVLink 4 of the H100 SXM: 900 GB/s per GPU in both directions together
# (NVIDIA H100 Tensor Core GPU datasheet), so 450 GB/s each way.
DEFAULT_INTRA_BW = 4.5e11
# One NDR InfiniBand port a GPU (NVIDIA ConnectX-7 datasheet: 400 Gb/s),
# 50 GB/s each way.
DEFAULT_INTER_BW = 5.0e10
# No datasheet states a time per message.  These priors assume a few us
# for one NCCL message over NVLink and about ten us over an RDMA NIC.
DEFAULT_INTRA_LAT = 3e-6
DEFAULT_INTER_LAT = 1e-5

ENV_NODE_SIZE = "REPRO_NODE_SIZE"


@dataclass(frozen=True)
class Topology:
    """Axis sizes, ranks a node along the wire axis, and link constants."""
    axis_sizes: Tuple[Tuple[str, int], ...]
    node_size: int = 0                  # 0: unknown, nothing factors
    intra_bw: float = DEFAULT_INTRA_BW
    inter_bw: float = DEFAULT_INTER_BW
    intra_lat: float = DEFAULT_INTRA_LAT
    inter_lat: float = DEFAULT_INTER_LAT

    def axis_size(self, name: str) -> int:
        return dict(self.axis_sizes).get(name, 1)

    def factor(self, axis_name: str) -> Tuple[int, int]:
        """(inter, intra) of the axis; (1, R) when it fits in a node or
        the node size does not divide it."""
        return factor(self.axis_size(axis_name), self.node_size)

    def can_factor(self, axis_name: str) -> bool:
        return self.factor(axis_name)[0] > 1


def factor(r: int, node_size: int) -> Tuple[int, int]:
    """(inter, intra) of an axis of ``r`` ranks at ``node_size`` a node."""
    n = int(node_size)
    if n <= 1 or n >= r or r % n:
        return 1, r
    return r // n, n


def resolve_node_size(mesh, node_size: int = 0) -> int:
    """``node_size`` (the CommConfig's) > $REPRO_NODE_SIZE > the mesh's."""
    n = int(node_size)
    if n <= 0:
        n = int(os.environ.get(ENV_NODE_SIZE, "0") or 0)
    if n <= 0 and mesh is not None:
        n = int(getattr(mesh, "node_size", 0))
    return n


def build_topology(mesh, *, axis_name: str = "model",
                   node_size: int = 0) -> Topology:
    """The topology of ``mesh`` (None: one card), node size resolved as
    above; ``node_size`` is the CommConfig's (0 falls through)."""
    names = ("data", "model") if mesh is None else mesh.axis_names
    sizes = tuple((a, 1 if mesh is None else int(mesh.axis_size(a)))
                  for a in names)
    return Topology(axis_sizes=sizes,
                    node_size=resolve_node_size(mesh, node_size))


# ------------------------------------------------------------ cost model --

@dataclass(frozen=True)
class HopCost:
    hop: str                            # "intra" | "inter"
    messages: int                       # per-rank message count
    bytes: float                        # per-rank bytes over this hop
    seconds: float = field(default=0.0)


def _hop(topo: Topology, hop: str, messages: int, nbytes: float) -> HopCost:
    bw = topo.intra_bw if hop == "intra" else topo.inter_bw
    lat = topo.intra_lat if hop == "intra" else topo.inter_lat
    return HopCost(hop, messages, nbytes,
                   seconds=messages * lat + nbytes / bw)


def a2a_cost(topo: Topology, axis_name: str, msg_bytes: float,
             algorithm: str, *, chunks: int = 1) -> Tuple[HopCost, ...]:
    """Per-rank, per-hop cost of one all-to-all of a ``msg_bytes`` local
    buffer over ``axis_name``.

      flat          (R-1) direct messages of msg/R bytes; the (R-intra)
                    off-node ones cross the slow link.
      hierarchical  an intra a2a over ``intra`` ranks, then an inter a2a
                    over ``inter`` ranks: the slow link carries (inter-1)
                    large messages instead of (R-intra) small ones.
      pipelined     flat, every message split K ways: the same bytes, K
                    times the messages (the overlap it buys is not a wire
                    cost).
      bubble        priced as its base transport.
    """
    r = topo.axis_size(axis_name)
    if r <= 1:
        return ()
    inter, intra = topo.factor(axis_name)
    k = max(1, chunks) if algorithm == "pipelined" else 1
    if algorithm == "hierarchical" and inter > 1:
        return (_hop(topo, "intra", (intra - 1),
                     msg_bytes * (intra - 1) / intra),
                _hop(topo, "inter", (inter - 1),
                     msg_bytes * (inter - 1) / inter))
    on_node = min(intra, r) - 1
    off_node = r - 1 - on_node
    hops = [_hop(topo, "intra", on_node * k, msg_bytes * on_node / r)]
    if off_node:
        hops.append(_hop(topo, "inter", off_node * k,
                         msg_bytes * off_node / r))
    return tuple(h for h in hops if h.messages > 0)


def stage_transfer_cost(topo: Topology, msg_bytes: float,
                        axis_name: str = "pipe") -> Tuple[HopCost, ...]:
    """Per-rank cost of one stage-boundary hand-off over the pipeline
    axis: one message to the next stage, over the slow link unless the
    whole axis fits in a node."""
    r = topo.axis_size(axis_name)
    if r <= 1:
        return ()
    hop = "intra" if 0 < r <= topo.node_size else "inter"
    return (_hop(topo, hop, 1, float(msg_bytes)),)


def estimate_seconds(costs: Tuple[HopCost, ...]) -> float:
    return sum(c.seconds for c in costs)
