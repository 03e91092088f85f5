"""A (data, model) mesh of ``torch.distributed`` process groups
(counterpart of ``repro/launch/mesh.py``).

Axes, as in the JAX package:
  data   data parallelism and FSDP of the expert weights;
  model  expert parallelism: the MoE all-to-all runs over it, and the
         residual stream between blocks is sharded over it by sequence.

Ranks are laid out row-major over the mesh shape, as the JAX package's
``devs.reshape(shape)`` lays out devices: rank = d * model + m.  A group
is made for every slice of every axis of more than one rank, on every
rank in the same order (``dist.new_group`` is collective), and one for
the whole mesh; an axis of one rank has no group, and the collectives
treat a missing group as the identity (comm/collectives.py).

Where the node size factors the model axis (1 < intra < model, intra
divides it), ``make_mesh`` also builds the 2-hop's subgroups
(comm/hierarchical.py), for each data index: the intra-node groups, then
the inter-node groups of ranks with one local index
(``comm.hierarchical.intra_groups`` / ``inter_groups``).  ``Mesh.hop_groups``
returns this rank's pair, and builds those of another node size (a
``CommConfig.node_size`` or ``$REPRO_NODE_SIZE`` that differs from the
mesh's) on first use.

``init_distributed`` starts the default group.  The device picks the
backend, as it picks the kernels: NCCL for a CUDA device, gloo for the
CPU.  With no store it reads torchrun's environment (``env://``).

``spawn_cpu_ranks`` / ``run_cpu_rank`` run a script on several local CPU
ranks that meet through a ``FileStore`` (no TCP port), as the multi-rank
tests do.
"""
from __future__ import annotations

import datetime
import math
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.comm.hierarchical import inter_groups, intra_groups
from repro_torch.comm.topology import factor

AXES = ("data", "model")


def backend_for(device: torch.device) -> str:
    """NCCL for a CUDA device, gloo for the CPU; a CUDA device without
    NCCL raises (there is no fallback to gloo)."""
    if device.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("a CUDA device needs the NCCL backend, and "
                               "this torch build has none")
        return "nccl"
    if device.type == "cpu":
        return "gloo"
    raise ValueError(f"unsupported device {device}; use 'cuda' or 'cpu'")


def init_distributed(device: torch.device, *, store=None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     timeout_s: Optional[float] = None) -> None:
    """Start the default process group for ``device`` (a no-op when it is
    already started).  ``store`` (a ``dist.Store``, for example a
    ``FileStore``) needs ``rank`` and ``world_size``; without one the
    group rendezvous through torchrun's environment.  A CUDA device is
    made the current one first.  ``timeout_s`` bounds a collective's wait
    (torch's default when None)."""
    if dist.is_initialized():
        return
    backend = backend_for(device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    kw = {} if timeout_s is None else {
        "timeout": datetime.timedelta(seconds=timeout_s)}
    if store is not None:
        if rank is None or world_size is None:
            raise ValueError("a store needs rank and world_size")
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world_size, **kw)
    else:
        dist.init_process_group(backend, init_method="env://", **kw)


class Mesh:
    """A (data, model) mesh: its shape, this rank's coordinates and the
    process groups of this rank's slices.

    ``Mesh(shape)`` alone describes a mesh without groups (what the
    planner and the shape checks read); ``make_mesh`` builds the groups
    of a started default group."""

    axis_names: Tuple[str, ...] = AXES

    def __init__(self, shape: Tuple[int, int], *, rank: int = 0,
                 groups: Optional[Dict[Tuple[str, ...], object]] = None,
                 node_size: int = 0):
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.size = math.prod(self.shape.values())
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = rank
        self.coords = dict(zip(self.axis_names,
                               (rank // self.shape["model"],
                                rank % self.shape["model"])))
        self._groups = dict(groups or {})
        self._hops: Dict[int, Tuple[object, object]] = {}
        self.node_size = int(node_size)

    def axis_size(self, name: str) -> int:
        return self.shape.get(name, 1)

    def axis_index(self, name: str) -> int:
        return self.coords.get(name, 0)

    def group(self, axes) -> object:
        """The process group over ``axes`` (a name or a tuple of names)
        holding this rank; None when it has one rank."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return self._groups.get(tuple(a for a in self.axis_names
                                      if a in axes))

    def hop_groups(self, intra: int) -> Tuple[object, object]:
        """This rank's (intra-node, inter-node) subgroups of the model axis
        at ``intra`` ranks a node (comm/hierarchical.py).  Those of the
        mesh's own node size are built by ``make_mesh``.  Another node
        size's are built on its first use and kept: ``dist.new_group`` is
        collective, so every rank must ask for them at the same point, as
        every rank does when it plans the same layer."""
        if intra not in self._hops:
            if not self._groups or not dist.is_initialized():
                raise RuntimeError(f"{self!r} has no process groups; the "
                                   "2-hop needs a mesh from make_mesh")
            self._hops[intra] = _new_hop_groups(self.shape, self.rank,
                                                intra)
        return self._hops[intra]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def _slices(shape: Dict[str, int], axes: Tuple[str, ...]):
    """The rank lists of every slice over ``axes``, in a fixed order."""
    names = list(shape)
    fixed = [a for a in names if a not in axes]
    out = []
    for fixed_idx in _product([range(shape[a]) for a in fixed]):
        pin = dict(zip(fixed, fixed_idx))
        ranks = []
        for free_idx in _product([range(shape[a]) for a in axes]):
            c = {**pin, **dict(zip(axes, free_idx))}
            ranks.append(c["data"] * shape["model"] + c["model"])
        out.append(ranks)
    return out


def _product(ranges):
    if not ranges:
        yield ()
        return
    for i in ranges[0]:
        for rest in _product(ranges[1:]):
            yield (i,) + rest


def _new_hop_groups(shape: Dict[str, int], rank: int, intra: int
                    ) -> Tuple[object, object]:
    """Make every 2-hop subgroup of the mesh (collective: every rank, in
    one order) and return this rank's (intra, inter) pair."""
    m = shape["model"]
    if factor(m, intra)[0] == 1:
        raise ValueError(f"{intra} ranks a node do not factor a model "
                         f"axis of {m}")
    mine = [None, None]
    for d in range(shape["data"]):
        for hop, lists in enumerate((intra_groups(m, intra),
                                     inter_groups(m, intra))):
            for local in lists:
                ranks = [d * m + r for r in local]
                g = dist.new_group(ranks)
                if rank in ranks:
                    mine[hop] = g
    return mine[0], mine[1]


def make_mesh(data: int = 1, model: int = 1, pipe: int = 1, *,
              node_size: int = 0) -> Mesh:
    """The (data, model) mesh over the started default group, whose size
    must be data * model.  ``node_size`` is the ranks a node holds (0:
    torchrun's LOCAL_WORLD_SIZE when the mesh spans several hosts), for
    the planner; where it factors the model axis, the 2-hop's subgroups
    are built too.  ``pipe`` > 1 raises: pipeline stages are ROADMAP Queue 1
    item 6."""
    if int(pipe) > 1:
        raise NotImplementedError(
            "a pipe axis (pipeline parallelism) is not ported (ROADMAP "
            "Queue 1 item 6)")
    shape = {"data": int(data), "model": int(model)}
    world = dist.get_world_size() if dist.is_initialized() else 1
    if math.prod(shape.values()) != world:
        raise ValueError(f"mesh {shape} needs {math.prod(shape.values())} "
                         f"ranks; the default group has {world}")
    rank = dist.get_rank() if dist.is_initialized() else 0
    groups: Dict[Tuple[str, ...], object] = {}
    for axes in (("data",), ("model",), AXES):
        if math.prod(shape[a] for a in axes) == 1:
            continue
        if axes == AXES:
            groups[axes] = dist.group.WORLD
            continue
        for ranks in _slices(shape, axes):
            g = dist.new_group(ranks)       # collective: every rank, in order
            if rank in ranks:
                groups[axes] = g
    if node_size <= 0:
        # ranks a host holds, when the mesh spans several hosts
        local = int(os.environ.get("LOCAL_WORLD_SIZE", "0") or 0)
        node_size = local if 0 < local < world else 0
    mesh = Mesh((shape["data"], shape["model"]), rank=rank, groups=groups,
                node_size=node_size)
    if factor(shape["model"], node_size)[0] > 1:
        mesh.hop_groups(node_size)
    return mesh


# ------------------------------------------------- local CPU ranks --

def spawn_cpu_ranks(script: str, world: int, args: Sequence[str], *,
                    store: str, env: Optional[dict] = None,
                    timeout_s: float = 600.0) -> List[str]:
    """Run ``python script RANK WORLD STORE *args`` for every rank at once
    and wait for all; returns each rank's standard output.  If a rank
    fails, the others are stopped and the failing rank's standard error
    is raised."""
    logs = [tempfile.TemporaryFile(mode="w+") for _ in range(2 * world)]
    procs = [subprocess.Popen(
        [sys.executable, script, str(r), str(world), store, *args],
        stdout=logs[2 * r], stderr=logs[2 * r + 1], env=env, text=True)
        for r in range(world)]
    deadline = time.monotonic() + timeout_s
    try:
        while any(p.poll() is None for p in procs):
            bad = [p for p in procs if p.returncode not in (None, 0)]
            if bad or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for f in logs:
        f.seek(0)
        outs.append(f.read())
        f.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} of {world} exited with "
                               f"{p.returncode}:\n{outs[2 * r + 1][-4000:]}")
    return outs[0::2]


def run_cpu_rank(argv: Sequence[str], main, timeout_s: float = 300.0):
    """In a rank ``spawn_cpu_ranks`` started: read RANK WORLD STORE from
    ``argv``, start the gloo group through the FileStore, return
    ``main(rank, world, the remaining arguments)``, and take the group
    down on every rank together (a rank that exits with gloo's threads
    still up aborts)."""
    rank, world, store = int(argv[0]), int(argv[1]), argv[2]
    init_distributed(torch.device("cpu"),
                     store=dist.FileStore(store, world), rank=rank,
                     world_size=world, timeout_s=timeout_s)
    try:
        return main(rank, world, list(argv[3:]))
    finally:
        dist.barrier()
        dist.destroy_process_group()
