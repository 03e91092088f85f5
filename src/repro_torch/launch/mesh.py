"""A ([pod,] data, [pipe,] model) mesh of ``torch.distributed`` process
groups (counterpart of ``repro/launch/mesh.py``).

Axes, as in the JAX package:
  pod    data parallelism across pods (the 512-rank production mesh):
         the batch splits over (pod, data), the params are whole over it;
         left out when it has one rank;
  data   data parallelism and FSDP of every split weight
         (runtime/params.py);
  pipe   the 1F1B pipeline's stage axis (runtime/pipeline_schedule.py),
         left out when it has one rank, so that such a mesh is the
         (data, model) mesh it was before, groups and rank numbers alike;
  model  expert and tensor parallelism: the MoE all-to-all runs over
         it, heads / FFN hidden / vocabulary split over it, and the
         residual stream between blocks is sharded over it by sequence.

Ranks are laid out row-major over the mesh shape, as the JAX package's
``devs.reshape(shape)`` lays out devices: rank = ((o * data + d) * pipe
+ p) * model + m.  A group is made for every slice of every axis of more
than one rank, on every rank in the same order (``dist.new_group`` is
collective), one for each slice of every other set of the non-pipe axes
(the (data, model) slice of each pipe index; with a pod axis, the sets
a gradient is summed over, runtime/step.py), and one for the whole mesh;
an axis of one rank has no group, and the collectives treat a missing
group as the identity (comm/collectives.py).
The pipe axis partitions the schedule, not the placement: the ranks of
one pipe column hold the same params and the same rows and compute the
same thing, so a step's reductions run over its (data, model) slice
(``runtime.sharding.all_group``), never over ``pipe``.

Where the node size factors the model axis (1 < intra < model, intra
divides it), ``make_mesh`` also builds the 2-hop's subgroups
(comm/hierarchical.py), for each (data, pipe) index: the intra-node
groups, then the inter-node groups of ranks with one local index
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
import itertools
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
PIPE_AXES = ("data", "pipe", "model")

# An HGX H100 host holds 8 cards on NVLink: the fast intra-node domain the
# 2-hop all-to-all exploits (the JAX package's v5e host holds 4 chips).
H100_GPUS_PER_HOST = 8


def mesh_dims(data: int, pipe: int, model: int, pod: int = 1):
    """(shape, axes) with the pipe axis left out at pipe == 1 (the JAX
    ``_mesh_dims``) and the pod axis in front where pod > 1."""
    pipe, pod = max(1, int(pipe)), max(1, int(pod))
    if pipe > 1:
        shape, axes = (int(data), pipe, int(model)), PIPE_AXES
    else:
        shape, axes = (int(data), int(model)), AXES
    if pod > 1:
        shape, axes = (pod,) + shape, ("pod",) + axes
    return shape, axes


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
    """A (data, model) or (data, pipe, model) mesh: its shape, this rank's
    coordinates and the process groups of this rank's slices.

    ``Mesh(shape)`` alone describes a mesh without groups (what the
    planner and the shape checks read); a shape of three sizes has a pipe
    axis unless ``axes`` names them.  ``make_mesh`` builds the groups of
    a started default group."""

    def __init__(self, shape: Tuple[int, ...], *, rank: int = 0,
                 groups: Optional[Dict[Tuple[str, ...], object]] = None,
                 node_size: int = 0, axes: Optional[Tuple[str, ...]] = None):
        shape = tuple(int(s) for s in shape)
        self.axis_names: Tuple[str, ...] = tuple(axes) if axes else \
            PIPE_AXES if len(shape) == 3 else AXES
        self.shape = dict(zip(self.axis_names, shape))
        self.size = math.prod(self.shape.values())
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = rank
        self.coords = _coords(self.shape, rank)
        self._groups = dict(groups or {})
        self._hops: Dict[int, Tuple[object, object]] = {}
        self._unit = None
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

    def tp_group(self) -> object:
        """The group runtime/tp.py's collectives run over: the model
        axis's, or where that axis holds one rank, a group of this rank
        alone, so that the tensor-parallel path makes its calls on every
        mesh.  The one-rank groups are built on first use, one for each
        rank of the world in rank order (``dist.new_group`` is
        collective: every rank reaches its first tensor-parallel call at
        the same point of the same program)."""
        if self.axis_size("model") > 1:
            return self.group("model")
        if self._unit is None:
            if not dist.is_initialized():
                raise RuntimeError("the tensor-parallel path needs a "
                                   "started default process group")
            me = dist.get_rank()
            for r in range(dist.get_world_size()):
                g = dist.new_group([r])
                if r == me:
                    self._unit = g
        return self._unit

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


def _coords(shape: Dict[str, int], rank: int) -> Dict[str, int]:
    """A rank's coordinates in the row-major layout of ``shape``."""
    out = {}
    for a in reversed(list(shape)):
        rank, out[a] = divmod(rank, shape[a])
    return {a: out[a] for a in shape}


def _rank(shape: Dict[str, int], coords: Dict[str, int]) -> int:
    r = 0
    for a in shape:
        r = r * shape[a] + coords[a]
    return r


def _slices(shape: Dict[str, int], axes: Tuple[str, ...]):
    """The rank lists of every slice over ``axes``, in a fixed order."""
    names = list(shape)
    fixed = [a for a in names if a not in axes]
    out = []
    for fixed_idx in _product([range(shape[a]) for a in fixed]):
        pin = dict(zip(fixed, fixed_idx))
        ranks = []
        for free_idx in _product([range(shape[a]) for a in axes]):
            ranks.append(_rank(shape, {**pin, **dict(zip(axes, free_idx))}))
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
    for column in _slices(shape, ("model",)):   # one a (pod, data, pipe)
        for hop, lists in enumerate((intra_groups(m, intra),
                                     inter_groups(m, intra))):
            for local in lists:
                ranks = [column[r] for r in local]
                g = dist.new_group(ranks)
                if rank in ranks:
                    mine[hop] = g
    return mine[0], mine[1]


def _axis_sets(names: Tuple[str, ...]) -> List[Tuple[str, ...]]:
    """The sets of axes that get groups, in the order they are made: each
    axis, then every other set of the non-pipe axes (larger first), then
    the whole mesh."""
    flat = [a for a in names if a != "pipe"]
    sets = [(a,) for a in names]
    for k in range(len(flat), 1, -1):
        for combo in itertools.combinations(flat, k):
            if combo != names:
                sets.append(combo)
    return sets + [names]


def make_mesh(data: int = 1, model: int = 1, pipe: int = 1, *,
              pod: int = 1, node_size: int = 0) -> Mesh:
    """The mesh over the started default group, whose size must be
    pod * data * pipe * model: (data, model), with ``pipe`` > 1 (data,
    pipe, model), with ``pod`` > 1 the pod axis in front.  ``node_size``
    is the ranks a node holds (0: torchrun's LOCAL_WORLD_SIZE when the
    mesh spans several hosts), for the planner; where it factors the
    model axis, the 2-hop's subgroups are built too."""
    dims, names = mesh_dims(data, pipe, model, pod)
    shape = dict(zip(names, dims))
    world = dist.get_world_size() if dist.is_initialized() else 1
    if math.prod(dims) != world:
        raise ValueError(f"mesh {shape} needs {math.prod(dims)} ranks; the "
                         f"default group has {world}")
    rank = dist.get_rank() if dist.is_initialized() else 0
    groups: Dict[Tuple[str, ...], object] = {}
    for axes in _axis_sets(names):
        if math.prod(shape[a] for a in axes) == 1:
            continue
        if axes == names:
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
    mesh = Mesh(dims, rank=rank, groups=groups, node_size=node_size,
                axes=names)
    if factor(shape["model"], node_size)[0] > 1:
        mesh.hop_groups(node_size)
    return mesh


def make_production_mesh(*, multi_pod: bool = False, pipe: int = 1,
                         node_size: int = H100_GPUS_PER_HOST) -> Mesh:
    """The JAX package's production mesh over the started default group:
    one pod is 16 x 16 = 256 ranks (data, model), two are 2 x 16 x 16 =
    512 (pod, data, model); ``pipe`` > 1 carves the stage axis out of
    ``data``, (16 / pipe, pipe, 16).  ``node_size`` ranks a host (an HGX
    H100 holds 8) factor the model axis for the 2-hop all-to-all."""
    pipe = max(1, int(pipe))
    if 16 % pipe:
        raise ValueError(f"pipe={pipe} must divide the data dimension (16)")
    return make_mesh(16 // pipe, 16, pipe, pod=2 if multi_pod else 1,
                     node_size=node_size)


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
