"""Roofline terms of one rank's program, counted op by op as eager PyTorch
runs it (counterpart of ``repro/launch/hlo_analysis.py`` and
``repro/launch/hlo_structural.py``, which read them from the compiled
SPMD HLO).

``CostMode`` is a ``TorchDispatchMode``: every op the rank's program
dispatches passes through it (on meta tensors, over a fake process
group, launch/dryrun.py), so there is no fusion to see through
and no loop to multiply, every layer being traced:

  FLOPs       the matmul-family and attention ops by
              ``torch.utils.flop_counter``'s formulas (their sum,
              ``aten_flops``, is what its ``FlopCounterMode`` counts: the
              cross-check JAX takes from XLA's cost analysis); the eleven
              ``repro_torch`` kernel ops (kernels/build.register_op) by
              the operation counts their bounds use in ``chip_smoke.py``
              (``KERNEL_OPS``: every routed entry kept, every slot in
              range, since a meta tensor holds no data); other ops none.
  bytes       each op's input plus output bytes, an input read once; views
              and allocations move none; a ``repro_torch`` op is one op
              with its inputs and outputs, what its kernel reads and
              writes.  Collectives are counted on the wire, not here.
  collectives read at the c10d ops the fake group runs, each priced by
              JAX's ring formulas (``wire_bytes``) on its group's size,
              and at the link its group crosses: NVLink within a node of
              ``node_size`` ranks, the inter-node rate across
              (comm/topology.py).  The reduce-scatter of
              comm/collectives.py runs as an all-to-all of the addends;
              it is labelled there and counted as the reduce-scatter it
              is (the same wire bytes).
  memory      the bytes of every storage an op makes, alive until its
              last tensor dies, each rounded up to the CUDA caching
              allocator's 512-byte blocks: ``temp_bytes`` is their peak
              above the arguments (the state and batch, made before the
              mode starts).

``Roofline`` prices them at hw.py's H100 SXM constants and gives JAX's
keys (``to_dict``).
"""
from __future__ import annotations

import math
import weakref
from collections import Counter
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch import hw
from repro_torch.comm import collectives, topology

PEAK_FLOPS = hw.DEVICE_FLOPS
HBM_BW = hw.HBM_BYTES_PER_S
ALLOC_BLOCK = 512          # the CUDA caching allocator's rounding

# c10d op -> the collective it is (receives are the other end of a send)
_C10D = {"alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
         "_allgather_base_": "all-gather", "allgather_": "all-gather",
         "allgather_into_tensor_coalesced_": "all-gather",
         "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
         "_reduce_scatter_base_": "reduce-scatter",
         "reduce_scatter_": "reduce-scatter",
         "reduce_scatter_tensor_coalesced_": "reduce-scatter",
         "send": "collective-permute", "recv_": None, "barrier": None}

_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "detach", "alias", "lift_fresh",
             "_local_scalar_dense", "set_", "resize_", "record_stream"}


def wire_bytes(kind: str, result_bytes: float, g: int) -> float:
    """Per-rank wire bytes of one collective by JAX's ring formulas
    (``repro/launch/hlo_analysis.py``, ``parse_collectives``), its result
    of ``result_bytes`` a rank over a group of ``g``: all-gather out (g -
    1) / g (out the gathered result), reduce-scatter out (g - 1) (out the
    scattered shard), all-reduce 2 size (g - 1) / g, all-to-all size (g -
    1) / g, collective-permute size."""
    if g <= 1:
        return 0.0
    if kind == "all-gather":
        return result_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return result_bytes * (g - 1)
    if kind == "all-reduce":
        return 2 * result_bytes * (g - 1) / g
    if kind == "all-to-all":
        return result_bytes * (g - 1) / g
    if kind == "collective-permute":
        return float(result_bytes)
    raise ValueError(f"unknown collective {kind!r}")


def _n(t) -> int:
    return math.prod(t.shape)


# the operations each kernel op does, as chip_smoke.py's bounds count them
# (args: the op's arguments; out: its outputs as a tuple)
KERNEL_OPS: Dict[str, Callable] = {
    "positions_in_expert": lambda a, out: 0,
    "dispatch_scatter": lambda a, out: _n(a[2]),                 # F H adds
    "combine_gather": lambda a, out: _n(out[0]),                 # F H
    "lsh_hash": lambda a, out: 2 * a[0].shape[0] * a[0].shape[1]
    * a[1].shape[0] * a[1].shape[2],                             # 2 T H L Dr
    "segment_centroid": lambda a, out: _n(a[1]),                 # G C H
    "residual_apply": lambda a, out: _n(out[0]),                 # G C H
    "wire_quantize": lambda a, out: 4 * _n(a[0]),
    "wire_dequantize": lambda a, out: _n(a[0]),
    "dispatch_scatter_quantize": lambda a, out: _n(a[2])
    + 4 * _n(out[0]),                                            # F H + 4 ECH
    "dequantize_combine_gather": lambda a, out: 2 * _n(out[0]),
    "dequantize_residual_apply": lambda a, out:
    (3 if a[4] is not None else 2) * _n(out[0]),
}


def _nbytes(t: torch.Tensor) -> int:
    return _n(t) * t.element_size()


def rounded(n: int) -> int:
    return -(-n // ALLOC_BLOCK) * ALLOC_BLOCK


@dataclass
class OpStats:
    calls: int = 0
    flops: float = 0.0
    bytes: float = 0.0


class CostMode(TorchDispatchMode):
    """Count one rank's program (module docstring).  ``node_size`` ranks
    a node decide the link each group crosses."""

    def __init__(self, node_size: int = 8):
        super().__init__()
        self.node_size = max(1, int(node_size))
        self.flops = 0.0
        self.aten_flops = 0.0
        self.bytes = 0.0
        self.kernels: Dict[str, OpStats] = {}
        self.coll_counts: Counter = Counter()
        self.coll_result: Counter = Counter()
        self.coll_wire: Counter = Counter()
        self.collective_s = 0.0
        self.op_bytes: Counter = Counter()
        self.live = 0
        self.peak = 0
        self._sizes: Dict[int, int] = {}
        self._groups: Dict[int, tuple] = {}

    # ---------------------------------------------------------- memory --
    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._sizes:
            return
        n = rounded(st.nbytes())
        self._sizes[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key, 0)

    # ----------------------------------------------------- collectives --
    def _group(self, pg) -> tuple:
        """(size, crosses nodes) of a c10d op's process group."""
        pg = dist.ProcessGroup.unbox(pg) \
            if isinstance(pg, torch.ScriptObject) else pg
        got = self._groups.get(id(pg))
        if got is None:
            ranks = dist.get_process_group_ranks(pg)
            nodes = {r // self.node_size for r in ranks}
            got = self._groups[id(pg)] = (len(ranks), len(nodes) > 1, pg)
        return got[:2]

    def _collective(self, name: str, args, out) -> None:
        kind = _C10D.get(name, "?")
        if kind is None:
            return
        if kind == "?":
            raise NotImplementedError(f"c10d op {name} is not counted")
        label = collectives.current_label()
        pg = next(a for a in args if isinstance(a, torch.ScriptObject)
                  or isinstance(a, dist.ProcessGroup))
        g, across = self._group(pg)
        tensors = [t for t in tree_flatten(args)[0]
                   if isinstance(t, torch.Tensor)]
        if kind == "all-to-all":
            size = _nbytes(tensors[0])            # the output, as the input
            if label == "reduce-scatter":
                kind, size = label, size // g     # the scattered shard
        elif kind in ("all-gather", "reduce-scatter"):
            size = _nbytes(tensors[0])            # the output
        else:                                     # all-reduce, send: in place
            size = sum(_nbytes(t) for t in tensors)
        wire = wire_bytes(kind, size, g)
        self.coll_counts[kind] += 1
        self.coll_result[kind] += size
        self.coll_wire[kind] += wire
        self.collective_s += wire / (topology.DEFAULT_INTER_BW if across
                                     else topology.DEFAULT_INTRA_BW)

    # -------------------------------------------------------- dispatch --
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns, name = func.namespace, func._opname
        if ns == "c10d":
            self._collective(name, args, out)
            return out
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        ins = {id(t): t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)}
        # a view or an in-place result holds an input's storage: not new
        held = {id(t.untyped_storage()) for t in ins.values()}
        for t in outs:
            if id(t.untyped_storage()) not in held:
                self._track(t)
        if not outs or func.is_view or name in _NO_BYTES:
            return out                    # metadata, a view, an allocation
        moved = sum(_nbytes(t) for t in ins.values())
        moved += sum(_nbytes(t) for t in outs)
        self.bytes += moved
        self.op_bytes[f"{ns}.{name}"] += moved
        if ns == "repro_torch":
            st = self.kernels.setdefault(name, OpStats())
            ops = KERNEL_OPS[name](args, tuple(outs))
            st.calls += 1
            st.flops += ops
            st.bytes += moved
            self.flops += ops
        elif func.overloadpacket in flop_registry:
            flops = flop_registry[func.overloadpacket](*args, **kwargs,
                                                       out_val=out)
            self.flops += flops
            self.aten_flops += flops
        return out


@dataclass
class Roofline:
    """The JAX ``Roofline``'s terms, from a ``CostMode``; the collective
    term is each collective's wire bytes over the rate of the link its
    group crosses."""
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float
    collectives: Dict[str, float]
    collective_counts: Dict[str, int]
    collective_s: float
    arg_bytes: int
    temp_bytes: int
    output_bytes: int
    xla_flops: float = 0.0          # the aten FLOPs alone (a cross-check)
    xla_bytes: float = 0.0
    kernels: Dict[str, Dict] = field(default_factory=dict)
    top_bytes: Dict[str, float] = field(default_factory=dict)

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def to_dict(self) -> Dict:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "wire_bytes_per_device": self.wire_bytes_per_device,
            "collectives": dict(self.collectives),
            "collective_counts": dict(self.collective_counts),
            "arg_bytes": self.arg_bytes,
            "temp_bytes": self.temp_bytes,
            "output_bytes": self.output_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "xla_flops": self.xla_flops,
            "xla_bytes": self.xla_bytes,
            "kernels": self.kernels,
            "top_bytes": self.top_bytes,
        }


def roofline(mode: CostMode, *, arg_bytes: int, output_bytes: int
             ) -> Roofline:
    """The ``Roofline`` of a finished ``CostMode`` run (the arguments made
    before it started)."""
    return Roofline(
        flops_per_device=mode.flops, bytes_per_device=mode.bytes,
        wire_bytes_per_device=float(sum(mode.coll_wire.values())),
        collectives={k: float(v) for k, v in mode.coll_wire.items()},
        collective_counts=dict(mode.coll_counts),
        collective_s=mode.collective_s, arg_bytes=int(arg_bytes),
        temp_bytes=int(mode.peak),
        output_bytes=int(output_bytes), xla_flops=mode.aten_flops,
        xla_bytes=mode.bytes,
        kernels={k: {"calls": v.calls, "flops": v.flops, "bytes": v.bytes}
                 for k, v in sorted(mode.kernels.items())},
        top_bytes={k: float(v) for k, v in mode.op_bytes.most_common(8)})


def tree_bytes(tree, alloc: bool = False,
               device: Optional[str] = None) -> int:
    """The bytes of the distinct storages of the tensors in ``tree`` (a
    pytree of dicts, lists and NamedTuples); ``alloc``: each rounded to the
    allocator's blocks; ``device`` only those on a device of that type."""
    seen, total = set(), 0
    for t in tree_flatten(tree)[0]:
        if not isinstance(t, torch.Tensor) or (
                device is not None and t.device.type != device):
            continue
        st = t.untyped_storage()
        if id(st) in seen:
            continue
        seen.add(id(st))
        total += rounded(st.nbytes()) if alloc else st.nbytes()
    return total
