"""The mesh, topology and software facts that key a tuning-cache entry
(counterpart of ``repro/tune/fingerprint.py``).

A probe's measurement carries over only to a mesh that looks the same in
everything it depends on: the platform and device kind, the ranks and
processes, the axis shapes, the wire axis and its node factoring, the
torch build that ran the collectives (with CUDA's and NCCL's versions on
the card), and the probe's payload dtype.  ``key()`` hashes every field,
so a changed field misses; ``diff()`` names the fields that disagree, so
that a rejection says why (cache.py).
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import asdict, dataclass
from typing import List, Tuple

import torch
import torch.distributed as dist

from repro_torch.comm.topology import Topology

SCHEMA_VERSION = 1


@dataclass(frozen=True)
class Fingerprint:
    schema: int
    platform: str                       # "gpu" | "cpu"
    device_kind: str                    # the CUDA device's name, or "cpu"
    n_devices: int                      # the mesh's ranks, one device each
    n_processes: int
    axis_sizes: Tuple[Tuple[str, int], ...]
    axis_name: str                      # the wire axis the probes ran over
    node_size: int                      # node factoring the probes assumed
    torch_version: str                  # torch (+ CUDA, NCCL on the card)
    wire_dtype: str = "bfloat16"        # probe payload dtype

    def key(self) -> str:
        """Stable hash of every field: the cache entry's file stem."""
        blob = json.dumps(self.to_dict(), sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    def to_dict(self) -> dict:
        d = asdict(self)
        d["axis_sizes"] = [list(p) for p in self.axis_sizes]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Fingerprint":
        d = dict(d)
        d["axis_sizes"] = tuple((str(a), int(n)) for a, n in d["axis_sizes"])
        return cls(**d)

    def diff(self, other: "Fingerprint") -> List[str]:
        """Names of the fields where the two disagree."""
        a, b = self.to_dict(), other.to_dict()
        return sorted(k for k in a if a[k] != b.get(k))


def on_card() -> bool:
    """Whether the collectives run on the card: the started group's
    backend is NCCL, or, with none started, a CUDA device exists."""
    if dist.is_initialized():
        return dist.get_backend() == "nccl"
    return torch.cuda.is_available()


def _device_facts(mesh) -> Tuple[str, str, int, int]:
    """(platform, device_kind, n_devices, n_processes)."""
    n_proc = dist.get_world_size() if dist.is_initialized() else 1
    n_dev = 1 if mesh is None else int(mesh.size)
    if on_card():
        return "gpu", torch.cuda.get_device_name(), n_dev, n_proc
    return "cpu", "cpu", n_dev, n_proc


def software_version() -> str:
    v = f"torch {torch.__version__}"
    if on_card():
        v += f", CUDA {torch.version.cuda}, NCCL " + ".".join(
            map(str, torch.cuda.nccl.version()))
    return v


def fingerprint_for(mesh, topo: Topology, axis_name: str = "model", *,
                    wire_dtype: str = "bfloat16") -> Fingerprint:
    """The fingerprint of (mesh, topo): ``topo`` gives the axis shapes and
    the resolved node size, the process the device facts."""
    platform, kind, n_dev, n_proc = _device_facts(mesh)
    return Fingerprint(
        schema=SCHEMA_VERSION, platform=platform, device_kind=kind,
        n_devices=n_dev, n_processes=n_proc,
        axis_sizes=tuple(topo.axis_sizes), axis_name=axis_name,
        node_size=int(topo.node_size), torch_version=software_version(),
        wire_dtype=str(wire_dtype))
