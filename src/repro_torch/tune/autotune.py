"""Probe the mesh, fit the cost model, fill the cache and sum up what the
planner will now choose (counterpart of ``repro/tune/autotune.py``).

``autotune(mesh, comm)`` is the entry of ``launch/train.py --autotune``
and of the CLI, ``python -m repro_torch.tune``.  The planner reads the
same data through ``runtime.calibration_for`` (the cache entry), so a
tuning run serves every later process on the same mesh.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

from repro_torch.comm.topology import Topology, build_topology
from repro_torch.obs import events as obs_events
from repro_torch.tune import cache as cache_lib
from repro_torch.tune import probe as probe_lib
from repro_torch.tune.fingerprint import fingerprint_for
from repro_torch.tune.model import CalibratedCostModel, fit_link_constants

log = logging.getLogger(__name__)

DEFAULT_LADDER = (1 << 16, 1 << 19, 1 << 22)


@dataclass(frozen=True)
class TunedChoices:
    """One tuning run in sum: what the planner will now decide."""
    key: str                                     # fingerprint key
    cache_path: str                              # "" when store=False
    model: CalibratedCostModel
    # (msg_bytes -> measured-best transport) per ladder point
    best_transport: Tuple[Tuple[int, str], ...]
    # (msg_bytes -> measured-best pipelined chunk count) per ladder point
    best_chunks: Tuple[Tuple[int, int], ...]
    n_rows: int

    def describe(self) -> str:
        lines = [f"fingerprint {self.key}  ({self.n_rows} probe rows, "
                 f"fit residual {self.model.fit_residual:.2f})",
                 f"  intra: {self.model.intra_bw:.3e} B/s  "
                 f"{self.model.intra_lat * 1e6:.2f} us/msg",
                 f"  inter: {self.model.inter_bw:.3e} B/s  "
                 f"{self.model.inter_lat * 1e6:.2f} us/msg"]
        for msg, name in self.best_transport:
            lines.append(f"  {msg / 2**20:8.2f} MiB -> {name}")
        for msg, k in self.best_chunks:
            lines.append(f"  {msg / 2**20:8.2f} MiB -> overlap_chunks={k}")
        if self.cache_path:
            lines.append(f"  cached: {self.cache_path}")
        return "\n".join(lines)


def _best_per_ladder(calib: CalibratedCostModel, ladder: Sequence[int],
                     chunk_candidates: Sequence[int]):
    """Measured-best transport (and chunk count) per ladder point."""
    transport, chunks = [], []
    for nbytes in ladder:
        scored = []
        for name in ("flat", "hierarchical"):
            s = calib.measured_seconds(name, nbytes)
            if s is not None:
                scored.append((s, name))
        bk = calib.best_chunks(nbytes, chunk_candidates)
        if bk is not None:
            s = calib.measured_seconds("pipelined", nbytes, chunks=bk)
            if s is not None:
                scored.append((s, "pipelined"))
            chunks.append((int(nbytes), int(bk)))
        if scored:
            transport.append((int(nbytes), min(scored)[1]))
    return tuple(transport), tuple(chunks)


def autotune(mesh, comm=None, *, axis_name: str = "model",
             ladder: Sequence[int] = DEFAULT_LADDER,
             wire_formats: Sequence[str] = ("bf16", "int8"),
             chunk_candidates: Sequence[int] = (2, 4),
             warmup: int = 1, iters: int = 5, store: bool = True,
             include_kernels: bool = True,
             topology: Optional[Topology] = None,
             verbose: bool = False, device=None) -> TunedChoices:
    """Probe ``mesh`` (on ``device``: ``probe.probe_device``), fit the
    calibrated cost model, store the cache entry (``store``) and return
    the tuned choices.  Every rank of the mesh calls it; their rows agree
    (probe.py), and each stores the same entry."""
    node = int(getattr(comm, "node_size", 0) or 0)
    topo = topology if topology is not None else build_topology(
        mesh, axis_name=axis_name, node_size=node)
    fp = fingerprint_for(mesh, topo, axis_name)
    log.info("autotune: probing fingerprint %s (axis %r, %s)",
             fp.key(), axis_name, dict(topo.axis_sizes))
    rows = probe_lib.run_probe_suite(
        mesh, topo, axis_name, ladder=tuple(int(b) for b in ladder),
        wire_formats=tuple(wire_formats),
        chunk_candidates=tuple(chunk_candidates), warmup=warmup,
        iters=iters, include_kernels=include_kernels, verbose=verbose,
        device=device)
    for r in rows:
        # "kind" is the event-kind key itself: the row's kind must travel
        # under a different name (emit("...", kind=...) is a TypeError)
        obs_events.emit("tune_probe", row_kind=r.kind, name=r.name,
                        wire_format=r.wire_format,
                        msg_bytes=int(r.msg_bytes), chunks=r.chunks,
                        seconds=float(r.seconds))
    consts = fit_link_constants(rows, topo, axis_name) or {}
    consts.pop("n_fit_rows", None)
    calib = CalibratedCostModel(key=fp.key(), measured=tuple(rows),
                                **consts)
    best_transport, best_chunks = _best_per_ladder(calib, ladder,
                                                   chunk_candidates)
    path = ""
    if not any(r.kind == "a2a" for r in rows):
        # Nothing was measured that could rank a transport (a wire axis of
        # one rank): a stored entry would make the planner report
        # calibrated decisions that no measurement backs.
        log.warning("autotune: no a2a probes ran on this mesh (axis %r "
                    "size %d); not storing a cache entry",
                    axis_name, topo.axis_size(axis_name))
    elif store:
        path = cache_lib.store(fp, calib.to_payload())
    obs_events.emit("tune_result", fingerprint=fp.key(), n_rows=len(rows),
                    cache_path=path,
                    best_transport=[list(t) for t in best_transport],
                    best_chunks=[list(t) for t in best_chunks])
    return TunedChoices(key=fp.key(), cache_path=path, model=calib,
                        best_transport=best_transport,
                        best_chunks=best_chunks, n_rows=len(rows))
