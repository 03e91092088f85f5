"""The comm cost model fitted from probe measurements (counterpart of
``repro/tune/model.py``).

The static model (comm/topology.py) prices an all-to-all per hop as
``bytes / bandwidth + messages * latency`` with prior link constants.
``fit_link_constants`` recovers the four constants from measured probe
rows instead: each row is one linear equation

    seconds = bytes_intra * (1/bw_i) + msgs_intra * lat_i
            + bytes_inter * (1/bw_e) + msgs_inter * lat_e

whose coefficients come from the same hop decomposition as the static
model's (``a2a_cost``'s messages and bytes do not depend on the
constants), so ``CalibratedCostModel.apply(topo)`` is the topology with
measured constants behind the same API.

The rows ride along (``measured``): the planner prefers a measured
lookup where the wire model cannot rank (the pipelined overlap), and the
fitted constants otherwise.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np

from repro_torch.comm import topology as topo_lib
from repro_torch.comm.topology import (DEFAULT_INTER_BW, DEFAULT_INTER_LAT,
                                 DEFAULT_INTRA_BW, DEFAULT_INTRA_LAT,
                                 Topology)

# Fit clamps: a noisy least-squares solve can go negative or absurd;
# constants outside these ranges fall back to the static default.
_BW_RANGE = (1e3, 1e15)                 # bytes/s
_LAT_RANGE = (0.0, 1.0)                 # s per message


@dataclass(frozen=True)
class MeasuredRow:
    """One probe measurement (probe.py) / cache row."""
    kind: str                           # "a2a" | "kernel" | "stage"
    name: str                           # transport name or kernel op
    wire_format: str                    # "bf16" | "int8" | "fp8" | "-"
    msg_bytes: int                      # per-rank wire-buffer bytes
    chunks: int                         # pipelined chunk count (1 = n/a)
    seconds: float                      # trimmed-mean wall clock per call

    def to_list(self):
        return [self.kind, self.name, self.wire_format, int(self.msg_bytes),
                int(self.chunks), float(self.seconds)]

    @classmethod
    def from_list(cls, row) -> "MeasuredRow":
        kind, name, fmt, msg, chunks, seconds = row
        return cls(str(kind), str(name), str(fmt), int(msg), int(chunks),
                   float(seconds))


def _hop_coeffs(topo: Topology, axis_name: str, row: MeasuredRow):
    """[bytes_intra, msgs_intra, bytes_inter, msgs_inter] of one probe row
    under the static hop decomposition (constants-independent)."""
    hops = topo_lib.a2a_cost(topo, axis_name, row.msg_bytes, row.name,
                             chunks=row.chunks)
    out = [0.0, 0.0, 0.0, 0.0]
    for h in hops:
        j = 0 if h.hop == "intra" else 2
        out[j] += h.bytes
        out[j + 1] += h.messages
    return out


def fit_link_constants(rows: Iterable[MeasuredRow], topo: Topology,
                       axis_name: str = "model") -> Optional[dict]:
    """Least-squares fit of (intra_bw, intra_lat, inter_bw, inter_lat)
    from bf16 a2a probe rows; None when there is nothing to fit.  Columns
    the probes never exercised (no inter hop on a mesh of one node) keep
    the static defaults."""
    rows = [r for r in rows if r.kind == "a2a" and r.wire_format == "bf16"]
    if not rows:
        return None
    X = np.array([_hop_coeffs(topo, axis_name, r) for r in rows])
    y = np.array([r.seconds for r in rows])
    theta = np.array([1.0 / DEFAULT_INTRA_BW, DEFAULT_INTRA_LAT,
                      1.0 / DEFAULT_INTER_BW, DEFAULT_INTER_LAT])
    cols = [j for j in range(4) if np.any(X[:, j] != 0.0)]
    if cols:
        sol, *_ = np.linalg.lstsq(X[:, cols], y, rcond=None)
        for j, v in zip(cols, sol):
            theta[j] = v
    # Clamp noise-driven nonsense back to the static defaults per constant.
    inv_bw_lo, inv_bw_hi = 1.0 / _BW_RANGE[1], 1.0 / _BW_RANGE[0]
    for j, default in ((0, 1.0 / DEFAULT_INTRA_BW),
                       (2, 1.0 / DEFAULT_INTER_BW)):
        if not (inv_bw_lo <= theta[j] <= inv_bw_hi):
            theta[j] = default
    for j, default in ((1, DEFAULT_INTRA_LAT), (3, DEFAULT_INTER_LAT)):
        theta[j] = default if not np.isfinite(theta[j]) \
            else min(max(theta[j], _LAT_RANGE[0]), _LAT_RANGE[1])
    pred = X @ theta
    residual = float(np.sqrt(np.mean(
        ((pred - y) / np.maximum(y, 1e-12)) ** 2)))
    return {"intra_bw": float(1.0 / theta[0]), "intra_lat": float(theta[1]),
            "inter_bw": float(1.0 / theta[2]), "inter_lat": float(theta[3]),
            "fit_residual": residual, "n_fit_rows": len(rows)}


@dataclass(frozen=True)
class CalibratedCostModel:
    """Measured link constants + the raw probe table they came from."""
    key: str                            # fingerprint key of the source mesh
    intra_bw: float = DEFAULT_INTRA_BW
    inter_bw: float = DEFAULT_INTER_BW
    intra_lat: float = DEFAULT_INTRA_LAT
    inter_lat: float = DEFAULT_INTER_LAT
    fit_residual: float = 0.0
    measured: Tuple[MeasuredRow, ...] = ()

    # -- the topology's constants ----------------------------------------

    def apply(self, topo: Topology) -> Topology:
        """The same topology with measured link constants: everything
        downstream (``a2a_cost``, ``CommPlan.wire_cost``) prices hops with
        them."""
        return dataclasses.replace(
            topo, intra_bw=self.intra_bw, inter_bw=self.inter_bw,
            intra_lat=self.intra_lat, inter_lat=self.inter_lat)

    def seconds(self, topo: Topology, axis_name: str, msg_bytes: float,
                algorithm: str, *, chunks: int = 1) -> float:
        return topo_lib.estimate_seconds(topo_lib.a2a_cost(
            self.apply(topo), axis_name, msg_bytes, algorithm,
            chunks=chunks))

    # -- direct measured lookups -----------------------------------------

    def measured_seconds(self, name: str, msg_bytes: float, *,
                         wire_format: str = "bf16",
                         chunks: Optional[int] = None) -> Optional[float]:
        """Interpolated measured seconds of one a2a leg, or None when the
        probes never ran this (transport, wire_format, chunks).  Linear
        interpolation on the message-size ladder; outside the ladder the
        nearest row is scaled by the byte ratio (bandwidth-dominated
        extrapolation — good enough for ranking)."""
        rows = sorted((r for r in self.measured
                       if r.kind == "a2a" and r.name == name
                       and r.wire_format == wire_format
                       and (chunks is None or r.chunks == chunks)),
                      key=lambda r: r.msg_bytes)
        if not rows:
            return None
        if msg_bytes <= rows[0].msg_bytes:
            return rows[0].seconds * (msg_bytes / max(1, rows[0].msg_bytes)) \
                if msg_bytes < rows[0].msg_bytes else rows[0].seconds
        if msg_bytes >= rows[-1].msg_bytes:
            return rows[-1].seconds * (msg_bytes
                                       / max(1, rows[-1].msg_bytes))
        for lo, hi in zip(rows, rows[1:]):
            if lo.msg_bytes <= msg_bytes <= hi.msg_bytes:
                t = (msg_bytes - lo.msg_bytes) / (hi.msg_bytes
                                                  - lo.msg_bytes)
                return lo.seconds + t * (hi.seconds - lo.seconds)
        return rows[-1].seconds

    def best_chunks(self, msg_bytes: float,
                    candidates: Sequence[int]) -> Optional[int]:
        """Measured-best pipelined chunk count among ``candidates`` —
        None when no pipelined rows were probed (caller keeps its
        configured value)."""
        scored = [(self.measured_seconds("pipelined", msg_bytes, chunks=k),
                   k) for k in candidates]
        scored = [(s, k) for s, k in scored if s is not None]
        return min(scored)[1] if scored else None

    # -- cache (de)serialization -----------------------------------------

    def to_payload(self) -> dict:
        return {"constants": {
                    "intra_bw": self.intra_bw, "inter_bw": self.inter_bw,
                    "intra_lat": self.intra_lat,
                    "inter_lat": self.inter_lat,
                    "fit_residual": self.fit_residual},
                "rows": [r.to_list() for r in self.measured]}

    @classmethod
    def from_payload(cls, key: str, entry: dict) -> "CalibratedCostModel":
        c = entry.get("constants", {})
        rows = tuple(MeasuredRow.from_list(r) for r in entry.get("rows", ()))
        return cls(key=key,
                   intra_bw=float(c.get("intra_bw", DEFAULT_INTRA_BW)),
                   inter_bw=float(c.get("inter_bw", DEFAULT_INTER_BW)),
                   intra_lat=float(c.get("intra_lat", DEFAULT_INTRA_LAT)),
                   inter_lat=float(c.get("inter_lat", DEFAULT_INTER_LAT)),
                   fit_residual=float(c.get("fit_residual", 0.0)),
                   measured=rows)
