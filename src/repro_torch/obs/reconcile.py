"""Modeled against measured: per-phase error, ``model_drift`` events, and
the stale-calibration signal for ``tune/`` (counterpart of
``repro/obs/reconcile.py``).

``timeline.model_phase_seconds`` predicts seconds per phase (analytic
FLOPs at the H100's peak and the possibly calibrated comm cost model);
``profile.parse_torch_trace`` measures them from the device trace.
``reconcile`` diffs the two on both axes:

 * **absolute seconds** per phase: how wrong the model's clock is (it
   prices every FLOP at the datasheet peak, so its clock runs fast), and
 * **normalized shares**: whether the model splits the step in the right
   proportions even when its clock is off.  The share error decides
   staleness: a calibrated comm model whose all-to-all share drifted
   ranks the transports wrongly whatever the clock.

Comm drift above ``stale_threshold`` recommends a re-probe:
``record_stale_calibration`` writes the report into the mesh's tuning-
cache entry (``tune.cache.record_drift``), which ``tune/runtime`` reports
as ``tune_stale`` on the next load and ``ensure_calibrated`` re-probes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.obs import events as obs_events
from repro_torch.obs.timeline import COMM_PHASES, PHASE_ORDER

_EPS = 1e-12

# A phase must hold at least this share (modeled or measured) before its
# relative error counts — errors on ~0% phases are noise, not drift.
MIN_SHARE = 0.01
# Per-phase share drift worth a model_drift event.
PHASE_DRIFT_THRESHOLD = 0.25
# Comm-share drift past this recommends re-probing the mesh.
STALE_THRESHOLD = 0.5


@dataclass(frozen=True)
class PhaseDrift:
    """One phase's modeled-vs-measured disagreement."""
    phase: str
    modeled_s: float
    measured_s: float
    modeled_share: float
    measured_share: float

    @property
    def abs_err_s(self) -> float:
        return self.modeled_s - self.measured_s

    @property
    def rel_err(self) -> float:
        """Relative error of absolute seconds against the measurement."""
        return (self.modeled_s - self.measured_s) \
            / max(self.measured_s, _EPS)

    @property
    def share_err(self) -> float:
        """Symmetric relative error of the normalized shares — scale
        (clock) invariant, in [0, 1] by the max-normalization."""
        hi = max(self.modeled_share, self.measured_share)
        if hi <= _EPS:
            return 0.0
        return abs(self.modeled_share - self.measured_share) / hi

    @property
    def significant(self) -> bool:
        return max(self.modeled_share, self.measured_share) >= MIN_SHARE


@dataclass(frozen=True)
class DriftReport:
    phases: Tuple[PhaseDrift, ...]
    drift_score: float              # share-weighted mean share_err
    comm_drift: float               # same, over the comm phases only
    comm_share_modeled: float
    comm_share_measured: float
    clock_ratio: float              # modeled step s / measured step s
    stale: bool                     # comm_drift > stale threshold

    def phase(self, name: str) -> Optional[PhaseDrift]:
        for p in self.phases:
            if p.phase == name:
                return p
        return None

    def to_metrics(self) -> Dict[str, float]:
        """Flat scalars for metrics.json (the reconciliation export)."""
        out = {
            "model_drift_score": self.drift_score,
            "model_comm_drift": self.comm_drift,
            "model_clock_ratio": self.clock_ratio,
            "model_stale": float(self.stale),
            "comm_share_modeled": self.comm_share_modeled,
            "comm_share_measured": self.comm_share_measured,
        }
        for p in self.phases:
            out[f"model_err_{p.phase}"] = p.share_err
        return out

    def to_payload(self) -> Dict:
        """The cache-entry drift record (tune.cache.record_drift)."""
        return {
            "drift_score": self.drift_score,
            "comm_drift": self.comm_drift,
            "comm_share_modeled": self.comm_share_modeled,
            "comm_share_measured": self.comm_share_measured,
            "clock_ratio": self.clock_ratio,
            "reprobe_recommended": self.stale,
            "phases": {p.phase: {"modeled_s": p.modeled_s,
                                 "measured_s": p.measured_s,
                                 "share_err": p.share_err}
                       for p in self.phases},
        }


def _shares(seconds: Dict[str, float]) -> Dict[str, float]:
    total = sum(max(0.0, v) for v in seconds.values())
    if total <= 0.0:
        return {k: 0.0 for k in seconds}
    return {k: max(0.0, v) / total for k, v in seconds.items()}


def reconcile(modeled: Dict[str, float], measured: Dict[str, float], *,
              stale_threshold: float = STALE_THRESHOLD) -> DriftReport:
    """Per-phase modeled-vs-measured error over the union of phases,
    share-weighted into one drift score (and a comm-only score that
    drives the stale-calibration recommendation)."""
    m_share = _shares(modeled)
    x_share = _shares(measured)
    phases = []
    for name in PHASE_ORDER:
        if name not in modeled and name not in measured:
            continue
        phases.append(PhaseDrift(
            phase=name,
            modeled_s=float(modeled.get(name, 0.0)),
            measured_s=float(measured.get(name, 0.0)),
            modeled_share=m_share.get(name, 0.0),
            measured_share=x_share.get(name, 0.0)))

    def weighted(sel) -> float:
        rows = [(max(p.modeled_share, p.measured_share), p.share_err)
                for p in phases if sel(p) and p.significant]
        wsum = sum(w for w, _ in rows)
        if wsum <= 0.0:
            return 0.0
        return sum(w * e for w, e in rows) / wsum

    comm_m = sum(p.modeled_share for p in phases if p.phase in COMM_PHASES)
    comm_x = sum(p.measured_share for p in phases if p.phase in COMM_PHASES)
    modeled_total = sum(max(0.0, v) for v in modeled.values())
    measured_total = sum(max(0.0, v) for v in measured.values())
    comm_drift = weighted(lambda p: p.phase in COMM_PHASES)
    return DriftReport(
        phases=tuple(phases),
        drift_score=weighted(lambda p: True),
        comm_drift=comm_drift,
        comm_share_modeled=comm_m,
        comm_share_measured=comm_x,
        clock_ratio=modeled_total / max(measured_total, _EPS),
        stale=comm_drift > stale_threshold)


def emit_drift_events(report: DriftReport, *,
                      step: Optional[int] = None) -> None:
    """One ``model_drift`` summary event, plus one per phase whose share
    drifted past ``PHASE_DRIFT_THRESHOLD``."""
    obs_events.emit(
        "model_drift", step=step, phase="*",
        drift_score=report.drift_score, comm_drift=report.comm_drift,
        comm_share_modeled=report.comm_share_modeled,
        comm_share_measured=report.comm_share_measured,
        clock_ratio=report.clock_ratio, stale=report.stale)
    for p in report.phases:
        if p.significant and p.share_err > PHASE_DRIFT_THRESHOLD:
            obs_events.emit(
                "model_drift", step=step, phase=p.phase,
                modeled_s=p.modeled_s, measured_s=p.measured_s,
                modeled_share=p.modeled_share,
                measured_share=p.measured_share,
                share_err=p.share_err, stale=report.stale)


def record_stale_calibration(mesh, comm, report: DriftReport, *,
                             axis_name: str = "model") -> Optional[str]:
    """Write ``report`` into the mesh's tune-cache entry so the
    calibration reports itself stale.  Returns the
    entry path, or None when there is no entry to annotate (an
    uncalibrated run has nothing to go stale)."""
    from repro_torch.comm.topology import build_topology
    from repro_torch.tune import cache as tune_cache
    from repro_torch.tune.fingerprint import fingerprint_for
    node = int(getattr(comm, "node_size", 0) or 0)
    topo = build_topology(mesh, axis_name=axis_name, node_size=node)
    fp = fingerprint_for(mesh, topo, axis_name)
    return tune_cache.record_drift(fp, report.to_payload())
