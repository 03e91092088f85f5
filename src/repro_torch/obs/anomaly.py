"""Rolling-window statistical anomaly detection over step metrics
(counterpart of ``repro/obs/anomaly.py``).

The resilience layer reacts to *hard* failures (hangs, corrupt shards,
NaN grads); this module catches the *soft* ones — the run that silently
got 40% slower after a link flap, the comm share that crept up when a
cache entry went stale, the loss spike a bad batch leaves behind, the
one device that is persistently the straggler.  Each detector keeps a
bounded rolling window of host-side scalars (nothing here is traced)
and emits a typed ``anomaly`` event when its statistic trips:

  ==================  ====================================================
  detector            fires when
  ==================  ====================================================
  step_time_regression  step time exceeds ``threshold x`` the rolling
                        median of recent steps (after warmup)
  comm_ratio_drift      the rolling mean of the live comm share deviates
                        from its frozen early-run baseline by more than
                        ``rel_threshold`` (relative)
  loss_spike            loss is non-finite, or beyond ``z x`` the robust
                        (median/MAD) spread of the window
  load_imbalance        the metric exceeds ``threshold`` for
                        ``consecutive`` steps in a row
  persistent_straggler  >= ``count`` straggler-flagged steps inside the
                        window (the StragglerMonitor flags individual
                        steps; this catches the *pattern*)
  ==================  ====================================================

``AnomalyMonitor`` owns a set of detectors, feeds them the per-step
signal dict, emits the events, and fans every anomaly out to registered
consumers — ``resilience.supervisor.AnomalyEscalator`` is the stock
consumer that converts a persistent pattern into a watchdog-style exit
the restart supervisor classifies.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.obs import events as obs_events


@dataclass(frozen=True)
class Anomaly:
    """One detector firing.  ``severity`` is the dimensionless trip
    ratio (value vs baseline / threshold), >= 1.0 when fired."""
    detector: str
    step: int
    metric: str
    value: float
    baseline: float
    severity: float
    message: str

    def to_event_data(self) -> Dict:
        return {"detector": self.detector, "metric": self.metric,
                "value": self.value, "baseline": self.baseline,
                "severity": self.severity, "message": self.message}


class _Window:
    """Bounded rolling window with the robust stats detectors need."""

    def __init__(self, size: int):
        self.size = int(size)
        self._q: deque = deque(maxlen=self.size)

    def push(self, v: float) -> None:
        self._q.append(float(v))

    def __len__(self) -> int:
        return len(self._q)

    def mean(self) -> float:
        return sum(self._q) / len(self._q) if self._q else 0.0

    def median(self) -> float:
        if not self._q:
            return 0.0
        s = sorted(self._q)
        n = len(s)
        mid = n // 2
        return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])

    def mad(self) -> float:
        """Median absolute deviation (robust spread)."""
        if not self._q:
            return 0.0
        med = self.median()
        devs = sorted(abs(v - med) for v in self._q)
        n = len(devs)
        mid = n // 2
        return devs[mid] if n % 2 else 0.5 * (devs[mid - 1] + devs[mid])


class Detector:
    """Base: ``observe(step, value)`` returns an Anomaly or None."""

    name = "detector"
    metric = ""

    def observe(self, step: int, value: float) -> Optional[Anomaly]:
        raise NotImplementedError


class StepTimeRegression(Detector):
    """Step time vs rolling median.  The current sample is compared
    BEFORE it enters the window, and a fired sample is clamped to the
    threshold (the StragglerMonitor lesson: one hang must not inflate
    the baseline and mask the next)."""

    name = "step_time_regression"

    def __init__(self, metric: str = "step_time", *, window: int = 20,
                 warmup: int = 3, threshold: float = 1.5,
                 min_samples: int = 5):
        self.metric = metric
        self.warmup = int(warmup)
        self.threshold = float(threshold)
        self.min_samples = int(min_samples)
        self._win = _Window(window)
        self._seen = 0

    def observe(self, step: int, value: float) -> Optional[Anomaly]:
        self._seen += 1
        if self._seen <= self.warmup:       # compile-dominated steps
            return None
        baseline = self._win.median()
        fired = (len(self._win) >= self.min_samples
                 and value > self.threshold * baseline)
        self._win.push(min(value, self.threshold * baseline)
                       if fired else value)
        if not fired:
            return None
        return Anomaly(
            detector=self.name, step=step, metric=self.metric,
            value=value, baseline=baseline,
            severity=value / max(baseline * self.threshold, 1e-12),
            message=(f"{self.metric} {value:.3g}s > {self.threshold:.2f}x "
                     f"rolling median {baseline:.3g}s"))


class DriftDetector(Detector):
    """Rolling mean vs a frozen early-run baseline — catches slow creep
    a per-step threshold never trips on.  Fires at most once per
    ``cooldown`` observations so a persistent drift does not flood the
    event log."""

    name = "comm_ratio_drift"

    def __init__(self, metric: str = "comm_share", *, window: int = 20,
                 warmup: int = 3, rel_threshold: float = 0.25,
                 cooldown: int = 20):
        self.metric = metric
        self.warmup = int(warmup)
        self.rel_threshold = float(rel_threshold)
        self.cooldown = int(cooldown)
        self._win = _Window(window)
        self._baseline: Optional[float] = None
        self._seen = 0
        self._quiet = 0

    def observe(self, step: int, value: float) -> Optional[Anomaly]:
        self._seen += 1
        if self._seen <= self.warmup:
            return None
        self._win.push(value)
        if self._baseline is None:
            if len(self._win) >= self._win.size:
                self._baseline = self._win.mean()   # freeze the baseline
            return None
        if self._quiet > 0:
            self._quiet -= 1
            return None
        mean = self._win.mean()
        denom = max(abs(self._baseline), 1e-12)
        drift = abs(mean - self._baseline) / denom
        if drift <= self.rel_threshold:
            return None
        self._quiet = self.cooldown
        return Anomaly(
            detector=self.name, step=step, metric=self.metric,
            value=mean, baseline=self._baseline,
            severity=drift / self.rel_threshold,
            message=(f"{self.metric} rolling mean {mean:.4g} drifted "
                     f"{drift:.0%} from baseline {self._baseline:.4g}"))


class LossSpike(Detector):
    """Robust z-score (median/MAD) on the loss; non-finite always
    fires.  The spiking sample never enters the window."""

    name = "loss_spike"

    def __init__(self, metric: str = "loss", *, window: int = 20,
                 warmup: int = 2, z: float = 6.0, min_samples: int = 5,
                 min_spread: float = 1e-3):
        self.metric = metric
        self.warmup = int(warmup)
        self.z = float(z)
        self.min_samples = int(min_samples)
        self.min_spread = float(min_spread)
        self._win = _Window(window)
        self._seen = 0

    def observe(self, step: int, value: float) -> Optional[Anomaly]:
        self._seen += 1
        if not math.isfinite(value):
            return Anomaly(
                detector=self.name, step=step, metric=self.metric,
                value=value, baseline=self._win.median(),
                severity=float("inf"),
                message=f"{self.metric} is non-finite ({value})")
        if self._seen <= self.warmup:
            return None
        med = self._win.median()
        spread = 1.4826 * self._win.mad() + self.min_spread
        fired = (len(self._win) >= self.min_samples
                 and abs(value - med) > self.z * spread)
        if not fired:
            self._win.push(value)
            return None
        return Anomaly(
            detector=self.name, step=step, metric=self.metric,
            value=value, baseline=med,
            severity=abs(value - med) / (self.z * spread),
            message=(f"{self.metric} {value:.4g} is "
                     f"{abs(value - med) / spread:.1f} robust sigmas "
                     f"from median {med:.4g}"))


class ThresholdBreach(Detector):
    """Value above an absolute threshold for N consecutive steps (the
    load-imbalance detector: one hot batch is routing noise, a sustained
    breach is a placement problem)."""

    name = "load_imbalance"

    def __init__(self, metric: str = "load_imbalance", *,
                 threshold: float = 4.0, consecutive: int = 3):
        self.metric = metric
        self.threshold = float(threshold)
        self.consecutive = int(consecutive)
        self._streak = 0

    def observe(self, step: int, value: float) -> Optional[Anomaly]:
        if value <= self.threshold:
            self._streak = 0
            return None
        self._streak += 1
        if self._streak != self.consecutive:    # fire once per breach run
            return None
        return Anomaly(
            detector=self.name, step=step, metric=self.metric,
            value=value, baseline=self.threshold,
            severity=value / max(self.threshold, 1e-12),
            message=(f"{self.metric} {value:.3g} > {self.threshold:.3g} "
                     f"for {self.consecutive} consecutive steps"))


class PersistentStraggler(Detector):
    """Consumes the per-step straggler flag (0/1); fires when the
    window holds >= ``count`` flagged steps, then resets so the next
    fire needs a fresh accumulation."""

    name = "persistent_straggler"

    def __init__(self, metric: str = "straggler", *, window: int = 50,
                 count: int = 3):
        self.metric = metric
        self.count = int(count)
        self._win = _Window(window)

    def observe(self, step: int, value: float) -> Optional[Anomaly]:
        self._win.push(1.0 if value else 0.0)
        flagged = int(sum(1 for v in self._win._q if v))
        if flagged < self.count:
            return None
        self._win = _Window(self._win.size)
        return Anomaly(
            detector=self.name, step=step, metric=self.metric,
            value=float(flagged), baseline=float(self.count),
            severity=flagged / max(self.count, 1),
            message=(f"{flagged} straggler steps within the last "
                     f"{self._win.size} (threshold {self.count})"))


def default_detectors() -> List[Detector]:
    return [StepTimeRegression(), DriftDetector(),
            LossSpike(), ThresholdBreach(), PersistentStraggler()]


class AnomalyMonitor:
    """Feeds per-step signals to every detector, emits typed ``anomaly``
    events, and fans anomalies out to consumers (the resilience
    escalator, tests).  Signals the step loop does not produce are
    simply absent from the dict — detectors whose metric is missing
    skip the step, so wiring is additive."""

    def __init__(self, detectors: Optional[Sequence[Detector]] = None,
                 *, emit: bool = True):
        self.detectors = list(default_detectors()
                              if detectors is None else detectors)
        self.emit = emit
        self.consumers: List[Callable[[Anomaly], None]] = []
        self.history: List[Anomaly] = []

    def add_consumer(self, fn: Callable[[Anomaly], None]) -> Callable:
        self.consumers.append(fn)
        return fn

    def observe(self, step: int, signals: Dict[str, float]
                ) -> List[Anomaly]:
        fired: List[Anomaly] = []
        for det in self.detectors:
            if det.metric not in signals:
                continue
            a = det.observe(step, float(signals[det.metric]))
            if a is not None:
                fired.append(a)
        for a in fired:
            self.history.append(a)
            if self.emit:
                obs_events.emit("anomaly", step=a.step,
                                **a.to_event_data())
            for fn in self.consumers:
                fn(a)
        return fired

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for a in self.history:
            out[a.detector] = out.get(a.detector, 0) + 1
        return out
