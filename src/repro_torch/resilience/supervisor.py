"""The exit-code-aware restart supervisor of ``--auto-restart``
(counterpart of ``repro/resilience/supervisor.py``):

 * it classifies a child's exit: preemption (42) and watchdog (43) from
   ``runtime.fault``, death by a signal (a negative return code), a
   usage error (2), anything else a crash;
 * it restarts only the restartable classes (a bad flag will not get
   better);
 * it charges only the budgeted classes (watchdog, signal, crash)
   against a rolling budget, ``$MAX_RESTARTS`` within
   ``$RESTART_WINDOW_S``; preemptions restart for free;
 * it sleeps an exponential backoff with seeded jitter
   (``$RESTART_BACKOFF_S`` base) before a budgeted restart.

Each decision is a ``restart`` or ``restart_budget_exhausted`` event.
``AnomalyEscalator`` turns a persistent pattern of anomalies
(obs/anomaly.py) into exit 43, which the supervisor restarts as a
budgeted watchdog exit.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from repro_torch.obs import events as obs_events
from repro_torch.runtime.fault import EXIT_PREEMPTED, EXIT_WATCHDOG

EXIT_OK = 0
EXIT_USAGE = 2

ENV_MAX_RESTARTS = "MAX_RESTARTS"
ENV_WINDOW_S = "RESTART_WINDOW_S"
ENV_BACKOFF_S = "RESTART_BACKOFF_S"


class AnomalyEscalator:
    """From soft anomalies to the restart machinery.  As an
    ``AnomalyMonitor`` consumer it counts the escalating detectors'
    anomalies within a rolling window; at ``limit`` it emits
    ``anomaly_escalation`` (once) and sets ``should_exit``: the train
    loop then checkpoints and exits ``EXIT_WATCHDOG``.  One loss spike or
    one slow step never escalates; a persistent pattern does."""

    ESCALATING = ("step_time_regression", "persistent_straggler")

    def __init__(self, *, limit: int = 3, window_s: float = 600.0,
                 detectors=ESCALATING, on_escalate=None,
                 clock: Callable[[], float] = time.monotonic):
        self.limit = int(limit)
        self.window_s = float(window_s)
        self.detectors = tuple(detectors)
        self.on_escalate = on_escalate
        self._clock = clock
        self._marks: list = []
        self.escalated = False

    @property
    def should_exit(self) -> bool:
        return self.escalated

    def consume(self, anomaly) -> bool:
        """The AnomalyMonitor consumer; returns ``should_exit``."""
        if anomaly.detector not in self.detectors:
            return self.escalated
        now = self._clock()
        self._marks = [t for t in self._marks if now - t < self.window_s]
        self._marks.append(now)
        if not self.escalated and len(self._marks) >= self.limit:
            self.escalated = True
            obs_events.emit(
                "anomaly_escalation", step=anomaly.step,
                detector=anomaly.detector, count=len(self._marks),
                limit=self.limit, window_s=self.window_s,
                exit_code=EXIT_WATCHDOG)
            if self.on_escalate is not None:
                self.on_escalate(anomaly)
        return self.escalated


@dataclass(frozen=True)
class ExitClass:
    """What a child's exit code means for the restart policy."""
    name: str
    restart: bool       # relaunch at all?
    budgeted: bool      # counted against the rolling budget?


def classify_exit(code: int) -> ExitClass:
    if code == EXIT_OK:
        return ExitClass("done", restart=False, budgeted=False)
    if code == EXIT_PREEMPTED:
        # the child checkpointed before it exited: restarting is free
        return ExitClass("preempted", restart=True, budgeted=False)
    if code == EXIT_WATCHDOG:
        return ExitClass("watchdog", restart=True, budgeted=True)
    if code == EXIT_USAGE:
        return ExitClass("usage_error", restart=False, budgeted=False)
    if code < 0:
        return ExitClass(f"signal_{-code}", restart=True, budgeted=True)
    return ExitClass("crash", restart=True, budgeted=True)


def backoff_seconds(n_budgeted: int, base: float, cap: float,
                    rng: np.random.Generator) -> float:
    """base * 2^(n - 1), capped, plus up to 25% jitter from ``rng``."""
    if base <= 0:
        return 0.0
    b = min(cap, base * (2.0 ** max(0, n_budgeted - 1)))
    return float(b * (1.0 + 0.25 * rng.random()))


def supervise(run_child: Callable[[], int], *,
              max_restarts: Optional[int] = None,
              window_s: Optional[float] = None,
              backoff_base_s: Optional[float] = None,
              backoff_cap_s: float = 60.0, seed: int = 0,
              sleep: Callable[[float], None] = time.sleep,
              clock: Callable[[], float] = time.monotonic) -> int:
    """Run ``run_child`` until it finishes, restarting by the policy
    above; returns the last child's exit code."""
    if max_restarts is None:
        max_restarts = int(os.environ.get(ENV_MAX_RESTARTS, "3"))
    if window_s is None:
        window_s = float(os.environ.get(ENV_WINDOW_S, "3600"))
    if backoff_base_s is None:
        backoff_base_s = float(os.environ.get(ENV_BACKOFF_S, "1.0"))
    rng = np.random.default_rng(np.random.SeedSequence([seed]))
    budget_marks: list = []     # clock() of each budgeted restart
    attempts = 0
    while True:
        code = run_child()
        cls = classify_exit(code)
        if not cls.restart:
            if code != EXIT_OK:
                obs_events.emit("error", where="supervise",
                                message=(f"child exit {code} "
                                         f"({cls.name}): not restartable"))
            return code
        wait = 0.0
        if cls.budgeted:
            now = clock()
            budget_marks = [t for t in budget_marks if now - t < window_s]
            if len(budget_marks) >= max_restarts:
                obs_events.emit("restart_budget_exhausted",
                                exit_code=code, classification=cls.name,
                                budget=max_restarts, window_s=window_s)
                return code
            budget_marks.append(now)
            wait = backoff_seconds(len(budget_marks), backoff_base_s,
                                   backoff_cap_s, rng)
        attempts += 1
        obs_events.emit("restart", attempt=attempts, exit_code=code,
                        classification=cls.name, budgeted=cls.budgeted,
                        budget_used=len(budget_marks),
                        budget=max_restarts, backoff_s=round(wait, 3))
        if wait > 0:
            sleep(wait)
