"""Fault tolerance and straggler detection for long training runs
(counterpart of ``repro/runtime/fault.py``):

 * ``StepWatchdog``: exits the process (43) when a step outlives its
   deadline (a hung collective, a dead peer); ``--auto-restart`` then
   resumes from the last committed checkpoint.
 * ``StragglerMonitor``: an EMA of step times; flags a step slower than
   ``threshold`` times it.  The first ``warmup`` samples never seed the
   EMA, and a flagged sample is clamped to the threshold before it is
   folded in, so one hang does not mask the next.
 * ``ExpertRebalancer``: an EMA of each expert's load; proposes a
   placement that pairs hot experts with cold ranks (applied with
   ``core.lsh_moe.apply_placement_update``).
 * ``PreemptionHandler``: SIGTERM -> a checkpoint -> exit 42.
 * the non-finite-loss skip lives in optim/adam.py (``grad_skips``).
"""
from __future__ import annotations

import os
import signal
import threading
import time
from typing import Callable, List, Optional

import numpy as np

from repro_torch.obs import events as obs_events

EXIT_PREEMPTED = 42
EXIT_WATCHDOG = 43


class StepWatchdog:
    """``arm()`` before each step, ``disarm()`` after.  A missed deadline
    emits a ``watchdog`` event and calls ``on_timeout`` (default: exit
    43, a budgeted restart for the supervisor).  The monitor thread
    survives a callback that does not exit and honours later ``arm()``
    calls: one fire per arm."""

    def __init__(self, timeout_s: float,
                 on_timeout: Optional[Callable] = None):
        self.timeout_s = timeout_s
        self.on_timeout = on_timeout or (lambda: os._exit(EXIT_WATCHDOG))
        self.fired = 0
        self._deadline = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def arm(self):
        with self._lock:
            self._deadline = time.monotonic() + self.timeout_s

    def disarm(self):
        with self._lock:
            self._deadline = None

    def stop(self):
        self._stop.set()

    def _run(self):
        while not self._stop.wait(min(0.5, self.timeout_s / 4)):
            fire = False
            with self._lock:
                if self._deadline is not None \
                        and time.monotonic() > self._deadline:
                    self._deadline = None     # one shot per arm()
                    fire = True
            if fire:
                self.fired += 1
                obs_events.emit("watchdog", timeout_s=self.timeout_s,
                                fired=self.fired)
                self.on_timeout()


class StragglerMonitor:
    def __init__(self, threshold: float = 2.0, ema: float = 0.9,
                 warmup: int = 1):
        self.threshold = threshold
        self.ema_coef = ema
        self.warmup = warmup
        self.ema: Optional[float] = None
        self.flagged: List[int] = []
        self._seen = 0

    def record(self, step: int, dt: float) -> bool:
        self._seen += 1
        if self._seen <= self.warmup:
            return False          # the first steps pay for warm-up
        is_straggler = (self.ema is not None
                        and dt > self.threshold * self.ema)
        sample = dt
        if is_straggler:
            self.flagged.append(step)
            sample = self.threshold * self.ema
        self.ema = sample if self.ema is None else \
            self.ema_coef * self.ema + (1 - self.ema_coef) * sample
        return is_straggler


class ExpertRebalancer:
    """Greedy hot / cold pairing: experts sorted by load EMA, each given
    to the open rank with the least load, so the ranks' loads even out."""

    def __init__(self, num_experts: int, num_ranks: int, ema: float = 0.95,
                 imbalance_trigger: float = 1.5):
        self.num_experts = num_experts
        self.num_ranks = num_ranks
        self.ema_coef = ema
        self.trigger = imbalance_trigger
        self.load = np.zeros(num_experts)

    def record(self, counts: np.ndarray,
               placement: Optional[np.ndarray] = None):
        """``counts`` in PHYSICAL slot order (the MoE layer's
        ``expert_load``); ``placement`` maps them back to the logical
        order the EMA works in (None: the identity)."""
        c = np.asarray(counts)
        if placement is not None:
            c = c[np.asarray(placement)]          # physical -> logical
        c = c[: self.num_experts]
        self.load = self.ema_coef * self.load + (1 - self.ema_coef) * c

    def imbalance(self, placement: np.ndarray) -> float:
        per_rank = np.zeros(self.num_ranks)
        e_per = max(1, int(np.ceil(self.num_experts / self.num_ranks)))
        for e in range(self.num_experts):
            per_rank[placement[e] // e_per] += self.load[e]
        mean = max(per_rank.mean(), 1e-9)
        return float(per_rank.max() / mean)

    def propose(self, placement: np.ndarray) -> Optional[np.ndarray]:
        """A new placement when the imbalance reaches the trigger."""
        if self.imbalance(placement) < self.trigger:
            return None
        order = np.argsort(-self.load)          # hot first
        e_per = max(1, int(np.ceil(self.num_experts / self.num_ranks)))
        rank_load = np.zeros(self.num_ranks)
        rank_fill = np.zeros(self.num_ranks, dtype=int)
        new_placement = np.zeros(self.num_experts, dtype=np.int32)
        for e in order:                          # best-fit decreasing
            open_ranks = np.where(rank_fill < e_per)[0]
            r = open_ranks[np.argmin(rank_load[open_ranks])]
            new_placement[e] = r * e_per + rank_fill[r]
            rank_fill[r] += 1
            rank_load[r] += self.load[e]
        return new_placement


class PreemptionHandler:
    def __init__(self):
        self.requested = threading.Event()
        try:
            signal.signal(signal.SIGTERM, self._handle)
        except ValueError:
            pass              # not the main thread

    def _handle(self, signum, frame):
        self.requested.set()
