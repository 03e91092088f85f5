"""Deterministic, step-addressed fault injection (counterpart of
``repro/resilience/faults.py``).  A ``FaultPlan`` is parsed from a
``--chaos`` spec (or ``$REPRO_CHAOS``):

    SPEC  := entry ("," entry)*
    entry := "seed=" INT | KIND "@" STEP [":" FLOAT]
    KIND  := nan_grads | hang | sigterm | sigkill | ckpt_flip
           | ckpt_truncate | tune_corrupt | data_stall

for example ``--chaos "nan_grads@3,hang@7:2.5,sigkill@9,seed=1"``.

Faults are addressed by training step, so a resumed run meets them
again at the same points.  ``nan_grads`` and ``data_stall`` are
replayable: they fire again when a step is re-run, as a bitwise replay
needs.  The others fire once: the plan writes a fired-marker to
``chaos_state.json`` (a temp file, fsync, ``os.replace``: atomic, also
when every rank of a mesh writes it) before the fault kills the process
or damages a file, so the supervised restart does not inject it again.

Over several ranks every rank fires at the same step; only the writer
(rank 0) damages files, since the ranks share them (two flips of one bit
would undo each other).  Every injection is a ``chaos`` event before it
takes effect.  ``nan_grads`` rides the batch as
``runtime.step.CHAOS_LOSS_SCALE_KEY``; without it the key is never added.
"""
from __future__ import annotations

import json
import math
import os
import signal
import tempfile
import time
from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs import events as obs_events

NAN_GRADS = "nan_grads"
HANG = "hang"
SIGTERM = "sigterm"
SIGKILL = "sigkill"
CKPT_FLIP = "ckpt_flip"
CKPT_TRUNCATE = "ckpt_truncate"
TUNE_CORRUPT = "tune_corrupt"
DATA_STALL = "data_stall"

KINDS = (NAN_GRADS, HANG, SIGTERM, SIGKILL, CKPT_FLIP, CKPT_TRUNCATE,
         TUNE_CORRUPT, DATA_STALL)
# once-only: re-firing them after a restart would keep the run from ever
# proving its recovery (a sigkill@k would kill every re-run of step k)
ONCE = frozenset({HANG, SIGTERM, SIGKILL, CKPT_FLIP, CKPT_TRUNCATE,
                  TUNE_CORRUPT})
_FILE_FAULTS = (CKPT_FLIP, CKPT_TRUNCATE, TUNE_CORRUPT)

_DEFAULT_ARG = {HANG: 3600.0, DATA_STALL: 1.0}

STATE_NAME = "chaos_state.json"


@dataclass(frozen=True)
class Fault:
    kind: str
    step: int
    arg: Optional[float] = None

    @property
    def fault_id(self) -> str:
        return f"{self.kind}@{self.step}"

    def seconds(self) -> float:
        return self.arg if self.arg is not None \
            else _DEFAULT_ARG.get(self.kind, 0.0)


def _parse_entry(entry: str) -> Tuple[Optional[Fault], Optional[int]]:
    entry = entry.strip()
    if entry.startswith("seed="):
        try:
            return None, int(entry[5:])
        except ValueError:
            raise ValueError(f"chaos spec: bad seed in {entry!r}") from None
    if "@" not in entry:
        raise ValueError(
            f"chaos spec: {entry!r} is not KIND@STEP[:ARG] or seed=N "
            f"(kinds: {', '.join(KINDS)})")
    kind, _, rest = entry.partition("@")
    if kind not in KINDS:
        raise ValueError(f"chaos spec: unknown fault kind {kind!r} "
                         f"(kinds: {', '.join(KINDS)})")
    step_s, _, arg_s = rest.partition(":")
    try:
        step = int(step_s)
    except ValueError:
        raise ValueError(
            f"chaos spec: bad step in {entry!r} (want KIND@STEP[:ARG])"
        ) from None
    if step < 0:
        raise ValueError(f"chaos spec: negative step in {entry!r}")
    arg = None
    if arg_s:
        try:
            arg = float(arg_s)
        except ValueError:
            raise ValueError(f"chaos spec: bad arg in {entry!r}") from None
        if not math.isfinite(arg) or arg < 0:
            raise ValueError(f"chaos spec: arg must be finite and >= 0 "
                             f"in {entry!r}")
    return Fault(kind, step, arg), None


class FaultPlan:
    """A parsed chaos spec and the hooks the launcher calls."""

    def __init__(self, faults: Iterable[Fault], seed: int = 0):
        self.faults: Tuple[Fault, ...] = tuple(
            sorted(faults, key=lambda f: (f.step, f.kind)))
        self.seed = int(seed)
        self._fired: set = set()
        self._state_path: Optional[str] = None

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        faults, seed = [], 0
        for entry in spec.split(","):
            if not entry.strip():
                continue
            fault, s = _parse_entry(entry)
            if s is not None:
                seed = s
            else:
                faults.append(fault)
        if not faults:
            raise ValueError(f"chaos spec {spec!r} names no faults")
        return cls(faults, seed=seed)

    def describe(self) -> str:
        parts = [f.fault_id + (f":{f.arg:g}" if f.arg is not None else "")
                 for f in self.faults]
        return ",".join(parts) + f",seed={self.seed}"

    # ------------------------------------------------------ fired markers --

    def bind_state(self, path: str) -> None:
        """Keep fired-markers at ``path``, so once-faults survive the
        process kills they cause."""
        self._state_path = path
        if os.path.exists(path):
            try:
                with open(path) as f:
                    self._fired = set(json.load(f).get("fired", []))
            except (OSError, json.JSONDecodeError, AttributeError):
                self._fired = set()

    def _mark_fired(self, fault: Fault) -> None:
        self._fired.add(fault.fault_id)
        if self._state_path is None:
            return
        d = os.path.dirname(self._state_path) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".chaos-", suffix=".json")
        with os.fdopen(fd, "w") as f:
            json.dump({"fired": sorted(self._fired)}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._state_path)

    def _pending(self, step: int, kinds: set) -> Sequence[Fault]:
        out = []
        for f in self.faults:
            if f.kind not in kinds:
                continue
            if f.kind in ONCE and f.fault_id in self._fired:
                continue
            # a file fault waits for its target to exist; a process fault
            # fires at its step only
            if f.step == step or (f.kind in _FILE_FAULTS and f.step <= step):
                out.append(f)
        return out

    def _emit(self, fault: Fault, step: int, **detail) -> None:
        obs_events.emit("chaos", step=step, fault=fault.kind,
                        fault_step=fault.step, fault_id=fault.fault_id,
                        seed=self.seed, **detail)

    # ------------------------------------------------------ in-step hooks --

    def wants_loss_scale(self) -> bool:
        return any(f.kind == NAN_GRADS for f in self.faults)

    def loss_scale(self, step: int) -> np.float32:
        """1.0 (an IEEE identity), NaN at a ``nan_grads`` step."""
        for f in self.faults:
            if f.kind == NAN_GRADS and f.step == step:
                self._emit(f, step, effect="loss *= nan (grad-skip path)")
                return np.float32(np.nan)
        return np.float32(1.0)

    def chaos_batch(self, batch: Dict, step: int) -> Dict:
        """The batch with the loss scale, at every step of a plan with
        ``nan_grads`` faults; the same object otherwise."""
        if not self.wants_loss_scale():
            return batch
        from repro_torch.runtime.step import CHAOS_LOSS_SCALE_KEY
        batch = dict(batch)
        batch[CHAOS_LOSS_SCALE_KEY] = self.loss_scale(step)
        return batch

    def on_step_start(self, step: int) -> None:
        """Process faults, injected with the watchdog armed and no
        checkpoint of this step yet."""
        for f in self._pending(step, {DATA_STALL, HANG, SIGTERM, SIGKILL}):
            if f.kind == DATA_STALL:
                self._emit(f, step, effect="input stall",
                           seconds=f.seconds())
                time.sleep(f.seconds())
            elif f.kind == HANG:
                self._emit(f, step, effect="hung step (watchdog bait)",
                           seconds=f.seconds())
                self._mark_fired(f)
                time.sleep(f.seconds())   # the watchdog exits 43 under us
            elif f.kind == SIGTERM:
                self._emit(f, step, effect="SIGTERM to self (preemption)")
                self._mark_fired(f)
                os.kill(os.getpid(), signal.SIGTERM)
            elif f.kind == SIGKILL:
                self._emit(f, step, effect="SIGKILL to self (hard crash)")
                self._mark_fired(f)       # written before the kill
                os.kill(os.getpid(), signal.SIGKILL)

    def on_step_end(self, step: int, *, manager=None, ckpt_dir: str = "",
                    tune_cache_dir: str = "", writer: bool = True) -> None:
        """File faults, after the step's save was issued, against the
        durable state on disk.  ``writer`` False (ranks other than 0):
        mark the fault fired and touch no file."""
        for f in self._pending(step, {CKPT_FLIP, CKPT_TRUNCATE}):
            if not ckpt_dir:
                continue
            if manager is not None:
                manager.wait()            # make the async save durable
            target = self._latest_shard(ckpt_dir)
            if target is None:
                continue                  # armed until a step commits
            path, ckpt_step = target
            detail = {}
            if writer:
                detail = self._corrupt_file(
                    path, truncate=(f.kind == CKPT_TRUNCATE), salt=f.step)
            self._emit(f, step, effect=f.kind, ckpt_step=ckpt_step,
                       path=path, **detail)
            self._mark_fired(f)
        for f in self._pending(step, {TUNE_CORRUPT}):
            d = tune_cache_dir
            if not d:
                from repro_torch.tune import cache as tune_cache
                d = tune_cache.cache_dir()
            names = []
            if os.path.isdir(d):
                for name in sorted(os.listdir(d)):
                    if name.endswith(".json"):
                        if writer:
                            with open(os.path.join(d, name), "wb") as fh:
                                fh.write(b'{"chaos": truncated')
                        names.append(name)
            self._emit(f, step, effect="tune cache corrupted", dir=d,
                       files=names)
            self._mark_fired(f)

    # ------------------------------------------------------------ helpers --

    @staticmethod
    def _latest_shard(ckpt_dir: str):
        from repro_torch.checkpoint.checkpoint import committed_steps
        steps = committed_steps(ckpt_dir)
        if not steps:
            return None
        d = os.path.join(ckpt_dir, f"step_{steps[-1]}")
        shards = sorted(n for n in os.listdir(d) if n.startswith("shard_"))
        if not shards:
            return None
        return os.path.join(d, shards[0]), steps[-1]

    def _corrupt_file(self, path: str, *, truncate: bool, salt: int
                      ) -> Dict:
        """Truncate to half, or flip one bit chosen by (seed, salt)."""
        with open(path, "rb") as f:
            buf = bytearray(f.read())
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, salt]))
        if truncate or len(buf) == 0:
            keep = len(buf) // 2
            with open(path, "wb") as f:
                f.write(bytes(buf[:keep]))
            return {"truncated_to": keep, "was": len(buf)}
        offset = int(rng.integers(len(buf)))
        bit = int(rng.integers(8))
        buf[offset] ^= 1 << bit
        with open(path, "wb") as f:
            f.write(bytes(buf))
        return {"flipped_offset": offset, "flipped_bit": bit}
