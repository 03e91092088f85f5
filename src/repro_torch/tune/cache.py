"""The persistent JSON tuning cache (counterpart of
``repro/tune/cache.py``).

One file per mesh fingerprint under ``$REPRO_TUNE_CACHE`` (default
``~/.cache/repro-tune``), named ``<fingerprint-key>.json``.  Writes are
atomic (temp file + ``os.replace`` in the same directory) so a crashed or
preempted probe run never leaves a torn entry; reads never raise — a
missing, corrupt, schema-stale or fingerprint-mismatched entry is logged
with the reason and treated as a miss, which is what lets the planner
keep the static constants.
"""
from __future__ import annotations

import json
import logging
import os
import tempfile
import time
from typing import Optional

from repro_torch.obs import events as obs_events
from repro_torch.tune.fingerprint import Fingerprint

SCHEMA_VERSION = 1
ENV_CACHE = "REPRO_TUNE_CACHE"

log = logging.getLogger(__name__)


def _reject(path: str, reason: str) -> None:
    """A rejected (corrupt, stale or mismatched) entry is logged and
    emitted as a ``tune_cache_reject`` event."""
    log.warning("tune cache: %s; ignoring it", reason)
    obs_events.emit("tune_cache_reject", path=path, reason=reason)


def cache_dir() -> str:
    return os.environ.get(ENV_CACHE) \
        or os.path.join(os.path.expanduser("~"), ".cache", "repro-tune")


def entry_path(fp: Fingerprint) -> str:
    return os.path.join(cache_dir(), f"{fp.key()}.json")


def _atomic_write(path: str, entry: dict) -> None:
    d = os.path.dirname(path)
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp-", suffix=".json")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(entry, f, indent=1)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def store(fp: Fingerprint, payload: dict) -> str:
    """Atomically write the entry for ``fp``; returns the path.  The
    fingerprint is embedded so a renamed/copied file still self-identifies
    (load() re-checks it against the requesting mesh)."""
    path = entry_path(fp)
    entry = {"schema": SCHEMA_VERSION, "created_unix": time.time(),
             "fingerprint": fp.to_dict(), **payload}
    _atomic_write(path, entry)
    log.info("tune cache: stored %s", path)
    return path


def record_drift(fp: Fingerprint, drift: dict) -> Optional[str]:
    """Annotate ``fp``'s entry with a modeled-against-measured drift
    record (a dict; ``comm_drift``, ``reprobe_recommended``): ``runtime``
    reports an entry whose record recommends a re-probe as ``tune_stale``,
    and ``ensure_calibrated`` re-probes it where probing is allowed.
    Returns the entry's path, or None when no valid entry exists."""
    entry = load(fp)
    if entry is None:
        return None
    entry["drift"] = {"recorded_unix": time.time(), **dict(drift)}
    path = entry_path(fp)
    _atomic_write(path, entry)
    log.info("tune cache: recorded drift for %s (comm_drift=%.3f, "
             "reprobe_recommended=%s)", path,
             float(drift.get("comm_drift", 0.0)),
             bool(drift.get("reprobe_recommended", False)))
    return path


def load(fp: Fingerprint) -> Optional[dict]:
    """The validated entry for ``fp``, or None (with a logged reason) on
    miss / corruption / schema drift / fingerprint mismatch."""
    path = entry_path(fp)
    if not os.path.exists(path):
        log.debug("tune cache: no entry for %s at %s", fp.key(), path)
        return None
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, UnicodeDecodeError, json.JSONDecodeError) as e:
        _reject(path, f"unreadable entry {path} ({e})")
        return None
    if not isinstance(data, dict) or data.get("schema") != SCHEMA_VERSION:
        have = data.get("schema") if isinstance(data, dict) else None
        _reject(path, f"schema mismatch in {path} (have {have!r}, "
                      f"want {SCHEMA_VERSION!r})")
        return None
    try:
        stored = Fingerprint.from_dict(data["fingerprint"])
    except Exception as e:  # malformed fingerprint dict
        _reject(path, f"bad fingerprint in {path} ({e})")
        return None
    if stored != fp:
        _reject(path, "fingerprint mismatch in %s (fields: %s) — re-run "
                      "`python -m repro_torch.tune` on this mesh"
                      % (path, ", ".join(fp.diff(stored))
                         or "<key collision>"))
        return None
    return data
