"""The tuning cache as the comm planner reads it (counterpart of
``repro/tune/runtime.py``).

``plan_collectives`` calls ``calibration_for`` once a plan.  The tuning
mode, first hit wins:

  1. ``CommConfig.tuning`` set to anything but "off",
  2. ``$REPRO_TUNE``,
  3. off.

  off    never read the cache: the static planner.
  cache  read the cache; any miss or mismatch keeps the static constants
         (cache.py logs why).
  probe  the same reads; and ``ensure_calibrated`` (the hook of
         ``launch/train.py --autotune`` and the CLI) runs the probes to
         fill the cache when it misses.  The planner itself never probes:
         it runs inside a layer's forward, where timed collectives would
         run on some layers and not others.

Parsed entries are kept by (path, mtime, size), so a plan costs one
``stat`` and an updated file is read again without a restart.
"""
from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.comm.topology import Topology, build_topology
from repro_torch.obs import events as obs_events
from repro_torch.tune import cache
from repro_torch.tune.fingerprint import Fingerprint, fingerprint_for
from repro_torch.tune.model import CalibratedCostModel

ENV_TUNE = "REPRO_TUNE"
MODES = ("off", "cache", "probe")

log = logging.getLogger(__name__)

_Memo = Tuple[Optional[CalibratedCostModel], bool]   # (model, stale)
_MEMO: Dict[Tuple[str, int, int], _Memo] = {}


def tuning_mode(comm=None) -> str:
    """Resolved tuning mode: CommConfig.tuning > $REPRO_TUNE > off."""
    name = (getattr(comm, "tuning", "off") if comm is not None else "off") \
        or "off"
    if name == "off":
        name = os.environ.get(ENV_TUNE, "") or "off"
    if name not in MODES:
        raise ValueError(f"unknown tuning mode {name!r}; "
                         f"available: {sorted(MODES)}")
    return name


def _load_entry(fp: Fingerprint) -> _Memo:
    """(model, stale) for ``fp``.  An entry whose drift record
    (``cache.record_drift``) recommends a re-probe is still used (stale
    means mis-calibrated, not corrupt), and says so with a ``tune_stale``
    event, once a file version."""
    path = cache.entry_path(fp)
    try:
        st = os.stat(path)
        memo_key = (path, st.st_mtime_ns, st.st_size)
    except OSError:
        memo_key = (path, -1, -1)
    if memo_key in _MEMO:
        return _MEMO[memo_key]
    entry = cache.load(fp)
    model = None
    stale = False
    if entry is not None:
        try:
            model = CalibratedCostModel.from_payload(fp.key(), entry)
        except Exception as e:  # malformed rows/constants: miss, not crash
            log.warning("tune cache: unparseable payload in %s (%s); "
                        "ignoring it", path, e)
        drift = entry.get("drift")
        if model is not None and isinstance(drift, dict) \
                and drift.get("reprobe_recommended"):
            stale = True
            log.warning("tune cache: calibration %s is drift-stale "
                        "(comm_drift=%.3f); re-run the probe", path,
                        float(drift.get("comm_drift", 0.0)))
            obs_events.emit(
                "tune_stale", fingerprint=fp.key(), path=path,
                comm_drift=float(drift.get("comm_drift", 0.0)),
                drift_score=float(drift.get("drift_score", 0.0)))
    if len(_MEMO) > 64:                  # bounded; entries are tiny
        _MEMO.clear()
    _MEMO[memo_key] = (model, stale)
    return model, stale


def _load(fp: Fingerprint) -> Optional[CalibratedCostModel]:
    return _load_entry(fp)[0]


def calibration_for(mesh, topo: Topology, comm=None,
                    axis_name: str = "model"
                    ) -> Optional[CalibratedCostModel]:
    """The calibrated cost model of (mesh, topo), or None when tuning is
    off or no valid entry exists: the planner then plans statically."""
    if tuning_mode(comm) == "off":
        return None
    return _load(fingerprint_for(mesh, topo, axis_name))


def _on_every_rank(flag: bool, device=None) -> bool:
    """Whether ``flag`` holds on every rank of the started group."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return flag
    from repro_torch.tune.probe import probe_device
    t = torch.tensor([int(flag)], device=probe_device(device))
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t.item())


def ensure_calibrated(mesh, comm=None, axis_name: str = "model", *,
                      probe: bool = False,
                      **autotune_kwargs) -> Optional[CalibratedCostModel]:
    """Start-up hook: the mesh's calibration, probed into the cache where
    allowed (``probe=True``, the launcher's --autotune, probes whatever
    the mode).  ``autotune_kwargs`` go to ``autotune`` (``device``,
    ``ladder``, ...)."""
    mode = tuning_mode(comm)
    if mode == "off" and not probe:
        return None
    node = int(getattr(comm, "node_size", 0) or 0)
    topo = build_topology(mesh, axis_name=axis_name, node_size=node)
    fp = fingerprint_for(mesh, topo, axis_name)
    model, stale = _load_entry(fp)
    can_probe = probe or mode == "probe"
    usable = model is not None and not (stale and can_probe)
    if can_probe:
        # the probe is collective: every rank probes if any rank must
        usable = _on_every_rank(usable, autotune_kwargs.get("device"))
    if usable:
        return model                   # valid, or stale w/o probe rights
    if not can_probe:
        log.info("tune: cache miss for %s and mode=%r; staying on static "
                 "constants (run `python -m repro_torch.tune` to "
                 "calibrate)",
                 fp.key(), mode)
        return None
    if stale:
        log.info("tune: re-probing drift-stale calibration for %s",
                 fp.key())
    from repro_torch.tune.autotune import autotune
    autotune(mesh, comm, axis_name=axis_name, **autotune_kwargs)
    return _load(fp)
