"""The port's launcher survives its process, on the CPU: real
``python -m repro_torch.launch.train --device cpu --smoke`` subprocesses,
a run killed or hung by its own chaos plan and restarted by
``--auto-restart``, whose per-step losses in ``events.jsonl`` must be
bit for bit the uninterrupted run's (json carries a float64 exactly, so
equal decoded floats are equal bits): under SIGKILL, under a hang that
the watchdog ends (exit 43) then a SIGTERM preemption (exit 42), and
under two damaged checkpoints that restore must quarantine.  Also the
replayable faults (a NaN loss skipped once, an input stall) and a bad
chaos spec (exit 2, no restart).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # parallel test workers share the cores

SRC = Path(__file__).resolve().parents[1] / "src"
COMMON = ["--arch", "granite-moe-3b-a800m", "--smoke", "--device", "cpu",
          "--steps", "6", "--batch", "4", "--seq", "32", "--log-every", "1"]
RESTART_ENV = {"RESTART_BACKOFF_S": "0", "MAX_RESTARTS": "3"}


def _launch(argv, env_extra=None, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="2",
               **(env_extra or {}))
    env.pop("REPRO_CHAOS", None)
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *argv],
        capture_output=True, text=True, env=env, timeout=timeout)


def _events(d, kind=None):
    with open(os.path.join(d, "events.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [r for r in recs if kind is None or r["kind"] == kind]


def _step_losses(d):
    """step -> loss; a later line wins, so a replayed step reports its
    value after the restart."""
    return {r["step"]: r["loss"] for r in _events(d, "step")}


@pytest.fixture(scope="module")
def baseline(tmp_path_factory):
    d = tmp_path_factory.mktemp("baseline")
    r = _launch([*COMMON, "--ckpt", str(d / "ckpt"), "--ckpt-every", "2",
                 "--metrics-dir", str(d)])
    assert r.returncode == 0, r.stderr[-3000:]
    losses = _step_losses(str(d))
    assert sorted(losses) == list(range(6))
    assert sorted(os.listdir(d / "ckpt")) == ["step_2", "step_4", "step_6"]
    return losses


def test_sigkill_resume_bitwise_identical(tmp_path, baseline):
    d = tmp_path / "run"
    r = _launch([*COMMON, "--ckpt", str(d / "ckpt"), "--ckpt-every", "2",
                 "--metrics-dir", str(d), "--chaos", "sigkill@3",
                 "--auto-restart"], env_extra=RESTART_ENV)
    assert r.returncode == 0, r.stderr[-3000:]
    assert _step_losses(str(d)) == baseline
    [restart] = _events(str(d), "restart")
    assert restart["classification"] == "signal_9" and restart["budgeted"]
    assert [e["fault"] for e in _events(str(d), "chaos")] == ["sigkill"]
    [resume] = _events(str(d), "resume")
    assert resume["from_step"] == 2
    assert "[supervisor] restart #1" in r.stdout


def test_hang_watchdog_and_sigterm_preempt_resume(tmp_path, baseline):
    """hang -> the watchdog exits 43 (a budgeted restart); a later SIGTERM
    -> checkpoint -> exit 42 (a free restart); the trajectory bitwise."""
    d = tmp_path / "run"
    r = _launch([*COMMON, "--ckpt", str(d / "ckpt"), "--ckpt-every", "2",
                 "--metrics-dir", str(d), "--watchdog-s", "6",
                 "--chaos", "hang@2:60,sigterm@4", "--auto-restart"],
                env_extra=RESTART_ENV)
    assert r.returncode == 0, r.stderr[-3000:]
    assert _step_losses(str(d)) == baseline
    kinds = [(e["classification"], e["budgeted"])
             for e in _events(str(d), "restart")]
    assert kinds == [("watchdog", True), ("preempted", False)]
    assert _events(str(d), "watchdog") and _events(str(d), "preempt")
    assert [e["from_step"] for e in _events(str(d), "resume")] == [2, 5]


def test_ckpt_corruption_faults_resume_bitwise(tmp_path, baseline):
    """ckpt_flip and ckpt_truncate damage two committed checkpoints; the
    sigkill that follows forces a restore, which quarantines both and
    falls back to the last clean step, then replays bitwise."""
    d = tmp_path / "run"
    r = _launch([*COMMON, "--ckpt", str(d / "ckpt"), "--ckpt-every", "1",
                 "--metrics-dir", str(d),
                 "--chaos", "ckpt_flip@1,ckpt_truncate@2,sigkill@3",
                 "--auto-restart"], env_extra=RESTART_ENV)
    assert r.returncode == 0, r.stderr[-3000:]
    assert _step_losses(str(d)) == baseline
    corrupt = _events(str(d), "checkpoint_corrupt")
    assert [e["step"] for e in corrupt] == [3, 2]
    assert any("sha256" in e["reason"] for e in corrupt)
    assert sorted(n for n in os.listdir(d / "ckpt")
                  if n.startswith("quarantine_step_")) == \
        ["quarantine_step_2", "quarantine_step_3"]
    assert [e["from_step"] for e in _events(str(d), "resume")] == [1]
    faults = [e["fault"] for e in _events(str(d), "chaos")]
    assert sorted(faults) == ["ckpt_flip", "ckpt_truncate", "sigkill"]


def test_nan_grads_and_data_stall_in_run(tmp_path):
    """Replayable faults: nan_grads takes the skip path once (skips go
    0 -> 1 and stay 1, losses finite), data_stall only delays; a SIGKILL
    after them resumes from a checkpoint that kept the skip count."""
    d = tmp_path / "run"
    r = _launch([*COMMON, "--ckpt", str(d / "ckpt"), "--ckpt-every", "2",
                 "--metrics-dir", str(d), "--chaos",
                 "nan_grads@2,data_stall@4:0.2,sigkill@4", "--auto-restart"],
                env_extra=RESTART_ENV)
    assert r.returncode == 0, r.stderr[-3000:]
    steps = {e["step"]: e for e in _events(str(d), "step")}
    assert [steps[s]["skips"] for s in range(6)] == [0, 0, 1, 1, 1, 1]
    assert all(np.isfinite(e["loss"]) for e in steps.values())
    faults = [e["fault"] for e in _events(str(d), "chaos")]
    assert sorted(faults) == ["data_stall", "data_stall", "nan_grads",
                              "sigkill"]
    assert [e["from_step"] for e in _events(str(d), "resume")] == [4]


def test_bad_chaos_spec_is_usage_error_no_restart(tmp_path):
    r = _launch([*COMMON, "--metrics-dir", str(tmp_path / "m"),
                 "--chaos", "not_a_fault@3", "--auto-restart"],
                env_extra={"RESTART_BACKOFF_S": "0"})
    assert r.returncode == 2
    assert "unknown fault kind" in r.stdout + r.stderr
    assert not [e for e in _events(str(tmp_path / "m"))
                if e["kind"] == "restart"]


def test_auto_restart_under_torchrun_is_usage_error(monkeypatch, capsys):
    """--auto-restart supervises one process; under torchrun (RANK set)
    it is a usage error that says so, before anything runs."""
    from repro_torch.launch import train
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(SystemExit) as exc:
        train.main([*COMMON, "--auto-restart"])
    assert exc.value.code == 2
    assert "one-process run" in capsys.readouterr().err
