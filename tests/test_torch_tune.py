"""The port's tune package (src/repro_torch/tune/): fingerprint, cache,
cost-model fit, planner integration and probes, the CPU cases of the
reference's tests/test_tune.py, and ``python -m repro_torch.tune`` on
four gloo ranks.

``repro.tune.model`` imports no JAX, so the fit is held against the
reference's ``fit_link_constants`` on the same rows, in one process: the
four constants and the residual within 1e-9 relative.  The CLI runs under
``torchrun --standalone --nproc-per-node 4`` at mesh (1, 4), two ranks a
node, and writes one entry; a restart (four ranks of a new process
group) plans calibrated from it, runs the probe suite (every transport
and wire format timed, int8's wire bytes below bf16's), and rejects the
entry, with a logged reason, under another node size.
"""
import json
import logging
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # parallel test workers share the cores
if __name__ != "__main__":
    pytest.importorskip("jax")

HERE = Path(__file__).resolve()
SRC = HERE.parents[1] / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

from repro_torch.comm import planner, topology  # noqa: E402
from repro_torch.configs.base import CommConfig  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.tune import cache, runtime  # noqa: E402
from repro_torch.tune.fingerprint import (Fingerprint,  # noqa: E402
                                          fingerprint_for)
from repro_torch.tune.model import (CalibratedCostModel,  # noqa: E402
                                    MeasuredRow, fit_link_constants)


def _topo(model=8, node=4, data=2, **links):
    return topology.Topology(axis_sizes=(("data", data), ("model", model)),
                             node_size=node, **links)


@pytest.fixture
def tune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv(cache.ENV_CACHE, str(tmp_path))
    monkeypatch.delenv(runtime.ENV_TUNE, raising=False)
    monkeypatch.delenv(planner.ENV_VAR, raising=False)
    return tmp_path


def _store_calib(fp, **constants):
    return cache.store(fp, CalibratedCostModel(key=fp.key(),
                                               **constants).to_payload())


# ----------------------------------------------------------- fingerprint --

def test_fingerprint_roundtrip_and_key():
    fp = fingerprint_for(None, _topo(), "model")
    assert Fingerprint.from_dict(fp.to_dict()) == fp
    assert fp.key() == Fingerprint.from_dict(fp.to_dict()).key()
    assert fp.platform == ("gpu" if torch.cuda.is_available() else "cpu")
    assert fp.torch_version.startswith(f"torch {torch.__version__}")
    other = fingerprint_for(None, _topo(node=2), "model")
    assert other.key() != fp.key()
    assert fp.diff(other) == ["node_size"]
    assert fp.diff(fp) == []


# ------------------------------------------------------------------ cache --

def test_cache_roundtrip_atomic(tune_cache):
    fp = fingerprint_for(None, _topo(), "model")
    path = _store_calib(fp, intra_bw=1e9, inter_lat=5e-5)
    assert os.path.basename(path) == f"{fp.key()}.json"
    assert [f for f in os.listdir(tune_cache) if f.startswith(".tmp")] == []
    got = CalibratedCostModel.from_payload(fp.key(), cache.load(fp))
    assert got.intra_bw == 1e9 and got.inter_lat == 5e-5


def test_cache_corrupt_file_recovers(tune_cache, caplog):
    fp = fingerprint_for(None, _topo(), "model")
    with open(cache.entry_path(fp), "w") as f:
        f.write("{ not json")
    with caplog.at_level(logging.WARNING, logger="repro_torch.tune.cache"):
        assert cache.load(fp) is None
    assert "unreadable" in caplog.text
    _store_calib(fp)
    assert cache.load(fp) is not None


def test_cache_fingerprint_mismatch_rejected(tune_cache, caplog):
    from repro_torch.obs import events
    fp_a = fingerprint_for(None, _topo(node=4), "model")
    fp_b = fingerprint_for(None, _topo(node=2), "model")
    _store_calib(fp_a)
    shutil.copyfile(cache.entry_path(fp_a), cache.entry_path(fp_b))
    sink = events.global_log().add_sink(events.MemorySink())
    try:
        with caplog.at_level(logging.WARNING,
                             logger="repro_torch.tune.cache"):
            assert cache.load(fp_b) is None
    finally:
        events.global_log().remove_sink(sink)
    assert "fingerprint mismatch" in caplog.text
    assert "node_size" in caplog.text
    (ev,) = sink.of_kind("tune_cache_reject")
    assert "node_size" in ev.data["reason"]


def test_cache_schema_mismatch_rejected(tune_cache, caplog):
    fp = fingerprint_for(None, _topo(), "model")
    _store_calib(fp)
    with open(cache.entry_path(fp)) as f:
        entry = json.load(f)
    entry["schema"] = cache.SCHEMA_VERSION + 1
    with open(cache.entry_path(fp), "w") as f:
        json.dump(entry, f)
    with caplog.at_level(logging.WARNING, logger="repro_torch.tune.cache"):
        assert cache.load(fp) is None
    assert "schema mismatch" in caplog.text


def test_cache_missing_is_quiet_miss(tune_cache):
    assert cache.load(fingerprint_for(None, _topo(), "model")) is None


def test_malformed_payload_is_miss_not_crash(tune_cache, caplog):
    topo = _topo()
    fp = fingerprint_for(None, topo, "model")
    cache.store(fp, {"constants": {"intra_bw": 1e9},
                     "rows": [["a2a", "flat", "bf16", 1024]]})  # bad arity
    with caplog.at_level(logging.WARNING, logger="repro_torch.tune.runtime"):
        assert runtime.calibration_for(None, topo, CommConfig(
            tuning="cache"), "model") is None
    assert "unparseable" in caplog.text
    p = planner.plan_collectives(None, CommConfig(tuning="cache"),
                                 topology=topo, msg_bytes=1 << 24,
                                 chunk_extent=64)
    assert p.algorithm == planner.HIERARCHICAL and not p.calibrated


def test_drift_record_marks_the_entry_stale(tune_cache):
    """An entry whose drift record recommends a re-probe is still used,
    and says so with a ``tune_stale`` event."""
    from repro_torch.obs import events
    topo = _topo()
    fp = fingerprint_for(None, topo, "model")
    assert cache.record_drift(fp, {"comm_drift": 0.5}) is None
    _store_calib(fp, intra_bw=1e8, inter_lat=1e-7)
    cache.record_drift(fp, {"comm_drift": 0.5, "reprobe_recommended": True})
    sink = events.global_log().add_sink(events.MemorySink())
    try:
        got = runtime.calibration_for(None, topo, CommConfig(tuning="cache"))
    finally:
        events.global_log().remove_sink(sink)
    assert got is not None and got.intra_bw == 1e8
    assert len(sink.of_kind("tune_stale")) == 1


def test_autotune_refuses_measurement_free_entry(tune_cache, caplog):
    """A wire axis of one rank times no transport: no entry is stored and
    ensure_calibrated reports none, so calibrated means measured."""
    from repro_torch.tune.autotune import autotune
    mesh = tmesh.make_mesh(1, 1)
    with caplog.at_level(logging.WARNING, logger="repro_torch.tune.autotune"):
        choices = autotune(mesh, ladder=(4096,), wire_formats=("bf16",),
                           iters=1, warmup=0, device="cpu")
    assert choices.cache_path == ""
    assert choices.n_rows > 0 and all(r.kind == "kernel"
                                      for r in choices.model.measured)
    assert os.listdir(tune_cache) == []
    assert "not storing" in caplog.text
    assert runtime.ensure_calibrated(mesh, None, probe=True,
                                     ladder=(4096,), wire_formats=("bf16",),
                                     iters=1, warmup=0, device="cpu") is None


def test_probe_kernels_rows():
    """The reference's op list, each fused op beside its composed chain,
    timed at two sizes (the plain versions on the CPU)."""
    from repro_torch.tune.probe import probe_kernels, trimmed_mean
    rows = probe_kernels(sizes=((4, 32, 16), (2, 16, 8)), num_slots=8,
                         warmup=0, iters=2, device="cpu")
    names = [r.name for r in rows]
    assert names[:8] == ["lsh_hash", "segment_centroid",
                         "dispatch_scatter_quantize",
                         "dispatch_scatter+quantize",
                         "dequantize_combine_gather",
                         "dequantize+combine_gather",
                         "dequantize_residual_apply",
                         "dequantize+residual_apply"]
    assert names[8:] == names[:8]
    assert all(r.kind == "kernel" and r.seconds > 0 for r in rows)
    assert rows[2].msg_bytes == 4 * 32 * (16 + 4)      # int8 + f32 scales
    assert trimmed_mean([5.0, 1.0, 2.0, 3.0]) == 2.5


# ------------------------------------------------------------- cost model --

def test_fit_recovers_link_constants():
    from repro.comm import topology as jtopo
    from repro.tune.model import MeasuredRow as JRow
    from repro.tune.model import fit_link_constants as j_fit
    links = dict(intra_bw=4e11, inter_bw=6e10, intra_lat=2e-6,
                 inter_lat=3e-5)
    topo = _topo(16, 4, **links)
    rows = [MeasuredRow("a2a", algo, "bf16", msg, 1,
                        topology.estimate_seconds(topology.a2a_cost(
                            topo, "model", msg, algo)))
            for msg in (1 << 16, 1 << 19, 1 << 22, 1 << 24)
            for algo in ("flat", "hierarchical")]
    c = fit_link_constants(rows, topo, "model")
    for k, v in links.items():
        assert c[k] == pytest.approx(v, rel=0.02)
    assert c["fit_residual"] < 1e-6
    assert fit_link_constants([], _topo(), "model") is None
    jt = jtopo.Topology(axis_sizes=topo.axis_sizes, node_size=4, **links)
    want = j_fit([JRow(*r.to_list()) for r in rows], jt, "model")
    assert set(want) == set(c)
    for k in want:
        assert c[k] == pytest.approx(want[k], rel=1e-9, abs=1e-15), k


def test_calibrated_model_apply_and_lookup():
    calib = CalibratedCostModel(
        key="k", intra_bw=1e9, inter_bw=1e8, intra_lat=1e-6, inter_lat=1e-4,
        measured=(MeasuredRow("a2a", "flat", "bf16", 1 << 10, 1, 1e-4),
                  MeasuredRow("a2a", "flat", "bf16", 1 << 20, 1, 1e-2),
                  MeasuredRow("a2a", "pipelined", "bf16", 1 << 20, 2, 9e-3),
                  MeasuredRow("a2a", "pipelined", "bf16", 1 << 20, 4, 5e-3)))
    t = calib.apply(_topo())
    assert (t.intra_bw, t.inter_bw) == (1e9, 1e8)
    assert t.node_size == _topo().node_size
    assert calib.measured_seconds("flat", 1 << 10) == pytest.approx(1e-4)
    mid = calib.measured_seconds("flat",
                                 (1 << 10) + ((1 << 20) - (1 << 10)) // 2)
    assert 1e-4 < mid < 1e-2
    assert calib.measured_seconds("flat", 1 << 22) == pytest.approx(4e-2)
    assert calib.measured_seconds("hierarchical", 1 << 20) is None
    assert calib.best_chunks(1 << 20, (2, 4, 8)) == 4
    assert calib.best_chunks(1 << 20, (8,)) is None


# --------------------------------------------------- planner integration --

def _plan(comm, *, model=8, node=4, msg=1 << 24, extent=64,
          calibration=None):
    return planner.plan_collectives(
        None, comm, topology=_topo(model, node),
        msg_bytes=msg, chunk_extent=extent, calibration=calibration)


def test_injected_measurement_flips_auto_choice(tune_cache):
    assert _plan(CommConfig()).algorithm == planner.HIERARCHICAL
    slow_intra = CalibratedCostModel(key="inj", intra_bw=1e8, inter_bw=5e10,
                                     intra_lat=1e-6, inter_lat=1e-7)
    p = _plan(CommConfig(), calibration=slow_intra)
    assert p.algorithm == planner.FLAT and p.calibrated
    assert "calibrated" in p.reason
    assert _plan(CommConfig(), msg=1 << 10).algorithm == planner.FLAT
    slow_msgs = CalibratedCostModel(key="inj2", inter_lat=5e-3)
    p = _plan(CommConfig(), msg=1 << 10, calibration=slow_msgs)
    assert p.algorithm == planner.HIERARCHICAL and p.calibrated


def test_planner_consults_cache_and_flips(tune_cache, monkeypatch):
    topo = _topo()
    fp = fingerprint_for(None, topo, "model")
    _store_calib(fp, intra_bw=1e8, inter_bw=5e10, intra_lat=1e-6,
                 inter_lat=1e-7)
    off = planner.plan_collectives(None, CommConfig(), topology=topo,
                                   msg_bytes=1 << 24, chunk_extent=64)
    assert off.algorithm == planner.HIERARCHICAL and not off.calibrated
    hit = planner.plan_collectives(None, CommConfig(tuning="cache"),
                                   topology=topo, msg_bytes=1 << 24,
                                   chunk_extent=64)
    assert hit.algorithm == planner.FLAT and hit.calibrated
    monkeypatch.setenv(runtime.ENV_TUNE, "cache")
    hit2 = planner.plan_collectives(None, CommConfig(), topology=topo,
                                    msg_bytes=1 << 24, chunk_extent=64)
    assert hit2.algorithm == planner.FLAT and hit2.calibrated


def test_planner_no_cache_bit_identical(tune_cache):
    import dataclasses
    for comm in (CommConfig(), CommConfig(overlap_chunks=4),
                 CommConfig(a2a_impl="pipelined", overlap_chunks=8)):
        for msg in (1 << 10, 1 << 24):
            off = _plan(dataclasses.replace(comm, tuning="off"), msg=msg)
            miss = _plan(dataclasses.replace(comm, tuning="cache"), msg=msg)
            assert miss == off


def test_planner_stale_fingerprint_keeps_static(tune_cache):
    _store_calib(fingerprint_for(None, _topo(node=2), "model"),
                 intra_bw=1e8, inter_lat=1e-7)
    p = planner.plan_collectives(None, CommConfig(tuning="cache"),
                                 topology=_topo(node=4),
                                 msg_bytes=1 << 24, chunk_extent=64)
    assert p.algorithm == planner.HIERARCHICAL and not p.calibrated


def test_tuned_overlap_chunks(monkeypatch):
    monkeypatch.delenv(planner.ENV_VAR, raising=False)
    rows = (MeasuredRow("a2a", "pipelined", "bf16", 1 << 24, 2, 10e-6),
            MeasuredRow("a2a", "pipelined", "bf16", 1 << 24, 4, 4e-6),
            MeasuredRow("a2a", "flat", "bf16", 1 << 24, 1, 20e-6),
            MeasuredRow("a2a", "hierarchical", "bf16", 1 << 24, 1, 8e-6))
    calib = CalibratedCostModel(key="k", measured=rows)
    p = _plan(CommConfig(a2a_impl="pipelined", overlap_chunks=2),
              calibration=calib)
    assert p.algorithm == planner.PIPELINED and p.chunks == 4
    assert "tuned overlap_chunks 2->4" in p.reason
    p = _plan(CommConfig(overlap_chunks=2), calibration=calib)
    assert p.algorithm == planner.PIPELINED and p.chunks == 4
    p = _plan(CommConfig(), calibration=calib)
    assert p.algorithm == planner.HIERARCHICAL


def test_calibrated_plan_still_degrades(monkeypatch):
    monkeypatch.delenv(planner.ENV_VAR, raising=False)
    calib = CalibratedCostModel(key="k", intra_bw=1e8, inter_lat=1e-7)
    p = _plan(CommConfig(a2a_impl="hierarchical"), model=1,
              calibration=calib)
    assert p.algorithm == planner.FLAT and p.degraded and p.calibrated


def test_tuning_mode_resolution(monkeypatch):
    monkeypatch.delenv(runtime.ENV_TUNE, raising=False)
    assert runtime.tuning_mode(None) == "off"
    assert runtime.tuning_mode(CommConfig()) == "off"
    assert runtime.tuning_mode(CommConfig(tuning="probe")) == "probe"
    monkeypatch.setenv(runtime.ENV_TUNE, "cache")
    assert runtime.tuning_mode(CommConfig()) == "cache"
    assert runtime.tuning_mode(CommConfig(tuning="probe")) == "probe"
    monkeypatch.setenv(runtime.ENV_TUNE, "bogus")
    with pytest.raises(ValueError, match="unknown tuning mode"):
        runtime.tuning_mode(CommConfig())
    with pytest.raises(ValueError, match="unknown tuning mode"):
        _plan(CommConfig())


def test_wire_cost_uses_calibrated_constants(monkeypatch):
    monkeypatch.delenv(planner.ENV_VAR, raising=False)
    calib = CalibratedCostModel(key="k", intra_bw=1e7, inter_bw=1e7,
                                intra_lat=1e-3, inter_lat=1e-3)
    p_cal = _plan(CommConfig(a2a_impl="flat"), calibration=calib)
    p_off = _plan(CommConfig(a2a_impl="flat"))
    msg = 1 << 20
    assert topology.estimate_seconds(p_cal.wire_cost(msg)) > \
        topology.estimate_seconds(p_off.wire_cost(msg))


def test_train_cli_autotune_on_one_rank(tune_cache, capsys, monkeypatch):
    """``launch/train.py --autotune`` probes before step 0; on one rank
    there is no all-to-all to time, so nothing is stored and it trains on
    the static plan.  (The launcher sets $REPRO_TUNE where it is unset;
    set here, so that the test's end restores it.)"""
    from repro_torch.launch import train as train_cli
    monkeypatch.setenv(runtime.ENV_TUNE, "cache")
    assert train_cli.main(["--arch", "granite-moe-3b-a800m", "--smoke",
                           "--device", "cpu", "--steps", "1", "--batch",
                           "2", "--seq", "16", "--autotune"]) == 0
    out = capsys.readouterr().out
    assert '"kind": "train_summary"' in out
    assert "tune_calibrated" not in out
    assert os.listdir(tune_cache) == []


# ------------------------------------------------ the CLI on four ranks --

def _restart_main(rank, world, args):
    """A fresh process group: plan from the CLI's entry, run the probe
    suite, then ask with another node size and a copied entry."""
    from repro_torch.comm.topology import build_topology
    from repro_torch.tune.probe import run_probe_suite
    cdir, out_path = args
    os.environ[cache.ENV_CACHE] = cdir
    logging.basicConfig(level=logging.WARNING, stream=sys.stdout)
    mesh = tmesh.make_mesh(1, world, node_size=2)
    p = planner.plan_collectives(mesh, CommConfig(tuning="cache"),
                                 msg_bytes=1 << 14, chunk_extent=64)
    rows = run_probe_suite(mesh, build_topology(mesh), ladder=(4096,),
                           wire_formats=("bf16", "int8"),
                           chunk_candidates=(2,), warmup=0, iters=2,
                           device="cpu")
    fp1 = fingerprint_for(mesh, build_topology(mesh))
    other = tmesh.make_mesh(1, world, node_size=1)
    fp2 = fingerprint_for(other, build_topology(other))
    if rank == 0:
        shutil.copyfile(cache.entry_path(fp1), cache.entry_path(fp2))
    torch.distributed.barrier()
    p2 = planner.plan_collectives(other, CommConfig(tuning="cache"),
                                  msg_bytes=1 << 14, chunk_extent=64)
    np.savez(out_path.format(rank=rank), calibrated=p.calibrated,
             algorithm=p.algorithm, calibrated2=p2.calibrated,
             rows=np.array([[r.kind, r.name, r.wire_format,
                             str(r.msg_bytes), str(r.seconds)]
                            for r in rows]))
    return 0


def test_probe_cli_cache_restart_and_invalidation(tmp_path):
    cdir = str(tmp_path / "tune-cache")
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    for k in ("REPRO_TUNE", "REPRO_COMM_IMPL", "REPRO_NODE_SIZE",
              cache.ENV_CACHE):
        env.pop(k, None)
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.tune", "--device",
         "cpu", "--model", "4", "--node-size", "2", "--ladder",
         "4096,16384", "--wire-formats", "bf16", "--chunks", "2",
         "--iters", "2", "--warmup", "0", "--cache-dir", cdir],
        capture_output=True, text=True, timeout=300, cwd=tmp_path, env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    entries = os.listdir(cdir)
    assert len(entries) == 1 and entries[0].endswith(".json")
    assert "[tune] probe a2a hierarchical/bf16" in out.stdout
    assert out.stdout.count("fingerprint ") == 1      # rank 0 prints
    entry = json.load(open(os.path.join(cdir, entries[0])))
    assert entry["fingerprint"]["n_processes"] == 4
    assert {r[1] for r in entry["rows"] if r[0] == "a2a"} == {
        "flat", "hierarchical", "pipelined"}

    logs = tmesh.spawn_cpu_ranks(
        str(HERE), 4, [cdir, str(tmp_path / "r{rank}.npz")],
        store=str(tmp_path / "store"), env=env, timeout_s=300)
    for r in range(4):
        got = np.load(tmp_path / f"r{r}.npz")
        assert bool(got["calibrated"]), got["algorithm"]
        assert not bool(got["calibrated2"])
        rows = got["rows"]
        names = {(k, n, f) for k, n, f, _, _ in rows}
        for t in ("flat", "hierarchical", "pipelined"):
            for f in ("bf16", "int8"):
                assert ("a2a", t, f) in names, (t, f)
        assert ("kernel", "lsh_hash", "-") in names
        assert all(float(s) > 0 for *_, s in rows)
        a2a = [(f, int(b)) for k, _, f, b, _ in rows if k == "a2a"]
        assert max(b for f, b in a2a if f == "int8") < \
            min(b for f, b in a2a if f == "bf16")
        # every rank holds the same times (the largest over the ranks)
        np.testing.assert_array_equal(rows, np.load(
            tmp_path / "r0.npz")["rows"])
        assert "fingerprint mismatch" in logs[r] and "node_size" in logs[r]


if __name__ == "__main__":                  # RANK WORLD STORE args...
    sys.exit(tmesh.run_cpu_rank(sys.argv[1:], _restart_main))
