"""The port's measured profile, drift, anomaly and bench-row modules
(src/repro_torch/obs/) and the launchers' --profile, --anomaly-exit and
--bench-json, on the CPU, against the JAX package where it has the same
function.

- ``parse_torch_trace`` on a real CPU ``torch.profiler`` trace of a smoke
  training step with the phase ranges on: every MoE phase present, and
  the backward attributed to its forward's phase by autograd's sequence
  numbers (each phase holds more ops in the forward-and-backward trace
  than in a forward-only one, and more ops and time than in the same
  trace with the links stripped).
- The parser on a hand-written GPU-style trace: kernels linked to their
  launches by correlation id, a backward on the autograd thread linked
  by a flow and by (forward thread, sequence number) where sequence
  numbers of two threads collide, a checkpointed block's recompute, an
  NCCL kernel, a copy, the device-side mirrors of the ranges (ignored):
  the exact seconds of every phase.
- ``reconcile``, the five detectors (hypothesis streams),
  ``AnomalyMonitor`` and ``AnomalyEscalator`` (a fake clock) give the
  outputs and events of JAX's for the same inputs; bench rows written by
  either package load in the other, and ``compare`` gives the same
  verdicts; the drift lands in the tune cache's entry.
- The launchers: ``train.py --device cpu --smoke --metrics-dir D
  --profile 1 --anomaly-exit`` writes events.jsonl, trace.json and a
  metrics.json holding every key the JAX launcher writes for the same
  arguments; --profile without --metrics-dir is a usage error; a chaos
  run whose steps stall persistently exits 43; under torchrun on two
  ranks the measured phases are the ranks' mean; ``serve.py
  --bench-json`` writes a row JAX's ``load_rows`` accepts.
"""
import dataclasses
import gzip
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # parallel test workers share the cores
pytest.importorskip("jax")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.obs import anomaly as janomaly  # noqa: E402
from repro.obs import benchrow as jbench  # noqa: E402
from repro.obs import events as jevents  # noqa: E402
from repro.obs import reconcile as jreconcile  # noqa: E402
from repro.resilience import supervisor as jsup  # noqa: E402
from repro_torch.obs import anomaly as tanomaly  # noqa: E402
from repro_torch.obs import benchrow as tbench  # noqa: E402
from repro_torch.obs import events as tevents  # noqa: E402
from repro_torch.obs import profile as tprofile  # noqa: E402
from repro_torch.obs import reconcile as treconcile  # noqa: E402
from repro_torch.resilience import supervisor as tsup  # noqa: E402

HERE = Path(__file__).resolve()
SRC = HERE.parents[1] / "src"
ARCH = "granite-moe-3b-a800m"
MOE_PHASES = ("gate", "hash_compress", "dispatch_a2a", "expert_mlp",
              "combine_a2a", "decompress")


@pytest.fixture
def logs():
    """Memory sinks on both packages' event logs."""
    j, t = jevents.MemorySink(), tevents.MemorySink()
    jevents.global_log().add_sink(j)
    tevents.global_log().add_sink(t)
    yield j, t
    jevents.global_log().remove_sink(j)
    tevents.global_log().remove_sink(t)


# ------------------------------------------------ the parser, CPU trace --

def _smoke_trace(tmp_path, name, backward, remat="full"):
    """A CPU torch.profiler trace of one smoke step (int8 wire, LSH on,
    the phase ranges on), forward only or forward and backward."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import ObsConfig
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.models import model as tmodel
    from repro_torch.runtime import step as tstep
    cfg = get_smoke_config(ARCH).replace(remat_policy=remat)
    cfg = cfg.replace(moe=dataclasses.replace(
        cfg.moe, obs=ObsConfig(enabled=True),
        lsh=dataclasses.replace(cfg.moe.lsh, wire_format="int8")))
    params = tmodel.init_params(cfg, seed=0, device="cpu")
    batch = tstep.batch_to_device(
        SyntheticLMDataset(cfg.vocab_size, 32, 2).batch_at(0),
        torch.device("cpu"))
    train = [p for p in tstep.leaves(params) if p.is_floating_point()]
    for p in train:
        p.requires_grad_(backward)

    def run():
        with torch.set_grad_enabled(backward):
            loss, _ = tmodel.loss_fn(params, cfg, batch)
            if backward:
                torch.autograd.grad(loss, train, allow_unused=True)
    run()                              # warm-up: one-time set-up costs
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    path = str(tmp_path / f"{name}.json")
    prof.export_chrome_trace(path)
    return path


def _strip_links(path, out):
    """The trace without flows and sequence numbers: no backward link."""
    with open(path) as f:
        trace = json.load(f)
    evs = [e for e in trace["traceEvents"] if e.get("cat") != "fwdbwd"]
    for e in evs:
        (e.get("args") or {}).pop("Sequence number", None)
    with open(out, "w") as f:
        json.dump({"traceEvents": evs}, f)
    return out


def test_parse_cpu_trace_attributes_backward(tmp_path):
    fwd = tprofile.parse_torch_trace(_smoke_trace(tmp_path, "fwd", False))
    path = _smoke_trace(tmp_path, "fwdbwd", True)
    both = tprofile.parse_torch_trace(path)
    unlinked = tprofile.parse_torch_trace(
        _strip_links(path, str(tmp_path / "unlinked.json")))
    assert not both.device and both.n_events > fwd.n_events
    for p in MOE_PHASES:
        assert fwd.phase_seconds.get(p, 0.0) > 0.0, p
        # more ops in each phase with the backward than without; the same
        # trace's seconds move out of the phase when the links are cut
        # (host times of two runs are too noisy to compare directly)
        assert both.phase_events[p] > fwd.phase_events[p], p
        assert both.phase_events[p] > unlinked.phase_events.get(p, 0), p
        assert both.phase_seconds[p] > unlinked.phase_seconds.get(p, 0.0), p
    # the links only move time between the phases
    assert sum(both.phase_seconds.values()) == pytest.approx(
        sum(unlinked.phase_seconds.values()), rel=1e-9)
    assert both.phase_seconds["other"] < unlinked.phase_seconds["other"]
    s = both.summary()
    assert s["measured_steps"] == 1.0 and s["measured_on_device"] == 0.0
    assert s["measured_step_s"] == pytest.approx(both.step_seconds())
    print({p: (fwd.phase_seconds[p], both.phase_seconds[p])
           for p in MOE_PHASES})


def test_parse_cpu_trace_with_recompute(tmp_path):
    """remat "nothing" recomputes each block in the backward: the
    recomputed ops run inside the ranges again and land in their phases."""
    both = tprofile.parse_torch_trace(
        _smoke_trace(tmp_path, "remat", True, remat="nothing"))
    for p in MOE_PHASES:
        assert both.phase_seconds.get(p, 0.0) > 0.0, p


# ------------------------------------------ the parser, GPU-style trace --

def _x(name, ts, dur, tid=10, cat="cpu_op", **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def _launch(ts, corr, tid=10, cat="cuda_runtime", name="cudaLaunchKernel"):
    return _x(name, ts, 2, tid=tid, cat=cat, correlation=corr)


def _kernel(name, ts, dur, corr, cat="kernel", stream=7):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": stream,
            "ts": ts, "dur": dur, "args": {"correlation": corr}}


def _flow(ph, fid, ts, tid):
    e = {"ph": ph, "cat": "fwdbwd", "name": "fwdbwd", "id": fid, "pid": 1,
         "tid": tid, "ts": ts}
    if ph == "f":
        e["bp"] = "e"
    return e


SEQ, FWD = "Sequence number", "Fwd thread id"
EVAL = "autograd::engine::evaluate_function: "


def _gpu_fixture():
    """Main thread 10 runs the forward; thread 20 is the autograd engine's,
    where a checkpointed block's ops are recomputed with the engine
    thread's own sequence numbers (0 and 1, which the main thread uses
    too).  Kernel durations are distinct primes of microseconds."""
    ev = [
        # forward, main thread (forward thread id 1 in backward events)
        _x("obs/gate", 0, 100, cat="user_annotation"),
        _x("aten::mm", 10, 50, **{SEQ: 5, FWD: 0}),
        _launch(20, 1),
        _x("obs/dispatch_a2a", 100, 100, cat="user_annotation"),
        _x("AllToAll", 110, 80, **{SEQ: 6, FWD: 0}),
        _launch(120, 2, cat="cuda_driver", name="cuLaunchKernelEx"),
        _x("aten::add", 200, 20, **{SEQ: 1, FWD: 0}),       # no range
        _launch(205, 3),
        _x("obs/decompress", 225, 50, cat="user_annotation"),
        _x("aten::mul", 230, 30, **{SEQ: 0, FWD: 0}),
        _launch(235, 9),
        _launch(240, 11, name="cudaMemcpyAsync"),
        # backward on the autograd thread
        _x(EVAL + "MmBackward0", 300, 100, tid=20, **{SEQ: 5, FWD: 1}),
        _x("MmBackward0", 301, 98, tid=20, **{SEQ: 5, FWD: 1}),
        _x("aten::mm", 310, 80, tid=20),
        _launch(320, 4, tid=20),
        _x(EVAL + "AllToAllBackward", 400, 90, tid=20, **{SEQ: 6, FWD: 1}),
        _launch(410, 5, tid=20, cat="cuda_driver", name="cuLaunchKernelEx"),
        # the recompute of a checkpointed block, inside its range
        _x("obs/expert_mlp", 500, 100, tid=20, cat="user_annotation"),
        _x("aten::bmm", 510, 30, tid=20, **{SEQ: 0, FWD: 0}),
        _launch(515, 7, tid=20),
        _x("aten::silu", 550, 30, tid=20, **{SEQ: 1, FWD: 0}),
        _launch(555, 12, tid=20),
        _x(EVAL + "BmmBackward0", 700, 100, tid=20, **{SEQ: 0, FWD: 2}),
        _x("BmmBackward0", 701, 98, tid=20, **{SEQ: 0, FWD: 2}),
        _launch(720, 8, tid=20),
        _x(EVAL + "SiluBackward0", 800, 50, tid=20, **{SEQ: 1, FWD: 2}),
        _launch(810, 10, tid=20),
        _x(EVAL + "MulBackward0", 850, 40, tid=20, **{SEQ: 0, FWD: 1}),
        _launch(860, 13, tid=20),
        _x(EVAL + "AddBackward0", 900, 40, tid=20, **{SEQ: 1, FWD: 1}),
        _launch(910, 6, tid=20),
        # flows for two of the nodes
        _flow("s", 1, 10, 10), _flow("f", 1, 301, 20),
        _flow("s", 2, 510, 20), _flow("f", 2, 701, 20),
        # device side
        _kernel("void (anonymous namespace)::positions_in_expert_kernel"
                "<true>(int const*)", 25, 2, 1),
        _kernel("ncclDevKernel_SendRecv(ncclDevComm*)", 125, 31, 2),
        _kernel("vectorized_elementwise_kernel<add>", 210, 5, 3),
        _kernel("gemm_bwd", 330, 7, 4),
        _kernel("ncclDevKernel_SendRecv(ncclDevComm*)", 420, 11, 5),
        _kernel("bwd_add", 920, 13, 6),
        _kernel("gemm_recompute", 520, 17, 7),
        _kernel("gemm_recompute_bwd", 730, 19, 8),
        _kernel("mul", 240, 23, 9),
        _kernel("silu_bwd", 820, 29, 10),
        _kernel("Memcpy DtoD (Device -> Device)", 250, 3, 11,
                cat="gpu_memcpy"),
        _kernel("silu", 560, 37, 12),
        _kernel("mul_bwd", 870, 41, 13),
        _kernel("orphan", 990, 1, 99),
        {"ph": "X", "cat": "gpu_user_annotation", "name": "obs/gate",
         "pid": 0, "tid": 7, "ts": 25, "dur": 500},
        {"ph": "X", "cat": "Trace", "name": "PyTorch Profiler (0)",
         "pid": "Spans", "tid": "x", "ts": 0, "dur": 1000},
    ]
    return {"traceEvents": ev}


GPU_WANT_US = {"gate": 2 + 7, "dispatch_a2a": 31 + 11,
               "expert_mlp": 17 + 19 + 29 + 37, "decompress": 23 + 3 + 41,
               "other": 5 + 13 + 1}


@pytest.mark.parametrize("steps,flows", [(1, "all"), (2, "all"),
                                         (1, "main")])
def test_parse_gpu_fixture_exact(steps, flows):
    """``flows`` "main": only the main thread's node has a flow, so the
    engine thread's recompute ops are linked by sequence number alone;
    AddBackward0 (main thread, seq 1, its op in no range) must not take
    aten::silu's phase (engine thread, seq 1)."""
    trace = _gpu_fixture()
    if flows == "main":
        trace["traceEvents"] = [e for e in trace["traceEvents"]
                                if e.get("cat") != "fwdbwd"
                                or e.get("id") == 1]
    m = tprofile.parse_trace_events(trace, steps=steps)
    assert m.device and m.n_events == 14
    assert set(m.phase_seconds) == set(GPU_WANT_US)
    for p, us in GPU_WANT_US.items():
        assert m.phase_seconds[p] == pytest.approx(us * 1e-6 / steps,
                                                   rel=1e-12), p
    assert m.phase_events == {"gate": 2, "dispatch_a2a": 2,
                              "expert_mlp": 4, "decompress": 3, "other": 3}
    assert m.other_names == {"vectorized_elementwise_kernel<add>": 1,
                             "bwd_add": 1, "orphan": 1}
    assert m.phase_nccl_seconds == pytest.approx(
        {"dispatch_a2a": 42e-6 / steps})
    assert m.summary()["measured_dispatch_a2a_nccl_s"] == pytest.approx(
        42e-6 / steps)
    comm = (31 + 11) / sum(GPU_WANT_US.values())
    assert m.comm_share() == pytest.approx(comm)
    assert m.summary()["measured_expert_mlp_launches"] == 4 / steps


def test_parse_gpu_fixture_without_flows():
    """Without flows the sequence number alone links a backward event:
    the engine thread's numbers collide with the main thread's (0 and 1),
    so the first forward op of a number that has a phase wins, as on a
    one-thread trace."""
    trace = _gpu_fixture()
    trace["traceEvents"] = [e for e in trace["traceEvents"]
                            if e.get("cat") != "fwdbwd"]
    m = tprofile.parse_trace_events(trace)
    # BmmBackward0 (seq 0) takes aten::mul's decompress; SiluBackward0 and
    # AddBackward0 (seq 1) take aten::silu's expert_mlp (aten::add has
    # no phase)
    want = {"gate": 2 + 7, "dispatch_a2a": 31 + 11,
            "expert_mlp": 17 + 37 + 29 + 13, "decompress": 23 + 3 + 41 + 19,
            "other": 5 + 1}
    for p, us in want.items():
        assert m.phase_seconds[p] == pytest.approx(us * 1e-6, rel=1e-12), p


def test_find_trace_file_and_gz(tmp_path):
    d = tmp_path / "torch_trace"
    d.mkdir()
    with gzip.open(d / "rank0.pt.trace.json.gz", "wt") as f:
        json.dump(_gpu_fixture(), f)
    assert tprofile.find_trace_file(str(tmp_path)).endswith(".json.gz")
    m = tprofile.parse_torch_trace(str(d))
    assert m.phase_seconds["gate"] == pytest.approx(9e-6)
    with pytest.raises(FileNotFoundError):
        tprofile.find_trace_file(str(tmp_path / "nothing"))


def test_reduce_over_one_rank_is_identity():
    m = tprofile.parse_trace_events(_gpu_fixture())
    assert tprofile.reduce_over_ranks(m, None, "cpu") is m


# ------------------------------------------------- reconcile and drift --

@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 10**6))
def test_reconcile_matches_jax(seed):
    rng = np.random.default_rng(seed)
    names = ("gate", "hash_compress", "dispatch_a2a", "expert_mlp",
             "combine_a2a", "decompress", "other")
    modeled = {n: float(v) for n, v in zip(names, rng.exponential(
        1.0, len(names)) * (rng.random(len(names)) > 0.2))}
    measured = {n: float(v) for n, v in zip(names, rng.exponential(
        1.0, len(names)) * (rng.random(len(names)) > 0.2))}
    j = jreconcile.reconcile(modeled, measured)
    t = treconcile.reconcile(modeled, measured)
    assert t.to_metrics() == j.to_metrics()
    assert t.to_payload() == j.to_payload()
    assert t.stale == j.stale


def test_drift_events_match_jax(logs):
    modeled = {"gate": 0.01, "dispatch_a2a": 0.4, "expert_mlp": 0.3,
               "combine_a2a": 0.4, "other": 1.0}
    measured = {"gate": 0.05, "dispatch_a2a": 0.05, "expert_mlp": 0.5,
                "combine_a2a": 0.05, "other": 0.8}
    jreconcile.emit_drift_events(jreconcile.reconcile(modeled, measured),
                                 step=3)
    j_events = list(logs[0].events)
    logs[0].events.clear()
    treconcile.emit_drift_events(treconcile.reconcile(modeled, measured),
                                 step=3)
    assert len(logs[1].events) > 1
    assert [(e.kind, e.step, e.data) for e in logs[1].events] == \
        [(e.kind, e.step, e.data) for e in j_events]
    assert tevents.render(logs[1].events[0]).startswith("[drift]")


def test_record_stale_calibration(tmp_path, monkeypatch):
    from repro_torch.comm.topology import build_topology
    from repro_torch.configs.base import CommConfig
    from repro_torch.tune import cache
    from repro_torch.tune.fingerprint import fingerprint_for
    from repro_torch.tune.model import CalibratedCostModel
    monkeypatch.setenv(cache.ENV_CACHE, str(tmp_path))
    report = treconcile.reconcile({"dispatch_a2a": 1.0, "other": 1.0},
                                  {"dispatch_a2a": 0.01, "other": 1.0})
    assert report.stale
    # nothing calibrated, nothing to go stale
    assert treconcile.record_stale_calibration(None, CommConfig(),
                                               report) is None
    fp = fingerprint_for(None, build_topology(None), "model")
    cache.store(fp, CalibratedCostModel(key=fp.key(),
                                        intra_bw=1e9).to_payload())
    path = treconcile.record_stale_calibration(None, CommConfig(), report)
    assert path == cache.entry_path(fp)
    assert cache.load(fp)["drift"]["reprobe_recommended"] is True


# ------------------------------------------------------------ anomaly --

def _stream(seed, n=60):
    """A step-time-like stream: noise, a slow stretch, a spike, a NaN."""
    rng = np.random.default_rng(seed)
    v = 1.0 + 0.05 * rng.standard_normal(n)
    a = int(rng.integers(10, n - 10))
    v[a:a + int(rng.integers(1, 8))] *= float(rng.uniform(1.2, 3.0))
    v[int(rng.integers(5, n))] = float(rng.uniform(5, 50))
    if rng.random() < 0.3:
        v[int(rng.integers(0, n))] = float("nan")
    return [float(x) for x in v]


def _fired(mod, name, values, **kw):
    det = getattr(mod, name)(**kw)
    out = []
    for i, v in enumerate(values):
        a = det.observe(i, v)
        if a is not None:
            d = a.to_event_data()
            out.append((a.step, {k: ("nan" if isinstance(x, float)
                                     and math.isnan(x) else x)
                                 for k, x in d.items()}))
    return out


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 10**6))
def test_detectors_match_jax(seed):
    vals = _stream(seed)
    flags = [1.0 if x > 1.3 else 0.0 for x in vals]
    for name, stream, kw in (
            ("StepTimeRegression", vals, {}),
            ("DriftDetector", vals, {"window": 8, "cooldown": 5}),
            ("LossSpike", vals, {}),
            ("ThresholdBreach", vals, {"threshold": 1.3, "consecutive": 2}),
            ("PersistentStraggler", flags, {"window": 10, "count": 3})):
        assert _fired(tanomaly, name, stream, **kw) == \
            _fired(janomaly, name, stream, **kw), name


def test_monitor_and_escalator_match_jax(logs):
    """The default detectors over a run that slows down for good, with an
    escalator on a fake clock: the same anomalies, the same escalation
    and the same events in both packages."""
    signals = [{"step_time": 1.0 + 0.01 * (i % 3), "loss": 3.0 - 0.01 * i,
                "comm_share": 0.3, "straggler": 0.0,
                "load_imbalance": 1.5} for i in range(12)]
    signals += [{"step_time": 2.5, "loss": 2.8, "comm_share": 0.3,
                 "straggler": 1.0, "load_imbalance": 5.0}
                for _ in range(6)]
    out = {}
    for pkg, anomaly, sup, sink in (("jax", janomaly, jsup, logs[0]),
                                    ("torch", tanomaly, tsup, logs[1])):
        t = iter(range(1000))
        esc = sup.AnomalyEscalator(limit=3, window_s=100.0,
                                   clock=lambda t=t: float(next(t)))
        mon = anomaly.AnomalyMonitor()
        mon.add_consumer(esc.consume)
        exit_at = None
        for i, s in enumerate(signals):
            mon.observe(i, s)
            if esc.should_exit and exit_at is None:
                exit_at = i
        out[pkg] = (mon.counts(), exit_at,
                    [(e.kind, e.step, e.data) for e in sink.events])
    assert out["torch"] == out["jax"]
    assert out["torch"][1] is not None
    assert any(k == "anomaly_escalation" for k, _, _ in out["torch"][2])


def test_escalator_window_expires_old_marks():
    now = [0.0]
    esc = tsup.AnomalyEscalator(limit=2, window_s=10.0,
                                clock=lambda: now[0])
    a = tanomaly.Anomaly("step_time_regression", 1, "step_time", 2.0, 1.0,
                         1.4, "slow")
    assert not esc.consume(a)
    now[0] = 20.0
    assert not esc.consume(a)               # the first mark expired
    assert esc.consume(a)
    assert not tsup.AnomalyEscalator().consume(
        tanomaly.Anomaly("loss_spike", 1, "loss", 9.0, 1.0, 2.0, "x"))


# ------------------------------------------------------------ benchrow --

def test_bench_rows_cross_validate(tmp_path):
    assert tbench.GATED_METRICS == jbench.GATED_METRICS
    assert tbench.KINDS == jbench.KINDS
    assert tbench.SCHEMA_VERSION == jbench.SCHEMA_VERSION
    for i, (writer, reader) in enumerate(((tbench, jbench),
                                          (jbench, tbench))):
        d = str(tmp_path / f"d{i}")
        for k, p50 in enumerate((1.0, 1.1, 0.9, 2.5)):
            row = writer.bench_row(
                name="serve_x", kind="serve", ts=100.0 + k,
                metrics={"latency_p50_s": p50, "latency_p99_s": 2 * p50,
                         "tokens_per_s_device": 10.0 / p50})
            path = writer.append_row(d, row)
        rows = reader.load_rows(path)
        assert len(rows) == 4
        for r in rows:
            reader.validate_row(r, name="serve_x")
        jc, tc = jbench.compare(rows), tbench.compare(rows)
        assert tc.describe() == jc.describe()
        assert not tc.ok and [d.metric for d in tc.regressions] == \
            [d.metric for d in jc.regressions]
    for mod in (tbench, jbench):
        with pytest.raises(ValueError):
            mod.bench_row(name="bad name", kind="serve",
                          metrics={"x": 1.0})
        with pytest.raises(ValueError):
            mod.bench_row(name="x", kind="train",
                          metrics={"x": float("inf")})


# ------------------------------------------------------------ launchers --

def _env():
    return dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1",
                JAX_PLATFORMS="cpu")


STALL_S = 2.0          # an injected input stall before step 2
COMMON = ["--arch", ARCH, "--smoke", "--steps", "3", "--batch", "2",
          "--seq", "32", "--log-every", "1", "--profile", "1",
          "--anomaly-exit", "--chaos", f"data_stall@2:{STALL_S}"]


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """The port's and JAX's launchers with the same arguments, one after
    the other (the suite's other workers share the CPUs)."""
    tmp = tmp_path_factory.mktemp("launch")
    cmds = {"torch": ["repro_torch.launch.train", *COMMON, "--device",
                      "cpu", "--metrics-dir", str(tmp / "torch")],
            "jax": ["repro.launch.train", *COMMON, "--metrics-dir",
                    str(tmp / "jax")]}
    out = {}
    for k, cmd in cmds.items():
        r = subprocess.run([sys.executable, "-m", *cmd], env=_env(),
                           capture_output=True, text=True, cwd=tmp,
                           timeout=600)
        assert r.returncode == 0, (k, r.stderr[-4000:])
        out[k] = r.stdout
    return tmp, out


def test_train_profile_writes_artifacts(launched):
    tmp, out = launched
    d = tmp / "torch"
    evs = tevents.read_jsonl(str(d / "events.jsonl"))
    kinds = {e.kind for e in evs}
    assert {"step", "train_summary", "model_drift"} <= kinds
    trace = json.load(open(d / "trace.json"))
    from repro_torch.obs import export
    assert export.span_coverage(trace) >= 0.999
    assert (d / "torch_trace" / "rank0.pt.trace.json").exists()
    m = json.load(open(d / "metrics.json"))
    assert m["steps"] == 3.0 and m["measured_steps"] == 1.0
    assert m["measured_devices"] == 1.0 and m["measured_on_device"] == 0.0
    for p in MOE_PHASES:
        assert m[f"measured_{p}_s"] > 0.0, p
    assert m["obs_compression_rate"] == pytest.approx(
        m["obs_wire_bytes"] / m["obs_raw_bytes"])
    assert "model_drift_score" in m and "[drift]" in out["torch"]


def test_train_metrics_keys_cover_jax(launched):
    tmp, _ = launched
    t = json.load(open(tmp / "torch" / "metrics.json"))
    j = json.load(open(tmp / "jax" / "metrics.json"))
    missing = sorted(set(j) - set(t))
    assert not missing, missing


def test_step_time_excludes_the_chaos_stall(launched):
    """Both launchers start a step's clock after the chaos hook: under
    ``--chaos data_stall@2:2.0`` the stall fired before step 2 in each,
    and neither's step 2 counts it (its ``dt`` far below the stall,
    where a smoke step takes some 20 ms)."""
    tmp, _ = launched
    read = {"torch": tevents.read_jsonl, "jax": jevents.read_jsonl}
    for side, reader in read.items():
        evs = reader(str(tmp / side / "events.jsonl"))
        stalls = [e for e in evs if e.kind == "chaos"
                  and e.data.get("fault") == "data_stall"]
        assert [e.step for e in stalls] == [2], (side, stalls)
        dt = {e.step: e.data["dt"] for e in evs if e.kind == "step"}
        assert sorted(dt) == [0, 1, 2], (side, dt)
        assert dt[2] < STALL_S / 2, (side, dt)


def test_train_profile_requires_metrics_dir():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--steps", "2", "--profile", "1"],
        capture_output=True, text=True, env=_env(), timeout=120)
    assert out.returncode == 2
    assert "--profile requires --metrics-dir" in out.stderr


def test_anomaly_exit_on_persistent_stall(tmp_path, monkeypatch, capsys):
    """Steps 8-10 of a smoke run whose steps take some 20 ms each spend
    0.6 s more inside the step (the launcher in this process, its step
    function wrapped to sleep there: an input stall injected by
    ``--chaos`` is not a step's time): three step-time regressions
    escalate to a checkpoint and exit 43, before step 11.  The straggler
    factor of 10 keeps a loaded host's 2x jitter in steps 2-7 from being
    flagged: with one such flag, the slow steps 8 and 9 would make a
    persistent_straggler pattern and escalate at step 9."""
    import signal
    import time

    from repro_torch.launch import train as train_cli
    from repro_torch.runtime import step as tstep
    make = tstep.make_train_step

    def slow_make(*args, **kw):
        fn = make(*args, **kw)

        def step(state, batch):
            if int(state.opt.step) in (8, 9, 10):
                time.sleep(0.6)
            return fn(state, batch)
        return step

    monkeypatch.setattr(tstep, "make_train_step", slow_make)
    d = tmp_path / "m"
    sigterm = signal.getsignal(signal.SIGTERM)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # as the launcher tests' OMP_NUM_THREADS
    try:
        rc = train_cli.main(
            ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "14",
             "--batch", "2", "--seq", "32", "--log-every", "1",
             "--metrics-dir", str(d), "--straggler-factor", "10",
             "--ckpt", str(tmp_path / "ck"), "--anomaly-exit"])
    finally:
        signal.signal(signal.SIGTERM, sigterm)
        torch.set_num_threads(threads)
    assert rc == 43, capsys.readouterr().out[-3000:]
    evs = tevents.read_jsonl(str(d / "events.jsonl"))
    esc = [e for e in evs if e.kind == "anomaly_escalation"]
    assert len(esc) == 1 and esc[0].data["exit_code"] == 43
    assert esc[0].step == 10
    assert max(e.step for e in evs if e.kind == "step") == 10
    assert sorted(os.listdir(tmp_path / "ck"))    # the state was saved
    m = json.load(open(d / "metrics.json"))
    assert m["anomaly_step_time_regression"] == 3.0


def test_train_profile_under_torchrun(tmp_path):
    d = tmp_path / "m"
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--arch", ARCH, "--smoke", "--device", "cpu", "--mesh-model", "2",
         "--steps", "3", "--batch", "2", "--seq", "32", "--log-every", "1",
         "--metrics-dir", str(d), "--profile", "1"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
        env=_env())
    assert out.returncode == 0, out.stderr[-4000:]
    assert sorted(os.listdir(d / "torch_trace")) == [
        "rank0.pt.trace.json", "rank1.pt.trace.json"]
    m = json.load(open(d / "metrics.json"))
    assert m["measured_devices"] == 2.0
    assert m["measured_dispatch_a2a_s"] > 0 and m["measured_combine_a2a_s"] > 0
    own = tprofile.parse_torch_trace(
        str(d / "torch_trace" / "rank0.pt.trace.json"))
    other = tprofile.parse_torch_trace(
        str(d / "torch_trace" / "rank1.pt.trace.json"))
    for p in MOE_PHASES:
        assert m[f"measured_{p}_s"] == pytest.approx(
            (own.phase_seconds.get(p, 0.0)
             + other.phase_seconds.get(p, 0.0)) / 2, rel=1e-9), p
    assert m["obs_comm_algorithm"] == 0.0 and m["comm_share"] > 0.0


def test_serve_bench_row_loads_in_jax(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--requests", "2", "--gen", "4",
         "--prompt-len", "4", "--bench-json", str(tmp_path),
         "--metrics-dir", str(tmp_path / "m")],
        capture_output=True, text=True, env=_env(), timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    rows = jbench.load_rows(jbench.bench_file(str(tmp_path), "serve_smoke"))
    assert len(rows) == 1 and rows[0]["kind"] == "serve"
    assert {"latency_p50_s", "latency_p99_s", "tokens_per_s",
            "tokens_per_s_device", "requests", "tokens"} <= set(
        rows[0]["metrics"])
    lines = [json.loads(x) for x in out.stdout.splitlines()
             if x.startswith("{")]
    assert [e["kind"] for e in lines] == ["serve_request"] * 2 + [
        "serve_summary"]
    assert "[bench] serve row 'serve_smoke'" in out.stdout
    evs = tevents.read_jsonl(str(tmp_path / "m" / "events.jsonl"))
    assert [e.kind for e in evs][-1] == "bench_row"
