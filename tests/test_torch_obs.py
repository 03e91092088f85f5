"""The port's in-graph observability (src/repro_torch/obs/) against the JAX
package's, on the CPU.

- ``MetricBag`` and ``merge_stat``: the counter / gauge semantics, the
  same values as the JAX bag for the same operations.
- ``phase_scope``: a no-op unless activated; with obs off a profile of a
  training step holds no ``obs/`` range.
- The in-graph metrics of the granite-moe-3b-a800m smoke config in f32
  with ``ObsConfig(enabled=True)``, bf16 and int8 wires, LSH on and off:
  the port's train step against JAX's ``loss_fn`` (the reference kernel
  backend) on the same params and batch, mesh-free and at mesh (data,
  model) = (2, 2) (four gloo ranks against four forced host devices).
  ``obs_wire_bytes``, ``obs_raw_bytes`` and the ``comm_*`` gauges exactly;
  the other ``obs_*`` values and ``obs_compression_rate`` within 1e-6
  relative (the load imbalance, drop fraction and slot occupancy are
  ratios of integer counts, so they agree where the slots do).
- Obs on against off: the losses, the gradients and the params after two
  steps bitwise equal; under microbatching the metrics are the last
  microbatch's.
- ``model_phase_seconds`` against JAX's at the same ``device_flops`` and
  the same planned topology, within 1e-12 relative, and the step
  timeline's Chrome trace covering its steps (>= 0.999).
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # parallel test workers share the cores
if __name__ != "__main__":
    jax = pytest.importorskip("jax")

HERE = Path(__file__).resolve()
SRC = HERE.parents[1] / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

from repro_torch.launch import mesh as tmesh  # noqa: E402

ARCH = "granite-moe-3b-a800m"
MESH = (2, 2)
BATCH, SEQ = 4, 16
SETTINGS = [(fmt, lsh) for fmt in ("bf16", "int8") for lsh in (True, False)]
EXACT = ("obs_wire_bytes", "obs_raw_bytes", "obs_comm_algorithm",
         "obs_comm_degraded", "obs_comm_calibrated", "obs_comm_wire_format",
         "comm_algorithm", "comm_degraded", "comm_calibrated",
         "comm_wire_format")
CLOSE = ("obs_load_imbalance", "obs_drop_fraction", "obs_slot_occupancy",
         "obs_compression_rate")
OBS_RTOL = 1e-6


def _cfg(b, registry, fmt, lsh, obs=True):
    """The smoke config in f32, wire format ``fmt``, LSH on or off, obs on
    or off, the reference kernel backend (read by the JAX package only)."""
    cfg = registry.get_smoke_config(ARCH).replace(dtype="float32")
    return cfg.replace(moe=dataclasses.replace(
        cfg.moe, lsh=dataclasses.replace(cfg.moe.lsh, wire_format=fmt,
                                         enabled=lsh),
        obs=b.ObsConfig(enabled=obs), kernel_backend="reference"))


def _tag(fmt, lsh):
    return f"{fmt}-{'lsh' if lsh else 'nolsh'}"


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}{i}/").items()}
    return {prefix[:-1]: np.asarray(tree)}


def _unflat(flat):
    root = {}
    for key, v in flat.items():
        node, parts = root, key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def fix(t):
        if isinstance(t, dict):
            t = {k: fix(v) for k, v in t.items()}
            if t and all(k.isdigit() for k in t):
                return [t[str(i)] for i in range(len(t))]
        return t
    return fix(root)


def _check(got, want, tag):
    for k in EXACT:
        assert float(got[k]) == float(want[k]), (tag, k, got[k], want[k])
    for k in CLOSE:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=OBS_RTOL, err_msg=f"{tag} {k}")


# ----------------------------------------------------------- MetricBag --

def test_metric_bag_semantics_match_jax():
    import jax.numpy as jnp

    from repro.obs import metrics as jm
    from repro_torch.obs import metrics as tm
    ops = [("inc", "wire_bytes", 3.0), ("set", "load_imbalance", 1.5),
           ("inc", "raw_bytes", 7.25), ("inc", "wire_bytes", 0.5),
           ("set", "drop_fraction", 0.125)]
    jb, tb = jm.MetricBag.zeros(), tm.MetricBag.zeros()
    for op, name, v in ops:
        jb, tb = getattr(jb, op)(name, v), getattr(tb, op)(name, v)
    merged_j = jb.merge(jm.MetricBag.zeros().set("load_imbalance", 2.0)
                        .inc("wire_bytes", 1.0))
    merged_t = tb.merge(tm.MetricBag.zeros().set("load_imbalance", 2.0)
                        .inc("wire_bytes", 1.0))
    assert tm.MOE_SCHEMA == jm.MOE_SCHEMA
    assert merged_t.names == merged_j.names
    for name in merged_t.names:
        assert merged_t.get(name).dtype == torch.float32
        assert float(merged_t.get(name)) == float(merged_j.get(name)), name
    assert set(merged_t.as_metrics()) == set(merged_j.as_metrics())
    assert float(merged_t.get("wire_bytes")) == 4.5
    assert float(merged_t.get("load_imbalance")) == 2.0   # gauge: newer
    for mod in (jm, tm):
        with pytest.raises(ValueError):
            mod.MetricBag.zeros().inc("load_imbalance", 1.0)
        with pytest.raises(KeyError):
            mod.MetricBag.zeros().get("nope")
        with pytest.raises(ValueError):
            mod.MetricBag.zeros().merge(
                mod.MetricBag.zeros((("x", mod.COUNTER),)))
        with pytest.raises(ValueError):
            mod.MetricBag.zeros((("x", "histogram"),))
    assert jnp.asarray(merged_j.get("raw_bytes")) == 7.25


def test_merge_stat():
    from repro_torch.obs import metrics as tm
    a = tm.MetricBag.zeros().inc("wire_bytes", 2.0)
    b = tm.MetricBag.zeros().inc("wire_bytes", 3.0).set("drop_fraction", .5)
    m = tm.merge_stat(a, b)
    assert float(m.get("wire_bytes")) == 5.0
    assert float(m.get("drop_fraction")) == 0.5
    assert tm.merge_stat(None, b) is b and tm.is_bag(b)
    assert tm.merge_stat(a, None) is None and not tm.is_bag(None)


def test_phase_scope_gated():
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import tracing
    assert not tracing.active()
    assert isinstance(tracing.phase_scope(tracing.PH_GATE),
                      contextlib.nullcontext)
    x = torch.ones(4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.phase_scope(tracing.PH_GATE):
            (x * 2).sum()
        with tracing.activate(True):
            assert tracing.active()
            with tracing.activate(False):
                assert not tracing.active()
            with tracing.phase_scope(tracing.PH_EXPERT):
                (x * 3).sum()
    names = {e.name for e in prof.events()}
    assert tracing.PH_EXPERT in names and tracing.PH_GATE not in names
    assert tracing.PHASES[0] == "obs/gate" and len(tracing.PHASES) == 7


# ------------------------------------------- in-graph metrics, mesh-free --

@pytest.fixture(scope="module")
def jax_params():
    import jax

    from repro.configs import registry as jreg
    from repro.launch.mesh import make_host_mesh
    from repro.models import model as jmodel
    cfg = jreg.get_smoke_config(ARCH).replace(dtype="float32")
    return jmodel.init_params(jax.random.PRNGKey(0), cfg,
                              make_host_mesh(1, 1, 1))


def _jax_metrics(params, cfg, mesh, batch):
    import jax
    import jax.numpy as jnp

    from repro.compat import set_mesh
    from repro.models import model as jmodel
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with set_mesh(mesh):
        _, m = jax.jit(lambda p, b: jmodel.loss_fn(p, cfg, mesh, b))(
            params, jb)
    return {k: np.asarray(v) for k, v in m.items() if np.ndim(v) == 0}


@pytest.mark.parametrize("fmt,lsh", SETTINGS,
                         ids=[_tag(*s) for s in SETTINGS])
def test_obs_metrics_match_jax(jax_params, fmt, lsh):
    from repro.configs import base as jbase
    from repro.configs import registry as jreg
    from repro.data.synthetic import SyntheticLMDataset
    from repro.launch.mesh import make_host_mesh
    from repro_torch.configs import base as tbase
    from repro_torch.configs import registry as treg
    from repro_torch.convert import params_from_jax
    from repro_torch.runtime import step as tstep
    batch = SyntheticLMDataset(515, SEQ, BATCH).batch_at(0)
    want = _jax_metrics(jax_params, _cfg(jbase, jreg, fmt, lsh),
                        make_host_mesh(1, 1, 1), batch)
    tcfg = _cfg(tbase, treg, fmt, lsh)
    opt = tbase.OptimizerConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    params = params_from_jax(jax.tree.map(np.asarray, jax_params),
                             device="cpu")
    state = tstep.TrainState(params, tstep.adamw_init(params, opt))
    _, got = tstep.make_train_step(tcfg, opt)(
        state, tstep.batch_to_device(batch, torch.device("cpu")))
    _check(got, want, _tag(fmt, lsh))
    print(_tag(fmt, lsh), {k: float(got[k]) for k in CLOSE})


# ----------------------------------------------- in-graph metrics, mesh --

def _jax_main(inp_path, out_path):
    from repro.configs import base as jbase
    from repro.configs import registry as jreg
    from repro.data.synthetic import SyntheticLMDataset
    from repro.launch.mesh import make_host_mesh
    import jax as jx
    import jax.numpy as jnp

    params = jx.tree.map(jnp.asarray, _unflat(dict(np.load(inp_path))))
    mesh = make_host_mesh(MESH[0], 1, MESH[1])
    batch = SyntheticLMDataset(515, SEQ, BATCH).batch_at(0)
    out = {}
    for fmt, lsh in SETTINGS:
        m = _jax_metrics(params, _cfg(jbase, jreg, fmt, lsh), mesh, batch)
        out.update({f"{_tag(fmt, lsh)}/{k}": v for k, v in m.items()})
    np.savez(out_path, **out)


def _port_main(rank, world, args):
    inp_path, out_path = args
    from repro_torch.configs import base as tbase
    from repro_torch.configs import registry as treg
    from repro_torch.convert import params_from_jax, shard_params
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.runtime import step as tstep

    cpu = torch.device("cpu")
    mesh = tmesh.make_mesh(*MESH)
    jparams = _unflat(dict(np.load(inp_path)))
    opt = tbase.OptimizerConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    batch = tstep.batch_to_device(
        SyntheticLMDataset(515, SEQ, BATCH).batch_at(0), cpu)
    out = {}
    for fmt, lsh in SETTINGS:
        params = shard_params(params_from_jax(jparams, device=cpu), mesh)
        state = tstep.TrainState(params, tstep.adamw_init(params, opt))
        _, m = tstep.make_train_step(_cfg(tbase, treg, fmt, lsh), opt,
                                     mesh=mesh)(state, batch)
        out.update({f"{_tag(fmt, lsh)}/{k}": v.numpy() for k, v in m.items()
                    if v.ndim == 0})
    np.savez(out_path.format(rank=rank), **out)
    return 0


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory, jax_params):
    tmp = tmp_path_factory.mktemp("obs_mesh")
    # the (2, 2) mesh pads nothing (6 experts over 2), so the params made
    # on this process's one device are the mesh's
    inp_path = tmp / "params.npz"
    np.savez(inp_path, **_flat(jax.tree.map(np.asarray, jax_params)))
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    # one side after the other: the suite's other workers share the CPUs
    jax_run = subprocess.run(
        [sys.executable, str(HERE), "jax", str(inp_path),
         str(tmp / "jax.npz")], env=env, capture_output=True, text=True,
        timeout=600)
    assert jax_run.returncode == 0, jax_run.stderr[-4000:]
    tmesh.spawn_cpu_ranks(
        str(HERE), 4, [str(inp_path), str(tmp / "port_{rank}.npz")],
        store=str(tmp / "store"),
        env=dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1"),
        timeout_s=300)
    return {"jax": dict(np.load(tmp / "jax.npz")),
            "port": [dict(np.load(tmp / f"port_{r}.npz")) for r in range(4)]}


@pytest.mark.parametrize("fmt,lsh", SETTINGS,
                         ids=[_tag(*s) for s in SETTINGS])
def test_mesh_obs_metrics_match_jax(mesh_runs, fmt, lsh):
    tag = _tag(fmt, lsh)
    ref = {k[len(tag) + 1:]: v for k, v in mesh_runs["jax"].items()
           if k.startswith(tag + "/")}
    ports = [{k[len(tag) + 1:]: v for k, v in r.items()
              if k.startswith(tag + "/")} for r in mesh_runs["port"]]
    for r in ports[1:]:                 # every rank holds the global values
        for k in EXACT + CLOSE:
            assert float(r[k]) == float(ports[0][k]), (tag, k)
    _check(ports[0], ref, f"(2, 2) {tag}")
    print(f"(2, 2) {tag}", {k: float(ports[0][k]) for k in CLOSE})


# ------------------------------------------------------ obs on and off --

def _steps(cfg, steps=2, microbatch=0, batch=4):
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.runtime import step as tstep
    opt = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    ds = SyntheticLMDataset(cfg.vocab_size, SEQ, batch)
    state = tstep.init_train_state(cfg, opt, seed=0, device="cpu")
    step = tstep.make_train_step(cfg, opt, microbatch=microbatch)
    grads, losses, metrics = [], [], []
    orig = tstep.adamw_update

    def spy(params, g, *a, **k):
        grads.append([None if x is None else x.clone() for x in g])
        return orig(params, g, *a, **k)

    tstep.adamw_update = spy
    try:
        for s in range(steps):
            state, m = step(state, tstep.batch_to_device(
                ds.batch_at(s), torch.device("cpu")))
            losses.append(m["loss"].clone())
            metrics.append(m)
    finally:
        tstep.adamw_update = orig
    return losses, grads, tstep.leaves(state.params), metrics


@pytest.mark.parametrize("fmt", ["bf16", "int8"])
def test_obs_on_off_bitwise(fmt):
    from repro_torch.configs import base as tbase
    from repro_torch.configs import registry as treg
    off = _steps(_cfg(tbase, treg, fmt, True, obs=False))
    on = _steps(_cfg(tbase, treg, fmt, True, obs=True))
    for a, b in zip(off[0], on[0]):
        assert torch.equal(a, b)
    for ga, gb in zip(off[1], on[1]):
        for a, b in zip(ga, gb):
            assert (a is None and b is None) or torch.equal(a, b)
    for a, b in zip(off[2], on[2]):
        assert torch.equal(a, b)
    assert not any(k.startswith("obs_") for k in off[3][-1])
    assert "obs_compression_rate" in on[3][-1]


def test_obs_off_records_no_phase_range():
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import base as tbase
    from repro_torch.configs import registry as treg
    names = {}
    for obs in (False, True):
        cfg = _cfg(tbase, treg, "bf16", True, obs=obs)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _steps(cfg, steps=1)
        names[obs] = {e.name for e in prof.events()
                      if e.name.startswith("obs/")}
    assert names[False] == set()
    assert {"obs/gate", "obs/hash_compress", "obs/dispatch_a2a",
            "obs/expert_mlp", "obs/combine_a2a",
            "obs/decompress"} <= names[True]


def test_obs_metrics_under_microbatching():
    """microbatch=2 over a batch of 4: the obs_* metrics are the last
    microbatch's, the ones its rows give alone."""
    from repro_torch.configs import base as tbase
    from repro_torch.configs import registry as treg
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.models import model as tmodel
    from repro_torch.runtime import step as tstep
    cfg = _cfg(tbase, treg, "int8", True)
    _, _, _, metrics = _steps(cfg, steps=1, microbatch=2)
    rows = {k: v[2:] for k, v in tstep.batch_to_device(
        SyntheticLMDataset(cfg.vocab_size, SEQ, 4).batch_at(0),
        torch.device("cpu")).items()}
    params = tstep.init_train_state(cfg, tbase.OptimizerConfig(
        lr=1e-3, warmup_steps=1, total_steps=4), seed=0,
        device="cpu").params
    with torch.no_grad():
        _, want = tmodel.loss_fn(params, cfg, rows)
    for k in want:
        if k.startswith("obs_"):
            assert float(metrics[0][k]) == float(want[k]), k


# ------------------------------------------------- modeled phase split --

@pytest.mark.parametrize("model_r", [1, 4])
def test_model_phase_seconds_matches_jax(model_r):
    from repro.comm import planner as jplanner
    from repro.comm.topology import Topology as JTopology
    from repro.configs.base import CommConfig as JComm
    from repro.configs.registry import get_smoke_config as j_smoke
    from repro.obs import timeline as jtl
    from repro_torch.comm import planner as tplanner
    from repro_torch.comm.topology import Topology as TTopology
    from repro_torch.configs.base import CommConfig as TComm
    from repro_torch.configs.registry import get_smoke_config as t_smoke
    from repro_torch.obs import timeline as ttl
    consts = dict(axis_sizes=(("model", model_r),), node_size=0,
                  intra_bw=4.5e11, inter_bw=5e10, intra_lat=3e-6,
                  inter_lat=1e-5)
    jplanner.plan_collectives(comm=JComm(a2a_impl="flat"),
                              msg_bytes=1 << 20, axis_name="model",
                              topology=JTopology(**consts))
    tplanner.plan_collectives(comm=TComm(a2a_impl="flat"),
                              msg_bytes=1 << 20, axis_name="model",
                              topology=TTopology(**consts))
    for lsh in (True, False):
        jc, tc = j_smoke(ARCH), t_smoke(ARCH)
        jc = jc.replace(moe=dataclasses.replace(
            jc.moe, lsh=dataclasses.replace(jc.moe.lsh, enabled=lsh)))
        tc = tc.replace(moe=dataclasses.replace(
            tc.moe, lsh=dataclasses.replace(tc.moe.lsh, enabled=lsh)))
        want = jtl.model_phase_seconds(jc, None, batch=8, seq=32,
                                       device_flops=989.4e12)
        got = ttl.model_phase_seconds(tc, None, batch=8, seq=32,
                                      device_flops=989.4e12)
        assert set(got) == set(want) == set(ttl.PHASE_ORDER)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12,
                                       atol=0, err_msg=k)
        assert (got["dispatch_a2a"] > 0) == (model_r > 1)
        np.testing.assert_allclose(ttl.comm_share(got),
                                   jtl.comm_share(want), rtol=1e-12)


def test_hw_constants_and_active_params():
    """hw.py holds the H100 SXM's datasheet rates and is the comm cost
    model's NVLink prior; active_param_count is the JAX function's."""
    from repro.configs.base import active_param_count as j_active
    from repro.configs.registry import get_config as j_config
    from repro_torch import hw
    from repro_torch.comm import topology
    from repro_torch.configs.base import active_param_count, param_count
    from repro_torch.configs.registry import get_config, get_smoke_config
    assert (hw.DEVICE_FLOPS, hw.FP32_FLOPS, hw.HBM_BYTES_PER_S,
            hw.NVLINK_BYTES_PER_S) == (989.4e12, 67e12, 3.35e12, 450e9)
    assert topology.DEFAULT_INTRA_BW == hw.NVLINK_BYTES_PER_S
    assert topology.Topology(axis_sizes=()).intra_bw == 450e9
    for cfg in (get_config(ARCH), get_smoke_config(ARCH)):
        assert active_param_count(cfg) < param_count(cfg)
    assert active_param_count(get_config(ARCH)) == j_active(j_config(ARCH))
    dense = get_smoke_config(ARCH).replace(layout=(("attn", "dense"),))
    assert active_param_count(dense) == param_count(dense)


def test_step_timeline_export_covers_steps(tmp_path):
    from repro_torch.obs import events as ev
    from repro_torch.obs import export
    from repro_torch.obs import timeline as ttl
    clock = iter([0.0, 1.0, 2.0, 4.0])
    tl = ttl.StepTimeline({"dispatch_a2a": 3.0, "expert_mlp": 6.0,
                           "combine_a2a": 3.0}, clock=lambda: next(clock),
                          wall=lambda: 100.0)
    for s in range(2):
        tl.start(s)
        tl.stop()
    assert tl.comm_share() == pytest.approx(0.5)
    assert tl.mean_step_seconds() == pytest.approx(1.5)
    path = export.write_chrome_trace(
        str(tmp_path / export.TRACE_NAME), tl,
        [ev.Event("step", 100.5, step=0, data={"loss": 1.0})])
    trace = export.load_chrome_trace(path)
    assert export.span_coverage(trace) >= 0.999
    assert any(e.get("ph") == "i" and e["name"] == "step"
               for e in trace["traceEvents"])
    m = export.write_metrics_json(str(tmp_path / export.METRICS_NAME), tl,
                                  {"extra": 1.0})
    with open(m) as f:
        got = json.load(f)
    assert got["steps"] == 2.0 and got["extra"] == 1.0
    assert got["comm_share"] == pytest.approx(0.5)


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_main(*sys.argv[2:])
    else:                                   # RANK WORLD STORE args...
        sys.exit(tmesh.run_cpu_rank(sys.argv[1:], _port_main))
