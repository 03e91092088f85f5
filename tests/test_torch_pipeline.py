"""The port's 1F1B pipeline (runtime/pipeline_schedule.py) against its own
accumulation and the JAX package's, on the CPU.

- The schedule, the stage cut and the timeline are pure arithmetic and
  equal the reference's: ``build_1f1b``'s grids, ``a2a_slot`` and the
  bubble fraction at the reference's test shapes, the errors of the
  degenerate ones, ``stage_bounds``, ``classify_a2a`` and
  ``reconstruct_grid``; so do ``stage_transfer_cost``,
  ``plan_stage_transfers`` and a fingerprint with a pipe axis.
- The staged step is bit for bit ``make_accum_grad_fn`` with microbatches
  of rows / n: loss, every metric and every gradient.  Eager PyTorch
  reorders no sum, so the contract the reference states holds exactly
  here (under JAX 0.9.0 XLA reassociates the reference's own staged
  gradients in their last bits).  Mesh-free with 4 stages (the f32 and
  the bf16 model, untied and tied embeddings); on 4 gloo ranks at mesh
  (data, pipe, model) = (1, 2, 2) with LSH on and the int8 wire, and at
  (2, 2, 1) with LSH off and the bf16 wire, where the two pipe columns'
  gradients are also bit-equal and one train step through
  ``make_train_step`` (which takes the 1F1B step on a pipe mesh) gives
  the params of ``apply_gradients`` on the accumulation.
- Against JAX, from JAX's params (convert.py): the qwen3-moe-30b-a3b smoke
  config in f32 with the f32 wire, LSH on, 2 stages and 2 microbatches:
  the port's staged loss within 1e-5 relative and each gradient within
  1e-4 relative L2 of JAX's ``make_pipeline_grad_fn`` (on 2 forced host
  devices) and of its ``make_accum_grad_fn``, the bounds of
  test_torch_train.py's f32 wire; and one whole-batch train step of the
  same config, loss within 1e-5 and params within 1e-5 relative L2.
- The launcher under ``torchrun --nproc-per-node 4`` with ``--mesh-pipe 2
  --mesh-model 2`` on the qwen3-moe-30b-a3b smoke config (the reference's
  tests/test_pipeline.py launcher case): exit 0, the bubble plan on the
  model axis and the stage hand-offs on pipe, the 1F1B rows in trace.json
  and metrics.json's keys those the JAX launcher writes for that run.

Ranks are ``python <this file> RANK WORLD STORE ...`` subprocesses
(``launch.mesh.spawn_cpu_ranks``); the JAX side is one ``python <this
file> jax OUT`` subprocess with two forced host devices, started first
and read last.
"""
import dataclasses
import hashlib
import json
import os
import pickle
import re
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

from repro_torch.comm import planner as tplanner  # noqa: E402
from repro_torch.comm import topology as ttopo  # noqa: E402
from repro_torch.configs.base import OptimizerConfig  # noqa: E402
from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.data.synthetic import SyntheticLMDataset  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.obs import timeline as ttimeline  # noqa: E402
from repro_torch.runtime import pipeline_schedule as tpipe  # noqa: E402
from repro_torch.runtime import step as tstep  # noqa: E402

QWEN = "qwen3-moe-30b-a3b"
GRANITE = "granite-moe-3b-a800m"
CPU = torch.device("cpu")
_SHAPES = [(1, 1), (1, 4), (2, 2), (2, 4), (3, 5), (4, 4), (4, 8)]
OPT = dict(lr=1e-3, warmup_steps=10, total_steps=100)
# (mesh (data, pipe, model), LSH on, wire format), on 4 gloo ranks
MESHES = {"1x2x2": ((1, 2, 2), True, "int8"),
          "2x2x1": ((2, 2, 1), False, "bf16")}
# the keys of metrics.json that the JAX launcher writes for the launcher
# case below (repro.launch.train with the same arguments on 4 forced host
# devices)
JAX_PIPE_METRICS = (
    "ce", "comm_algorithm", "comm_calibrated", "comm_degraded", "comm_s",
    "comm_share", "comm_wire_format", "grad_skips", "loss", "lr",
    "mean_step_s", "moe_aux", "obs_comm_algorithm", "obs_comm_calibrated",
    "obs_comm_degraded", "obs_comm_wire_format", "obs_compression_rate",
    "obs_drop_fraction", "obs_load_imbalance", "obs_raw_bytes",
    "obs_slot_occupancy", "obs_wire_bytes", "steps", "weight_combine_a2a",
    "weight_decompress", "weight_dispatch_a2a", "weight_expert_mlp",
    "weight_gate", "weight_hash_compress", "weight_other",
    "weight_stage_transfer", "z_loss")


def _cfg(arch, *, dtype="float32", blocks=4, n_mb=4, tie=False,
         wire_format="bf16", wire_dtype=None):
    cfg = get_smoke_config(arch).replace(
        dtype=dtype, num_super_blocks=blocks, pipeline_microbatches=n_mb,
        tie_embeddings=tie)
    lsh = dataclasses.replace(cfg.moe.lsh, wire_format=wire_format,
                              **({"wire_dtype": wire_dtype} if wire_dtype
                                 else {}))
    return cfg.replace(moe=dataclasses.replace(cfg.moe, lsh=lsh))


def _same(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return a.dtype == b.dtype and torch.equal(a, b)


def _digest(t) -> str:
    return "none" if t is None else hashlib.sha256(
        t.detach().reshape(-1).contiguous().view(torch.uint8).numpy()
        .tobytes()).hexdigest()[:16]


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.detach().clone()


def _compare(cfg, params, batch, *, mesh=None, stages=None, use_lsh=None):
    """(staged, accumulated) -> which of loss, metrics and grads are
    bit-equal, and the staged gradients."""
    rows = batch["tokens"].shape[0]
    n_mb = cfg.pipeline_microbatches or stages
    la, ma, ga = tstep.make_accum_grad_fn(
        cfg, use_lsh=use_lsh, microbatch=rows // n_mb, mesh=mesh)(params,
                                                                  batch)
    lp, mp, gp = tpipe.make_pipeline_grad_fn(
        cfg, mesh, use_lsh=use_lsh, stages=stages)(params, batch)
    same = {"loss": _same(la, lp),
            "metric keys": sorted(ma) == sorted(mp),
            "metrics": all(_same(ma[k], mp[k]) for k in ma),
            "grads": len(ga) == len(gp) and all(
                _same(a, b) for a, b in zip(ga, gp))}
    return same, (la, ma, ga), gp


# ------------------------------------------------------------- schedule --

@pytest.mark.parametrize("S,M", _SHAPES)
def test_build_1f1b_matches_jax(S, M):
    from repro.runtime import pipeline_schedule as jpipe
    want, got = jpipe.build_1f1b(S, M), tpipe.build_1f1b(S, M)
    assert (got.stages, got.microbatches, got.grid) == \
        (want.stages, want.microbatches, want.grid)
    assert got.ticks == (2 * (M + S - 1) if S > 1 else 2 * M)
    assert got.bubble_fraction() == want.bubble_fraction()
    assert tpipe.bubble_fraction(S, M) == jpipe.bubble_fraction(S, M)
    assert got.bubble_fraction() == pytest.approx(tpipe.bubble_fraction(S, M))
    for s in range(S):
        assert got.bubbles(s) == want.bubbles(s)
        for mb in range(M):
            assert got.a2a_slot(s, mb) == want.a2a_slot(s, mb)
            slot = got.a2a_slot(s, mb)
            assert slot == -1 if (s, mb) == (0, 0) else (
                got.grid[s][slot] is None or got.grid[s][slot][1] != mb)


def test_degenerate_schedules_and_cuts_raise_as_jax():
    from repro.models import model as jmodel
    from repro.runtime import pipeline_schedule as jpipe
    for args in ((0, 4), (2, 0)):
        with pytest.raises(ValueError) as want:
            jpipe.build_1f1b(*args)
        with pytest.raises(ValueError, match=re.escape(str(want.value))):
            tpipe.build_1f1b(*args)
    for nsb, stages in ((4, 2), (4, 1), (5, 2), (7, 3), (48, 4), (4, 4)):
        assert tmodel.stage_bounds(nsb, stages) == \
            jmodel.stage_bounds(nsb, stages)
    for nsb, stages in ((2, 3), (4, 0)):
        with pytest.raises(ValueError) as want:
            jmodel.stage_bounds(nsb, stages)
        with pytest.raises(ValueError, match=re.escape(str(want.value))):
            tmodel.stage_bounds(nsb, stages)
    # the stage's layers are whole super-blocks of params["layers"]
    layers = list(range(12))
    assert tmodel.stage_blocks(layers, 1, 3, 3) == list(range(3, 9))


def test_staged_step_raises_as_jax():
    cfg = _cfg(GRANITE)
    params = tmodel.init_params(cfg, seed=0, device=CPU)
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLMDataset(
        cfg.vocab_size, 16, 6).batch_at(0).items()}
    with pytest.raises(ValueError, match="batch rows 6 not divisible by "
                                         "pipeline microbatches 4"):
        tpipe.make_pipeline_grad_fn(cfg, stages=2)(params, batch)
    with pytest.raises(ValueError, match=re.escape(
            "stages=5 > num_super_blocks=4")):
        tpipe.make_pipeline_grad_fn(cfg, stages=5)
    with pytest.raises(ValueError, match="'pipe' axis"):
        tpipe.make_pipeline_grad_fn(cfg)
    with pytest.raises(NotImplementedError, match="mutually exclusive"):
        tstep.make_train_step(cfg.replace(dp_only=True), OptimizerConfig(),
                              mesh=tmesh.Mesh((1, 2, 1)))


# ------------------------------------------------------------- timeline --

@pytest.mark.parametrize("S,M", [(2, 2), (2, 4), (3, 5), (4, 8)])
def test_classify_and_reconstruct_match_jax(S, M):
    from repro.obs import timeline as jtimeline
    from repro.runtime import pipeline_schedule as jpipe
    js, ts = jpipe.build_1f1b(S, M), tpipe.build_1f1b(S, M)
    key = ("stage", "microbatch", "tick", "status", "hidden")
    assert [tuple(getattr(a, k) for k in key)
            for a in ttimeline.classify_a2a(ts)] == \
        [tuple(getattr(a, k) for k in key)
         for a in jtimeline.classify_a2a(js)]
    key = ("stage", "tick", "phase", "microbatch", "start", "duration")
    assert [tuple(getattr(u, k) for k in key)
            for u in ttimeline.reconstruct_grid(ts, 100.0, 1.0)] == \
        [tuple(getattr(u, k) for k in key)
         for u in jtimeline.reconstruct_grid(js, 100.0, 1.0)]


def test_chrome_trace_has_the_stage_rows():
    from repro.obs import export as jexport
    from repro.obs import timeline as jtimeline
    from repro.runtime import pipeline_schedule as jpipe
    from repro_torch.obs import export as texport
    got = []
    for tl_lib, ex, sched in ((ttimeline, texport, tpipe.build_1f1b(2, 4)),
                              (jtimeline, jexport, jpipe.build_1f1b(2, 4))):
        clock = iter(np.arange(0.0, 10.0, 0.5).tolist()).__next__
        tl = tl_lib.StepTimeline(clock=clock, wall=clock)
        tl.start(0)
        tl.stop()
        evs = ex.chrome_trace(tl, (), schedule=sched)["traceEvents"]
        got.append([(e["ph"], e["name"], e.get("tid"), e.get("args"))
                    for e in evs if e.get("tid", 0) >= ex.TID_STAGE0])
    assert got[0] == got[1] and len(got[0]) == 2 + 16 + 8


# ------------------------------------------------------- plans and costs --

def _topos(data=1, pipe=4, model=8, node=4):
    from repro.comm import topology as jtopo
    sizes = (("data", data), ("pipe", pipe), ("model", model))
    return (jtopo.Topology(axis_sizes=sizes, node_size=node),
            ttopo.Topology(axis_sizes=sizes, node_size=node))


def test_stage_transfer_cost_and_plans_match_jax():
    from repro.comm import planner as jplanner
    from repro.comm import topology as jtopo
    from repro.configs.base import CommConfig as JComm
    from repro_torch.configs.base import CommConfig
    for pipe, node, msg in ((4, 2, 1 << 20), (2, 2, 1 << 20), (1, 4, 1024),
                            (4, 0, 12288)):
        jt, tt = _topos(pipe=pipe, node=node)
        jt = dataclasses.replace(jt, **{k: getattr(tt, k) for k in (
            "intra_bw", "inter_bw", "intra_lat", "inter_lat")})
        want = jtopo.stage_transfer_cost(jt, msg)
        got = ttopo.stage_transfer_cost(tt, msg)
        assert [(c.hop, c.messages, c.bytes, c.seconds) for c in got] == \
            [(c.hop, c.messages, c.bytes, c.seconds) for c in want]
        wp = jplanner.plan_stage_transfers(None, JComm(), msg_bytes=msg,
                                           topology=jt)
        tp = tplanner.plan_stage_transfers(None, CommConfig(),
                                           msg_bytes=msg, topology=tt)
        assert (tp.algorithm, tp.axis_name, tp.intra, tp.reason,
                tp.degraded) == (wp.algorithm, wp.axis_name, wp.intra,
                                 wp.reason, wp.degraded)
        assert tplanner.last_plan("pipe") is tp
    # the bubble plan inside a pipeline, flat or 2-hop base as the message
    # clears min_hierarchical_bytes
    for msg in (1 << 24, 1024):
        jt, tt = _topos()
        with jplanner.pipeline_context(4, 8, 0.3):
            want = jplanner.plan_collectives(None, JComm(), topology=jt,
                                             msg_bytes=msg)
        with tplanner.pipeline_context(4, 8, 0.3):
            got = tplanner.plan_collectives(None, CommConfig(), topology=tt,
                                            msg_bytes=msg)
        assert (got.algorithm, got.base, got.transport, got.reason) == \
            (want.algorithm, want.base, want.transport, want.reason)
    assert tplanner.current_pipeline_context() is None
    # one stage or one microbatch: the plan of no pipeline at all
    jt, tt = _topos(pipe=1)
    base = tplanner.plan_collectives(None, CommConfig(), topology=tt,
                                     msg_bytes=1 << 24)
    for ctx in ((1, 1, 0.0), (4, 1, 0.0)):
        with tplanner.pipeline_context(*ctx):
            p = tplanner.plan_collectives(None, CommConfig(), topology=tt,
                                          msg_bytes=1 << 24)
        assert (p.algorithm, p.reason, p.base) == \
            (base.algorithm, base.reason, base.base)


def test_fingerprint_carries_pipe_axis(tmp_path, monkeypatch):
    """A (data, pipe, model) fingerprint keeps the pipe axis, as the
    reference's does, so a 3-D mesh and a 2-D one of the same ranks key
    differently, and round-trips through the tuning cache."""
    from repro.tune.fingerprint import fingerprint_for as jfp
    from repro_torch.tune import cache
    from repro_torch.tune.fingerprint import Fingerprint, fingerprint_for
    from repro_torch.tune.model import CalibratedCostModel
    monkeypatch.setenv(cache.ENV_CACHE, str(tmp_path))
    jt, tt = _topos(data=1, pipe=4, model=2, node=2)
    fp3 = fingerprint_for(tmesh.Mesh((1, 4, 2)), tt, "model")
    want = jfp(None, jt, "model")
    assert fp3.axis_sizes == want.axis_sizes == (
        ("data", 1), ("pipe", 4), ("model", 2))
    assert fp3.node_size == want.node_size and fp3.n_devices == 8
    assert Fingerprint.from_dict(fp3.to_dict()) == fp3
    cache.store(fp3, CalibratedCostModel(key=fp3.key(),
                                         intra_bw=1e9).to_payload())
    assert CalibratedCostModel.from_payload(
        fp3.key(), cache.load(fp3)).intra_bw == 1e9
    fp2 = fingerprint_for(tmesh.Mesh((4, 2)), ttopo.Topology(
        axis_sizes=(("data", 4), ("model", 2)), node_size=2), "model")
    assert fp2.key() != fp3.key() and "axis_sizes" in fp3.diff(fp2)
    assert cache.load(fp2) is None


# ------------------------------------------------- bitwise, one process --

@pytest.mark.parametrize("arch,dtype,tie,fmt", [
    (GRANITE, "float32", False, "bf16"),
    (QWEN, "bfloat16", False, "int8"),
    (QWEN, "bfloat16", True, "bf16")],
    ids=["granite-f32", "qwen-bf16-int8", "qwen-bf16-tied"])
def test_staged_step_is_the_accumulation_bitwise(arch, dtype, tie, fmt):
    """Mesh-free, 4 stages of one super-block, 4 microbatches of 2 rows:
    loss, metrics and gradients bit-equal to the accumulation; the tied
    embedding's two uses summed as autograd sums them."""
    cfg = _cfg(arch, dtype=dtype, tie=tie, wire_format=fmt)
    params = tmodel.init_params(cfg, seed=0, device=CPU)
    assert ("head" in params) == (not tie)
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLMDataset(
        cfg.vocab_size, 16, 8).batch_at(0).items()}
    same, (la, _, ga), _ = _compare(cfg, params, batch, stages=4)
    assert all(same.values()), same
    assert np.isfinite(float(la)) and sum(g is not None for g in ga) > 20
    sched = tpipe.build_1f1b(4, 4)
    assert tplanner.last_plan("pipe").degraded      # no mesh, no pipe axis
    assert sched.bubble_fraction() == 3 / 7


# ------------------------------------------------- ranks, JAX, launcher --

def _rank_main(rank, world, args):
    """Each MESHES setting on this rank: the staged step against the
    accumulation, the gradients' digests, the plans, and one train step
    through make_train_step against apply_gradients."""
    (out_path,) = args
    from repro_torch.optim.adam import adamw_init, leaves
    from repro_torch.runtime import sharding
    out = {}
    for key, (shape, lsh, fmt) in MESHES.items():
        mesh = tmesh.make_mesh(shape[0], shape[2], pipe=shape[1])
        cfg = _cfg(QWEN, wire_format=fmt)
        params = tmodel.init_params(cfg, seed=0, device=CPU, mesh=mesh)
        batch = {k: torch.from_numpy(v) for k, v in SyntheticLMDataset(
            cfg.vocab_size, 16, 8).batch_at(0).items()}
        same, (la, ma, ga), gp = _compare(cfg, params, batch, mesh=mesh,
                                          use_lsh=lsh)
        plans = {a: tplanner.last_plan(a) for a in ("model", "pipe")}
        opt = OptimizerConfig(**OPT)

        def fresh():
            tree = _clone(params)
            return tstep.TrainState(tree, adamw_init(tree, opt))
        step = tstep.make_train_step(cfg, opt, use_lsh=lsh, mesh=mesh)
        s_p, m_p = step(fresh(), batch)
        s_a, m_a = tstep.apply_gradients(fresh(), opt, la, ma, ga,
                                         mesh=mesh,
                                         specs=tstep.mesh_specs(cfg, mesh))
        same["train step params"] = all(
            _same(a, b) for a, b in zip(leaves(s_p.params),
                                        leaves(s_a.params)))
        same["train step norm"] = _same(m_p["grad_norm"], m_a["grad_norm"])
        out[key] = dict(
            same=same, digests=[_digest(g) for g in gp],
            loss=float(la), coords=[mesh.axis_index(a)
                                    for a in ("data", "pipe", "model")],
            plans={a: None if p is None else [p.algorithm, p.base,
                                              p.reason]
                   for a, p in plans.items()},
            slice=sharding.axis_size(mesh, "data")
            * sharding.axis_size(mesh, "model"))
    with open(out_path.format(rank=rank), "w") as f:
        json.dump(out, f)
    return 0


def _jax_main(out_path):
    """The JAX side: params on a (1, 2, 1) host mesh, the staged and the
    accumulated grads of the qwen3 smoke config (f32 wire, 2 stages, 2
    microbatches), and one whole-batch train step on one device."""
    import jax
    import jax.numpy as jnp

    from repro.compat import set_mesh
    from repro.configs.base import OptimizerConfig as JOpt
    from repro.configs.registry import get_smoke_config as jget
    from repro.data.synthetic import SyntheticLMDataset as JData
    from repro.launch.mesh import make_host_mesh
    from repro.models.model import init_params
    from repro.optim.adam import adamw_init
    from repro.runtime import step as jstep
    from repro.runtime.pipeline_schedule import make_pipeline_grad_fn

    cfg = jget(QWEN).replace(dtype="float32", pipeline_microbatches=2)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, lsh=dataclasses.replace(
        cfg.moe.lsh, wire_dtype="float32")))
    batch = JData(cfg.vocab_size, 16, 4).batch_at(0)

    def host(params, tree):
        return jax.tree.map(
            lambda p, x: np.asarray(x) if jnp.issubdtype(p.dtype,
                                                         jnp.floating)
            else np.zeros(p.shape, np.float32), params, tree)

    out = {}
    mesh = make_host_mesh(1, 2, 1)
    with set_mesh(mesh):
        params = init_params(jax.random.PRNGKey(0), cfg, mesh)
        out["params"] = jax.tree.map(np.asarray, params)
        for name, fn in (
                ("accum", jstep.make_accum_grad_fn(cfg, mesh, microbatch=2)),
                ("pipe", make_pipeline_grad_fn(cfg, mesh))):
            loss, _, grads = jax.jit(fn)(params, batch)
            out[name] = (float(loss), host(params, grads))
    one = make_host_mesh(1, 1, 1)
    with set_mesh(one):
        opt = JOpt(**OPT)
        p1 = jax.tree.map(jnp.asarray, out["params"])
        state = jstep.TrainState(p1, adamw_init(p1, opt))
        state, m = jax.jit(jstep.make_train_step(cfg, opt, one))(state,
                                                                 batch)
        out["train"] = (float(m["loss"]),
                        jax.tree.map(np.asarray, state.params))
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    return 0


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX subprocess, the 4 gloo ranks and the launcher under
    torchrun; JAX runs beside the other two."""
    tmp = tmp_path_factory.mktemp("pipeline")
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    jax_proc = subprocess.Popen(
        [sys.executable, str(HERE), "jax", str(tmp / "jax.pkl")],
        env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=2"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        tmesh.spawn_cpu_ranks(str(HERE), 4, [str(tmp / "r{rank}.json")],
                              store=str(tmp / "store"), env=env,
                              timeout_s=300)
        ranks = [json.load(open(tmp / f"r{r}.json")) for r in range(4)]
        d = tmp / "launch"
        launch = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
             "--arch", QWEN, "--smoke", "--device", "cpu", "--mesh-pipe",
             "2", "--mesh-model", "2", "--pipeline-microbatches", "4",
             "--steps", "2", "--batch", "8", "--seq", "32", "--log-every",
             "1", "--metrics-dir", str(d)],
            capture_output=True, text=True, timeout=300, cwd=tmp, env=env)
        _, err = jax_proc.communicate(timeout=600)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.wait()
    assert jax_proc.returncode == 0, err[-4000:]
    with open(tmp / "jax.pkl", "rb") as f:
        jax_out = pickle.load(f)
    return ranks, jax_out, launch, d


@pytest.mark.parametrize("key", list(MESHES))
def test_staged_step_bitwise_on_gloo_ranks(runs, key):
    ranks = runs[0]
    shape = MESHES[key][0]
    for rank, got in enumerate(ranks):
        r = got[key]
        assert all(r["same"].values()), (rank, r["same"])
        assert r["slice"] == shape[0] * shape[2]
        assert r["coords"] == [rank // (shape[1] * shape[2]),
                               rank // shape[2] % shape[1],
                               rank % shape[2]]
        model_plan, pipe_plan = r["plans"]["model"], r["plans"]["pipe"]
        assert "stage hand-offs" in pipe_plan[2]
        if shape[2] > 1:
            assert model_plan[:2] == ["bubble", "flat"]
    # the pipe columns compute the same thing: equal gradient bits
    for rank, got in enumerate(ranks):
        d, p, m = got[key]["coords"]
        for other in ranks:
            od, op, om = other[key]["coords"]
            if (od, om) == (d, m):
                assert other[key]["digests"] == got[key]["digests"]
                assert other[key]["loss"] == got[key]["loss"]


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_staged_step_matches_jax(runs):
    """From JAX's params: the port's staged loss and gradients against
    JAX's staged ones and its accumulation's (which differ from each
    other in their last bits under JAX 0.9.0)."""
    from repro_torch.convert import params_from_jax
    from repro_torch.optim.adam import leaves
    jax_out = runs[1]
    cfg = _cfg(QWEN, blocks=2, n_mb=2, wire_dtype="float32")
    params = params_from_jax(jax_out["params"], device=CPU)
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLMDataset(
        cfg.vocab_size, 16, 4).batch_at(0).items()}
    loss, _, grads = tpipe.make_pipeline_grad_fn(cfg, stages=2)(params,
                                                               batch)
    ps = leaves(params)
    for name in ("pipe", "accum"):
        jl, jg = jax_out[name]
        assert abs(float(loss) - jl) <= 1e-5 * abs(jl), name
        want = leaves(params_from_jax(jg, device=CPU))
        assert len(want) == len(grads) == len(ps)
        worst = 0.0
        for p, g, w in zip(ps, grads, want):
            if not p.is_floating_point():
                assert g is None
                continue
            if not w.any():             # the detached hash rotations
                assert not g.any()
                continue
            worst = max(worst, _rel_l2(g.numpy(), w.numpy()))
        print(f"against JAX's {name}: loss {float(loss)} / {jl}, worst "
              f"gradient rel L2 {worst:.3g}")
        assert worst < 1e-4, name


def test_qwen3_smoke_train_step_matches_jax(runs):
    """One whole-batch train step of the qwen3-moe-30b-a3b smoke config
    (f32, f32 wire) from JAX's params: loss within 1e-5 relative, params
    after AdamW within 1e-5 relative L2."""
    from repro_torch.convert import params_from_jax
    from repro_torch.optim.adam import adamw_init, leaves
    jl, jparams = runs[1]["train"]
    cfg = _cfg(QWEN, blocks=2, n_mb=0, wire_dtype="float32")
    params = params_from_jax(runs[1]["params"], device=CPU)
    opt = OptimizerConfig(**OPT)
    state = tstep.TrainState(params, adamw_init(params, opt))
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLMDataset(
        cfg.vocab_size, 16, 4).batch_at(0).items()}
    state, m = tstep.make_train_step(cfg, opt)(state, batch)
    assert abs(float(m["loss"]) - jl) <= 1e-5 * abs(jl)
    worst = 0.0
    for p, w in zip(leaves(state.params),
                    leaves(params_from_jax(jparams, device=CPU))):
        if p.is_floating_point():
            worst = max(worst, _rel_l2(p.detach().numpy(), w.numpy()))
        else:
            assert torch.equal(p, w)
    assert worst < 1e-5, worst


def test_launcher_trains_a_pipe_mesh_under_torchrun(runs):
    launch, d = runs[2], runs[3]
    assert launch.returncode == 0, launch.stderr[-4000:]
    out = launch.stdout
    assert "[comm] plan: bubble on axis 'model'" in out
    assert "on axis 'pipe' (pipeline: 1 stage hand-offs" in out
    steps = [json.loads(line) for line in out.splitlines()
             if line.startswith('{"') and '"kind": "step"' in line]
    assert [s["step"] for s in steps] == [0, 1]
    assert all(s["comm"] == "bubble/bf16" and np.isfinite(s["loss"])
               for s in steps)
    [summary] = [json.loads(line) for line in out.splitlines()
                 if '"kind": "train_summary"' in line]
    assert summary["pipe_columns_bit_equal"] is True
    assert summary["mesh"] == {"data": 1, "pipe": 2, "model": 2}
    trace = json.load(open(d / "trace.json"))["traceEvents"]
    rows = {t: [e["name"] for e in trace if e.get("tid") == t
                and e["ph"] == "X"] for t in (100, 101)}
    sched = tpipe.build_1f1b(2, 4)
    for s, t in enumerate((100, 101)):
        want = [f"{u[0]}{u[1]}" for u in sched.grid[s] if u is not None]
        assert rows[t] == want * 2                  # 2 steps
    marks = [e["args"]["status"] for e in trace if e.get("ph") == "i"
             and str(e.get("name", "")).startswith("a2a mb")]
    assert len(marks) == 2 * 2 * 4 and "cold_start" in marks
    m = json.load(open(d / "metrics.json"))
    assert not set(JAX_PIPE_METRICS) - set(m)
    assert m["weight_stage_transfer"] > 0 and m["comm_algorithm"] == 3.0


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        sys.exit(_jax_main(sys.argv[2]))
    sys.exit(tmesh.run_cpu_rank(sys.argv[1:], _rank_main))
