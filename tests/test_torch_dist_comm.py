"""The port's training step and decode layer over four CPU ranks (gloo)
with the 2-hop and the chunk-pipelined transports, against the JAX
package's on four forced host devices.

- The granite-moe-3b-a800m smoke config in f32, LSH on, 2 steps, with
  the f32 (``wire_dtype="float32"``) and int8 wires: at mesh (data,
  model) = (1, 4) with two ranks a node and ``a2a_impl="hierarchical"``
  (the 6 experts pad to 8), and at (2, 2) with ``a2a_impl="pipelined",
  overlap_chunks=2``.  Each step's loss and clip norm and every param
  after the second AdamW step (expert shards gathered) against JAX's
  ``make_accum_grad_fn`` + ``apply_gradients`` on the same mesh and
  config, to the bounds of test_torch_dist_train.py's
  ``test_mesh_train_step_matches_jax``: the f32 wire within 1e-5
  relative (loss, clip norm, params); the int8 wire's first step within
  1e-4 (loss) and 1e-3 (clip norm), its second within 2e-2 and 5e-2, and
  its params within 1e-3 relative L2.  The pipelined runs need no wider
  bound: each rank's chunked MLP gives the same forward bits here, and
  the weight gradients' chunk sums stay within those bounds.  Every rank
  reports the plan it ran (hierarchical with intra 2, pipelined with 2
  chunks).
- The decode layer (``moe_dense_dispatch``) at (1, 4) and (2, 2) through
  the pipelined plan, and at (1, 4) through the 2-hop: y within 1e-5 of
  JAX's planned decode under the same transport, aux and z within 1e-5,
  load exact (the reference's ``test_decode_dense_dispatch_planned_parity``).

The JAX side runs in one subprocess a mesh, the two side by side; each
makes the params on its mesh (the padding needs the mesh) and writes them
first, so that the port's ranks start while it trains.
"""
import dataclasses
import os
import subprocess
import sys
import time
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

from repro_torch.launch import mesh as tmesh  # noqa: E402

ARCH = "granite-moe-3b-a800m"
BATCH, SEQ, STEPS = 4, 16, 2
NODE = 2
# run: (mesh, comm settings)
RUNS = {"hierarchical": ((1, 4), dict(a2a_impl="hierarchical",
                                      node_size=NODE)),
        "pipelined": ((2, 2), dict(a2a_impl="pipelined",
                                   overlap_chunks=2))}
WIRES = {"f32": ("float32", "bf16"), "int8": ("bfloat16", "int8")}
BOUNDS = {"f32": (((1e-5, 1e-5), (1e-5, 1e-5)), 1e-5),
          "int8": (((1e-4, 1e-3), (2e-2, 5e-2)), 1e-3)}
DECODES = (("pipelined", (1, 4)), ("pipelined", (2, 2)),
           ("hierarchical", (1, 4)))
H, F, E, TOP_K = 16, 32, 6, 2
BD, SD = 4, 2
OPT = dict(lr=1e-3, warmup_steps=10, total_steps=100)


def _cfg(b, registry, run, wire):
    cfg = registry.get_smoke_config(ARCH).replace(dtype="float32")
    wd, fmt = WIRES[wire]
    moe = dataclasses.replace(
        cfg.moe, comm=b.CommConfig(**RUNS[run][1]),
        lsh=dataclasses.replace(cfg.moe.lsh, wire_dtype=wd,
                                wire_format=fmt))
    return cfg.replace(moe=moe)


def _decode_cfg(b, run):
    return b.MoEConfig(num_experts=E, top_k=TOP_K, expert_ffn_dim=F,
                       kernel_backend="reference",
                       comm=b.CommConfig(**RUNS[run][1]))


def _decode_inputs():
    rng = np.random.default_rng(31)
    out = {"xd": rng.standard_normal((BD, SD, H)).astype(np.float32),
           "router_w": (rng.standard_normal((H, E)) / 4).astype(np.float32),
           "placement": rng.permutation(E).astype(np.int32)}
    for ep in (6, 8):
        out[f"w_gate{ep}"] = (rng.standard_normal((ep, H, F)) / 4).astype(
            np.float32)
        out[f"w_up{ep}"] = (rng.standard_normal((ep, H, F)) / 4).astype(
            np.float32)
        out[f"w_down{ep}"] = (rng.standard_normal((ep, F, H)) / 6).astype(
            np.float32)
    return out


def _decode_params(inp, ms):
    ep = -(-E // ms[1]) * ms[1]
    return {"router_w": inp["router_w"], "w_gate": inp[f"w_gate{ep}"],
            "w_up": inp[f"w_up{ep}"], "w_down": inp[f"w_down{ep}"],
            "lsh_rot": np.zeros((1, H, H), np.float32),
            "placement": inp["placement"]}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}{i}/").items()}
    if isinstance(tree, torch.Tensor):
        tree = tree.detach()
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


# ------------------------------------------------- the JAX reference --

def _jax_main(run, params_path, out_path):
    import jax
    import jax.numpy as jnp

    from repro.compat import set_mesh
    from repro.configs import base as jbase
    from repro.configs import registry as jreg
    from repro.core.lsh_moe import lsh_moe_apply
    from repro.data.synthetic import SyntheticLMDataset
    from repro.launch.mesh import make_host_mesh
    from repro.models import model as jmodel
    from repro.optim import adam as jadam
    from repro.runtime import step as jstep

    ms = RUNS[run][0]
    mesh = make_host_mesh(ms[0], 1, ms[1], node_size=NODE)
    params = jmodel.init_params(jax.random.PRNGKey(0),
                                _cfg(jbase, jreg, run, "f32"), mesh)
    np.savez(str(params_path) + ".tmp.npz", **_flat(params))
    os.replace(str(params_path) + ".tmp.npz", params_path)

    opt = jbase.OptimizerConfig(**OPT)
    ds = SyntheticLMDataset(515, SEQ, BATCH)
    batches = [{k: jnp.asarray(v) for k, v in ds.batch_at(s).items()}
               for s in range(STEPS)]
    out = {}
    with set_mesh(mesh):
        for wire in WIRES:
            cfg = _cfg(jbase, jreg, run, wire)
            accum = jax.jit(jstep.make_accum_grad_fn(cfg, mesh))
            apply = jax.jit(lambda st, l, m, g, cfg=cfg:
                            jstep.apply_gradients(st, opt, l, m, g))
            state = jstep.TrainState(params, jadam.adamw_init(params, opt))
            for s, b in enumerate(batches):
                l, metrics, grads = accum(state.params, b)
                out[f"{wire}/loss{s}"] = np.asarray(l)
                out[f"{wire}/gn{s}"] = np.asarray(jadam.global_norm(grads))
                state, _ = apply(state, l, metrics, grads)
            out.update({f"{wire}/p/{k}": v
                        for k, v in _flat(state.params).items()})
        inp = _decode_inputs()
        for drun, dms in DECODES:
            if dms != ms:
                continue
            cfg = _decode_cfg(jbase, drun)
            p = {k: jnp.asarray(v)
                 for k, v in _decode_params(inp, dms).items()}
            y, st = jax.jit(lambda p, x: lsh_moe_apply(
                p, x, cfg, mesh, mlp_act="swiglu", mode="decode"))(
                    p, jnp.asarray(inp["xd"]))
            out[f"decode/{drun}/y"] = np.asarray(y)
            for k in ("aux_loss", "z_loss", "expert_load"):
                out[f"decode/{drun}/{k}"] = np.asarray(st[k])
    np.savez(out_path, **out)


# ------------------------------------------------- the port's ranks --

def _port_main(rank, world, args):
    params_path, out_path, run = args
    from repro_torch.comm import planner as tplanner
    from repro_torch.configs import base as tbase
    from repro_torch.configs import registry as treg
    from repro_torch.convert import (gather_params, params_from_jax,
                                     shard_params, tensor_from_numpy)
    from repro_torch.core import moe as tmoe
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.optim.adam import adamw_init
    from repro_torch.runtime import step as tstep
    from repro_torch.runtime.params import param_specs

    cpu = torch.device("cpu")
    ms = RUNS[run][0]
    mesh = tmesh.make_mesh(*ms, node_size=NODE)
    inp = dict(np.load(params_path))
    jparams = _unflat(inp)
    opt = tbase.OptimizerConfig(**OPT)
    ds = SyntheticLMDataset(515, SEQ, BATCH)
    out = {}
    for wire in WIRES:
        cfg = _cfg(tbase, treg, run, wire)
        whole = params_from_jax(jparams, device=cpu)
        specs = param_specs(whole, mesh)
        params = shard_params(whole, mesh, specs)
        state = tstep.TrainState(params, adamw_init(params, opt))
        step = tstep.make_train_step(cfg, opt, mesh=mesh)
        for s in range(STEPS):
            state, m = step(state, tstep.batch_to_device(ds.batch_at(s),
                                                         cpu))
            out[f"{wire}/loss{s}"] = m["loss"].numpy()
            out[f"{wire}/gn{s}"] = m["grad_norm"].numpy()
            assert int(m["grad_skips"]) == 0
        plan = tplanner.last_plan("model")
        out[f"{wire}/plan"] = np.array(
            f"{plan.algorithm}/{plan.intra}/{plan.chunks}")
        full = gather_params(state.params, mesh, specs)
        out.update({f"{wire}/p/{k}": v for k, v in _flat(full).items()})
    dinp = _decode_inputs()
    for drun, dms in DECODES:
        if dms != ms:
            continue
        cfg = _decode_cfg(tbase, drun)
        full = {k: tensor_from_numpy(v, cpu)
                for k, v in _decode_params(dinp, dms).items()}
        bl = BD // dms[0]
        di = mesh.axis_index("data")
        xd = torch.from_numpy(dinp["xd"][di * bl:(di + 1) * bl].copy())
        with torch.no_grad():
            y, st = tmoe._moe_dense_planned(xd, shard_params(full, mesh), cfg,
                                            mesh=mesh, mlp_act="swiglu")
        plan = tplanner.last_plan("model")
        tag = f"decode/{drun}"
        out[f"{tag}/plan"] = np.array(plan.algorithm)
        out[f"{tag}/y"] = y.numpy()
        for k in ("aux_loss", "z_loss", "expert_load"):
            out[f"{tag}/{k}"] = st[k].numpy()
    np.savez(out_path.format(rank=rank), **out)
    return 0


# ------------------------------------------------------------- tests --

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{run: (JAX's arrays, [each rank's arrays])}: one JAX subprocess a
    run, side by side; each run's ranks start once its params are
    written."""
    tmp = tmp_path_factory.mktemp("dist_comm")
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    for k in ("REPRO_COMM_IMPL", "REPRO_NODE_SIZE", "REPRO_TUNE"):
        env.pop(k, None)
    procs = {run: subprocess.Popen(
        [sys.executable, str(HERE), "jax", run, str(tmp / f"{run}.p.npz"),
         str(tmp / f"{run}.jax.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for run in RUNS}
    out = {}
    try:
        for run, proc in procs.items():
            params_path = tmp / f"{run}.p.npz"
            deadline = time.monotonic() + 300
            while not params_path.exists():
                if proc.poll() is not None or time.monotonic() > deadline:
                    break
                time.sleep(0.1)
            tmesh.spawn_cpu_ranks(
                str(HERE), 4, [str(params_path),
                               str(tmp / f"{run}_{{rank}}.npz"), run],
                store=str(tmp / f"store_{run}"),
                env=dict(env, OMP_NUM_THREADS="1"), timeout_s=300)
            out[run] = [dict(np.load(tmp / f"{run}_{r}.npz"))
                        for r in range(4)]
    finally:
        errs = {run: p.communicate(timeout=600)[1]
                for run, p in procs.items()}
    for run, proc in procs.items():
        assert proc.returncode == 0, errs[run][-4000:]
        out[run] = (dict(np.load(tmp / f"{run}.jax.npz")), out[run])
    return out


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _worst_param(port, ref, pre):
    from repro_torch.convert import params_from_jax
    want = _flat(params_from_jax(_unflat(
        {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)}),
        device="cpu"))
    got = {k[len(pre):]: v for k, v in port.items() if k.startswith(pre)}
    assert want and set(want) == set(got)
    worst = 0.0
    for k, w in want.items():
        if np.issubdtype(w.dtype, np.floating):
            worst = max(worst, _rel_l2(got[k], w))
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)
    return worst


@pytest.mark.parametrize("wire", list(WIRES))
@pytest.mark.parametrize("run", list(RUNS))
def test_mesh_train_step_matches_jax(runs, run, wire):
    ref, port = runs[run]
    plan = {"hierarchical": f"hierarchical/{NODE}/1",
            "pipelined": f"pipelined/{RUNS[run][0][1]}/2"}[run]
    for r in port:
        assert str(r[f"{wire}/plan"]) == plan
    for s in range(STEPS):
        for r in port:
            np.testing.assert_array_equal(r[f"{wire}/loss{s}"],
                                          port[0][f"{wire}/loss{s}"])
        (loss_tol, gn_tol) = BOUNDS[wire][0][s]
        np.testing.assert_allclose(port[0][f"{wire}/loss{s}"],
                                   ref[f"{wire}/loss{s}"], rtol=loss_tol)
        np.testing.assert_allclose(port[0][f"{wire}/gn{s}"],
                                   ref[f"{wire}/gn{s}"], rtol=gn_tol)
    worst = _worst_param(port[0], ref, f"{wire}/p/")
    print(f"{run} {wire} wire: losses port "
          f"{[float(port[0][f'{wire}/loss{s}']) for s in range(STEPS)]} jax "
          f"{[float(ref[f'{wire}/loss{s}']) for s in range(STEPS)]};"
          f" worst param rel L2 {worst:.3g}")
    assert worst < BOUNDS[wire][1]


@pytest.mark.parametrize("run,mesh_shape", DECODES,
                         ids=[f"{r}-{d}x{m}" for r, (d, m) in DECODES])
def test_decode_dense_dispatch_planned_parity(runs, run, mesh_shape):
    ref, ranks = runs[{(1, 4): "hierarchical",
                       (2, 2): "pipelined"}[mesh_shape]]
    tag = jtag = f"decode/{run}"
    d_r, m_r = mesh_shape
    for r in ranks:
        assert str(r[f"{tag}/plan"]) == run
    y = np.concatenate([ranks[d * m_r][f"{tag}/y"] for d in range(d_r)])
    err = float(np.abs(y - ref[f"{jtag}/y"]).max())
    print(f"{mesh_shape} decode via {run}: max |y diff| {err:.3g}")
    assert err <= 1e-5
    for r in ranks:
        for k in ("aux_loss", "z_loss"):
            np.testing.assert_allclose(r[f"{tag}/{k}"], ref[f"{jtag}/{k}"],
                                       atol=1e-5, err_msg=k)
        np.testing.assert_array_equal(r[f"{tag}/expert_load"],
                                      ref[f"{jtag}/expert_load"])


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_main(*sys.argv[2:])
    else:                                   # RANK WORLD STORE args...
        sys.exit(tmesh.run_cpu_rank(sys.argv[1:], _port_main))
