"""The new archs over two gloo ranks against the JAX package on 2 forced
host devices (one ``python <this file> jax ...`` subprocess, one spawn of
the port's ranks, both started together), on the CPU:

- whisper-base and smollm-360m's pure data-parallel step (``dp_only``, a
  (2, 1) mesh), 2 steps on [4, 16] batches: losses within 1e-5 relative,
  the replicas bit-identical, each param's distance from JAX's within
  5e-3 of the norm of JAX's update to it (tests/test_torch_xlstm.py gives
  the bound's reasoning).  Measured: losses 1.4e-7 relative, params
  2.2e-4 of the update.
- granite-8b and internvl2-26b (4 patch embeddings before 12 tokens: the
  combined sequence of 16 splits 8 / 8, so the prefix lies on rank 0) on
  a (1, 2) mesh: the gradient half of the step (the loss within 1e-5
  relative, every rank's the same; every gradient leaf within 1e-4
  relative L2) and prefill's last logits within 1e-5 relative L2.
  Measured: loss 7.3e-8, gradients 1.4e-6, prefill 9.6e-7.  With the
  same bounds smollm-360m outside ``dp_only`` ("smollm-360m-tp"): its 3
  query heads and 1 kv head do not split over 2 model ranks, so the port
  takes the replicated fallback (runtime/tp.py).
- Every leaf placed by its spec (runtime/params.py: FSDP over ``data``,
  heads / FFN hidden / vocabulary over ``model``) on four gloo ranks
  against JAX on 4 forced host devices, with the same bounds:
  granite-8b at (2, 2) and (1, 4) and granite-moe-3b-a800m at (2, 2) in
  its check config (LSH off, a capacity that drops no token, no router
  losses: tests/test_torch_tp.py), the loss, every gradient leaf
  (gathered whole over the mesh) and prefill's last logits.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # parallel test workers share the cores

HERE = Path(__file__).resolve()
SRC = HERE.parents[1] / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

from repro_torch.launch import mesh as tmesh  # noqa: E402

if __name__ != "__main__":
    jax = pytest.importorskip("jax")

    from repro.compat import set_mesh
    from repro.configs.registry import get_smoke_config as j_smoke
    from repro.models import model as jmodel
    from repro_torch.convert import params_from_jax

DP_ARCHS = ("whisper-base", "smollm-360m")
MESH_ARCHS = ("granite-8b", "internvl2-26b", "smollm-360m-tp")
FSDP_CASES = (("granite-8b", (2, 2)), ("granite-8b", (1, 4)),
              ("granite-moe-3b-a800m", (2, 2)))
DP_BATCH, DP_STEPS = 4, 2
OPT = dict(lr=1e-3, warmup_steps=0, total_steps=10)
RTOL = 1e-5


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}{i}/").items()}
    if isinstance(tree, torch.Tensor):
        tree = tree.detach()
    return {prefix[:-1]: tree}


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


def _sub(store, pre):
    return {k[len(pre):]: v for k, v in store.items() if k.startswith(pre)}


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _np(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else x, np.float32)


def _check_config(cfg):
    """LSH off, a capacity that drops no token, no router losses (either
    package's config)."""
    if not cfg.has_moe():
        return cfg
    import dataclasses
    return cfg.replace(moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts),
        router_aux_weight=0.0, router_z_weight=0.0,
        lsh=dataclasses.replace(cfg.moe.lsh, enabled=False)))


def _mesh_cfg(get_smoke, key):
    """A MESH_ARCHS entry's f32 smoke config: "<arch>-tp" is the arch
    outside ``dp_only``."""
    cfg = get_smoke(key.removesuffix("-tp")).replace(dtype="float32")
    return cfg.replace(dp_only=False) if key.endswith("-tp") else cfg


def _case(arch, shape):
    return f"fsdp/{arch}/{shape[0]}x{shape[1]}"


def _batch(arch, seed, batch):
    from repro_torch.configs.registry import get_smoke_config as tsc
    cfg = tsc(arch.removesuffix("-tp"))
    rng = np.random.default_rng(seed)
    P = cfg.num_patches if cfg.frontend == "patch_stub" else 0
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, 16 - P))
           .astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (batch, 16 - P))
           .astype(np.int32)}
    if P:
        out["patch_embeds"] = rng.standard_normal(
            (batch, P, cfg.d_model)).astype(np.float32)
    if cfg.encoder_decoder:
        out["frames"] = rng.standard_normal(
            (batch, 16, cfg.d_model)).astype(np.float32)
    return out


def _jax_main(inp_path, out_path):
    import jax
    import jax.numpy as jnp

    from repro.compat import set_mesh
    from repro.configs import base as jb
    from repro.configs.registry import get_smoke_config as jsc
    from repro.launch.mesh import make_host_mesh
    from repro.models import model as jm
    from repro.optim.adam import adamw_init
    from repro.runtime import step as js
    inp = dict(np.load(inp_path))
    opt = jb.OptimizerConfig(**OPT)
    out = {}
    for arch in DP_ARCHS:
        cfg = jsc(arch).replace(dtype="float32")
        params = jax.tree.map(jnp.asarray, _unflat(_sub(inp, f"{arch}/")))
        mesh = make_host_mesh(2, 1, 1)
        with set_mesh(mesh):
            state = js.TrainState(params, adamw_init(params, opt))
            step = jax.jit(js.make_train_step(cfg, opt, mesh))
            for s in range(DP_STEPS):
                state, m = step(state, {k: jnp.asarray(v) for k, v in
                                        _batch(arch, s, DP_BATCH).items()})
                out[f"{arch}/loss{s}"] = np.asarray(m["loss"])
        out.update({f"{arch}/p/{k}": np.asarray(v)
                    for k, v in _flat(state.params).items()})
    for arch in MESH_ARCHS:
        cfg = _mesh_cfg(jsc, arch)
        params = jax.tree.map(jnp.asarray, _unflat(_sub(inp, f"{arch}/")))
        batch = {k: jnp.asarray(v) for k, v in _batch(arch, 0, 2).items()}
        mesh = make_host_mesh(1, 1, 2)
        with set_mesh(mesh):
            loss, _, grads = jax.jit(js.make_accum_grad_fn(cfg, mesh))(
                params, batch)
            logits, _ = jax.jit(lambda p, b: jm.prefill(p, cfg, mesh, b))(
                params, {k: v for k, v in batch.items() if k != "labels"})
        out[f"{arch}/loss"] = np.asarray(loss)
        out[f"{arch}/prefill"] = np.asarray(logits)
        out.update({f"{arch}/g/{k}": np.asarray(v)
                    for k, v in _flat(grads).items()})
    for arch, shape in FSDP_CASES:
        cfg = _check_config(jsc(arch).replace(dtype="float32"))
        params = jax.tree.map(jnp.asarray, _unflat(_sub(inp, f"{arch}/")))
        batch = {k: jnp.asarray(v) for k, v in _batch(arch, 1, 4).items()}
        mesh = make_host_mesh(shape[0], 1, shape[1])
        with set_mesh(mesh):
            loss, _, grads = jax.jit(js.make_accum_grad_fn(cfg, mesh))(
                params, batch)
            logits, _ = jax.jit(lambda p, b: jm.prefill(p, cfg, mesh, b))(
                params, {k: v for k, v in batch.items() if k != "labels"})
        key = _case(arch, shape)
        out[f"{key}/loss"] = np.asarray(loss)
        out[f"{key}/prefill"] = np.asarray(logits)
        out.update({f"{key}/g/{k}": np.asarray(v)     # not the placement's
                    for k, v in _flat(grads).items()
                    if np.asarray(v).dtype.kind != "V"})
    np.savez(out_path, **out)


def _port_main(rank, world, args):
    from repro_torch.configs import base as tbase
    from repro_torch.configs.registry import get_smoke_config as tsc
    from repro_torch.convert import gather_params, params_from_jax, \
        shard_params
    from repro_torch.optim.adam import adamw_init
    from repro_torch.runtime import params as tparams
    from repro_torch.runtime import step as ts
    inp_path, out_path = args
    inp = dict(np.load(inp_path))
    opt = tbase.OptimizerConfig(**OPT)
    cpu = torch.device("cpu")
    out = {}
    mesh = tmesh.make_mesh(2, 1)
    for arch in DP_ARCHS:
        cfg = tsc(arch).replace(dtype="float32")
        params = params_from_jax(_unflat(_sub(inp, f"{arch}/")), device=cpu)
        # the rank's FSDP shards over data (the dp_only profile's specs)
        specs = tparams.model_specs(cfg, mesh)
        params = shard_params(params, mesh, specs)
        state = ts.TrainState(params, adamw_init(params, opt))
        step = ts.make_train_step(cfg, opt, mesh=mesh)
        for s in range(DP_STEPS):
            state, m = step(state, ts.batch_to_device(
                _batch(arch, s, DP_BATCH), cpu))
            out[f"{arch}/loss{s}"] = _np(m["loss"])
        out.update({f"{arch}/p/{k}": _np(v) for k, v in _flat(
            gather_params(state.params, mesh, specs)).items()})
    mesh = tmesh.make_mesh(1, 2)
    for arch in MESH_ARCHS:
        cfg = _mesh_cfg(tsc, arch)
        out.update(_mesh_case(cfg, _unflat(_sub(inp, f"{arch}/")),
                              _batch(arch, 0, 2), mesh, arch))
    np.savez(out_path.format(rank=rank), **out)
    return 0


def _mesh_case(cfg, flat_params, batch, mesh, key):
    """The gradient half of the step and prefill over ``mesh``, the
    params cut by their specs, the gradients gathered whole."""
    from repro_torch.convert import gather_params, params_from_jax, \
        shard_params
    from repro_torch.models import model as tm
    from repro_torch.optim.adam import _map, leaves
    from repro_torch.runtime import params as tparams
    from repro_torch.runtime import step as ts
    cpu = torch.device("cpu")
    full = params_from_jax(flat_params, device=cpu)
    specs = tparams.model_specs(cfg, mesh)
    params = shard_params(full, mesh, specs)
    batch = ts.batch_to_device(batch, cpu)
    loss, _, grads = ts.make_accum_grad_fn(cfg, mesh=mesh)(params, batch)
    assert len(leaves(params)) == len(grads)
    it = iter(grads)
    gt = _flat(gather_params(_map(lambda p: next(it), params), mesh, specs))
    out = {f"{key}/loss": _np(loss)}
    out.update({f"{key}/g/{k}": _np(v) for k, v in gt.items()
                if v is not None})
    logits, _ = tm.prefill(params, cfg, {k: v for k, v in batch.items()
                                         if k != "labels"}, mesh=mesh)
    out[f"{key}/prefill"] = _np(logits)
    return out


def _port4_main(rank, world, args):
    """The FSDP / tensor-parallel cases on four ranks."""
    from repro_torch.configs.registry import get_smoke_config as tsc
    inp_path, out_path = args
    inp = dict(np.load(inp_path))
    out = {}
    meshes = {}
    for arch, shape in FSDP_CASES:
        if shape not in meshes:
            meshes[shape] = tmesh.make_mesh(*shape)
        cfg = _check_config(tsc(arch).replace(dtype="float32"))
        out.update(_mesh_case(cfg, _unflat(_sub(inp, f"{arch}/")),
                              _batch(arch, 1, 4), meshes[shape],
                              _case(arch, shape)))
    np.savez(out_path.format(rank=rank), **out)
    return 0


@pytest.fixture(scope="module")
def runs(tmp_path_factory, mesh):
    tmp = tmp_path_factory.mktemp("encdec")
    inp = {}
    for arch in DP_ARCHS + MESH_ARCHS + ("granite-moe-3b-a800m",):
        cfg = _mesh_cfg(j_smoke, arch)
        with set_mesh(mesh):
            p = jmodel.init_params(jax.random.PRNGKey(0), cfg, mesh)
        inp.update({f"{arch}/{k}": np.asarray(v)
                    for k, v in _flat(jax.tree.map(np.asarray, p)).items()})
    np.savez(tmp / "inputs.npz", **inp)
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jax_proc = subprocess.Popen(
        [sys.executable, str(HERE), "jax", str(tmp / "inputs.npz"),
         str(tmp / "jax.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        for world in (2, 4):
            tmesh.spawn_cpu_ranks(
                str(HERE), world, [str(tmp / "inputs.npz"),
                                   str(tmp / f"port{world}_{{rank}}.npz")],
                store=str(tmp / f"store{world}"),
                env=dict(os.environ, PYTHONPATH=str(SRC),
                         OMP_NUM_THREADS="1"),
                timeout_s=300)
    finally:
        _, err = jax_proc.communicate(timeout=600)
    assert jax_proc.returncode == 0, err[-4000:]
    return {"inputs": inp, "jax": dict(np.load(tmp / "jax.npz")),
            "port": [dict(np.load(tmp / f"port2_{r}.npz")) for r in range(2)],
            "port4": [dict(np.load(tmp / f"port4_{r}.npz"))
                      for r in range(4)]}


def _port_layout(flat_jax):
    return {k: _np(v) for k, v in _flat(params_from_jax(
        _unflat(flat_jax), device="cpu")).items()}


@pytest.mark.parametrize("arch", DP_ARCHS)
def test_dp_only_step_on_two_ranks_matches_jax(runs, arch):
    ref, port = runs["jax"], runs["port"]
    for s in range(DP_STEPS):
        np.testing.assert_allclose(port[0][f"{arch}/loss{s}"],
                                   ref[f"{arch}/loss{s}"], rtol=RTOL)
    for k in port[0]:                   # the replicas stay bit-identical
        if k.startswith(f"{arch}/"):
            np.testing.assert_array_equal(port[1][k], port[0][k], err_msg=k)
    want = _port_layout(_sub(ref, f"{arch}/p/"))
    start = _port_layout(_sub(runs["inputs"], f"{arch}/"))
    got = _sub(port[0], f"{arch}/p/")
    assert set(got) == set(want)
    worst = max(np.linalg.norm(got[k] - w) / np.linalg.norm(w - start[k])
                for k, w in want.items())
    print(f"{arch} dp_only on 2 ranks: losses "
          f"{[float(port[0][f'{arch}/loss{s}']) for s in range(DP_STEPS)]}"
          f" / {[float(ref[f'{arch}/loss{s}']) for s in range(DP_STEPS)]}"
          f", worst param difference over its update {worst:.3g}")
    assert worst < 5e-3


@pytest.mark.parametrize("arch", MESH_ARCHS)
def test_mesh_of_two_matches_jax(runs, arch):
    ref, port = runs["jax"], runs["port"]
    np.testing.assert_array_equal(port[1][f"{arch}/loss"],
                                  port[0][f"{arch}/loss"])
    loss_rel = abs(float(port[0][f"{arch}/loss"]) - float(
        ref[f"{arch}/loss"])) / abs(float(ref[f"{arch}/loss"]))
    want = _port_layout(_sub(ref, f"{arch}/g/"))
    got = _sub(port[0], f"{arch}/g/")
    assert set(got) == set(want)
    worst = max(_rel_l2(got[k], w) for k, w in want.items())
    pre = max(_rel_l2(p[f"{arch}/prefill"], ref[f"{arch}/prefill"])
              for p in port)
    print(f"{arch} at (1, 2): loss rel {loss_rel:.3g}, worst gradient rel "
          f"L2 {worst:.3g}, prefill rel L2 {pre:.3g}")
    assert loss_rel <= RTOL and worst <= 1e-4 and pre <= RTOL


@pytest.mark.parametrize("arch,shape", FSDP_CASES,
                         ids=[_case(a, s) for a, s in FSDP_CASES])
def test_placed_mesh_step_matches_jax(runs, arch, shape):
    """Every leaf placed by its spec over four ranks: the loss (every
    rank's the same) within 1e-5 relative of JAX's on the same mesh,
    every gradient leaf within 1e-4 relative L2, prefill's last logits
    within 1e-5 relative L2."""
    ref, port = runs["jax"], runs["port4"]
    key = _case(arch, shape)
    for p in port[1:]:
        np.testing.assert_array_equal(p[f"{key}/loss"], port[0][f"{key}/loss"])
    loss_rel = abs(float(port[0][f"{key}/loss"]) - float(
        ref[f"{key}/loss"])) / abs(float(ref[f"{key}/loss"]))
    want = _port_layout(_sub(ref, f"{key}/g/"))
    got = _sub(port[0], f"{key}/g/")
    assert set(got) == set(want)
    worst = max(_rel_l2(got[k], w) for k, w in want.items())
    pre = max(_rel_l2(p[f"{key}/prefill"], ref[f"{key}/prefill"])
              for p in port)
    print(f"{key}: loss rel {loss_rel:.3g}, worst gradient rel L2 "
          f"{worst:.3g}, prefill rel L2 {pre:.3g}")
    assert loss_rel <= RTOL and worst <= 1e-4 and pre <= RTOL


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_main(*sys.argv[2:])
    else:                                   # RANK WORLD STORE args...
        world = int(sys.argv[2])
        sys.exit(tmesh.run_cpu_rank(
            sys.argv[1:], _port_main if world == 2 else _port4_main))
