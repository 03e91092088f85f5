"""Tensor-parallel Mamba over the ``model`` axis (runtime/tp.py,
models/ssm.mamba_apply(mesh=)) on gloo ranks against the JAX package on
forced host devices (one ``python <this file> jax ...`` subprocess with
four), and against the port's own mesh-free path.

- ``sp_gather``, ``tp_in_project`` (one column-sliced and one replicated
  projection) and ``tp_project`` at model 2 and 4, f32, forward and VJP
  against JAX's ``runtime/tp.py`` (the counterpart of
  tests/test_distributed.py's ``test_tp_project_multidevice_matches_matmul``):
  within 1e-5 relative (XLA's and torch's dots sum in other orders; the
  gather is bitwise).  Each rank's objective is its share of JAX's: the
  column and sequence slices partition the outputs, and a replicated
  output's sum is divided by the g ranks that hold it.  The weights are
  the ranks' shards (runtime/params.py) and their gradients are gathered
  whole.
- ``mamba_apply`` (jamba's smoke widths: d_inner 256 in 16 heads, d_state
  8, chunk 8; [2, 16] tokens) at (1, 2), f32: output and every gradient
  within 1e-5 relative L2 of JAX's on the same mesh and of the port's
  mesh-free function (measured: at most 5.1e-6, a gradient of w_b or w_c,
  sums over the sequence that cancel).
- One train step of the jamba smoke config (f32, LSH on) at (1, 2) and
  (2, 2), the gradient half (``make_accum_grad_fn``) and the clip norm,
  against JAX's on the same mesh, with the bounds of
  tests/test_torch_hybrid.py::test_train_step_matches_jax: with the f32
  wire the loss within 1e-5 relative and every gradient leaf within 1e-4
  relative L2; with the bf16 wire 1e-4 and 3e-2 (the hybrid stack carries
  a bf16 step of a centroid into its Mamba gradients; that file's
  docstring).  The clip norm within the gradients' bound.  Measured: f32
  wire loss 7e-8, worst leaf 4.2e-5; bf16 wire loss 2.4e-5, worst leaf
  8.9e-3, clip norm 1.4e-3.  Against the
  port's mesh-free step: a mesh changes the MoE layer's function (each
  rank hashes, clusters and fills capacity over its own tokens, in either
  package), so there the comparison runs with LSH off, a capacity that
  drops no token and no router losses (each rank's load-balancing term
  reads its own tokens' load), where the two are one function: loss within 1e-5
  relative, gradients within 1e-4 relative L2 (f32 wire).
- ``prefill`` at (1, 2): the last logits within 1e-5 relative L2 of JAX's
  prefill on the same mesh.
- Mamba heads that do not split over the model axis (3 over 2) run
  replicated over it (the JAX package's fallback): output and every
  gradient within 1e-5 relative L2 of JAX's on (1, 2) and of the
  port's mesh-free function; ``projects_whole`` says where the fallback
  is taken.
- At a one-rank model axis the mesh path (whose collectives then run over
  a one-rank group) is bit-equal to the mesh-free one: loss and every
  gradient, f32 and bf16, for jamba and for granite-8b (the placement,
  the FSDP / TP helpers of attention and the dense FFN, the vocabulary
  split of the embedding, head and loss, all at data = model = 1).
"""
import concurrent.futures
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
    pytest.importorskip("jax")

HERE = Path(__file__).resolve()
SRC = HERE.parents[1] / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

from repro_torch.launch import mesh as tmesh  # noqa: E402

ARCH = "jamba-1.5-large-398b"
HELPER_MODELS = (2, 4)
X, W_IN, W_REP, W_OUT = (2, 8, 16), (16, 32), (16, 8), (32, 16)
MAMBA_X = (2, 16, 128)
# Mamba heads that do not split over a model axis of 2: d_model 48,
# d_inner 96 in 3 heads of 32
MAMBA3_D, MAMBA3_HEAD_DIM = 48, 32
MAMBA3_X = (2, 16, MAMBA3_D)
TRAIN_MESHES = ((1, 2), (2, 2))
BATCH, SEQ = 2, 16
WIRES = {"f32": "float32", "bf16": "bfloat16"}
# wire: (loss, gradient) relative bounds
BOUNDS = {"f32": (1e-5, 1e-4), "bf16": (1e-4, 3e-2)}
HELPER_RTOL = 1e-5
MAMBA_RTOL = 1e-5


def _cfg(registry, b, wire="f32", use_lsh=True):
    cfg = registry.get_smoke_config(ARCH).replace(dtype="float32")
    moe = cfg.moe
    lsh = dataclasses.replace(moe.lsh, wire_dtype=WIRES[wire])
    if not use_lsh:
        # a capacity that drops no token, and no router losses (each rank
        # balances its own tokens' load)
        moe = dataclasses.replace(moe, capacity_factor=float(
            moe.num_experts), router_aux_weight=0.0, router_z_weight=0.0)
    return cfg.replace(moe=dataclasses.replace(moe, lsh=lsh))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}{i}/").items()}
    if tree is None:
        return {}
    if isinstance(tree, torch.Tensor):
        tree = tree.detach()
    return {prefix[:-1]: np.asarray(tree)}


def _grad_flat(tree):
    """_flat without the integer placement leaf (float0 in JAX)."""
    return {k: v for k, v in _flat(tree).items()
            if not k.endswith("placement")}


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


def _inputs():
    rng = np.random.default_rng(31)

    def f(shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"x": f(X), "w_in": f(W_IN, 0.25), "w_rep": f(W_REP, 0.25),
            "w_out": f(W_OUT, 0.2), "h": f(X[:2] + (W_OUT[0],)),
            "ct_gather": f(X), "ct_in": f(X[:2] + (W_IN[1],)),
            "ct_rep": f(X[:2] + (W_REP[1],)), "ct_out": f(X),
            "mx": f(MAMBA_X), "mct": f(MAMBA_X),
            "m3x": f(MAMBA3_X), "m3ct": f(MAMBA3_X)}


def _ssm3(cfg):
    return dataclasses.replace(cfg.ssm, head_dim=MAMBA3_HEAD_DIM)


# ------------------------------------------------- the JAX reference --

def _jax_main(inp_path, out_path):
    import jax
    import jax.numpy as jnp

    from repro.compat import set_mesh
    from repro.configs import base as jbase
    from repro.configs import registry as jreg
    from repro.launch.mesh import make_host_mesh
    from repro.models import model as jmodel
    from repro.models import ssm as jssm
    from repro.optim import adam as jadam
    from repro.runtime import step as jstep
    from repro.runtime.tp import sp_gather, tp_in_project, tp_project

    inp = {k: jnp.asarray(v) for k, v in np.load(inp_path).items()}
    params, mp3 = (jax.tree.map(jnp.asarray, _unflat(
        {k[len(pre):]: v for k, v in np.load(inp_path).items()
         if k.startswith(pre)})) for pre in ("p/", "p3/"))
    out = {}
    for g in HELPER_MODELS:
        mesh = make_host_mesh(1, 1, g)

        # each forward and its VJP in one jit (an eager VJP compiles its
        # ops one at a time)
        def helpers(inp, mesh=mesh):
            res = {}
            y, vjp = jax.vjp(lambda x: sp_gather(x, mesh), inp["x"])
            res["gather"] = y
            (res["gather/dx"],) = vjp(inp["ct_gather"])

            def fin(x, w1, w2):
                return tp_in_project(x, (w1, w2), mesh, replicate=(False,
                                                                   True))
            (h1, h2), vjp = jax.vjp(fin, inp["x"], inp["w_in"],
                                    inp["w_rep"])
            res["in"], res["rep"] = h1, h2
            res["in/dx"], res["in/dw"], res["rep/dw"] = vjp(
                (inp["ct_in"], inp["ct_rep"]))
            y, vjp = jax.vjp(lambda h, w: tp_project(h, w, mesh), inp["h"],
                             inp["w_out"])
            res["out"] = y
            res["out/dh"], res["out/dw"] = vjp(inp["ct_out"])
            return res
        with set_mesh(mesh):
            out.update({f"g{g}/{k}": v
                        for k, v in jax.jit(helpers)(inp).items()})

    cfg = _cfg(jreg, jbase)
    mesh = make_host_mesh(1, 1, 2)
    mp = params["blocks"][0]["mixer"]
    mp = jax.tree.map(lambda a: a[0], mp)            # super-block 0
    # the jamba smoke widths, then 3 heads over 2, which JAX's
    # tp_in_project projects whole (in a jit: its sharding constraints
    # on 3 heads over 2, which only the partitioner takes)
    for tag, p, ssm, key in (("mamba", mp, cfg.ssm, "m"),
                             ("mamba3", mp3, _ssm3(cfg), "m3")):
        def fn(p, x, ct, ssm=ssm):
            y, vjp = jax.vjp(lambda p, x: jssm.mamba_apply(
                p, x, ssm, cfg.norm_eps, mesh=mesh), p, x)
            return (y,) + vjp(ct)
        with set_mesh(mesh):
            y, dp, dx = jax.jit(fn)(
                p, inp[f"{key}x"], inp[f"{key}ct"])
        out[f"{tag}/y"], out[f"{tag}/dx"] = y, dx
        out.update({f"{tag}/dp/{k}": v for k, v in _flat(
            jax.tree.map(np.asarray, dp)).items()})

    from repro.data.synthetic import SyntheticLMDataset
    batch = {k: jnp.asarray(v) for k, v in SyntheticLMDataset(
        cfg.vocab_size, SEQ, BATCH).batch_at(0).items()}
    for shape in TRAIN_MESHES:
        mesh = make_host_mesh(shape[0], 1, shape[1])
        with set_mesh(mesh):
            for wire in WIRES:
                tag = f"train{shape[0]}x{shape[1]}/{wire}"
                loss, _, grads = jax.jit(jstep.make_accum_grad_fn(
                    _cfg(jreg, jbase, wire), mesh))(params, batch)
                out[f"{tag}/loss"] = loss
                out[f"{tag}/gn"] = jadam.global_norm(grads)
                grads = jax.tree.map(np.asarray, grads)
                for blk in grads["blocks"]:
                    blk.get("ffn", {}).pop("placement", None)     # float0
                out.update({f"{tag}/g/{k}": v
                            for k, v in _flat(grads).items()})
    mesh = make_host_mesh(1, 1, 2)
    with set_mesh(mesh):
        logits, _ = jax.jit(lambda p, b: jmodel.prefill(p, cfg, mesh, b))(
            params, {"tokens": batch["tokens"]})
    out["prefill"] = logits
    np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})


# ------------------------------------------------- the port's ranks --

def _port_main(rank, world, args):
    inp_path, out_path = args
    from repro_torch.comm import collectives
    from repro_torch.configs import base as tbase
    from repro_torch.configs import registry as treg
    from repro_torch.convert import (gather_params, params_from_jax,
                                     shard_params)
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.models import model as tmodel
    from repro_torch.models import ssm as tssm
    from repro_torch.optim import adam as tadam
    from repro_torch.runtime import params as tparams
    from repro_torch.runtime import sharding, tp
    from repro_torch.runtime import step as tstep

    cpu = torch.device("cpu")
    inp = dict(np.load(inp_path))
    t = {k: torch.from_numpy(v) for k, v in inp.items()
         if not k.startswith("p/")}
    jparams = _unflat({k[2:]: v for k, v in inp.items()
                       if k.startswith("p/")})
    out = {}

    def grad(outputs, inputs, cts):
        return torch.autograd.grad(outputs, inputs, grad_outputs=cts)

    def model_sum(x, mesh):         # the step's sum of replicated grads
        return collectives.raw_all_reduce_sum(x, sharding.model_group(mesh))

    def model_gather(x, mesh, dim):  # a shard's gradient, whole
        return collectives.raw_all_gather(x.contiguous(),
                                          sharding.model_group(mesh), dim)

    # the three helpers on a (1, world) mesh
    mesh = tmesh.make_mesh(1, world)
    g, m = world, rank
    seq = slice(m * X[1] // g, (m + 1) * X[1] // g)
    x = t["x"][:, seq].clone().requires_grad_(True)
    y = tp.sp_gather(x, mesh)
    (dx,) = grad(y, [x], t["ct_gather"] / g)
    out.update({"gather": y.detach(), "gather/dx": dx})
    # the weights are the rank's shards ((data, model) = (1, g): their
    # columns, w_out's rows), as runtime/params.py places them
    cols = slice(m * W_IN[1] // g, (m + 1) * W_IN[1] // g)
    rcols = slice(m * W_REP[1] // g, (m + 1) * W_REP[1] // g)
    w1 = t["w_in"][:, cols].clone().requires_grad_(True)
    w2 = t["w_rep"][:, rcols].clone().requires_grad_(True)
    cut = ((), ("model",))
    h1, h2 = tp.tp_in_project(x, [w1, w2], mesh, [cut, cut],
                              replicate=(False, True))
    dx, dw1, dw2 = grad([h1, h2], [x, w1, w2],
                        [t["ct_in"][..., cols], t["ct_rep"] / g])
    out.update({"in": h1.detach(), "rep": h2.detach(), "in/dx": dx,
                "in/dw": model_gather(dw1, mesh, 1),
                "rep/dw": model_gather(dw2, mesh, 1)})
    rows = slice(m * W_OUT[0] // g, (m + 1) * W_OUT[0] // g)
    h = t["h"][..., rows].clone().requires_grad_(True)
    w3 = t["w_out"][rows].clone().requires_grad_(True)
    y = tp.tp_project(h, w3, mesh, (("model",), ()))
    dh, dw3 = grad(y, [h, w3], t["ct_out"][:, seq])
    out.update({"out": y.detach(), "out/dh": dh,
                "out/dw": model_gather(dw3, mesh, 0)})

    cfg = _cfg(treg, tbase)
    full = params_from_jax(jparams, device=cpu)
    batch = tstep.batch_to_device(SyntheticLMDataset(
        cfg.vocab_size, SEQ, BATCH).batch_at(0), cpu)
    if world == 2:
        # mamba_apply, mesh and mesh-free, at jamba's smoke widths and with
        # 3 heads that do not split over the axis
        # (the mesh reads the rank's shards; a split leaf's gradient is
        # gathered whole, a whole one's summed as the step sums it)
        mp3 = {k: torch.from_numpy(v) for k, v in _flat(_unflat(
            {k[3:]: v for k, v in inp.items() if k.startswith("p3/")}
        )).items()}
        for pre, mp, ssm, key, width in (
                ("mamba", full["layers"][0]["mixer"], cfg.ssm, "m",
                 MAMBA_X[1]),
                ("mamba3", _unflat(mp3), _ssm3(cfg), "m3", MAMBA3_X[1])):
            specs = tparams.param_specs(mp, mesh)
            ms = slice(m * width // g, (m + 1) * width // g)
            for tag, xm, mm, ct in (
                    (pre, t[f"{key}x"][:, ms], mesh, t[f"{key}ct"][:, ms]),
                    (f"{pre}_free", t[f"{key}x"], None, t[f"{key}ct"])):
                mine = mp if mm is None else shard_params(mp, mesh, specs)
                leaves = tadam.leaves(mine)
                for p in leaves:
                    p.requires_grad_(True)
                xm = xm.clone().requires_grad_(True)
                y = tssm.mamba_apply(mine, xm, ssm, cfg.norm_eps, mesh=mm,
                                     specs=None if mm is None else specs)
                gs = grad(y, [xm] + leaves, ct)
                out[f"{tag}/y"], out[f"{tag}/dx"] = y.detach(), gs[0]
                it = iter(gs[1:])
                dp = tadam._map(lambda p: next(it), mine)
                if mm is not None:
                    dp = tparams.map_specs(
                        lambda d, s: tparams.gather(d, s, mesh)
                        if tparams.split_axes(s, mesh)
                        else model_sum(d, mesh), dp, specs)
                out.update({f"{tag}/dp/{k}": v
                            for k, v in _flat(dp).items()})
                for p in leaves:
                    p.requires_grad_(False)
        # prefill
        logits, _ = tmodel.prefill(shard_params(full, mesh), cfg,
                                   {"tokens": batch["tokens"]}, mesh=mesh)
        out["prefill"] = logits

    # the train step's gradient half on each mesh of this world
    def accum(cfg, mesh, params, use_lsh=None):
        loss, _, grads = tstep.make_accum_grad_fn(
            cfg, use_lsh=use_lsh, mesh=mesh)(params, batch)
        # an integer leaf's None stands as an empty tensor, which keeps
        # gather_params' walk over the leaves in step
        it = iter([torch.zeros(0) if g is None else g for g in grads])
        gt = tadam._map(lambda p: next(it), params)
        if mesh is not None:
            gt = gather_params(gt, mesh, tparams.param_specs(full, mesh))
        return loss, tadam.global_norm(tadam.leaves(gt)), gt

    for shape in TRAIN_MESHES:
        if shape[0] * shape[1] != world:
            continue
        mesh = tmesh.make_mesh(*shape)
        local = shard_params(full, mesh)
        for wire in WIRES:
            tag = f"train{shape[0]}x{shape[1]}/{wire}"
            loss, norm, gt = accum(_cfg(treg, tbase, wire), mesh, local)
            out.update({f"{tag}/loss": loss, f"{tag}/gn": norm})
            out.update({f"{tag}/g/{k}": v
                        for k, v in _grad_flat(gt).items()})
        nolsh = _cfg(treg, tbase, use_lsh=False)
        for tag, mm, p in (("mesh", mesh, local), ("free", None, full)):
            loss, norm, gt = accum(nolsh, mm, p, use_lsh=False)
            key = f"nolsh{shape[0]}x{shape[1]}/{tag}"
            out.update({f"{key}/loss": loss, f"{key}/gn": norm})
            out.update({f"{key}/g/{k}": v
                        for k, v in _grad_flat(gt).items()})
    np.savez(out_path.format(world=world, rank=rank),
             **{k: np.asarray(v.detach() if torch.is_tensor(v) else v)
                for k, v in out.items()})
    return 0


# ------------------------------------------------------------- tests --

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    from repro.configs import base as jbase
    from repro.configs import registry as jreg
    from repro.launch.mesh import make_host_mesh
    from repro.models import model as jmodel
    from repro.models import ssm as jssm

    tmp = tmp_path_factory.mktemp("tp")
    cfg = _cfg(jreg, jbase)
    params = jmodel.init_params(jax.random.PRNGKey(0), cfg,
                                make_host_mesh(1, 1, 1))
    mp3 = jssm.mamba_init(jax.random.PRNGKey(3), MAMBA3_D, _ssm3(cfg),
                          jax.numpy.float32)
    inp = dict(_inputs())
    for pre, tree in (("p", params), ("p3", mp3)):
        inp.update({f"{pre}/{k}": np.asarray(v) for k, v in _flat(
            jax.tree.map(np.asarray, tree)).items()})
    inp_path = tmp / "inputs.npz"
    np.savez(inp_path, **inp)
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jax_proc = subprocess.Popen(
        [sys.executable, str(HERE), "jax", str(inp_path),
         str(tmp / "jax.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    port_env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    try:
        # the world-2 and world-4 ranks at once
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            for r in [pool.submit(
                    tmesh.spawn_cpu_ranks, str(HERE), world,
                    [str(inp_path), str(tmp / "port_{world}_{rank}.npz")],
                    store=str(tmp / f"store{world}"), env=port_env,
                    timeout_s=600) for world in (2, 4)]:
                r.result()
    finally:
        _, err = jax_proc.communicate(timeout=900)
    assert jax_proc.returncode == 0, err[-4000:]
    return {"jax": dict(np.load(tmp / "jax.npz")),
            "port": {w: [dict(np.load(tmp / f"port_{w}_{r}.npz"))
                         for r in range(w)] for w in (2, 4)}}


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _close(got, want, rtol, what):
    r = _rel_l2(got, want)
    assert got.shape == want.shape and r <= rtol, (what, r, got.shape,
                                                   want.shape)
    return r


@pytest.mark.parametrize("g", HELPER_MODELS)
def test_helpers_match_jax(runs, g):
    """Forward and VJP of sp_gather, tp_in_project and tp_project."""
    ref, ranks = runs["jax"], runs["port"][g]
    for m, got in enumerate(ranks):
        seq = slice(m * X[1] // g, (m + 1) * X[1] // g)
        cols = slice(m * W_IN[1] // g, (m + 1) * W_IN[1] // g)
        rows = slice(m * W_OUT[0] // g, (m + 1) * W_OUT[0] // g)
        np.testing.assert_array_equal(got["gather"], ref[f"g{g}/gather"])
        np.testing.assert_array_equal(got["gather/dx"],
                                      ref[f"g{g}/gather/dx"][:, seq])
        for key, want in (("in", ref[f"g{g}/in"][..., cols]),
                          ("rep", ref[f"g{g}/rep"]),
                          ("in/dx", ref[f"g{g}/in/dx"][:, seq]),
                          ("in/dw", ref[f"g{g}/in/dw"]),
                          ("rep/dw", ref[f"g{g}/rep/dw"]),
                          ("out", ref[f"g{g}/out"][:, seq]),
                          ("out/dh", ref[f"g{g}/out/dh"][..., rows]),
                          ("out/dw", ref[f"g{g}/out/dw"])):
            _close(got[key], want, HELPER_RTOL, (g, m, key))


def _check_mamba(runs, tag, seq_len):
    """Rank by rank, ``tag``'s output and gradients against JAX's on
    (1, 2) and the port's mesh-free function -> the worst rel L2."""
    ref, ranks = runs["jax"], runs["port"][2]
    worst = 0.0
    free_tag = f"{tag}_free"
    for m, got in enumerate(ranks):
        seq = slice(m * seq_len // 2, (m + 1) * seq_len // 2)
        free = {k: v[:, seq] if k in (f"{free_tag}/y", f"{free_tag}/dx")
                else v for k, v in got.items()}
        for want, pre in ((ref, tag), (free, free_tag)):
            for key in ("y", "dx"):
                w = want[f"{pre}/{key}"]
                w = w[:, seq] if pre == tag else w
                worst = max(worst, _close(got[f"{tag}/{key}"], w,
                                          MAMBA_RTOL, (m, pre, key)))
            keys = [k for k in want if k.startswith(f"{pre}/dp/")]
            assert len(keys) == 11
            for k in keys:
                worst = max(worst, _close(
                    got[f"{tag}/dp/" + k[len(f"{pre}/dp/"):]], want[k],
                    MAMBA_RTOL, (m, k)))
    return worst


def test_mamba_apply_on_a_model_axis_of_two(runs):
    """Output and gradients against JAX's on (1, 2) and the port's
    mesh-free function."""
    worst = _check_mamba(runs, "mamba", MAMBA_X[1])
    print(f"mamba_apply at (1, 2): worst rel L2 {worst:.3g}")


def test_mamba_heads_that_do_not_split_match_jax(runs):
    """3 heads over a model axis of 2: the layer runs replicated over it
    (JAX's fallback); output and gradients as above."""
    worst = _check_mamba(runs, "mamba3", MAMBA3_X[1])
    print(f"mamba_apply, 3 heads at (1, 2): worst rel L2 {worst:.3g}")


def _grads(store, pre):
    return {k[len(pre):]: v for k, v in store.items() if k.startswith(pre)}


@pytest.mark.parametrize("shape", TRAIN_MESHES, ids=["1x2", "2x2"])
@pytest.mark.parametrize("wire", list(WIRES))
def test_train_step_matches_jax(runs, shape, wire):
    from repro_torch.convert import params_from_jax
    ref = runs["jax"]
    world = shape[0] * shape[1]
    port = runs["port"][world]
    tag = f"train{shape[0]}x{shape[1]}/{wire}"
    loss_tol, grad_tol = BOUNDS[wire]
    for r in port:                      # every rank holds the global loss
        np.testing.assert_array_equal(r[f"{tag}/loss"], port[0][f"{tag}/loss"])
    got = port[0]
    want = _flat(params_from_jax(_unflat(_grads(ref, f"{tag}/g/")),
                                 device="cpu"))
    mine = _grads(got, f"{tag}/g/")
    assert set(mine) == set(want) and len(want) > 50
    worst = max(_rel_l2(mine[k], want[k]) for k in want)
    loss_rel = abs(float(got[f"{tag}/loss"]) - float(ref[f"{tag}/loss"])) \
        / abs(float(ref[f"{tag}/loss"]))
    gn_rel = abs(float(got[f"{tag}/gn"]) - float(ref[f"{tag}/gn"])) \
        / float(ref[f"{tag}/gn"])
    print(f"jamba smoke at {shape}, wire {wire}: loss rel {loss_rel:.3g}, "
          f"clip norm rel {gn_rel:.3g}, worst gradient rel L2 {worst:.3g}")
    assert loss_rel <= loss_tol and gn_rel <= grad_tol and worst <= grad_tol


@pytest.mark.parametrize("shape", TRAIN_MESHES, ids=["1x2", "2x2"])
def test_train_step_matches_the_mesh_free_step(runs, shape):
    got = runs["port"][shape[0] * shape[1]][0]
    key = f"nolsh{shape[0]}x{shape[1]}"
    a, b = _grads(got, f"{key}/mesh/g/"), _grads(got, f"{key}/free/g/")
    assert set(a) == set(b) and a
    worst = max(_rel_l2(a[k], b[k]) for k in b)
    loss_rel = abs(float(got[f"{key}/mesh/loss"])
                   - float(got[f"{key}/free/loss"])) \
        / abs(float(got[f"{key}/free/loss"]))
    print(f"jamba smoke at {shape} against mesh-free, LSH off: loss rel "
          f"{loss_rel:.3g}, worst gradient rel L2 {worst:.3g}")
    assert loss_rel <= BOUNDS["f32"][0] and worst <= BOUNDS["f32"][1]


def test_prefill_matches_jax(runs):
    ref = runs["jax"]["prefill"]
    for got in runs["port"][2]:         # every rank returns the global
        r = _close(got["prefill"], ref, 1e-5, "prefill")
    print(f"prefill at (1, 2): last logits rel L2 {r:.3g}")


def test_a_width_that_does_not_split_takes_the_fallback():
    """``projects_whole`` says where runtime/tp.py's replicated fallback
    is taken: for a projection whose columns, or rows over ``data``, do
    not split; Mamba heads that do not split take it too (against JAX:
    ``test_mamba_heads_that_do_not_split_match_jax``)."""
    from repro_torch.configs import base as tbase
    from repro_torch.configs import registry as treg
    from repro_torch.models import ssm as tssm
    from repro_torch.runtime import params as tparams
    from repro_torch.runtime import tp
    mesh = tmesh.Mesh((1, 4))           # shapes are checked before a call
    assert tp.projects_whole(mesh, [(("data",), ())])
    assert tp.projects_whole(tmesh.Mesh((2, 4)), [((), ("model",))])
    assert not tp.projects_whole(mesh, [(("data",), ("model",))])
    assert not tp.projects_whole(mesh, [(("data",), ())], [True])
    assert not tp.projects_whole(tmesh.Mesh((2, 1)), [((), ())])
    ssm = _ssm3(_cfg(treg, tbase))
    p = tssm.mamba_init(torch.Generator().manual_seed(0), MAMBA3_D, ssm,
                        torch.float32, "cpu")
    specs = tparams.param_specs(p, tmesh.Mesh((1, 2)))
    assert "model" not in specs["w_dt"][1] and "model" in specs["w_x"][1]
    assert tp.projects_whole(tmesh.Mesh((1, 2)), [
        specs[k] for k in ("w_z", "w_x", "w_b", "w_c", "w_dt")],
        (False, False, True, True, False))


@pytest.mark.parametrize("arch,dtype", [
    pytest.param(ARCH, "float32", id="float32"),
    pytest.param(ARCH, "bfloat16", id="bfloat16"),
    pytest.param("granite-8b", "float32", id="granite-8b-float32"),
    pytest.param("granite-8b", "bfloat16", id="granite-8b-bfloat16")])
def test_one_rank_model_axis_is_the_mesh_free_path_bitwise(arch, dtype,
                                                          tmp_path):
    """A (1, 1) mesh of one gloo rank: loss_fn and every gradient bit-equal
    to the mesh-free run (the TP collectives run over a one-rank group)."""
    outs = tmesh.spawn_cpu_ranks(str(HERE), 1, ["one", dtype, arch],
                                 store=str(tmp_path / "store"),
                                 timeout_s=240)
    rec = json.loads(outs[0].strip().splitlines()[-1])
    assert rec == {"loss_equal": True, "grads_equal": True,
                   "grads": rec["grads"]} and \
        rec["grads"] > (50 if arch == ARCH else 20)


def _one_rank_main(rank, world, args):
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.models import model as tmodel
    from repro_torch.optim import adam as tadam
    from repro_torch.runtime import step as tstep
    cpu = torch.device("cpu")
    mesh = tmesh.make_mesh(1, 1)
    cfg = get_smoke_config(args[2]).replace(dtype=args[1])
    params = tmodel.init_params(cfg, seed=0, device=cpu)
    batch = tstep.batch_to_device(SyntheticLMDataset(
        cfg.vocab_size, SEQ, BATCH).batch_at(0), cpu)
    train = [p for p in tadam.leaves(params) if p.is_floating_point()]
    for p in train:
        p.requires_grad_(True)
    res = []
    for m in (None, mesh):
        loss, _ = tmodel.loss_fn(params, cfg, batch, mesh=m)
        res.append((loss.detach(), torch.autograd.grad(loss, train,
                                                       allow_unused=True)))
    (la, ga), (lb, gb) = res
    same = all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip(ga, gb))
    print(json.dumps({"loss_equal": bool(torch.equal(la, lb)),
                      "grads_equal": same,
                      "grads": sum(a is not None for a in ga)}))
    return 0


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_main(*sys.argv[2:])
    else:                                   # RANK WORLD STORE args...
        main = _one_rank_main if sys.argv[4:5] == ["one"] else _port_main
        sys.exit(tmesh.run_cpu_rank(sys.argv[1:], main))
