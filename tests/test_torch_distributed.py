"""The port's expert-parallel MoE layer over several CPU ranks (gloo)
against the JAX package's on the same forced-device mesh.

``moe_expert_parallel`` at meshes (data, model) = (1, 2), (2, 2) and
(1, 4) (which pads the 6 experts to 8), with the f32 wire
(``wire_dtype="float32"``) and LSH on and off, and the int8 and fp8 wires
with LSH on and off, each fused and composed ($REPRO_FUSED_WIRE=0); and
the decode layer ``moe_dense_dispatch`` at (2, 2) and (1, 4) (its planned
exchange, ``_moe_dense_planned``) and at (2, 1) (one plan over the batch
gathered over data).  The JAX
side runs once for the module in a subprocess with 4 forced host devices
(``a2a_impl="flat"``, the ``reference`` kernel backend); the port's ranks
are subprocesses that meet through a FileStore
(``launch.mesh.spawn_cpu_ranks``), each holding its tokens [B / data,
S / model] and its expert shard [E_pad / model, H / data, F].

Rank r's objective is sum(y_r * ct_r) + (aux + z) / n_ranks, its share of
JAX's sum(y * ct) + aux + z; the router's gradients are summed over the
ranks here, the expert shards' put together.  Tolerances are those of the
one-card layer tests (test_torch_train.py, test_torch_wire.py): y, aux and
z within 1e-5, every gradient within 1e-4 relative L2, load and each
rank's LSH slots exact; fused and composed bitwise equal in the port.
The decode: y within 1e-5 of JAX's and of the port's one-rank
``moe_dense_dispatch`` on the whole batch, and for the planned exchange
aux / z within 1e-5 and load exact.
"""
import dataclasses
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

from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402

H, F, E, TOP_K = 16, 32, 6, 2
B, S = 2, 16                      # training tokens
BD, SD = 4, 2                     # decode tokens
MESHES = ((1, 2), (2, 2), (1, 4))
# (2, 1): no model axis, so decode gathers the batch over data and runs
# the one-plan dispatch (the JAX package's GSPMD path)
DECODE_MESHES = ((2, 2), (1, 4), (2, 1))
# name: (wire_dtype, wire_format, use_lsh, fused)
CASES = {
    "f32-lsh": ("float32", "bf16", True, True),
    "f32-nolsh": ("float32", "bf16", False, True),
    "int8-lsh-fused": ("bfloat16", "int8", True, True),
    "int8-lsh-composed": ("bfloat16", "int8", True, False),
    "fp8-lsh-fused": ("bfloat16", "fp8", True, True),
    "fp8-lsh-composed": ("bfloat16", "fp8", True, False),
    "int8-nolsh-fused": ("bfloat16", "int8", False, True),
    "int8-nolsh-composed": ("bfloat16", "int8", False, False),
}
DIFF = ("router_w", "w_gate", "w_up", "w_down")


def _jax_key(case):
    """The JAX run a case is held against (fused and composed share it)."""
    wd, fmt, lsh, _ = CASES[case]
    return f"{wd}-{fmt}-{int(lsh)}"


def _moe_cfg(b, case):
    wd, fmt, lsh, _ = CASES[case]
    return b.MoEConfig(num_experts=E, top_k=TOP_K, expert_ffn_dim=F,
                       capacity_factor=2.0, kernel_backend="reference",
                       comm=b.CommConfig(a2a_impl="flat"),
                       lsh=b.LSHConfig(enabled=lsh, num_hashes=3,
                                       rotation_dim=16, compression_rate=0.5,
                                       wire_dtype=wd, wire_format=fmt))


def _e_pad(mesh_shape):
    m = mesh_shape[1]
    return -(-E // m) * m


def _inputs():
    """Numpy inputs from a seed: tokens, cotangent, decode tokens, and the
    layer's params for each padded expert count."""
    rng = np.random.default_rng(17)
    out = {"x": rng.standard_normal((B, S, H)).astype(np.float32),
           "ct": rng.standard_normal((B, S, H)).astype(np.float32),
           "xd": rng.standard_normal((BD, SD, H)).astype(np.float32),
           "router_w": (rng.standard_normal((H, E)) / 4).astype(np.float32),
           "lsh_rot": rng.standard_normal((3, H, 16)).astype(np.float32),
           "placement": rng.permutation(E).astype(np.int32)}
    for ep in sorted({_e_pad(m) for m in MESHES}):
        out[f"w_gate{ep}"] = (rng.standard_normal((ep, H, F)) / 4).astype(
            np.float32)
        out[f"w_up{ep}"] = (rng.standard_normal((ep, H, F)) / 4).astype(
            np.float32)
        out[f"w_down{ep}"] = (rng.standard_normal((ep, F, H)) / 6).astype(
            np.float32)
    return out


def _params(inp, ep):
    return {"router_w": inp["router_w"], "w_gate": inp[f"w_gate{ep}"],
            "w_up": inp[f"w_up{ep}"], "w_down": inp[f"w_down{ep}"],
            "lsh_rot": inp["lsh_rot"], "placement": inp["placement"]}


# ------------------------------------------------- the JAX reference --

def _jax_main(inp_path, out_path):
    import jax
    import jax.numpy as jnp

    from repro.compat import set_mesh
    from repro.configs import base as jbase
    from repro.core import clustering as jclust
    from repro.core.lsh_moe import lsh_moe_apply
    from repro.launch.mesh import make_host_mesh

    inp = dict(np.load(inp_path))
    rec = {}
    orig = jclust.assign_slots

    def spy(tokens, rotations, num_slots, hash_type, backend=None):
        s = orig(tokens, rotations, num_slots, hash_type, backend)
        idx = jax.lax.axis_index(("data", "model"))
        jax.debug.callback(
            lambda v, i: rec.setdefault(int(i), np.asarray(v).copy()), s, idx)
        return s

    jclust.assign_slots = spy
    out = {}
    for ms in MESHES + tuple(m for m in DECODE_MESHES if m not in MESHES):
        mesh = make_host_mesh(ms[0], 1, ms[1])
        params = {k: jnp.asarray(v) for k, v in
                  _params(inp, _e_pad(ms)).items()}
        done = set()
        for case in CASES if ms in MESHES else ():
            key = _jax_key(case)
            if key in done:
                continue
            done.add(key)
            cfg = _moe_cfg(jbase, case)
            lsh = CASES[case][2]

            def obj(p, x):
                y, st = lsh_moe_apply({**params, **p}, x, cfg, mesh,
                                      mlp_act="swiglu", mode="train",
                                      use_lsh=lsh)
                return jnp.sum(y * inp["ct"]) + st["aux_loss"] \
                    + st["z_loss"], (y, st)

            rec.clear()
            with set_mesh(mesh):
                (_, (y, st)), (gp, gx) = jax.jit(jax.value_and_grad(
                    obj, argnums=(0, 1), has_aux=True))(
                        {k: params[k] for k in DIFF},
                        jnp.asarray(inp["x"]))
                jax.block_until_ready(y)
            tag = f"{ms[0]}x{ms[1]}/{key}"
            out[f"{tag}/y"] = np.asarray(y)
            out[f"{tag}/gx"] = np.asarray(gx)
            for k in DIFF:
                out[f"{tag}/g_{k}"] = np.asarray(gp[k])
            for k in ("aux_loss", "z_loss", "expert_load"):
                out[f"{tag}/{k}"] = np.asarray(st[k])
            for r, s in rec.items():
                out[f"{tag}/slots{r}"] = s
        if ms in DECODE_MESHES:
            cfg = _moe_cfg(jbase, "f32-nolsh")
            with set_mesh(mesh):
                y, st = jax.jit(lambda p, x: lsh_moe_apply(
                    p, x, cfg, mesh, mlp_act="swiglu", mode="decode"))(
                        params, jnp.asarray(inp["xd"]))
            tag = f"{ms[0]}x{ms[1]}/decode"
            out[f"{tag}/y"] = np.asarray(y)
            for k in ("aux_loss", "z_loss", "expert_load"):
                out[f"{tag}/{k}"] = np.asarray(st[k])
    np.savez(out_path, **out)


# ------------------------------------------------- the port's ranks --

def _port_main(rank, world, args):
    inp_path, out_path, d, m = args
    from repro_torch.comm import wire as twire
    from repro_torch.convert import shard_params, tensor_from_numpy
    from repro_torch.core import clustering as tclust
    from repro_torch.core import moe as tmoe
    from repro_torch.core.lsh_moe import lsh_moe_apply
    from repro_torch.runtime import sharding

    cpu = torch.device("cpu")
    mesh = tmesh.make_mesh(int(d), int(m))
    inp = dict(np.load(inp_path))
    full = {k: tensor_from_numpy(v, cpu) for k, v in
            _params(inp, _e_pad((int(d), int(m)))).items()}
    bs, ss = sharding.token_slices(mesh, B, S)
    rec = []
    orig = tclust.assign_slots

    def spy(tokens, rotations, num_slots, hash_type):
        s = orig(tokens, rotations, num_slots, hash_type)
        rec.append(s.numpy().copy())
        return s

    tclust.assign_slots = spy
    out = {}
    for case in CASES if (int(d), int(m)) in MESHES else ():
        os.environ[twire.FUSED_ENV] = "1" if CASES[case][3] else "0"
        cfg = _moe_cfg(tbase, case)
        p = shard_params(full, mesh)
        for k in DIFF:
            p[k] = p[k].clone().requires_grad_(True)
        x = torch.from_numpy(inp["x"][bs, ss].copy()).requires_grad_(True)
        ct = torch.from_numpy(inp["ct"][bs, ss].copy())
        rec.clear()
        y, st = lsh_moe_apply(p, x, cfg, mlp_act="swiglu", mode="train",
                              use_lsh=CASES[case][2], mesh=mesh)
        obj = (y * ct).sum() + (st["aux_loss"] + st["z_loss"]) / world
        grads = torch.autograd.grad(obj, [x] + [p[k] for k in DIFF])
        out[f"{case}/y"] = y.detach().numpy()
        out[f"{case}/gx"] = grads[0].numpy()
        for k, g in zip(DIFF, grads[1:]):
            out[f"{case}/g_{k}"] = g.numpy()
        for k in ("aux_loss", "z_loss", "expert_load"):
            out[f"{case}/{k}"] = st[k].detach().numpy()
        if rec:
            out[f"{case}/slots"] = rec[0]
    if (int(d), int(m)) in DECODE_MESHES:
        cfg = _moe_cfg(tbase, "f32-nolsh")
        n_dp = int(d)
        bl = BD // n_dp
        di = mesh.axis_index("data")
        xd = torch.from_numpy(inp["xd"][di * bl:(di + 1) * bl].copy())
        with torch.no_grad():
            p = shard_params(full, mesh)
            out["decode/y"] = tmoe.moe_dense_dispatch(
                xd, p, cfg, mesh=mesh, mlp_act="swiglu").numpy()
            if int(m) > 1:
                y, st = tmoe._moe_dense_planned(xd, p, cfg, mesh=mesh,
                                                mlp_act="swiglu")
                assert torch.equal(y, torch.from_numpy(out["decode/y"]))
                for k in ("aux_loss", "z_loss", "expert_load"):
                    out[f"decode/{k}"] = st[k].numpy()
    np.savez(out_path.format(rank=rank), **out)
    return 0


# ------------------------------------------------------------- tests --

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"jax": the reference's arrays, (d, m): [each rank's arrays]}."""
    tmp = tmp_path_factory.mktemp("dist_moe")
    inp_path = tmp / "inputs.npz"
    np.savez(inp_path, **_inputs())
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jax_proc = subprocess.Popen(
        [sys.executable, str(HERE), "jax", str(inp_path),
         str(tmp / "jax.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    out = {}
    penv = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    try:
        for d, m in MESHES + tuple(x for x in DECODE_MESHES
                                   if x not in MESHES):
            world = d * m
            tmesh.spawn_cpu_ranks(
                str(HERE), world,
                [str(inp_path), str(tmp / f"{d}x{m}_{{rank}}.npz"), str(d),
                 str(m)],
                store=str(tmp / f"store{d}x{m}"), env=penv, timeout_s=300)
            out[(d, m)] = [dict(np.load(tmp / f"{d}x{m}_{r}.npz"))
                           for r in range(world)]
    finally:
        _, err = jax_proc.communicate(timeout=600)
    assert jax_proc.returncode == 0, err[-4000:]
    out["jax"] = dict(np.load(tmp / "jax.npz"))
    out["inputs"] = dict(np.load(inp_path))
    return out


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _assemble(ranks, key, mesh_shape, kind):
    """Put the ranks' pieces of ``key`` together: tokens [B, S, ...] by
    (batch, sequence) slices, expert shards by (expert, dim 1) slices,
    replicated gradients by summing."""
    d_r, m_r = mesh_shape
    if kind == "sum":
        return sum(r[key] for r in ranks)
    rows = []
    for d in range(d_r):
        parts = [ranks[d * m_r + m][key] for m in range(m_r)]
        rows.append(np.concatenate(parts, axis=1 if kind == "tokens"
                                   else 0))
    return np.concatenate(rows, axis=0 if kind == "tokens" else 1)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mesh_shape", MESHES,
                         ids=[f"{d}x{m}" for d, m in MESHES])
def test_moe_expert_parallel_matches_jax(runs, mesh_shape, case):
    ranks, ref = runs[mesh_shape], runs["jax"]
    tag = f"{mesh_shape[0]}x{mesh_shape[1]}/{_jax_key(case)}"
    y = _assemble(ranks, f"{case}/y", mesh_shape, "tokens")
    err = float(np.abs(y - ref[f"{tag}/y"]).max())
    grads = {"x": (_assemble(ranks, f"{case}/gx", mesh_shape, "tokens"),
                   ref[f"{tag}/gx"]),
             "router_w": (_assemble(ranks, f"{case}/g_router_w", mesh_shape,
                                    "sum"), ref[f"{tag}/g_router_w"])}
    for k in ("w_gate", "w_up", "w_down"):
        grads[k] = (_assemble(ranks, f"{case}/g_{k}", mesh_shape, "experts"),
                    ref[f"{tag}/g_{k}"])
    worst = {k: _rel_l2(a, b) for k, (a, b) in grads.items()}
    print(f"{mesh_shape} {case}: max |y diff| {err:.3g}, gradient rel L2 "
          f"{worst}")
    assert err <= 1e-5
    assert max(worst.values()) < 1e-4, worst
    for r in ranks:
        for k in ("aux_loss", "z_loss"):
            np.testing.assert_allclose(r[f"{case}/{k}"], ref[f"{tag}/{k}"],
                                       atol=1e-5, err_msg=k)
        np.testing.assert_array_equal(r[f"{case}/expert_load"],
                                      ref[f"{tag}/expert_load"])
    if CASES[case][2]:
        for i, r in enumerate(ranks):
            np.testing.assert_array_equal(r[f"{case}/slots"],
                                          ref[f"{tag}/slots{i}"])
    if not CASES[case][3]:          # composed: bitwise the fused run
        fused = case.replace("composed", "fused")
        for r in ranks:
            for k in r:
                if k.startswith(case + "/"):
                    np.testing.assert_array_equal(
                        r[k], r[fused + k[len(case):]], err_msg=k)


@pytest.mark.parametrize("mesh_shape", DECODE_MESHES,
                         ids=[f"{d}x{m}" for d, m in DECODE_MESHES])
def test_moe_dense_dispatch_mesh_matches_jax(runs, mesh_shape):
    ranks, ref = runs[mesh_shape], runs["jax"]
    tag = f"{mesh_shape[0]}x{mesh_shape[1]}/decode"
    d_r, m_r = mesh_shape
    for d in range(d_r):
        for m in range(m_r):             # replicated along model
            np.testing.assert_array_equal(ranks[d * m_r + m]["decode/y"],
                                          ranks[d * m_r]["decode/y"])
    y = np.concatenate([ranks[d * m_r]["decode/y"] for d in range(d_r)])
    err = float(np.abs(y - ref[f"{tag}/y"]).max())
    print(f"{mesh_shape} decode: max |y diff| {err:.3g}")
    assert err <= 1e-5
    if m_r == 1:            # the one-plan path reports no stats
        return
    for r in ranks:
        for k in ("aux_loss", "z_loss"):
            np.testing.assert_allclose(r[f"decode/{k}"], ref[f"{tag}/{k}"],
                                       atol=1e-5, err_msg=k)
        np.testing.assert_array_equal(r["decode/expert_load"],
                                      ref[f"{tag}/expert_load"])


@pytest.mark.parametrize("mesh_shape", DECODE_MESHES,
                         ids=[f"{d}x{m}" for d, m in DECODE_MESHES])
def test_moe_dense_dispatch_mesh_matches_one_rank(runs, mesh_shape):
    """The planned decode over the mesh against the port's one-rank
    ``moe_dense_dispatch`` on the whole batch with the full params."""
    from repro_torch.convert import tensor_from_numpy
    from repro_torch.core.moe import moe_dense_dispatch
    inp = runs["inputs"]
    ranks = runs[mesh_shape]
    d_r, m_r = mesh_shape
    cpu = torch.device("cpu")
    p = {k: tensor_from_numpy(v, cpu)
         for k, v in _params(inp, _e_pad(mesh_shape)).items()}
    want = moe_dense_dispatch(torch.from_numpy(inp["xd"]), p,
                              _moe_cfg(tbase, "f32-nolsh"), mlp_act="swiglu")
    y = np.concatenate([ranks[d * m_r]["decode/y"] for d in range(d_r)])
    np.testing.assert_allclose(y, want.numpy(), atol=1e-5)


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_main(*sys.argv[2:])
    else:                                   # RANK WORLD STORE args...
        sys.exit(tmesh.run_cpu_rank(sys.argv[1:], _port_main))
