"""The port's training step over four CPU ranks (gloo) against the JAX
package's on four forced host devices, and the launcher under torchrun.

- The granite-moe-3b-a800m smoke config in f32 at mesh (data, model) =
  (2, 2), LSH on, 2 steps, with the f32, bf16 and int8 wires: each
  step's loss and clip norm, and every param after the second AdamW step
  (the expert shards gathered), against JAX's ``make_accum_grad_fn`` +
  ``apply_gradients`` (the two halves of ``make_train_step``) on the same
  mesh.  The f32 wire (``wire_dtype="float32"``) is held to the bounds of
  test_torch_train.py's f32 wire: loss and clip norm within 1e-5
  relative at both steps, params within 1e-5 relative L2 (measured:
  7e-8, 4e-7, 4.2e-7).  That holds the mesh path itself (sequence
  sharding, K / V gathers, the all-to-alls, FSDP gathers, loss shares,
  gradient sync, clip norm) to JAX's.
- The bf16 and int8 wires round the expert outputs to bf16 steps or
  whole quanta, so where the two packages' f32 sums differ in the last
  bit a value moves by a step (ROADMAP Queue 3).  At this seed one
  expert output value of magnitude about 46 rounds the other way in the
  first layer (0.18 on one token), so these are held to bounds stated by
  measurement rather than test_train_step_matches_jax's (whose seed
  rounds nothing the other way): the first step's loss within 1e-4
  (measured 3.1e-5 bf16, 6.4e-5 int8) and clip norm within 1e-3 (its
  gradients' bound; measured 5.8e-5, 2.1e-4); the second step, which
  reads params moved by an AdamW step where a tiny gradient's sign may
  differ, its loss within 2e-2 (the bf16-wire trajectory bound of
  test_quickstart_loss_trajectory_matches_jax; measured 1.4e-3, 2.0e-4)
  and clip norm within 5e-2 (measured 8.4e-3, 1.7e-2); params after both
  steps within 1e-3 relative L2, test_train_step_matches_jax's bound
  (measured 6.7e-4, 5.4e-4).
- The pure data-parallel step (``cfg.dp_only``) at 4 ranks, 2 steps, of
  the smoke config's dense variant ((attention, dense MLP) blocks: the
  JAX package's dp_only step runs its layers without a mesh, which its
  MoE layer does not take), against JAX's ``_make_dp_only_train_step``:
  loss within 1e-5 relative, params within 1e-5 relative L2.  JAX
  averages with ``pmean``, the port with gloo's all-reduce, which sums
  in another order: the last bits may differ.
- ``compressed_psum`` (int8 with error feedback), two rounds over 4
  ranks, against JAX's inside ``shard_map``: the error carries and the
  averaged gradients within 4 f32 ulps of the largest gradient magnitude
  (measured 2.0e-7 at magnitudes near 3).  Not bitwise: under jit XLA
  takes the scale as absmax * (1/127) where the port divides, and fuses
  gf - q * scale into one FMA; the all-reduce sums in another order.
- ``launch/train.py --mesh-model 2 --device cpu`` under
  ``torchrun --standalone --nproc-per-node 2``, 2 steps: rank 0 alone
  prints its step lines and summary, with finite losses.

Params are JAX's ``init_params``, carried with ``convert.params_from_jax``
and cut with ``shard_params``; batches are ``SyntheticLMDataset``'s.
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
if __name__ != "__main__":
    pytest.importorskip("jax")

HERE = Path(__file__).resolve()
SRC = HERE.parents[1] / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

from repro_torch.launch import mesh as tmesh  # noqa: E402

ARCH = "granite-moe-3b-a800m"
MESH = (2, 2)
BATCH, SEQ, STEPS = 4, 16, 2
WIRES = {"f32": ("float32", "bf16"), "bf16": ("bfloat16", "bf16"),
         "int8": ("bfloat16", "int8")}
# wire: ((loss, clip norm) relative bounds at step 1, at step 2), params
BOUNDS = {"f32": (((1e-5, 1e-5), (1e-5, 1e-5)), 1e-5),
          "bf16": (((1e-4, 1e-3), (2e-2, 5e-2)), 1e-3),
          "int8": (((1e-4, 1e-3), (2e-2, 5e-2)), 1e-3)}
OPT = dict(lr=1e-3, warmup_steps=10, total_steps=100)


def _cfg(b, registry, wire=None, dp_only=False):
    """The smoke config in f32 with a wire (None: the f32 wire); under
    ``dp_only`` its dense variant (attention + dense MLP blocks), since
    the JAX package's dp_only step runs no MoE layer."""
    import dataclasses
    cfg = registry.get_smoke_config(ARCH).replace(dtype="float32",
                                                  dp_only=dp_only)
    if dp_only:
        cfg = cfg.replace(layout=((b.ATTN, b.DENSE),))
    wd, fmt = WIRES[wire] if wire else ("float32", "bf16")
    return cfg.replace(moe=dataclasses.replace(cfg.moe, lsh=dataclasses.replace(
        cfg.moe.lsh, wire_dtype=wd, wire_format=fmt)))


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


def _grads_inputs():
    rng = np.random.default_rng(23)
    return {f"g{r}/{k}": rng.standard_normal(shape).astype(np.float32)
            * scale
            for r in range(4) for k, shape, scale in
            (("a", (3, 50), 1.0), ("b", (7,), 1e-3))} | {
        f"h{r}/{k}": rng.standard_normal(shape).astype(np.float32)
        for r in range(4) for k, shape in (("a", (3, 50)), ("b", (7,)))}


# ------------------------------------------------- the JAX reference --

def _jax_main(inp_path, out_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.compat import set_mesh, shard_map
    from repro.configs import base as jbase
    from repro.configs import registry as jreg
    from repro.data.synthetic import SyntheticLMDataset
    from repro.launch.mesh import make_host_mesh
    from repro.optim import adam as jadam
    from repro.optim.grad_compress import compressed_psum
    from repro.runtime import step as jstep

    inp = dict(np.load(inp_path))
    params = jax.tree.map(jnp.asarray, _unflat(
        {k[2:]: v for k, v in inp.items() if k.startswith("p/")}))
    dense = jax.tree.map(jnp.asarray, _unflat(
        {k[3:]: v for k, v in inp.items() if k.startswith("pd/")}))
    mesh = make_host_mesh(MESH[0], 1, MESH[1])
    opt = jbase.OptimizerConfig(**OPT)
    ds = SyntheticLMDataset(515, SEQ, BATCH)
    batches = [{k: jnp.asarray(v) for k, v in ds.batch_at(s).items()}
               for s in range(STEPS)]
    out = {}
    with set_mesh(mesh):
        for wire in WIRES:
            cfg = _cfg(jbase, jreg, wire)
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
        cfg = _cfg(jbase, jreg, None, dp_only=True)
        step = jax.jit(jstep.make_train_step(cfg, opt, mesh))
        state = jstep.TrainState(dense, jadam.adamw_init(dense, opt))
        for s, b in enumerate(batches):
            state, m = step(state, b)
            out[f"dp/loss{s}"] = np.asarray(m["loss"])
        out.update({f"dp/p/{k}": v for k, v in _flat(state.params).items()})

        axes = ("data", "model")

        def local(g, e):
            s, ne = compressed_psum(jax.tree.map(lambda a: a[0], g),
                                    jax.tree.map(lambda a: a[0], e), axes)
            return (jax.tree.map(lambda a: a[None], s),
                    jax.tree.map(lambda a: a[None], ne))

        fn = jax.jit(shard_map(local, mesh=mesh, in_specs=(P(axes), P(axes)),
                               out_specs=(P(axes), P(axes))))
        err = {k: jnp.zeros((4,) + inp[f"g0/{k}"].shape, jnp.float32)
               for k in ("a", "b")}
        for rnd, pre in enumerate(("g", "h")):
            g = {k: jnp.stack([inp[f"{pre}{r}/{k}"] for r in range(4)])
                 for k in ("a", "b")}
            synced, err = fn(g, err)
            for k in ("a", "b"):
                out[f"psum{rnd}/{k}"] = np.asarray(synced[k])
                out[f"err{rnd}/{k}"] = np.asarray(err[k])
    np.savez(out_path, **out)


# ------------------------------------------------- the port's ranks --

def _port_main(rank, world, args):
    inp_path, out_path = args
    from repro_torch.configs import base as tbase
    from repro_torch.configs import registry as treg
    from repro_torch.convert import (gather_params, params_from_jax,
                                     shard_params)
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.optim.adam import adamw_init
    from repro_torch.optim.grad_compress import (compressed_psum,
                                                 init_error_state)
    from repro_torch.runtime import sharding
    from repro_torch.runtime import step as tstep
    from repro_torch.runtime.params import model_specs, param_specs

    cpu = torch.device("cpu")
    mesh = tmesh.make_mesh(*MESH)
    inp = dict(np.load(inp_path))
    jparams = _unflat({k[2:]: v for k, v in inp.items()
                       if k.startswith("p/")})
    jdense = _unflat({k[3:]: v for k, v in inp.items()
                      if k.startswith("pd/")})
    opt = tbase.OptimizerConfig(**OPT)
    ds = SyntheticLMDataset(515, SEQ, BATCH)
    out = {}

    def run(tag, cfg, params):
        state = tstep.TrainState(params, adamw_init(params, opt))
        step = tstep.make_train_step(cfg, opt, mesh=mesh)
        for s in range(STEPS):
            state, m = step(state, tstep.batch_to_device(ds.batch_at(s),
                                                         cpu))
            out[f"{tag}/loss{s}"] = m["loss"].numpy()
            out[f"{tag}/gn{s}"] = m["grad_norm"].numpy()
            assert int(m["grad_skips"]) == 0
        return state.params

    for wire in WIRES:
        cfg = _cfg(tbase, treg, wire)
        whole = params_from_jax(jparams, device=cpu)
        specs = param_specs(whole, mesh)
        full = run(wire, cfg, shard_params(whole, mesh, specs))
        full = gather_params(full, mesh, specs)
        out.update({f"{wire}/p/{k}": v for k, v in _flat(full).items()})
    dcfg = _cfg(tbase, treg, None, dp_only=True)
    # the rank's FSDP shards over data (the dp_only profile's specs)
    dspecs = model_specs(dcfg, mesh)
    full = run("dp", dcfg, shard_params(params_from_jax(jdense, device=cpu),
                                        mesh, dspecs))
    full = gather_params(full, mesh, dspecs)
    out.update({f"dp/p/{k}": v for k, v in _flat(full).items()})

    group = sharding.all_group(mesh)
    grads = [torch.from_numpy(inp[f"g{rank}/{k}"]) for k in ("a", "b")]
    err = init_error_state(grads)
    for rnd, pre in enumerate(("g", "h")):
        grads = [torch.from_numpy(inp[f"{pre}{rank}/{k}"])
                 for k in ("a", "b")]
        synced, err = compressed_psum(grads, err, group)
        for k, s, e in zip(("a", "b"), synced, err):
            out[f"psum{rnd}/{k}"] = s.numpy()
            out[f"err{rnd}/{k}"] = e.numpy()
    np.savez(out_path.format(rank=rank), **out)
    return 0


# ------------------------------------------------------------- tests --

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    from repro.configs import base as jbase
    from repro.configs import registry as jreg
    from repro.launch.mesh import make_host_mesh
    from repro.models import model as jmodel

    tmp = tmp_path_factory.mktemp("dist_train")
    # the (2, 2) mesh pads nothing (6 experts over 2), so params made on
    # this process's one device are the mesh's
    cfg = jreg.get_smoke_config(ARCH).replace(dtype="float32")
    params = jmodel.init_params(jax.random.PRNGKey(0), cfg,
                                make_host_mesh(1, 1, 1))
    inp = {f"p/{k}": v for k, v in _flat(params).items()}
    dense = jmodel.init_params(jax.random.PRNGKey(1), _cfg(
        jbase, jreg, None, dp_only=True), make_host_mesh(1, 1, 1))
    inp.update({f"pd/{k}": v for k, v in _flat(dense).items()})
    inp.update(_grads_inputs())
    inp_path = tmp / "inputs.npz"
    np.savez(inp_path, **inp)
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jax_proc = subprocess.Popen(
        [sys.executable, str(HERE), "jax", str(inp_path),
         str(tmp / "jax.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        tmesh.spawn_cpu_ranks(
            str(HERE), 4, [str(inp_path), str(tmp / "port_{rank}.npz")],
            store=str(tmp / "store"),
            env=dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1"),
            timeout_s=300)
    finally:
        _, err = jax_proc.communicate(timeout=600)
    assert jax_proc.returncode == 0, err[-4000:]
    return {"jax": dict(np.load(tmp / "jax.npz")),
            "port": [dict(np.load(tmp / f"port_{r}.npz")) for r in range(4)]}


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _worst_param(port, ref, tag):
    """The largest relative L2 distance between the port's params and
    JAX's (carried to the port's layout), integer leaves equal."""
    from repro_torch.convert import params_from_jax
    pre = f"{tag}/p/"
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
def test_mesh_train_step_matches_jax(runs, wire):
    port, ref = runs["port"], runs["jax"]
    for s in range(STEPS):
        for r in port:            # every rank reports the global values
            np.testing.assert_array_equal(r[f"{wire}/loss{s}"],
                                          port[0][f"{wire}/loss{s}"])
        (loss_tol, gn_tol), param_tol = BOUNDS[wire][0][s], BOUNDS[wire][1]
        np.testing.assert_allclose(port[0][f"{wire}/loss{s}"],
                                   ref[f"{wire}/loss{s}"], rtol=loss_tol)
        np.testing.assert_allclose(port[0][f"{wire}/gn{s}"],
                                   ref[f"{wire}/gn{s}"], rtol=gn_tol)
    worst = _worst_param(port[0], ref, wire)
    print(f"(2, 2) {wire} wire: losses port "
          f"{[float(port[0][f'{wire}/loss{s}']) for s in range(STEPS)]} jax "
          f"{[float(ref[f'{wire}/loss{s}']) for s in range(STEPS)]}; norms "
          f"port {[float(port[0][f'{wire}/gn{s}']) for s in range(STEPS)]} "
          f"jax {[float(ref[f'{wire}/gn{s}']) for s in range(STEPS)]}; worst "
          f"param rel L2 {worst:.3g}")
    assert worst < BOUNDS[wire][1]


def test_dp_only_train_step_matches_jax(runs):
    port, ref = runs["port"], runs["jax"]
    for s in range(STEPS):
        np.testing.assert_allclose(port[0][f"dp/loss{s}"], ref[f"dp/loss{s}"],
                                   rtol=1e-5)
    for r in port[1:]:             # replicas stay bit-identical
        for k in r:
            if k.startswith("dp/p/"):
                np.testing.assert_array_equal(r[k], port[0][k], err_msg=k)
    worst = _worst_param(port[0], ref, "dp")
    print(f"dp_only: worst param rel L2 {worst:.3g}")
    assert worst < 1e-5


def test_compressed_psum_matches_jax(runs):
    port, ref = runs["port"], runs["jax"]
    for rnd in range(2):
        for r, got in enumerate(port):
            for k in ("a", "b"):
                ulp = np.spacing(np.abs(ref[f"psum{rnd}/{k}"]).max()
                                 + np.abs(ref[f"err{rnd}/{k}"]).max())
                for name in ("err", "psum"):
                    np.testing.assert_allclose(
                        got[f"{name}{rnd}/{k}"], ref[f"{name}{rnd}/{k}"][r],
                        rtol=0, atol=4 * ulp, err_msg=f"{name}{rnd}/{k}")


def test_train_cli_under_torchrun(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--arch", ARCH, "--smoke", "--device", "cpu", "--mesh-model", "2",
         "--steps", "2", "--batch", "2", "--seq", "16", "--log-every", "1"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
        env=dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-4000:]
    events = [json.loads(line) for line in out.stdout.splitlines()
              if line.startswith("{")]
    steps = [e for e in events if e["kind"] == "step"]
    summary = [e for e in events if e["kind"] == "train_summary"]
    assert len(steps) == 2 and len(summary) == 1, out.stdout
    assert all(np.isfinite(e["loss"]) and e["skips"] == 0 for e in steps)
    assert summary[0]["mesh"] == {"data": 1, "model": 2}


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_main(*sys.argv[2:])
    else:                                   # RANK WORLD STORE args...
        sys.exit(tmesh.run_cpu_rank(sys.argv[1:], _port_main))
