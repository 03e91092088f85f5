"""A smoke config on a (data, model) mesh: the port on gloo ranks against
the JAX package on forced host devices, from the same numpy params and
batch, and against the port's own mesh-free path.

The test process writes each case's params (seeded numpy values in the
tree of JAX's ``init_params``, from ``jax.eval_shape``: drawing them
eagerly takes seconds a config) and its batch; then, at once, a JAX
subprocess computes ``jax_case`` for every case and a spawn of gloo ranks
``port_case``.  A case:

- the gradient half of a train step (``make_accum_grad_fn``) on the mesh:
  the loss and every gradient leaf (the port's gathered whole);
- ``DECODE_STEPS`` teacher-forced decode steps on the state that JAX's
  ``decode_state_specs`` lays out (JAX: ``decode_step`` jitted with
  ``in_shardings`` from ``param_specs`` and ``decode_state_specs``, as
  ``repro/launch/dryrun.py`` lowers it; the port:
  ``init_decode_state(mesh=)``): the logits, and each state leaf's
  shape on the rank (JAX: its shard shape); the port's mesh-free decode
  on the same params beside them.

``background`` starts a file's JAX subprocess and gloo spawns with its
first test.  Used by tests/test_torch_xlstm.py and
tests/test_torch_encdec.py.
"""
import concurrent.futures
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "src"

BATCH, SEQ, DECODE_STEPS, DECODE_LEN = 2, 16, 4, 8


def case_cfg(registry, arch: str, overrides: dict):
    """The smoke config of ``arch`` in f32 with tensor parallelism on
    (``dp_only`` off) and ``overrides``."""
    return registry.get_smoke_config(arch).replace(
        dtype="float32", dp_only=False, **overrides)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}{i}/").items()}
    if tree is None:
        return {}
    if hasattr(tree, "detach"):
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


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def write_inputs(tmp: Path, name: str, arch: str, overrides: dict) -> None:
    """``params_<name>.npz`` (JAX's tree: matrices normal / sqrt(fan-in),
    norm scales 1 + normal 0.1, biases normal 0.1) and
    ``batch_<name>.npz`` (tokens and labels of the synthetic dataset,
    frames [B, S, H] normal for an encoder-decoder config)."""
    import jax

    from repro.configs import registry as jreg
    from repro.data.synthetic import SyntheticLMDataset
    from repro.launch.mesh import make_host_mesh
    from repro.models import model as jmodel
    cfg = case_cfg(jreg, arch, overrides)
    shapes = jax.eval_shape(lambda k: jmodel.init_params(
        k, cfg, make_host_mesh(1, 1, 1)), jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)

    def one(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        r = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "scale":
            return 1.0 + 0.1 * r
        if name.startswith("b_"):
            return 0.1 * r
        return r / np.float32(np.sqrt(leaf.shape[-2]))
    np.savez(tmp / f"params_{name}.npz",
             **_flat(jax.tree_util.tree_map_with_path(one, shapes)))
    batch = dict(SyntheticLMDataset(cfg.vocab_size, SEQ, BATCH).batch_at(0))
    if cfg.encoder_decoder:
        batch["frames"] = rng.standard_normal(
            (BATCH, SEQ, cfg.d_model)).astype(np.float32)
    np.savez(tmp / f"batch_{name}.npz", **batch)


def jax_case(tmp: Path, name: str, arch: str, mesh_shape, overrides: dict):
    """The JAX side of a case on ``mesh_shape`` (data, model) ->
    ``jax_<name>.npz``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.compat import set_mesh
    from repro.configs import registry as jreg
    from repro.launch.mesh import make_host_mesh
    from repro.models import model as jmodel
    from repro.runtime import params as jparams
    from repro.runtime import sharding as jsharding
    from repro.runtime import step as jstep
    cfg = case_cfg(jreg, arch, overrides)
    mesh = make_host_mesh(mesh_shape[0], 1, mesh_shape[1])
    params = jax.tree.map(jnp.asarray, _unflat(dict(np.load(
        tmp / f"params_{name}.npz"))))
    batch = {k: jnp.asarray(v) for k, v in np.load(
        tmp / f"batch_{name}.npz").items()}
    out = {}
    with set_mesh(mesh):
        loss, _, grads = jax.jit(jstep.make_accum_grad_fn(cfg, mesh))(
            params, batch)
        out["loss"] = np.asarray(loss)
        out.update({f"g/{k}": v for k, v in _flat(
            jax.tree.map(np.asarray, grads)).items()})

        def shard(specs):
            return jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                                is_leaf=lambda x: isinstance(x, P))
        p_sh = shard(jparams.param_specs(params, mesh))
        st_sh = shard(jparams.decode_state_specs(cfg, BATCH, mesh,
                                                 max_len=DECODE_LEN))
        tok_sh = NamedSharding(mesh, jparams._divisible(jsharding.resolve(
            mesh, "batch", None), (BATCH, 1), mesh))
        state = jax.device_put(jmodel.init_decode_state(
            cfg, BATCH, DECODE_LEN, mesh), st_sh)
        # each entry's leaves, stacked over the super-blocks, as
        # decode_state_specs places them: the shard's shape without that
        # dimension
        out["shard_shapes"] = json.dumps([
            {k: list(v.sharding.shard_shape(v.shape)[1:])
             for k, v in e.items()} for e in state["entries"]])
        step = jax.jit(lambda p, s, t: jmodel.decode_step(p, cfg, mesh, s,
                                                          t),
                       in_shardings=(p_sh, st_sh, tok_sh))
        logits = []
        for i in range(DECODE_STEPS):
            # (the step's output state may lie otherwise: placed again)
            lg, state = step(params, jax.device_put(state, st_sh),
                             jax.device_put(batch["tokens"][:, i:i + 1],
                                            tok_sh))
            logits.append(np.asarray(lg))
    out["logits"] = np.concatenate(logits, 1)
    np.savez(tmp / f"jax_{name}.npz", **out)


def port_case(tmp: Path, name: str, arch: str, mesh_shape, overrides: dict,
              rank: int) -> None:
    """The port's side of a case on this gloo rank of a ``mesh_shape``
    mesh -> ``port_<name>.npz`` (rank 0)."""
    import torch

    from repro_torch.configs import registry as treg
    from repro_torch.convert import (gather_params, params_from_jax,
                                     shard_params)
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models import model as tmodel
    from repro_torch.optim import adam as tadam
    from repro_torch.runtime import params as tparams
    from repro_torch.runtime import step as tstep
    cpu = torch.device("cpu")
    cfg = case_cfg(treg, arch, overrides)
    mesh = tmesh.make_mesh(*mesh_shape)
    full = params_from_jax(_unflat(dict(np.load(
        tmp / f"params_{name}.npz"))), device=cpu)
    specs = tparams.model_specs(cfg, mesh)
    local = shard_params(full, mesh, specs)
    batch = {k: torch.from_numpy(v) for k, v in np.load(
        tmp / f"batch_{name}.npz").items()}
    out = {}
    loss, _, grads = tstep.make_accum_grad_fn(cfg, mesh=mesh)(local, batch)
    it = iter([torch.zeros(0) if g is None else g for g in grads])
    gt = gather_params(tadam._map(lambda p: next(it), local), mesh, specs)
    out["loss"] = loss.detach()
    out.update({f"g/{k}": v for k, v in _flat(gt).items()})
    for tag, m, p in (("mesh", mesh, local), ("free", None, full)):
        state = tmodel.init_decode_state(cfg, BATCH, DECODE_LEN,
                                         device=cpu, mesh=m)
        r0, n = state["layout"]["rows"] if m is not None else (0, BATCH)
        logits = []
        for i in range(DECODE_STEPS):
            lg, state = tmodel.decode_step(
                p, cfg, state, batch["tokens"][r0:r0 + n, i:i + 1].long(),
                mesh=m)
            logits.append(lg)
        out[f"logits/{tag}"] = torch.cat(logits, 1)
        if m is not None:
            out["layout"] = json.dumps({
                k: v for k, v in state["layout"].items()
                if k not in ("specs", "shapes")})
            out["local_shapes"] = json.dumps([
                {k: list(t.shape) for k, t in c.items()}
                for c in state["layers"]])
    if rank == 0:
        np.savez(tmp / f"port_{name}.npz", **{
            k: v.numpy() if isinstance(v, torch.Tensor) else v
            for k, v in out.items()})


def check_train(jax_out: dict, port_out: dict, loss_tol: float,
                grad_tol: float) -> str:
    """The port's loss and every gradient leaf against JAX's (JAX's tree
    through ``params_from_jax``)."""
    from repro_torch.convert import params_from_jax
    want = _flat(params_from_jax(_unflat({
        k[2:]: v for k, v in jax_out.items() if k.startswith("g/")}),
        device="cpu"))
    got = {k[2:]: v for k, v in port_out.items() if k.startswith("g/")}
    assert set(got) == set(want) and len(want) > 10
    worst = max(rel_l2(got[k], want[k]) for k in want)
    loss_rel = abs(float(port_out["loss"]) - float(jax_out["loss"])) \
        / abs(float(jax_out["loss"]))
    assert loss_rel <= loss_tol and worst <= grad_tol, (loss_rel, worst)
    return f"loss rel {loss_rel:.3g}, worst gradient rel L2 {worst:.3g}"


def check_decode(cfg, jax_out: dict, port_out: dict, rtol: float) -> str:
    """The logits against JAX's and the port's mesh-free decode; every
    state leaf's shape on the rank against JAX's shard shape."""
    mesh, free = port_out["logits/mesh"], port_out["logits/free"]
    to_jax, to_free = rel_l2(mesh, jax_out["logits"]), rel_l2(mesh, free)
    assert mesh.shape == jax_out["logits"].shape
    assert to_jax <= rtol and to_free <= rtol, (to_jax, to_free)
    want = json.loads(str(jax_out["shard_shapes"]))
    got = json.loads(str(port_out["local_shapes"]))
    assert len(got) == len(cfg.layout) * cfg.num_super_blocks
    for i, leaves in enumerate(got):
        assert leaves == want[i % len(cfg.layout)], (i, leaves, want)
    return (f"decode logits rel L2 {to_jax:.3g} to JAX, {to_free:.3g} to "
            f"mesh-free")


class _Runs:
    """A JAX subprocess (``python <script> jax TMP``, stderr to a file)
    and spawns of gloo ranks (``python <script> RANK WORLD STORE TMP``),
    one a world, all running at once."""

    def __init__(self, script: Path, tmp: Path, devices: int, worlds,
                 xla_flags: str):
        from repro_torch.launch import mesh as tmesh
        self.tmp = tmp
        env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
                   XLA_FLAGS=f"--xla_force_host_platform_device_count="
                             f"{devices} {xla_flags}".strip())
        self.err = open(tmp / "jax.err", "w+")
        self.proc = subprocess.Popen(
            [sys.executable, str(script), "jax", str(tmp)], env=env,
            stdout=subprocess.DEVNULL, stderr=self.err, text=True)
        port_env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
        self.pool = concurrent.futures.ThreadPoolExecutor(len(worlds))
        self.ranks = [self.pool.submit(
            tmesh.spawn_cpu_ranks, str(script), w, [str(tmp)],
            store=str(tmp / f"store{w}"), env=port_env, timeout_s=900)
            for w in worlds]

    def wait(self) -> Path:
        try:
            for r in self.ranks:
                r.result()
        finally:
            self.proc.wait(timeout=900)
        self.err.seek(0)
        assert self.proc.returncode == 0, self.err.read()[-4000:]
        return self.tmp

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.pool.shutdown(wait=True)
        self.err.close()


def background(request, tmp_path_factory, script: Path, devices: int,
               worlds, prepare, xla_flags: str = ""):
    """The body of a module-scoped autouse fixture: where a test of the
    session in this module reads ``refs``, ``prepare(tmp)`` writes the
    inputs, then the JAX subprocess on ``devices`` forced host devices
    and the gloo spawns of ``worlds`` start at once; yields the runs
    (``refs`` calls their ``wait``), or None."""
    if not any("refs" in item.fixturenames for item in request.session.items
               if item.module is request.module):
        yield None
        return
    tmp = tmp_path_factory.mktemp(Path(script).stem)
    prepare(tmp)
    runs = _Runs(script, tmp, devices, worlds, xla_flags)
    try:
        yield runs
    finally:
        runs.close()
