"""The port's microbatched train step and prefill against the JAX
package's, on the granite-moe-3b-a800m smoke config in f32 with the f32
wire (``LSHConfig.wire_dtype``), the setting whose bounds
test_torch_train.py states for one step:

- ``make_accum_grad_fn(microbatch=1)`` at batch 2 (two microbatches)
  against JAX's ``make_accum_grad_fn(cfg, mesh, microbatch=1)`` (its
  ``lax.scan``): the accumulated loss within 1e-5 relative, each
  gradient leaf within 1e-4 relative L2, the params after
  ``apply_gradients`` within 1e-5 relative L2, and the LSH slots of every
  MoE layer of every microbatch equal;
- the same over a (data, model) = (2, 2) mesh of four gloo ranks,
  microbatch 2 at batch 4, against JAX on four forced host devices: the
  accumulated loss and the clip norm within 1e-5 relative, the params
  after the update within 1e-5 relative L2 (test_torch_dist_train.py's
  f32 bounds), and ``prefill`` over the mesh (the last logits gathered
  on every rank) within the bound below;
- ``prefill``'s last-position logits against ``repro.models.model.prefill``
  within 1e-5 relative and absolute, the MoE layer outputs' bound of
  test_torch_train.py (logits near 1 in magnitude; measured 2.7e-6 worst
  absolute: the two frameworks sum matrix products in another order),
  and its position.
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

from repro_torch.launch import mesh as tmesh  # noqa: E402

ARCH = "granite-moe-3b-a800m"
OPT = dict(lr=1e-3, warmup_steps=10, total_steps=100)
MESH_BATCH, MESH_SEQ, MESH_MICRO = 4, 16, 2


def _cfg(registry):
    cfg = registry.get_smoke_config(ARCH).replace(dtype="float32")
    return cfg.replace(moe=dataclasses.replace(cfg.moe, lsh=dataclasses.replace(
        cfg.moe.lsh, wire_dtype="float32")))


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


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


# --------------------------------------------------------- mesh-free --

@pytest.fixture()
def slot_spies(monkeypatch):
    """Every MoE layer call's LSH slots, in both packages."""
    import jax

    from repro.core import clustering as jclust
    from repro_torch.core import clustering as tclust
    rec = {"jax": [], "torch": []}
    j_orig, t_orig = jclust.assign_slots, tclust.assign_slots

    def j_spy(tokens, rotations, num_slots, hash_type, backend=None):
        out = j_orig(tokens, rotations, num_slots, hash_type, backend)
        jax.debug.callback(lambda s: rec["jax"].append(np.asarray(s)), out)
        return out

    def t_spy(tokens, rotations, num_slots, hash_type):
        out = t_orig(tokens, rotations, num_slots, hash_type)
        rec["torch"].append(out.numpy().copy())
        return out

    monkeypatch.setattr(jclust, "assign_slots", j_spy)
    monkeypatch.setattr(tclust, "assign_slots", t_spy)
    return rec


def test_microbatch_train_step_matches_jax(mesh, slot_spies):
    import jax

    from repro.compat import set_mesh
    from repro.configs import base as jbase
    from repro.configs import registry as jreg
    from repro.data.synthetic import SyntheticLMDataset
    from repro.models import model as jmodel
    from repro.optim import adam as jadam
    from repro.runtime import step as jstep
    from repro_torch.configs import base as tbase
    from repro_torch.configs import registry as treg
    from repro_torch.convert import params_from_jax
    from repro_torch.optim import adam as tadam
    from repro_torch.runtime import step as tstep

    jcfg, tcfg = _cfg(jreg), _cfg(treg)
    jopt, topt = jbase.OptimizerConfig(**OPT), tbase.OptimizerConfig(**OPT)
    batch = SyntheticLMDataset(jcfg.vocab_size, 16, 2).batch_at(0)
    with set_mesh(mesh):
        params = jmodel.init_params(jax.random.PRNGKey(0), jcfg, mesh)
        jl, jm, jg = jax.jit(jstep.make_accum_grad_fn(
            jcfg, mesh, microbatch=1))(params, batch)
        state = jstep.TrainState(params, jadam.adamw_init(params, jopt))
        state, _ = jax.jit(lambda st, l, m, g: jstep.apply_gradients(
            st, jopt, l, m, g))(state, jl, jm, jg)
        jg = jax.tree.map(np.asarray, jg)
        for blk in jg["blocks"]:
            blk.get("ffn", {}).pop("placement", None)     # float0
        jfinal = jax.tree.map(np.asarray, state.params)
    n_jax_slots = len(slot_spies["jax"])
    tparams = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    tb = tstep.batch_to_device(batch, torch.device("cpu"))
    tl, tm, tg = tstep.make_accum_grad_fn(tcfg, microbatch=1)(tparams, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    want = tadam.leaves(params_from_jax(jg, device="cpu"))
    trainable = [g for g in tg if g is not None]
    assert len(want) == len(trainable)
    assert all(g.dtype == torch.float32 for g in trainable)
    worst = max(_rel_l2(g.numpy(), w.numpy()) for g, w in
                zip(trainable, want) if w.any())
    tstate = tstep.TrainState(tparams, tadam.adamw_init(tparams, topt))
    tstate, m = tstep.apply_gradients(tstate, topt, tl, tm, tg)
    after = tadam.leaves(params_from_jax(jfinal, device="cpu"))
    worst_p = max(_rel_l2(p.detach().numpy(), w.numpy())
                  for p, w in zip(tadam.leaves(tstate.params), after)
                  if p.is_floating_point())
    # slots: the distinct assignments of each side (JAX records each
    # rematerialised forward again) are the same 2 layers x 2 microbatches
    def distinct(recs):
        return {r.tobytes() for r in recs}
    assert n_jax_slots >= 4
    assert distinct(slot_spies["torch"]) == distinct(slot_spies["jax"])
    assert len(distinct(slot_spies["torch"])) == 4
    print(f"microbatch 1 x 2: loss port {float(tl)} jax {float(jl)}; worst "
          f"gradient rel L2 {worst:.3g}; worst param rel L2 {worst_p:.3g}")
    assert worst < 1e-4 and worst_p < 1e-5
    assert int(m["grad_skips"]) == 0


def test_prefill_matches_jax(mesh):
    import jax

    from repro.compat import set_mesh
    from repro.configs import registry as jreg
    from repro.models import model as jmodel
    from repro_torch.configs import registry as treg
    from repro_torch.convert import params_from_jax
    from repro_torch.models import model as tmodel
    from repro_torch.runtime import step as tstep

    jcfg, tcfg = _cfg(jreg), _cfg(treg)
    tokens = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (3, 24)).astype(np.int32)
    with set_mesh(mesh):
        params = jmodel.init_params(jax.random.PRNGKey(1), jcfg, mesh)
        jl, jst = jax.jit(lambda p, b: jmodel.prefill(p, jcfg, mesh, b))(
            params, {"tokens": tokens})
    tparams = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    tl, tst = tstep.make_prefill_step(tcfg)(
        tparams, {"tokens": torch.from_numpy(tokens)})
    assert tl.shape == (3, 1, jcfg.vocab_size) and tl.dtype == torch.float32
    assert tst["position"] == int(jst["position"]) == 24
    assert not tl.requires_grad
    diff = np.abs(tl.numpy() - np.asarray(jl)).max()
    print(f"prefill last logits: worst absolute difference {diff:.3g}")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    full, _ = tmodel.forward(tparams, tcfg, torch.from_numpy(tokens),
                             moe_mode="prefill")
    assert torch.equal(full[:, -1:], tl)


# --------------------------------------------------------- the mesh --

def _jax_main(inp_path, out_path):
    import jax
    import jax.numpy as jnp

    from repro.compat import set_mesh
    from repro.configs import base as jbase
    from repro.configs import registry as jreg
    from repro.data.synthetic import SyntheticLMDataset
    from repro.launch.mesh import make_host_mesh
    from repro.models import model as jmodel
    from repro.optim import adam as jadam
    from repro.runtime import step as jstep

    params = jax.tree.map(jnp.asarray, _unflat(dict(np.load(inp_path))))
    mesh = make_host_mesh(2, 1, 2)
    cfg, opt = _cfg(jreg), jbase.OptimizerConfig(**OPT)
    batch = SyntheticLMDataset(515, MESH_SEQ, MESH_BATCH).batch_at(0)
    with set_mesh(mesh):
        pre, _ = jax.jit(lambda p, b: jmodel.prefill(p, cfg, mesh, b))(
            params, {"tokens": batch["tokens"]})
        l, m, g = jax.jit(jstep.make_accum_grad_fn(
            cfg, mesh, microbatch=MESH_MICRO))(params, batch)
        state = jstep.TrainState(params, jadam.adamw_init(params, opt))
        state, _ = jax.jit(lambda st, l, m, g: jstep.apply_gradients(
            st, opt, l, m, g))(state, l, m, g)
        out = {"loss": np.asarray(l), "prefill": np.asarray(pre),
               "gn": np.asarray(jadam.global_norm(g))}
    out.update({f"p/{k}": v for k, v in _flat(state.params).items()})
    np.savez(out_path, **out)


def _port_main(rank, world, args):
    inp_path, out_path = args
    from repro_torch.configs import base as tbase
    from repro_torch.configs import registry as treg
    from repro_torch.convert import (gather_params, params_from_jax,
                                     shard_params)
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.optim.adam import adamw_init
    from repro_torch.runtime import step as tstep
    from repro_torch.runtime.params import param_specs

    mesh = tmesh.make_mesh(2, 2)
    cpu = torch.device("cpu")
    whole = params_from_jax(_unflat(dict(np.load(inp_path))), device=cpu)
    specs = param_specs(whole, mesh)
    params = shard_params(whole, mesh, specs)
    opt = tbase.OptimizerConfig(**OPT)
    state = tstep.TrainState(params, adamw_init(params, opt))
    batch = tstep.batch_to_device(
        SyntheticLMDataset(515, MESH_SEQ, MESH_BATCH).batch_at(0), cpu)
    pre, st = tstep.make_prefill_step(_cfg(treg), mesh)(
        params, {"tokens": batch["tokens"]})
    assert st["position"] == MESH_SEQ and pre.shape[:2] == (MESH_BATCH, 1)
    accum = tstep.make_accum_grad_fn(_cfg(treg), microbatch=MESH_MICRO,
                                     mesh=mesh)
    loss, m, grads = accum(state.params, batch)
    state, m = tstep.apply_gradients(state, opt, loss, m, grads, mesh=mesh,
                                     specs=specs)
    full = gather_params(state.params, mesh, specs)
    if rank == 0:
        np.savez(out_path, loss=loss.numpy(), prefill=pre.numpy(),
                 gn=m["grad_norm"].numpy(),
                 skips=m["grad_skips"].numpy(),
                 **{f"p/{k}": v for k, v in _flat(full).items()})
    return 0


def test_mesh_microbatch_train_step_matches_jax(tmp_path):
    import jax

    from repro.configs import registry as jreg
    from repro.launch.mesh import make_host_mesh
    from repro.models import model as jmodel
    from repro_torch.convert import params_from_jax

    params = jmodel.init_params(jax.random.PRNGKey(0), _cfg(jreg),
                                make_host_mesh(1, 1, 1))
    inp = tmp_path / "params.npz"
    np.savez(inp, **_flat(jax.tree.map(np.asarray, params)))
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jax_proc = subprocess.Popen(
        [sys.executable, str(HERE), "jax", str(inp), str(tmp_path / "j.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        tmesh.spawn_cpu_ranks(
            str(HERE), 4, [str(inp), str(tmp_path / "t.npz")],
            store=str(tmp_path / "store"),
            env=dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1"),
            timeout_s=300)
    finally:
        _, err = jax_proc.communicate(timeout=600)
    assert jax_proc.returncode == 0, err[-4000:]
    ref, got = dict(np.load(tmp_path / "j.npz")), dict(np.load(
        tmp_path / "t.npz"))
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["gn"], ref["gn"], rtol=1e-5)
    np.testing.assert_allclose(got["prefill"], ref["prefill"], rtol=1e-5,
                               atol=1e-5)
    assert int(got["skips"]) == 0
    want = _flat(params_from_jax(_unflat(
        {k[2:]: v for k, v in ref.items() if k.startswith("p/")}),
        device="cpu"))
    mine = {k[2:]: v for k, v in got.items() if k.startswith("p/")}
    assert set(want) == set(mine)
    worst = 0.0
    for k, w in want.items():
        if np.issubdtype(w.dtype, np.floating):
            worst = max(worst, _rel_l2(mine[k], w))
        else:
            np.testing.assert_array_equal(mine[k], w, err_msg=k)
    print(f"(2, 2) microbatch {MESH_MICRO}: loss port {float(got['loss'])} "
          f"jax {float(ref['loss'])}; worst param rel L2 {worst:.3g}")
    assert worst < 1e-5


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_main(*sys.argv[2:])
    else:                                   # RANK WORLD STORE args...
        sys.exit(tmesh.run_cpu_rank(sys.argv[1:], _port_main))
