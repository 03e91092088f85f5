"""The port's gating, dispatch plan and decode MoE layer against the JAX
package's, on the same numpy inputs and shared params.

Tolerances: gate weights and losses within 1e-6 (the two frameworks' f32
softmax and exp may differ in the last bits); the MoE layer output and its
aux / z losses within 1e-5 at f32 (sums over k and the expert products run
in another order).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.compat import set_mesh
from repro.configs.base import LSHConfig, MoEConfig
from repro.core import routing as jrouting
from repro.core.gating import top_k_gating as j_top_k_gating
from repro.core.lsh_moe import lsh_moe_apply as j_lsh_moe_apply
from repro.core.lsh_moe import lsh_moe_init as j_lsh_moe_init
from repro_torch.configs import base as tbase
from repro_torch.convert import tensor_from_numpy
from repro_torch.core import routing
from repro_torch.core.gating import gating_losses, top_k_gating
from repro_torch.core.lsh_moe import lsh_moe_apply
from repro_torch.core.moe import moe_dense_dispatch
from repro_torch.launch.mesh import Mesh

JAX_BACKENDS = ("reference", "pallas_interpret")
CPU = torch.device("cpu")


def _placement(e, seed=0):
    return np.random.default_rng(seed).permutation(e).astype(np.int32)


def _gate_inputs(seed, t=24, h=16, e=8, tie=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, h)).astype(np.float32)
    w = rng.standard_normal((h, e)).astype(np.float32)
    if tie:
        w[:, 5] = w[:, 2]          # experts 2 and 5 score exactly equal
    return x, w


@pytest.mark.parametrize("tie", [False, True])
def test_top_k_gating_matches_jax(tie):
    x, w = _gate_inputs(0, tie=tie)
    place = _placement(8)
    want = j_top_k_gating(jnp.asarray(x), jnp.asarray(w), 3,
                          jnp.asarray(place))
    tplace = torch.from_numpy(place)
    got = top_k_gating(torch.from_numpy(x), torch.from_numpy(w), 3, tplace)
    np.testing.assert_array_equal(got.expert_ids.numpy(),
                                  np.asarray(want.expert_ids))
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(want.weights),
                               atol=1e-6)
    losses = gating_losses(got, tplace)
    np.testing.assert_allclose(float(losses.aux_loss), float(want.aux_loss),
                               atol=1e-6)
    np.testing.assert_allclose(float(losses.z_loss), float(want.z_loss),
                               rtol=1e-6)
    np.testing.assert_array_equal(losses.load.numpy(), np.asarray(want.load))


def test_top_k_gating_tie_takes_lower_index():
    """With two experts tied for first, the lower index comes first, as
    jax.lax.top_k orders them."""
    x = np.ones((4, 2), np.float32)
    w = np.zeros((2, 6), np.float32)
    w[:, 1] = w[:, 4] = 1.0
    got = top_k_gating(torch.from_numpy(x), torch.from_numpy(w), 2)
    want = j_top_k_gating(jnp.asarray(x), jnp.asarray(w), 2)
    np.testing.assert_array_equal(np.asarray(want.expert_ids), [[1, 4]] * 4)
    np.testing.assert_array_equal(got.expert_ids.numpy(), [[1, 4]] * 4)


@pytest.mark.parametrize("backend", JAX_BACKENDS)
def test_build_dispatch_plan_matches_jax(backend):
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 6, size=(40, 2)).astype(np.int32)
    ids[3, 1] = 6                  # an out-of-range id
    w = rng.uniform(size=(40, 2)).astype(np.float32)
    want = jrouting.build_dispatch_plan(jnp.asarray(ids), jnp.asarray(w), 6,
                                        8, backend=backend)
    got = routing.build_dispatch_plan(torch.from_numpy(ids),
                                      torch.from_numpy(w), 6, 8)
    for name in ("expert_ids", "weights", "flat_ids", "positions", "keep",
                 "counts"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert (got.num_experts, got.capacity, got.top_k) == (6, 8, 2)
    assert not bool(got.keep.all())     # drops to capacity happened
    np.testing.assert_allclose(float(got.drop_fraction()),
                               float(want.drop_fraction()), atol=1e-7)


def _moe_cfgs(backend):
    jcfg = MoEConfig(num_experts=6, top_k=2, expert_ffn_dim=32,
                     capacity_factor=2.0, kernel_backend=backend,
                     lsh=LSHConfig(enabled=True, num_hashes=3,
                                   rotation_dim=16, compression_rate=0.5))
    tcfg = tbase.MoEConfig(**{
        k: v for k, v in dataclasses.asdict(jcfg).items()
        if k not in ("lsh", "comm", "obs")})
    return jcfg, tcfg


@pytest.mark.parametrize("backend", JAX_BACKENDS)
def test_lsh_moe_decode_matches_jax(mesh, backend):
    jcfg, tcfg = _moe_cfgs(backend)
    params = j_lsh_moe_init(jax.random.PRNGKey(0), 16, jcfg, mesh,
                            mlp_act="swiglu", dtype=jnp.float32)
    params["placement"] = jnp.asarray(_placement(6, seed=3))
    x = np.random.default_rng(2).standard_normal((2, 3, 16)).astype(
        np.float32)
    with set_mesh(mesh):
        y, stats = jax.jit(lambda p, x: j_lsh_moe_apply(
            p, x, jcfg, mesh, mlp_act="swiglu", mode="decode"))(
                params, jnp.asarray(x))
    tparams = {k: tensor_from_numpy(v, CPU) for k, v in params.items()}
    tx = torch.from_numpy(x)
    ty = lsh_moe_apply(tparams, tx, tcfg, mlp_act="swiglu", mode="decode")
    assert ty.shape == (2, 3, 16) and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), atol=1e-5)
    # The decode layer leaves its stats to gating_losses on the same gate.
    gate = top_k_gating(tx.reshape(6, 16), tparams["router_w"], tcfg.top_k,
                        tparams["placement"])
    tstats = gating_losses(gate, tparams["placement"])
    for k in ("aux_loss", "z_loss"):
        np.testing.assert_allclose(float(getattr(tstats, k)), float(stats[k]),
                                   atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(tstats.load.numpy(),
                                  np.asarray(stats["expert_load"]))


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_lsh_moe_train_modes_int8_wire_match_jax(mesh, mode):
    """The train / prefill path with LSH on and the int8 wire (the fused
    precoded dispatch and decode + decompress): output, aux / z losses
    within 1e-5 and equal load, as the bf16 wire's layer."""
    jcfg, _ = _moe_cfgs("reference")
    jcfg = dataclasses.replace(jcfg, lsh=dataclasses.replace(
        jcfg.lsh, wire_format="int8"))
    tcfg = tbase.MoEConfig(**{
        k: v for k, v in dataclasses.asdict(jcfg).items()
        if k not in ("lsh", "comm", "obs")},
        lsh=tbase.LSHConfig(**dataclasses.asdict(jcfg.lsh)))
    params = j_lsh_moe_init(jax.random.PRNGKey(0), 16, jcfg, mesh,
                            mlp_act="swiglu", dtype=jnp.float32)
    params["placement"] = jnp.asarray(_placement(6, seed=3))
    x = np.random.default_rng(4).standard_normal((2, 12, 16)).astype(
        np.float32)
    with set_mesh(mesh):
        y, stats = jax.jit(lambda p, x: j_lsh_moe_apply(
            p, x, jcfg, mesh, mlp_act="swiglu", mode=mode))(
                params, jnp.asarray(x))
    tparams = {k: tensor_from_numpy(v, CPU) for k, v in params.items()}
    ty, tstats = lsh_moe_apply(tparams, torch.from_numpy(x), tcfg,
                               mlp_act="swiglu", mode=mode)
    assert ty.shape == (2, 12, 16) and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), atol=1e-5)
    for k in ("aux_loss", "z_loss"):
        np.testing.assert_allclose(float(tstats[k]), float(stats[k]),
                                   atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(tstats["expert_load"].numpy(),
                                  np.asarray(stats["expert_load"]))


def test_moe_dense_dispatch_is_one_card_only(monkeypatch):
    """The one-card refusal is gone: over a model axis of two ranks the
    decode layer takes the planned exchange (held against JAX's on four
    CPU ranks in test_torch_distributed.py and test_torch_dist_comm.py).
    With ``a2a_impl="pipelined"`` it plans the pipelined transport (2
    chunks of the capacity of 8) and hands its exchange to
    ``pipelined_moe_exchange`` (here a stand-in that runs the experts,
    since this mesh has no process groups)."""
    from repro_torch.comm import planner as tplanner
    _, tcfg = _moe_cfgs("reference")
    tcfg = dataclasses.replace(tcfg, comm=tbase.CommConfig(
        a2a_impl="pipelined", overlap_chunks=2))
    calls = []

    def exchange(send, compute_fn, group, chunks, transfer=None):
        calls.append((tuple(send.shape), group, chunks, transfer))
        return compute_fn(send)
    monkeypatch.setattr(tplanner, "pipelined_moe_exchange", exchange)
    params = {"w_up": torch.zeros(3, 4, 8), "w_gate": torch.zeros(3, 4, 8),
              "w_down": torch.zeros(3, 8, 4),
              "router_w": torch.zeros(4, 6),
              "placement": torch.arange(6, dtype=torch.int32)}
    y = moe_dense_dispatch(torch.zeros(1, 1, 4), params, tcfg,
                           mlp_act="swiglu", mesh=Mesh((1, 2)))
    assert y.shape == (1, 1, 4)
    assert calls == [((2, 3, 8, 4), None, 2, None)]
    plan = tplanner.last_plan("model")
    assert (plan.algorithm, plan.chunks) == ("pipelined", 2)
