"""The port's training path against the JAX package's, on the CPU: the
train / prefill MoE layer, one train step of the granite-moe-3b-a800m smoke
config, five steps of the quickstart example's config, AdamW, the
schedule, the non-finite skip, the synthetic data and the CLI.

Inputs come from numpy with fixed seeds; params are made by JAX and
carried over with ``params_from_jax`` (gradients too, with the ``float0``
leaf of the integer ``placement`` dropped first).  Tolerances, at f32:
MoE layer output and losses within 1e-5; the train step's loss within 1e-5
relative, each gradient leaf within 1e-4 relative L2, the params after
AdamW within 1e-5 relative L2; the quickstart loss trajectory within 1e-4
relative (the two frameworks sum matrix products in another order).  The
last three hold with an f32 wire; the bf16 wire's roundings amplify the
f32 differences, and the tests that run it state by how much and why.
Every MoE layer's LSH slots must be equal to JAX's; the smallest near-tie
margin of the hash seen is printed.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # parallel test workers share the cores
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.compat import set_mesh
from repro.configs import base as jbase
from repro.configs.registry import get_smoke_config as j_smoke_config
from repro.core import clustering as jclust
from repro.core.lsh_moe import lsh_moe_apply as j_lsh_moe_apply
from repro.core.lsh_moe import lsh_moe_init as j_lsh_moe_init
from repro.data.synthetic import SyntheticLMDataset as JData
from repro.models import model as jmodel
from repro.optim import adam as jadam
from repro.optim.schedule import warmup_cosine as j_warmup_cosine
from repro.runtime import step as jstep
from repro_torch.configs import base as tbase
from repro_torch.configs.registry import get_smoke_config
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.core import clustering as tclust
from repro_torch.core.lsh_moe import lsh_moe_apply
from repro_torch.data.synthetic import SyntheticLMDataset
from repro_torch.examples import quickstart
from repro_torch.kernels.lsh_hash import near_tie_margin
from repro_torch.launch import train as train_cli
from repro_torch.models import model as tmodel
from repro_torch.optim import adam as tadam
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.runtime import step as tstep

ARCH = "granite-moe-3b-a800m"
CPU = torch.device("cpu")


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


@pytest.fixture()
def slot_spies(monkeypatch):
    """Record the LSH slots of every MoE layer call in both packages (JAX
    through a debug callback, which fires in the forward and again in
    each rematerialised forward), and the port's hash inputs."""
    rec = {"jax": [], "torch": [], "inputs": []}
    j_orig, t_orig = jclust.assign_slots, tclust.assign_slots

    def j_spy(tokens, rotations, num_slots, hash_type, backend=None):
        out = j_orig(tokens, rotations, num_slots, hash_type, backend)
        jax.debug.callback(lambda s: rec["jax"].append(np.asarray(s)), out)
        return out

    def t_spy(tokens, rotations, num_slots, hash_type):
        out = t_orig(tokens, rotations, num_slots, hash_type)
        rec["torch"].append(out.numpy().copy())
        rec["inputs"].append((tokens.detach().reshape(-1, tokens.shape[-1])
                              .clone(), rotations.detach().clone()))
        return out

    monkeypatch.setattr(jclust, "assign_slots", j_spy)
    monkeypatch.setattr(tclust, "assign_slots", t_spy)
    return rec


def _check_slots(rec, n_layers):
    """The first n_layers records of each side are the forward pass, in
    layer order; every later record (recompute) repeats one of them."""
    assert len(rec["torch"]) >= n_layers and len(rec["jax"]) >= n_layers
    for t, j in zip(rec["torch"][:n_layers], rec["jax"][:n_layers]):
        np.testing.assert_array_equal(t, j)
    for side in ("torch", "jax"):
        for r in rec[side][n_layers:]:
            assert any(np.array_equal(r, f) for f in rec[side][:n_layers])
    margin = min(float(near_tie_margin(x, rot).min())
                 for x, rot in rec["inputs"][:n_layers])
    print(f"slots equal in {n_layers} MoE layer(s); smallest near-tie "
          f"margin of the hash {margin:.3g}")


# ------------------------------------------------- the train MoE layer --

def _moe_cfgs():
    jcfg = jbase.MoEConfig(num_experts=6, top_k=2, expert_ffn_dim=32,
                           capacity_factor=2.0, kernel_backend="reference",
                           lsh=jbase.LSHConfig(enabled=True, num_hashes=3,
                                               rotation_dim=16,
                                               compression_rate=0.5))
    tcfg = tbase.MoEConfig(**{
        k: v for k, v in dataclasses.asdict(jcfg).items()
        if k not in ("lsh", "comm", "obs")},
        lsh=tbase.LSHConfig(**dataclasses.asdict(jcfg.lsh)))
    return jcfg, tcfg


@pytest.mark.parametrize("use_lsh", [True, False])
@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_lsh_moe_train_matches_jax(mesh, slot_spies, use_lsh, mode):
    """Output, aux / z losses, load, and the gradients of
    sum(y * ct) + aux + z in x, the router and the experts, with a
    non-identity placement."""
    jcfg, tcfg = _moe_cfgs()
    h = 16
    params = j_lsh_moe_init(jax.random.PRNGKey(0), h, jcfg, mesh,
                            mlp_act="swiglu", dtype=jnp.float32)
    params["placement"] = jnp.asarray(
        np.random.default_rng(3).permutation(6).astype(np.int32))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 12, h)).astype(np.float32)
    ct = rng.standard_normal((2, 12, h)).astype(np.float32)
    diff = ("router_w", "w_gate", "w_up", "w_down")

    def j_obj(p, x):
        y, st = j_lsh_moe_apply({**params, **p}, x, jcfg, mesh,
                                mlp_act="swiglu", mode=mode,
                                use_lsh=use_lsh)
        return jnp.sum(y * ct) + st["aux_loss"] + st["z_loss"], (y, st)

    with set_mesh(mesh):
        (_, (y, st)), (gp, gx) = jax.jit(jax.value_and_grad(
            j_obj, argnums=(0, 1), has_aux=True))(
                {k: params[k] for k in diff}, jnp.asarray(x))
    tp = {k: tensor_from_numpy(v, CPU) for k, v in params.items()}
    for k in diff:
        tp[k].requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    ty, tst = lsh_moe_apply(tp, tx, tcfg, mlp_act="swiglu", mode=mode,
                            use_lsh=use_lsh)
    obj = (ty * torch.from_numpy(ct)).sum() + tst["aux_loss"] \
        + tst["z_loss"]
    grads = torch.autograd.grad(obj, [tx] + [tp[k] for k in diff])
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(y), atol=1e-5)
    for k in ("aux_loss", "z_loss"):
        np.testing.assert_allclose(float(tst[k].detach()), float(st[k]),
                                   atol=1e-5)
    np.testing.assert_array_equal(tst["expert_load"].numpy(),
                                  np.asarray(st["expert_load"]))
    for name, g, want in zip(("x",) + diff, grads,
                             [gx] + [gp[k] for k in diff]):
        assert _rel_l2(g.numpy(), want) < 1e-4, name
    if use_lsh:
        _check_slots(slot_spies, 1)
    else:
        assert not slot_spies["torch"] and not slot_spies["jax"]


# ------------------------------------------------------- the train step --

def _train_both(mesh, jcfg, tcfg, opt_kw, *, steps, batch, seq):
    """``steps`` train steps in both packages from JAX-initialised params
    on SyntheticLMDataset batches.  Returns per-step losses (JAX, port)
    and, for one step, the gradients (JAX's, port's) and the params after
    it (port's, JAX's)."""
    jopt = jbase.OptimizerConfig(**opt_kw)
    topt = tbase.OptimizerConfig(**opt_kw)
    ds = JData(jcfg.vocab_size, seq, batch)
    jbatch = [{k: jnp.asarray(v) for k, v in ds.batch_at(s).items()}
              for s in range(steps)]
    with set_mesh(mesh):
        params = jmodel.init_params(jax.random.PRNGKey(0), jcfg, mesh)
        state = jstep.TrainState(params, jadam.adamw_init(params, jopt))
        jgrads = None
        if steps == 1:       # one compile of the model: grads, then AdamW
            loss, metrics, jgrads = jax.jit(jstep.make_accum_grad_fn(
                jcfg, mesh))(params, jbatch[0])
            state, _ = jax.jit(lambda st, l, m, g: jstep.apply_gradients(
                st, jopt, l, m, g))(state, loss, metrics, jgrads)
            jl = [float(loss)]
            jgrads = _np_tree(jgrads)
            for blk in jgrads["blocks"]:
                blk.get("ffn", {}).pop("placement", None)   # float0
        else:
            step = jax.jit(jstep.make_train_step(jcfg, jopt, mesh))
            jl = []
            for b in jbatch:
                state, m = step(state, b)
                jl.append(float(m["loss"]))
        jfinal = _np_tree(state.params)
    tparams = params_from_jax(_np_tree(params), device="cpu")
    tgrads = None
    if steps == 1:
        train = [p for p in tadam.leaves(tparams) if p.is_floating_point()]
        for p in train:
            p.requires_grad_(True)
        loss, _ = tmodel.loss_fn(tparams, tcfg,
                                 tstep.batch_to_device(ds.batch_at(0), CPU))
        tgrads = torch.autograd.grad(loss, train, allow_unused=True)
    tstate = tstep.TrainState(tparams, tadam.adamw_init(tparams, topt))
    tstep_fn = tstep.make_train_step(tcfg, topt)
    tl = []
    for s in range(steps):
        tstate, m = tstep_fn(tstate, tstep.batch_to_device(ds.batch_at(s),
                                                           CPU))
        tl.append(float(m["loss"]))
        assert int(m["grad_skips"]) == 0
    return jl, tl, jgrads, tgrads, tparams, jfinal


def _wire(cfg, b, wire_dtype, wire_format="bf16"):
    return cfg.replace(moe=dataclasses.replace(cfg.moe, lsh=b.LSHConfig(
        **{**dataclasses.asdict(cfg.moe.lsh), "wire_dtype": wire_dtype,
           "wire_format": wire_format})))


@pytest.mark.parametrize("wire_dtype,grad_tol,param_tol,wire_format", [
    pytest.param("float32", 1e-4, 1e-5, "bf16", id="float32-0.0001-1e-05"),
    pytest.param("bfloat16", 1e-3, 1e-3, "bf16", id="bfloat16-0.001-0.001"),
    pytest.param("bfloat16", 1e-3, 1e-3, "int8", id="int8-0.001-0.001"),
    pytest.param("bfloat16", 1e-3, 1e-3, "fp8", id="fp8-0.001-0.001")])
def test_train_step_matches_jax(mesh, slot_spies, wire_dtype, grad_tol,
                                param_tol, wire_format):
    """One step of the granite smoke config at f32 with LSH on: the loss
    within 1e-5 relative, equal slots in every MoE layer, each gradient
    leaf and each param after AdamW within the stated relative L2.

    With the production bf16 wire (LSHConfig.wire_dtype) the centroids and
    the cotangents of both exchange legs round to bf16 in both packages.
    Where the two frameworks' f32 sums differ in the last bit, a value
    next to a bf16 rounding boundary rounds to the other side, a 2**-8
    relative step: the gradients of the layers below the top MoE layer
    then differ by about 1e-4 relative L2 (measured 1.04e-4) against about
    1e-6 without the rounding, and a first AdamW step, which moves each
    param by about lr * sign(g), turns a flipped tiny gradient into a
    full step.  The f32 wire takes the roundings out and is held to 1e-4
    and 1e-5.  The step is the first of a 10-step warm-up (lr 1e-4), as a
    run's first step is; a full-lr first step moves every param whose tiny
    gradient's sign the two frameworks' sums disagree on by 1e-3.

    The int8 and fp8 wires (LSHConfig.wire_format) send the same bf16
    cotangents back, and quantize centroids and expert outputs that the
    two packages sum in another order: a value within a last f32 bit of a
    rounding midpoint moves by a whole quantum (1/127 or an fp8 step of
    its row's absmax), which the loss hardly sees but the expert weights'
    gradients do.  Measured: loss rel 7.4e-8 and 0, worst gradient rel L2
    7.6e-4 (int8) and 4.1e-4 (fp8), worst param 4.5e-5; held to the bf16
    wire's 1e-3 and 1e-3."""
    jcfg = _wire(j_smoke_config(ARCH).replace(dtype="float32"), jbase,
                 wire_dtype, wire_format)
    tcfg = _wire(get_smoke_config(ARCH).replace(dtype="float32"), tbase,
                 wire_dtype, wire_format)
    jl, tl, jgrads, tgrads, tparams, jfinal = _train_both(
        mesh, jcfg, tcfg, dict(lr=1e-3, warmup_steps=10, total_steps=100),
        steps=1, batch=2, seq=16)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _check_slots(slot_spies, jcfg.num_layers)
    # gradients, leaf for leaf (lsh_rot has none: zeros on the JAX side)
    jg = tadam.leaves(params_from_jax(jgrads, device="cpu"))
    train = [p for p in tadam.leaves(tparams) if p.is_floating_point()]
    assert len(jg) == len(tgrads) == len(train)
    n_zero, worst = 0, 0.0
    for g, want in zip(tgrads, jg):
        if g is None:
            assert not want.any()
            n_zero += 1
            continue
        worst = max(worst, _rel_l2(g.numpy(), want.numpy()))
    assert n_zero == jcfg.num_layers              # one lsh_rot per layer
    after = tadam.leaves(params_from_jax(jfinal, device="cpu"))
    worst_p = 0.0
    for p, want in zip(tadam.leaves(tparams), after):
        if p.is_floating_point():
            worst_p = max(worst_p, _rel_l2(p.detach().numpy(),
                                           want.numpy()))
        else:
            assert torch.equal(p, want)
    print(f"wire {wire_format} ({wire_dtype}): loss rel "
          f"{abs(tl[0] - jl[0]) / abs(jl[0]):.3g}, worst gradient rel L2 "
          f"{worst:.3g}, worst param-after-AdamW rel L2 {worst_p:.3g}")
    assert worst < grad_tol and worst_p < param_tol


def _quickstart_f32(wire_dtype):
    """repro_torch.examples.quickstart's config in f32 with the given
    LSH wire."""
    cfg = quickstart.build_config()
    moe = cfg.moe
    return dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(
        moe, lsh=dataclasses.replace(moe.lsh, wire_dtype=wire_dtype)))


@pytest.mark.parametrize("wire_dtype,rtol", [("float32", 1e-4),
                                             ("bfloat16", 2e-2)])
def test_quickstart_loss_trajectory_matches_jax(mesh, wire_dtype, rtol):
    """examples/quickstart.py's config (the JAX side built here, the JAX
    example is not imported; the port side by
    repro_torch.examples.quickstart.build_config, so the port's example
    and this test cannot drift) and its optimizer, 5 steps with LSH on at
    batch 8 x 64, at f32 (the example's bf16 rounds products where each
    framework does).

    With the f32 wire every step's loss is within 1e-4 relative of JAX's
    (measured 4e-7): the gate of ROADMAP Queue 1 item 1.  With the bf16
    wire the first loss agrees within 1e-5, but the trajectory is held to
    2e-2 only (measured 9.2e-3 at step 3): the first AdamW step moves each
    param by about lr * sign(g), so a gradient that the bf16 rounding of a
    cotangent flipped (see test_train_step_matches_jax) moves the hash
    inputs, and a token near a hash tie then changes slot."""
    jcfg = jbase.ModelConfig(
        name="quickstart-moe", family="moe", d_model=64, num_heads=4,
        num_kv_heads=2, d_ff=128, vocab_size=512,
        layout=((jbase.ATTN, jbase.MOE),), num_super_blocks=2,
        moe=jbase.MoEConfig(num_experts=8, top_k=2, expert_ffn_dim=128,
                            lsh=jbase.LSHConfig(enabled=True, num_hashes=6,
                                                rotation_dim=32,
                                                compression_rate=0.25,
                                                wire_dtype=wire_dtype)),
        remat_policy="dots", kv_chunk=32, dtype="float32")
    jl, tl, *_ = _train_both(
        mesh, jcfg, _quickstart_f32(wire_dtype),
        dict(lr=1e-3, warmup_steps=5, total_steps=50), steps=5, batch=8,
        seq=64)
    print(f"quickstart losses, wire {wire_dtype}: jax {jl} torch {tl}")
    np.testing.assert_allclose(tl[0], jl[0], rtol=1e-5)
    np.testing.assert_allclose(tl, jl, rtol=rtol)


# ------------------------------------------------------------ optimizer --

def _opt_tree(rng):
    return {"a": rng.standard_normal((3, 200)).astype(np.float32),
            "b": [rng.standard_normal((7,)).astype(np.float32)],
            "rot": rng.standard_normal((2, 5)).astype(np.float32),
            "placement": np.arange(4, dtype=np.int32)}


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16", "int8"])
def test_adamw_update_matches_jax(moment_dtype):
    """Three steps; ``rot`` has a zero gradient, as the hash rotations do,
    and still decays by lr * weight_decay * p."""
    rng = np.random.default_rng(11)
    p = _opt_tree(rng)
    cfg_kw = dict(lr=1e-2, moment_dtype=moment_dtype, clip_norm=5.0)
    jcfg, tcfg = jbase.OptimizerConfig(**cfg_kw), tbase.OptimizerConfig(
        **cfg_kw)
    jp = jax.tree.map(jnp.asarray, p)
    jst = jadam.adamw_init(jp, jcfg)
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), p)
    tst = tadam.adamw_init(tp, tcfg)
    for i in range(3):
        g = _opt_tree(np.random.default_rng(20 + i))
        g["rot"] = np.zeros_like(g["rot"])
        jg = {**jax.tree.map(jnp.asarray, g),
              "placement": np.zeros((4,), jax.dtypes.float0)}
        lr = jnp.float32(1e-2)
        jp, jst = jadam.adamw_update(jp, jg, jst, jcfg, lr)
        tg = [None if not torch.is_floating_point(x) else x
              for x in tadam.leaves(jax.tree.map(torch.from_numpy, g))]
        tst = tadam.adamw_update(tp, tg, tst, tcfg, torch.tensor(1e-2))
    for name in ("a", "rot"):
        np.testing.assert_allclose(tp[name].numpy(), np.asarray(jp[name]),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    np.testing.assert_allclose(tp["b"][0].numpy(), np.asarray(jp["b"][0]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(tp["placement"].numpy(),
                                  np.asarray(jp["placement"]))
    assert int(tst.step) == 3 and int(tst.grad_skips) == 0
    decay = (1 - 1e-2 * 0.1) ** 3
    np.testing.assert_allclose(tp["rot"].numpy(), p["rot"] * decay,
                               rtol=1e-5)


def test_nan_loss_skips_and_counts():
    rng = np.random.default_rng(12)
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), _opt_tree(rng))
    cfg = tbase.OptimizerConfig()
    st = tadam.adamw_init(tp, cfg)
    before = [x.clone() for x in tadam.leaves(tp)]
    grads = [torch.ones_like(x) if x.is_floating_point() else None
             for x in tadam.leaves(tp)]
    state = tstep.TrainState(tp, st)
    state, metrics = tstep.apply_gradients(
        state, cfg, torch.tensor(float("nan")), {}, grads)
    assert int(metrics["grad_skips"]) == 1 and int(state.opt.step) == 1
    for x, y in zip(tadam.leaves(state.params), before):
        assert torch.equal(x, y)
    for m in tadam.leaves(state.opt.m) + tadam.leaves(state.opt.v):
        assert m is None or not m.any()


def test_warmup_cosine_matches_jax():
    for step in range(0, 60, 3):
        want = j_warmup_cosine(jnp.int32(step), 1e-3, 10, 50)
        got = warmup_cosine(torch.tensor(step, dtype=torch.int32), 1e-3, 10,
                            50)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------- data and CLI --

def test_synthetic_batches_equal_bit_for_bit():
    j, t = JData(515, 33, 4, seed=3), SyntheticLMDataset(515, 33, 4, seed=3)
    for step in (0, 1, 7):
        jb, tb = j.batch_at(step), t.batch_at(step)
        assert jb.keys() == tb.keys()
        for k in jb:
            assert jb[k].dtype == tb[k].dtype
            np.testing.assert_array_equal(jb[k], tb[k])


def test_train_cli_smoke_on_cpu(capsys):
    assert train_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--steps", "2", "--batch", "2", "--seq", "16",
                           "--log-every", "1"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    steps = [ev for ev in lines if ev["kind"] == "step"]
    summary = [ev for ev in lines if ev["kind"] == "train_summary"]
    assert [ev["step"] for ev in steps] == [0, 1] and len(summary) == 1
    for ev in steps:
        assert {"loss", "ce", "lr", "dt", "skips"} <= set(ev)
        assert np.isfinite(ev["loss"]) and ev["skips"] == 0
    s = summary[0]
    assert s["steps"] == 2 and s["final_loss"] == steps[-1]["loss"]
    assert s["tokens_per_s"] > 0 and s["peak_memory_bytes"] is None


@pytest.mark.parametrize("argv,want", [
    (["--mesh-pipe", "2"], "mesh 1x2x1 needs 2 devices, have 1"),
    (["--pipeline-microbatches", "2", "--mesh-pipe", "2", "--mesh-model",
      "2"], "mesh 1x2x2 needs 4 devices, have 1")])
def test_train_cli_rejects_flags_of_later_items(argv, want, capsys):
    """The pipe flags parse; a pipe mesh of more ranks than the job has
    exits 2 with the JAX launcher's message, before anything is built,
    and never trains on one stage."""
    assert train_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                           *argv]) == 2
    err = capsys.readouterr().err
    assert "unrecognized arguments" not in err and want in err


def test_profile_summary_on_cpu():
    """launch.profiling.summarize on a CPU-only trace: no device events,
    so busy time and idle share are not measured (None), and no kernel
    launch call is counted; the top-op lines name the ops run."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.profiling import summarize
    a = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            (a @ a).sum()
    record, lines = summarize(prof, 2, 10.0, top=3)
    assert record["device_busy_ms_per_step"] is None
    assert record["device_idle_share"] is None
    assert record["device_kernels_per_step"] == 0
    assert record["host_launch_ms_per_step"] == 0
    assert record["host_launches_per_step"] == 0
    assert len(lines) == 6 and any("aten::mm" in ln for ln in lines)


def test_profile_train_on_cpu(capsys):
    """launch.profile_train at the smoke config on the CPU, fp8 wire with
    LSH off: the steady steps timed alone, the profiled step's record
    (nothing measured on a device) and the wire format set."""
    from repro_torch.launch import profile_train
    assert profile_train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                               "--wire", "fp8", "--lsh", "off", "--batch",
                               "2", "--seq", "16", "--warmup", "1",
                               "--steps", "2", "--top", "2"]) == 0
    out = capsys.readouterr().out.splitlines()
    rec = json.loads(out[-1])
    assert rec["kind"] == "train_profile" and rec["device"] == "cpu"
    assert rec["wire_format"] == "fp8" and rec["lsh"] == "off"
    assert len(rec["warmup_ms"]) == 1 and len(rec["step_ms"]) == 2
    assert rec["median_step_ms"] == rec["wall_ms_per_step"] > 0
    assert rec["device_busy_ms_per_step"] is None
    assert rec["host_launches_per_step"] == 0
    assert len(out) == 5                  # 2 device + 2 host top ops
