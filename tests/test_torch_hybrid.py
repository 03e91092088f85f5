"""The hybrid Mamba-2 + MoE path: jamba-1.5-large-398b's smoke config in
the port against the JAX package, on the CPU, and the port's own checks
of its mixed layout.

Params are made by JAX and carried with ``params_from_jax``; batches are
``SyntheticLMDataset``'s.  Tolerances, at f32 (the JAX run as
tests/test_torch_train.py runs it):
- the forward (LSH on, f32 wire): logits within 1e-5 relative L2, the
  expert load equal;
- one train step with LSH on: equal slots in every MoE layer; with the
  f32 wire the loss within 1e-5 relative and each gradient leaf within
  1e-4 relative L2 (measured 2.8e-7 and 3.4e-5).  With the bf16 wire the
  centroids and both legs' cotangents round to bf16 in both packages;
  where the two frameworks' f32 sums differ in the last bit a value next
  to a bf16 boundary rounds to the other side, a 2**-8 relative step,
  which the layers above carry into the loss and the layers below into
  their gradients.  The hybrid stack amplifies it: the port against
  itself, with the embedding moved by 1e-7 relative, moves its loss by
  2.5e-5 and its worst gradient leaf (a Mamba layer's w_b, w_c, a_log or
  dt_bias: sums over the sequence that cancel) by 1.1e-2 relative L2 with
  the bf16 wire, 4.4e-5 with the f32 wire (granite's smoke config: 8e-4
  and 1.5e-6).  Against JAX the bf16 wire measured a loss 7.5e-5 and a
  worst leaf 1.4e-2 apart, and is held to 1e-4 (the first step's bound
  of tests/test_torch_dist_train.py's bf16 wire, for the same reason)
  and 3e-2;
- 8 teacher-forced ``decode_step``s: logits within 1e-5 relative L2 and
  atol 1e-4 (test_torch_decode.py's bound), equal greedy tokens.
  Measured: rel L2 3.9e-6, max |diff| 2.6e-5, five times granite's: the
  Mamba recurrence's sums over the state (y = h . C over d_state, with
  terms of both signs) cancel, and each layer's f32 products, summed in
  another order (about 2e-7 relative), leave about 8e-7 relative in its
  output;
- the port's decode against its own forward (``use_lsh=False``, the
  recurrence against the chunked scan) within atol 1e-3, the JAX test's
  bound.

Also: the config and its param count equal JAX's; ``init_params`` gives
JAX's leaves, shapes and dtypes, with f32 ``dt_bias``, ``a_log`` and
``d_skip`` in a bf16 model, and those leaves stay f32 through
``state_from_jax``, AdamW, the port's checkpoint, a JAX-written checkpoint
read by ``load_jax_checkpoint`` and ``shard_params`` / ``gather_params``; serve and train run on the CPU; the mesh-free staged
(1F1B) step is bitwise its accumulation; ``check_supported`` takes
whisper-base and internvl2-26b, and an encoder in pipeline stages
raises (item 7), as in JAX; and on 2 gloo ranks, a ``model`` axis of 2,
the forward (LSH off) matches the mesh-free forward within 1e-5 relative
L2 and decode equals the mesh-free decode (tests/test_torch_tp.py holds
the tensor-parallel Mamba against JAX).
"""
import dataclasses
import json
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

from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.convert import gather_params, shard_params  # noqa: E402
from repro_torch.runtime.params import param_specs  # noqa: E402
from repro_torch.data.synthetic import SyntheticLMDataset  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.optim import adam as tadam  # noqa: E402
from repro_torch.runtime import step as tstep  # noqa: E402

if __name__ != "__main__":
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.compat import set_mesh
    from repro.configs import base as jbase
    from repro.configs.registry import get_config as j_get_config
    from repro.configs.registry import get_smoke_config as j_smoke_config
    from repro.models import model as jmodel
    from repro.optim import adam as jadam
    from repro_torch.convert import params_from_jax, state_from_jax
    from test_torch_decode import _decode_both
    from repro.data.synthetic import SyntheticLMDataset as JData
    from repro.runtime import step as jstep
    from test_torch_train import (_check_slots, _np_tree, _rel_l2,  # noqa
                                  _wire, slot_spies)

ARCH = "jamba-1.5-large-398b"
CPU = torch.device("cpu")
F32_LEAVES = ("dt_bias", "a_log", "d_skip")
N_MOE = 4                           # MoE layers of the smoke config


def _mamba_layers(params):
    return [p["mixer"] for p in params["layers"] if "w_dt" in p["mixer"]]


def _port_cfg(jcfg):
    """A JAX ModelConfig as the port's (the same fields)."""
    d = dataclasses.asdict(jcfg)
    moe = d["moe"]
    moe.update(lsh=tbase.LSHConfig(**moe["lsh"]),
               comm=tbase.CommConfig(**moe["comm"]),
               obs=tbase.ObsConfig(**moe["obs"]))
    d.update(moe=tbase.MoEConfig(**moe), ssm=tbase.SSMConfig(**d["ssm"]),
             xlstm=tbase.XLSTMConfig(**d["xlstm"]))
    return tbase.ModelConfig(**d)


_JAX_PARAMS = {}


@pytest.fixture(autouse=True)
def _cached_jax_init(monkeypatch):
    """JAX's init_params runs eagerly (seconds at this size): the tests
    that compare with JAX share one result per key and config, the wire
    fields aside (they make no param)."""
    orig = jmodel.init_params

    def cached(key, cfg, mesh):
        if isinstance(key, jax.core.Tracer):
            return orig(key, cfg, mesh)
        lsh = dataclasses.replace(cfg.moe.lsh, wire_dtype="", wire_format="")
        k = (np.asarray(jax.random.key_data(key)).tobytes(),
             cfg.replace(moe=dataclasses.replace(cfg.moe, lsh=lsh)))
        if k not in _JAX_PARAMS:
            _JAX_PARAMS[k] = orig(key, cfg, mesh)
        return _JAX_PARAMS[k]

    monkeypatch.setattr(jmodel, "init_params", cached)


def _configs(dtype="float32"):
    return (j_smoke_config(ARCH).replace(dtype=dtype),
            get_smoke_config(ARCH).replace(dtype=dtype))


# ------------------------------------------------------ config and init --

def test_jamba_config_and_param_count_match_jax():
    for jcfg, tcfg in ((j_get_config(ARCH), get_config(ARCH)),
                       (j_smoke_config(ARCH), get_smoke_config(ARCH))):
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert tbase.param_count(tcfg) == jbase.param_count(jcfg)
        assert _port_cfg(jcfg) == tcfg
        tmodel.check_supported(tcfg)
    assert 3.9e11 < tbase.param_count(get_config(ARCH)) < 4.0e11


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}#{i}/"))
        return out
    return {prefix[:-1]: tree}


def test_init_params_shapes_and_dtypes_as_jax(mesh):
    """bf16: the port's init_params has JAX's leaves in the port's layer
    order, leaf for leaf the same shape and dtype; the Mamba layers'
    dt_bias, a_log and d_skip are f32, and stay f32 through
    params_from_jax and state_from_jax (moments included)."""
    jcfg, tcfg = _configs("bfloat16")

    def init(key):
        p = jmodel.init_params(key, jcfg, mesh)
        return p, jadam.adamw_init(p, jbase.OptimizerConfig())

    with set_mesh(mesh):         # shapes and dtypes only: zeros stand in
        jstate = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                              jax.eval_shape(init, jax.random.PRNGKey(0)))
    want = _flat(params_from_jax(jstate[0], device="cpu"))
    got = _flat(tmodel.init_params(tcfg, seed=0, device="cpu"))
    assert sorted(got) == sorted(want)
    for k in want:
        assert (tuple(got[k].shape), got[k].dtype) == \
            (tuple(want[k].shape), want[k].dtype), k
    tstate = state_from_jax(jstate, device="cpu")
    n = 0
    for tree in (tstate.params, tstate.opt.m, tstate.opt.v):
        for mixer in _mamba_layers(tree):
            for k in F32_LEAVES:
                assert mixer[k].dtype == torch.float32, k
                n += 1
            assert tree is not tstate.params \
                or mixer["w_x"].dtype == torch.bfloat16
    assert n == 3 * len(F32_LEAVES) * 7          # 7 Mamba layers


def test_f32_leaves_keep_dtype_through_adamw_and_checkpoint(tmp_path):
    """A bf16 state: one AdamW step and a save / restore leave the f32
    Mamba leaves f32 (and bit-equal after the restore)."""
    from repro_torch.checkpoint.checkpoint import (load_checkpoint,
                                                   save_checkpoint)
    _, tcfg = _configs("bfloat16")
    opt = tbase.OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    state = tstep.init_train_state(tcfg, opt, seed=0, device="cpu")
    batch = tstep.batch_to_device(SyntheticLMDataset(
        tcfg.vocab_size, 16, 2).batch_at(0), CPU)
    before = [m["a_log"].clone() for m in _mamba_layers(state.params)]
    state, met = tstep.make_train_step(tcfg, opt)(state, batch)
    assert np.isfinite(float(met["loss"])) and int(met["grad_skips"]) == 0
    for m, b in zip(_mamba_layers(state.params), before):
        assert all(m[k].dtype == torch.float32 for k in F32_LEAVES)
        assert not torch.equal(m["a_log"], b)       # the step moved it
    save_checkpoint(str(tmp_path), 1, state)
    template = tstep.init_train_state(tcfg, opt, seed=1, device="cpu")
    restored, step, _ = load_checkpoint(str(tmp_path), template)
    assert step == 1
    a, b = tadam.leaves(restored.params), tadam.leaves(state.params)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_port_restores_a_jax_checkpoint_of_the_hybrid(tmp_path, monkeypatch,
                                                      mesh):
    """A bf16 TrainState (random values in JAX's tree) written by the JAX
    package's checkpoint and read through jax_checkpoint_layout into a
    port state: every leaf's dtype and bits, the f32 Mamba leaves f32."""
    import repro.checkpoint.checkpoint as jck
    from repro.runtime import step as jstep
    from repro_torch.convert import load_jax_checkpoint
    monkeypatch.setattr(jck, "zstandard", None)
    jcfg, tcfg = _configs("bfloat16")
    rng = np.random.default_rng(4)

    def fill(a):
        if np.issubdtype(a.dtype, np.integer):
            return rng.integers(0, 4, a.shape).astype(a.dtype)
        return rng.standard_normal(a.shape).astype(a.dtype)

    with set_mesh(mesh):
        jstate = jax.tree.map(fill, jax.eval_shape(
            lambda k: jstep.init_train_state(k, jcfg, jbase.OptimizerConfig(),
                                             mesh), jax.random.PRNGKey(0)))
    jck.save_checkpoint(str(tmp_path), 1, jstate)
    want = state_from_jax(jstate, device="cpu")
    tpl = tstep.init_train_state(tcfg, tbase.OptimizerConfig(), seed=3,
                                 device="cpu")
    got, step, _ = load_jax_checkpoint(str(tmp_path), tpl)
    assert step == 1
    for tree_got, tree_want in ((got.params, want.params),
                                (got.opt.m, want.opt.m),
                                (got.opt.v, want.opt.v)):
        fg, fw = _flat(tree_got), _flat(tree_want)
        assert sorted(fg) == sorted(fw)
        for k in fw:
            if fw[k] is None:                # an integer leaf's moment
                assert fg[k] is None, k
                continue
            assert fg[k].dtype == fw[k].dtype and torch.equal(fg[k], fw[k]), k
    for m in _mamba_layers(got.params):
        assert all(m[k].dtype == torch.float32 for k in F32_LEAVES)


# ------------------------------------------------- forward and training --

def test_forward_matches_jax(mesh):
    """f32, LSH on, f32 wire: logits and the stats of the four MoE
    layers."""
    jcfg, tcfg = _configs()
    jcfg, tcfg = _wire(jcfg, jbase, "float32"), _wire(tcfg, tbase, "float32")
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, size=(2, 16)).astype(np.int32)
    with set_mesh(mesh):
        params = jmodel.init_params(jax.random.PRNGKey(0), jcfg, mesh)
        jl, jst = jax.jit(lambda p, b: jmodel.forward(p, jcfg, mesh, b))(
            params, {"tokens": jnp.asarray(tokens)})
    tparams = params_from_jax(_np_tree(params), device="cpu")
    with torch.no_grad():
        tl, tst = tmodel.forward(tparams, tcfg,
                                 torch.from_numpy(tokens).long())
    assert tuple(tl.shape) == jl.shape
    rel = _rel_l2(tl.numpy(), np.asarray(jl))
    print(f"jamba smoke forward: logits rel L2 {rel:.3g}")
    assert rel < 1e-5
    np.testing.assert_array_equal(tst["expert_load"].numpy(),
                                  np.asarray(jst["expert_load"]))
    for k in ("aux_loss", "z_loss"):
        np.testing.assert_allclose(float(tst[k]), float(jst[k]), rtol=1e-5)


@pytest.mark.parametrize("wire_dtype,loss_tol,grad_tol", [
    ("float32", 1e-5, 1e-4), ("bfloat16", 1e-4, 3e-2)])
def test_train_step_matches_jax(mesh, slot_spies, wire_dtype, loss_tol,
                                grad_tol):
    """One step at f32 with LSH on, the gradient half of the train step
    (JAX's make_accum_grad_fn, the port's loss_fn and autograd): loss,
    slots, gradients (module docstring).  The AdamW half is the granite
    tests' (tests/test_torch_train.py); the port's whole step runs in
    test_f32_leaves_keep_dtype_through_adamw_and_checkpoint."""
    jcfg, tcfg = _configs()
    jcfg, tcfg = _wire(jcfg, jbase, wire_dtype), _wire(tcfg, tbase,
                                                       wire_dtype)
    batch = SyntheticLMDataset(jcfg.vocab_size, 16, 2).batch_at(0)
    with set_mesh(mesh):
        params = jmodel.init_params(jax.random.PRNGKey(0), jcfg, mesh)
        loss, _, jgrads = jax.jit(jstep.make_accum_grad_fn(jcfg, mesh))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    jl = [float(loss)]
    jgrads = _np_tree(jgrads)
    for blk in jgrads["blocks"]:
        blk.get("ffn", {}).pop("placement", None)           # float0
    tparams = params_from_jax(_np_tree(params), device="cpu")
    train = [p for p in tadam.leaves(tparams) if p.is_floating_point()]
    for p in train:
        p.requires_grad_(True)
    tloss, _ = tmodel.loss_fn(tparams, tcfg, tstep.batch_to_device(batch,
                                                                   CPU))
    tgrads = torch.autograd.grad(tloss, train, allow_unused=True)
    tl = [float(tloss.detach())]
    _check_slots(slot_spies, N_MOE)
    jg = tadam.leaves(params_from_jax(jgrads, device="cpu"))
    assert len(jg) == len(tgrads) == len(train)
    n_zero, worst, worst_mamba = 0, 0.0, 0.0
    mamba = {id(t) for m in _mamba_layers(tparams) for t in m.values()
             if torch.is_tensor(t)}
    for p, g, want in zip(train, tgrads, jg):
        if g is None:
            assert not want.any()
            n_zero += 1
            continue
        r = _rel_l2(g.numpy(), want.numpy())
        worst = max(worst, r)
        if id(p) in mamba:
            worst_mamba = max(worst_mamba, r)
    assert n_zero == N_MOE                        # one lsh_rot a MoE layer
    print(f"jamba smoke, wire {wire_dtype}: loss rel "
          f"{abs(tl[0] - jl[0]) / abs(jl[0]):.3g}, worst gradient rel L2 "
          f"{worst:.3g} (Mamba leaves {worst_mamba:.3g})")
    np.testing.assert_allclose(tl, jl, rtol=loss_tol)
    assert worst < grad_tol


def test_decode_matches_jax(mesh):
    """8 teacher-forced steps: 4 MoE, 1 attention and 7 Mamba layers."""
    jcfg, tcfg = _configs()
    want, got = _decode_both(mesh, jcfg, tcfg)
    assert got.shape == (2, 8, jcfg.vocab_size)
    rel = _rel_l2(got, want)
    print(f"jamba smoke decode: logits rel L2 {rel:.3g}, max |diff| "
          f"{np.abs(got - want).max():.3g}")
    assert rel < 1e-5
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_decode_matches_own_forward():
    """The Mamba recurrence and the KV caches against the chunked scan
    and the attention forward, LSH off (decode is exact; the LSH forward
    is lossy by design)."""
    _, tcfg = _configs()
    params = tmodel.init_params(tcfg, seed=2, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, tcfg.vocab_size, size=(2, 16))).long()
    with torch.no_grad():
        full, _ = tmodel.forward(params, tcfg, tokens, use_lsh=False)
    state = tmodel.init_decode_state(tcfg, 2, 16, device="cpu")
    outs = []
    for i in range(16):
        logits, state = tmodel.decode_step(params, tcfg, state,
                                           tokens[:, i:i + 1])
        outs.append(logits)
    err = float((torch.cat(outs, 1) - full).abs().max())
    print(f"jamba smoke decode against forward: max |diff| {err:.3g}")
    assert err < 1e-3
    assert state["position"] == 16
    kinds = [m for m, _ in tmodel.layer_kinds(tcfg)]
    for kind, cache in zip(kinds, state["layers"]):
        assert set(cache) == ({"h", "conv"} if kind == tbase.MAMBA
                              else {"k", "v"})


# ------------------------------------------------------ launchers, 1F1B --

def _events(out):
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


def test_serve_and_train_cli_on_cpu(capsys):
    from repro_torch.launch import serve, train
    assert serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--requests", "3", "--batch-slots", "2",
                       "--prompt-len", "3", "--gen", "2"]) == 0
    s = [e for e in _events(capsys.readouterr().out)
         if e["kind"] == "serve_summary"]
    assert len(s) == 1 and s[0]["tokens"] == 6 and s[0]["arch"] == ARCH
    assert train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--steps", "2", "--batch", "2", "--seq", "16",
                       "--log-every", "1"]) == 0
    ev = _events(capsys.readouterr().out)
    steps = [e for e in ev if e["kind"] == "step"]
    assert [e["step"] for e in steps] == [0, 1]
    assert all(np.isfinite(e["loss"]) and e["skips"] == 0 for e in steps)
    assert sum(e["kind"] == "train_summary" for e in ev) == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_staged_step_is_the_accumulation_bitwise(dtype):
    """Mesh-free, 2 stages of one super-block (8 layers each), 2
    microbatches: the loss, the clip norm and every param after the step
    bit-equal to the accumulation's (make_train_step(microbatch=))."""
    from repro_torch.runtime import pipeline_schedule as tpipe
    _, tcfg = _configs(dtype)
    cfg = tcfg.replace(num_super_blocks=2, pipeline_microbatches=2)
    opt = tbase.OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    batch = tstep.batch_to_device(SyntheticLMDataset(
        cfg.vocab_size, 16, 4).batch_at(0), CPU)
    out = []
    for fn in (tpipe.make_pipeline_train_step(cfg, opt, stages=2),
               tstep.make_train_step(cfg, opt, microbatch=2)):
        state = tstep.init_train_state(cfg, opt, seed=0, device="cpu")
        state, met = fn(state, batch)
        out.append((float(met["loss"]), float(met["grad_norm"]),
                    tadam.leaves(state.params)))
    (la, na, pa), (lb, nb, pb) = out
    assert np.isfinite(la) and (la, na) == (lb, nb)
    assert len(pa) == len(pb)
    for x, y in zip(pa, pb):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("arch", ["whisper-base", "internvl2-26b"])
def test_check_supported_raises_for_other_item7_archs(arch):
    """Both archs are ported (tests/test_torch_encdec.py): check_supported
    takes their configs.  What still raises, as in JAX, is an
    encoder-decoder stack's pipeline staging: here with an encoder on
    each arch's decoder.  (Its forward on a model axis > 1 runs:
    tests/test_torch_encdec.py's ``test_mesh_train_step_matches_jax``.)"""
    from repro_torch.runtime.pipeline_schedule import make_pipeline_grad_fn
    cfg = _port_cfg(j_smoke_config(arch))
    tmodel.check_supported(cfg)
    tmodel.init_params(cfg, device="cpu")
    cfg = cfg.replace(dtype="float32", encoder_decoder=True,
                      num_encoder_super_blocks=1, dp_only=False)
    tmodel.init_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="item 7"):
        make_pipeline_grad_fn(cfg, stages=2)


# ------------------------------------------------ a model axis of 2 --

def _rank_main(rank, world, args):
    """On a (1, 2) mesh: the forward (its Mamba layers' heads split over
    the model axis) within 1e-5 relative L2 of the mesh-free forward; 4
    decode steps equal the mesh-free decode on the same params;
    shard_params / gather_params keep every leaf's dtype and bits."""
    mesh = tmesh.make_mesh(data=1, model=2)
    cfg = get_smoke_config(ARCH).replace(dtype="float32")
    full = tmodel.init_params(cfg, seed=0, device="cpu")
    local = shard_params(full, mesh)
    back = gather_params(local, mesh, param_specs(full, mesh))
    for x, y in zip(tadam.leaves(back), tadam.leaves(full)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    for m in _mamba_layers(local):
        assert all(m[k].dtype == torch.float32 for k in F32_LEAVES)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(2, 16))).long()
    # the forward, LSH off (with LSH on a mesh hashes each rank's tokens
    # apart: another function), the heads split over the model axis
    # (runtime/tp.py): the mesh-free logits of the whole sequence on this
    # rank's vocabulary columns (the head splits the vocabulary)
    seq = slice(rank * 8, (rank + 1) * 8)
    cols = slice(rank * cfg.vocab_size // 2, (rank + 1) * cfg.vocab_size // 2)
    with torch.no_grad():
        got, _ = tmodel.forward(local, cfg, tokens[:, seq], mesh=mesh,
                                use_lsh=False)
        want, _ = tmodel.forward(full, cfg, tokens, use_lsh=False)
    fwd = float(torch.linalg.norm(got - want[:, :, cols])
                / torch.linalg.norm(want[:, :, cols]))
    assert fwd < 1e-5, fwd
    tokens = tokens[:, :4]
    outs = {}
    for name, params, m in (("mesh", local, mesh), ("free", full, None)):
        state = tmodel.init_decode_state(cfg, 2, 4, device="cpu")
        logits = []
        for i in range(4):
            lg, state = tmodel.decode_step(params, cfg, state,
                                           tokens[:, i:i + 1], mesh=m)
            logits.append(lg)
        outs[name] = torch.cat(logits, 1)
    err = float((outs["mesh"] - outs["free"]).abs().max())
    assert err < 1e-5, err
    print(json.dumps({"rank": rank, "forward_rel_l2": fwd,
                      "decode_max_abs_diff": err}))
    return 0


def test_mamba_on_a_model_axis_of_two(tmp_path):
    outs = tmesh.spawn_cpu_ranks(str(HERE), 2, [],
                                 store=str(tmp_path / "store"),
                                 timeout_s=240)
    recs = [json.loads(line) for out in outs for line in out.splitlines()
            if line.startswith("{")]
    assert sorted(r["rank"] for r in recs) == [0, 1]


if __name__ == "__main__":                  # RANK WORLD STORE
    sys.exit(tmesh.run_cpu_rank(sys.argv[1:], _rank_main))
