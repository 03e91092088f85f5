"""The xLSTM mixers (models/xlstm.py) and xlstm-350m's smoke config in the
port against the JAX package, on the CPU.

Inputs are numpy arrays from a seeded generator; params are JAX's,
carried with ``params_from_jax``.  Tolerances, at f32:
- ``_mlstm_chunk`` (forward and the gradients of a scalar of y and the
  final state): within 1e-5 relative L2 of JAX's, in three regimes:
  ordinary gates; large input gates (log_i up to 60: exp(60) overflows
  f32, so the values are finite only through the stabiliser m); and a
  sequence shorter than a chunk.  No NaN or inf in any gradient.
- ``slstm_apply`` forward and gradients within 1e-5 relative L2;
  ``mlstm_decode`` / ``slstm_decode`` steps against JAX's within 1e-5.
  The gradient at ties: the sLSTM's normaliser max(n, 1) is exactly 1
  wherever the input gate sets the stabiliser, which both packages split
  half and half (``torch.maximum``, ``jnp.maximum``).
- The port's decode against its own forward (the recurrences against
  the chunkwise mLSTM and the sLSTM loop): 16 steps within 1e-4.
- One train step of the smoke config (2 super-blocks of mLSTM + sLSTM),
  JAX with ``--xla_allow_excess_precision=false`` (as
  tests/test_torch_ssm.py runs it): loss within 1e-5 relative and every
  gradient leaf within 1e-4 relative L2 in f32 (measured 7e-8, 8e-6); in
  bf16 loss within 1e-3 and gradients within 2e-2 (measured 9.7e-5 and
  7.6e-3: both packages round each op's output to bf16, and where the two
  frameworks' f32 sums differ in their last bits a bf16 rounding turns it
  into a 2**-8 step; the port's own bf16 gradients move by 0.16 relative
  L2 when its embedding moves by 2**-7).
- The pure data-parallel step (``dp_only``, the config's own profile) on
  2 gloo ranks, 2 steps, against JAX's on 2 forced host devices
  (tests/test_distributed.py's ``test_dp_only_step_multidevice_matches_single``
  is its JAX counterpart): losses within 1e-5 relative (measured 1.4e-6),
  the replicas bit-identical, and each param's distance from JAX's within
  5e-3 of the norm of JAX's update to it (measured 1.1e-3).  Not held
  relative to the params: AdamW's first steps move an element by about
  lr * sign(g), so where a gradient element near zero differs in its last
  bits (JAX averages with ``pmean``, the port with gloo's all-reduce, which
  sum in other orders) the element moves by another amount, and the
  xLSTM's zero-initialised biases (``b_if``, ``b_gates``) hold nothing
  but their updates (5.9e-4 relative to themselves).
- On a ``model`` axis > 1 outside ``dp_only`` (tests/_torch_mesh_cases.py):
  the smoke config at (1, 2) with head_dim 32 (4 heads, 2 a rank) and at
  (1, 4) with head_dim 64 (2 heads that do not split: the mLSTM runs
  replicated, and its decode state splits on the head dimension), f32,
  gloo ranks against JAX on as many forced host devices: the loss within
  1e-5 relative and every gradient leaf within 1e-4 relative L2
  (tests/test_torch_tp.py's bounds); 4 teacher-forced decode steps on
  the state of JAX's ``decode_state_specs``, the logits within 1e-5
  relative L2 of JAX's and of the port's mesh-free decode, every state
  leaf's shape on a rank JAX's shard shape.
- Serve and train run through the CLIs with ``--device cpu``.
- All the JAX references come from one subprocess (four forced host
  devices, ``--xla_allow_excess_precision=false``) that starts with the
  file's first test, beside the gloo ranks of 2 and 4 (the ``dp_only``
  step and the mesh cases).
- The config and param count equal JAX's; ``init_params`` gives JAX's
  leaves, shapes and dtypes (f32 ``b_if`` / ``b_gates`` in a bf16
  model); ``params_from_jax`` and ``load_jax_checkpoint`` carry JAX's
  xLSTM params bit for bit, and jamba's Mamba params made on a JAX mesh
  whose model axis splits them.
"""
import dataclasses
import json
import math
import os
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # parallel test workers share the cores

HERE = Path(__file__).resolve()
SRC = HERE.parents[1] / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

import _torch_mesh_cases as cases  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.data.synthetic import SyntheticLMDataset  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import xlstm as tx  # noqa: E402
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
    from repro.models import xlstm as jx
    from repro.runtime import step as jstep
    from repro_torch.convert import params_from_jax, state_from_jax
    from test_torch_decode import _decode_both
    from test_torch_train import _np_tree, _rel_l2

ARCH = "xlstm-350m"
CPU = torch.device("cpu")
RTOL = 1e-5
OPT = dict(lr=1e-3, warmup_steps=0, total_steps=10)
DP_MESH, DP_BATCH, DP_SEQ, DP_STEPS = (2, 1), 4, 16, 2
# name: ((data, model), config overrides); 4 heads of 32 split 2 a rank,
# 2 heads of 64 do not split over 4 (the training forward replicated, the
# decode state on the head dimension)
MESH_CASES = {"1x2": ((1, 2), {"head_dim": 32}),
              "1x4": ((1, 4), {"head_dim": 64})}
DTYPES = ("float32", "bfloat16")


def _configs(dtype="float32"):
    return (j_smoke_config(ARCH).replace(dtype=dtype),
            get_smoke_config(ARCH).replace(dtype=dtype))


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


def _np(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else x)


# ------------------------------------------------------- the mixers --

def _chunk_inputs(S, li_shift, li_scale, seed):
    rng = np.random.default_rng(seed)
    B, nh, dh = 2, 2, 8

    def f(*s):
        return rng.standard_normal(s).astype(np.float32)
    return (f(B, S, nh, dh), f(B, S, nh, dh), f(B, S, nh, dh),
            f(B, S, nh) * li_scale + li_shift,
            -np.abs(f(B, S, nh)) - 0.05, f(B, S, nh, dh))


@pytest.mark.parametrize("S,li_shift,li_scale", [
    (24, 0.0, 1.0),             # ordinary gates
    (24, 45.0, 15.0),           # input gates up to ~60: exp overflows f32
    (5, 0.0, 2.0)],             # shorter than the chunk (8)
    ids=["ordinary", "large_input_gates", "short_sequence"])
def test_mlstm_chunk_matches_jax(S, li_shift, li_scale):
    q, k, v, li, lf, ct = _chunk_inputs(S, li_shift, li_scale, seed=S)
    B, _, nh, dh = q.shape
    st = (np.zeros((B, nh, dh, dh), np.float32),
          np.zeros((B, nh, dh), np.float32), np.zeros((B, nh), np.float32))

    def objective(y, C, n, m, lib):
        return (lib.sum(y * lib.asarray(ct)) + lib.sum(C * C) * 1e-3
                + lib.sum(n) + lib.sum(m))

    def jf(*a):
        y, (C, n, m) = jx._mlstm_chunk(*a, st, 8)
        return objective(y, C, n, m, jnp), (y, C, n, m)

    (jl, jout), jg = jax.value_and_grad(jf, argnums=tuple(range(5)),
                                        has_aux=True)(
        *map(jnp.asarray, (q, k, v, li, lf)))
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v, li, lf)]
    y, (C, n, m) = tx._mlstm_chunk(*ts, tuple(map(torch.tensor, st)), 8)
    tl = objective(y, C, n, m, torch)
    tg = torch.autograd.grad(tl, ts)
    worst = 0.0
    for got, want in zip((y, C, n, m) + tuple(tg), tuple(jout) + tuple(jg)):
        got, want = _np(got), np.asarray(want)
        assert np.isfinite(got).all()
        worst = max(worst, _rel_l2(got, want))
    print(f"_mlstm_chunk S={S} li~{li_shift}+-{li_scale}: worst rel L2 "
          f"{worst:.3g}, |y| max {np.abs(_np(y)).max():.3g}")
    assert worst < RTOL


def _mixer_params(jinit, seed):
    return _np_tree(jinit(jax.random.PRNGKey(seed)))


def test_slstm_apply_matches_jax():
    d = 32
    jp = _mixer_params(lambda k: jx.slstm_init(k, d, 2, 4.0 / 3.0,
                                               jnp.float32), 1)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 12, d)).astype(np.float32)
    ct = rng.standard_normal((2, 12, d)).astype(np.float32)

    def jf(p, x):
        return jnp.sum(jx.slstm_apply(p, x) * ct)

    jl, (jgp, jgx) = jax.value_and_grad(jf, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    tp = _t(jp)
    leaves = tadam.leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    xt = torch.tensor(x, requires_grad=True)
    y = tx.slstm_apply(tp, xt)
    tl = torch.sum(y * torch.from_numpy(ct))
    grads = torch.autograd.grad(tl, leaves + [xt])
    want = tadam.leaves(jax.tree.map(np.asarray, jgp)) + [np.asarray(jgx)]
    worst = max(_rel_l2(_np(g), w) for g, w in zip(grads, want))
    print(f"slstm_apply: loss {tl.item()} / {float(jl)}, worst gradient "
          f"rel L2 {worst:.3g}")
    np.testing.assert_allclose(tl.item(), float(jl), rtol=RTOL)
    assert worst < RTOL


def _t(v):
    if isinstance(v, dict):
        return {k: _t(x) for k, x in v.items()}
    return torch.from_numpy(np.array(v))


def test_mixer_decode_steps_match_jax():
    """Four steps of mlstm_decode and slstm_decode, outputs and states."""
    d, dh = 32, 16
    jm = _mixer_params(lambda k: jx.mlstm_init(k, d, dh, 2.0, jnp.float32),
                       3)
    js = _mixer_params(lambda k: jx.slstm_init(k, d, 2, 4.0 / 3.0,
                                               jnp.float32), 4)
    x = np.random.default_rng(5).standard_normal((4, 2, 1, d)).astype(
        np.float32)
    jst_m = jx.init_mlstm_state(2, d, dh, 2.0)
    jst_s = jx.init_slstm_state(2, d)
    tst_m = tx.init_mlstm_state(2, 64 // dh, dh, CPU)
    tst_s = tx.init_slstm_state(2, d, CPU)
    worst = 0.0
    for t in range(4):
        ym, jst_m = jx.mlstm_decode(jm, jnp.asarray(x[t]), jst_m, dh)
        ys, jst_s = jx.slstm_decode(js, jnp.asarray(x[t]), jst_s)
        tm, tst_m = tx.mlstm_decode(_t(jm), torch.from_numpy(x[t]), tst_m,
                                    dh)
        ts, tst_s = tx.slstm_decode(_t(js), torch.from_numpy(x[t]), tst_s)
        pairs = [(tm, ym), (ts, ys)] + list(zip(tst_m.values(), jst_m)) \
            + list(zip(tst_s.values(), jst_s))
        for got, want in pairs:
            worst = max(worst, _rel_l2(_np(got), np.asarray(want)))
    print(f"xLSTM decode steps: worst rel L2 {worst:.3g}")
    assert worst < RTOL


def test_decode_matches_own_forward():
    _, tcfg = _configs()
    params = tmodel.init_params(tcfg, seed=2, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, tcfg.vocab_size, size=(2, 16))).long()
    with torch.no_grad():
        full, _ = tmodel.forward(params, tcfg, tokens)
    state = tmodel.init_decode_state(tcfg, 2, 16, device="cpu")
    outs = []
    for i in range(16):
        logits, state = tmodel.decode_step(params, tcfg, state,
                                           tokens[:, i:i + 1])
        outs.append(logits)
    err = float((torch.cat(outs, 1) - full).abs().max())
    print(f"xlstm smoke decode against forward: max |diff| {err:.3g}")
    assert err < 1e-4
    kinds = [m for m, _ in tmodel.layer_kinds(tcfg)]
    for kind, cache in zip(kinds, state["layers"]):
        assert set(cache) == ({"C", "n", "m"} if kind == tbase.MLSTM
                              else {"c", "n", "h", "m"})
        assert all(v.dtype == torch.float32 for v in cache.values())


def test_decode_matches_jax(mesh):
    jcfg, tcfg = _configs()
    want, got = _decode_both(mesh, jcfg, tcfg)
    rel = _rel_l2(got, want)
    print(f"xlstm smoke decode: logits rel L2 {rel:.3g}")
    assert rel < RTOL
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


# ------------------------------------------------ config and weights --

def test_config_param_count_and_init_match_jax(mesh):
    for jcfg, tcfg in ((j_get_config(ARCH), get_config(ARCH)),
                       (j_smoke_config(ARCH), get_smoke_config(ARCH))):
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert tbase.param_count(tcfg) == jbase.param_count(jcfg)
        tmodel.check_supported(tcfg)
    cfg = get_config(ARCH)
    assert cfg.dp_only and tbase.param_count(cfg) == 400926720
    d_in = tx.mlstm_width(cfg.d_model, cfg.resolved_head_dim,
                          cfg.xlstm.mlstm_proj_factor)
    assert d_in == 2048 and int(cfg.xlstm.slstm_proj_factor
                                * cfg.d_model) == 1365
    jcfg, tcfg = _configs("bfloat16")
    with set_mesh(mesh):
        shapes = jax.eval_shape(lambda k: jmodel.init_params(k, jcfg, mesh),
                                jax.random.PRNGKey(0))
    want = _flat(params_from_jax(jax.tree.map(
        lambda a: np.zeros(a.shape, a.dtype), shapes), device="cpu"))
    got = _flat(tmodel.init_params(tcfg, seed=0, device="cpu"))
    assert sorted(got) == sorted(want)
    for k in want:
        assert (tuple(got[k].shape), got[k].dtype) == \
            (tuple(want[k].shape), want[k].dtype), k
    assert {k.split("/")[-1] for k in got
            if got[k].dtype == torch.float32} == {"b_if", "b_gates"}


def test_params_and_checkpoint_from_jax_bitwise(tmp_path, monkeypatch, mesh):
    """JAX's xLSTM params (bf16, f32 biases) through params_from_jax, and a
    JAX-written TrainState through load_jax_checkpoint: every leaf's
    dtype and bits."""
    import repro.checkpoint.checkpoint as jck
    from repro_torch.convert import load_jax_checkpoint
    monkeypatch.setattr(jck, "zstandard", None)
    jcfg, tcfg = _configs("bfloat16")
    with set_mesh(mesh):
        jp = jmodel.init_params(jax.random.PRNGKey(3), jcfg, mesh)
    jflat = {}
    for bi, blk in enumerate(jp["blocks"]):
        for k, v in _flat(jax.tree.map(np.asarray, blk)).items():
            for sb in range(v.shape[0]):
                jflat[f"layers/{sb * len(jp['blocks']) + bi}/{k}"] = v[sb]
    tp = _flat(params_from_jax(_np_tree(jp), device="cpu"))
    for k, w in jflat.items():
        got = tp[k]
        assert str(got.dtype).split(".")[-1] == str(w.dtype)
        assert np.array_equal(_np(got.view(torch.int16) if got.dtype ==
                                  torch.bfloat16 else got),
                              w.view(np.int16) if w.dtype.name == "bfloat16"
                              else w), k
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
    for a, b in ((got.params, want.params), (got.opt.m, want.opt.m),
                 (got.opt.v, want.opt.v)):
        fa, fb = _flat(a), _flat(b)
        assert sorted(fa) == sorted(fb)
        for k in fb:
            if fb[k] is None:
                assert fa[k] is None
                continue
            assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k


def test_mesh_made_mamba_params_carry_across(refs):
    """jamba's smoke params made by JAX on a (1, 1, 2) mesh, whose model
    axis splits the Mamba weights' columns: params_from_jax gives every
    leaf's bits, in the port's layout, with the shapes of the port's own
    init_params."""
    flat = dict(np.load(refs / "mesh_params.npz"))
    sharded = json.loads(str(flat.pop("__sharded__")))
    assert any("w_x" in k for k in sharded)       # split over the devices
    jtree = _unflat(flat)
    tp = _flat(params_from_jax(jtree, device="cpu"))
    n_entries = len(jtree["blocks"])
    for k, w in flat.items():
        parts = k.split("/")
        if parts[0] != "blocks":
            assert np.array_equal(_np(tp[k]), w), k
            continue
        for sb in range(w.shape[0]):
            key = "/".join(["layers", str(sb * n_entries + int(parts[1]))]
                           + parts[2:])
            assert np.array_equal(_np(tp[key]), w[sb]), key
    mine = _flat(tmodel.init_params(get_smoke_config(
        "jamba-1.5-large-398b").replace(dtype="float32"), device="cpu"))
    assert sorted(mine) == sorted(tp)
    assert all(mine[k].shape == tp[k].shape for k in mine)


def _jax_mesh_params(out):
    import jax

    from repro.compat import set_mesh
    from repro.configs.registry import get_smoke_config as jsc
    from repro.launch.mesh import make_host_mesh
    from repro.models import model as jm
    from repro.runtime.params import param_shardings
    mesh = make_host_mesh(1, 1, 2)
    cfg = jsc("jamba-1.5-large-398b").replace(dtype="float32")

    def init(k):
        return jm.init_params(k, cfg, mesh)
    with set_mesh(mesh):
        shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
        p = jax.jit(init, out_shardings=param_shardings(shapes, mesh))(
            jax.random.PRNGKey(0))
    flat = _flat(p)
    sharded = [k for k, v in flat.items()
               if len(v.sharding.device_set) > 1
               and not v.sharding.is_fully_replicated]
    np.savez(out, __sharded__=json.dumps(sharded),
             **{k: np.asarray(v) for k, v in flat.items()})


# ------------------------------------------------------------ training --

def _jax_grads(out_path, dtype):
    import jax
    import jax.numpy as jnp

    from repro.compat import set_mesh
    from repro.configs.registry import get_smoke_config as jsc
    from repro.data.synthetic import SyntheticLMDataset as JData
    from repro.launch.mesh import make_host_mesh
    from repro.models import model as jm
    from repro.runtime import step as js
    cfg = jsc(ARCH).replace(dtype=dtype)
    mesh = make_host_mesh(1, 1, 1)
    batch = {k: jnp.asarray(v) for k, v in JData(cfg.vocab_size, 16, 2)
             .batch_at(0).items()}
    with set_mesh(mesh):
        params = jm.init_params(jax.random.PRNGKey(0), cfg, mesh)
        loss, _, grads = jax.jit(js.make_accum_grad_fn(cfg, mesh))(params,
                                                                  batch)
    np.savez(out_path, loss=np.asarray(loss), **{
        f"{pre}/{k}": np.asarray(v).view(np.uint16)
        if v.dtype == jnp.bfloat16 else np.asarray(v)
        for pre, tree in (("p", params), ("g", grads))
        for k, v in _flat(tree).items()})


@pytest.mark.parametrize("dtype,loss_tol,grad_tol", [
    ("float32", 1e-5, 1e-4), ("bfloat16", 1e-3, 2e-2)])
def test_train_step_matches_jax(refs, dtype, loss_tol, grad_tol):
    """The gradient half of the step: JAX's make_accum_grad_fn (in a
    subprocess with XLA's excess bf16 precision off, ROADMAP Queue 3: with
    it on XLA skips bf16 roundings inside fused chains that the port
    makes, and the bf16 gradients drift 7e-2 apart) against the port's
    loss_fn and autograd, from JAX's params."""
    ref = dict(np.load(refs / f"jax_grads_{dtype}.npz"))
    _, tcfg = _configs(dtype)

    def tree(pre):
        return params_from_jax(_unflat({
            k[2:]: v.view(jnp.bfloat16) if v.dtype == np.uint16 else v
            for k, v in ref.items() if k.startswith(pre)}), device="cpu")
    tparams = tree("p/")
    train = tadam.leaves(tparams)
    assert all(p.is_floating_point() for p in train)
    for p in train:
        p.requires_grad_(True)
    batch = SyntheticLMDataset(tcfg.vocab_size, 16, 2).batch_at(0)
    tloss, _ = tmodel.loss_fn(tparams, tcfg, tstep.batch_to_device(batch,
                                                                   CPU))
    tgrads = torch.autograd.grad(tloss, train)
    jg = tadam.leaves(tree("g/"))
    assert len(jg) == len(tgrads)
    worst = max(_rel_l2(_np(g.float()), _np(w.float()))
                for g, w in zip(tgrads, jg))
    loss_rel = abs(tloss.item() - float(ref["loss"])) / abs(float(
        ref["loss"]))
    print(f"xlstm smoke {dtype}: loss rel {loss_rel:.3g}, worst gradient "
          f"rel L2 {worst:.3g}")
    assert loss_rel < loss_tol and worst < grad_tol


def _jax_dp(tmp):
    import jax
    import jax.numpy as jnp

    from repro.compat import set_mesh
    from repro.configs import base as jb
    from repro.configs.registry import get_smoke_config as jsc
    from repro.data.synthetic import SyntheticLMDataset as JData
    from repro.launch.mesh import make_host_mesh
    from repro.models import model as jm
    from repro.runtime import step as js
    cfg = jsc(ARCH).replace(dtype="float32")
    opt = jb.OptimizerConfig(**OPT)
    mesh = make_host_mesh(DP_MESH[0], 1, DP_MESH[1])
    ds = JData(cfg.vocab_size, DP_SEQ, DP_BATCH)
    out = {}
    with set_mesh(mesh):
        params = jm.init_params(jax.random.PRNGKey(0), cfg, mesh)
        out.update({f"p0/{k}": np.asarray(v) for k, v in
                    _flat(params).items()})
        # the ranks start from these as soon as they are written
        np.savez(tmp / "dp_p0.part.npz", **out)
        os.replace(tmp / "dp_p0.part.npz", tmp / "dp_p0.npz")
        state = js.init_train_state(jax.random.PRNGKey(0), cfg, opt, mesh)
        step = jax.jit(js.make_train_step(cfg, opt, mesh))
        for s in range(DP_STEPS):
            state, m = step(state, {k: jnp.asarray(v)
                                    for k, v in ds.batch_at(s).items()})
            out[f"loss{s}"] = np.asarray(m["loss"])
    out.update({f"p/{k}": np.asarray(v) for k, v in
                _flat(state.params).items()})
    np.savez(tmp / "jax_dp.npz", **out)


def _port_dp(jax_out, out_path):
    from repro_torch.convert import gather_params, params_from_jax, \
        shard_params
    from repro_torch.optim.adam import adamw_init
    from repro_torch.runtime import params as tparams
    ref = dict(np.load(jax_out))
    cfg = get_smoke_config(ARCH).replace(dtype="float32")
    opt = tbase.OptimizerConfig(**OPT)
    mesh = tmesh.make_mesh(*DP_MESH)
    params = params_from_jax(_unflat({k[3:]: v for k, v in ref.items()
                                      if k.startswith("p0/")}), device=CPU)
    # the rank's FSDP shards over data (the dp_only profile's specs)
    specs = tparams.model_specs(cfg, mesh)
    params = shard_params(params, mesh, specs)
    state = tstep.TrainState(params, adamw_init(params, opt))
    step = tstep.make_train_step(cfg, opt, mesh=mesh)
    ds = SyntheticLMDataset(cfg.vocab_size, DP_SEQ, DP_BATCH)
    out = {}
    for s in range(DP_STEPS):
        state, m = step(state, tstep.batch_to_device(ds.batch_at(s), CPU))
        out[f"loss{s}"] = _np(m["loss"])
    out.update({f"p/{k}": _np(v) for k, v in _flat(
        gather_params(state.params, mesh, specs)).items()})
    np.savez(out_path, **out)


def test_dp_only_step_on_two_ranks_matches_jax(refs):
    ref = dict(np.load(refs / "jax_dp.npz"))
    port = [dict(np.load(refs / f"port_dp_{r}.npz")) for r in range(2)]
    for s in range(DP_STEPS):
        np.testing.assert_allclose(port[0][f"loss{s}"], ref[f"loss{s}"],
                                   rtol=1e-5)
    for k in port[0]:                   # the replicas stay bit-identical
        np.testing.assert_array_equal(port[1][k], port[0][k], err_msg=k)
    def tree(pre):
        return _flat(params_from_jax(_unflat(
            {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)}),
            device="cpu"))
    want, start = tree("p/"), tree("p0/")
    worst = max(np.linalg.norm(port[0][f"p/{k}"] - _np(w))
                / np.linalg.norm(_np(w) - _np(start[k]))
                for k, w in want.items())
    print(f"xlstm dp_only on 2 ranks: losses "
          f"{[float(port[0][f'loss{s}']) for s in range(DP_STEPS)]} / "
          f"{[float(ref[f'loss{s}']) for s in range(DP_STEPS)]}, worst "
          f"param difference over its update {worst:.3g}")
    assert worst < 5e-3


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


# ------------------------------------------------ on a model axis > 1 --

@pytest.mark.parametrize("name", list(MESH_CASES))
def test_mesh_train_step_matches_jax(refs, name):
    """The gradient half of a train step at (1, 2) (the heads split) and
    (1, 4) (2 heads over 4: the replicated forward) against JAX's on the
    same mesh, with tests/test_torch_tp.py's f32 bounds."""
    jax_out, port_out = (dict(np.load(refs / f"{who}_{name}.npz"))
                         for who in ("jax", "port"))
    print(f"xlstm smoke at {MESH_CASES[name][0]}: "
          + cases.check_train(jax_out, port_out, RTOL, 1e-4))


@pytest.mark.parametrize("name", list(MESH_CASES))
def test_mesh_decode_matches_jax(refs, name):
    """Teacher-forced decode on the state of JAX's decode_state_specs:
    the mLSTM state by heads at (1, 2), by its first head-dimension
    index at (1, 4), the sLSTM state by width at both."""
    shape, over = MESH_CASES[name]
    jax_out, port_out = (dict(np.load(refs / f"{who}_{name}.npz"))
                         for who in ("jax", "port"))
    layout = json.loads(str(port_out["layout"]))
    assert (layout["mlstm_split"], layout["mlstm_axes"],
            layout["slstm_axes"]) == ("heads" if name == "1x2" else "dh",
                                      ["model"], ["model"])
    cfg = cases.case_cfg(tregistry, ARCH, over)
    print(f"xlstm smoke at {shape}: "
          + cases.check_decode(cfg, jax_out, port_out, RTOL))


# --------------------------------- the JAX subprocess and the gloo ranks --

def _jax_main(tmp):
    """Every JAX reference of this file, in one process."""
    tmp = Path(tmp)
    _jax_dp(tmp)
    _jax_mesh_params(tmp / "mesh_params.npz")
    for dtype in DTYPES:
        _jax_grads(tmp / f"jax_grads_{dtype}.npz", dtype)
    for name, (shape, over) in MESH_CASES.items():
        cases.jax_case(tmp, name, ARCH, shape, over)


def _port_main(rank, world, args):
    tmp = Path(args[0])
    for name, (shape, over) in MESH_CASES.items():
        if shape[0] * shape[1] == world:
            cases.port_case(tmp, name, ARCH, shape, over, rank)
    if world == math.prod(DP_MESH):
        deadline = time.monotonic() + 900
        while not (tmp / "dp_p0.npz").exists():
            if time.monotonic() > deadline:
                raise TimeoutError("no JAX params for the dp_only step")
            time.sleep(0.05)
        _port_dp(tmp / "dp_p0.npz", tmp / f"port_dp_{rank}.npz")
    return 0


def _write_inputs(tmp):
    for name, (_, over) in MESH_CASES.items():
        cases.write_inputs(tmp, name, ARCH, over)


@pytest.fixture(scope="module", autouse=True)
def _background(request, tmp_path_factory):
    """With the file's first test: the JAX subprocess (four forced host
    devices, XLA's excess bf16 precision off) and the gloo ranks, 2 and
    4 at once."""
    yield from cases.background(
        request, tmp_path_factory, HERE, 4, (2, 4), _write_inputs,
        "--xla_allow_excess_precision=false")


@pytest.fixture(scope="module")
def refs(_background):
    return _background.wait()


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_main(sys.argv[2])
    else:                                   # RANK WORLD STORE args...
        sys.exit(tmesh.run_cpu_rank(sys.argv[1:], _port_main))
