"""The dense and patch-prefix architectures (granite-8b, nemotron-4-15b,
phi3-mini-3.8b, smollm-360m, internvl2-26b) in the port against the JAX
package, on the CPU, at their smoke configs; the checks are shared with
tests/test_torch_encdec.py, which runs them for whisper-base.

Inputs are numpy arrays from a seeded generator, shaped as
tests/test_archs_smoke.py makes them: [2, 16] positions, internvl2-26b's
4 of them patch embeddings before 12 tokens, whisper-base's encoder over
16 frames.  Params are JAX's, carried with ``params_from_jax``.  JAX runs
in this process with its default flags, once an (arch, dtype) (one jit of
the loss, its gradients and AdamW, one of the decode step), shared by the
tests through a module-scoped cache.

Bounds (relative L2 unless said), f32 / bf16, with the worst of the six
archs measured:
- forward logits: 1e-5 / 3e-2 (7.8e-7 / 9.0e-3);
- loss: 1e-5 / 1e-3 relative (2.9e-7 / 2.6e-4); every gradient leaf:
  1e-4 / 3e-2 (1.5e-6 / 1.6e-2).  In bf16 XLA keeps excess f32
  precision inside its fused chains where the port rounds each op to
  bf16 (ROADMAP Queue 3; with ``--xla_allow_excess_precision=false``
  granite-8b's bf16 logits come within 4.3e-4), and whisper's GELU is
  torch's, which rounds once;
- one train step (``make_train_step``, AdamW, lr 1e-3, no warm-up)
  against JAX's ``apply_gradients`` on its gradients, each param leaf's
  distance from JAX's over the norm of JAX's update to it: 5e-3 / 0.3
  (9.8e-4 / 0.21).  AdamW's first step moves an element by about
  lr * sign(g), so a gradient element near zero whose last bits differ
  moves another way, and in bf16 the gradients differ by the 1.6e-2
  above and a bf16 param rounds its 1e-3 step to whole ulps; the
  optimizer alone, the port's ``apply_gradients`` on JAX's gradients,
  within 1e-4 in both (4.9e-5);
- four decode steps against JAX's ``decode_step``: logits within 1e-5 /
  3e-2 (5.7e-7 / 9.0e-3), whisper's with its cross caches at zero, as
  JAX's state holds them.
- granite-8b's teacher-forced decode against its own forward: 16 steps
  within 1e-3 absolute in f32 (3.6e-6; the counterpart of
  tests/test_archs_smoke.py's ``test_decode_matches_forward``).
- The sinusoid table [8192, d] against JAX's ``_sinusoidal`` within 2e-3
  absolute: the angles reach 8191 rad, where one f32 ulp is 4.9e-4, and
  the two frameworks' f32 ``pow`` may differ by an ulp (measured: 2.4e-7
  at d = 512, 9.8e-4 at d = 1536; 5-7% of the elements differ).
"""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # parallel test workers share the cores
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

HERE = Path(__file__).resolve()
SRC = HERE.parents[1] / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

from repro.compat import set_mesh  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.configs.registry import get_smoke_config as j_smoke  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim.adam import adamw_init as j_adamw_init  # noqa: E402
from repro.runtime import step as jstep  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.optim import adam as tadam  # noqa: E402
from repro_torch.runtime import step as tstep  # noqa: E402

ARCHS = ("granite-8b", "nemotron-4-15b", "phi3-mini-3.8b", "smollm-360m",
         "internvl2-26b", "whisper-base")
DTYPES = ("float32", "bfloat16")
B, S, DECODE_STEPS = 2, 16, 4
OPT = dict(lr=1e-3, warmup_steps=0, total_steps=10)
CPU = torch.device("cpu")
DECODER_ARCHS = ARCHS[:5]            # whisper-base's: test_torch_encdec.py
BOUNDS = {"float32": dict(logits=1e-5, loss=1e-5, grads=1e-4, step=5e-3,
                          tail=1e-4, decode=1e-5),
          "bfloat16": dict(logits=3e-2, loss=1e-3, grads=3e-2, step=0.3,
                           tail=1e-4, decode=3e-2)}


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def batch_for(cfg, seed=0, batch=B, seq=S):
    """tokens / labels [batch, seq - P] int32 with P patch embeddings
    before them (the patch frontend), or frames [batch, seq, d] (the
    encoder's input); f32 numpy, from a seeded generator."""
    rng = np.random.default_rng(seed)
    P = cfg.num_patches if cfg.frontend == "patch_stub" else 0
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq - P))
           .astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (batch, seq - P))
           .astype(np.int32)}
    if P:
        out["patch_embeds"] = rng.standard_normal(
            (batch, P, cfg.d_model)).astype(np.float32)
    if cfg.encoder_decoder:
        out["frames"] = rng.standard_normal(
            (batch, seq, cfg.d_model)).astype(np.float32)
    return out


def _leaves_t(tree):
    """A JAX tree's leaves in the port's layout and order, as tensors."""
    return tadam.leaves(params_from_jax(jax.tree.map(np.asarray, tree),
                                        device="cpu"))


_RUNS = {}


def jax_reference(mesh, arch, dtype):
    """JAX's params, logits, loss, gradients, params after one AdamW step
    and decode logits for (arch, dtype), computed once a process."""
    if (arch, dtype) not in _RUNS:
        _RUNS[arch, dtype] = _jax(mesh, arch, dtype)
    return _RUNS[arch, dtype]


@pytest.fixture(scope="module")
def jax_run(mesh):
    return lambda arch, dtype: jax_reference(mesh, arch, dtype)


def _jax(mesh, arch, dtype):
    cfg = j_smoke(arch).replace(dtype=dtype)
    batch = {k: jnp.asarray(v) for k, v in batch_for(cfg).items()}
    opt = jbase.OptimizerConfig(**OPT)

    def lf(p, b):
        logits, stats = jmodel.forward(p, cfg, mesh, b)
        loss, _ = jmodel.loss_from_logits(cfg, logits, stats, b)
        return loss, logits

    def step(p, b):
        (loss, logits), grads = jax.value_and_grad(lf, has_aux=True)(p, b)
        state = jstep.TrainState(p, j_adamw_init(p, opt))
        stepped, _ = jstep.apply_gradients(state, opt, loss, {}, grads)
        return loss, logits, grads, stepped

    with set_mesh(mesh):
        params = jmodel.init_params(jax.random.PRNGKey(0), cfg, mesh)
        loss, logits, grads, stepped = jax.jit(step)(params, batch)
        dstate = jmodel.init_decode_state(cfg, B, DECODE_STEPS, mesh)
        dstep = jax.jit(lambda p, s, t: jmodel.decode_step(p, cfg, mesh, s,
                                                           t))
        dec = []
        for i in range(DECODE_STEPS):
            out, dstate = dstep(params, dstate, batch["tokens"][:, i:i + 1])
            dec.append(np.asarray(out))
    return dict(params=jax.tree.map(np.asarray, params),
                logits=np.asarray(logits), loss=float(loss),
                grads=_leaves_t(grads),
                stepped=[_np(t) for t in _leaves_t(stepped.params)],
                decode=np.concatenate(dec, 1))


def _port(arch, dtype, ref):
    cfg = get_smoke_config(arch).replace(dtype=dtype)
    params = params_from_jax(ref["params"], device="cpu")
    batch = tstep.batch_to_device(batch_for(cfg), CPU)
    return cfg, params, batch


# ------------------------------------------------------ the six archs --

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_forward_matches_jax(jax_run, arch, dtype):
    check_forward_matches_jax(jax_run(arch, dtype), arch, dtype)


def check_forward_matches_jax(ref, arch, dtype):
    cfg, params, batch = _port(arch, dtype, ref)
    with torch.no_grad():
        logits, _ = tmodel.forward(params, cfg, batch["tokens"],
                                   **tmodel._inputs(cfg, batch))
    assert logits.shape == ref["logits"].shape == (B, S, cfg.vocab_size)
    rel = _rel_l2(_np(logits), ref["logits"])
    print(f"{arch} {dtype}: forward logits rel L2 {rel:.3g}")
    assert np.isfinite(_np(logits)).all() and rel <= BOUNDS[dtype]["logits"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_loss_and_gradients_match_jax(jax_run, arch, dtype):
    check_loss_and_gradients_match_jax(jax_run(arch, dtype), arch, dtype)


def check_loss_and_gradients_match_jax(ref, arch, dtype):
    cfg, params, batch = _port(arch, dtype, ref)
    train = tadam.leaves(params)
    for p in train:
        p.requires_grad_(True)
    loss, metrics = tmodel.loss_fn(params, cfg, batch)
    grads = torch.autograd.grad(loss, train)
    assert len(grads) == len(ref["grads"])
    worst = max(_rel_l2(_np(g), _np(w)) for g, w in zip(grads,
                                                         ref["grads"]))
    loss_rel = abs(loss.item() - ref["loss"]) / abs(ref["loss"])
    print(f"{arch} {dtype}: loss {loss.item()} / {ref['loss']} (rel "
          f"{loss_rel:.3g}), worst gradient rel L2 {worst:.3g}")
    assert loss_rel <= BOUNDS[dtype]["loss"]
    assert worst <= BOUNDS[dtype]["grads"]


def _update_distance(got, want, start):
    """The worst leaf's distance from JAX's params over the norm of JAX's
    update to it; a leaf JAX left alone must be equal."""
    worst = 0.0
    for g, w, s0 in zip(got, want, start):
        moved = np.linalg.norm(w.astype(np.float64) - s0)
        if moved:
            worst = max(worst, np.linalg.norm(g.astype(np.float64) - w)
                        / moved)
        else:
            np.testing.assert_array_equal(g, w)
    return worst


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_train_step_params_match_jax(jax_run, arch, dtype):
    check_train_step_params_match_jax(jax_run(arch, dtype), arch, dtype)


def check_train_step_params_match_jax(ref, arch, dtype):
    cfg, params, batch = _port(arch, dtype, ref)
    start = [_np(p).copy() for p in tadam.leaves(params)]
    opt = tbase.OptimizerConfig(**OPT)
    state = tstep.TrainState(params, tadam.adamw_init(params, opt))
    state, metrics = tstep.make_train_step(cfg, opt)(state, batch)
    assert int(metrics["grad_skips"]) == 0
    step = _update_distance([_np(p) for p in tadam.leaves(state.params)],
                            ref["stepped"], start)
    # the optimizer tail alone, on JAX's gradients
    _, params, _ = _port(arch, dtype, ref)
    state = tstep.TrainState(params, tadam.adamw_init(params, opt))
    state, _ = tstep.apply_gradients(
        state, opt, torch.tensor(ref["loss"]), {},
        [g.clone() for g in ref["grads"]])
    tail = _update_distance([_np(p) for p in tadam.leaves(state.params)],
                            ref["stepped"], start)
    print(f"{arch} {dtype}: one step, worst param distance over JAX's "
          f"update {step:.3g}; AdamW on JAX's gradients {tail:.3g}")
    assert step <= BOUNDS[dtype]["step"] and tail <= BOUNDS[dtype]["tail"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_decode_matches_jax(jax_run, arch, dtype):
    check_decode_matches_jax(jax_run(arch, dtype), arch, dtype)


def check_decode_matches_jax(ref, arch, dtype):
    cfg, params, batch = _port(arch, dtype, ref)
    state = tmodel.init_decode_state(cfg, B, DECODE_STEPS, device="cpu")
    if cfg.encoder_decoder:
        assert all(set(c) == {"k", "v", "cross_k", "cross_v"}
                   for c in state["layers"])
    outs = []
    for i in range(DECODE_STEPS):
        logits, state = tmodel.decode_step(params, cfg, state,
                                           batch["tokens"][:, i:i + 1])
        outs.append(_np(logits))
    got = np.concatenate(outs, 1)
    rel = _rel_l2(got, ref["decode"])
    print(f"{arch} {dtype}: {DECODE_STEPS} decode steps, logits rel L2 "
          f"{rel:.3g}")
    assert rel <= BOUNDS[dtype]["decode"]


# ---------------------------------------------------------- the rest --

def test_granite_decode_matches_forward():
    cfg = get_smoke_config("granite-8b").replace(dtype="float32")
    params = tmodel.init_params(cfg, seed=3, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(2, 16))).long()
    with torch.no_grad():
        full, _ = tmodel.forward(params, cfg, tokens)
    state = tmodel.init_decode_state(cfg, 2, 16, device="cpu")
    outs = []
    for i in range(16):
        logits, state = tmodel.decode_step(params, cfg, state,
                                           tokens[:, i:i + 1])
        outs.append(logits)
    err = float((torch.cat(outs, 1) - full).abs().max())
    print(f"granite-8b smoke decode against forward: max |diff| {err:.3g}")
    assert err < 1e-3


@pytest.mark.parametrize("d", [512, 1536])
def test_sinusoid_table_matches_jax(d):
    want = np.asarray(jmodel._sinusoidal(tlayers.DECODE_TABLE, d))
    got = tlayers.sinusoidal(tlayers.DECODE_TABLE, d).numpy()
    assert got.dtype == np.float32
    err = np.abs(got - want).max()
    print(f"sinusoid [8192, {d}]: max |diff| {err:.3g}, "
          f"{(got != want).mean():.3g} of the elements differ")
    assert err <= 2e-3
    rows = tlayers.sinusoid_rows(8000, 192, d, CPU)
    np.testing.assert_array_equal(rows.numpy(), got[8000:])
