"""whisper-base's encoder-decoder stack in the port against the JAX
package on the CPU, and the six new archs' configs and launchers.

- whisper-base's smoke config through test_torch_archs.py's four checks
  (forward, loss and gradients, one train step, four decode steps with
  the cross caches at zero), f32 and bf16, with that file's bounds.
- The encoder alone (``_encode``: frames plus the sinusoid, the
  bidirectional stack, the final norm) and one cross-attention layer
  alone (queries from x [2, 12, 64], keys and values from encoder states
  [2, 20, 64]: chunks of 8, so JAX pads and masks its last chunk where the
  port takes a short one), output and every gradient within 1e-5 relative
  L2 in f32 (measured at most 7.2e-7); ``decode_attention(cross=True)``
  over a cache of random encoder keys and values within 1e-5 (3.4e-7),
  writing nothing to it.
- A JAX whisper checkpoint (zlib shards; its ``zstandard`` hidden) restored
  by ``load_jax_checkpoint``, leaf for leaf the bits of
  ``state_from_jax`` (the encoder's stack and the cross-attention leaves
  included), and the port's save of it read back by the JAX package, bit
  for bit.
- whisper's smoke config with tensor parallelism on at (1, 2)
  (tests/_torch_mesh_cases.py: two gloo ranks against JAX on two forced
  host devices, started with the file's first test): the loss within
  1e-5 relative and every gradient leaf within 1e-4 relative L2 of JAX's
  on the same mesh; 4 teacher-forced decode steps over caches split by
  sequence, the logits within 1e-5 relative L2 of JAX's and of the
  port's mesh-free decode, each state leaf's shape on a rank JAX's shard
  shape.
- An encoder-decoder forward without frames raises a ValueError (in
  pipeline stages it raises NotImplementedError:
  tests/test_torch_hybrid.py).
- For all six archs: the configs and param counts equal JAX's,
  ``init_params`` gives JAX's leaves, shapes and dtypes (``encoder`` and
  ``cross`` leaves for whisper-base alone); the serve CLI decodes each on
  the CPU, the train CLI trains the five decoder-only ones (internvl2-26b
  on text, as the JAX launcher does) and raises a ValueError that names
  the missing frames for whisper-base.
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

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import _torch_mesh_cases as cases  # noqa: E402
import test_torch_archs as archs  # noqa: E402
from repro.compat import set_mesh  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.configs.registry import get_smoke_config as j_smoke  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.runtime import step as jstep  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.optim import adam as tadam  # noqa: E402

ARCH = "whisper-base"
ARCHS = archs.ARCHS
RTOL = 1e-5
MESH = (1, 2)


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


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _np(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else x, np.float32)


# ------------------------------------------- whisper's smoke parity --

@pytest.fixture(scope="module")
def jax_run(mesh):
    return lambda arch, dtype: archs.jax_reference(mesh, arch, dtype)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("check", ["forward_matches_jax",
                                   "loss_and_gradients_match_jax",
                                   "train_step_params_match_jax",
                                   "decode_matches_jax"])
def test_whisper_matches_jax(jax_run, check, dtype):
    getattr(archs, f"check_{check}")(jax_run(ARCH, dtype), ARCH, dtype)


def test_encoder_matches_jax(mesh):
    jcfg = j_smoke(ARCH).replace(dtype="float32")
    tcfg = get_smoke_config(ARCH).replace(dtype="float32")
    with set_mesh(mesh):
        jp = jmodel.init_params(jax.random.PRNGKey(1), jcfg, mesh)
    rng = np.random.default_rng(1)
    frames = rng.standard_normal((2, 24, jcfg.d_model)).astype(np.float32)
    ct = rng.standard_normal(frames.shape).astype(np.float32)
    with set_mesh(mesh):
        y, vjp = jax.vjp(lambda p, f: jmodel._encode(p, jcfg, mesh, f),
                         jp, jnp.asarray(frames))
        jgp, jgf = vjp(jnp.asarray(ct))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    enc = tadam.leaves(tp["encoder"])
    for t in enc:
        t.requires_grad_(True)
    tf = torch.from_numpy(frames).requires_grad_(True)
    ty = tmodel._encode(tp, tcfg, tf)
    grads = torch.autograd.grad(ty, enc + [tf],
                                grad_outputs=torch.from_numpy(ct))
    want = tadam.leaves(params_from_jax(
        jax.tree.map(np.asarray, jgp), device="cpu")["encoder"])
    pairs = [(ty, y)] + list(zip(grads, want + [jgf]))
    worst = max(_rel_l2(_np(a), _np(b)) for a, b in pairs)
    print(f"whisper smoke encoder: output and gradients, worst rel L2 "
          f"{worst:.3g}")
    assert worst <= RTOL


def test_cross_attention_layer_matches_jax():
    d, nh, dh = 64, 4, 16
    jp = jattn.attention_init(jax.random.PRNGKey(2), d, nh, nh, dh,
                              jnp.float32)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 12, d)).astype(np.float32)
    enc = rng.standard_normal((2, 20, d)).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    kw = dict(num_heads=nh, num_kv_heads=nh, head_dim=dh, rope_theta=1e4,
              causal=False, kv_chunk=8, use_rope=False)
    y, vjp = jax.vjp(lambda p, a, b: jattn.attention_apply(p, a, kv_x=b,
                                                           **kw),
                     jp, jnp.asarray(x), jnp.asarray(enc))
    jg = vjp(jnp.asarray(ct))
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
          for k, v in jp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    te = torch.from_numpy(enc).requires_grad_(True)
    ty = tattn.attention_apply(tp, tx, kv_x=te, **kw)
    keys = sorted(tp)
    grads = torch.autograd.grad(ty, [tp[k] for k in keys] + [tx, te],
                                grad_outputs=torch.from_numpy(ct))
    want = [jg[0][k] for k in keys] + [jg[1], jg[2]]
    worst = max(_rel_l2(_np(a), _np(b)) for a, b in
                [(ty, y)] + list(zip(grads, want)))
    # one decode step over a cache of encoder keys and values
    cache = {"k": rng.standard_normal((2, 20, nh, dh)).astype(np.float32),
             "v": rng.standard_normal((2, 20, nh, dh)).astype(np.float32)}
    xd = x[:, :1]
    jy, jc = jattn.decode_attention(
        jp, jnp.asarray(xd), {k: jnp.asarray(v) for k, v in cache.items()},
        3, num_heads=nh, num_kv_heads=nh, head_dim=dh, rope_theta=1e4,
        use_rope=False, cross=True)
    tc = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    with torch.no_grad():
        dy, _ = tattn.decode_attention(
            {k: v.detach() for k, v in tp.items()}, torch.from_numpy(xd), tc,
            3, num_heads=nh, num_kv_heads=nh, head_dim=dh, rope_theta=1e4,
            use_rope=False, cross=True)
    dec = _rel_l2(_np(dy), _np(jy))
    for k in cache:                          # nothing written
        np.testing.assert_array_equal(tc[k].numpy(), cache[k])
    print(f"cross-attention layer: worst rel L2 {worst:.3g}; cross decode "
          f"{dec:.3g}")
    assert worst <= RTOL and dec <= RTOL


# ------------------------------------------------------ checkpoints --

def _numpy_template(tree):
    if tree is None:
        return None
    if hasattr(tree, "_fields"):
        return type(tree)(*[_numpy_template(v) for v in tree])
    if isinstance(tree, dict):
        return {k: _numpy_template(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy_template(v) for v in tree]
    if tree.dtype == torch.bfloat16:
        return tree.view(torch.int16).numpy().view(jnp.bfloat16)
    return tree.detach().numpy()


def _bits(x):
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def test_whisper_checkpoint_from_jax_and_back(tmp_path, monkeypatch, mesh):
    import repro.checkpoint.checkpoint as jck
    from repro_torch.checkpoint import checkpoint as ck
    from repro_torch.configs import base as tbase
    from repro_torch.convert import load_jax_checkpoint, state_from_jax
    from repro_torch.runtime import step as tstep
    monkeypatch.setattr(jck, "zstandard", None)
    jcfg, tcfg = j_smoke(ARCH), get_smoke_config(ARCH)
    opt = jbase.OptimizerConfig(moment_dtype="int8")
    rng = np.random.default_rng(4)

    def fill(a):
        if np.issubdtype(a.dtype, np.integer):
            return rng.integers(0, 4, a.shape).astype(a.dtype)
        return rng.standard_normal(a.shape).astype(a.dtype)

    with set_mesh(mesh):
        jstate = jax.tree.map(fill, jax.eval_shape(
            lambda k: jstep.init_train_state(k, jcfg, opt, mesh),
            jax.random.PRNGKey(0)))
    jck.save_checkpoint(str(tmp_path / "jax"), 1, jstate)
    want = state_from_jax(jstate, device="cpu")
    tpl = tstep.init_train_state(tcfg, tbase.OptimizerConfig(
        moment_dtype="int8"), seed=3, device="cpu")
    got, step, _ = load_jax_checkpoint(str(tmp_path / "jax"), tpl)
    assert step == 1
    fa = {k: x for k, x in ck._flatten(got)}
    fb = {k: x for k, x in ck._flatten(want)}
    assert set(fa) == set(fb)
    assert any("params/encoder/layers/#1/" in k for k in fb)
    assert any("/cross/wq" in k for k in fb)
    for k, x in fb.items():
        assert ck.dtype_name(fa[k]) == ck.dtype_name(x), k
        np.testing.assert_array_equal(_bits(fa[k]), _bits(x), err_msg=k)
    # and back: the port's save, read by the JAX package
    ck.save_checkpoint(str(tmp_path / "port"), 2, got)
    back, step, _ = jck.load_checkpoint(str(tmp_path / "port"),
                                        _numpy_template(got))
    assert step == 2
    flat = jck._flatten(back)
    assert set(flat) == set(fb)
    for k, v in flat.items():
        np.testing.assert_array_equal(_bits(v), _bits(fb[k]), err_msg=k)


# ------------------------------------------- on a model axis of 2 --

def test_mesh_train_step_matches_jax(refs):
    """whisper's smoke config with tensor parallelism on (``dp_only``
    off) at (1, 2): frames and tokens split by their sequences, the
    cross-attention gathering the encoder's output; the loss and every
    gradient leaf against JAX's on the same mesh."""
    jax_out, port_out = (dict(np.load(refs / f"{who}_1x2.npz"))
                         for who in ("jax", "port"))
    print("whisper smoke at (1, 2): "
          + cases.check_train(jax_out, port_out, RTOL, 1e-4))


def test_mesh_decode_matches_jax(refs):
    """Teacher-forced decode with the self- and cross-attention caches
    split by sequence over ``model`` (JAX's decode_state_specs)."""
    jax_out, port_out = (dict(np.load(refs / f"{who}_1x2.npz"))
                         for who in ("jax", "port"))
    layout = json.loads(str(port_out["layout"]))
    assert layout["seq_axes"] == ["model"] and layout["seq_blocks"] == 2
    cfg = cases.case_cfg(tregistry, ARCH, {})
    print("whisper smoke at (1, 2): "
          + cases.check_decode(cfg, jax_out, port_out, RTOL))


@pytest.fixture(scope="module", autouse=True)
def _background(request, tmp_path_factory):
    """With the file's first test: JAX on two forced host devices and two
    gloo ranks, at once."""
    yield from cases.background(
        request, tmp_path_factory, HERE, 2, (2,),
        lambda tmp: cases.write_inputs(tmp, "1x2", ARCH, {}))


@pytest.fixture(scope="module")
def refs(_background):
    return _background.wait()


def _port_main(rank, world, args):
    cases.port_case(Path(args[0]), "1x2", ARCH, MESH, {}, rank)
    return 0


# ------------------------------------------------------------ raises --

def test_encoder_decoder_forward_without_frames_raises():
    """(The pipeline staging's raise: tests/test_torch_hybrid.py's
    ``test_check_supported_raises_for_other_item7_archs``.)"""
    cfg = get_smoke_config(ARCH).replace(dtype="float32")
    params = tmodel.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="frames"):
        tmodel.forward(params, cfg, torch.zeros((1, 8), dtype=torch.long))


@pytest.mark.parametrize("arch", ARCHS)
def test_config_param_count_and_init_match_jax(arch, mesh):
    for jcfg, tcfg in ((j_get_config(arch), get_config(arch)),
                       (j_smoke(arch), get_smoke_config(arch))):
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert tbase.param_count(tcfg) == jbase.param_count(jcfg)
        tmodel.check_supported(tcfg)
    assert arch in ARCH_IDS
    jcfg, tcfg = j_smoke(arch), get_smoke_config(arch)
    with set_mesh(mesh):
        shapes = jax.eval_shape(lambda k: jmodel.init_params(k, jcfg, mesh),
                                jax.random.PRNGKey(0))
    want = _flat(params_from_jax(jax.tree.map(
        lambda a: np.zeros(a.shape, a.dtype), shapes), device="cpu"))
    got = _flat(tmodel.init_params(tcfg, seed=0, device="cpu"))
    assert sorted(got) == sorted(want)
    assert any(k.startswith("encoder/") for k in got) == tcfg.encoder_decoder
    assert any("/cross/" in k for k in got) == tcfg.encoder_decoder
    for k in want:
        assert (tuple(got[k].shape), got[k].dtype) == \
            (tuple(want[k].shape), want[k].dtype), k


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tree}


def _events(out):
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_and_train_cli_on_cpu(arch, capsys):
    from repro_torch.launch import serve, train
    assert serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--requests", "2", "--batch-slots", "2",
                       "--prompt-len", "3", "--gen", "2"]) == 0
    s = [e for e in _events(capsys.readouterr().out)
         if e["kind"] == "serve_summary"]
    assert len(s) == 1 and s[0]["tokens"] == 4 and s[0]["arch"] == arch
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
            "--batch", "2", "--seq", "16", "--log-every", "1"]
    if arch == "whisper-base":
        with pytest.raises(ValueError, match="frames"):
            train.main(argv)
        return
    assert train.main(argv) == 0
    steps = [e for e in _events(capsys.readouterr().out)
             if e["kind"] == "step"]
    assert [e["step"] for e in steps] == [0, 1]
    assert all(np.isfinite(e["loss"]) and e["skips"] == 0 for e in steps)


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        cases.jax_case(Path(sys.argv[2]), "1x2", ARCH, MESH, {})
    else:                                   # RANK WORLD STORE args...
        from repro_torch.launch import mesh as tmesh
        sys.exit(tmesh.run_cpu_rank(sys.argv[1:], _port_main))
