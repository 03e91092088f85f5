"""The port's Mamba-2 mixer (``repro_torch/models/ssm.py``) against the
JAX package's ``repro/models/ssm.py``, function for function, on the CPU
with seeded numpy inputs.

Tolerances, at f32: the SSD chunk scan's ``y`` and final state within
1e-5 relative L2, its gradients in ``xh``, ``dt``, ``a_log``, ``B`` and
``C`` against ``jax.grad`` within 1e-4 relative L2 (the two frameworks
sum the products and the cumsum in another order); the causal conv
within 1e-6 (four multiply-adds in the same order); ``mamba_apply`` and
eight ``mamba_decode`` steps, on params made by JAX and carried over with
``params_from_jax``, within 1e-5 relative L2 (outputs and states).

In bf16 each elementwise op rounds to bf16, as the JAX function's ops
say.  XLA on the CPU may keep a fused chain in f32 instead (its default
``--xla_allow_excess_precision=true``): a conv whose last add feeds the
f32 silu skips that add's rounding.  So the causal conv alone is held
bit-equal, and ``mamba_apply`` in bf16 twice: against JAX run in a
subprocess with ``--xla_allow_excess_precision=false``, bit-equal in all
but 0.1% of the elements (the scan's f32 sums, in another order, may move
a value across a bf16 rounding boundary; measured: all equal), and
against JAX as it runs by default within 2e-2 relative L2 (measured
5e-3; 35% of the elements bit-equal: the skipped roundings move about a
fifth of the conv's outputs by a bf16 step, and the scan, gate, norm and
output product spread them).  Decode in bf16 is held to the same 2e-2.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # parallel test workers share the cores
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs import base as jbase
from repro.models import ssm as jssm
from repro_torch.configs import base as tbase
from repro_torch.convert import params_from_jax
from repro_torch.models import ssm as tssm

CPU = torch.device("cpu")
HERE = Path(__file__).resolve()


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _f32(t):
    return t.detach().to(torch.float32).numpy()


def _scan_inputs(S, nh, dh=4, N=3, B=2, seed=0):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((B, S, nh, dh)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, nh)))).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 16.0, nh, dtype=np.float32))
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    ct_y = rng.standard_normal((B, S, nh, dh)).astype(np.float32)
    ct_h = rng.standard_normal((B, nh, dh, N)).astype(np.float32)
    return (xh, dt, a_log, Bm, Cm), ct_y, ct_h


@pytest.mark.parametrize("S,chunk,nh", [(8, 8, 1), (32, 8, 1), (32, 8, 4),
                                        (6, 8, 2)],
                         ids=["S=c", "S=4c", "S=4c-nh4", "S<c"])
def test_ssd_chunk_scan_matches_jax(S, chunk, nh):
    """y and the final state, and the gradients of sum(y * ct_y) +
    sum(h * ct_h) in every input; with S < chunk the chunk is S."""
    inputs, ct_y, ct_h = _scan_inputs(S, nh)

    def j_obj(*a):
        y, h = jssm._ssd_chunk_scan(*a, chunk)
        return jnp.sum(y * ct_y) + jnp.sum(h * ct_h), (y, h)

    (_, (jy, jh)), jg = jax.jit(jax.value_and_grad(
        j_obj, argnums=tuple(range(5)), has_aux=True))(
            *map(jnp.asarray, inputs))
    tin = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
    ty, th = tssm._ssd_chunk_scan(*tin, chunk)
    assert ty.dtype == torch.float32 and th.dtype == torch.float32
    assert tuple(ty.shape) == jy.shape and tuple(th.shape) == jh.shape
    assert _rel_l2(_f32(ty), jy) < 1e-5
    assert _rel_l2(_f32(th), jh) < 1e-5
    obj = (ty * torch.from_numpy(ct_y)).sum() + \
        (th * torch.from_numpy(ct_h)).sum()
    tg = torch.autograd.grad(obj, tin)
    for name, g, want in zip(("xh", "dt", "a_log", "B", "C"), tg, jg):
        assert np.isfinite(g.numpy()).all(), name
        assert _rel_l2(g.numpy(), want) < 1e-4, name


def test_ssd_chunk_scan_large_decay_stays_finite():
    """Long chunks with fast decay: the masked entries' exp(decay) would
    overflow without the min, and their backward would give NaN."""
    inputs, ct_y, ct_h = _scan_inputs(64, 2, seed=1)
    xh, dt, a_log, Bm, Cm = inputs
    dt = dt * 20.0                          # L spans thousands of nats
    tin = [torch.from_numpy(a).requires_grad_(True)
           for a in (xh, dt, a_log, Bm, Cm)]
    ty, th = tssm._ssd_chunk_scan(*tin, 64)
    g = torch.autograd.grad((ty * torch.from_numpy(ct_y)).sum()
                            + (th * torch.from_numpy(ct_h)).sum(), tin)
    assert all(bool(torch.isfinite(t).all()) for t in (ty, th, *g))
    jy, _ = jssm._ssd_chunk_scan(*map(jnp.asarray, (xh, dt, a_log, Bm, Cm)),
                                 64)
    assert _rel_l2(_f32(ty), jy) < 1e-5


def test_ssd_chunk_scan_recomputes_each_chunk():
    """With gradients on, the backward pass recomputes the chunk body
    (one more forward call a chunk), as jax.checkpoint does; without
    gradients the body runs once a chunk."""
    inputs, _, _ = _scan_inputs(32, 2)
    calls = []
    orig = tssm._chunk_body

    def spy(*a):
        calls.append(1)
        return orig(*a)

    tssm._chunk_body = spy
    try:
        with torch.no_grad():
            tssm._ssd_chunk_scan(*map(torch.from_numpy, inputs), 8)
        assert len(calls) == 4
        calls.clear()
        tin = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
        y, h = tssm._ssd_chunk_scan(*tin, 8)
        (y.sum() + h.sum()).backward()
        assert len(calls) == 8
    finally:
        tssm._chunk_body = orig


def test_softplus_is_jax_softplus():
    """No threshold at 20, unlike F.softplus's default.  XLA on the CPU
    flushes subnormal results to zero (x below about -87), hence the
    absolute bound of the smallest normal f32."""
    x = np.concatenate([np.linspace(-100, 100, 2001),
                        np.random.default_rng(3).standard_normal(500) * 30]
                       ).astype(np.float32)
    got = tssm.softplus(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=np.finfo(np.float32).tiny)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_jax(dtype):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 11, 24)).astype(np.float32)
    w = (rng.standard_normal((4, 24)) * 0.2).astype(np.float32)
    jd = jnp.dtype(dtype)
    jx, jw = jnp.asarray(x).astype(jd), jnp.asarray(w).astype(jd)
    want = np.asarray(jax.jit(jssm._causal_conv)(jx, jw).astype(jnp.float32))
    td = getattr(torch, dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(td)
    tw = torch.from_numpy(np.array(jw.astype(jnp.float32))).to(td)
    got = tssm._causal_conv(tx, tw)
    assert got.dtype == td
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_f32(got), want)
    else:
        np.testing.assert_allclose(_f32(got), want, atol=1e-6)


def _ssm_cfgs():
    kw = dict(d_state=8, head_dim=16, expand=2, conv_width=4, chunk_size=8)
    return jbase.SSMConfig(**kw), tbase.SSMConfig(**kw)


def _mixer_params(dtype, d_model=64, seed=0):
    """JAX's mamba_init, carried with params_from_jax (as one layer)."""
    jcfg, _ = _ssm_cfgs()
    jp = jssm.mamba_init(jax.random.PRNGKey(seed), d_model, jcfg,
                         jnp.dtype(dtype))
    # a nonzero dt_bias and a non-unit norm scale exercise both leaves
    jp["dt_bias"] = jnp.linspace(-1.0, 1.0, jp["dt_bias"].shape[0],
                                 dtype=jnp.float32)
    jp["norm"]["scale"] = (1.0 + 0.1 * jax.random.normal(
        jax.random.PRNGKey(seed + 1), jp["norm"]["scale"].shape)).astype(
            jnp.dtype(dtype))
    stacked = jax.tree.map(lambda a: np.asarray(a)[None], jp)
    tp = params_from_jax({"blocks": [{"mixer": stacked}]},
                         device="cpu")["layers"][0]["mixer"]
    return jp, tp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_params_from_jax_keep_f32_leaves(dtype):
    jp, tp = _mixer_params(dtype)
    for k in ("dt_bias", "a_log", "d_skip"):
        assert tp[k].dtype == torch.float32, k
    for k in ("w_z", "w_x", "w_b", "w_c", "w_dt", "conv_w", "w_out"):
        assert tp[k].dtype == getattr(torch, dtype), k
        np.testing.assert_array_equal(_f32(tp[k]), np.asarray(
            jp[k].astype(jnp.float32)))


def test_mamba_apply_matches_jax():
    jcfg, tcfg = _ssm_cfgs()
    jp, tp = _mixer_params("float32")
    x = np.random.default_rng(5).standard_normal((2, 24, 64)).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda p, x: jssm.mamba_apply(p, x, jcfg))(
        jp, jnp.asarray(x)))
    got = tssm.mamba_apply(tp, torch.from_numpy(x), tcfg)
    assert _rel_l2(_f32(got), want) < 1e-5


def _bf16_case():
    jcfg, tcfg = _ssm_cfgs()
    jp, tp = _mixer_params("bfloat16")
    x = np.random.default_rng(6).standard_normal((2, 24, 64)).astype(
        np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        torch.bfloat16)
    return jcfg, tcfg, jp, tp, jx, tx


def _jax_bf16_apply():
    jcfg, _, jp, _, jx, _ = _bf16_case()
    return np.asarray(jax.jit(lambda p, x: jssm.mamba_apply(p, x, jcfg))(
        jp, jx).astype(jnp.float32))


@pytest.mark.parametrize("excess_precision", [False, True])
def test_mamba_apply_bf16_rounds_as_jax(tmp_path, excess_precision):
    _, tcfg, _, tp, _, tx = _bf16_case()
    got = tssm.mamba_apply(tp, tx, tcfg)
    assert got.dtype == torch.bfloat16
    if excess_precision:
        want = _jax_bf16_apply()
    else:
        out = tmp_path / "want.npy"
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_allow_excess_precision=false",
                   PYTHONPATH=str(HERE.parents[1] / "src"))
        res = subprocess.run([sys.executable, str(HERE), "jax-bf16",
                              str(out)], env=env, capture_output=True,
                             text=True, timeout=300)
        assert res.returncode == 0, res.stderr
        want = np.load(out)
    g = _f32(got)
    rel, same = _rel_l2(g, want), float(np.mean(g == want))
    print(f"bf16 mamba_apply, XLA excess precision {excess_precision}: rel "
          f"L2 {rel:.3g}, {same:.4f} of the elements bit-equal")
    if excess_precision:
        assert rel < 2e-2
    else:
        assert same >= 0.999 and rel < 1e-3


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_mamba_decode_matches_jax(dtype, tol):
    """Eight steps from the zero state: each output and the final state
    (h in f32, the conv buffer in the model dtype)."""
    jcfg, tcfg = _ssm_cfgs()
    jp, tp = _mixer_params(dtype)
    jd = jnp.dtype(dtype)
    x = jnp.asarray(np.random.default_rng(7).standard_normal(
        (3, 8, 64)).astype(np.float32)).astype(jd)
    tx = torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        getattr(torch, dtype))
    js = jssm.init_mamba_state(3, 64, jcfg, jd)
    ts = tssm.init_mamba_state(3, 64, tcfg, getattr(torch, dtype), CPU)
    assert ts["h"].dtype == torch.float32
    assert ts["conv"].dtype == getattr(torch, dtype)
    step = jax.jit(lambda p, x, s: jssm.mamba_decode(p, x, s, jcfg))
    for i in range(8):
        jy, js = step(jp, x[:, i:i + 1], js)
        ty, ts = tssm.mamba_decode(tp, tx[:, i:i + 1], ts, tcfg)
        assert _rel_l2(_f32(ty), np.asarray(jy.astype(jnp.float32))) < tol
    assert _rel_l2(_f32(ts["h"]), np.asarray(js["h"])) < tol
    assert _rel_l2(_f32(ts["conv"]),
                   np.asarray(js["conv"].astype(jnp.float32))) < tol


def test_mamba_init_leaves_as_jax():
    """The port's own init: JAX's leaves, shapes and dtypes, f32 dt_bias,
    a_log and d_skip in a bf16 model, a_log = log(linspace(1, 16, nh))."""
    jcfg, tcfg = _ssm_cfgs()
    jp = jssm.mamba_init(jax.random.PRNGKey(0), 64, jcfg, jnp.bfloat16)
    tp = tssm.mamba_init(torch.Generator().manual_seed(0), 64, tcfg,
                         torch.bfloat16, CPU)
    assert list(tp) == list(jp)
    for k in jp:
        a, b = (jp[k]["scale"], tp[k]["scale"]) if k == "norm" \
            else (jp[k], tp[k])
        assert tuple(b.shape) == a.shape, k
        assert str(b.dtype).split(".")[-1] == str(a.dtype), k
    # the same formula; XLA's log and linspace differ in the last bit
    np.testing.assert_allclose(tp["a_log"].numpy(), np.asarray(jp["a_log"]),
                               rtol=1e-6)


if __name__ == "__main__":
    assert sys.argv[1] == "jax-bf16"
    np.save(sys.argv[2], _jax_bf16_apply())
