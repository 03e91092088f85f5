"""Teacher-forced decoding of the granite-moe-3b-a800m smoke config in the
port against the JAX package, on params initialised by JAX and converted
with ``params_from_jax``; and the port's serve loop on the CPU.

Tolerance: logits within atol 1e-4 at f32 (the two frameworks sum the
matrix products and the softmax in another order), and equal greedy
tokens at every step.  The layers are also held in bf16, so that each
rounds where the JAX package's does (f32 norms and RoPE, silu in f32 cast
back before the product, a bf16 head product widened after): at most 1%
of the elements may differ, by one bf16 rounding, where a matrix product
sums in another order; a rounding step in the wrong place moves about
half of them or more.
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
from repro.configs.base import ATTN, DENSE, MOE
from repro.configs.registry import get_smoke_config as j_smoke_config
from repro.core import moe as jmoe
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch.configs import base as tbase
from repro_torch.configs.registry import get_smoke_config
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.core import moe as tmoe
from repro_torch.launch import serve
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel

ARCH = "granite-moe-3b-a800m"
STEPS = 8
B = 2


def _configs(dtype="float32", two_entry=False, backend="reference"):
    jcfg = j_smoke_config(ARCH).replace(dtype=dtype)
    jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe,
                                                kernel_backend=backend))
    tcfg = get_smoke_config(ARCH).replace(dtype=dtype)
    if two_entry:
        jcfg = jcfg.replace(layout=((ATTN, MOE), (ATTN, DENSE)))
        tcfg = tcfg.replace(layout=((tbase.ATTN, tbase.MOE),
                                    (tbase.ATTN, tbase.DENSE)))
    return jcfg, tcfg


def _decode_both(mesh, jcfg, tcfg):
    with set_mesh(mesh):
        params = jmodel.init_params(jax.random.PRNGKey(0), jcfg, mesh)
        tokens = np.random.default_rng(0).integers(
            0, jcfg.vocab_size, size=(B, STEPS)).astype(np.int32)
        state = jmodel.init_decode_state(jcfg, B, STEPS, mesh)
        step = jax.jit(lambda p, s, t: jmodel.decode_step(p, jcfg, mesh, s,
                                                          t))
        jl = []
        for i in range(STEPS):
            logits, state = step(params, state,
                                 jnp.asarray(tokens[:, i:i + 1]))
            jl.append(np.asarray(logits))
    tparams = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    tstate = tmodel.init_decode_state(tcfg, B, STEPS, device="cpu")
    tl = []
    for i in range(STEPS):
        logits, tstate = tmodel.decode_step(
            tparams, tcfg, tstate, torch.from_numpy(tokens[:, i:i + 1]).long())
        tl.append(logits.numpy())
    assert tstate["position"] == STEPS
    return np.concatenate(jl, 1), np.concatenate(tl, 1)


@pytest.mark.parametrize("backend", ["reference", "pallas_interpret"])
def test_decode_matches_jax(mesh, backend):
    jcfg, tcfg = _configs(backend=backend)
    want, got = _decode_both(mesh, jcfg, tcfg)
    assert got.shape == (B, STEPS, jcfg.vocab_size)
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_decode_two_entry_layout_matches_jax(mesh):
    """A layout of two entries pins the block order (super-block major,
    layout interleaved) through params_from_jax, and the dense FFN."""
    jcfg, tcfg = _configs(two_entry=True)
    want, got = _decode_both(mesh, jcfg, tcfg)
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_params_from_jax_bf16_and_order(mesh):
    """bf16 leaves arrive bit-exact (compared in f32), and layer
    sb * len(layout) + i is layout entry i of super-block sb."""
    jcfg, _ = _configs(dtype="bfloat16", two_entry=True)
    params = jmodel.init_params(jax.random.PRNGKey(1), jcfg, mesh)
    np_params = jax.tree.map(np.asarray, params)
    tp = params_from_jax(np_params, device="cpu")
    assert len(tp["layers"]) == jcfg.num_layers == 4
    for sb in range(jcfg.num_super_blocks):
        for i, (_, ffn) in enumerate(jcfg.layout):
            layer = tp["layers"][sb * 2 + i]
            want = np_params["blocks"][i]["mixer"]["wq"][sb]
            assert layer["mixer"]["wq"].dtype == torch.bfloat16
            np.testing.assert_array_equal(
                layer["mixer"]["wq"].float().numpy(),
                want.astype(np.float32))
            assert ("router_w" in layer["ffn"]) == (ffn == MOE)
    np.testing.assert_array_equal(
        tp["head"]["w"].float().numpy(),
        np_params["head"]["w"].astype(np.float32))


def test_serve_smoke_on_cpu(capsys):
    assert serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--requests", "3", "--batch-slots", "2",
                       "--prompt-len", "3", "--gen", "2"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    summary = [ev for ev in lines if ev["kind"] == "serve_summary"]
    assert len(summary) == 1
    s = summary[0]
    assert s["requests"] == 3 and s["tokens"] == 3 * 2
    assert s["tokens_per_s"] > 0
    assert 0 < s["latency_p50_s"] <= s["latency_p99_s"]
    assert sum(ev["kind"] == "serve_request" for ev in lines) == 3


def _bf16_pair(rng, shape, scale=1.0):
    """The same bf16 values as a JAX array and a torch tensor."""
    j = jnp.asarray(rng.standard_normal(shape).astype(np.float32)
                    * scale).astype(jnp.bfloat16)
    return j, tensor_from_numpy(np.asarray(j), torch.device("cpu"))


@pytest.mark.parametrize("layer", ["rmsnorm", "rope", "swiglu_mlp",
                                   "expert_mlp", "head", "unembed"])
def test_layers_round_as_jax_in_bf16(layer):
    rng = np.random.default_rng(7)
    xj, xt = _bf16_pair(rng, (4, 3, 96), 3.0)
    if layer == "rmsnorm":
        sj, st = _bf16_pair(rng, (96,))
        want = jlayers.rmsnorm({"scale": sj}, xj)
        got = tlayers.rmsnorm({"scale": st}, xt)
    elif layer == "rope":
        qj, qt = _bf16_pair(rng, (2, 5, 4, 24))
        pos = (np.arange(10).reshape(2, 5) * 37).astype(np.int32)
        want = jlayers.apply_rope(qj, jnp.asarray(pos), 10000.0)
        got = tlayers.apply_rope(qt, torch.from_numpy(pos), 10000.0)
    elif layer == "swiglu_mlp":
        w = {k: _bf16_pair(rng, shape, 0.1) for k, shape in (
            ("w_up", (96, 64)), ("w_gate", (96, 64)), ("w_down", (64, 96)))}
        want = jlayers.mlp_apply({k: v[0] for k, v in w.items()}, xj,
                                 "swiglu")
        got = tlayers.mlp_apply({k: v[1] for k, v in w.items()}, xt,
                                "swiglu")
    elif layer == "expert_mlp":
        tj, tt = _bf16_pair(rng, (6, 4, 96))
        ws = [_bf16_pair(rng, shape, 0.1)
              for shape in ((6, 96, 64), (6, 96, 64), (6, 64, 96))]
        want = jmoe._expert_mlp(tj, *(w[0] for w in ws), "swiglu")
        got = tmoe._expert_mlp(tt, *(w[1] for w in ws), "swiglu")
    elif layer == "head":
        wj, wt = _bf16_pair(rng, (96, 515), 0.1)
        want = (xj @ wj).astype(jnp.float32)
        got = (xt @ wt).to(torch.float32)
    else:
        ej, et = _bf16_pair(rng, (515, 96), 0.1)
        want = jlayers.unembed({"table": ej}, xj)
        got = tlayers.unembed({"table": et}, xt)
    assert got.dtype == {"bfloat16": torch.bfloat16,
                         "float32": torch.float32}[str(want.dtype)]
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=0)
    assert np.mean(got != want) <= 0.01
