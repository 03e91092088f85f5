"""The port's serve_batch example (src/repro_torch/examples/serve_batch.py)
against the JAX package's (examples/serve_batch.py) on the CPU.

For every arch of the registry at its smoke config in f32, from params
made by JAX and carried over with ``params_from_jax``, and the same numpy
prompts (the two packages' seeded draws differ): the JAX script's loop
(the decode step jitted, the prompt fed a token a step, then greedy
decode) and the port's ``run`` give equal greedy tokens up to the first
position of each row where JAX's two largest logits lie within 1e-4 of
each other (a near tie, where the frameworks' f32 sums in another order
may pick the other token).  The test prints how many positions each arch
compared.  whisper-base decodes without frames in both packages.  The
port's ``main`` prints the JAX script's lines (``--device cpu``).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # parallel test workers share the cores
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import _torch_examples as ex  # noqa: E402
from repro.compat import set_mesh  # noqa: E402
from repro.configs.registry import get_smoke_config as j_smoke  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs.registry import (ARCH_IDS,  # noqa: E402
                                          get_smoke_config)
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.examples import serve_batch  # noqa: E402

BATCH, PROMPT, GEN = 4, 12, 20           # the JAX script's defaults
NEAR_TIE = 1e-4


def _jax_decode(cfg, mesh, prompts):
    """The JAX script's loop on ``prompts``: params, the greedy tokens
    [B, GEN] and the gap between the two largest logits behind each."""
    with set_mesh(mesh):
        params = jax.jit(lambda k: jmodel.init_params(k, cfg, mesh))(
            jax.random.PRNGKey(0))
        decode = jax.jit(
            lambda p, s, t: jmodel.decode_step(p, cfg, mesh, s, t))
        state = jmodel.init_decode_state(cfg, BATCH, PROMPT + GEN, mesh)
        toks = jnp.asarray(prompts)
        for i in range(PROMPT):
            logits, state = decode(params, state, toks[:, i:i + 1])
        generated, gaps = [], []
        for _ in range(GEN):
            top2 = np.sort(np.asarray(logits[:, 0], np.float64), -1)[:, -2:]
            gaps.append(top2[:, 1] - top2[:, 0])
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            generated.append(np.asarray(tok)[:, 0])
            logits, state = decode(params, state, tok)
    return ex.np_tree(params), np.stack(generated, 1), np.stack(gaps, 1)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_greedy_tokens_match_jax(arch, mesh):
    jcfg = j_smoke(arch).replace(dtype="float32")
    prompts = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (BATCH, PROMPT), dtype=np.int32)
    params, want, gaps = _jax_decode(jcfg, mesh, prompts)
    tcfg = get_smoke_config(arch).replace(dtype="float32")
    out = serve_batch.run(tcfg, params_from_jax(params, device="cpu"),
                          torch.from_numpy(prompts), GEN)
    got = out["tokens"]
    assert got.shape == want.shape == (BATCH, GEN)
    compared = 0
    for b in range(BATCH):
        ties = np.flatnonzero(gaps[b] < NEAR_TIE)
        n = int(ties[0]) if ties.size else GEN
        np.testing.assert_array_equal(got[b, :n], want[b, :n],
                                      err_msg=f"{arch} row {b}")
        compared += n
    print(f"{arch}: {compared} of {BATCH * GEN} generated positions "
          f"compared (smallest top-2 gap {gaps.min():.3g})")
    assert compared >= BATCH * GEN // 2


def test_main_prints_the_jax_lines(capsys):
    assert serve_batch.main(["--arch", "granite-moe-3b-a800m", "--device",
                             "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"arch=granite-moe-3b-a800m generated "
                               f"({BATCH}, {GEN}) tokens in ")
    assert lines[0].endswith("s") and len(lines) == 1 + BATCH
    for b, line in enumerate(lines[1:]):
        toks = json.loads(line.split(":", 1)[1])
        assert line.startswith(f"  seq{b}: [") and len(toks) == GEN
