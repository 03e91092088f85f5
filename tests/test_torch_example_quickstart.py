"""The port's quickstart example (src/repro_torch/examples/quickstart.py)
against the JAX package's (examples/quickstart.py) on the CPU.

- The config and optimizer are the JAX script's, field for field (read
  from what its ``main()`` hands ``init_train_state``).
- ``run`` on params made by JAX and carried over with
  ``params_from_jax``, in f32 with the f32 wire: the baseline and LSH
  losses within 1e-5 relative of JAX's ``make_train_step(use_lsh=False /
  True)`` losses on the same unstepped state (the two frameworks sum
  matrix products in another order).  Each of its losses is bit for bit
  that of a step from a fresh copy of the state, and the state it was
  given is left unstepped: the port's step updates in place, and the LSH
  step must not start from the params the baseline moved.  The wire
  tensor's shapes equal JAX's.
- ``python -m repro_torch.examples.quickstart --device cpu`` prints the
  JAX script's three lines; every example's ``main`` raises without a
  CUDA device unless ``--device cpu`` is given.
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
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import _torch_examples as ex  # noqa: E402
from repro.compat import set_mesh  # noqa: E402
from repro.core import clustering as jclust  # noqa: E402
from repro.core.hashing import make_rotations as j_make_rotations  # noqa: E402
from repro.data.synthetic import SyntheticLMDataset as JData  # noqa: E402
from repro.runtime import step as jstep  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data.pipeline import place  # noqa: E402
from repro_torch.data.synthetic import SyntheticLMDataset  # noqa: E402
from repro_torch.examples import quickstart as tq  # noqa: E402
from repro_torch.optim import adam as tadam  # noqa: E402
from repro_torch.runtime import step as tstep  # noqa: E402

LOSS_RTOL = 1e-5
ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def jax_setup():
    jq = ex.jax_example("quickstart")
    calls = ex.run_until(jq.main, (jq, "init_train_state"))
    (_, jcfg, jopt, _), _ = calls["init_train_state"][0]
    return jcfg, jopt


@pytest.fixture(scope="module")
def both(jax_setup, mesh):
    """JAX's two losses and wire shapes on an f32 state, and the port's
    run on the same params."""
    jcfg, jopt = ex.f32(jax_setup[0]), jax_setup[1]
    batch = JData(jcfg.vocab_size, tq.SEQ, tq.BATCH).batch_at(0)
    with set_mesh(mesh):
        state = jstep.init_train_state(jax.random.PRNGKey(0), jcfg, jopt,
                                       mesh)
        jl = [float(jax.jit(jstep.make_train_step(
            jcfg, jopt, mesh, use_lsh=use_lsh))(state, batch)[1]["loss"])
            for use_lsh, _ in tq.RUNS]
    toks = jax.random.normal(jax.random.PRNGKey(1), (1, 128, 64))
    rot = j_make_rotations(jax.random.PRNGKey(2), 6, 64, 32, jnp.float32)
    comp = jclust.compress(toks, jnp.ones((1, 128), bool), rot, 32,
                           "cross_polytope")
    jwire = (tuple(comp.residuals.shape), tuple(comp.centroids.shape))
    params = ex.np_tree(state.params)

    def fresh():
        p = params_from_jax(params, device=CPU)
        return tstep.TrainState(p, tadam.adamw_init(p, tq.build_optimizer()))

    tcfg = ex.f32(tq.build_config())
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    given = fresh()
    out = tq.run(tcfg, tq.build_optimizer(), given)
    return dict(jl=jl, jwire=jwire, out=out, given=given, fresh=fresh,
                cfg=tcfg)


def test_config_is_the_jax_examples(jax_setup):
    jcfg, jopt = jax_setup
    assert dataclasses.asdict(tq.build_config()) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tq.build_optimizer()) == \
        dataclasses.asdict(jopt)


def test_losses_match_jax(both):
    tl, jl = both["out"]["losses"], both["jl"]
    print(f"quickstart losses (baseline, LSH): jax {jl} torch {tl}")
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)


def test_each_run_steps_an_unstepped_state(both):
    """The losses ``run`` printed are those of steps from fresh copies,
    bit for bit, and the state it was given is still the initial one."""
    cfg, opt = both["cfg"], tq.build_optimizer()
    batch = place(SyntheticLMDataset(cfg.vocab_size, tq.SEQ,
                                     tq.BATCH).batch_at(0), CPU)
    for (use_lsh, tag), got in zip(tq.RUNS, both["out"]["losses"]):
        _, m = tstep.make_train_step(cfg, opt, use_lsh=use_lsh)(
            both["fresh"](), batch)
        assert float(m["loss"]) == got, tag
    initial = both["fresh"]()
    assert int(both["given"].opt.step) == 0
    for a, b in zip(tadam.leaves(both["given"].params),
                    tadam.leaves(initial.params)):
        assert torch.equal(a, b)


def test_wire_shapes_match_jax(both):
    assert both["out"]["wire"] == both["jwire"] == ((1, 128, 64),
                                                    (1, 32, 64))


def test_cli_prints_the_jax_lines():
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.quickstart", "--device",
         "cpu"], capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.splitlines()
    assert [ln.split(":")[0] for ln in lines] == [
        "baseline (uncompressed a2a)", "LSH-MoE  (compressed a2a)",
        "wire tensor"]
    assert lines[2] == ("wire tensor: (1, 128, 64) tokens -> (1, 32, 64) "
                        "centroids (25% of the bytes); residuals stay local "
                        "(error compensation).")


@pytest.mark.parametrize("name", ["quickstart", "train_lm", "serve_batch",
                                  "elastic_restart"])
def test_main_raises_without_cuda(name):
    """The default device is the card; no example falls back to the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import importlib
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="--device cpu"):
        mod.main([])
