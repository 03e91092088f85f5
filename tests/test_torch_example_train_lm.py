"""The port's train_lm example (src/repro_torch/examples/train_lm.py)
against the JAX package's (examples/train_lm.py) on the CPU.

- ``lm-100m`` is the JAX script's config and optimizer field for field
  (read from what its ``main()`` hands ``param_count`` and
  ``OptimizerConfig``), its ``param_count`` / ``active_param_count`` are
  JAX's exactly, and the port's ``main`` prints the JAX script's
  ``params:`` line.
- At 1 super-block (width kept), f32 with the f32 wire, from params
  made by JAX: ``run``'s 3 losses within 1e-4 relative of the JAX
  package's jitted steps (the frameworks' f32 sums differ in order; a
  first AdamW step moves each param by about lr * sign(g), so the
  trajectory is held as test_torch_train.py's quickstart trajectory is).
- A run stopped by a KeyboardInterrupt after its save at step 2 (saves
  every step here) and re-run with the same arguments prints ``resumed
  from step 2`` and ends with every param and moment bit-equal to the
  uninterrupted run's.  The schedule allows that because the learning
  rate is a function of the restored step counter and of ``--steps``
  (``total_steps``), which the re-run repeats; the batches are a function
  of the step, and the restore gives back every byte of the state.
"""
import contextlib
import dataclasses
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # parallel test workers share the cores
jax = pytest.importorskip("jax")

import _torch_examples as ex  # noqa: E402
import repro.checkpoint.checkpoint as jck  # noqa: E402
from repro.compat import set_mesh  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.data.synthetic import SyntheticLMDataset as JData  # noqa: E402
from repro.runtime import step as jstep  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data.synthetic import SyntheticLMDataset  # noqa: E402
from repro_torch.examples import train_lm as tl  # noqa: E402
from repro_torch.optim import adam as tadam  # noqa: E402
from repro_torch.runtime import step as tstep  # noqa: E402

LOSS_RTOL = 1e-4
STEPS = 3
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def jax_setup(tmp_path_factory):
    """The config, optimizer and printed params line of the JAX script."""
    jt = ex.jax_example("train_lm")
    ckpt = tmp_path_factory.mktemp("jax_ckpt")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        calls = ex.run_until(
            jt.main, (jck, "CheckpointManager"),
            record=((jbase, "param_count"), (jbase, "OptimizerConfig")),
            argv=("train_lm.py", "--steps", str(STEPS), "--ckpt", str(ckpt)))
    jcfg = calls["param_count"][0][0][0]
    jopt = jbase.OptimizerConfig(**calls["OptimizerConfig"][0][1])
    return jcfg, jopt, printed.getvalue().splitlines()


@pytest.fixture(scope="module")
def runs(jax_setup, mesh, tmp_path_factory):
    """JAX's 3 losses at 1 super-block in f32, the port's uninterrupted
    run from the same params, and the numpy params to start others."""
    jcfg, jopt, _ = jax_setup
    jcfg = ex.f32(dataclasses.replace(jcfg, num_super_blocks=1))
    ds = JData(jcfg.vocab_size, tl.SEQ, tl.BATCH)
    with set_mesh(mesh):
        state = jstep.init_train_state(jax.random.PRNGKey(0), jcfg, jopt,
                                       mesh)
        params = ex.np_tree(state.params)
        step = jax.jit(jstep.make_train_step(jcfg, jopt, mesh))
        jl = []
        for s in range(STEPS):
            state, m = step(state, ds.batch_at(s))
            jl.append(float(m["loss"]))
    tcfg = ex.f32(dataclasses.replace(tl.build_config(),
                                      num_super_blocks=1))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    out = tl.run(tcfg, tl.build_optimizer(STEPS), _state(params), steps=STEPS,
                 ckpt=str(tmp_path_factory.mktemp("whole")))
    return dict(jl=jl, out=out, params=params, cfg=tcfg)


def _state(params):
    p = params_from_jax(params, device=CPU)
    return tstep.TrainState(p, tadam.adamw_init(p, tl.build_optimizer(STEPS)))


def test_config_and_param_counts_are_the_jax_examples(jax_setup, capsys):
    jcfg, jopt, jax_lines = jax_setup
    tcfg = tl.build_config()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tl.build_optimizer(STEPS)) == \
        dataclasses.asdict(jopt)
    assert tbase.param_count(tcfg) == jbase.param_count(jcfg)
    assert tbase.active_param_count(tcfg) == jbase.active_param_count(jcfg)
    print(f"lm-100m: {tbase.param_count(tcfg)} params, "
          f"{tbase.active_param_count(tcfg)} active a token")
    capsys.readouterr()
    with pytest.MonkeyPatch.context() as mp:     # main up to the training
        mp.setattr(tl, "init_train_state", lambda *a, **k: None)
        mp.setattr(tl, "run", lambda *a, **k: None)
        assert tl.main(["--device", "cpu"]) == 0
    port_line = capsys.readouterr().out.splitlines()
    assert port_line == jax_lines and jax_lines[0].startswith("params: ")


def test_losses_match_jax(runs):
    tl_losses = [runs["out"]["losses"][s] for s in range(STEPS)]
    print(f"lm-100m at 1 super-block, f32: jax {runs['jl']} torch "
          f"{tl_losses}")
    np.testing.assert_allclose(tl_losses, runs["jl"], rtol=LOSS_RTOL)
    assert runs["out"]["start"] == 0


class _Interrupted(SyntheticLMDataset):
    """Ctrl-C when the batch of step 2 is asked for."""

    def batch_at(self, step):
        if step == 2:
            raise KeyboardInterrupt
        return super().batch_at(step)


def test_interrupted_run_resumes_bitwise(runs, tmp_path, monkeypatch, capsys):
    cfg, opt, ckpt = runs["cfg"], tl.build_optimizer(STEPS), str(tmp_path)
    monkeypatch.setattr(tl, "CKPT_EVERY", 1)
    with monkeypatch.context() as mp:
        mp.setattr(tl, "SyntheticLMDataset", _Interrupted)
        with pytest.raises(KeyboardInterrupt):
            tl.run(cfg, opt, _state(runs["params"]), steps=STEPS, ckpt=ckpt)
    capsys.readouterr()
    out = tl.run(cfg, opt, _state(runs["params"]), steps=STEPS, ckpt=ckpt)
    printed = capsys.readouterr().out.splitlines()
    assert printed[0] == "resumed from step 2"
    assert out["start"] == 2 and list(out["losses"]) == [2]
    assert out["losses"][2] == runs["out"]["losses"][2]
    want = tadam.leaves(runs["out"]["state"])
    got = tadam.leaves(out["state"])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a, b)
