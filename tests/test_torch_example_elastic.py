"""The port's elastic_restart example
(src/repro_torch/examples/elastic_restart.py) against the JAX package's
(examples/elastic_restart.py) on the CPU.

- Its config and optimizer are the JAX script's (what its ``main()``
  hands ``init_train_state``).
- ``run``: 3 steps on mesh A (1, 1), a save, a restore into a freshly
  initialised state on mesh B (1, 1) through ``load_checkpoint(mesh=,
  specs=)``, 3 more steps.  The restored state is bit-equal to the saved
  one, every leaf; each of the six losses, step 6's among them, is bit
  for bit that of an uninterrupted 6-step run on a (1, 1) mesh from the
  same seed; the JAX package's ``load_checkpoint`` reads the example's
  checkpoint bit for bit.  ``main`` prints the JAX script's three lines
  (``--device cpu``).
- ``run`` in f32 with the f32 wire from the params JAX's
  ``init_train_state`` makes: its six losses within 1e-4 relative of six
  jitted JAX mesh steps on the same batches (the frameworks' f32 sums
  differ in order; the trajectory is held as test_torch_example_train_lm
  holds it).
"""
import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # parallel test workers share the cores
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import _torch_examples as ex  # noqa: E402
import repro.checkpoint.checkpoint as jck  # noqa: E402
from repro.compat import set_mesh  # noqa: E402
from repro.data.synthetic import SyntheticLMDataset as JData  # noqa: E402
from repro.runtime import step as jstep  # noqa: E402
import torch.distributed as dist  # noqa: E402
from repro_torch.checkpoint import checkpoint as ck  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data.pipeline import place  # noqa: E402
from repro_torch.data.synthetic import SyntheticLMDataset  # noqa: E402
from repro_torch.examples import elastic_restart as te  # noqa: E402
from repro_torch.launch.mesh import init_distributed, make_mesh  # noqa: E402
from repro_torch.optim.adam import adamw_init  # noqa: E402
from repro_torch.runtime.step import (TrainState,  # noqa: E402
                                      init_train_state, make_train_step)

CPU = torch.device("cpu")
LOSS_RTOL = 1e-4


def _bits(t):
    if isinstance(t, torch.Tensor):
        t = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return t.detach().numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


def _numpy_template(tree):
    """The port's tree as nested dicts / lists of numpy arrays (bf16 as
    JAX's bfloat16), which JAX flattens to the port's keys."""
    if hasattr(tree, "_fields"):
        return {f: _numpy_template(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, dict):
        return {k: _numpy_template(v) for k, v in tree.items()
                if v is not None}
    if isinstance(tree, (list, tuple)):
        return [_numpy_template(v) for v in tree]
    return _bits(tree).view(jnp.bfloat16) if tree.dtype == torch.bfloat16 \
        else tree.detach().numpy()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The example's run, the restored state as ``load_checkpoint`` gave
    it (a copy, before mesh B's steps update it in place)."""
    ckpt = str(tmp_path_factory.mktemp("elastic"))
    restored = []

    def spy(*a, **k):
        out = ck.load_checkpoint(*a, **k)
        restored.append(copy.deepcopy(out[0]))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(te, "load_checkpoint", spy)
        out = te.run(te.build_config(), te.build_optimizer(), ckpt, CPU)
    return dict(out, restored=restored[0], ckpt=ckpt)


@pytest.fixture(scope="module")
def jax_setup(tmp_path_factory):
    """The config and optimizer the JAX script hands init_train_state."""
    je = ex.jax_example("elastic_restart")
    ckpt = str(tmp_path_factory.mktemp("jax_elastic"))
    calls = ex.run_until(je.main, (je, "init_train_state"), replace=(
        (je.tempfile, "mkdtemp", lambda **k: ckpt),))
    (_, jcfg, jopt, _), _ = calls["init_train_state"][0]
    return jcfg, jopt


def test_config_is_the_jax_examples(jax_setup):
    jcfg, jopt = jax_setup
    assert dataclasses.asdict(te.build_config()) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(te.build_optimizer()) == \
        dataclasses.asdict(jopt)


def test_restored_state_is_the_saved_one(run):
    assert run["step0"] == te.STEPS
    want = dict(ck._flatten(run["state_a"]))
    got = dict(ck._flatten(run["restored"]))
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_array_equal(_bits(v), _bits(want[k]), err_msg=k)


def test_losses_equal_an_uninterrupted_run(run):
    cfg, opt = te.build_config(), te.build_optimizer()
    ds = SyntheticLMDataset(cfg.vocab_size, te.SEQ, te.BATCH)
    init_distributed(CPU, store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh(1, 1)
        state = init_train_state(cfg, opt, seed=0, device=CPU, mesh=mesh)
        step = make_train_step(cfg, opt, mesh=mesh)
        want = {}
        for s in range(2 * te.STEPS):
            state, m = step(state, place(ds.batch_at(s), CPU))
            want[s + 1] = float(m["loss"])
    finally:
        dist.destroy_process_group()
    print(f"elastic losses {run['losses']}")
    assert run["losses"] == want


def test_jax_reads_the_examples_checkpoint(run, monkeypatch):
    monkeypatch.setattr(jck, "zstandard", None)
    got, step, _ = jck.load_checkpoint(run["ckpt"],
                                       _numpy_template(run["state_a"]))
    assert step == te.STEPS
    want = dict(ck._flatten(run["state_a"]))
    flat = jck._flatten(got)
    assert set(flat) == set(want)
    for k, v in flat.items():
        np.testing.assert_array_equal(_bits(v), _bits(want[k]), err_msg=k)


def test_main_prints_the_jax_lines(capsys):
    assert te.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("[mesh A {'data': 1, 'model': 1}] step 3 "
                               "loss ")
    assert lines[1].startswith("[mesh B {'data': 1, 'model': 1}] resumed "
                               "at 3, step 6 loss ")
    assert lines[2] == "elastic restore OK: same logical state, new mesh"


def test_losses_match_jax(jax_setup, mesh, tmp_path):
    jcfg, jopt = jax_setup
    jcfg = ex.f32(jcfg)
    ds = JData(jcfg.vocab_size, te.SEQ, te.BATCH)
    with set_mesh(mesh):
        state = jstep.init_train_state(jax.random.PRNGKey(0), jcfg, jopt,
                                       mesh)
        params = ex.np_tree(state.params)
        step = jax.jit(jstep.make_train_step(jcfg, jopt, mesh))
        jl = []
        for s in range(2 * te.STEPS):
            state, m = step(state, ds.batch_at(s))
            jl.append(float(m["loss"]))
    tcfg, opt = ex.f32(te.build_config()), te.build_optimizer()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)

    def from_jax(*a, **k):     # mesh A's state and mesh B's template
        p = params_from_jax(params, device=CPU)
        return TrainState(p, adamw_init(p, opt))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(te, "init_train_state", from_jax)
        out = te.run(tcfg, opt, str(tmp_path), CPU)
    tl = [out["losses"][s + 1] for s in range(2 * te.STEPS)]
    print(f"elastic f32 losses: jax {jl} torch {tl}")
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
