"""The port's launcher and checkpoints over a (data, model) = (2, 2) mesh
of four CPU ranks (gloo), started by ``launch.mesh.spawn_cpu_ranks``:

- a run that every rank's SIGTERM stops at step 2 (it saves step 3 and
  exits 42) and that is launched again ends with the uninterrupted run's
  per-step losses, bit for bit;
- the uninterrupted run's last checkpoint (saved on (2, 2): the expert
  leaves of params and moments gathered to their logical shapes) restores
  on a (1, 2) mesh and on one rank without a mesh, and each restored
  state, gathered again, is bit for bit the checkpoint's arrays;
- on (1, 2), ``apply_placement_update`` over the mesh (gather, permute,
  cut) gives the mesh-free update's shards bit for bit;
- granite-8b's smoke state, every leaf placed by its spec
  (runtime/params.py), after one step on (2, 2): its checkpoint restores
  on (1, 4), on one rank and in the JAX package, each bit for bit the
  checkpoint's arrays.
"""
import json
import os
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

from repro_torch.launch import mesh as tmesh  # noqa: E402

ARCH = "granite-moe-3b-a800m"
COMMON = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "4",
          "--batch", "4", "--seq", "32", "--log-every", "1",
          "--ckpt-every", "2"]


def _opt():
    from repro_torch.configs.base import OptimizerConfig
    return OptimizerConfig(lr=1e-3, warmup_steps=0, total_steps=4)


def _logical(state, mesh):
    """The state as the checkpoint holds it: {key: bits}, on rank 0."""
    from repro_torch.checkpoint.checkpoint import host_copy
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.runtime.params import train_state_specs
    entries = host_copy(state, mesh, train_state_specs(
        get_smoke_config(ARCH), mesh, _opt().moment_dtype))
    return None if entries is None else {k: a for k, a, _, _ in entries}


# ------------------------------------------------------------ the ranks --

def _rank_main(rank, world, args):
    mode = args[0]
    if mode == "train":
        from repro_torch.launch import train as train_cli
        out, extra = args[1], args[2:]
        rc = train_cli.main([*COMMON, "--mesh-data", "2", "--mesh-model",
                             "2", *extra])
        Path(out, f"rc_{rank}").write_text(str(rc))
        return 0
    if mode == "ckpt14":
        return _ckpt14_main(rank, args[1], args[2])
    ckpt, out = args[1], args[2]
    from repro_torch.checkpoint.checkpoint import load_checkpoint
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.convert import gather_params
    from repro_torch.core.lsh_moe import apply_placement_update
    from repro_torch.runtime import params as tparams
    from repro_torch.runtime.step import init_train_state
    cfg = get_smoke_config(ARCH)
    mesh = tmesh.make_mesh(1, 2)
    tpl = init_train_state(cfg, _opt(), seed=9, device="cpu", mesh=mesh)
    state, step, _ = load_checkpoint(ckpt, tpl, mesh=mesh,
                                     specs=tparams.train_state_specs(
                                         cfg, mesh, _opt().moment_dtype))
    got = _logical(state, mesh)
    ffn = state.params["layers"][0]["ffn"]
    new = torch.tensor([3, 0, 5, 1, 4, 2], dtype=torch.int32)
    specs = tparams.model_specs(cfg, mesh)["layers"][0]["ffn"]
    moved = apply_placement_update(ffn, new, ffn["placement"], mesh=mesh,
                                   specs=specs)
    full = gather_params({"ffn": ffn}, mesh, {"ffn": specs})["ffn"]
    want = apply_placement_update(full, new, full["placement"])
    for k in ("w_gate", "w_up", "w_down"):
        assert torch.equal(moved[k], tparams.shard(want[k], specs[k], mesh)), k
    assert torch.equal(moved["placement"], new)
    if got is not None:
        np.savez(out, step=step, **{k.replace("/", "|"): v
                                     for k, v in got.items()})
    return 0


PLACED_ARCH = "granite-8b"


def _ckpt14_main(rank, ckpt, out):
    """One step of granite-8b's smoke config on (2, 2), saved; restored
    on (1, 4) from a template of another seed; the restored state as the
    checkpoint holds it, on rank 0."""
    from repro_torch.checkpoint.checkpoint import (load_checkpoint,
                                                   save_checkpoint)
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.runtime.params import train_state_specs
    from repro_torch.runtime import step as tstep
    cfg = get_smoke_config(PLACED_ARCH)
    opt = _opt()
    m22 = tmesh.make_mesh(2, 2)
    m14 = tmesh.make_mesh(1, 4)
    state = tstep.init_train_state(cfg, opt, seed=4, device="cpu", mesh=m22)
    state, _ = tstep.make_train_step(cfg, opt, mesh=m22)(
        state, tstep.batch_to_device(SyntheticLMDataset(
            cfg.vocab_size, 32, 4).batch_at(0), torch.device("cpu")))
    save_checkpoint(ckpt, 1, state, mesh=m22,
                    specs=train_state_specs(cfg, m22, opt.moment_dtype))
    s14 = train_state_specs(cfg, m14, opt.moment_dtype)
    tpl = tstep.init_train_state(cfg, opt, seed=5, device="cpu", mesh=m14)
    got, step, _ = load_checkpoint(ckpt, tpl, mesh=m14, specs=s14)
    assert step == 1
    from repro_torch.checkpoint.checkpoint import host_copy
    entries = host_copy(got, m14, s14)
    if entries is not None:
        np.savez(out, **{k.replace("/", "|"): a for k, a, _, _ in entries})
    return 0


# ------------------------------------------------------------- tests --

def _spawn(tmp, world, args):
    tmesh.spawn_cpu_ranks(str(HERE), world, args,
                          store=str(tmp / f"store_{len(os.listdir(tmp))}"),
                          env=dict(os.environ, PYTHONPATH=str(SRC),
                                   OMP_NUM_THREADS="1"),
                          timeout_s=300)


def _train(tmp, run, *extra):
    d = tmp / run
    d.mkdir(exist_ok=True)
    _spawn(tmp, 4, ["train", str(d), "--ckpt", str(d / "ckpt"),
                    "--metrics-dir", str(d), *extra])
    return d, {int(Path(d, f"rc_{r}").read_text()) for r in range(4)}


def _losses(d):
    out = {}
    with open(d / "events.jsonl") as f:
        for line in f:
            rec = json.loads(line)
            if rec["kind"] == "step":
                out[rec["step"]] = rec["loss"]
    return out


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_trainer")
    d, rcs = _train(tmp, "base")
    assert rcs == {0}
    losses = _losses(d)
    assert sorted(losses) == [0, 1, 2, 3]
    return tmp, d, losses


def test_preempted_mesh_run_resumes_bitwise(base):
    tmp, _, want = base
    d, rcs = _train(tmp, "chaos", "--chaos", "sigterm@2")
    assert rcs == {42}
    assert "step_3" in os.listdir(d / "ckpt")
    d, rcs = _train(tmp, "chaos", "--chaos", "sigterm@2")
    assert rcs == {0}
    assert _losses(d) == want
    kinds = [json.loads(line)["kind"] for line in open(d / "events.jsonl")]
    assert kinds.count("preempt") == 1 and kinds.count("resume") == 1


def test_mesh_checkpoint_restores_on_other_meshes(base):
    from repro_torch.checkpoint.checkpoint import (load_checkpoint,
                                                   read_checkpoint)
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.runtime.step import init_train_state
    tmp, d, _ = base
    ckpt = d / "ckpt"
    _, arrays = read_checkpoint(str(ckpt / "step_4"))
    saved = {k: a for k, (a, _) in arrays.items()}
    assert saved["params/layers/#0/ffn/w_up"].shape[:2] == (6, 96)
    out = tmp / "restored_1x2.npz"
    _spawn(tmp, 2, ["restore", str(ckpt), str(out)])
    got = dict(np.load(out))
    assert int(got.pop("step")) == 4
    got = {k.replace("|", "/"): v for k, v in got.items()}
    one_tpl = init_train_state(get_smoke_config(ARCH), _opt(), seed=9,
                               device="cpu")
    state, step, _ = load_checkpoint(str(ckpt), one_tpl)
    one = _logical(state, None)
    assert step == 4
    for name, restored in (("(1, 2)", got), ("one rank", one)):
        assert set(restored) == set(saved), name
        for k, v in saved.items():
            np.testing.assert_array_equal(restored[k], v,
                                          err_msg=f"{name}: {k}")


def test_placed_checkpoint_restores_on_1x4_one_rank_and_jax(tmp_path):
    """Every leaf split by its spec on (2, 2) (FSDP over data, heads /
    FFN hidden / vocabulary over model) is saved whole: the checkpoint
    restores on (1, 4), on one rank and in the JAX package bit for bit,
    and some of its leaves were split on (2, 2)."""
    jax = pytest.importorskip("jax")
    from repro.checkpoint import checkpoint as jck
    from repro_torch.checkpoint.checkpoint import (_flatten, load_checkpoint,
                                                   read_checkpoint)
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.runtime.step import init_train_state
    ckpt, out = tmp_path / "ckpt", tmp_path / "restored_1x4.npz"
    _spawn(tmp_path, 4, ["ckpt14", str(ckpt), str(out)])
    _, arrays = read_checkpoint(str(ckpt / "step_1"))
    saved = {k: a for k, (a, _) in arrays.items()}
    got = {k.replace("|", "/"): v for k, v in dict(np.load(out)).items()}
    one_tpl = init_train_state(get_smoke_config(PLACED_ARCH), _opt(),
                               seed=9, device="cpu")
    one, step, _ = load_checkpoint(str(ckpt), one_tpl)
    assert step == 1
    table = one.params["embed"]["table"]
    assert saved["params/embed/table"].shape == tuple(table.shape)
    orig = jck.zstandard
    jck.zstandard = None
    try:
        jgot, jstep, _ = jck.load_checkpoint(str(ckpt), _numpy_tree(one))
    finally:
        jck.zstandard = orig
    assert jstep == 1
    jflat = {k: _word_bits(v) for k, v in jck._flatten(jgot).items()}
    for name, restored in (("(1, 4)", got), ("one rank", _logical(one, None)),
                           ("JAX", jflat)):
        assert set(restored) == set(saved), name
        for k, v in saved.items():
            np.testing.assert_array_equal(_word_bits(restored[k]),
                                          _word_bits(v),
                                          err_msg=f"{name}: {k}")
    assert {k for k, _ in _flatten(one)} == set(saved)
    # on (2, 2) the state was cut: the restored (1, 4) shards are smaller
    from repro_torch.launch.mesh import Mesh
    from repro_torch.runtime.params import model_specs, split_axes
    specs = model_specs(get_smoke_config(PLACED_ARCH), Mesh((2, 2)))
    assert split_axes(specs["embed"]["table"], Mesh((2, 2))) == ("model",)
    assert split_axes(specs["layers"][0]["mixer"]["wq"], Mesh((2, 2))) == \
        ("data", "model")


def _numpy_tree(tree):
    """The port's tree as nested dicts / lists of numpy arrays (bf16 as
    ml_dtypes' bfloat16), which the JAX reader flattens to the port's
    keys."""
    import ml_dtypes
    if hasattr(tree, "_fields"):
        return {f: _numpy_tree(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items() if v is not None}
    if isinstance(tree, (list, tuple)):
        return [_numpy_tree(v) for v in tree]
    if tree.dtype == torch.bfloat16:
        return tree.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return tree.detach().numpy()


def _word_bits(a):
    """An array's words as unsigned integers of its item size."""
    a = np.ascontiguousarray(np.asarray(a))
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32,
                   8: np.uint64}[a.itemsize])


if __name__ == "__main__":                  # RANK WORLD STORE args...
    sys.exit(tmesh.run_cpu_rank(sys.argv[1:], _rank_main))
