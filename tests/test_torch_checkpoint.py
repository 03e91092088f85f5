"""The port's checkpoints (checkpoint/checkpoint.py) against the JAX
package's on the CPU.

- A round trip of the granite-moe-3b-a800m smoke config's training state,
  after one step so the moments are not zero, with f32, bf16 and int8
  moments (int8: {"q", "scale"} dicts), restored into a state of another
  seed: every leaf bit for bit, the int32 ``placement`` and the host-side
  step counter included.
- The hand-written msgpack encoder gives the bytes of
  ``msgpack.packb(payload, use_bin_type=True)`` and its decoder reads
  msgpack's output (msgpack is imported here only: the card's host has
  none).
- Cross-reading: the JAX package's ``load_checkpoint`` reads a
  port-written directory into a numpy template, bit for bit; the port
  restores a directory the JAX package wrote (zlib shards: its
  ``zstandard`` is hidden by monkeypatching the JAX module's global) into
  its ``TrainState``, equal to ``convert.state_from_jax``; a zstd shard
  raises a clear CheckpointError.
- The JAX suite's damage and protocol cases, by name
  (tests/test_resilience.py, tests/test_optim_ckpt.py).
- ``jax_checkpoint_layout`` numbers the layers of each stack (decoder,
  encoder) by its own layout length.
- A JAX run carried across: two JAX steps saved by the JAX package, the
  port restores them and takes the third step, held to JAX's third step
  within test_torch_train.py's f32-wire bounds (loss 1e-5 relative,
  params 1e-5 relative L2).
"""
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # parallel test workers share the cores
jax = pytest.importorskip("jax")
import jax.numpy as jnp

import repro.checkpoint.checkpoint as jck
from repro.compat import set_mesh
from repro.configs import base as jbase
from repro.configs.registry import get_smoke_config as j_smoke_config
from repro.data.synthetic import SyntheticLMDataset as JData
from repro.obs import events as j_events
from repro.runtime import step as jstep
from repro_torch.checkpoint import checkpoint as ck
from repro_torch.checkpoint.checkpoint import (CheckpointCorruptError,
                                               CheckpointError,
                                               CheckpointManager,
                                               committed_steps,
                                               load_checkpoint,
                                               save_checkpoint)
from repro_torch.configs import base as tbase
from repro_torch.configs.registry import get_smoke_config
from repro_torch.convert import load_jax_checkpoint, state_from_jax
from repro_torch.data.synthetic import SyntheticLMDataset
from repro_torch.obs import events as obs_events
from repro_torch.optim import adam as tadam
from repro_torch.runtime import step as tstep

ARCH = "granite-moe-3b-a800m"
CPU = torch.device("cpu")


@pytest.fixture
def events():
    log = obs_events.global_log()
    mem = obs_events.MemorySink()
    log.add_sink(mem)
    yield mem
    log.remove_sink(mem)


def _bits(x):
    """A leaf as comparable numpy bits (bf16 as int16)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def _assert_trees_equal(a, b):
    """Leaf for leaf by key (JAX's dicts come in sorted key order)."""
    fa = {k: x for k, x in ck._flatten(a)}
    fb = {k: x for k, x in ck._flatten(b)}
    assert set(fa) == set(fb)
    for k, x in fa.items():
        y = fb[k]
        assert ck.dtype_name(x) == ck.dtype_name(y), k
        assert tuple(x.shape) == tuple(y.shape), k
        np.testing.assert_array_equal(_bits(x), _bits(y), err_msg=k)


def _port_state(moment_dtype, seed=0, steps=1):
    cfg = get_smoke_config(ARCH)
    opt = tbase.OptimizerConfig(lr=1e-3, warmup_steps=0, total_steps=10,
                                moment_dtype=moment_dtype)
    state = tstep.init_train_state(cfg, opt, seed=seed, device=CPU)
    step = tstep.make_train_step(cfg, opt)
    ds = SyntheticLMDataset(cfg.vocab_size, 16, 2)
    for s in range(steps):
        state, _ = step(state, tstep.batch_to_device(ds.batch_at(s), CPU))
    return state


# ------------------------------------------------------------ round trip --

@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16", "int8"])
def test_state_round_trip_is_bitwise(tmp_path, moment_dtype):
    state = _port_state(moment_dtype)
    save_checkpoint(str(tmp_path), 1, state, extra={"run": "a"})
    fresh = _port_state(moment_dtype, seed=1, steps=0)
    got, step, extra = load_checkpoint(str(tmp_path), fresh)
    assert step == 1 and extra == {"run": "a"}
    assert isinstance(got, tstep.TrainState)
    _assert_trees_equal(got, state)
    assert got.opt.step.device == CPU and int(got.opt.step) == 1
    names = {ck.dtype_name(x) for _, x in ck._flatten(got)}
    assert {"bfloat16", "float32", "int32"} <= names
    if moment_dtype == "int8":
        assert "int8" in names and set(got.opt.m["embed"]["table"]) == \
            {"q", "scale"}


# ----------------------------------------------------------------- codec --

def test_encoder_bytes_equal_msgpack_and_decoder_reads_it():
    msgpack = pytest.importorskip("msgpack")
    entries = ck.host_copy(_port_state("int8", steps=0))
    payload = {k: (a.tobytes(), d, s) for k, a, d, s in entries}
    payload["odd/shapes"] = (b"\x07" * 70000, "int8",
                             [0, 1, 127, 128, 255, 256, 65535, 65536,
                              2 ** 32, -1, -32, -33, -200, -40000])
    want = msgpack.packb(payload, use_bin_type=True)
    assert ck.packb(payload) == want
    assert ck.unpackb(want) == msgpack.unpackb(want, raw=False)
    small = {str(i): (b"", "f", []) for i in range(17)}
    assert ck.packb(small) == msgpack.packb(small, use_bin_type=True)


def test_shard_is_one_zlib_stream_of_the_payload(tmp_path):
    """What JAX's _read_payload does with a shard: zlib.decompress, then
    msgpack.unpackb."""
    import zlib
    msgpack = pytest.importorskip("msgpack")
    state = _port_state("float32", steps=0)
    save_checkpoint(str(tmp_path), 3, state)
    blob = (tmp_path / "step_3" / "shard_0.msgpack.zlib").read_bytes()
    payload = msgpack.unpackb(zlib.decompress(blob), raw=False)
    for key, a, dtype, shape in ck.host_copy(state):
        buf, d, s = payload[key]
        assert (d, s) == (dtype, shape) and buf == a.tobytes(), key


# --------------------------------------------------------- cross-reading --

def _numpy_template(tree):
    """The port's tree as nested dicts / lists of numpy arrays (bf16 as
    ml_dtypes' bfloat16), which JAX flattens to the port's keys."""
    if hasattr(tree, "_fields"):
        return {f: _numpy_template(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, dict):
        return {k: _numpy_template(v) for k, v in tree.items()
                if v is not None}
    if isinstance(tree, (list, tuple)):
        return [_numpy_template(v) for v in tree]
    if tree.dtype == torch.bfloat16:
        return tree.view(torch.int16).numpy().view(jnp.bfloat16)
    return tree.detach().numpy()


def test_jax_reads_a_port_checkpoint(tmp_path, monkeypatch):
    monkeypatch.setattr(jck, "zstandard", None)
    state = _port_state("int8")
    save_checkpoint(str(tmp_path), 2, state)
    tpl = _numpy_template(state)
    got, step, _ = jck.load_checkpoint(str(tmp_path), tpl)
    assert step == 2
    want = {k: _bits(x) for k, x in ck._flatten(state)}
    flat = jck._flatten(got)
    assert set(flat) == set(want)
    for k, v in flat.items():
        np.testing.assert_array_equal(_bits(v), want[k], err_msg=k)


def _jax_state(mesh, moment_dtype="int8"):
    cfg = j_smoke_config(ARCH)
    opt = jbase.OptimizerConfig(lr=1e-3, warmup_steps=0, total_steps=10,
                                moment_dtype=moment_dtype)
    with set_mesh(mesh):
        state = jstep.init_train_state(jax.random.PRNGKey(0), cfg, opt, mesh)
        step = jax.jit(jstep.make_train_step(cfg, opt, mesh))
        state, _ = step(state, JData(cfg.vocab_size, 16, 2).batch_at(0))
    return state


def test_port_restores_a_jax_checkpoint(tmp_path, monkeypatch, mesh):
    monkeypatch.setattr(jck, "zstandard", None)
    jstate = _jax_state(mesh)
    jck.save_checkpoint(str(tmp_path), 1, jstate)
    assert os.listdir(tmp_path / "step_1") and any(
        n.endswith(".zlib") for n in os.listdir(tmp_path / "step_1"))
    want = state_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
    tpl = _port_state("int8", seed=3, steps=0)
    got, step, _ = load_jax_checkpoint(str(tmp_path), tpl)
    assert step == 1
    _assert_trees_equal(got, want)
    assert int(got.opt.step) == 1 and got.opt.step.device == CPU


def test_jax_layout_counts_entries_per_prefix():
    """``jax_checkpoint_layout`` numbers each stack's layers by the layout
    length under its own prefix: here a decoder of 2 entries x 3
    super-blocks beside an encoder of 1 entry x 4, in the params and in a
    moment tree."""
    from repro_torch.convert import jax_checkpoint_layout
    arrays = {}
    for pre in ("params/", "opt/m/"):
        for i in range(2):
            arrays[f"{pre}blocks/#{i}/mixer/wq"] = (
                np.arange(3 * 2).reshape(3, 2) + 10 * i, "float32")
        arrays[f"{pre}encoder/blocks/#0/mixer/wq"] = (
            np.arange(4 * 2).reshape(4, 2) + 100, "float32")
        arrays[f"{pre}encoder/final_norm/scale"] = (np.ones(2), "float32")
    out = jax_checkpoint_layout(arrays)
    for pre in ("params/", "opt/m/"):
        for sb in range(3):
            for i in range(2):
                arr, dtype = out[f"{pre}layers/#{sb * 2 + i}/mixer/wq"]
                np.testing.assert_array_equal(arr, [2 * sb + 10 * i,
                                                    2 * sb + 1 + 10 * i])
        for sb in range(4):
            arr, _ = out[f"{pre}encoder/layers/#{sb}/mixer/wq"]
            np.testing.assert_array_equal(arr, [2 * sb + 100,
                                                2 * sb + 101])
        assert f"{pre}encoder/final_norm/scale" in out
    assert len(out) == 2 * (3 * 2 + 4 + 1)


def test_zstd_shard_raises_a_clear_error(tmp_path, mesh):
    if jck.zstandard is None:
        pytest.skip("the JAX side writes zstd only with zstandard installed")
    jck.save_checkpoint(str(tmp_path), 1, _jax_state(mesh))
    with pytest.raises(CheckpointError, match="zstd"):
        load_jax_checkpoint(str(tmp_path), _port_state("int8", steps=0))
    assert committed_steps(str(tmp_path)) == [1]       # not quarantined


def test_a_jax_run_resumes_on_the_port(tmp_path, monkeypatch, mesh):
    """Two JAX steps, saved by the JAX package; the port's third step from
    that checkpoint against JAX's third step (f32, f32 wire)."""
    import dataclasses
    monkeypatch.setattr(jck, "zstandard", None)
    jcfg = j_smoke_config(ARCH).replace(dtype="float32")
    jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, lsh=dataclasses.replace(
        jcfg.moe.lsh, wire_dtype="float32")))
    tcfg = get_smoke_config(ARCH).replace(dtype="float32")
    tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe, lsh=dataclasses.replace(
        tcfg.moe.lsh, wire_dtype="float32")))
    kw = dict(lr=1e-3, warmup_steps=10, total_steps=100)
    ds = JData(jcfg.vocab_size, 16, 2)
    with set_mesh(mesh):
        jopt = jbase.OptimizerConfig(**kw)
        state = jstep.init_train_state(jax.random.PRNGKey(0), jcfg, jopt,
                                       mesh)
        step = jax.jit(jstep.make_train_step(jcfg, jopt, mesh))
        for s in range(2):
            state, _ = step(state, ds.batch_at(s))
        jck.save_checkpoint(str(tmp_path), 2, state)
        state, jm = step(state, ds.batch_at(2))
        jparams = jax.tree.map(np.asarray, state.params)
    topt = tbase.OptimizerConfig(**kw)
    tpl = tstep.init_train_state(tcfg, topt, seed=5, device=CPU)
    tstate, start, _ = load_jax_checkpoint(str(tmp_path), tpl)
    assert start == 2 and int(tstate.opt.step) == 2
    tstate, tm = tstep.make_train_step(tcfg, topt)(
        tstate, tstep.batch_to_device(ds.batch_at(2), CPU))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    from repro_torch.convert import params_from_jax
    want = {k: x for k, x in ck._flatten(params_from_jax(jparams,
                                                            device="cpu"))}
    worst = 0.0
    for k, p in ck._flatten(tstate.params):
        w = want[k]
        if p.is_floating_point():
            a, b = p.detach().double().numpy(), w.double().numpy()
            worst = max(worst, np.linalg.norm(a - b)
                        / max(np.linalg.norm(b), 1e-30))
        else:
            assert torch.equal(p, w), k
    print(f"third step from a JAX checkpoint: loss port "
          f"{float(tm['loss'])} jax {float(jm['loss'])}; worst param rel "
          f"L2 {worst:.3g}")
    assert worst < 1e-5


# --------------------------------------------- damage and protocol cases --

def _tree(scale=1.0):
    return {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4) * scale,
            "b": torch.full((4,), scale).to(torch.bfloat16), "none": None}


def _shard_path(directory, step):
    d = os.path.join(directory, f"step_{step}")
    name = [n for n in os.listdir(d) if n.startswith("shard_")][0]
    return os.path.join(d, name)


def test_manifest_carries_shard_digests(tmp_path):
    import hashlib
    save_checkpoint(str(tmp_path), 1, _tree())
    with open(tmp_path / "step_1" / "manifest.json") as f:
        manifest = json.load(f)
    [(name, digest)] = manifest["digests"].items()
    blob = (tmp_path / "step_1" / name).read_bytes()
    assert hashlib.sha256(blob).hexdigest() == digest
    assert manifest["arrays"]["b"] == {"kind": "array", "dtype": "bfloat16",
                                       "shape": [4]}


def test_bitflip_quarantined_and_fallback(tmp_path, events):
    save_checkpoint(str(tmp_path), 1, _tree(1.0))
    save_checkpoint(str(tmp_path), 2, _tree(2.0))
    p = _shard_path(tmp_path, 2)
    buf = bytearray(open(p, "rb").read())
    buf[len(buf) // 3] ^= 0x10
    open(p, "wb").write(bytes(buf))
    tree, step, _ = load_checkpoint(str(tmp_path), _tree())
    assert step == 1
    assert torch.equal(tree["w"], _tree(1.0)["w"]) and tree["none"] is None
    assert committed_steps(str(tmp_path)) == [1]
    assert (tmp_path / "quarantine_step_2").is_dir()
    ev = events.of_kind("checkpoint_corrupt")
    assert len(ev) == 1 and ev[0].step == 2
    assert "sha256 mismatch" in ev[0].data["reason"]


def test_truncated_shard_quarantined_and_fallback(tmp_path, events):
    save_checkpoint(str(tmp_path), 1, _tree(1.0))
    save_checkpoint(str(tmp_path), 2, _tree(2.0))
    p = _shard_path(tmp_path, 2)
    blob = open(p, "rb").read()
    open(p, "wb").write(blob[: len(blob) // 2])
    tree, step, _ = load_checkpoint(str(tmp_path), _tree())
    assert step == 1
    assert events.of_kind("checkpoint_corrupt")


def test_missing_shard_with_commit_falls_back(tmp_path, events):
    save_checkpoint(str(tmp_path), 1, _tree(1.0))
    save_checkpoint(str(tmp_path), 2, _tree(2.0))
    os.unlink(_shard_path(tmp_path, 2))
    tree, step, _ = load_checkpoint(str(tmp_path), _tree())
    assert step == 1
    assert "missing" in events.of_kind("checkpoint_corrupt")[0].data["reason"]


def test_all_corrupt_raises_typed_error(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    open(_shard_path(tmp_path, 1), "wb").write(b"garbage")
    with pytest.raises(CheckpointCorruptError, match="every committed"):
        load_checkpoint(str(tmp_path), _tree())


def test_undecodable_shard_with_its_digest_is_corrupt(tmp_path):
    """A shard whose digest matches but whose zlib stream is damaged (the
    manifest was rewritten with it) is still damage, not a crash."""
    import hashlib
    save_checkpoint(str(tmp_path), 1, _tree())
    p = _shard_path(tmp_path, 1)
    open(p, "wb").write(b"garbage")
    mpath = tmp_path / "step_1" / "manifest.json"
    m = json.loads(mpath.read_text())
    m["digests"] = {os.path.basename(p): hashlib.sha256(b"garbage")
                    .hexdigest()}
    mpath.write_text(json.dumps(m))
    with pytest.raises(CheckpointCorruptError, match="undecodable"):
        load_checkpoint(str(tmp_path), _tree(), step=1)


def test_explicit_step_corruption_raises_not_falls_back(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree(1.0))
    save_checkpoint(str(tmp_path), 2, _tree(2.0))
    open(_shard_path(tmp_path, 2), "wb").write(b"garbage")
    with pytest.raises(CheckpointCorruptError):
        load_checkpoint(str(tmp_path), _tree(), step=2)
    _, step, _ = load_checkpoint(str(tmp_path), _tree(), step=1)
    assert step == 1


def test_missing_template_key_is_typed_error(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    bad = dict(_tree(), extra_leaf=torch.zeros(2))
    with pytest.raises(CheckpointError, match="no entry for template leaf"):
        load_checkpoint(str(tmp_path), bad)


def test_template_drift_is_typed_error_not_fallback(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    save_checkpoint(str(tmp_path), 2, _tree())
    for drift in (dict(_tree(), w=torch.zeros(5, 5)),
                  dict(_tree(), b=torch.zeros(4))):          # dtype drift
        with pytest.raises(CheckpointError, match="drift"):
            load_checkpoint(str(tmp_path), drift)
    assert committed_steps(str(tmp_path)) == [1, 2]


def test_quarantined_dirs_are_not_committed_steps(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    os.rename(tmp_path / "step_1", tmp_path / "quarantine_step_1")
    assert committed_steps(str(tmp_path)) == []
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path), _tree())


def test_manager_save_error_surfaces_in_wait(tmp_path, events):
    mgr = CheckpointManager(str(tmp_path / "nope" / "\0bad"))
    mgr.save_async(3, _tree())
    with pytest.raises(CheckpointError, match="step 3 failed"):
        mgr.wait()
    assert events.of_kind("checkpoint_error")
    mgr.directory = str(tmp_path)            # raised once, not latched
    mgr.save_async(4, _tree())
    mgr.wait()
    assert committed_steps(str(tmp_path)) == [4]


def test_manager_save_error_surfaces_in_next_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "nope" / "\0bad"))
    mgr.save_async(3, _tree())
    time.sleep(0.1)
    with pytest.raises(CheckpointError):
        mgr.save_async(4, _tree())


def test_checkpoint_manager_gc_and_commit(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        mgr.save_async(s, {"w": torch.ones(4)})
    mgr.wait()
    assert committed_steps(str(tmp_path)) == [2, 3]
    assert mgr.latest_step() == 3 and mgr.last_bytes > 0
    os.makedirs(tmp_path / "step_9")          # no COMMIT: not a step
    assert committed_steps(str(tmp_path)) == [2, 3]


def test_manager_host_copy_is_taken_before_the_state_moves(tmp_path):
    """The step updates the state in place while the thread writes: the
    save holds the values of the call."""
    tree = {"w": torch.zeros(1 << 16)}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(1, tree)
    tree["w"].add_(1.0)
    mgr.wait()
    got, _, _ = load_checkpoint(str(tmp_path), tree)
    assert not got["w"].any()


def test_resave_of_a_committed_step_and_uncommitted_leftover(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree(1.0))
    save_checkpoint(str(tmp_path), 1, _tree(5.0))      # idempotent no-op
    got, _, _ = load_checkpoint(str(tmp_path), _tree())
    assert torch.equal(got["w"], _tree(1.0)["w"])
    os.makedirs(tmp_path / "step_2")                   # renamed, no COMMIT
    (tmp_path / "step_2" / "junk").write_text("x")
    save_checkpoint(str(tmp_path), 2, _tree(2.0))
    assert committed_steps(str(tmp_path)) == [1, 2]
    assert not (tmp_path / "step_2" / "junk").exists()


def test_events_render_as_jax_console_sink():
    """The trainer's event kinds render as the JAX ConsoleSink prints
    them."""
    data = {
        "resume": (None, {"from_step": 4}),
        "preempt": (3, {}),
        "checkpoint_save": (2, {"path": "/d/step_2"}),
        "checkpoint_restore": (2, {"path": "/d/step_2"}),
        "checkpoint_corrupt": (2, {"path": "/d/step_2", "reason": "sha",
                                   "quarantined": "/d/q"}),
        "checkpoint_error": (2, {"error": "boom"}),
        "chaos": (3, {"fault": "sigkill", "fault_step": 3, "seed": 0,
                      "fault_id": "sigkill@3", "effect": "kill"}),
        "chaos_plan": (None, {"spec": "sigkill@3,seed=0"}),
        "watchdog": (None, {"timeout_s": 5.0, "fired": 2}),
        "straggler": (7, {"dt": 3.0, "ema": 1.0, "factor": 2.0}),
        "data_stall": (None, {"waited_s": 0.3, "timeout_s": 0.1}),
        "restart": (None, {"attempt": 1, "exit_code": -9,
                           "classification": "signal_9", "budgeted": True,
                           "budget_used": 1, "budget": 3,
                           "backoff_s": 0.5}),
        "restart_budget_exhausted": (None, {"budget": 3, "window_s": 60.0,
                                            "exit_code": 43}),
    }
    for kind, (step, d) in data.items():
        t = obs_events.Event(kind, 0.0, step, d)
        j = j_events.Event(kind, 0.0, step, d)
        assert obs_events.render(t) == j_events.render(j), kind
        assert kind in obs_events._RENDERERS, kind
