"""The port's fault-injection plan, supervisor policy, watchdog, straggler
monitor, expert rebalancer, prefetch iterator, chaos loss-scale hook and
``apply_placement_update``, on the CPU, each against the JAX package's
(tests/test_resilience.py) where it has a counterpart with numbers: the
rebalancer's loads, imbalance and proposal, and the permuted expert
weights, must be equal to JAX's (``apply_placement_update`` bit for bit).
"""
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # parallel test workers share the cores
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.core import lsh_moe as j_lsh_moe
from repro.runtime import fault as j_fault
from repro_torch.configs import base as tbase
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core.lsh_moe import apply_placement_update
from repro_torch.data.pipeline import DataStallError, PrefetchIterator, place
from repro_torch.obs import events as obs_events
from repro_torch.resilience.faults import ONCE, STATE_NAME, Fault, FaultPlan
from repro_torch.resilience.supervisor import (backoff_seconds, classify_exit,
                                               supervise)
from repro_torch.runtime import step as tstep
from repro_torch.runtime.fault import (EXIT_PREEMPTED, EXIT_WATCHDOG,
                                       ExpertRebalancer, StepWatchdog,
                                       StragglerMonitor)

ARCH = "granite-moe-3b-a800m"
CPU = torch.device("cpu")


@pytest.fixture
def events():
    log = obs_events.global_log()
    mem = obs_events.MemorySink()
    log.add_sink(mem)
    yield mem
    log.remove_sink(mem)


# ---------------------------------------------------------- chaos grammar --

def test_chaos_spec_parse_and_describe():
    p = FaultPlan.parse("sigkill@5, nan_grads@3, hang@7:2.5, seed=11")
    assert p.seed == 11
    assert [f.fault_id for f in p.faults] == ["nan_grads@3", "sigkill@5",
                                              "hang@7"]
    assert p.faults[2].seconds() == 2.5
    assert Fault("hang", 1).seconds() == 3600.0
    assert Fault("data_stall", 1).seconds() == 1.0
    q = FaultPlan.parse(p.describe())
    assert q.faults == p.faults and q.seed == p.seed


@pytest.mark.parametrize("spec", [
    "bogus@3", "nan_grads", "nan_grads@x", "nan_grads@-1", "hang@3:abc",
    "hang@3:-1", "hang@3:inf", "seed=x", "seed=3", ""])
def test_chaos_spec_rejects_bad_entries(spec):
    with pytest.raises(ValueError):
        FaultPlan.parse(spec)


def test_chaos_once_markers_persist_across_plans(tmp_path, events):
    state = str(tmp_path / STATE_NAME)
    p = FaultPlan.parse("hang@2:0.0")
    p.bind_state(state)
    t0 = time.monotonic()
    p.on_step_start(2)                    # fires (a 0 s hang), marks
    assert time.monotonic() - t0 < 5.0 and os.path.exists(state)
    assert [e.data["fault"] for e in events.of_kind("chaos")] == ["hang"]
    q = FaultPlan.parse("hang@2:0.0")     # a restarted process's plan
    q.bind_state(state)
    q.on_step_start(2)
    assert len(events.of_kind("chaos")) == 1
    assert ONCE.isdisjoint({"nan_grads", "data_stall"})
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".chaos-")]


def test_chaos_loss_scale_identity_and_injection(events):
    p = FaultPlan.parse("nan_grads@3")
    assert p.wants_loss_scale()
    assert p.loss_scale(2) == np.float32(1.0)
    assert np.isnan(p.loss_scale(3))
    ev = events.of_kind("chaos")[-1]
    assert ev.data["fault"] == "nan_grads" and ev.step == 3
    b = {"tokens": np.zeros(3)}
    assert tstep.CHAOS_LOSS_SCALE_KEY in p.chaos_batch(b, 1)
    assert tstep.CHAOS_LOSS_SCALE_KEY not in b
    assert FaultPlan.parse("sigkill@5").chaos_batch(b, 1) is b


def test_chaos_corruption_is_seed_deterministic(tmp_path):
    blob = bytes(range(256)) * 8
    paths = []
    for i in range(2):
        f = tmp_path / f"shard{i}"
        f.write_bytes(blob)
        paths.append(str(f))
    d0 = FaultPlan([Fault("ckpt_flip", 1)], seed=7)._corrupt_file(
        paths[0], truncate=False, salt=1)
    d1 = FaultPlan([Fault("ckpt_flip", 1)], seed=7)._corrupt_file(
        paths[1], truncate=False, salt=1)
    assert d0 == d1
    assert (tmp_path / "shard0").read_bytes() == \
        (tmp_path / "shard1").read_bytes() != blob
    d2 = FaultPlan([Fault("ckpt_flip", 1)], seed=8)._corrupt_file(
        paths[0], truncate=False, salt=1)
    assert d2 != d0


def test_file_faults_damage_only_from_the_writer(tmp_path, events):
    """Over a mesh every rank fires the fault; only rank 0 (the writer)
    touches the shared file, and each marks it fired."""
    from repro_torch.checkpoint.checkpoint import save_checkpoint
    ck = tmp_path / "ck"
    save_checkpoint(str(ck), 1, {"w": torch.ones(64)})
    shard = ck / "step_1" / "shard_0.msgpack.zlib"
    before = shard.read_bytes()
    other = FaultPlan.parse("ckpt_flip@0")
    other.bind_state(str(tmp_path / "r1" / STATE_NAME))
    other.on_step_end(0, ckpt_dir=str(ck), writer=False)
    assert shard.read_bytes() == before
    assert events.of_kind("chaos")
    writer = FaultPlan.parse("ckpt_flip@0")
    writer.on_step_end(0, ckpt_dir=str(ck), writer=True)
    assert shard.read_bytes() != before
    again = FaultPlan.parse("ckpt_flip@0")
    again.bind_state(str(tmp_path / "r1" / STATE_NAME))
    n = len(events.of_kind("chaos"))
    again.on_step_end(1, ckpt_dir=str(ck), writer=True)
    assert len(events.of_kind("chaos")) == n


def test_tune_cache_corruption_rejected_with_event(tmp_path, monkeypatch,
                                                   events):
    from repro_torch.comm.topology import Topology
    from repro_torch.tune import cache as tune_cache
    from repro_torch.tune.fingerprint import fingerprint_for
    monkeypatch.setenv(tune_cache.ENV_CACHE, str(tmp_path))
    fp = fingerprint_for(None, Topology(axis_sizes=(("data", 2),
                                                    ("model", 8)),
                                        node_size=4), "model")
    tune_cache.store(fp, {"rows": []})
    assert tune_cache.load(fp) is not None
    FaultPlan.parse("tune_corrupt@0").on_step_end(0)   # the cache's dir
    assert tune_cache.load(fp) is None
    rej = events.of_kind("tune_cache_reject")
    assert len(rej) == 1 and "unreadable" in rej[0].data["reason"]
    assert events.of_kind("chaos")[0].data["fault"] == "tune_corrupt"


# ------------------------------------------------------ the loss-scale hook --

def _smoke():
    cfg = get_smoke_config(ARCH)
    opt = tbase.OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    return cfg, opt, batch


def _leaves_bits(tree):
    from repro_torch.optim.adam import leaves
    return [t.detach().clone() for t in leaves(tree) if t is not None]


def test_train_step_chaos_scale_skips_update():
    """A NaN loss scale takes the skip path (params unchanged, one skip
    counted, the logged loss finite); a 1.0 scale gives the bits of a
    step without the key."""
    cfg, opt, batch = _smoke()
    step = tstep.make_train_step(cfg, opt)
    plain, m0 = step(tstep.init_train_state(cfg, opt, device=CPU),
                     dict(batch))
    one = dict(batch, **{tstep.CHAOS_LOSS_SCALE_KEY: np.float32(1.0)})
    scaled, m1 = step(tstep.init_train_state(cfg, opt, device=CPU), one)
    for a, b in zip(_leaves_bits(plain), _leaves_bits(scaled)):
        assert torch.equal(a, b)
    start = tstep.init_train_state(cfg, opt, device=CPU)
    before = _leaves_bits(start.params)
    nan = dict(batch, **{tstep.CHAOS_LOSS_SCALE_KEY: np.float32(np.nan)})
    skipped, m2 = step(start, nan)
    for a, b in zip(before, _leaves_bits(skipped.params)):
        assert torch.equal(a, b)
    assert int(m2["grad_skips"]) == 1 and int(m1["grad_skips"]) == 0
    assert int(m0["grad_skips"]) == 0 and np.isfinite(float(m2["loss"]))
    # the scale as the launcher places it (a 0-d tensor) keeps the skip
    # count a scalar, as a checkpoint template has it
    host = {k: v.numpy() for k, v in batch.items()}
    placed = place(dict(host, **{tstep.CHAOS_LOSS_SCALE_KEY:
                                 np.float32(np.nan)}), CPU)
    assert placed[tstep.CHAOS_LOSS_SCALE_KEY].shape == ()
    again, m3 = step(skipped, placed)
    assert again.opt.grad_skips.shape == () and int(m3["grad_skips"]) == 2


def test_train_step_ops_unchanged_without_chaos_key():
    """Without the key the hooked step dispatches the same ops, in the
    same order, as a step built from its two halves without the hook."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    cfg, opt, batch = _smoke()
    accum = tstep.make_accum_grad_fn(cfg)

    def unhooked(st, b):
        loss, metrics, grads = accum(st.params, b)
        return tstep.apply_gradients(st, opt, loss, metrics, grads)

    traces = []
    for fn in (tstep.make_train_step(cfg, opt), unhooked):
        state = tstep.init_train_state(cfg, opt, device=CPU)
        with Ops() as mode:
            fn(state, dict(batch))
        traces.append(mode.ops)
    assert traces[0] == traces[1] and len(traces[0]) > 100


# ------------------------------------------------------------- supervisor --

def test_classify_exit_policy():
    done = classify_exit(0)
    assert (done.restart, done.budgeted) == (False, False)
    pre = classify_exit(EXIT_PREEMPTED)
    assert (pre.name, pre.restart, pre.budgeted) == ("preempted", True, False)
    wd = classify_exit(EXIT_WATCHDOG)
    assert (wd.name, wd.restart, wd.budgeted) == ("watchdog", True, True)
    use = classify_exit(2)
    assert (use.restart, use.budgeted) == (False, False)
    sig = classify_exit(-9)
    assert (sig.name, sig.restart, sig.budgeted) == ("signal_9", True, True)
    crash = classify_exit(1)
    assert (crash.name, crash.restart, crash.budgeted) == ("crash", True, True)


def test_backoff_grows_and_caps():
    rng = np.random.default_rng(0)
    seq = [backoff_seconds(n, 1.0, 60.0, rng) for n in (1, 2, 3, 4)]
    assert 1.0 <= seq[0] <= 1.25 and 2.0 <= seq[1] <= 2.5
    assert 4.0 <= seq[2] <= 5.0 and 8.0 <= seq[3] <= 10.0
    assert backoff_seconds(50, 1.0, 60.0, rng) <= 60.0 * 1.25
    assert backoff_seconds(3, 0.0, 60.0, rng) == 0.0


def test_supervisor_preemptions_never_burn_budget(events):
    codes = iter([EXIT_PREEMPTED] * 10 + [1, 0])
    rc = supervise(lambda: next(codes), max_restarts=1, window_s=100.0,
                   backoff_base_s=0.0, clock=lambda: 0.0, sleep=lambda s: 0)
    assert rc == 0
    restarts = events.of_kind("restart")
    assert len(restarts) == 11
    assert sum(e.data["budgeted"] for e in restarts) == 1
    assert all(e.data["backoff_s"] == 0.0
               for e in restarts if not e.data["budgeted"])


def test_supervisor_budget_exhaustion_returns_last_code(events):
    codes = iter([EXIT_WATCHDOG] * 10)
    rc = supervise(lambda: next(codes), max_restarts=3, window_s=100.0,
                   backoff_base_s=0.0, clock=lambda: 0.0, sleep=lambda s: 0)
    assert rc == EXIT_WATCHDOG
    assert len(events.of_kind("restart")) == 3
    ex = events.of_kind("restart_budget_exhausted")
    assert len(ex) == 1 and ex[0].data["budget"] == 3


def test_supervisor_budget_window_rolls(events):
    times = iter([0.0, 100.0, 200.0, 300.0, 400.0, 500.0])
    codes = iter([1, 1, 1, 1, 1, 0])
    rc = supervise(lambda: next(codes), max_restarts=2, window_s=50.0,
                   backoff_base_s=0.0, clock=lambda: next(times),
                   sleep=lambda s: 0)
    assert rc == 0
    assert len(events.of_kind("restart")) == 5
    assert not events.of_kind("restart_budget_exhausted")


def test_supervisor_usage_error_never_restarts(events):
    calls = []
    rc = supervise(lambda: calls.append(1) or 2, max_restarts=3,
                   window_s=100.0, backoff_base_s=0.0)
    assert rc == 2 and len(calls) == 1
    assert not events.of_kind("restart")


def test_supervisor_sleeps_backoff_and_reads_env(monkeypatch):
    codes = iter([1, 1, 0])
    slept = []
    rc = supervise(lambda: next(codes), max_restarts=5, window_s=100.0,
                   backoff_base_s=1.0, seed=0, clock=lambda: 0.0,
                   sleep=slept.append)
    assert rc == 0 and len(slept) == 2
    assert 1.0 <= slept[0] <= 1.25 and 2.0 <= slept[1] <= 2.5
    monkeypatch.setenv("MAX_RESTARTS", "1")
    monkeypatch.setenv("RESTART_BACKOFF_S", "0")
    codes = iter([1, 1, 0])
    assert supervise(lambda: next(codes), clock=lambda: 0.0) == 1


# ------------------------------------------------ watchdog and straggler --

def test_watchdog_survives_nonexiting_callback_and_rearms(events):
    fired = []
    wd = StepWatchdog(0.2, on_timeout=lambda: fired.append(1))
    wd.arm()
    time.sleep(0.9)
    assert len(fired) == 1
    wd.arm()
    time.sleep(0.9)
    assert len(fired) == 2
    wd.arm()
    wd.disarm()
    time.sleep(0.5)
    assert len(fired) == 2 and wd.fired == 2
    assert [e.data["fired"] for e in events.of_kind("watchdog")] == [1, 2]
    wd.stop()


def test_straggler_clamps_outlier_and_skips_warmup():
    mon = StragglerMonitor(threshold=2.0, ema=0.9, warmup=1)
    assert not mon.record(0, 100.0)
    assert mon.ema is None
    for s in range(1, 11):
        assert not mon.record(s, 1.0)
    assert mon.record(11, 50.0)
    assert mon.ema <= 2.0 * 1.0 + 1e-6
    assert mon.record(12, 50.0)
    assert mon.flagged == [11, 12]


# ------------------------------------------------------------ rebalancer --

def test_rebalancer_matches_jax():
    rng = np.random.default_rng(4)
    ne, nr = 40, 4
    placement = rng.permutation(ne).astype(np.int32)
    port, ref = ExpertRebalancer(ne, nr), j_fault.ExpertRebalancer(ne, nr)
    for _ in range(30):
        counts = rng.zipf(1.5, size=ne).astype(np.float64)
        port.record(counts, placement)
        ref.record(counts, placement)
    np.testing.assert_array_equal(port.load, ref.load)
    assert port.imbalance(placement) == ref.imbalance(placement)
    got, want = port.propose(placement), ref.propose(placement)
    assert want is not None
    np.testing.assert_array_equal(got, want)
    even = ExpertRebalancer(ne, nr)
    even.record(np.ones(ne))
    assert even.propose(np.arange(ne)) is None


# ------------------------------------------------------------ data stall --

def test_prefetch_stall_emits_events_then_raises(events):
    release = threading.Event()

    def slow():
        release.wait(10.0)
        yield 1

    it = PrefetchIterator(slow(), stall_timeout_s=0.1, stall_max_s=0.35)
    with pytest.raises(DataStallError):
        next(it)
    release.set()
    stalls = events.of_kind("data_stall")
    assert len(stalls) >= 3 and stalls[0].data["timeout_s"] == 0.1


def test_prefetch_stall_recovers_when_slow_not_dead(events):
    def slow():
        time.sleep(0.3)
        yield 42

    it = PrefetchIterator(slow(), stall_timeout_s=0.1, stall_max_s=30.0)
    assert next(it) == 42
    assert events.of_kind("data_stall")
    with pytest.raises(StopIteration):
        next(it)
    with pytest.raises(StopIteration):
        next(it)


def test_prefetch_reraises_producer_error_and_places():
    def bad():
        yield {"tokens": np.arange(4, dtype=np.int32)}
        raise KeyError("loader broke")

    it = PrefetchIterator(bad(), depth=1, place=lambda b: place(b, CPU))
    first = next(it)
    assert isinstance(first["tokens"], torch.Tensor)
    assert first["tokens"].tolist() == [0, 1, 2, 3]
    with pytest.raises(KeyError, match="loader broke"):
        next(it)


# ------------------------------------------------- placement update --

def test_apply_placement_update_matches_jax():
    """A granite-smoke MoE layer's params (JAX-made), a new placement: the
    permuted expert weights and the placement bit for bit."""
    from repro.configs.registry import get_smoke_config as j_smoke
    from repro.launch.mesh import make_host_mesh
    from repro_torch.convert import params_from_jax
    jcfg = j_smoke(ARCH)
    jp = j_lsh_moe.lsh_moe_init(jax.random.PRNGKey(3), jcfg.d_model,
                                jcfg.moe, make_host_mesh(1, 1, 1),
                                mlp_act=jcfg.mlp_act, dtype=jnp.bfloat16)
    ne = jcfg.moe.num_experts
    new = np.random.default_rng(0).permutation(ne).astype(np.int32)
    want = j_lsh_moe.apply_placement_update(jp, jnp.asarray(new),
                                            jp["placement"])
    tp = params_from_jax({"blocks": [], **{k: np.asarray(v)
                                          for k, v in jp.items()}},
                         device="cpu")
    got = apply_placement_update(tp, torch.from_numpy(new),
                                 tp["placement"])
    for k in ("w_gate", "w_up", "w_down", "placement", "router_w"):
        w = np.asarray(want[k])
        if w.dtype.name == "bfloat16":
            w = w.view(np.int16)
            g = got[k].view(torch.int16).numpy()
        else:
            g = got[k].numpy()
        np.testing.assert_array_equal(g, w, err_msg=k)
    assert not torch.equal(got["w_up"], tp["w_up"])
