"""Training launcher with fault tolerance (counterpart of
``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train \
      --arch granite-moe-3b-a800m --steps 200 --batch 4 --seq 1024 \
      --ckpt /data/run1 --ckpt-every 50

Runs on the CUDA device unless ``--device cpu``.  The optimizer is the JAX
launcher's: ``OptimizerConfig(lr=1e-3, warmup_steps=min(20, steps // 5),
total_steps=steps)``; the data is ``SyntheticLMDataset`` (the JAX
package's batches, bit for bit, a pure function of the step): tokens and
labels, so internvl2-26b trains on text alone (no patch prefix), as in
the JAX launcher, and whisper-base, whose encoder needs frames, raises a
ValueError.  Prints one
JSON ``step`` line per logged step (step, loss, ce, lr, dt, skips) and a
final ``train_summary`` line: steps run by this process, mean step ms
after the first, tokens/s over those steps, final loss, and the peak of
``torch.cuda.max_memory_allocated`` (null on the CPU), and on a pipe
mesh whether every pipe column's losses were bit-equal; the other events
print as one line each (``obs.events.render``).  ``dt`` is the host clock
around a step, which ends in a synchronise (the loss is read back).

Fault tolerance (resilience/, checkpoint/, runtime/fault.py):

 * ``--ckpt DIR``: resume from the newest committed step (a damaged one
   is quarantined and the one before it restored), save every
   ``--ckpt-every`` steps (asynchronously: the host copy blocks, the write
   does not) and at the end.  The resumed trajectory is bitwise the
   uninterrupted one: the batches are a function of the step and the
   restore gives back every byte of the state.
 * SIGTERM: save, wait for it, exit 42.  Over a mesh the ranks agree on
   it each step (a rank's SIGTERM stops every rank).
 * ``--watchdog-s``: a step that outlives it exits 43.
 * ``--straggler-factor``: a ``straggler`` event for a step slower than
   that multiple of the EMA step time.
 * the MoE layers' ``expert_load`` feeds ``ExpertRebalancer``, which
   records it (no placement is applied, as in the JAX launcher).
 * ``--chaos SPEC`` / ``$REPRO_CHAOS``: step-addressed faults
   (resilience/faults.py); a bad spec exits 2.
 * ``--auto-restart``: supervise this run as a child process, restarting
   it by its exit class ($MAX_RESTARTS within $RESTART_WINDOW_S, backoff
   from $RESTART_BACKOFF_S; preemptions free, usage errors never).  A
   one-process run only: under torchrun it is a usage error.

Observability (obs/), as in the JAX launcher: ``--metrics-dir DIR`` turns
on the in-graph metrics and the phase ranges (``ObsConfig``), appends
every event to ``DIR/events.jsonl`` (the supervisor's too), and at exit
writes ``DIR/trace.json`` (the step timeline as Chrome trace events) and
``DIR/metrics.json``: the comm share of the modeled phase split
(obs/timeline.py, set after the first step), the final step's scalar
metrics (``obs_compression_rate``, the live Eq. 5 rate, among them) and
the anomaly counts.  ``--profile N`` runs ``torch.profiler`` (CPU and,
on the card, CUDA activities) over N steps from the first steady one,
writes each rank's Chrome trace under ``DIR/torch_trace/``, parses it
into the measured device seconds of each phase (obs/profile.py; over a
mesh the ranks' sums are averaged), and reconciles them with the modeled
split: ``measured_*`` and ``model_*`` keys in metrics.json,
``model_drift`` events, and the drift recorded in the tune cache when a
calibration is in play.  The anomaly detectors (obs/anomaly.py) watch
step time, loss, comm share, stragglers and load imbalance whenever
``--metrics-dir`` is on; ``--anomaly-exit`` escalates a persistent
slowdown to a checkpoint and exit 43 (``resilience.supervisor.
AnomalyEscalator``).  As in the JAX launcher, a step's time starts after
the chaos hook (an injected stall or hang is not the step's), while the
watchdog is armed before it (a hang must trip it) and disarmed before
the timeline stops.

Expert parallelism: ``--mesh-data D --mesh-model M`` trains over a
(data, model) mesh of D * M ranks, started by torchrun:

  PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \
      -m repro_torch.launch.train --arch granite-moe-3b-a800m --smoke \
      --device cpu --mesh-model 2 --steps 2 --batch 2 --seq 32

Each rank runs on ``cuda:$LOCAL_RANK`` (NCCL) unless ``--device cpu``
(gloo); every rank reads the same batches and keeps its part.  Only
rank 0 prints and writes files; a checkpoint holds the logical state
and restores on another mesh of the same padded expert count.
Tokens/s counts the whole mesh's tokens.  ``--node-size N`` says how
many ranks a node holds along the model axis (the planner's 2-hop
transport; 0: $REPRO_NODE_SIZE, else torchrun's LOCAL_WORLD_SIZE across
hosts).  ``--autotune`` probes the mesh and fills the comm tuning cache
before step 0 (tune/), and makes this run read it unless $REPRO_TUNE is
set; ``CommConfig.tuning="probe"`` probes on a cache miss without the
flag.

Pipeline parallelism: ``--mesh-pipe P`` adds a pipe axis, a (data, pipe,
model) mesh of D * P * M ranks, and trains with the 1F1B step
(runtime/pipeline_schedule.py) over ``--pipeline-microbatches`` (0: P)
microbatches; the pipe indices hold the same params and rows.  The comm
plans print as ``[comm] plan: bubble ...`` (the model axis) and the
stage hand-offs on ``pipe``, and ``--metrics-dir``'s trace.json gains one
row per stage of the 1F1B grid with its ``a2a`` marks.  A mesh of more
ranks than the job has exits 2:

  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \
      -m repro_torch.launch.train --arch qwen3-moe-30b-a3b --smoke \
      --device cpu --mesh-pipe 2 --mesh-model 2 \
      --pipeline-microbatches 4 --steps 2 --batch 8 --seq 32
"""
from __future__ import annotations

import argparse
import math
import os
import subprocess
import sys

_JSON_KINDS = ("step", "train_summary", "tune_calibrated")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-sized)")
    ap.add_argument("--lsh", default=None, choices=("on", "off"))
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--ckpt", default="",
                    help="checkpoint directory: resume from its newest "
                         "committed step, save every --ckpt-every steps")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--watchdog-s", type=float, default=600.0,
                    help="exit 43 when a step takes longer than this")
    ap.add_argument("--straggler-factor", type=float, default=2.0,
                    help="flag a step as a straggler when it exceeds this "
                         "multiple of the EMA step time")
    ap.add_argument("--auto-restart", action="store_true",
                    help="supervise this (one-process) run and restart it "
                         "by its exit class")
    ap.add_argument("--chaos", default=os.environ.get("REPRO_CHAOS", ""),
                    help="fault-injection spec, e.g. 'nan_grads@3,"
                         "sigkill@5,hang@7:2.5,seed=1' (also $REPRO_CHAOS)")
    ap.add_argument("--metrics-dir", default="",
                    help="write events.jsonl, trace.json (Perfetto) and "
                         "metrics.json here and turn on the in-graph "
                         "metrics and phase ranges (ObsConfig)")
    ap.add_argument("--profile", type=int, default=0,
                    help="run torch.profiler over N steady steps (the "
                         "first step is skipped) into <metrics-dir>/"
                         "torch_trace, parse it into the measured per-"
                         "phase device time and reconcile it with the "
                         "modeled split (requires --metrics-dir)")
    ap.add_argument("--anomaly-exit", action="store_true",
                    help="checkpoint and exit 43 when the anomaly "
                         "detectors see persistent degradation, for "
                         "--auto-restart's budgeted supervisor")
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-pipe", type=int, default=1,
                    help="pipeline stages: a (data, pipe, model) mesh "
                         "trained with the 1F1B schedule")
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--pipeline-microbatches", type=int, default=0,
                    help="1F1B microbatches (0 = --mesh-pipe)")
    ap.add_argument("--node-size", type=int, default=0,
                    help="ranks a node along the model axis (0 = "
                         "$REPRO_NODE_SIZE, else LOCAL_WORLD_SIZE)")
    ap.add_argument("--autotune", action="store_true",
                    help="probe the mesh and fill the comm tuning cache "
                         "before step 0, and read it in this run")
    return ap


def supervise_cli(argv, metrics_dir: str) -> int:
    """--auto-restart: run this launcher as a child until it finishes,
    restarting it by the supervisor's policy; the restart events go to
    the console and to the run's events.jsonl."""
    from repro_torch.obs import events as obs_events
    from repro_torch.resilience import supervisor as sup
    log = obs_events.global_log()
    sinks = [log.add_sink(obs_events.ConsoleSink())]
    jsonl = None
    if metrics_dir:
        jsonl = obs_events.JsonlSink(os.path.join(metrics_dir,
                                                  "events.jsonl"))
        sinks.append(log.add_sink(jsonl))
    child = [a for a in argv if a != "--auto-restart"]
    try:
        return sup.supervise(lambda: subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", *child]
        ).returncode)
    finally:
        for s in sinks:
            log.remove_sink(s)
        if jsonl is not None:
            jsonl.close()


def main(argv=None) -> int:
    ap = _parser()
    argv = list(sys.argv[1:] if argv is None else argv)
    args = ap.parse_args(argv)
    if args.profile and not args.metrics_dir:
        ap.error("--profile requires --metrics-dir: the device trace and "
                 "its measured-timeline artifacts land under "
                 "<metrics-dir> (torch_trace/, metrics.json)")

    from repro_torch import resolve_device
    dev = resolve_device(args.device)
    n_mesh = args.mesh_data * args.mesh_pipe * args.mesh_model
    if args.auto_restart:
        if "RANK" in os.environ or n_mesh > 1:
            ap.error("--auto-restart supervises a one-process run; under "
                     "torchrun (or with a mesh) restart the job from its "
                     "launcher instead")
        return supervise_cli(argv, args.metrics_dir)

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.obs import events as obs_events
    from repro_torch.obs import export as obs_export

    mesh, own_group = None, False
    world = dist.get_world_size() if dist.is_initialized() else \
        int(os.environ.get("WORLD_SIZE", "1") or 1)
    if n_mesh > world:
        sink = obs_events.global_log().add_sink(obs_events.ConsoleSink())
        try:
            obs_events.emit(
                "error", where="train",
                message=(f"mesh {args.mesh_data}x{args.mesh_pipe}x"
                         f"{args.mesh_model} needs {n_mesh} devices, have "
                         f"{world} (start that many ranks with torchrun)"))
        finally:
            obs_events.global_log().remove_sink(sink)
        return 2
    if "RANK" in os.environ or n_mesh > 1 or dist.is_initialized():
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        own_group = not dist.is_initialized()
        init_distributed(dev)
        mesh = make_mesh(args.mesh_data, args.mesh_model, args.mesh_pipe,
                         node_size=args.node_size)
    log = obs_events.global_log()
    sinks, jsonl, mem = [], None, None
    if mesh is None or mesh.rank == 0:
        sinks.append(log.add_sink(lambda ev: print(
            ev.to_json() if ev.kind in _JSON_KINDS
            else obs_events.render(ev),
            file=sys.stderr if ev.kind == "error" else sys.stdout,
            flush=True)))
        if args.metrics_dir:
            jsonl = obs_events.JsonlSink(
                os.path.join(args.metrics_dir, obs_export.EVENTS_NAME))
            mem = obs_events.MemorySink()   # the events for trace.json
            sinks += [log.add_sink(jsonl), log.add_sink(mem)]
    try:
        rc = _train(args, dev, mesh, mem)
    finally:
        for s in sinks:
            log.remove_sink(s)
        if jsonl is not None:
            jsonl.close()
    if own_group:          # every rank returns here, with the same code
        dist.barrier()
        dist.destroy_process_group()
    return rc


def _train(args, dev, mesh, mem) -> int:
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.checkpoint.checkpoint import (CheckpointManager,
                                                   load_checkpoint)
    from repro_torch.comm import collectives
    from repro_torch.comm import planner as comm_planner
    from repro_torch.comm.collectives import any_rank
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.data.pipeline import place
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.obs import events as obs_events
    from repro_torch.obs import export as obs_export
    from repro_torch.obs import timeline as timeline_lib
    from repro_torch.optim.adam import leaves
    from repro_torch.runtime import params as params_lib
    from repro_torch.runtime import sharding
    from repro_torch.runtime.fault import (EXIT_PREEMPTED, EXIT_WATCHDOG,
                                           ExpertRebalancer,
                                           PreemptionHandler, StepWatchdog,
                                           StragglerMonitor)
    from repro_torch.models.model import torch_dtype
    from repro_torch.runtime.step import init_train_state, make_train_step
    from repro_torch.tune import runtime as tune_runtime
    # torch.utils.checkpoint imports torch._dynamo (and sympy) on its first
    # call, seconds on a loaded host: import it here, before the first
    # step arms the watchdog
    import torch._dynamo  # noqa: F401

    emit = obs_events.emit
    rank0 = mesh is None or mesh.rank == 0
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.encoder_decoder:
        raise ValueError(
            f"{args.arch} is an encoder-decoder model: its batches need "
            "frames [B, S_enc, d_model], and this launcher's synthetic "
            "dataset makes tokens and labels only (as the JAX launcher's, "
            "which cannot feed it either); train it through "
            "runtime.step.make_train_step with a batch that holds frames")
    if args.mesh_pipe > 1:
        cfg = cfg.replace(pipeline_microbatches=args.pipeline_microbatches)
    if args.metrics_dir:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, obs=dataclasses.replace(cfg.moe.obs, enabled=True)))
    chaos = None
    if args.chaos:
        from repro_torch.resilience.faults import STATE_NAME, FaultPlan
        try:
            chaos = FaultPlan.parse(args.chaos)
        except ValueError as exc:
            emit("error", where="chaos", message=str(exc))
            return 2
        state_dir = args.ckpt or args.metrics_dir
        if state_dir:
            # the fired-markers must survive the kills the plan causes
            os.makedirs(state_dir, exist_ok=True)
            chaos.bind_state(os.path.join(state_dir, STATE_NAME))
        emit("chaos_plan", spec=chaos.describe())
    comm = cfg.moe.comm if cfg.has_moe() else None
    if args.autotune:
        # a cache that nobody reads is of no use: this run reads it
        os.environ.setdefault(tune_runtime.ENV_TUNE, "cache")
    if cfg.has_moe() and (args.autotune
                          or tune_runtime.tuning_mode(comm) == "probe"):
        calib = tune_runtime.ensure_calibrated(mesh, comm,
                                               probe=args.autotune,
                                               device=dev)
        if calib is not None:
            emit("tune_calibrated", fingerprint=calib.key)
    opt = OptimizerConfig(lr=1e-3, warmup_steps=min(20, args.steps // 5),
                          total_steps=args.steps)
    use_lsh = None if args.lsh is None else (args.lsh == "on")
    ds = SyntheticLMDataset(cfg.vocab_size, args.seq, args.batch)
    preempt = PreemptionHandler()
    watchdog = StepWatchdog(args.watchdog_s)
    straggler = StragglerMonitor(threshold=args.straggler_factor)
    timeline = timeline_lib.StepTimeline()
    specs = params_lib.train_state_specs(cfg, mesh, opt.moment_dtype)
    mgr = CheckpointManager(args.ckpt, keep=3, mesh=mesh, specs=specs) \
        if args.ckpt else None
    monitor = escalator = None
    if args.metrics_dir:
        from repro_torch.obs import anomaly as anomaly_lib
        monitor = anomaly_lib.AnomalyMonitor()
        if args.anomaly_exit:
            from repro_torch.resilience.supervisor import AnomalyEscalator
            escalator = AnomalyEscalator()
            monitor.add_consumer(escalator.consume)
    rebalancer = placement = None
    if cfg.has_moe():
        rebalancer = ExpertRebalancer(cfg.moe.num_experts,
                                      sharding.axis_size(mesh, "model"))
        # expert_load comes in physical slot order; the identity until a
        # placement is applied (core.lsh_moe.apply_placement_update)
        placement = np.arange(cfg.moe.num_experts, dtype=np.int32)
    n_mb = (cfg.pipeline_microbatches or args.mesh_pipe) \
        if args.mesh_pipe > 1 else 1
    stage_msg_bytes = 0
    if args.mesh_pipe > 1:
        stage_msg_bytes = (args.batch // max(1, n_mb)) * args.seq \
            * cfg.d_model * torch.empty(
                (), dtype=torch_dtype(cfg.dtype)).element_size()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    world = sharding.world_group(mesh)
    prof = _Profile(args, dev, mesh, world, cfg, comm)
    state = init_train_state(cfg, opt, seed=0, device=dev, mesh=mesh)
    start = 0
    if mgr and mgr.latest_step() is not None:
        state, start, _ = load_checkpoint(args.ckpt, state, mesh=mesh,
                                          specs=specs)
        emit("resume", from_step=start)
    step_fn = make_train_step(cfg, opt, use_lsh=use_lsh, mesh=mesh)

    def export_artifacts(final_metrics) -> None:
        """metrics.json and trace.json under --metrics-dir (rank 0), after
        the profile's analysis (a collective over the mesh)."""
        prof.stop()
        if not args.metrics_dir:
            return
        profile_extra = prof.analyze()
        if not rank0:
            return
        sched = None
        if args.mesh_pipe > 1:
            from repro_torch.runtime.pipeline_schedule import build_1f1b
            sched = build_1f1b(args.mesh_pipe, n_mb)
        obs_export.write_chrome_trace(
            os.path.join(args.metrics_dir, obs_export.TRACE_NAME),
            timeline, mem.events if mem is not None else (),
            schedule=sched)
        extra = {k: float(v) for k, v in (final_metrics or {}).items()
                 if v.ndim == 0}
        extra.update(profile_extra)
        if monitor is not None:
            for det, n in monitor.counts().items():
                extra[f"anomaly_{det}"] = float(n)
        obs_export.write_metrics_json(
            os.path.join(args.metrics_dir, obs_export.METRICS_NAME),
            timeline, extra=extra)

    dts, losses, loss, metrics = [], [], float("nan"), {}
    try:
        for s in range(start, args.steps):
            if args.profile and (s == start + 1 or args.steps - start == 1):
                prof.start()
            batch = ds.batch_at(s)
            watchdog.arm()
            if chaos is not None:
                # after arm(): a hang must trip the watchdog; before the
                # timeline: an injected stall is not the step's time
                chaos.on_step_start(s)
                batch = chaos.chaos_batch(batch, s)
            timeline.start(s)
            state, metrics = step_fn(state, place(batch, dev))
            loss = float(metrics["loss"])       # waits for the step
            watchdog.disarm()
            rec = timeline.stop(s)
            dt = rec.duration
            dts.append(dt)
            losses.append(loss)
            if s == start:
                # the first step resolved the comm plan: the modeled split
                prof.modeled = timeline_lib.model_phase_seconds(
                    _effective(cfg, use_lsh), mesh, batch=args.batch,
                    seq=args.seq, stage_msg_bytes=stage_msg_bytes)
                timeline.set_phase_seconds(prof.modeled)
            prof.step_done(args.profile)
            is_straggler = straggler.record(s, dt)
            if is_straggler:
                emit("straggler", step=s, dt=dt, ema=straggler.ema,
                     factor=args.straggler_factor,
                     phases=rec.phase_seconds())
            if rebalancer is not None:
                rebalancer.record(metrics["expert_load"].cpu().numpy(),
                                  placement)
            if s % args.log_every == 0:
                extra = {}
                if "comm_algorithm" in metrics:
                    extra = dict(
                        comm=comm_planner.describe_comm_metrics(
                            int(metrics["comm_algorithm"]),
                            int(metrics["comm_degraded"]),
                            int(metrics["comm_calibrated"]),
                            int(metrics["comm_wire_format"])),
                        comm_share=timeline.comm_share())
                emit("step", step=s, loss=loss, ce=float(metrics["ce"]),
                     lr=float(metrics["lr"]), dt=dt,
                     skips=int(metrics["grad_skips"]), **extra)
            if monitor is not None:
                signals = {"step_time": dt, "loss": loss,
                           "comm_share": timeline.comm_share(),
                           "straggler": 1.0 if is_straggler else 0.0}
                if "obs_load_imbalance" in metrics:
                    signals["load_imbalance"] = float(
                        metrics["obs_load_imbalance"])
                monitor.observe(s, signals)
            if escalator is not None and any_rank(escalator.should_exit,
                                                  world, dev):
                # persistent degradation: make the run durable and hand
                # the restart decision to the supervisor
                if mgr:
                    mgr.save_async(s + 1, state)
                    mgr.wait()
                export_artifacts(metrics)
                return EXIT_WATCHDOG
            if any_rank(preempt.requested.is_set(), world, dev):
                if mgr:
                    mgr.save_async(s + 1, state)
                    mgr.wait()
                emit("preempt", step=s)
                export_artifacts(metrics)
                return EXIT_PREEMPTED
            if mgr and (s + 1) % args.ckpt_every == 0:
                mgr.save_async(s + 1, state)
            if chaos is not None:
                chaos.on_step_end(s, manager=mgr, ckpt_dir=args.ckpt,
                                  writer=rank0)
        if mgr:
            mgr.save_async(args.steps, state)
            mgr.wait()
    finally:
        watchdog.stop()
        prof.stop()
    export_artifacts(metrics)
    extra = {}
    if sharding.axis_size(mesh, "pipe") > 1:
        # the pipe columns compute the same thing: say whether they did
        col = collectives.raw_all_gather(
            torch.tensor(losses, dtype=torch.float64, device=dev),
            sharding.pipe_group(mesh), 0).reshape(args.mesh_pipe, -1)
        extra["pipe_columns_bit_equal"] = all(
            torch.equal(col[0], c) for c in col[1:])
    steady = dts[1:]
    tokens = args.batch * args.seq
    emit("train_summary", arch=args.arch, smoke=args.smoke, steps=len(dts),
         first_step=start, batch=args.batch, seq=args.seq,
         lsh=cfg.moe.lsh.enabled if use_lsh is None else use_lsh,
         mean_step_ms_after_first=(sum(steady) / len(steady) * 1e3
                                   if steady else math.nan),
         tokens_per_s=(tokens * len(steady) / sum(steady) if steady
                       else math.nan),
         first_step_ms=dts[0] * 1e3 if dts else math.nan,
         final_loss=loss,
         skips=int(metrics["grad_skips"]) if metrics else 0,
         peak_memory_bytes=(torch.cuda.max_memory_allocated(dev)
                            if dev.type == "cuda" else None),
         device=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
         mesh=None if mesh is None else mesh.shape,
         param_bytes_per_rank=sum(t.numel() * t.element_size()
                                  for t in leaves(state.params)),
         comm_share=timeline.comm_share(), **extra)
    return 0


def _effective(cfg, use_lsh):
    """``cfg`` with ``--lsh`` applied, for the modeled phase split."""
    import dataclasses
    if use_lsh is None or not cfg.has_moe():
        return cfg
    return cfg.replace(moe=dataclasses.replace(
        cfg.moe, lsh=dataclasses.replace(cfg.moe.lsh, enabled=use_lsh)))


class _Profile:
    """``--profile``: torch.profiler over the steady steps, each rank's
    Chrome trace under ``<metrics-dir>/torch_trace/``, and its analysis
    (the measured phases against ``modeled``, the split set after the
    first step)."""

    def __init__(self, args, dev, mesh, world, cfg, comm):
        self.args, self.dev, self.mesh, self.world = args, dev, mesh, world
        self.cfg, self.comm = cfg, comm
        self.modeled = None
        self.prof = None
        self.steps = 0
        self.path = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        if self.prof is not None or self.steps:
            return
        acts = [ProfilerActivity.CPU]
        if self.dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.dev)
        self.prof = profile(activities=acts)
        self.prof.start()

    def step_done(self, wanted: int) -> None:
        if self.prof is not None:
            self.steps += 1
            if self.steps >= wanted:
                self.stop()

    def stop(self) -> None:
        """Stop the profiler (once its last step's kernels have finished)
        and export this rank's trace."""
        if self.prof is None:
            return
        import torch
        prof, self.prof = self.prof, None
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        prof.stop()
        rank = 0 if self.mesh is None else self.mesh.rank
        d = os.path.join(self.args.metrics_dir, "torch_trace")
        os.makedirs(d, exist_ok=True)
        self.path = os.path.join(d, f"rank{rank}.pt.trace.json")
        prof.export_chrome_trace(self.path)

    def analyze(self) -> dict:
        """The measured timeline (averaged over the ranks), reconciled
        with the modeled split: model_drift events, the drift recorded
        in the tune cache; returns the keys for metrics.json.  A failure
        is an ``error`` event, as in the JAX launcher."""
        from repro_torch.comm.collectives import any_rank
        from repro_torch.obs import events as obs_events
        from repro_torch.obs import profile as obs_profile
        from repro_torch.obs import reconcile as obs_reconcile
        from repro_torch.tune import runtime as tune_runtime
        if not self.steps or self.path is None:
            return {}
        local = None
        try:
            local = obs_profile.parse_torch_trace(self.path,
                                                  steps=self.steps)
        except Exception as exc:
            obs_events.emit("error", where="profile", message=str(exc))
        # every rank joins the reduction, or none does
        if any_rank(local is None, self.world, self.dev):
            return {}
        measured = obs_profile.reduce_over_ranks(local, self.world,
                                                 self.dev)
        out = measured.summary()
        if not self.modeled:
            return out
        report = obs_reconcile.reconcile(self.modeled,
                                         measured.phase_seconds)
        if self.mesh is None or self.mesh.rank == 0:
            obs_reconcile.emit_drift_events(report)
        out.update(report.to_metrics())
        if self.cfg.has_moe() \
                and tune_runtime.tuning_mode(self.comm) != "off":
            try:
                entry = obs_reconcile.record_stale_calibration(
                    self.mesh, self.comm, report)
                if entry is not None and report.stale:
                    obs_events.emit("tune_stale", path=entry,
                                    comm_drift=report.comm_drift,
                                    drift_score=report.drift_score)
            except Exception as exc:
                obs_events.emit("error", where="reconcile",
                                message=str(exc))
        return out


if __name__ == "__main__":
    raise SystemExit(main())
