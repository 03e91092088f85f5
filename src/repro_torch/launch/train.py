"""Training launcher (counterpart of ``repro/launch/train.py``, without
its later features: checkpoints, chaos, metrics and profiles are not
ported, and argparse rejects their flags and ``--mesh-pipe``).

  PYTHONPATH=src python -m repro_torch.launch.train \
      --arch granite-moe-3b-a800m --steps 3 --batch 4 --seq 1024

Runs on the CUDA device unless ``--device cpu``.  The optimizer is the JAX
launcher's: ``OptimizerConfig(lr=1e-3, warmup_steps=min(20, steps // 5),
total_steps=steps)``; the data is ``SyntheticLMDataset`` (the JAX
package's batches, bit for bit).  Prints one JSON ``step`` line per logged
step (step, loss, ce, lr, dt, skips) and a final ``train_summary`` line:
steps, mean step ms after the first, tokens/s over those steps, final
loss, and the peak of ``torch.cuda.max_memory_allocated`` (null on the
CPU).  ``dt`` is the host clock around a step, which ends in a
synchronise (the loss is read back).

Expert parallelism: ``--mesh-data D --mesh-model M`` trains over a
(data, model) mesh of D * M ranks, started by torchrun:

  PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \
      -m repro_torch.launch.train --arch granite-moe-3b-a800m --smoke \
      --device cpu --mesh-model 2 --steps 2 --batch 2 --seq 32

Each rank runs on ``cuda:$LOCAL_RANK`` (NCCL) unless ``--device cpu``
(gloo); every rank reads the same batches and keeps its part.  Only
rank 0 prints.  Tokens/s counts the whole mesh's tokens.
``--node-size N`` says how many ranks a node holds along the model axis
(the planner's 2-hop transport; 0: $REPRO_NODE_SIZE, else torchrun's
LOCAL_WORLD_SIZE across hosts).  ``--autotune`` probes the mesh and fills
the comm tuning cache before step 0 (tune/), and makes this run read it
unless $REPRO_TUNE is set; ``CommConfig.tuning="probe"`` probes on a
cache miss without the flag.
"""
from __future__ import annotations

import argparse
import math
import time


def main(argv=None) -> int:
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
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--node-size", type=int, default=0,
                    help="ranks a node along the model axis (0 = "
                         "$REPRO_NODE_SIZE, else LOCAL_WORLD_SIZE)")
    ap.add_argument("--autotune", action="store_true",
                    help="probe the mesh and fill the comm tuning cache "
                         "before step 0, and read it in this run")
    args = ap.parse_args(argv)

    import os

    import torch
    import torch.distributed as dist

    from repro_torch import resolve_device
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.launch.serve import event_writer
    from repro_torch.runtime.step import (batch_to_device, init_train_state,
                                          make_train_step)
    from repro_torch.tune import runtime as tune_runtime

    dev = resolve_device(args.device)
    mesh = None
    if "RANK" in os.environ or args.mesh_data * args.mesh_model > 1:
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        init_distributed(dev)
        mesh = make_mesh(args.mesh_data, args.mesh_model,
                         node_size=args.node_size)
    rank0 = mesh is None or mesh.rank == 0
    emit = event_writer("") if rank0 else (lambda *a, **k: None)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
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
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    state = init_train_state(cfg, opt, seed=0, device=dev, mesh=mesh)
    step_fn = make_train_step(cfg, opt, use_lsh=use_lsh, mesh=mesh)
    dts, loss = [], float("nan")
    for s in range(args.steps):
        batch = batch_to_device(ds.batch_at(s), dev)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])       # waits for the step
        dt = time.perf_counter() - t0
        dts.append(dt)
        if s % args.log_every == 0:
            emit("step", step=s, loss=loss, ce=float(metrics["ce"]),
                 lr=float(metrics["lr"]), dt=dt,
                 skips=int(metrics["grad_skips"]))
    steady = dts[1:]
    mean_ms = sum(steady) / len(steady) * 1e3 if steady else math.nan
    tokens = args.batch * args.seq
    emit("train_summary", arch=args.arch, smoke=args.smoke, steps=args.steps,
         batch=args.batch, seq=args.seq,
         lsh=cfg.moe.lsh.enabled if use_lsh is None else use_lsh,
         mean_step_ms_after_first=mean_ms,
         tokens_per_s=(tokens * len(steady) / sum(steady) if steady
                       else math.nan),
         first_step_ms=dts[0] * 1e3 if dts else math.nan,
         final_loss=loss, skips=int(metrics["grad_skips"]) if dts else 0,
         peak_memory_bytes=(torch.cuda.max_memory_allocated(dev)
                            if dev.type == "cuda" else None),
         device=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
         mesh=None if mesh is None else mesh.shape)
    if mesh is not None:
        dist.barrier()
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
