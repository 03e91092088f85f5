"""CLI: probe the mesh and fill the tuning cache (counterpart of
``repro/tune/__main__.py``).

  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \
      -m repro_torch.tune --device cpu --model 4 --node-size 2
  PYTHONPATH=src python -m repro_torch.tune --ladder 65536,4194304

Under torchrun each process is one rank of a (data, model) mesh, or with
``--pipe P`` a (data, pipe, model) one whose probe adds the 1F1B stage
leg's rows (``kind`` "stage", tune/probe.py) (NCCL on
``cuda:$LOCAL_RANK``, gloo with ``--device cpu``); run alone it is a mesh
of one rank, whose axis of one rank times no all-to-all and so stores no
entry.  Rank 0 prints the probe rows and the tuned choices.
"""
from __future__ import annotations

import argparse
import logging
import os


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tune",
        description="calibrate the comm cost model from live-mesh probes")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--data", type=int, default=1,
                    help="data-axis extent of the probe mesh")
    ap.add_argument("--pipe", type=int, default=1,
                    help="pipe-axis extent (> 1 adds the stage rows)")
    ap.add_argument("--model", type=int, default=0,
                    help="model-axis extent (0 = all remaining ranks)")
    ap.add_argument("--node-size", type=int, default=0,
                    help="ranks a node along the model axis (0 = "
                         "$REPRO_NODE_SIZE, else torchrun's "
                         "LOCAL_WORLD_SIZE across hosts)")
    ap.add_argument("--ladder", default="",
                    help="comma-separated per-rank message sizes in bytes "
                         "(default 64KiB,512KiB,4MiB)")
    ap.add_argument("--wire-formats", default="bf16,int8",
                    help="comma-separated wire formats to probe")
    ap.add_argument("--chunks", default="2,4",
                    help="comma-separated pipelined chunk candidates")
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--cache-dir", default="",
                    help="override $REPRO_TUNE_CACHE for this run")
    ap.add_argument("--no-store", action="store_true",
                    help="probe and report without writing the cache")
    ap.add_argument("--metrics-dir", default="",
                    help="also write the events (events.jsonl) here")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    if args.cache_dir:
        os.environ["REPRO_TUNE_CACHE"] = args.cache_dir
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(levelname)s %(name)s: %(message)s")

    import torch
    import torch.distributed as dist

    from repro_torch import resolve_device
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.obs import events as obs_events
    from repro_torch.tune.autotune import DEFAULT_LADDER, autotune

    dev = resolve_device(args.device)
    started = "RANK" in os.environ
    if started:
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        init_distributed(dev)
    world = dist.get_world_size() if started else 1
    rank0 = not started or dist.get_rank() == 0
    log = obs_events.global_log()
    sinks = []
    if rank0:
        sinks.append(log.add_sink(obs_events.ConsoleSink()))
        if args.metrics_dir:
            sinks.append(log.add_sink(obs_events.JsonlSink(
                os.path.join(args.metrics_dir, "events.jsonl"))))
    try:
        outer = max(1, args.data) * max(1, args.pipe)
        model = args.model or max(1, world // outer)
        if outer * model != world:
            shape = "x".join(map(str, (args.data, args.pipe, model)
                                 if args.pipe > 1 else (args.data, model)))
            obs_events.emit("error", where="tune",
                            message=(f"mesh {shape} needs {outer * model} "
                                     f"ranks, have {world}"))
            return 2
        mesh = make_mesh(args.data, model, args.pipe,
                         node_size=args.node_size)
        ladder = tuple(int(b) for b in args.ladder.split(",") if b) \
            or DEFAULT_LADDER
        choices = autotune(
            mesh, axis_name="model", ladder=ladder,
            wire_formats=tuple(f for f in args.wire_formats.split(",")
                               if f),
            chunk_candidates=tuple(int(k) for k in args.chunks.split(",")
                                   if k),
            warmup=args.warmup, iters=args.iters, store=not args.no_store,
            verbose=args.verbose, device=dev)
        if rank0:
            print(choices.describe(), flush=True)
        return 0
    finally:
        for sink in sinks:
            log.remove_sink(sink)
            if isinstance(sink, obs_events.JsonlSink):
                sink.close()
        if started:
            dist.barrier()
            dist.destroy_process_group()


if __name__ == "__main__":
    raise SystemExit(main())
