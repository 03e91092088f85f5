"""Where a decode step's time goes on the card: host clock per step, device
busy time from ``torch.profiler``, and the ops that take each.

  PYTHONPATH=src python -m repro_torch.launch.profile_decode \
      --arch granite-moe-3b-a800m [--warmup 4] [--steps 8]

The config at its full depth, with serve's default 4 batch slots.  Runs
``--warmup`` decode steps (each timed alone, since the first ones pay
one-time costs), times ``--steps`` more with the host clock
(profiler off, ending in a synchronise), then profiles ``--steps`` steps
with CPU and CUDA activities.  Prints one line per top op and a final JSON
line: wall ms per step, device busy ms per step (the sum of kernel times
on the device; one stream, so kernels do not overlap), the device's idle
share of the wall time, and the routing kernels' launches per step.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-moe-3b-a800m")
    ap.add_argument("--warmup", type=int, default=4)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--trace", default="",
                    help="also write the Chrome trace to this path")
    args = ap.parse_args(argv)
    batch_slots = 4                       # serve.py's default

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import resolve_device
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import dispatch
    from repro_torch.launch.profiling import summarize
    from repro_torch.models import model as model_lib

    dev = resolve_device("cuda")
    cfg = get_config(args.arch)
    params = model_lib.init_params(cfg, seed=0, device=dev)
    n_steps = args.warmup + 2 * args.steps
    state = model_lib.init_decode_state(cfg, batch_slots, n_steps,
                                        device=dev)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (batch_slots, n_steps),
                           generator=gen).to(dev)
    step = 0

    def run(n):
        nonlocal state, step
        for _ in range(n):
            _, state = model_lib.decode_step(params, cfg, state,
                                             tokens[:, step:step + 1])
            step += 1
        torch.cuda.synchronize(dev)

    warmup_ms = []                        # first steps pay one-time costs
    for _ in range(args.warmup):
        t0 = time.perf_counter()
        run(1)
        warmup_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    run(args.steps)
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    before = {k.name: k.launches for k in dispatch.ROUTING_KERNELS}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(args.steps)
    launches = {k.name: (k.launches - before[k.name]) / args.steps
                for k in dispatch.ROUTING_KERNELS}
    if args.trace:
        prof.export_chrome_trace(args.trace)

    record, lines = summarize(prof, args.steps, wall_ms, args.top)
    for line in lines:
        print(line)
    print(json.dumps({
        "kind": "decode_profile", "arch": args.arch,
        "layers": cfg.num_layers, "batch_slots": batch_slots,
        "steps": args.steps, "warmup_ms_per_step": warmup_ms,
        **record,
        "routing_launches_per_step": launches,
        "device": torch.cuda.get_device_name(dev)}, sort_keys=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
