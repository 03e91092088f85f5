"""Where a training step's time goes on the card: host clock per step,
device busy time from ``torch.profiler``, the device's idle share and the
host's time in kernel launch calls.

  PYTHONPATH=src python -m repro_torch.launch.profile_train \
      --arch granite-moe-3b-a800m [--wire bf16|int8|fp8] [--lsh on|off] \
      [--batch 4] [--seq 1024] [--warmup 2] [--steps 10]

The config at its full depth (``--smoke``: the reduced one), with the
wire format set by ``dataclasses.replace`` of its ``LSHConfig`` (the
trainer has no wire flag, as in the JAX package) and the optimizer of
``launch/train.py``.  Runs ``--warmup`` steps, then ``--steps`` more, each
timed alone with the host clock (a step ends in reading its loss back),
then profiles one more with CPU and CUDA activities.  Prints one line per
top op and a final JSON line: the steady steps' ms, their mean and
median, and the profiled step's device busy ms, idle share of the median
step, kernels, and host ms in kernel launch calls.  Runs on the CUDA
device unless ``--device cpu`` (where nothing on the device is measured).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-moe-3b-a800m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-sized)")
    ap.add_argument("--wire", default=None, choices=("bf16", "int8", "fp8"),
                    help="wire format (default: the config's)")
    ap.add_argument("--lsh", default="on", choices=("on", "off"))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import resolve_device
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.launch.profiling import summarize
    from repro_torch.runtime.step import (batch_to_device, init_train_state,
                                          make_train_step)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.wire is not None:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, lsh=dataclasses.replace(cfg.moe.lsh,
                                             wire_format=args.wire)))
    total = args.warmup + args.steps + 1
    opt = OptimizerConfig(lr=1e-3, warmup_steps=min(20, total // 5),
                          total_steps=total)
    ds = SyntheticLMDataset(cfg.vocab_size, args.seq, args.batch)
    state = init_train_state(cfg, opt, seed=0, device=dev)
    step_fn = make_train_step(cfg, opt, use_lsh=args.lsh == "on")
    step = 0

    def run():
        nonlocal state, step
        state, m = step_fn(state, batch_to_device(ds.batch_at(step), dev))
        float(m["loss"])                  # waits for the step
        if int(m["grad_skips"]):
            raise RuntimeError(f"step {step} skipped its update")
        step += 1

    def timed():
        t0 = time.perf_counter()
        run()
        return (time.perf_counter() - t0) * 1e3

    warmup_ms = [timed() for _ in range(args.warmup)]
    step_ms = [timed() for _ in range(args.steps)]
    median = statistics.median(step_ms)
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        run()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    record, lines = summarize(prof, 1, median, args.top)
    for line in lines:
        print(line)
    print(json.dumps({
        "kind": "train_profile", "arch": args.arch,
        "wire_format": cfg.moe.lsh.wire_format, "lsh": args.lsh,
        "batch": args.batch, "seq": args.seq, "warmup_ms": warmup_ms,
        "step_ms": step_ms, "mean_step_ms": statistics.fmean(step_ms),
        "median_step_ms": median, **record,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu")}, sort_keys=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
