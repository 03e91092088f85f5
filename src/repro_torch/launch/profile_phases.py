"""The paper's phase split of a training step, measured: ``launch/train.py
--profile`` run once for each wire format and LSH setting, and the
measured device seconds of each phase printed beside the modeled ones.

  torchrun --standalone --nproc-per-node 4 \
      -m repro_torch.launch.profile_phases --mesh-model 4 --batch 16 \
      --seq 1024

On the four H100s of one host this is the counterpart of the paper's
Fig. 3 (the share of a step in the all-to-all) and of its claim that LSH
shrinks the exchange.  For each ``WIRE:LSH`` of ``--settings`` (default
bf16:on, bf16:off, int8:on, int8:off) it runs the launcher's ``main`` in
this process with ``LSHConfig.wire_format`` replaced, ``--steps`` steps
of which ``--profile`` from the second run under torch.profiler, and
rank 0 prints one JSON line ``phase_split`` a setting: the measured
milliseconds, launches and share of each phase a step and the NCCL
kernels' part of each (obs/profile.py; the ranks' mean), the modeled
shares (obs/timeline.py), the measured and modeled comm shares, the
drift score, the host-clock ms of the steps after the profiled ones,
and the wire bytes.  The process group is made once (NCCL for the card,
gloo with ``--device cpu``); each run's metrics directory is a temporary
one, removed at the end.  Exits non-zero if a run fails.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import shutil
import sys
import tempfile

PHASES = ("gate", "hash_compress", "dispatch_a2a", "expert_mlp",
          "combine_a2a", "decompress", "stage_transfer", "other")


@contextlib.contextmanager
def wire_format(registry, fmt: str):
    """The registry's configs with ``LSHConfig.wire_format`` = fmt, for
    the launcher's runs (it has no wire flag, as the JAX one has none)."""
    saved = registry.get_config, registry.get_smoke_config

    def wrap(get):
        def get_wired(arch):
            cfg = get(arch)
            return cfg.replace(moe=dataclasses.replace(
                cfg.moe, lsh=dataclasses.replace(cfg.moe.lsh,
                                                 wire_format=fmt)))
        return get_wired
    registry.get_config, registry.get_smoke_config = map(wrap, saved)
    try:
        yield
    finally:
        registry.get_config, registry.get_smoke_config = saved


def _row(m: dict, steady_ms, wire: str, lsh: str) -> dict:
    step = m["measured_step_s"]
    modeled = {p: m.get(f"weight_{p}", 0.0) for p in PHASES}
    return {
        "kind": "phase_split", "wire_format": wire, "lsh": lsh,
        "measured_ms": {p: m.get(f"measured_{p}_s", 0.0) * 1e3
                        for p in PHASES},
        "measured_launches": {p: m.get(f"measured_{p}_launches", 0.0)
                              for p in PHASES},
        "measured_nccl_ms": {p: m[f"measured_{p}_nccl_s"] * 1e3
                             for p in PHASES
                             if f"measured_{p}_nccl_s" in m},
        "measured_share": {p: m.get(f"measured_{p}_s", 0.0) / step
                           for p in PHASES},
        "modeled_share": modeled,
        "measured_step_ms": step * 1e3,
        "measured_comm_share": m["measured_comm_share"],
        "modeled_comm_share": m["comm_share"],
        "model_drift_score": m.get("model_drift_score"),
        "model_clock_ratio": m.get("model_clock_ratio"),
        "measured_ranks": m["measured_devices"],
        "steady_step_ms": steady_ms,
        "obs_wire_bytes": m["obs_wire_bytes"],
        "obs_raw_bytes": m["obs_raw_bytes"],
        "obs_compression_rate": m["obs_compression_rate"],
        "comm_algorithm": m["comm_algorithm"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-moe-3b-a800m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--profile", type=int, default=2)
    ap.add_argument("--settings", default="bf16:on,bf16:off,int8:on,"
                                          "int8:off")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from repro_torch import resolve_device
    from repro_torch.configs import registry
    from repro_torch.launch import train
    from repro_torch.launch.mesh import init_distributed
    from repro_torch.obs import events as obs_events

    dev = resolve_device(args.device)
    if "RANK" in os.environ and not dist.is_initialized():
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        init_distributed(dev)
    rank = dist.get_rank() if dist.is_initialized() else 0
    root = [tempfile.mkdtemp(prefix="profile_phases-") if rank == 0
            else None]
    if dist.is_initialized():
        dist.broadcast_object_list(root, src=0)
    rc = 0
    try:
        for setting in args.settings.split(","):
            wire, lsh = setting.split(":")
            d = os.path.join(root[0], f"{wire}-{lsh}")
            argv = ["--arch", args.arch, "--device", args.device,
                    "--mesh-data", str(args.mesh_data), "--mesh-model",
                    str(args.mesh_model), "--batch", str(args.batch),
                    "--seq", str(args.seq), "--steps", str(args.steps),
                    "--profile", str(args.profile), "--lsh", lsh,
                    "--log-every", "1", "--metrics-dir", d]
            if args.smoke:
                argv.append("--smoke")
            with wire_format(registry, wire):
                rc = train.main(argv)
            if rc != 0:
                print(f"profile_phases: {setting} exited {rc}",
                      file=sys.stderr, flush=True)
                break
            if rank == 0:
                with open(os.path.join(d, "metrics.json")) as f:
                    m = json.load(f)
                events = obs_events.read_jsonl(os.path.join(
                    d, "events.jsonl"))
                steady = [ev.data["dt"] * 1e3 for ev in events
                          if ev.kind == "step" and ev.step > args.profile]
                print(json.dumps(_row(m, steady, wire, lsh),
                                 sort_keys=True), flush=True)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        if dist.is_initialized():
            dist.barrier()
        if rank == 0:
            shutil.rmtree(root[0], ignore_errors=True)
        if dist.is_initialized():
            dist.destroy_process_group()
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
