"""jamba-1.5-large-398b's window trained over a (1, 4) mesh: the
tensor-parallel Mamba (runtime/tp.py) on the expert-parallel axis.

The window is chip_smoke.py phase hybrid's: layout entries 4-5 of the
full-width config (one Mamba + MoE block, one attention + dense block;
11.9 G params, bf16, seeded random weights).  On one card its params,
gradients and f32 AdamW moments need about 143 GB; over (1, 4) every leaf
splits by its spec (runtime/params.py): the experts, the Mamba and
attention heads, the dense FFN's hidden columns and the vocabulary.
Each rank:

1. before the mesh state exists, rank 0 runs the mesh-free ``loss_fn``
   of the window on its card from the same seed and batch, twice: with
   LSH on, and in the check config (LSH off, a capacity that drops no
   token, no router losses), where the mesh computes the same function as
   one card;
2. builds its shard (``init_train_state`` on the mesh) and runs the check
   config's ``loss_fn`` over the mesh: within CHECK_RTOL of rank 0's
   one-card loss (bf16: the column and row slices and the reduce-scatter
   round in other places than one card's products);
3. trains STEPS AdamW steps at 2 x 2048 tokens (phase hybrid's batch),
   LSH on: finite losses, the first beside the one-card LSH-on loss
   within LSH_RTOL (a mesh hashes, clusters and fills capacity over each
   rank's own tokens, as the JAX package's does: another function), step
   ms, peak memory;
4. profiles one more step (after the profiler's warm-up step) and parses
   the trace (obs/profile.py) with the Mamba forward wrapped in an
   ``obs/mamba`` range: device ms of the step, of the Mamba layer (its
   backward and recompute included) and of NCCL's kernels, in and
   outside the Mamba layer.

AdamW keeps its moments in bf16 (MOMENT_DTYPE, see there).

Prints one JSON line a rank and, from rank 0, the card's name and power
limit and a summary line; exits non-zero when a check fails.

  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 scripts/jamba_tp_train.py

Rehearse on the CPU (4 gloo ranks, the smoke config's window):

  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
      scripts/jamba_tp_train.py --smoke --device cpu --seq 32
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

ARCH = "jamba-1.5-large-398b"
CHECK_RTOL = 2e-3
LSH_RTOL = 5e-2
# bf16 AdamW moments: with f32 ones a rank holds 55.8 GB of params,
# gradients and moments before the update, and the update's unfused chain
# of f32 copies of a leaf (3.2 GB each for an expert weight's shard, about
# eight at once) leaves too little of the card's 80 GB
MOMENT_DTYPE = "bfloat16"


def check_config(cfg):
    """LSH off, a capacity that drops no token, no router losses: the
    function a mesh shares with one card."""
    moe = dataclasses.replace(cfg.moe, capacity_factor=float(
        cfg.moe.num_experts), router_aux_weight=0.0, router_z_weight=0.0)
    return cfg.replace(moe=moe)


def profile_step(torch, run_step, ssm_lib):
    """Two calls of ``run_step`` under torch.profiler (the first in its
    warm-up) with every ``mamba_apply`` in an ``obs/mamba`` range; the
    second's trace parsed by obs/profile.py -> its per-phase device ms
    and NCCL ms."""
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)

    from repro_torch.obs import profile as prof_lib
    orig = ssm_lib.mamba_apply

    def traced(*a, **k):
        with record_function("obs/mamba"):
            return orig(*a, **k)

    ssm_lib.mamba_apply = traced
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                run_step()
                prof.step()
    finally:
        ssm_lib.mamba_apply = orig
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        saved = prof_lib.PHASE_RE
        prof_lib.PHASE_RE = re.compile(r"^obs/(mamba)$")
        try:
            m = prof_lib.parse_torch_trace(path)
        finally:
            prof_lib.PHASE_RE = saved
    ms = {k: v * 1e3 for k, v in m.phase_seconds.items()}
    nccl = {k: v * 1e3 for k, v in m.phase_nccl_seconds.items()}
    return dict(device_ms=sum(ms.values()), mamba_ms=ms.get("mamba", 0.0),
                other_ms=ms.get("other", 0.0),
                nccl_ms=sum(nccl.values()),
                nccl_in_mamba_ms=nccl.get("mamba", 0.0),
                device_events=m.n_events, on_device=m.device,
                mamba_launches=m.launches_per_step().get("mamba", 0.0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    # the update's gigabyte-sized f32 copies come and go leaf by leaf
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from repro_torch.configs.base import OptimizerConfig, param_count
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.models import model as model_lib
    from repro_torch.models import ssm as ssm_lib
    from repro_torch.optim.adam import leaves
    from repro_torch.runtime import sharding
    from repro_torch.runtime import step as step_lib

    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("jamba_tp_train: no CUDA device", file=sys.stderr)
            return 1
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    else:
        dev = torch.device(args.device)
    init_distributed(dev)
    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = make_mesh(1, world)
    cuda = dev.type == "cuda"
    full = (get_smoke_config if args.smoke else get_config)(ARCH)
    cfg = cs.hybrid_window(full)
    check = check_config(cfg)
    batch = step_lib.batch_to_device(SyntheticLMDataset(
        cfg.vocab_size, args.seq, args.batch).batch_at(0), dev)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    out = {"rank": rank, "world": world}
    ref = {}
    if rank == 0:
        if cuda:
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                check=True, timeout=60).stdout.strip().splitlines()[0]
            print(smi, flush=True)
        params = model_lib.init_params(cfg, seed=args.seed, device=dev)
        with torch.no_grad():
            for tag, c, lsh in (("lsh", cfg, True), ("check", check, False)):
                loss, _ = model_lib.loss_fn(params, c, batch, use_lsh=lsh)
                ref[tag] = float(loss)
        del params
        if cuda:
            torch.cuda.empty_cache()
    dist.barrier()

    opt = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                          moment_dtype=MOMENT_DTYPE)
    t0 = time.time()
    state = step_lib.init_train_state(cfg, opt, seed=args.seed, device=dev,
                                      mesh=mesh)
    sync()
    out["init_s"] = time.time() - t0
    with torch.no_grad():
        _, met = model_lib.loss_fn(state.params, check,
                                   sharding.shard_batch(batch, mesh),
                                   use_lsh=False, mesh=mesh)
    out["check_loss"] = float(met["loss"])        # global, not the share
    if rank == 0:
        print(json.dumps({"check_loss": out["check_loss"],
                          "one_card": ref}), flush=True)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    step_fn = step_lib.make_train_step(cfg, opt, use_lsh=True, mesh=mesh)
    losses, norms, skips, dts = [], [], [], []
    box = {"state": state}
    del state

    def run_step():
        box["state"], met = step_fn(box["state"], batch)
        return met

    for _ in range(args.steps):
        sync()
        t1 = time.perf_counter()
        met = run_step()
        losses.append(met["loss"].item())
        norms.append(met["grad_norm"].item())
        skips.append(int(met["grad_skips"]))
        sync()
        dts.append((time.perf_counter() - t1) * 1e3)
    out.update(losses=losses, grad_norms=norms, step_ms=dts, skips=skips[-1])
    if cuda:
        out["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        out["params_gb"] = sum(p.numel() * p.element_size()
                               for p in leaves(box["state"].params)) / 1e9
    out["profile"] = profile_step(torch, lambda: run_step()["loss"].item(),
                                  ssm_lib)
    print(json.dumps(out, sort_keys=True), flush=True)

    ok = all(math.isfinite(v) for v in losses + norms) and skips[-1] == 0
    if rank == 0:
        rel_check = abs(out["check_loss"] - ref["check"]) / abs(ref["check"])
        rel_lsh = abs(losses[0] - ref["lsh"]) / abs(ref["lsh"])
        ok = ok and rel_check <= CHECK_RTOL and rel_lsh <= LSH_RTOL
        print(json.dumps({
            "summary": "jamba_tp_train", "arch": ARCH, "mesh": [1, world],
            "window_entries": list(cs.HYB_ENTRIES),
            "window_params": param_count(cfg), "tokens": [args.batch,
                                                          args.seq],
            "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "one_card_loss_lsh": ref["lsh"], "first_loss": losses[0],
            "first_loss_rel": rel_lsh, "lsh_bound": LSH_RTOL,
            "one_card_check_loss": ref["check"],
            "mesh_check_loss": out["check_loss"],
            "check_rel": rel_check, "check_bound": CHECK_RTOL, "ok": ok},
            sort_keys=True), flush=True)
    flag = torch.tensor([0 if ok else 1], device=dev)
    dist.all_reduce(flag)
    failed = int(flag.item()) > 0
    dist.destroy_process_group()
    return int(failed)


if __name__ == "__main__":
    raise SystemExit(main())
