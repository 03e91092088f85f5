"""Dense and MoE models trained over four cards with every weight placed
by its spec (runtime/params.py): FSDP over ``data``, heads / FFN hidden /
vocabulary / experts over ``model``.

Cases (``--case``; ``all`` runs all but ``moe-2x2`` in order in one
process group; ``moe-2x2``, whose launcher starts its own, runs alone):

  check        granite-8b at full width and CHECK_SUPER_BLOCKS super-blocks:
               rank 0's one-card ``loss_fn`` from the seed, then the same
               loss over (2, 2) and over (1, 4), each within CHECK_RTOL of
               it (bf16: the column and row slices and the reduce-scatters
               round in other places than one card's products);
  granite-2x2  granite-8b at full width and depth (36 layers) over (2, 2):
  granite-1x4  ... and over (1, 4): STEPS AdamW steps (f32 moments) at
               BATCH x SEQ tokens, finite losses, step ms, peak memory and
               param bytes a rank;
  ckpt         granite-8b at full width and CKPT_SUPER_BLOCKS super-block,
               one step over (2, 2), a checkpoint written there and
               restored over (1, 4): every leaf of params and moments, each
               gathered whole, bit-equal (a digest of its words);
  nemotron-1x4 nemotron-4-15b at full depth over (1, 4), and
  internvl-2x2 internvl2-26b (on text) at full depth over (2, 2): STEPS
               steps where they fit; where not, the allocator's message
               and numbers;
  moe-2x2      granite-moe-3b-a800m at full size over (2, 2) through
               launch/train.main (STEPS steps, BATCH x SEQ tokens): its
               train_summary, peak memory a rank and the launches of the
               port's kernels of its bf16-wire LSH path on every rank.

Each rank prints one JSON line a case; rank 0 prints the card's name and
power limit first and a summary line a case.  Exits non-zero when a check
fails; an out-of-memory case prints its record and exits 3 (under
torchrun the other ranks are then stopped), so run the cases that may
not fit one torchrun each:

  for c in check granite-2x2 granite-1x4 ckpt nemotron-1x4 internvl-2x2 \\
           moe-2x2; do
    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
        scripts/fsdp_tp_train.py --case $c
  done

Rehearse on the CPU (4 gloo ranks, the smoke configs):

  for c in all moe-2x2; do
    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
        scripts/fsdp_tp_train.py --smoke --device cpu --seq 32 --case $c
  done
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

CHECK_RTOL = 2e-3
CHECK_SUPER_BLOCKS = 4
CKPT_SUPER_BLOCKS = 1
BATCH, SEQ, STEPS = 4, 1024, 5
CASES = ("check", "granite-2x2", "granite-1x4", "ckpt", "nemotron-1x4",
         "internvl-2x2", "moe-2x2")
FULL = {"granite-2x2": ("granite-8b", (2, 2)),
        "granite-1x4": ("granite-8b", (1, 4)),
        "nemotron-1x4": ("nemotron-4-15b", (1, 4)),
        "internvl-2x2": ("internvl2-26b", (2, 2))}


class Ctx:
    def __init__(self, torch, args, dev, rank):
        from repro_torch.configs.registry import get_config, get_smoke_config
        self.torch, self.args, self.dev, self.rank = torch, args, dev, rank
        self.cuda = dev.type == "cuda"
        self.get = get_smoke_config if args.smoke else get_config
        self.meshes = {}

    def mesh(self, shape):
        from repro_torch.launch.mesh import make_mesh
        if shape not in self.meshes:
            self.meshes[shape] = make_mesh(*shape)
        return self.meshes[shape]

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize(self.dev)

    def reset(self):
        if self.cuda:
            self.torch.cuda.empty_cache()
            self.torch.cuda.reset_peak_memory_stats(self.dev)

    def peak_gb(self):
        return self.torch.cuda.max_memory_allocated(self.dev) / 1e9 \
            if self.cuda else None

    def batch(self, cfg):
        from repro_torch.data.synthetic import SyntheticLMDataset
        from repro_torch.runtime import step as step_lib
        return step_lib.batch_to_device(SyntheticLMDataset(
            cfg.vocab_size, self.args.seq, self.args.batch).batch_at(0),
            self.dev)

    def opt(self):
        from repro_torch.configs.base import OptimizerConfig
        return OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                               moment_dtype="float32")


def case_check(ctx):
    """The mesh loss against rank 0's one-card loss, over both meshes."""
    import torch.distributed as dist
    from repro_torch.models import model as model_lib
    from repro_torch.runtime import sharding
    from repro_torch.runtime import step as step_lib
    cfg = ctx.get("granite-8b").replace(num_super_blocks=CHECK_SUPER_BLOCKS)
    batch = ctx.batch(cfg)
    ref = None
    if ctx.rank == 0:
        params = model_lib.init_params(cfg, seed=ctx.args.seed,
                                       device=ctx.dev)
        with ctx.torch.no_grad():
            ref = float(model_lib.loss_fn(params, cfg, batch)[0])
        del params
    dist.barrier()
    out = {"one_card": ref}
    ok = True
    for shape in ((2, 2), (1, 4)):
        mesh = ctx.mesh(shape)
        ctx.reset()
        state = step_lib.init_train_state(cfg, ctx.opt(), seed=ctx.args.seed,
                                          device=ctx.dev, mesh=mesh)
        with ctx.torch.no_grad():
            _, met = model_lib.loss_fn(state.params, cfg,
                                       sharding.shard_batch(batch, mesh),
                                       mesh=mesh)
        key = f"{shape[0]}x{shape[1]}"
        out[key] = float(met["loss"])
        if ref is not None:
            out[f"{key}_rel"] = abs(out[key] - ref) / abs(ref)
            ok = ok and out[f"{key}_rel"] <= CHECK_RTOL
        del state
    out.update(bound=CHECK_RTOL, super_blocks=CHECK_SUPER_BLOCKS)
    return out, ok


def _train(ctx, cfg, mesh, steps):
    """STEPS steps of ``cfg`` over ``mesh`` -> (record, ok, state)."""
    from repro_torch.configs.base import param_count
    from repro_torch.optim.adam import leaves
    from repro_torch.runtime import step as step_lib
    ctx.reset()
    t0 = time.time()
    state = step_lib.init_train_state(cfg, ctx.opt(), seed=ctx.args.seed,
                                      device=ctx.dev, mesh=mesh)
    ctx.sync()
    rec = {"init_s": time.time() - t0,
           "param_bytes_per_rank": sum(t.numel() * t.element_size()
                                       for t in leaves(state.params)),
           "param_elements_whole": param_count(cfg)}
    step_fn = step_lib.make_train_step(cfg, ctx.opt(), mesh=mesh)
    batch = ctx.batch(cfg)
    losses, norms, dts = [], [], []
    for _ in range(steps):
        ctx.sync()
        t1 = time.perf_counter()
        state, met = step_fn(state, batch)
        losses.append(met["loss"].item())
        norms.append(met["grad_norm"].item())
        ctx.sync()
        dts.append((time.perf_counter() - t1) * 1e3)
    rec.update(losses=losses, grad_norms=norms, step_ms=dts,
               skips=int(met["grad_skips"]), peak_memory_gb=ctx.peak_gb())
    ok = all(math.isfinite(v) for v in losses + norms) and rec["skips"] == 0
    return rec, ok, state


def case_full(ctx, name):
    arch, shape = FULL[name]
    cfg = ctx.get(arch)
    rec, ok, state = _train(ctx, cfg, ctx.mesh(shape), ctx.args.steps)
    rec.update(arch=arch, mesh=list(shape), layers=len(state.params[
        "layers"]), tokens=[ctx.args.batch, ctx.args.seq])
    return rec, ok


def _digests(ctx, tree, specs, mesh):
    """{key: (word sum, position-weighted sum)} of every leaf of
    ``tree`` gathered whole (a collective), leaf by leaf."""
    from repro_torch.checkpoint.checkpoint import _flatten
    from repro_torch.runtime import params as params_lib
    torch = ctx.torch
    split = params_lib.flat_specs(specs)
    out = {}
    for key, leaf in _flatten(tree):
        if key in split:
            leaf = params_lib.gather(leaf, split[key], mesh)
        w = leaf.detach().contiguous().view(-1)
        w = w.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[
            w.element_size()]).to(torch.int64)
        pos = torch.arange(w.numel(), device=w.device, dtype=torch.int64)
        out[key] = (int(w.sum()), int((w * (pos % 65521 + 1)).sum()))
        del leaf, w, pos
    return out


def case_ckpt(ctx):
    """A checkpoint written over (2, 2) after one step, restored over
    (1, 4): every leaf bit-equal."""
    import torch.distributed as dist
    from repro_torch.checkpoint.checkpoint import (load_checkpoint,
                                                   save_checkpoint)
    from repro_torch.runtime import params as params_lib
    from repro_torch.runtime import step as step_lib
    cfg = ctx.get("granite-8b").replace(num_super_blocks=CKPT_SUPER_BLOCKS)
    m22, m14 = ctx.mesh((2, 2)), ctx.mesh((1, 4))
    _, ok, state = _train(ctx, cfg, m22, 1)
    s22 = params_lib.train_state_specs(cfg, m22, "float32")
    s14 = params_lib.train_state_specs(cfg, m14, "float32")
    want = _digests(ctx, state, s22, m22)
    box = [None]
    if ctx.rank == 0:
        box[0] = tempfile.mkdtemp(prefix=".fsdp-ckpt-", dir=str(ROOT))
    dist.broadcast_object_list(box, src=0)
    t0 = time.time()
    save_checkpoint(box[0], 1, state, mesh=m22, specs=s22)
    save_s = time.time() - t0
    del state
    ctx.reset()
    tpl = step_lib.init_train_state(cfg, ctx.opt(), seed=ctx.args.seed + 1,
                                    device=ctx.dev, mesh=m14)
    t0 = time.time()
    got, step, _ = load_checkpoint(box[0], tpl, mesh=m14, specs=s14)
    load_s = time.time() - t0
    del tpl
    have = _digests(ctx, got, s14, m14)
    dist.barrier()
    if ctx.rank == 0:
        import shutil
        shutil.rmtree(box[0], ignore_errors=True)
    same = have == want and step == 1
    return {"leaves": len(want), "bit_equal": same, "save_s": save_s,
            "load_s": load_s,
            "super_blocks": CKPT_SUPER_BLOCKS}, ok and same


def case_moe(ctx):
    """granite-moe-3b-a800m over (2, 2) through the launcher."""
    from repro_torch.kernels import dispatch
    from repro_torch.launch import train
    kernels = list(dispatch.ROUTING_KERNELS) + list(dispatch.LSH_KERNELS)
    for k in dispatch.KERNELS:
        k.launches = 0
    ctx.reset()
    argv = ["--arch", "granite-moe-3b-a800m", "--mesh-data", "2",
            "--mesh-model", "2", "--batch", str(ctx.args.batch), "--seq",
            str(ctx.args.seq), "--steps", str(ctx.args.steps),
            "--log-every", "1"]
    if ctx.args.smoke:
        argv.append("--smoke")
    if not ctx.cuda:
        argv += ["--device", "cpu"]
    rc = train.main(argv)
    launches = {k.name: k.launches for k in kernels}
    rec = {"rc": rc, "peak_memory_gb": ctx.peak_gb(),
           "launches": launches}
    ok = rc == 0 and (not ctx.cuda or all(launches.values()))
    return rec, ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--case", default="all", choices=("all",) + CASES)
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--seq", type=int, default=SEQ)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    # the update's gigabyte-sized f32 copies come and go leaf by leaf
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed

    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("fsdp_tp_train: no CUDA device", file=sys.stderr)
            return 1
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(args.device)
    rank = int(os.environ.get("RANK", "0"))
    ctx = Ctx(torch, args, dev, rank)
    if rank == 0 and ctx.cuda:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
        print(smi, flush=True)
    if args.case == "moe-2x2":
        # the launcher starts and ends its own process group; each rank's
        # verdict is its exit code
        t0 = time.time()
        rec, ok = case_moe(ctx)
        rec.update(case=args.case, rank=rank, ok=ok, wall_s=time.time() - t0)
        print(json.dumps(rec, sort_keys=True), flush=True)
        return int(not ok)
    cases = CASES[:-1] if args.case == "all" else (args.case,)
    init_distributed(dev)
    world = dist.get_world_size()
    if world != 4:
        print(f"fsdp_tp_train: needs 4 ranks, has {world}", file=sys.stderr)
        return 2
    failed = False
    for case in cases:
        t0 = time.time()
        try:
            if case == "check":
                rec, ok = case_check(ctx)
            elif case == "ckpt":
                rec, ok = case_ckpt(ctx)
            else:
                rec, ok = case_full(ctx, case)
        except torch.OutOfMemoryError as e:
            print(json.dumps({"case": case, "rank": rank, "oom": str(e),
                              "peak_memory_gb": ctx.peak_gb(),
                              "reserved_gb": torch.cuda.memory_reserved(
                                  dev) / 1e9}, sort_keys=True), flush=True)
            os._exit(3)
        rec.update(case=case, rank=rank, ok=ok, wall_s=time.time() - t0)
        print(json.dumps(rec, sort_keys=True), flush=True)
        flag = torch.tensor([0 if ok else 1], device=dev)
        dist.all_reduce(flag)
        failed = failed or int(flag.item()) > 0
        if rank == 0:
            print(json.dumps({"summary": "fsdp_tp_train", "case": case,
                              "ok": int(flag.item()) == 0,
                              "device": torch.cuda.get_device_name(dev)
                              if ctx.cuda else "cpu"}), flush=True)
        ctx.reset()
    dist.destroy_process_group()
    return int(failed)


if __name__ == "__main__":
    raise SystemExit(main())
