"""Check and time the MoE exchange's transports across the ranks of a
(1, R) mesh: flat, the 2-hop (hierarchical) and the chunk-pipelined.

  torchrun --standalone --nproc-per-node 4 \
      -m repro_torch.launch.profile_comm --node-size 2

Each rank runs on ``cuda:$LOCAL_RANK`` (NCCL) unless ``--device cpu``
(gloo).  ``--node-size`` ranks make a node along the model axis (on one
host every link is the same; the split only decides what the 2-hop
does).  Three parts, rank 0 printing one JSON line a record:
1. ``legs``: the raw all-to-all of each wire leaf of the training shape,
   per rank [R, E / R, S, H] (bf16, int8 and fp8 payloads, the f32
   scales): the 2-hop and the chunked (2, 4; every chunk in flight at
   once) bitwise the flat call; and the coded int8 / fp8 legs (flat,
   2-hop, chunked through ``wire.transfer_fn``) of an f32 tensor bitwise
   the flat coded leg.  Each timed.
2. ``layer``: the config's MoE layer, ``--batch`` x ``--seq`` tokens a
   rank, LSH on, bf16 and int8 wires, forward and backward under the
   plans of ``CommConfig(a2a_impl=...)`` flat, hierarchical and
   pipelined (2, 4 chunks): y and each gradient against flat (bitwise
   for the 2-hop; within 2 bf16 steps of max |y| and 2^-7 relative L2
   for the pipelined exchange, whose expert MLP runs on fewer rows and
   whose weight gradients are sums over chunks); the forward alone and
   forward + backward timed.
3. ``tune``: ``autotune`` on the mesh into a temporary cache directory:
   the probe rows, the fitted link constants, the measured-best choices,
   and the plan the calibrated planner then makes.
Times are ms a call: the median of ``--reps`` samples, each 10 calls in
a row between CUDA events after a barrier (the host clock on the CPU,
where nothing on the device is measured), the largest over the ranks.
Exits non-zero if a check fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import statistics
import sys
import tempfile
import time

CHUNKS = (2, 4)
INNER = 10                  # calls a timed sample
Y_STEPS = 2 ** -7
GRAD_RTOL = 2 ** -7
DIFF = ("router_w", "w_gate", "w_up", "w_down")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-moe-3b-a800m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-sized)")
    ap.add_argument("--node-size", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--slots", type=int, default=208,
                    help="slots S of the legs' wire leaves")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--ladder", default="65536,524288,4194304,16777216")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from repro_torch import resolve_device
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.launch.mesh import init_distributed, make_mesh

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    init_distributed(dev, timeout_s=300)
    torch.backends.cuda.matmul.allow_tf32 = False
    world = dist.get_world_size()
    mesh = make_mesh(1, world, node_size=args.node_size)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    ok = True

    def emit(kind, **rec):
        if mesh.rank == 0:
            print(json.dumps({"kind": kind, **rec}, sort_keys=True),
                  flush=True)

    try:
        emit("profile_comm", ranks=world, node_size=args.node_size,
             device=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"), torch=torch.__version__,
             arch=args.arch, smoke=args.smoke)
        ok &= _legs(torch, dist, mesh, cfg, dev, args, emit)
        ok &= _layer(torch, dist, mesh, cfg, dev, args, emit)
        _tune(torch, mesh, cfg, dev, args, emit)
    finally:
        dist.barrier()
        dist.destroy_process_group()
    return 0 if ok else 1


def _timer(torch, dist, dev, reps, inner=INNER):
    """fn -> ms a call: the median over ``reps`` samples of ``inner``
    calls in a row (so the ranks' skew after the barrier is spread over
    them), the largest over the ranks."""
    cuda = dev.type == "cuda"

    def timed(fn):
        fn()
        samples = []
        for _ in range(reps):
            dist.barrier()
            if cuda:
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(inner):
                    fn()
                b.record()
                b.synchronize()
                samples.append(a.elapsed_time(b) / inner)
            else:
                t0 = time.perf_counter()
                for _ in range(inner):
                    fn()
                samples.append((time.perf_counter() - t0) * 1e3 / inner)
        t = torch.tensor([statistics.median(samples)], dtype=torch.float64,
                         device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t.item())
    return timed


def _same(torch, a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def _all_ranks(torch, dist, dev, flag):
    t = torch.tensor([int(flag)], device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t.item())


def _legs(torch, dist, mesh, cfg, dev, args, emit) -> bool:
    from repro_torch.comm import collectives, wire
    from repro_torch.comm.hierarchical import two_hop
    from repro_torch.comm.pipeline import pipelined_all_to_all
    from repro_torch.runtime import sharding
    r = mesh.axis_size("model")
    group = sharding.model_group(mesh)
    groups = mesh.hop_groups(args.node_size)
    timed = _timer(torch, dist, dev, args.reps)
    e_local = -(-cfg.moe.num_experts // r)
    shape = (r, e_local, args.slots, cfg.d_model)
    gen = torch.Generator().manual_seed(100 + mesh.rank)
    base = torch.randn(shape, generator=gen).to(dev)
    leaves = {"bf16": base.to(torch.bfloat16),
              "int8": (base * 40).round().clamp(-127, 127).to(torch.int8),
              "fp8": base.to(torch.float8_e4m3fn),
              "f32 scales": torch.exp2(torch.round(base[..., 0] * 4))}
    ok = True

    def chunked(x, k):
        parts = [c.contiguous() for c in x.split(x.shape[2] // k, 2)]
        pend = [collectives.raw_all_to_all_async(c, group) for c in parts]
        return torch.cat([p.wait() for p in pend], dim=2)

    for name, x in leaves.items():
        flat = collectives.raw_all_to_all(x, group)
        got = {"hierarchical": two_hop(x, groups)}
        got.update({f"chunked{k}": chunked(x, k) for k in CHUNKS})
        same = {t: _all_ranks(torch, dist, dev, _same(torch, y, flat))
                for t, y in got.items()}
        ms = {"flat": timed(lambda: collectives.raw_all_to_all(x, group)),
              "hierarchical": timed(lambda: two_hop(x, groups))}
        ms.update({f"chunked{k}": timed(lambda k=k: chunked(x, k))
                   for k in CHUNKS})
        ok &= all(same.values())
        emit("legs", leaf=name, shape=list(shape[:x.dim()]),
             bytes=x.numel() * x.element_size(), bitwise_flat=same, ms=ms)
    for fmt in ("int8", "fp8"):
        codec = wire.make_codec(fmt, compute_dtype=torch.float32)
        legs = {"flat": lambda v: wire.coded_transfer(
                    v, codec, *wire.flat_leaves(group)),
                "hierarchical": lambda v: wire.coded_transfer(
                    v, codec, *wire.hierarchical_leaves(groups))}
        legs.update({f"pipelined{k}": lambda v, k=k: pipelined_all_to_all(
            v, group, k, transfer=wire.transfer_fn(codec, group))
            for k in CHUNKS})
        with torch.no_grad():
            want = legs["flat"](base)
            same = {t: _all_ranks(torch, dist, dev,
                                  _same(torch, leg(base), want))
                    for t, leg in legs.items() if t != "flat"}
            ms = {t: timed(lambda leg=leg: leg(base))
                  for t, leg in legs.items()}
        ok &= all(same.values())
        emit("coded_legs", wire=fmt, shape=list(shape), bitwise_flat=same,
             ms=ms)
    return ok


def _rel_l2(torch, a, b):
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / max(float(torch.linalg.vector_norm(b)), 1e-30))


def _layer(torch, dist, mesh, cfg, dev, args, emit) -> bool:
    from repro_torch.comm import planner
    from repro_torch.configs.base import CommConfig
    from repro_torch.core import moe as moe_lib
    from repro_torch.core.lsh_moe import lsh_moe_init
    timed = _timer(torch, dist, dev, max(3, args.reps // 2))
    H = cfg.d_model
    dtype = getattr(torch, cfg.dtype)
    gen = torch.Generator().manual_seed(200 + mesh.rank)
    x0 = torch.randn((args.batch, args.seq, H), generator=gen).to(dev, dtype)
    ct = torch.randn((args.batch, args.seq, H), generator=gen).to(dev)
    plans = {"flat": CommConfig(a2a_impl="flat"),
             "hierarchical": CommConfig(a2a_impl="hierarchical",
                                        node_size=args.node_size)}
    plans.update({f"pipelined{k}": CommConfig(a2a_impl="pipelined",
                                              overlap_chunks=k)
                  for k in CHUNKS})
    ok = True
    for fmt in ("bf16", "int8"):
        moe = dataclasses.replace(cfg.moe, lsh=dataclasses.replace(
            cfg.moe.lsh, wire_format=fmt))
        params = lsh_moe_init(torch.Generator(device=dev).manual_seed(5), H,
                              moe, mlp_act=cfg.mlp_act, dtype=dtype,
                              device=dev, mesh=mesh)
        res, ms = {}, {}
        for tag, comm in plans.items():
            c = dataclasses.replace(moe, comm=comm)

            def run(grad=True, c=c):
                p = {k: (v.detach().requires_grad_(grad) if k in DIFF
                         else v) for k, v in params.items()}
                x = x0.detach().requires_grad_(grad)
                with torch.set_grad_enabled(grad):
                    y, st = moe_lib.moe_expert_parallel(
                        x, p, c, mlp_act=cfg.mlp_act, use_lsh=True,
                        mesh=mesh)
                    if not grad:
                        return y, ()
                    obj = (y.float() * ct).sum() + st["aux_loss"] \
                        + st["z_loss"]
                    return y.detach(), torch.autograd.grad(
                        obj, [x] + [p[k] for k in DIFF])
            res[tag] = run()
            plan = planner.last_plan("model")
            ms[tag] = {"plan": f"{plan.algorithm}/{plan.intra}/"
                               f"{plan.chunks}",
                       "forward_ms": timed(lambda run=run: run(False)),
                       "forward_backward_ms": timed(run)}
        y_f, g_f = res["flat"]
        scale = float(y_f.float().abs().max())
        checks = {}
        for tag, (y, grads) in res.items():
            if tag == "flat":
                continue
            dy = float((y.float() - y_f.float()).abs().max())
            rel = {n: _rel_l2(torch, g, gf)
                   for n, g, gf in zip(("x",) + DIFF, grads, g_f)}
            y_bits = torch.equal(y, y_f)
            g_bits = {n: torch.equal(g, gf)
                      for n, g, gf in zip(("x",) + DIFF, grads, g_f)}
            good = (y_bits and all(g_bits.values())) \
                if tag == "hierarchical" else (
                    dy <= Y_STEPS * scale and max(rel.values()) <= GRAD_RTOL)
            good = _all_ranks(torch, dist, dev, good)
            ok &= good
            checks[tag] = {"ok": good, "y_bitwise": y_bits, "max_dy": dy,
                           "grads_bitwise": g_bits, "grad_rel_l2": rel}
        emit("layer", wire=fmt, tokens_per_rank=args.batch * args.seq,
             times=ms, against_flat=checks, max_abs_y=scale)
        del params, res
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return ok


def _tune(torch, mesh, cfg, dev, args, emit) -> None:
    from repro_torch.configs.base import CommConfig
    from repro_torch.tune import cache
    d = tempfile.mkdtemp(prefix="repro-tune-")
    os.environ[cache.ENV_CACHE] = d
    comm = CommConfig(node_size=args.node_size)
    try:
        _tuned(torch, mesh, cfg, dev, args, emit, comm)
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _tuned(torch, mesh, cfg, dev, args, emit, comm) -> None:
    from repro_torch.comm import planner
    from repro_torch.core.clustering import wire_bytes
    from repro_torch.tune.autotune import autotune
    choices = autotune(mesh, comm, ladder=tuple(
        int(b) for b in args.ladder.split(",") if b),
        wire_formats=("bf16", "int8"), chunk_candidates=CHUNKS,
        iters=args.reps, device=dev)
    for r in choices.model.measured:
        emit("tune_row", row_kind=r.kind, name=r.name,
             wire_format=r.wire_format, msg_bytes=r.msg_bytes,
             chunks=r.chunks, ms=r.seconds * 1e3)
    m = choices.model
    r = mesh.axis_size("model")
    msg = wire_bytes(-(-cfg.moe.num_experts // r) * r, args.slots,
                     cfg.d_model, "int8")
    plan = planner.plan_collectives(
        mesh, dataclasses.replace(comm, tuning="cache", overlap_chunks=2),
        msg_bytes=msg, chunk_extent=args.slots)
    emit("tune", fitted={"intra_bw": m.intra_bw, "inter_bw": m.inter_bw,
                         "intra_lat": m.intra_lat,
                         "inter_lat": m.inter_lat,
                         "fit_residual": m.fit_residual},
         best_transport=[list(t) for t in choices.best_transport],
         best_chunks=[list(t) for t in choices.best_chunks],
         stored=bool(choices.cache_path),
         plan_int8_training_shape={"algorithm": plan.algorithm,
                                   "chunks": plan.chunks,
                                   "calibrated": plan.calibrated,
                                   "msg_bytes": msg, "reason": plan.reason})


if __name__ == "__main__":
    sys.exit(main())
