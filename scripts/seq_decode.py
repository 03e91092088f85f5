"""Decode over a sequence-split KV cache on four cards: the state of
``models.model.init_decode_state(mesh=)``, laid out by JAX's
``decode_state_specs`` (the caches' sequence over ``model``, rows over
``data``), through ``models.model.decode_step``.

Cases (``--case``; ``all`` runs both in one process group):

  phi3         phi3-mini-3.8b at full width and depth (bf16, seeded
               weights), ROWS rows, over (1, 4).  First a CHECK_LEN cache:
               STEPS teacher-forced steps against rank 0's one-card
               mesh-free decode of the same params (gathered whole):
               greedy tokens equal, logits within BF16_RTOL relative L2
               (tests/test_torch_archs.py's bf16 decode bound), and the
               four ranks' logits bit-equal.  Then a LONG_LEN cache (the
               decode_32k cells'; whole, it is more than a card holds),
               filled with seeded values, STEPS steps across the edge of
               the last two ranks' blocks: finite logits, bit-equal on
               every rank, ms a step, the state's bytes and the peak
               memory a rank.
  granite-2x2  granite-moe-3b-a800m at full size over (2, 2), ROWS rows
               (half a data rank), a CHECK_LEN cache: STEPS steps, the
               logits bit-equal on every rank that holds them, each
               routing kernel (positions_in_expert, dispatch_scatter,
               combine_gather) launched once a MoE layer a step on every
               rank; the distance from rank 0's mesh-free decode is
               recorded (top-k routing can send a token elsewhere on a
               last-bit difference, so no dense bound holds it).

Each rank prints one JSON line a case; rank 0 prints the card's name and
power limit first and a summary line a case.  Exits non-zero when a
check fails.

  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
      scripts/seq_decode.py

Rehearse on the CPU (4 gloo ranks, the smoke configs):

  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
      scripts/seq_decode.py --smoke --device cpu --check-len 16 \\
      --long-len 32
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

ROWS, STEPS = 8, 8
CHECK_LEN, LONG_LEN = 4096, 32768
BF16_RTOL = 3e-2
CASES = ("phi3", "granite-2x2")


class Ctx:
    def __init__(self, torch, args, dev, rank):
        from repro_torch.configs.registry import get_config, get_smoke_config
        self.torch, self.args, self.dev, self.rank = torch, args, dev, rank
        self.cuda = dev.type == "cuda"
        self.get = get_smoke_config if args.smoke else get_config

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize(self.dev)

    def reset(self):
        if self.cuda:
            self.torch.cuda.empty_cache()
            self.torch.cuda.reset_peak_memory_stats(self.dev)

    def peak_gib(self):
        return self.torch.cuda.max_memory_allocated(self.dev) / 2 ** 30 \
            if self.cuda else None


def _tokens(ctx, cfg):
    torch = ctx.torch
    return torch.randint(0, cfg.vocab_size, (ROWS, STEPS),
                         generator=torch.Generator().manual_seed(
                             ctx.args.seed + 1)).to(ctx.dev)


def _decode(ctx, params, cfg, state, tokens, mesh):
    """STEPS teacher-forced steps from the state's position -> (logits
    [rows, STEPS, V], the state, ms of each step)."""
    from repro_torch.models import model as model_lib
    torch = ctx.torch
    logits, ms = [], []
    for i in range(STEPS):
        ctx.sync()
        t0 = time.perf_counter()
        lg, state = model_lib.decode_step(params, cfg, state,
                                          tokens[:, i:i + 1], mesh=mesh)
        ctx.sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        logits.append(lg)
    return torch.cat(logits, 1), state, ms


def _state_bytes(state):
    return sum(t.numel() * t.element_size() for layer in state["layers"]
               for t in layer.values())


def _same_on_every_rank(ctx, t):
    """Whether every rank holds the same bits of ``t``."""
    import torch.distributed as dist

    from repro_torch.comm import collectives
    got = collectives.raw_all_gather(t.contiguous()[None], dist.group.WORLD,
                                     0)
    return all(ctx.torch.equal(got[0], got[r]) for r in range(got.shape[0]))


def _check(ctx, cfg, shape, kernels=(), gate=True):
    """ROWS rows over a CHECK_LEN cache on ``shape``, against rank 0's
    mesh-free decode -> (record, ok, mesh, local params); ``gate``: the
    greedy tokens and the logits' bound decide ``ok`` (else they are
    recorded only)."""
    import torch.distributed as dist

    from repro_torch.comm import collectives
    from repro_torch.convert import gather_params
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as model_lib
    from repro_torch.runtime import params as params_lib
    from repro_torch.runtime import sharding
    torch = ctx.torch
    mesh = make_mesh(*shape)
    local = model_lib.init_params(cfg, seed=ctx.args.seed, device=ctx.dev,
                                  mesh=mesh)
    whole = gather_params(local, mesh, params_lib.model_specs(cfg, mesh))
    tokens = _tokens(ctx, cfg)
    ref = None
    if ctx.rank == 0:
        state = model_lib.init_decode_state(cfg, ROWS, ctx.args.check_len,
                                            device=ctx.dev)
        ref, state, ref_ms = _decode(ctx, whole, cfg, state, tokens, None)
        del state
    del whole
    dist.barrier()
    ctx.reset()
    state = model_lib.init_decode_state(cfg, ROWS, ctx.args.check_len,
                                        device=ctx.dev, mesh=mesh)
    r0, n = state["layout"]["rows"]
    for k in kernels:
        k.launches = 0
    got, state, ms = _decode(ctx, local, cfg, state, tokens[r0:r0 + n],
                             mesh)
    launches = {k.name: k.launches for k in kernels}
    rec = {"arch": cfg.name, "mesh": list(shape), "rows": ROWS,
           "cache_len": ctx.args.check_len, "layout": {
               k: v for k, v in state["layout"].items()
               if k not in ("specs", "shapes")},
           "state_bytes_per_rank": _state_bytes(state), "step_ms": ms,
           "peak_memory_gib": ctx.peak_gib(), "launches": launches}
    if n < ROWS:
        got = collectives.raw_all_gather(got.contiguous(),
                                         sharding.dp_group(mesh), 0)
    rec["logits_bit_equal_on_every_rank"] = _same_on_every_rank(ctx, got)
    ok = rec["logits_bit_equal_on_every_rank"] and bool(
        torch.isfinite(got).all())
    want = cfg.num_layers * STEPS
    if kernels:
        ok = ok and all(v == want for v in launches.values())
    if ref is not None:
        a, b = got.double(), ref.double()
        rec.update(one_card_step_ms=ref_ms,
                   rel_l2=float(torch.linalg.norm(a - b)
                                / torch.linalg.norm(b)),
                   max_abs=float((a - b).abs().max()),
                   greedy_equal=bool(torch.equal(got.argmax(-1),
                                                 ref.argmax(-1))),
                   bound=BF16_RTOL)
        if gate:
            ok = ok and rec["greedy_equal"] and rec["rel_l2"] <= BF16_RTOL
    del state
    return rec, ok, mesh, local


def case_phi3(ctx):
    from repro_torch.models import model as model_lib
    torch = ctx.torch
    cfg = ctx.get("phi3-mini-3.8b")
    rec, ok, mesh, local = _check(ctx, cfg, (1, 4))
    meta = model_lib.init_decode_state(cfg, ROWS, ctx.args.long_len,
                                       device="meta")
    ctx.reset()
    state = model_lib.init_decode_state(cfg, ROWS, ctx.args.long_len,
                                        device=ctx.dev, mesh=mesh)
    g = torch.Generator(device=ctx.dev).manual_seed(ctx.args.seed + 2
                                                     + ctx.rank)
    for layer in state["layers"]:
        for t in layer.values():
            t.copy_(torch.randn(t.shape, generator=g, device=ctx.dev,
                                dtype=torch.float32).to(t.dtype))
    n = ctx.args.long_len // state["layout"]["seq_blocks"]
    state["position"] = ctx.args.long_len - n - STEPS // 2
    got, state, ms = _decode(ctx, local, cfg, state, _tokens(ctx, cfg),
                             mesh)
    same = _same_on_every_rank(ctx, got)
    rec["long"] = {"cache_len": ctx.args.long_len,
                   "positions": [state["position"] - STEPS,
                                 state["position"] - 1],
                   "state_bytes_whole": _state_bytes(meta),
                   "state_bytes_per_rank": _state_bytes(state),
                   "step_ms": ms, "peak_memory_gib": ctx.peak_gib(),
                   "logits_bit_equal_on_every_rank": same,
                   "finite": bool(torch.isfinite(got).all())}
    del state
    return rec, ok and same and rec["long"]["finite"]


def case_granite(ctx):
    from repro_torch.kernels import dispatch
    cfg = ctx.get("granite-moe-3b-a800m")
    # top-k routing turns a last-bit difference of the split softmax into
    # another expert for a token, so the one-card comparison is recorded,
    # not held to the dense bound
    rec, ok, _, _ = _check(ctx, cfg, (2, 2),
                           kernels=dispatch.ROUTING_KERNELS if ctx.cuda
                           else (), gate=False)
    return rec, ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--case", default="all", choices=("all",) + CASES)
    ap.add_argument("--check-len", type=int, default=CHECK_LEN)
    ap.add_argument("--long-len", type=int, default=LONG_LEN)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed

    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("seq_decode: no CUDA device", file=sys.stderr)
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
    init_distributed(dev)
    if dist.get_world_size() != 4:
        print(f"seq_decode: needs 4 ranks, has {dist.get_world_size()}",
              file=sys.stderr)
        return 2
    failed = False
    for case in CASES if args.case == "all" else (args.case,):
        t0 = time.time()
        rec, ok = {"phi3": case_phi3, "granite-2x2": case_granite}[case](ctx)
        rec.update(case=case, rank=rank, ok=ok, wall_s=time.time() - t0)
        print(json.dumps(rec, sort_keys=True), flush=True)
        flag = torch.tensor([0 if ok else 1], device=dev)
        dist.all_reduce(flag)
        failed = failed or int(flag.item()) > 0
        if rank == 0:
            print(json.dumps({"summary": "seq_decode", "case": case,
                              "ok": int(flag.item()) == 0,
                              "device": torch.cuda.get_device_name(dev)
                              if ctx.cuda else "cpu"}), flush=True)
        ctx.reset()
    dist.destroy_process_group()
    return int(failed)


if __name__ == "__main__":
    raise SystemExit(main())
