"""xlstm-350m and whisper-base with tensor parallelism on (``dp_only``
off) over a (1, 4) mesh of four cards: the xLSTM mixers' and the
encoder-decoder's split over ``model`` (models/xlstm.py, runtime/tp.py),
and the xLSTM decode state laid out by JAX's ``decode_state_specs``.

Cases (``--case``; ``all`` runs both in one process group), each at full
width and depth (seeded weights), every leaf split by its spec
(runtime/params.py), first in f32, held to bounds against one card, then
in the config's bf16, where the distances from one card are recorded
(the step and decode times and the peak memory are the config's).

The full-width xLSTM stack amplifies a difference in the last bit: on 4
gloo ranks at full width in f32 (seed 0, 8 rows, 8 steps), moving every
entry of the embedding table by one ulp moves one card's decode logits
by 4.9e-4 relative L2 at full depth and 2.9e-5 at one super-block, and
the mesh's reordered sums (tp_rmsnorm, decode_project, the products on
the rank's columns) put its logits 3.0e-4 and 2.0e-5 from one card's.
So each f32 distance is held to the larger of the CPU tests' bound and
NOISE_FACTOR times rank 0's own distance under that one-ulp change
(``_one_ulp``), measured in the same run beside it: a wrong head, gate or
slice moves the result by orders of magnitude more.

  xlstm    8 mLSTM heads, 2 a rank; the sLSTM replicated over ``model``.
           One AdamW step at BATCH x SEQ tokens on the mesh against rank
           0's one-card step from the same params (gathered whole) and
           batch: the loss (LOSS_RTOL) and the clip norm (NORM_RTOL,
           tests/test_torch_tp.py's loss and gradient bounds); the params
           after the step recorded beside the one card's.  Then ROWS
           rows, STEPS teacher-forced decode steps from the stepped params
           on the state of ``init_decode_state(mesh=)`` (the mLSTM state
           by heads, the sLSTM state by width) against rank 0's mesh-free
           decode of the same params: the logits' relative L2
           (DECODE_RTOL, tests/test_torch_xlstm.py's), bit-equal on every
           rank in both dtypes, greedy tokens recorded; the state's bytes
           a rank and whole.
  whisper  8 heads, 2 a rank; frames [BATCH, WHISPER_FRAMES, d_model] and
           tokens [BATCH, WHISPER_TOKENS], each split by its sequence.
           One AdamW step against rank 0's one-card step, as above.

Every rank records step ms and its peak memory.  Each rank prints one
JSON line a case and dtype; rank 0 prints the card's name and power limit
first and a summary line a case.  Exits non-zero when a check fails.

  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
      scripts/xlstm_encdec_tp.py

Rehearse on the CPU (4 gloo ranks, the smoke configs):

  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
      scripts/xlstm_encdec_tp.py --smoke --device cpu --seq 32 \\
      --whisper-frames 32 --whisper-tokens 16
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

MESH = (1, 4)
BATCH, SEQ = 4, 1024
WHISPER_FRAMES, WHISPER_TOKENS = 1500, 448   # its 30 s window, its context
ROWS, STEPS, CACHE = 8, 8, 64
# f32 against one card: tests/test_torch_tp.py's loss and gradient bounds,
# tests/test_torch_xlstm.py's decode bound, or NOISE_FACTOR times the one
# card's own distance under a one-ulp change of its embedding table
LOSS_RTOL, NORM_RTOL, DECODE_RTOL = 1e-5, 1e-4, 1e-5
NOISE_FACTOR = 4.0
DTYPES = ("float32", "bfloat16")     # the first one held to the bounds
CASES = ("xlstm", "whisper")


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


def _rel(torch, a, b) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def _one_ulp(torch, params):
    """``params`` with a copy of the embedding table whose every entry
    lies one ulp further from zero (its bits plus one)."""
    table = params["embed"]["table"].clone()
    table.view(torch.int32 if table.element_size() == 4
               else torch.int16).add_(1)
    return {**params, "embed": {**params["embed"], "table": table}}


def _held(rec, key, dist, noise, floor):
    """Records ``dist`` and ``noise`` under ``key`` -> whether dist lies
    within the larger of ``floor`` and NOISE_FACTOR x noise."""
    bound = max(floor, NOISE_FACTOR * noise)
    rec.update({key: dist, f"{key}_one_ulp": noise, f"{key}_bound": bound})
    return dist <= bound


def _same_on_every_rank(ctx, t) -> bool:
    import torch.distributed as dist

    from repro_torch.comm import collectives
    got = collectives.raw_all_gather(t.contiguous()[None], dist.group.WORLD,
                                     0)
    return all(ctx.torch.equal(got[0], got[r]) for r in range(got.shape[0]))


def _batch(ctx, cfg, frames: int, tokens: int):
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.models.model import torch_dtype
    from repro_torch.runtime import step as step_lib
    torch = ctx.torch
    batch = step_lib.batch_to_device(SyntheticLMDataset(
        cfg.vocab_size, tokens, ctx.args.batch).batch_at(0), ctx.dev)
    if cfg.encoder_decoder:
        g = torch.Generator(device=ctx.dev).manual_seed(ctx.args.seed + 3)
        batch["frames"] = torch.randn(
            (ctx.args.batch, frames, cfg.d_model), generator=g,
            device=ctx.dev).to(torch_dtype(cfg.dtype))
    return batch


def _train_check(ctx, cfg, batch, gate):
    """One AdamW step over the mesh against rank 0's one-card step ->
    (record, ok, mesh, the rank's params after the step); ``gate``: the
    bounds decide ``ok`` (else the distances are recorded only)."""
    import torch.distributed as dist

    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.convert import gather_params
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.adam import _map, adamw_init, leaves
    from repro_torch.runtime import params as params_lib
    from repro_torch.runtime import step as step_lib
    torch = ctx.torch
    opt = OptimizerConfig(lr=1e-4, warmup_steps=0, total_steps=10)
    mesh = make_mesh(*MESH)
    specs = params_lib.model_specs(cfg, mesh)
    state = step_lib.init_train_state(cfg, opt, seed=ctx.args.seed,
                                      device=ctx.dev, mesh=mesh)
    rec = {"arch": cfg.name, "mesh": list(MESH),
           "tokens": list(batch["tokens"].shape),
           "params_bytes_per_rank": sum(
               t.numel() * t.element_size() for t in leaves(state.params))}
    ref = None
    if ctx.rank == 0:
        whole = gather_params(state.params, mesh, specs)
        ref = {}
        for tag in ("one_card", "one_ulp"):
            # a copy: a leaf that does not split is the rank's own tensor,
            # and the step updates its params in place
            p = _map(lambda t: t.clone(), whole)
            if tag == "one_ulp":
                p = _one_ulp(torch, p)
            free = step_lib.TrainState(p, adamw_init(p, opt))
            ctx.sync()
            t0 = time.perf_counter()
            free, m = step_lib.make_train_step(cfg, opt)(free, batch)
            ctx.sync()
            ref[tag] = dict(loss=float(m["loss"]),
                            grad_norm=float(m["grad_norm"]),
                            ms=(time.perf_counter() - t0) * 1e3,
                            params=leaves(free.params))
            del free, p
        del whole
    else:
        gather_params(state.params, mesh, specs)    # its collectives
    dist.barrier()
    ctx.reset()
    step = step_lib.make_train_step(cfg, opt, mesh=mesh)
    ctx.sync()
    t0 = time.perf_counter()
    state, m = step(state, batch)
    ctx.sync()
    rec.update(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
               step_ms=(time.perf_counter() - t0) * 1e3,
               peak_memory_gib=ctx.peak_gib())
    after = leaves(gather_params(state.params, mesh, specs))
    ok = bool(torch.isfinite(torch.tensor([rec["loss"], rec["grad_norm"]]))
              .all())
    if ref is not None:
        one, ulp = ref["one_card"], ref["one_ulp"]

        def rel(a, b):
            return abs(a - b) / abs(b)
        rec.update(one_card_loss=one["loss"],
                   one_card_grad_norm=one["grad_norm"],
                   one_card_step_ms=one["ms"],
                   params_worst_rel_l2=max(
                       _rel(torch, a, b) for a, b in zip(after, one["params"])
                       if b.is_floating_point() and b.norm() > 0))
        held = [_held(rec, f"{key}_rel", rel(rec[key], one[key]),
                      rel(ulp[key], one[key]), floor)
                for key, floor in (("loss", LOSS_RTOL),
                                   ("grad_norm", NORM_RTOL))]
        if gate:
            ok = ok and all(held)
    return rec, ok, mesh, state.params


def case_xlstm(ctx, dtype, gate):
    from repro_torch.models import model as model_lib
    torch = ctx.torch
    cfg = ctx.get("xlstm-350m").replace(dp_only=False, dtype=dtype)
    rec, ok, mesh, local = _train_check(
        ctx, cfg, _batch(ctx, cfg, 0, ctx.args.seq), gate)
    # decode from the params after the step, mesh-free on rank 0
    from repro_torch.convert import gather_params
    from repro_torch.runtime import params as params_lib
    whole = gather_params(local, mesh, params_lib.model_specs(cfg, mesh))
    tokens = torch.randint(0, cfg.vocab_size, (ROWS, STEPS),
                           generator=torch.Generator().manual_seed(
                               ctx.args.seed + 1)).to(ctx.dev)

    def decode(params, m):
        state = model_lib.init_decode_state(cfg, ROWS, CACHE,
                                            device=ctx.dev, mesh=m)
        r0, n = state["layout"]["rows"] if m is not None else (0, ROWS)
        logits, ms = [], []
        for i in range(STEPS):
            ctx.sync()
            t0 = time.perf_counter()
            lg, state = model_lib.decode_step(
                params, cfg, state, tokens[r0:r0 + n, i:i + 1], mesh=m)
            ctx.sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            logits.append(lg)
        return torch.cat(logits, 1), state, ms

    ref = (decode(whole, None)[0], decode(_one_ulp(torch, whole), None)[0]) \
        if ctx.rank == 0 else None
    del whole
    ctx.reset()
    got, state, ms = decode(local, mesh)
    whole_state = model_lib.init_decode_state(cfg, ROWS, CACHE,
                                              device="meta")
    rec["decode"] = {
        "rows": ROWS, "steps": STEPS, "step_ms": ms,
        "layout": {k: v for k, v in state["layout"].items()
                   if k not in ("specs", "shapes")},
        "state_bytes_per_rank": sum(
            t.numel() * t.element_size() for layer in state["layers"]
            for t in layer.values()),
        "state_bytes_whole": sum(
            t.numel() * t.element_size() for layer in whole_state["layers"]
            for t in layer.values()),
        "peak_memory_gib": ctx.peak_gib(),
        "logits_bit_equal_on_every_rank": _same_on_every_rank(ctx, got)}
    ok = ok and rec["decode"]["logits_bit_equal_on_every_rank"] and bool(
        torch.isfinite(got).all())
    if ref is not None:
        rec["decode"]["greedy_equal"] = bool(torch.equal(
            got.argmax(-1), ref[0].argmax(-1)))
        held = _held(rec["decode"], "rel_l2", _rel(torch, got, ref[0]),
                     _rel(torch, ref[1], ref[0]), DECODE_RTOL)
        ok = ok and (held or not gate)
    return rec, ok


def case_whisper(ctx, dtype, gate):
    cfg = ctx.get("whisper-base").replace(dp_only=False, dtype=dtype)
    rec, ok, _, _ = _train_check(
        ctx, cfg, _batch(ctx, cfg, ctx.args.whisper_frames,
                         ctx.args.whisper_tokens), gate)
    return rec, ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--case", default="all", choices=("all",) + CASES)
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--seq", type=int, default=SEQ)
    ap.add_argument("--whisper-frames", type=int, default=WHISPER_FRAMES)
    ap.add_argument("--whisper-tokens", type=int, default=WHISPER_TOKENS)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed

    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("xlstm_encdec_tp: no CUDA device", file=sys.stderr)
            return 1
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
        # the one-card references run in full f32 products, as the mesh
        torch.backends.cuda.matmul.allow_tf32 = False
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
        print(f"xlstm_encdec_tp: needs 4 ranks, has "
              f"{dist.get_world_size()}", file=sys.stderr)
        return 2
    failed = False
    for case in CASES if args.case == "all" else (args.case,):
        for dtype in DTYPES:
            t0 = time.time()
            rec, ok = {"xlstm": case_xlstm, "whisper": case_whisper}[case](
                ctx, dtype, gate=dtype == DTYPES[0])
            rec.update(case=case, dtype=dtype, rank=rank, ok=ok,
                       wall_s=time.time() - t0)
            print(json.dumps(rec, sort_keys=True), flush=True)
            flag = torch.tensor([0 if ok else 1], device=dev)
            dist.all_reduce(flag)
            failed = failed or int(flag.item()) > 0
            if rank == 0:
                print(json.dumps({
                    "summary": "xlstm_encdec_tp", "case": case,
                    "dtype": dtype, "ok": int(flag.item()) == 0,
                    "device": torch.cuda.get_device_name(dev)
                    if ctx.cuda else "cpu"}), flush=True)
            ctx.reset()
    dist.destroy_process_group()
    return int(failed)


if __name__ == "__main__":
    raise SystemExit(main())
