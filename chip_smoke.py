#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one H100 and check it.

  python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:
  1. device   CUDA with compute capability (9, 0); prints nvidia-smi's
              name and power limit.
  2. build    builds every kernel from src/repro_torch/kernels/csrc with
              nvcc for sm_90a (one nvcc per source, in parallel), and
              csrc/launch_floor.cu, an empty kernel.
  3. kernels  holds each CUDA kernel against its plain PyTorch version on
              the card, and times kernel, plain version and the nearest
              single PyTorch call with CUDA events beside each kernel's
              bound.  Routing kernels at the decode shape (F=32, E=40,
              C=4, H=1536) and the training shape (F=32768, E=40, C=1024,
              H=1536): bitwise for integers and unique plans, and a
              duplicate-(e, c) scatter within 1e-6 of the sum of its
              terms' magnitudes.  LSH kernels at the training shape
              (T=40960 hashed rows, L=6, Dr=64; G=40, C=1024, S=208) and a
              ragged small shape with out-of-range slots: lsh_hash equal
              wherever the two largest |v| differ by more than 1e-5 of the
              largest, segment_centroid within 1e-6 of the mean magnitude
              with exact counts, residual_apply bitwise; lsh_hash's
              tensor-core kernel also at T=4100 with H=40 / 1096 / 1536
              and (L, Dr)=(5, 16), (1, 8), (3, 16), (6, 64), zero rows and
              exact three-way ties (first index), and timed beside its
              bound and a cuBLAS chain (bf16 mm, abs, argmax, sign).
              Every kernel
              called twice gives the same bits, and each autograd.Function
              backward matches autograd through the plain versions within
              1e-6 of the sum of the magnitudes of each result's terms.
              The wire kernels (wire_quantize from f32 centroids and from
              bf16 expert outputs, wire_dequantize, and the fused
              dispatch_scatter_quantize, dequantize_combine_gather,
              dequantize_residual_apply with and without base) for int8
              and fp8 at the training shape (G=40, S=208) and the decode
              one: bitwise (payload bits, scales, values), each fused
              kernel bitwise the unfused kernels it replaces, timed
              beside the shortest PyTorch chain; dispatch_scatter_quantize
              also at ragged shapes (E x C = 315 and 32 rows, H = 1536
              and 1000, bf16 and f32 src, duplicates few and many,
              out-of-range ids and positions) bitwise the plain version
              on the CPU and the composed kernels; and an fp8 encode sweep
              of every 97th f32 bit pattern in [-448, 448] (23,479,456
              values) bitwise torch's CUDA cast, every non-NaN code's
              decode bitwise torch's.  positions_in_expert at F = 40963
              (not a tile multiple), ids uniform and all in one expert,
              with ids -1 and E: bitwise, one launch a call, timed;
              wire_dequantize at [40, 1024, 1536] (the coded baseline's
              buffer), bitwise and timed; fp8 rows under a 2^-124 scale
              whose values dequantize below 2^-126, through the
              dequantize and both fused dequantizing kernels: f32 bits
              equal to the plain versions' and fused == composed; and
              the empty kernel timed as the kernels are (one block, and
              a cooperative launch of the training shape's blocks), the
              floor under any launch.
  4. serve    repro_torch.launch.serve.main at the full granite-moe-3b-a800m
              config (bf16, random weights from a seeded torch.Generator):
              8 requests, 4 slots, 16 prompt + 16 generated tokens; each
              routing kernel ran once per MoE layer per decode step (2048
              launches) and no LSH kernel ran.
  5. parity   the same config cut to 2 layers in f32, 8 teacher-forced
              decode steps on the card (kernels) and on the CPU (plain
              versions) with the same params, TF32 off: logits within 1e-3
              and equal greedy tokens.
  6. train    repro_torch.launch.train.main at the full config, bf16,
              batch 4 x 1024: 3 steps with LSH on, then 2 with it off;
              finite losses, no skips, every kernel launched on the LSH-on
              run and no LSH kernel on the other; then one steady-state
              step under torch.profiler (device busy ms, idle share, top
              device ops, host ms in kernel launch calls, and the port's
              kernels' device ms: each kernel and each template
              instantiation).  Its first
              warm-up step records the slots it hands segment_centroid:
              the forward's and residual_apply's backward's (the clamped
              overflow bin), at the first and the last MoE layer.  Their
              statistics are printed (rows in range, the largest slot's
              rows and share), and segment_centroid is held to its plain
              version at them and at all C rows of every group in slot
              S - 1 (bf16 and f32): counts equal, sums within 1e-6 of the
              magnitude sum, the same bits twice, timed beside
              index_add_ and the bound.  Then the int8 / fp8 wire (LSHConfig.
              wire_format by dataclasses.replace, through
              init_train_state + make_train_step): int8 with LSH on (4
              steps), fp8 with LSH on (4), int8 with LSH off (3); finite
              losses, and each wire kernel of the setting launched its
              expected count a step (LSH on: wire_quantize 128,
              wire_dequantize 128, dequantize_residual_apply 64; off:
              dispatch_scatter_quantize 64, wire_quantize 64,
              wire_dequantize 64, dequantize_combine_gather 96; each
              dispatch_scatter_quantize launch is a memset and two
              kernels on the stream), one more step profiled (device busy
              ms, its idle share of the mean host-clock step after the
              first, host ms in kernel launch calls, top device ops, the
              port's kernels).
  7. train parity  the config at full width, 2 layers, f32, LSH on, batch
              2 x 64: one train step (the first of a warm-up) on the card
              (kernels) and on the CPU (plain versions) from the same
              params and batch, TF32 off.  With an f32 wire: slots equal
              in every MoE layer, loss within 1e-5 relative, each gradient
              leaf within 1e-4 and each param after AdamW within 1e-5
              relative L2.  With the production bf16 wire, whose roundings
              turn the two devices' last-bit f32 differences into bf16
              steps (ROADMAP Queue 3), and with the int8 wire, whose
              roundings do the same by whole quanta: the first layer's
              slots equal and the loss within 1e-3; the rest is printed.
  8. nccl   one NCCL rank (init_process_group on a HashStore: no
              network), its NCCL version printed; the collectives' raw calls
              (comm/collectives.py's AllToAll, AllGather, ReduceScatter,
              which skip no call for a group of one rank, and the gradient
              all-reduce) on the training shape's wire leaves: bf16
              [1, 40, 208, 1536], int8 and fp8 payloads of that shape with
              f32 scales [1, 40, 208], the coded baseline's int8
              [1, 40, 1024, 1536] and scales [1, 40, 1024], and one
              256 MiB f32 gradient bucket.  Each forward and backward
              returns its input's bits; each forward is timed (CUDA
              events) beside the bytes it moves, and a profile of one pass
              lists NCCL's ops.
  9. mesh   the full config, 4 x 1024 tokens, bf16 and int8 wires with
              LSH on: 2 training steps through the mesh path on a (1, 1)
              mesh of that rank (runtime.step with mesh=) and 2 through
              the mesh-free path from the same seed; the losses, the clip
              norms and every param leaf (a digest of its bits) after step
              2 bit-equal; then one more step of each under the profiler:
              step ms, device busy ms, kernel launches, the port's kernels
              and NCCL's (none: a group of one rank makes no call).
 10. comm   on that NCCL rank: the chunked all-to-all as raw calls (2 and
              4 chunks of axis 2, every chunk issued asynchronously, then
              waited) on the nccl phase's leaves, bitwise the unchunked
              call, both timed; one full-config MoE layer (4 x 1024
              tokens, LSH on, bf16 and int8 wires) forward and backward
              through pipelined plans of 2 and 4 chunks over the one-rank
              group against the flat plan: y within 2 bf16 steps of its
              largest magnitude and each gradient within 2^-7 relative L2
              (printed bitwise where they are), each chunk's int8 / fp8
              encode and decode bitwise the slice of the whole, and one
              profiled pass of each plan (launches, device ms); the tune
              probe's kernel rows at its own size and at the training
              shape, and autotune on the one-rank axis, which must store
              no cache entry; then a full-config train step with
              a2a_impl="pipelined", overlap_chunks=2 on mesh (1, 1):
              the planner's degrade reason logged, and its loss
              bit-equal to the flat mesh step's.
The line before the last is the kernels' JSON record (times at the
training shape, int8 for the wire kernels; launches of the bf16-wire
LSH-on training run for the routing and LSH kernels, of the int8 runs
for the wire kernels); the last line is {"ok": true, "device": {...}}.  Without a CUDA device, or without the rest
of the repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
ARCH = "granite-moe-3b-a800m"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
FP32_OPS_PER_S = 67e12             # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12            # H100 SXM bf16 tensor cores, dense
DUP_RTOL = 1e-6
SUM_RTOL = 1e-6
NEAR_TIE = 1e-5
PARITY_ATOL = 1e-3
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
PARAM_RTOL = 1e-5
BF16_WIRE_LOSS_RTOL = 1e-3
REPS = 30
SLEEP_CYCLES = 4_000_000           # ~2 ms at the H100's clocks
LAUNCH_FLOOR_SOURCE = "launch_floor.cu"   # an empty kernel (csrc/)
POSITIONS_TILE = 256               # entries a block of token_position.cu
TRAIN_ARGV = ["--arch", ARCH, "--batch", "4", "--seq", "1024",
              "--log-every", "1"]
WIRE_FORMATS = ("int8", "fp8")
# (wire format, LSH on, steps) of the quantized training runs, and the
# wire kernels' launches per MoE layer and step of each setting: each
# forward runs twice (the checkpoint's recompute); with LSH on it encodes
# and decodes the centroids (compress) and the expert outputs, and with
# it off the backward adds a dequantize-gather for the combine weights'
# gradient
WIRE_RUNS = (("int8", True, 4), ("fp8", True, 4), ("int8", False, 3))
WIRE_LAUNCHES_PER_LAYER = {
    True: {"wire_quantize": 4, "wire_dequantize": 4,
           "dequantize_residual_apply": 2},
    False: {"dispatch_scatter_quantize": 2, "wire_quantize": 2,
            "wire_dequantize": 2, "dequantize_combine_gather": 3}}


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------ 1. device --

def phase_device(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs compute capability (9, 0), "
                         f"found {cap}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)                        # as nvidia-smi prints it
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return smi


# ------------------------------------------------------------- 2. build --

def phase_build(build, kernels):
    t0 = time.time()
    logs = build.build_all(sorted({k.source for k in kernels}
                                  | {LAUNCH_FLOOR_SOURCE}))
    log(f"[build] {len(logs)} sources in {time.time() - t0:.3f} s")
    for source, out in logs.items():
        for line in out.splitlines():
            if "registers" in line or "error" in line.lower():
                log(f"[build] {source}: {line.strip()}")


# ----------------------------------------------------------- 3. kernels --

def time_ms(torch, fn, *, queued=True, reps=REPS, warmup=3):
    """Median over ``reps`` calls of the time between CUDA events recorded
    around one call.  ``queued``: each call waits on the device behind a
    sleep kernel long enough to hide the host's launch time, so the events
    time the device's work; otherwise the time includes the host's launch
    overhead whenever the host is slower than the device."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        fn()
        b.record()
        if not queued:
            b.synchronize()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def make_plan(torch, ref, T, k, E, C, H, *, skew, bad_frac, seed):
    """Routing inputs as the main path builds them: top-k distinct experts
    per token (skewed toward low ids when ``skew``), a fraction of ids
    outside [0, E), positions from the plain version with the overflow-bin
    mapping, bf16 tokens repeated k times, an f32 expert-output buffer and
    f32 weights."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    scores = torch.rand(T, E, generator=g, device=dev)
    if skew:
        scores = scores + torch.linspace(0.3, 0.0, E, device=dev)
    ids = torch.argsort(scores, dim=1, descending=True)[:, :k]
    ids = ids.reshape(-1).to(torch.int32)
    F = T * k
    n_bad = int(F * bad_frac)
    if n_bad:
        where = torch.randperm(F, generator=g, device=dev)[:n_bad]
        ids[where[: n_bad // 2]] = -1
        ids[where[n_bad // 2:]] = E + 2
    ids = ids.contiguous()
    raw, _ = ref.positions_in_expert_ref(ids, E)
    in_range = (ids >= 0) & (ids < E)
    pos = torch.where(in_range, raw, C).to(torch.int32)
    keep = pos < C
    flat = torch.where(keep, ids, E).to(torch.int32).contiguous()
    tokens = torch.randn(T, H, generator=g, device=dev).to(torch.bfloat16)
    src = torch.repeat_interleave(tokens, k, dim=0).contiguous()
    buf = torch.randn(E, C, H, generator=g, device=dev)
    w = torch.rand(F, generator=g, device=dev)
    return dict(ids=ids, flat=flat, pos=pos.contiguous(), keep=keep, src=src,
                buf=buf, w=w, F=F, E=E, C=C, H=H)


def _bound(bytes_moved, ops, ops_per_s=FP32_OPS_PER_S):
    """The least time for the work, in ms: the larger of the bytes over
    the memory rate and the operations over the peak rate of their type."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _timed(torch, kernel, plain, library, bound):
    """Time the kernel (device time, and the whole call with the host's
    launch time), the plain version and the library call."""
    b, by = bound
    return dict(
        ms=time_ms(torch, kernel), call_ms=time_ms(torch, kernel,
                                                   queued=False),
        plain_ms=time_ms(torch, plain),
        library_ms=None if library is None else time_ms(torch, library),
        bound_ms=b, bound_by=by)


def _same_twice(torch, label, name, kernel, first):
    """A second call gives the same bits (the backward pass recomputes the
    forward under torch.utils.checkpoint and must see the same values)."""
    again = kernel()
    for g, r in zip(first, again):
        if not torch.equal(g, r):
            raise AssertionError(f"[{label}] {name}: a second call gave other "
                                 "bits")


def _record(torch, label, name, kernel, plain, library, bound):
    """Hold ``kernel()`` against ``plain()`` bitwise and time both."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    for g, r in zip(got, want):
        if not torch.equal(g, r):
            raise AssertionError(f"[{label}] {name} differs from its plain "
                                 "version")
    _same_twice(torch, label, name, kernel, got)
    return dict(max_abs_err=max(float((g.float() - r.float()).abs().max())
                                for g, r in zip(got, want)),
                **_timed(torch, kernel, plain, library, bound))


def _log_records(label, out):
    for name, r in out.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.6f}"
        log(f"[kernels] {label} {name}: kernel_ms={r['ms']:.6f} "
            f"call_ms={r['call_ms']:.6f} plain_ms={r['plain_ms']:.6f} "
            f"library_ms={lib} bound_us={r['bound_ms'] * 1e3:.3f} "
            f"({r['bound_by']}) max_abs_err={r['max_abs_err']}")


def _positions_chain(torch, ids, E):
    """positions_in_expert as PyTorch calls, a yardstick of time: a one-hot
    of the in-range ids, its cumsum gathered at each id, minus 1."""
    valid = (ids >= 0) & (ids < E)
    idc = torch.where(valid, ids, 0).long()
    cs = torch.nn.functional.one_hot(idc, E).mul_(valid[:, None]).cumsum(0)
    return (torch.where(valid, cs.gather(1, idc[:, None])[:, 0] - 1, 0),
            cs[-1])


def check_kernels(torch, tp, sg, ref, p, label):
    """Compare each kernel with its plain version on ``p`` and time both and
    the nearest single PyTorch call.  Returns {kernel name: record}."""
    F, E, C, H = p["F"], p["E"], p["C"], p["H"]
    ids, flat, pos, src, buf, w, keep = (p["ids"], p["flat"], p["pos"],
                                         p["src"], p["buf"], p["w"],
                                         p["keep"])
    n_kept = int(keep.sum())
    # the library calls get their index arithmetic done beforehand
    rows = torch.where(keep, flat.long() * C + pos.long(), E * C)
    src32 = src.float()
    ids_c, pos_c = flat.long().clamp(0, E - 1), pos.long().clamp(0, C - 1)
    w_m = w * keep.float()
    out = {
        "positions_in_expert": _record(
            torch, label, "positions_in_expert",
            lambda: tp.positions_in_expert(ids, E),
            lambda: ref.positions_in_expert_ref(ids, E),
            lambda: _positions_chain(torch, ids, E),
            _bound(F * 4 + F * 4 + E * 4, 0)),
        "dispatch_scatter": _record(
            torch, label, "dispatch_scatter",
            lambda: (sg.dispatch_scatter(flat, pos, src, E, C),),
            lambda: (ref.dispatch_scatter_ref(flat, pos, src, E, C),),
            lambda: torch.zeros(E * C + 1, H, device="cuda").index_put_(
                (rows,), src32, accumulate=True),
            _bound(F * 8 + n_kept * H * src.element_size() + E * C * H * 4,
                   n_kept * H)),
        "combine_gather": _record(
            torch, label, "combine_gather",
            lambda: (sg.combine_gather(flat, pos, buf, w),),
            lambda: (ref.combine_gather_ref(flat, pos, buf, w),),
            lambda: buf[ids_c, pos_c] * w_m[:, None],
            _bound(F * 12 + n_kept * H * 4 + F * H * 4, F * H)),
    }
    # the backward of combine_gather scatters an f32 cotangent
    out["dispatch_scatter (f32 src)"] = _record(
        torch, label, "dispatch_scatter (f32 src)",
        lambda: (sg.dispatch_scatter(flat, pos, src32, E, C),),
        lambda: (ref.dispatch_scatter_ref(flat, pos, src32, E, C),),
        lambda: torch.zeros(E * C + 1, H, device="cuda").index_put_(
            (rows,), src32, accumulate=True),
        _bound(F * 8 + n_kept * H * 4 + E * C * H * 4, n_kept * H))
    if not bool((sg.combine_gather(flat, pos, buf, w)[~keep] == 0).all()):
        raise AssertionError(f"[{label}] dropped entries must gather zero")
    log(f"[kernels] {label}: F={F} E={E} C={C} H={H} kept={n_kept} "
        f"dropped={F - n_kept} (ids out of range or over capacity)")
    _log_records(label, out)
    return out


def check_duplicates(torch, sg, ref, E, C, H, F, seed):
    """Scatter with many duplicate (e, c) pairs: the kernel sums in entry
    order, the plain version (index_add_ with atomics on the card) in
    another, so each element may differ by a reordered f32 sum: within
    DUP_RTOL times the sum of the magnitudes of its terms."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    ids = torch.randint(-1, E + 1, (F,), generator=g, device="cuda",
                        dtype=torch.int32)
    pos = torch.randint(0, C // 8, (F,), generator=g, device="cuda",
                        dtype=torch.int32)
    src = torch.randn(F, H, generator=g, device="cuda").to(torch.bfloat16)
    got = sg.dispatch_scatter(ids, pos, src, E, C)
    _same_twice(torch, "duplicates", "dispatch_scatter",
                lambda: (sg.dispatch_scatter(ids, pos, src, E, C),), (got,))
    want = ref.dispatch_scatter_ref(ids, pos, src, E, C)
    scale = ref.dispatch_scatter_ref(ids, pos, src.abs(), E, C)
    err = (got - want).abs()
    ok = bool((err <= DUP_RTOL * scale).all())
    log(f"[kernels] duplicates: F={F} into {E}x{C // 8} rows, max_abs_err="
        f"{float(err.max())} max rel-to-magnitude "
        f"{float((err / scale.clamp_min(1e-30)).max())} (rtol {DUP_RTOL})")
    if not ok:
        raise AssertionError("duplicate scatter outside tolerance")


def _vertex_check(torch, lh, label, got, want, x, rot, name="lsh_hash"):
    """Vertex ids equal wherever the hash is not at a near-tie."""
    margin = lh.near_tie_margin(x, rot)
    ok = margin > NEAR_TIE
    if not torch.equal(got[ok], want[ok]):
        raise AssertionError(f"[{label}] {name} differs from its plain "
                             "version away from near-ties")
    n_tie = int((~ok).sum())
    log(f"[kernels] {label} {name}: {n_tie} of {ok.numel()} (token, hash) "
        f"pairs within the near-tie margin {NEAR_TIE} (not compared), "
        f"{int((got != want).sum())} differ; smallest margin "
        f"{float(margin.min()):.3g}")
    return float((got.long() - want.long()).abs().max())


def _sum_check(torch, label, name, got, want, scale):
    """Each element within SUM_RTOL of ``scale`` (the same sum over the
    terms' magnitudes): an f32 sum in another order."""
    err = (got - want).abs()
    if not bool((err <= SUM_RTOL * scale).all()):
        raise AssertionError(f"[{label}] {name} outside {SUM_RTOL} of the "
                             "magnitude of its terms")
    return float(err.max())


def lsh_inputs(torch, ref, hashing, p, S, *, L=6, Dr=64, seed=14):
    """The LSH stage's inputs as the training path makes them from the
    routing plan ``p``: the bf16 dispatch buffer (unfilled rows zero), the
    bf16 rotations (the lsh_rot params), the slots of the occupied rows
    (overflow bin S elsewhere), f32 expert outputs on the centroids and an
    f32 residual."""
    E, C, H = p["E"], p["C"], p["H"]
    g = torch.Generator(device="cuda").manual_seed(seed)
    disp = ref.dispatch_scatter_ref(p["flat"], p["pos"], p["src"], E, C) \
        .to(torch.bfloat16)
    rot = (torch.randn(L, H, Dr, generator=g, device="cuda") / H ** 0.5) \
        .to(torch.bfloat16)
    counts = torch.bincount(p["flat"][p["keep"]].long(), minlength=E)[:E]
    occupied = torch.arange(C, device="cuda")[None] < counts[:, None]
    x = disp.reshape(E * C, H)
    ids = hashing._fold(ref.lsh_hash_ref(x, rot).reshape(E, C, L))
    slots = torch.where(occupied, torch.remainder(torch.abs(ids), S),
                        S).to(torch.int32)
    eout = torch.randn(E, S, H, generator=g, device="cuda")
    return dict(x=x, disp=disp, rot=rot, slots=slots, eout=eout,
                resid=disp.float(), G=E, C=C, S=S, H=H, L=L, Dr=Dr)


def _lsh_chain(torch, x, rot):
    """lsh_hash as PyTorch calls, a yardstick of time: one bf16 mm of x
    with the rotations packed beforehand to [H, L * Dr] (f32 output where
    torch.mm takes out_dtype, else bf16), abs, argmax, the sign gather.
    Returns (the chain, the mm's output type)."""
    T = x.shape[0]
    L, H, Dr = rot.shape
    w = rot.permute(1, 0, 2).reshape(H, L * Dr).contiguous()
    try:
        torch.mm(x[:8], w, out_dtype=torch.float32)
        kw, kind = {"out_dtype": torch.float32}, "f32"
    except TypeError:
        kw, kind = {}, "bf16"

    def chain():
        v = torch.mm(x, w, **kw).view(T, L, Dr)
        idx = v.abs().argmax(-1)
        neg = v.gather(-1, idx[..., None])[..., 0] < 0
        return 2 * idx + neg
    return chain, kind


def _centroid_record(torch, scm, ref, label, slots, x, S):
    """segment_centroid on (slots, x) against its plain version: counts
    equal, sums within SUM_RTOL of the terms' magnitudes, the same bits on
    a second call; timed beside index_add_ of the sums and the bound."""
    G, C, H = x.shape
    cent, counts = scm.segment_centroid(slots, x, S)
    rc, rn = ref.segment_centroid_ref(slots, x, S)
    if not torch.equal(counts, rn):
        raise AssertionError(f"[{label}] segment_centroid counts differ")
    mag, _ = ref.segment_centroid_ref(slots, x.float().abs(), S)
    err = _sum_check(torch, label, "segment_centroid", cent, rc, mag)
    _same_twice(torch, label, "segment_centroid",
                lambda: scm.segment_centroid(slots, x, S), (cent, counts))
    in_range = (slots >= 0) & (slots < S)
    n_in = int(in_range.sum())
    rows = torch.where(in_range, torch.arange(G, device="cuda")[:, None] * S
                       + slots, G * S).reshape(-1)
    x32 = x.reshape(G * C, H).float()
    return dict(max_abs_err=err, **_timed(
        torch, lambda: scm.segment_centroid(slots, x, S),
        lambda: ref.segment_centroid_ref(slots, x, S),
        lambda: torch.zeros(G * S + 1, H, device="cuda").index_add_(
            0, rows, x32),
        _bound(G * C * 4 + n_in * H * x.element_size() + G * S * H * 4
               + G * S * 4, n_in * H)))


def check_lsh_kernels(torch, lh, scm, ram, ref, q, label):
    """lsh_hash, segment_centroid and residual_apply on ``q`` against their
    plain versions, and timed."""
    G, C, S, H, L, Dr = q["G"], q["C"], q["S"], q["H"], q["L"], q["Dr"]
    x, rot, disp, slots = q["x"], q["rot"], q["disp"], q["slots"]
    eout, resid = q["eout"], q["resid"]
    T = x.shape[0]
    in_range = (slots >= 0) & (slots < S)
    n_in = int(in_range.sum())
    clamped = torch.clamp(slots, max=S - 1)
    out = {}

    flops = 2 * T * H * L * Dr
    log(f"[kernels] {label} lsh_hash bounds: {flops / 1e9:.2f} GFLOP, "
        f"{flops / FP32_OPS_PER_S * 1e3:.6f} ms at f32 FMA, "
        f"{flops / BF16_OPS_PER_S * 1e3:.6f} ms at bf16 tensor cores, "
        f"{(T * H * x.element_size()) / HBM_BYTES_PER_S * 1e3:.6f} ms "
        "for the bytes")
    # bf16 x and rotations, as the training path has them, take the tensor
    # cores; f32 ones (an f32 model) the f32-FMA kernel
    x32, rot32 = x.float(), rot.float()
    chain, chain_out = _lsh_chain(torch, x, rot)
    log(f"[kernels] {label} lsh_hash library chain: bf16 mm with {chain_out} "
        "output, abs, argmax, sign gather")
    for name, xi, ri, rate, library in (
            ("lsh_hash", x, rot, BF16_OPS_PER_S, chain),
            ("lsh_hash (f32 x, FMA kernel)", x32, rot32, FP32_OPS_PER_S,
             None)):
        got = lh.lsh_hash(xi, ri)
        err = _vertex_check(torch, lh, label, got, ref.lsh_hash_ref(xi, ri),
                            xi, ri, name)
        _same_twice(torch, label, name, lambda: (lh.lsh_hash(xi, ri),),
                    (got,))
        out[name] = dict(max_abs_err=err, **_timed(
            torch, lambda: lh.lsh_hash(xi, ri),
            lambda: ref.lsh_hash_ref(xi, ri), library,
            _bound(T * H * xi.element_size() + ri.numel() * ri.element_size()
                   + T * L * 4, flops, rate)))
    del x32, rot32
    pack_ms = time_ms(torch, lambda: lh.pack_rotations(rot))
    log(f"[kernels] {label} lsh_hash: of its kernel_ms, {pack_ms:.6f} ms "
        "pack the rotations")

    out["segment_centroid"] = _centroid_record(torch, scm, ref, label,
                                               slots, disp, S)

    rows_c = (torch.arange(G, device="cuda")[:, None] * S + clamped) \
        .reshape(-1)
    eflat = eout.reshape(G * S, H)
    got = ram.residual_apply(clamped, eout, resid)
    want = ref.residual_apply_ref(clamped, eout, resid)
    if not torch.equal(got, want):
        raise AssertionError(f"[{label}] residual_apply differs from its "
                             "plain version")
    _same_twice(torch, label, "residual_apply",
                lambda: (ram.residual_apply(clamped, eout, resid),), (got,))
    out["residual_apply"] = dict(max_abs_err=float((got - want).abs().max()),
                                 **_timed(
        torch, lambda: ram.residual_apply(clamped, eout, resid),
        lambda: ref.residual_apply_ref(clamped, eout, resid),
        lambda: (eflat[rows_c].view(G, C, H) + resid),
        _bound(G * C * 4 + G * S * H * 4 + 2 * G * C * H * 4, G * C * H)))
    log(f"[kernels] {label}: T={T} L={L} Dr={Dr}; G={G} C={C} S={S} H={H}, "
        f"{n_in} rows in range of {G * C}")
    _log_records(label, out)
    return out


def check_lsh_ragged(torch, lh, scm, ram, ref):
    """A ragged small shape: C and H not multiples of the kernels' tiles
    (H = 34 takes the one-column paths; H = 40 with bf16 rotations the
    tensor cores, with 600 rows and Dr = 16), slot ids in the overflow
    bin, beyond it and negative, and f32 inputs."""
    g = torch.Generator(device="cuda").manual_seed(15)
    G, C, S = 3, 200, 24
    for H, dt, rot_dt in ((40, torch.bfloat16, torch.bfloat16),
                          (36, torch.bfloat16, torch.float32),
                          (34, torch.float32, torch.float32)):
        slots = torch.randint(0, S, (G, C), generator=g, device="cuda",
                              dtype=torch.int32)
        slots[0, :7] = S
        slots[-1, 3], slots[-1, 4] = S + 5, -1
        x = torch.randn(G, C, H, generator=g, device="cuda").to(dt)
        x[1, :5] = 0
        rot = (torch.randn(3, H, 16, generator=g, device="cuda")
               / H ** 0.5).to(rot_dt)
        xf = x.reshape(G * C, H)
        _vertex_check(torch, lh, f"ragged H={H}", lh.lsh_hash(xf, rot),
                      ref.lsh_hash_ref(xf, rot), xf, rot)
        cent, counts = scm.segment_centroid(slots, x, S)
        rc, rn = ref.segment_centroid_ref(slots, x, S)
        mag, _ = ref.segment_centroid_ref(slots, x.float().abs(), S)
        if not torch.equal(counts, rn):
            raise AssertionError("ragged segment_centroid counts differ")
        _sum_check(torch, "ragged", "segment_centroid", cent, rc, mag)
        for r in (x.float(), None):
            if not torch.equal(ram.residual_apply(slots, rc, r),
                               ref.residual_apply_ref(slots, rc, r)):
                raise AssertionError("ragged residual_apply differs")
    log(f"[kernels] ragged: G={G} C={C} S={S}, H=40 / 36 bf16 and H=34 "
        "f32, overflow-bin / beyond / negative slots: all three agree")


def check_lsh_hash_shapes(torch, lh, ref):
    """lsh_hash's tensor-core kernel at ragged shapes: T not a multiple of
    its 128-row tile, H not of its 64-deep k slice, L * Dr not of its
    192-column tile.  Rows 0-2 are zero (vertex 0); columns 1, Dr / 2 and
    Dr - 1 of each rotation are one large column, so wherever it holds the
    maximum the three tie exactly and index 1 must win; elsewhere equal
    away from near-ties; the same bits on a second call."""
    g = torch.Generator(device="cuda").manual_seed(18)
    for T, H, L, Dr in ((4100, 40, 5, 16), (4100, 1096, 1, 8),
                        (4100, 1096, 3, 16), (4100, 1536, 6, 64)):
        x = torch.randn(T, H, generator=g, device="cuda")
        x[:3] = 0
        x = x.to(torch.bfloat16)
        r = torch.randn(L, H, Dr, generator=g, device="cuda") / H ** 0.5
        r[:, :, 1] *= 30
        r[:, :, Dr // 2] = r[:, :, 1]
        r[:, :, Dr - 1] = r[:, :, 1]
        rot = r.to(torch.bfloat16)
        label = f"ragged T={T} H={H} L={L} Dr={Dr}"
        if not lh.uses_tensor_cores(x, rot):
            raise AssertionError(f"[{label}] lsh_hash took the FMA kernel")
        got = lh.lsh_hash(x, rot)
        _same_twice(torch, label, "lsh_hash", lambda: (lh.lsh_hash(x, rot),),
                    (got,))
        want = ref.lsh_hash_ref(x, rot)
        _vertex_check(torch, lh, label, got, want, x, rot)
        tied = (want // 2) == 1
        n_tied = int(tied.sum())
        if (n_tied < T * L // 2 or not torch.equal(got[tied], want[tied])
                or not bool((got[:3] == 0).all())):
            raise AssertionError(f"[{label}] lsh_hash: exact ties or zero "
                                 "rows differ from the plain version")
        log(f"[kernels] {label} lsh_hash: {n_tied} exact three-way ties, "
            "first index taken; zero rows vertex 0")


def check_scatter_quantize_shapes(torch, mods, ref):
    """dispatch_scatter_quantize at ragged shapes, int8 and fp8, bf16 and
    f32 src, H = 1536 and H = 1000 (the one-column path): a plan of unique
    rows with a few duplicate entries, ids and positions out of range on
    both sides and empty rows, E * C = 315 rows (not a multiple of a
    block's 8); and 3000 entries into 4 x 8 rows (many duplicates).
    Bitwise the plain version on the CPU (which sums duplicates in entry
    order, as the kernel does) and the composed dispatch_scatter +
    wire_quantize on the card; the same bits on a second call."""
    fw, wq, sg = mods["fused_wire"], mods["wire_quant"], mods["scatter_gather"]
    g = torch.Generator(device="cuda").manual_seed(19)
    E, C, F = 7, 45, 300
    rows = torch.randperm(E * C, generator=g, device="cuda")[:F]
    ids = (rows // C).to(torch.int32)
    pos = (rows % C).to(torch.int32)
    ids[[50, 120, 299]] = int(ids[7])           # duplicates of entry 7
    pos[[50, 120, 299]] = int(pos[7])
    ids[10:20:3], ids[11:21:3] = -1, E          # ids out of range
    pos[30:40:3], pos[31:41:3] = -1, C          # positions out of range
    plans = [(ids, pos, E, C),
             (torch.randint(-1, 5, (3000,), generator=g, device="cuda",
                            dtype=torch.int32),
              torch.randint(-1, 9, (3000,), generator=g, device="cuda",
                            dtype=torch.int32), 4, 8)]
    n = 0
    for pid, pp, e, c in plans:
        for H in (1536, 1000):
            base = torch.randn(pid.numel(), H, generator=g, device="cuda")
            for src in (base.to(torch.bfloat16), base):
                for fmt in WIRE_FORMATS:
                    got = tuple(map(_u8, fw.dispatch_scatter_quantize(
                        pid, pp, src, e, c, fmt)))
                    _same_twice(torch, "ragged", "dispatch_scatter_quantize",
                                lambda: tuple(map(
                                    _u8, fw.dispatch_scatter_quantize(
                                        pid, pp, src, e, c, fmt))), got)
                    want = tuple(map(_u8, ref.dispatch_scatter_quantize_ref(
                        pid.cpu(), pp.cpu(), src.cpu(), e, c, fmt)))
                    comp = tuple(map(_u8, wq.wire_quantize(
                        sg.dispatch_scatter(pid, pp, src, e, c), fmt)))
                    if not all(torch.equal(a.cpu(), b) for a, b in
                               zip(got, want)) or not all(
                                   torch.equal(a, b) for a, b in
                                   zip(got, comp)):
                        raise AssertionError(
                            f"ragged dispatch_scatter_quantize {fmt} "
                            f"{src.dtype} H={H} E={e} C={c} F={pid.numel()}"
                            ": differs from the plain version or the "
                            "composed kernels")
                    n += 1
    log(f"[kernels] ragged dispatch_scatter_quantize: {n} cases (E x C = "
        "315 and 32, H = 1536 and 1000, bf16 and f32 src, int8 and fp8; "
        "duplicates few and many, out-of-range ids and positions, empty "
        "rows) bitwise the plain version and the composed kernels")


def check_backwards(torch, dispatch, ref, p, q):
    """Each autograd.Function's backward (kernels) against autograd through
    the plain versions on the card, on the same cotangent, at the training
    shapes.  Every backward is linear in the cotangent with coefficients
    that are ones, 1 / count, weights >= 0 or buffer values, so the plain
    backward at |cotangent| and |inputs| is the sum of the magnitudes of
    each result's terms: each element within SUM_RTOL of it (f32 sums in
    another order; the plain versions sum with atomics on the card)."""
    g = torch.Generator(device="cuda").manual_seed(16)
    S, H = q["S"], q["H"]
    slots = torch.clamp(q["slots"], max=S - 1)      # as decompress has them

    def grads(fn, leaves, ct):
        leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
        return torch.autograd.grad(fn(*leaves), leaves, ct)

    cases = {
        "segment_centroid": (
            lambda x: dispatch.segment_centroid(q["slots"], x, S)[0],
            lambda x: ref.segment_centroid_ref(q["slots"], x, S)[0],
            [q["disp"]], (q["G"], S, H)),
        "residual_apply": (
            lambda e, r: dispatch.residual_apply(slots, e, r),
            lambda e, r: ref.residual_apply_ref(slots, e, r),
            [q["eout"], q["resid"]], q["resid"].shape),
        "dispatch_scatter": (
            lambda s: dispatch.dispatch_scatter(p["flat"], p["pos"], s,
                                                p["E"], p["C"]),
            lambda s: ref.dispatch_scatter_ref(p["flat"], p["pos"], s,
                                               p["E"], p["C"]),
            [p["src"]], (p["E"], p["C"], p["H"])),
        "combine_gather": (
            lambda b, w: dispatch.combine_gather(p["flat"], p["pos"], b, w),
            lambda b, w: ref.combine_gather_ref(p["flat"], p["pos"], b, w),
            [p["buf"], p["w"]], (p["F"], p["H"])),
    }
    for name, (kern, plain, leaves, shape) in cases.items():
        ct = torch.randn(shape, generator=g, device="cuda")
        got, want = grads(kern, leaves, ct), grads(plain, leaves, ct)
        scale = grads(plain, [t.abs() for t in leaves], ct.abs())
        errs = []
        for a, b, m in zip(got, want, scale):
            if a.dtype != b.dtype:
                raise AssertionError(f"{name} backward dtype {a.dtype} vs "
                                     f"{b.dtype}")
            err = (a.float() - b.float()).abs()
            if not bool((err <= SUM_RTOL * m.float()).all()):
                raise AssertionError(f"{name} backward outside {SUM_RTOL} "
                                     "of the magnitude of its terms")
            errs.append(float(err.max()))
        _same_twice(torch, "backward", name, lambda: grads(kern, leaves, ct),
                    got)
        log(f"[kernels] backward {name}: max_abs_err {errs}, within "
            f"{SUM_RTOL} of the magnitude of the terms "
            f"({', '.join(str(tuple(a.shape)) for a in got)})")


def _u8(t):
    """A payload as comparable bytes: fp8 through its uint8 bits (torch
    compares no float8 tensors)."""
    import torch
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def _quantize_chain(torch, x, fmt):
    """The shortest PyTorch chain for the wire quantize: amax, exp2(ceil(
    log2)) of the quotient, div, round and clamp (int8) or clamp (fp8),
    cast.  A yardstick of time only: log2 in floats is not exact at the
    power-of-two boundaries the kernel's bit arithmetic is."""
    xf = x.float()
    qm = 127.0 if fmt == "int8" else 448.0
    sc = torch.exp2(torch.ceil(torch.log2(
        xf.abs().amax(-1, keepdim=True) / qm)))
    y = xf / sc
    if fmt == "int8":
        return torch.clamp(torch.round(y), -127, 127).to(torch.int8), sc
    return torch.clamp(y, -448, 448).to(torch.float8_e4m3fn), sc


def check_wire_kernels(torch, mods, ref, p, q, label, fmt):
    """The five wire kernels on the training path's inputs for ``fmt``:
    bitwise against their plain versions (and the same bits on a second
    call), each fused kernel bitwise against the unfused kernels it
    replaces on the card, and timed beside its bound and its library
    chain."""
    wq, fw = mods["wire_quant"], mods["fused_wire"]
    sg, ram = mods["scatter_gather"], mods["residual_apply"]
    E, C, F, H = p["E"], p["C"], p["F"], p["H"]
    G, S = q["G"], q["S"]
    flat, pos, src, buf, w, keep = (p["flat"], p["pos"], p["src"], p["buf"],
                                    p["w"], p["keep"])
    n_kept = int(keep.sum())
    cent, _ = ref.segment_centroid_ref(q["slots"], q["disp"], S)
    eo16 = q["eout"].to(torch.bfloat16)
    slots = torch.clamp(q["slots"], max=S - 1).contiguous()
    resid = q["resid"]
    qc, sc = ref.wire_quantize_ref(cent, fmt)
    qe, se = ref.wire_quantize_ref(q["eout"], fmt)
    base = ref.wire_dequantize_ref(qc, sc)
    qb, sb = ref.wire_quantize_ref(buf, fmt)
    n_ref = int(torch.unique(torch.arange(G, device="cuda")[:, None] * S
                             + slots).numel())
    ids_c, pos_c = flat.long().clamp(0, E - 1), pos.long().clamp(0, C - 1)
    w_m = w * keep.float()
    rows = torch.where(keep, flat.long() * C + pos.long(), E * C)
    rows_c = (torch.arange(G, device="cuda")[:, None] * S + slots) \
        .reshape(-1)
    src32 = src.float()

    def quant(x):
        return lambda: tuple(map(_u8, wq.wire_quantize(x, fmt)))

    def quant_ref(x):
        return lambda: tuple(map(_u8, ref.wire_quantize_ref(x, fmt)))

    out = {}
    for name, x in (("wire_quantize", cent), ("wire_quantize (bf16)", eo16)):
        out[name] = _record(
            torch, label, f"{name} {fmt}", quant(x), quant_ref(x),
            lambda x=x: _quantize_chain(torch, x, fmt),
            _bound(x.numel() * (x.element_size() + 1) + G * S * 4,
                   4 * x.numel()))
    out["wire_dequantize"] = _record(
        torch, label, f"wire_dequantize {fmt}",
        lambda: (wq.wire_dequantize(qc, sc),),
        lambda: (ref.wire_dequantize_ref(qc, sc),),
        lambda: qc.float() * sc[..., None],
        _bound(qc.numel() * 5 + G * S * 4, qc.numel()))
    out["dispatch_scatter_quantize"] = _record(
        torch, label, f"dispatch_scatter_quantize {fmt}",
        lambda: tuple(map(_u8, fw.dispatch_scatter_quantize(
            flat, pos, src, E, C, fmt))),
        lambda: tuple(map(_u8, ref.dispatch_scatter_quantize_ref(
            flat, pos, src, E, C, fmt))),
        lambda: _quantize_chain(torch, torch.zeros(
            E * C + 1, H, device="cuda").index_put_(
                (rows,), src32, accumulate=True), fmt),
        _bound(F * 8 + n_kept * H * src.element_size() + E * C * (H + 4),
               n_kept * H + 4 * E * C * H))
    out["dequantize_combine_gather"] = _record(
        torch, label, f"dequantize_combine_gather {fmt}",
        lambda: (fw.dequantize_combine_gather(flat, pos, qb, sb, w),),
        lambda: (ref.dequantize_combine_gather_ref(flat, pos, qb, sb, w),),
        lambda: (qb[ids_c, pos_c].float() * sb[ids_c, pos_c][:, None])
        * w_m[:, None],
        _bound(F * 12 + n_kept * (H + 4) + F * H * 4, 2 * F * H))
    out["dequantize_residual_apply"] = _record(
        torch, label, f"dequantize_residual_apply {fmt}",
        lambda: (fw.dequantize_residual_apply(slots, qe, se, resid, base),),
        lambda: (ref.dequantize_residual_apply_ref(slots, qe, se, resid,
                                                   base),),
        lambda: (qe.float() * se[..., None] - base).reshape(G * S, H)[
            rows_c].view(G, C, H) + resid,
        _bound(G * C * 4 + n_ref * (H * 5 + 4) + 2 * G * C * H * 4,
               3 * G * C * H))
    out["dequantize_residual_apply (no base)"] = _record(
        torch, label, f"dequantize_residual_apply (no base) {fmt}",
        lambda: (fw.dequantize_residual_apply(slots, qe, se, resid),),
        lambda: (ref.dequantize_residual_apply_ref(slots, qe, se, resid),),
        lambda: (qe.float() * se[..., None]).reshape(G * S, H)[
            rows_c].view(G, C, H) + resid,
        _bound(G * C * 4 + n_ref * (H + 4) + 2 * G * C * H * 4,
               2 * G * C * H))

    # fused == composed, on the card
    fq, fs = fw.dispatch_scatter_quantize(flat, pos, src, E, C, fmt)
    cq, cs = wq.wire_quantize(sg.dispatch_scatter(flat, pos, src, E, C), fmt)
    same = [torch.equal(_u8(fq), _u8(cq)) and torch.equal(fs, cs)]
    same.append(torch.equal(
        fw.dequantize_combine_gather(flat, pos, qb, sb, w),
        sg.combine_gather(flat, pos, wq.wire_dequantize(qb, sb), w)))
    dq = wq.wire_dequantize(qe, se)
    same.append(torch.equal(
        fw.dequantize_residual_apply(slots, qe, se, resid, base),
        ram.residual_apply(slots, dq - base, resid)))
    same.append(torch.equal(
        fw.dequantize_residual_apply(slots, qe, se, resid),
        ram.residual_apply(slots, dq, resid)))
    if not all(same):
        raise AssertionError(f"[{label}] {fmt}: a fused kernel differs from "
                             f"the composed kernels: {same}")
    log(f"[kernels] {label} {fmt}: fused == composed on the card, bitwise "
        "(scatter-quantize, dequantize-gather, dequantize-residual with "
        f"and without base); {n_ref} payload rows referenced of {G * S}")
    _log_records(f"{label} {fmt}", out)
    return out


def check_wire_decode_shape(torch, mods, ref, p, label):
    """The fused routing kernels at the decode shape and the quantize /
    dequantize / residual kernels at a decode-sized [E, C, H], bitwise and
    timed (printed only)."""
    wq, fw = mods["wire_quant"], mods["fused_wire"]
    E, C, H = p["E"], p["C"], p["H"]
    flat, pos, src, buf, w = p["flat"], p["pos"], p["src"], p["buf"], p["w"]
    g = torch.Generator(device="cuda").manual_seed(17)
    slots = torch.randint(0, 2 * C, (E, 2 * C), generator=g, device="cuda",
                          dtype=torch.int32)
    resid = torch.randn(E, 2 * C, H, generator=g, device="cuda")
    for fmt in WIRE_FORMATS:
        qb, sb = ref.wire_quantize_ref(buf, fmt)
        base = ref.wire_dequantize_ref(qb, sb)
        out = {
            "wire_quantize": _record(
                torch, label, f"wire_quantize {fmt}",
                lambda: tuple(map(_u8, wq.wire_quantize(buf, fmt))),
                lambda: tuple(map(_u8, ref.wire_quantize_ref(buf, fmt))),
                None, _bound(buf.numel() * 5, 0)),
            "wire_dequantize": _record(
                torch, label, f"wire_dequantize {fmt}",
                lambda: (wq.wire_dequantize(qb, sb),),
                lambda: (ref.wire_dequantize_ref(qb, sb),), None,
                _bound(buf.numel() * 5, 0)),
            "dispatch_scatter_quantize": _record(
                torch, label, f"dispatch_scatter_quantize {fmt}",
                lambda: tuple(map(_u8, fw.dispatch_scatter_quantize(
                    flat, pos, src, E, C, fmt))),
                lambda: tuple(map(_u8, ref.dispatch_scatter_quantize_ref(
                    flat, pos, src, E, C, fmt))), None,
                _bound(E * C * H * 3, 0)),
            "dequantize_combine_gather": _record(
                torch, label, f"dequantize_combine_gather {fmt}",
                lambda: (fw.dequantize_combine_gather(flat, pos, qb, sb,
                                                      w),),
                lambda: (ref.dequantize_combine_gather_ref(
                    flat, pos, qb, sb, w),), None,
                _bound(p["F"] * H * 5, 0)),
            "dequantize_residual_apply": _record(
                torch, label, f"dequantize_residual_apply {fmt}",
                lambda: (fw.dequantize_residual_apply(slots, qb, sb, resid,
                                                      base),),
                lambda: (ref.dequantize_residual_apply_ref(
                    slots, qb, sb, resid, base),), None,
                _bound(resid.numel() * 8, 0)),
        }
        _log_records(f"{label} {fmt}", out)


def check_fp8_sweep(torch, wq):
    """Every 97th f32 bit pattern in [0, 448], both signs (23,479,456
    values), through the quantize kernel at scale 1 (each row carries a
    448 pilot, so its po2 scale is exactly 1 and the kernel encodes the
    value itself): payload bits against torch's CUDA cast after the
    clamp.  Then every non-NaN fp8 code through the dequantize kernel
    against torch's cast to f32."""
    bits = torch.arange(0, 0x43E00000 + 1, 97, device="cuda",
                        dtype=torch.int64).to(torch.int32)
    vals = torch.cat([bits.view(torch.float32), -bits.view(torch.float32)])
    n, width = vals.numel(), 1536
    rows = -(-n // (width - 1))
    body = torch.zeros(rows * (width - 1), device="cuda")
    body[:n] = vals
    x = torch.cat([torch.full((rows, 1), 448.0, device="cuda"),
                   body.view(rows, width - 1)], dim=1)
    q, s = wq.wire_quantize(x[None], "fp8")
    got = q[0, :, 1:].reshape(-1)[:n].view(torch.uint8)
    want = torch.clamp(vals, -448.0, 448.0).to(torch.float8_e4m3fn) \
        .view(torch.uint8)
    n_diff = int((got != want).sum())
    codes = torch.arange(256, device="cuda", dtype=torch.int32) \
        .to(torch.uint8)
    codes = codes[(codes & 0x7F) != 0x7F].view(torch.float8_e4m3fn)
    dq = wq.wire_dequantize(codes.reshape(1, 1, -1),
                            torch.ones(1, 1, device="cuda"))
    dec_ok = torch.equal(dq.reshape(-1), codes.float())
    log(f"[kernels] fp8 sweep: {n} values, scales all 1: "
        f"{bool((s == 1).all())}, {n_diff} payloads differ from torch's "
        f"CUDA cast; {codes.numel()} non-NaN codes decode as torch's: "
        f"{dec_ok}")
    if n_diff or not dec_ok or not bool((s == 1).all()):
        raise AssertionError("fp8 sweep: the kernel's encode or decode "
                             "differs from torch's cast")


def check_positions_shapes(torch, tp, ref):
    """positions_in_expert at F = 40963 entries (not a multiple of the
    256-entry tile), E = 40: ids uniform, and every in-range id in one
    expert, each with ids -1 and E among them; bitwise, the same bits
    twice, one launch a call; timed beside the bound and the one-hot
    chain (printed only)."""
    g = torch.Generator(device="cuda").manual_seed(19)
    F, E = 40963, 40
    out = {}
    for dist in ("uniform", "one expert"):
        ids = torch.randint(0, E, (F,), generator=g, device="cuda",
                            dtype=torch.int32)
        if dist == "one expert":
            ids.fill_(E - 1)
        ids[::97] = -1
        ids[5::89] = E
        before = tp.KERNEL.launches
        tp.positions_in_expert(ids, E)
        if tp.KERNEL.launches != before + 1:
            raise AssertionError("positions_in_expert: not one launch a "
                                 "call")
        out[f"positions_in_expert ({dist})"] = _record(
            torch, f"positions F={F}", f"positions_in_expert ({dist})",
            lambda: tp.positions_in_expert(ids, E),
            lambda: ref.positions_in_expert_ref(ids, E),
            lambda: _positions_chain(torch, ids, E),
            _bound(F * 8 + E * 4, 0))
    _log_records(f"positions F={F} E={E}", out)


def measure_launch_floor(torch, build):
    """An empty kernel timed as every kernel here is (time_ms, queued):
    an ordinary launch of one block (positions_in_expert's decode-shape
    launch) and a cooperative one of the training shape's blocks (F =
    32768 entries in 256-entry tiles, at most one block an SM).  No real
    launch of the same kind can take less."""
    import ctypes
    fn = build.load_library(LAUNCH_FLOOR_SOURCE).empty_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grid = min(-(-32768 // POSITIONS_TILE), sms)

    def launch(blocks, coop):
        def go():
            err = fn(blocks, coop, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"empty kernel: cudaError {err}")
        return go
    out = {"ordinary, 1 block": time_ms(torch, launch(1, 0)),
           f"cooperative, {grid} blocks": time_ms(torch, launch(grid, 1))}
    log("[kernels] launch floor (an empty kernel, CUDA events, queued): "
        + "; ".join(f"{k} {v:.6f} ms" for k, v in out.items()))
    return out


def check_dequantize_coded_shape(torch, wq, ref):
    """wire_dequantize at [40, 1024, 1536], the [E, C, H] buffer the int8
    / fp8 coded baseline (LSH off) decodes: bitwise, the same bits twice,
    timed beside its bound and cast + mul (printed only)."""
    g = torch.Generator(device="cuda").manual_seed(21)
    x = torch.randn(40, 1024, 1536, generator=g, device="cuda") * torch.exp(
        torch.randn(40, 1024, 1, generator=g, device="cuda"))
    out = {}
    for fmt in WIRE_FORMATS:
        q, s = ref.wire_quantize_ref(x, fmt)
        out[f"wire_dequantize {fmt}"] = _record(
            torch, "coded [40, 1024, 1536]", f"wire_dequantize {fmt}",
            lambda: (wq.wire_dequantize(q, s),),
            lambda: (ref.wire_dequantize_ref(q, s),),
            lambda: q.float() * s[..., None],
            _bound(q.numel() * 5 + s.numel() * 4, q.numel()))
        del q, s
    _log_records("coded [40, 1024, 1536]", out)


def check_subnormal_rows(torch, mods, ref, H=1536):
    """fp8 rows under a scale of 2^-124 whose values dequantize below
    2^-126 (fp8 subnormal payloads, 0.5, 1.0) beside normal values and
    signed zeros, and a row under scale 1, through wire_dequantize and the
    two fused dequantizing kernels: the f32 bits (signs of zero included)
    equal the plain versions', and fused == composed on the card."""
    wq, fw = mods["wire_quant"], mods["fused_wire"]
    sg, ram = mods["scatter_gather"], mods["residual_apply"]
    vals = torch.tensor([0.5, 1.0, 448.0, 2.0 ** -9, -2.0 ** -9,
                         3 * 2.0 ** -9, -7 * 2.0 ** -9, 2.0 ** -6,
                         -2.0 ** -7, 0.0, -0.0, -448.0], device="cuda")
    v = vals.repeat(-(-H // vals.numel()))[:H]
    q = v.expand(2, 3, H).clone()
    q[1, 1] = -q[1, 1]
    q = q.to(torch.float8_e4m3fn)
    s = torch.tensor([[2.0 ** -124, 2.0 ** -124, 1.0]] * 2, device="cuda")
    ids = torch.tensor([0, 0, 0, 1, 1, 1, 1, 0], dtype=torch.int32,
                       device="cuda")
    pos = torch.tensor([0, 1, 2, 0, 1, 2, 1, 1], dtype=torch.int32,
                       device="cuda")
    w = torch.tensor([1.0, 1.5, 2.0, 1.0, 1.5, 2.0, 1.0, 1.0], device="cuda")
    slots = torch.tensor([[0, 1, 2, 1, 0], [2, 1, 0, 1, 1]],
                         dtype=torch.int32, device="cuda")
    resid = torch.zeros(2, 5, H, device="cuda")
    resid[..., H // 2:] = 1.0
    base = torch.zeros(2, 3, H, device="cuda")
    base[:, 2] = 0.25

    def bits(t):
        return t.contiguous().view(torch.int32)

    dq = wq.wire_dequantize(q, s)
    pairs = {
        "wire_dequantize": (dq, ref.wire_dequantize_ref(q, s)),
        "dequantize_combine_gather": (
            fw.dequantize_combine_gather(ids, pos, q, s, w),
            ref.dequantize_combine_gather_ref(ids, pos, q, s, w)),
        "dequantize_residual_apply": (
            fw.dequantize_residual_apply(slots, q, s, resid, base),
            ref.dequantize_residual_apply_ref(slots, q, s, resid, base)),
        "dequantize_residual_apply (no base)": (
            fw.dequantize_residual_apply(slots, q, s, resid),
            ref.dequantize_residual_apply_ref(slots, q, s, resid))}
    composed = {
        "dequantize_combine_gather": sg.combine_gather(ids, pos, dq, w),
        "dequantize_residual_apply": ram.residual_apply(slots, dq - base,
                                                        resid),
        "dequantize_residual_apply (no base)": ram.residual_apply(
            slots, dq, resid)}
    bad = [name for name, (got, want) in pairs.items()
           if not torch.equal(bits(got), bits(want))]
    bad += [f"{name} (fused != composed)" for name, c in composed.items()
            if not torch.equal(bits(pairs[name][0]), bits(c))]
    nonzero = q[:, :2].float() != 0
    flushed = int((nonzero & (dq[:, :2] == 0)).sum())
    log(f"[kernels] subnormal rows (fp8, scale 2^-124, H={H}): "
        f"{flushed} of {int(nonzero.sum())} nonzero payload values "
        "dequantize to zero; kernels bitwise the plain versions and fused "
        f"== composed: {not bad}")
    if bad:
        raise AssertionError(f"subnormal rows differ: {bad}")


def phase_kernels(torch, mods, ref, moe_lib, hashing):
    tp, sg = mods["token_position"], mods["scatter_gather"]
    # decode shape: 4 batch slots, top-8 of 40, capacity max(4, ceil(1.6))
    decode = make_plan(torch, ref, T=4, k=8, E=40, C=4, H=1536,
                       skew=False, bad_frac=0.0, seed=11)
    check_kernels(torch, tp, sg, ref, decode, "decode")
    C_train = moe_lib.expert_capacity(4096, 40, 8, 1.25)
    train = make_plan(torch, ref, T=4096, k=8, E=40, C=C_train, H=1536,
                      skew=True, bad_frac=0.01, seed=12)
    if int(((train["ids"] >= 0) & (train["ids"] < 40)
            & ~train["keep"]).sum()) == 0:
        raise AssertionError("train plan has no over-capacity entries")
    res = check_kernels(torch, tp, sg, ref, train, "train")
    check_duplicates(torch, sg, ref, 40, C_train, 1536, 32768, seed=13)
    S = moe_lib.num_lsh_slots(C_train, 0.2)
    q = lsh_inputs(torch, ref, hashing, train, S)
    res.update(check_lsh_kernels(torch, mods["lsh_hash"],
                                 mods["segment_centroid"],
                                 mods["residual_apply"], ref, q, "train"))
    check_lsh_ragged(torch, mods["lsh_hash"], mods["segment_centroid"],
                     mods["residual_apply"], ref)
    check_lsh_hash_shapes(torch, mods["lsh_hash"], ref)
    check_backwards(torch, mods["dispatch"], ref, train, q)
    for fmt in WIRE_FORMATS:
        wire = check_wire_kernels(torch, mods, ref, train, q, "train", fmt)
        if fmt == "int8":                   # the JSON record's times
            res.update(wire)
    check_wire_decode_shape(torch, mods, ref, decode, "decode")
    check_scatter_quantize_shapes(torch, mods, ref)
    check_fp8_sweep(torch, mods["wire_quant"])
    check_positions_shapes(torch, tp, ref)
    check_dequantize_coded_shape(torch, mods["wire_quant"], ref)
    check_subnormal_rows(torch, mods, ref)
    measure_launch_floor(torch, mods["build"])
    return res


# ------------------------------------------------------------- 4. serve --

def phase_serve(serve, kernels, routing_kernels, cfg):
    argv = ["--arch", ARCH, "--requests", "8", "--batch-slots", "4",
            "--prompt-len", "16", "--gen", "16"]
    for k in kernels:
        k.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(argv)
    launches = {k.name: k.launches for k in kernels}
    if rc != 0:
        raise AssertionError(f"serve.main returned {rc}")
    events = [json.loads(line) for line in buf.getvalue().splitlines()
              if line.startswith("{")]
    summary = [e for e in events if e["kind"] == "serve_summary"]
    if len(summary) != 1:
        raise AssertionError("serve printed no serve_summary")
    s = summary[0]
    log("[serve] " + json.dumps(s, sort_keys=True))
    steps = 2 * (16 + 16)                     # 8 requests / 4 slots
    want = cfg.num_layers * steps
    log(f"[serve] launches {launches} (want {want} = {cfg.num_layers} MoE "
        f"layers x {steps} decode steps)")
    if s["requests"] != 8 or s["tokens"] != 8 * 16:
        raise AssertionError(f"serve_summary counts wrong: {s}")
    if not all(math.isfinite(s[k]) and s[k] > 0
               for k in ("tokens_per_s", "latency_p50_s", "latency_p99_s")):
        raise AssertionError(f"serve_summary metrics not finite: {s}")
    routing = {k.name for k in routing_kernels}
    bad = {n: c for n, c in launches.items()
           if c != (want if n in routing else 0)}
    if bad:
        raise AssertionError(f"kernel launches on the serve path: {bad}, "
                             f"want {want} of each routing kernel and none "
                             "of the LSH kernels")
    return s, launches


# ------------------------------------------------------------ 5. parity --

def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.detach().to(device)


def phase_parity(torch, model_lib, kernels, routing_kernels, cfg_full):
    """Same params on the card (kernels) and on the CPU (plain versions),
    f32 with TF32 off on the card."""
    cfg = cfg_full.replace(num_super_blocks=2, dtype="float32")
    cpu = torch.device("cpu")
    params_cpu = model_lib.init_params(cfg, seed=3, device=cpu)
    params_gpu = tree_to(params_cpu, "cuda")
    tokens = torch.randint(0, cfg.vocab_size, (4, 8),
                           generator=torch.Generator().manual_seed(4))
    runs = {}
    for name, params, dev in (("cuda", params_gpu, torch.device("cuda")),
                              ("cpu", params_cpu, cpu)):
        before = [k.launches for k in kernels]
        state = model_lib.init_decode_state(cfg, 4, 8, device=dev)
        outs = []
        for i in range(8):
            logits, state = model_lib.decode_step(
                params, cfg, state, tokens[:, i:i + 1].to(dev))
            outs.append(logits.float().cpu())
        runs[name] = torch.cat(outs, dim=1)
        ran = [k.launches - b for k, b in zip(kernels, before)]
        want = [cfg.num_layers * 8 if k in routing_kernels else 0
                for k in kernels]
        if name == "cuda" and ran != want:
            raise AssertionError(f"parity run launched {ran}, want {want}")
        if name == "cpu" and any(ran):
            raise AssertionError("the CPU run launched CUDA kernels")
    a, b = runs["cuda"], runs["cpu"]
    if not bool(torch.isfinite(a).all()):
        raise AssertionError("non-finite logits on the card")
    err = float((a - b).abs().max())
    same = bool(torch.equal(a.argmax(-1), b.argmax(-1)))
    log(f"[parity] {cfg.num_layers} layers f32, 8 steps x 4 slots: max "
        f"|logits cuda - cpu| = {err} (atol {PARITY_ATOL}), greedy tokens "
        f"equal: {same}, TF32 off")
    if err > PARITY_ATOL or not same:
        raise AssertionError("CUDA and CPU decode disagree")


# ------------------------------------------------------------- 6. train --

def _events(buf):
    return [json.loads(line) for line in buf.getvalue().splitlines()
            if line.startswith("{")]


def phase_train(torch, train, kernels, routing_kernels, lsh_kernels,
                wire_kernels):
    """train.main at the full config (the bf16 wire): 3 steps with LSH on,
    2 with it off.  Returns {"on": (summary, launches), "off": (...)},
    launches counted over the run with every count set to 0 just before
    it."""
    out = {}
    for lsh, steps in (("on", 3), ("off", 2)):
        for k in kernels:
            k.launches = 0
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = train.main(TRAIN_ARGV + ["--lsh", lsh, "--steps",
                                          str(steps)])
        launches = {k.name: k.launches for k in kernels}
        if rc != 0:
            raise AssertionError(f"train.main returned {rc}")
        events = _events(buf)
        step_ev = [e for e in events if e["kind"] == "step"]
        summary = [e for e in events if e["kind"] == "train_summary"]
        for e in step_ev:
            log(f"[train] lsh {lsh} " + json.dumps(e, sort_keys=True))
        if len(step_ev) != steps or len(summary) != 1:
            raise AssertionError(f"train printed {len(step_ev)} step lines "
                                 f"and {len(summary)} summaries")
        s = summary[0]
        log(f"[train] lsh {lsh} summary " + json.dumps(s, sort_keys=True))
        log(f"[train] lsh {lsh} launches per step " + json.dumps(
            {n: c / steps for n, c in launches.items()}))
        if not all(math.isfinite(e["loss"]) and e["skips"] == 0
                   for e in step_ev):
            raise AssertionError("a training step had a non-finite loss or "
                                 "skipped")
        never = [k.name for k in routing_kernels + lsh_kernels
                 if launches[k.name] == 0]
        if lsh == "on" and never:
            raise AssertionError(f"kernels never launched with LSH on: "
                                 f"{never}")
        if lsh == "off" and any(launches[k.name] for k in lsh_kernels):
            raise AssertionError("LSH kernels launched with LSH off")
        if any(launches[k.name] for k in wire_kernels):
            raise AssertionError("wire kernels launched with the bf16 wire")
        out[lsh] = (s, launches)
    return out


def with_wire(cfg, **lsh):
    """``cfg`` with LSHConfig fields replaced (dataclasses.replace)."""
    import dataclasses
    return cfg.replace(moe=dataclasses.replace(
        cfg.moe, lsh=dataclasses.replace(cfg.moe.lsh, **lsh)))


def phase_train_wire(torch, cfg, step_lib, data_lib, kernels,
                     routing_kernels, lsh_kernels, summarize, port_names):
    """The full config, 4 x 1024 tokens, with the int8 and fp8 wires
    (LSHConfig.wire_format, by dataclasses.replace) through
    init_train_state + make_train_step: int8 with LSH on (4 steps), fp8
    with LSH on (4) and int8 with LSH off (3, the coded baseline).  Each
    run's loss is finite, each wire kernel of its setting launches
    WIRE_LAUNCHES_PER_LAYER times the MoE layers a step (32 layers: 128,
    128 and 64 with LSH on; 64, 64, 64 and 96 with it off), the routing
    (and with LSH on the LSH) kernels launch, and no other; then one more
    step under torch.profiler for its device busy ms, idle share of the
    mean step after the first, host ms in kernel launch calls and the
    port's kernels' device ms.  Returns {(fmt, lsh): (summary, launches)}."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import OptimizerConfig
    dev = torch.device("cuda")
    out = {}
    for fmt, lsh, steps in WIRE_RUNS:
        c = with_wire(cfg, wire_format=fmt)
        opt = OptimizerConfig(lr=1e-3, warmup_steps=min(20, steps // 5),
                              total_steps=steps)
        ds = data_lib.SyntheticLMDataset(c.vocab_size, 1024, 4)
        torch.cuda.reset_peak_memory_stats(dev)
        state = step_lib.init_train_state(c, opt, seed=0, device=dev)
        step_fn = step_lib.make_train_step(c, opt, use_lsh=lsh)
        for k in kernels:
            k.launches = 0
        losses, dts = [], []
        for s in range(steps):
            batch = step_lib.batch_to_device(ds.batch_at(s), dev)
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            losses.append(float(m["loss"]))       # waits for the step
            dts.append(time.perf_counter() - t0)
            if int(m["grad_skips"]):
                raise AssertionError(f"{fmt} lsh={lsh}: step {s} skipped")
        launches = {k.name: k.launches for k in kernels}
        # one more step under the profiler: device busy ms (the sum of the
        # kernels' durations), its idle share of the unprofiled steps' mean
        steady = dts[1:]
        mean_ms = sum(steady) / len(steady) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state, m = step_fn(state, step_lib.batch_to_device(
                ds.batch_at(steps), dev))
            float(m["loss"])
            torch.cuda.synchronize()
        busy, top = summarize(prof, 1, mean_ms, top=10)
        summary = dict(
            wire_format=fmt, lsh=lsh, steps=steps, batch=4, seq=1024,
            losses=losses, step_ms=[d * 1e3 for d in dts],
            mean_step_ms_after_first=mean_ms,
            tokens_per_s=4 * 1024 * len(steady) / sum(steady),
            peak_memory_bytes=torch.cuda.max_memory_allocated(dev),
            profiled_device_busy_ms=busy["device_busy_ms_per_step"],
            profiled_kernels=busy["device_kernels_per_step"],
            profiled_idle_share=busy["device_idle_share"],
            profiled_host_launch_ms=busy["host_launch_ms_per_step"],
            port_kernels_ms=_port_kernels(prof.key_averages(), port_names))
        tag = f"{fmt} lsh {'on' if lsh else 'off'}"
        log(f"[train-wire] {tag} summary " + json.dumps(summary,
                                                        sort_keys=True))
        for line in top[:10]:                   # the top ops by device time
            log(f"[train-wire] {tag} {line}")
        per_step = {n: cnt / steps for n, cnt in launches.items()}
        log(f"[train-wire] {tag} launches per step " + json.dumps(per_step))
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{tag}: a loss is not finite: {losses}")
        want = {n: 0 for n in launches}
        want.update({n: cnt * c.num_layers
                     for n, cnt in WIRE_LAUNCHES_PER_LAYER[lsh].items()})
        ran = {k.name for k in routing_kernels + (lsh_kernels if lsh
                                                  else ())}
        bad = {n: cnt for n, cnt in per_step.items()
               if (n in ran and cnt == 0)
               or (n not in ran and cnt != want[n])}
        if bad:
            raise AssertionError(f"{tag}: launches per step {bad}, want "
                                 f"{want} of the wire kernels, the routing"
                                 f"{' and LSH' if lsh else ''} kernels, and "
                                 "nothing else")
        out[(fmt, lsh)] = (summary, launches)
        del state, step_fn
        torch.cuda.empty_cache()
    return out


def port_kernel_names(build):
    """The names of the kernels defined in the port's CUDA sources."""
    decl = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                      r"(\w+)\s*\(")
    return {name for src in build.CSRC.glob("*.cu")
            for name in decl.findall(src.read_text())}


def _template_args(s):
    """The leading "<...>" of ``s``, nested brackets included."""
    depth = 0
    for i, ch in enumerate(s):
        depth += {"<": 1, ">": -1}.get(ch, 0)
        if depth == 0:
            return s[:i + 1]
    return s


def _port_kernels(avgs, names):
    """Device ms of the port's own kernels (``names``) in the averages of a
    profile of one step (``prof.key_averages()``), whether or not among
    the top ops: each kernel with a template's
    instantiations summed ("name"), and each instantiation apart
    ("name<args>": segment_centroid's bf16 ones are the forward, its f32
    ones the backward).  A profile names them
    "(anonymous namespace)::name(...)", or "void (anonymous namespace)::name<...>(...)" for a template."""
    ns = "(anonymous namespace)::"
    out = {}
    for a in avgs:
        key = a.key.removeprefix("void ")
        if not key.startswith(ns) or a.self_device_time_total <= 0:
            continue
        rest = key[len(ns):]
        name = re.split(r"[<(]", rest)[0]
        if name not in names:
            continue
        keys = [name]
        if rest[len(name):].startswith("<"):
            keys.append(name + _template_args(rest[len(name):]))
        for k in keys:
            out[k] = out.get(k, 0.0) + a.self_device_time_total / 1e3
    return out


def phase_train_profile(torch, cfg, step_lib, data_lib, summarize,
                        port_names, spy):
    """One steady-state training step under torch.profiler (LSH on), after
    two warm-up steps and a host-clock timing of two more.  The first
    warm-up step runs under ``spy`` (spy_centroid_slots): returns (the
    profile's record, that step's segment_centroid slot sets)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import OptimizerConfig
    opt = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=8)
    state = step_lib.init_train_state(cfg, opt, seed=0, device="cuda")
    step_fn = step_lib.make_train_step(cfg, opt)
    ds = data_lib.SyntheticLMDataset(cfg.vocab_size, 1024, 4)

    def run(first, n):
        nonlocal state
        for s in range(first, first + n):
            state, m = step_fn(state, step_lib.batch_to_device(
                ds.batch_at(s), torch.device("cuda")))
        float(m["loss"])
        torch.cuda.synchronize()

    with spy() as rec:
        run(0, 1)
    run(1, 1)
    t0 = time.perf_counter()
    run(2, 2)
    wall_ms = (time.perf_counter() - t0) * 1e3 / 2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(4, 1)
    record, lines = summarize(prof, 1, wall_ms, top=15)
    for line in lines:
        log(f"[train-profile] {line}")
    record["port_kernels_ms_per_step"] = _port_kernels(prof.key_averages(),
                                                       port_names)
    log("[train-profile] " + json.dumps(record, sort_keys=True))
    del state
    return record, training_slot_sets(rec, cfg.num_layers)


# ----------------------------------- 6b. the training path's own slots --

@contextlib.contextmanager
def spy_centroid_slots(dispatch, scm):
    """Record what each segment_centroid call of a training step gets, by
    caller: "forward" (the forward pass, then the checkpoint's recompute)
    and "backward" (residual_apply's transpose).  Yields {"forward":
    [(slots, x dtype, H, S), ...], "backward": [...]}, in call order."""
    rec = {"forward": [], "backward": []}
    side = ["forward"]
    orig_sc, orig_tr = scm.segment_centroid, dispatch.residual_apply_transpose

    def centroid(slots, x, num_slots):
        rec[side[0]].append((slots.clone(), x.dtype, x.shape[-1], num_slots))
        return orig_sc(slots, x, num_slots)

    def transpose(slots, ct, num_slots):
        side[0] = "backward"
        try:
            return orig_tr(slots, ct, num_slots)
        finally:
            side[0] = "forward"

    scm.segment_centroid = centroid
    dispatch.residual_apply_transpose = transpose
    try:
        yield rec
    finally:
        scm.segment_centroid = orig_sc
        dispatch.residual_apply_transpose = orig_tr


def training_slot_sets(rec, n_layers):
    """The first and the last MoE layer's slot sets of one recorded step:
    the forward pass runs the layers in order (its recompute follows), the
    backward in reverse."""
    fwd, bwd = rec["forward"], rec["backward"]
    if len(fwd) != 2 * n_layers or len(bwd) != n_layers:
        raise AssertionError(f"a training step called segment_centroid "
                             f"{len(fwd)} times forward and {len(bwd)} "
                             f"backward, want {2 * n_layers} and {n_layers}")
    return {"forward, first MoE layer": fwd[0],
            "forward, last MoE layer": fwd[n_layers - 1],
            "backward, first MoE layer": bwd[-1],
            "backward, last MoE layer": bwd[0]}


def slot_stats(torch, slots, S):
    """Per group: rows in range, the largest slot's rows and their share
    of the rows in range, occupied slots; summed, or mean and max over
    the groups."""
    in_range = (slots >= 0) & (slots < S)
    n_in = in_range.sum(1)
    counts = torch.zeros(slots.shape[0], S, dtype=torch.int64,
                         device=slots.device).scatter_add_(
        1, slots.long().clamp(0, S - 1), in_range.long())
    largest = counts.max(1).values
    share = largest.double() / n_in.clamp_min(1).double()
    return dict(groups=slots.shape[0], rows=slots.shape[1],
                rows_in_range=int(n_in.sum()),
                rows_in_range_mean=float(n_in.double().mean()),
                largest_slot_rows_mean=float(largest.double().mean()),
                largest_slot_rows_max=int(largest.max()),
                largest_slot_share_mean=float(share.mean()),
                largest_slot_share_max=float(share.max()),
                occupied_slots_mean=float((counts > 0).sum(1).double()
                                          .mean()))


def check_training_slots(torch, scm, ref, sets):
    """segment_centroid at the training path's own slots (``sets``: label
    -> (slots, x dtype, H, S) as recorded) and at the worst case, all C
    rows of every group in slot S - 1 (bf16 and f32 x): the slot
    statistics, then _centroid_record on seeded random x of that dtype
    (bf16 forward, f32 backward, as the step has them)."""
    g = torch.Generator(device="cuda").manual_seed(20)
    slots0, _, H, S = next(iter(sets.values()))
    worst = torch.full(slots0.shape, S - 1, dtype=torch.int32, device="cuda")
    cases = dict(sets)
    for dt, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        cases[f"all rows in slot S-1, {name}"] = (worst, dt, H, S)
    out = {}
    for label, (slots, dt, H, S) in cases.items():
        log(f"[kernels] training slots, {label} ({dt}): " + json.dumps(
            slot_stats(torch, slots, S), sort_keys=True))
        x = torch.randn(*slots.shape, H, generator=g, device="cuda").to(dt)
        out[label] = _centroid_record(torch, scm, ref, label,
                                      slots.contiguous(), x, S)
    _log_records("training slots", {f"segment_centroid, {k}": v
                                    for k, v in out.items()})
    return out


# ------------------------------------------------------ 7. train parity --

def phase_train_parity(torch, model_lib, step_lib, clustering, lh, kernels,
                       path_kernels, cfg_full):
    """One train step on the card (kernels) and on the CPU (plain
    versions) from the same params and batch, per wire: f32, bf16 and
    int8 (``path_kernels``: the kernels each launches on the card)."""
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.optim.adam import leaves
    # the first step of a 10-step warm-up (lr 1e-4): a first AdamW step
    # moves each param by about lr * sign(g), so a tiny gradient whose sign
    # the two devices' f32 sums disagree on moves the param by a full lr
    opt = OptimizerConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    orig_assign, orig_update = clustering.assign_slots, step_lib.adamw_update
    cpu = torch.device("cpu")
    try:
        for wire, fmt in (("float32", "bf16"), ("bfloat16", "bf16"),
                          ("bfloat16", "int8")):
            cfg = with_wire(cfg_full.replace(num_super_blocks=2,
                                             dtype="float32"),
                            wire_dtype=wire, wire_format=fmt)
            expect = {k.name for k in path_kernels[fmt]}
            params_cpu = model_lib.init_params(cfg, seed=5, device=cpu)
            batch = SyntheticLMDataset(cfg.vocab_size, 64, 2).batch_at(0)
            runs = {}
            for name, dev in (("cuda", torch.device("cuda")), ("cpu", cpu)):
                rec = {"slots": [], "inputs": [], "grads": None}

                def spy(tokens, rotations, num_slots, hash_type, rec=rec):
                    out = orig_assign(tokens, rotations, num_slots,
                                      hash_type)
                    rec["slots"].append(out.cpu())
                    rec["inputs"].append(
                        (tokens.detach().reshape(-1, tokens.shape[-1])
                         .float().cpu(), rotations.detach().float().cpu()))
                    return out

                def update(params, grads, *a, rec=rec, **k):
                    rec["grads"] = [None if g is None else g.detach().cpu()
                                    for g in grads]
                    return orig_update(params, grads, *a, **k)

                clustering.assign_slots = spy
                step_lib.adamw_update = update
                params = (tree_to(params_cpu, dev) if dev.type == "cuda"
                          else params_cpu)
                state = step_lib.TrainState(
                    params, step_lib.adamw_init(params, opt))
                before = [k.launches for k in kernels]
                state, m = step_lib.make_train_step(cfg, opt)(
                    state, step_lib.batch_to_device(batch, dev))
                ran = {k.name: k.launches - b
                       for k, b in zip(kernels, before)}
                if {n for n, c in ran.items() if c} != (
                        expect if dev.type == "cuda" else set()):
                    raise AssertionError(f"{name} run launched {ran}")
                rec["loss"] = float(m["loss"])
                rec["params"] = [p.detach().cpu()
                                 for p in leaves(state.params)]
                runs[name] = rec
            a, b = runs["cuda"], runs["cpu"]
            n_moe = cfg.num_layers
            n_diff = [int((x != y).sum()) for x, y in zip(a["slots"],
                                                          b["slots"])]
            margin = min(float(lh.near_tie_margin(x, r).min())
                         for x, r in b["inputs"][:n_moe])    # forward

            def rel(u, v):
                return float((u.double() - v.double()).norm()
                             / v.double().norm().clamp_min(1e-30))

            loss_rel = abs(a["loss"] - b["loss"]) / abs(b["loss"])
            g_rel = max(rel(x, y) for x, y in zip(a["grads"], b["grads"])
                        if y is not None and y.any())
            p_rel = max(rel(x, y) for x, y in zip(a["params"], b["params"])
                        if y.is_floating_point())
            log(f"[train-parity] wire {fmt} ({wire}): slot ids differing "
                "per record "
                f"(forward of {n_moe} MoE layers, then their recompute) "
                f"{n_diff}; smallest near-tie margin of the forward hashes "
                f"{margin:.3g}; loss cuda {a['loss']} cpu {b['loss']} "
                f"(rel {loss_rel:.3g}); worst gradient rel L2 {g_rel:.3g}; "
                f"worst param-after-AdamW rel L2 {p_rel:.3g}; TF32 off")
            if wire == "float32":
                # every layer's slots, and the stated tolerances
                ok = (not any(n_diff) and loss_rel <= LOSS_RTOL
                      and g_rel <= GRAD_RTOL and p_rel <= PARAM_RTOL)
            else:
                # The bf16 wire rounds the centroids and the cotangents:
                # where the two devices' f32 sums differ in the last bit,
                # a value next to a bf16 boundary rounds the other way, so
                # the next layer's hash input moves by a bf16 step and a
                # token near a hash tie may change slot.  Only the first
                # layer's input is free of it.  The int8 wire sends the
                # same bf16 cotangents and rounds the centroids and
                # expert outputs to a quantum of their row's absmax / 127,
                # so it is held to the same bound.
                ok = n_diff[0] == 0 and loss_rel <= BF16_WIRE_LOSS_RTOL
            if not ok:
                raise AssertionError(f"wire {fmt} ({wire}): CUDA and CPU "
                                     "train steps disagree")
    finally:
        clustering.assign_slots = orig_assign
        step_lib.adamw_update = orig_update


# --------------------------------------------------------------- 8. mesh --

NCCL_REPS = 10
# the wire leaves of the training shape (R = 1 rank): the bf16 wire's
# centroids, the int8 / fp8 payloads with their f32 scales, and the
# coded baseline's (int8, LSH off) payload and scales
NCCL_LEAVES = (("bf16", (1, 40, 208, 1536)), ("int8", (1, 40, 208, 1536)),
               ("fp8", (1, 40, 208, 1536)), ("f32 scales", (1, 40, 208)),
               ("coded int8", (1, 40, 1024, 1536)),
               ("coded scales", (1, 40, 1024)))
MESH_STEPS = 2


def _leaf(torch, name, shape, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, generator=gen, device="cuda")
    if name == "bf16":
        return x.to(torch.bfloat16)
    if name.endswith("int8"):
        return (x * 40).round().clamp(-127, 127).to(torch.int8)
    if name == "fp8":
        return x.to(torch.float8_e4m3fn)
    return torch.exp2(torch.round(x * 4))          # po2 f32 scales


def _same_bits(torch, a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def _nccl_kernels(avgs):
    """Device ms of NCCL's work in a profile's averages, by name (the
    NCCL ops, "nccl:...", and any "ncclDevKernel" kernel)."""
    out = {}
    for a in avgs:
        if "nccl" in a.key.lower() and a.self_device_time_total > 0:
            out[a.key] = out.get(a.key, 0.0) + a.self_device_time_total / 1e3
    return out


def phase_nccl(torch, collectives, summarize):
    """One NCCL rank (a HashStore, no network): the collectives' raw calls
    (the classes, which skip no call for a group of one rank) on the
    training shape's wire leaves.  Each forward and backward must give
    the input's bits; each forward is timed beside the bytes it moves; a
    profile of one pass lists NCCL's kernels.  Returns the records."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from types import SimpleNamespace

    from repro_torch.launch.mesh import init_distributed
    init_distributed(torch.device("cuda", 0), store=dist.HashStore(),
                     rank=0, world_size=1)
    log(f"[nccl] backend {dist.get_backend()}, NCCL "
        f"{'.'.join(map(str, torch.cuda.nccl.version()))}, world "
        f"{dist.get_world_size()}")
    world = dist.group.WORLD
    ops = {"all_to_all": (collectives.AllToAll, {}),
           "all_gather": (collectives.AllGather, {"axis": 1}),
           "reduce_scatter": (collectives.ReduceScatter, {"axis": 1})}
    records = []
    for i, (name, shape) in enumerate(NCCL_LEAVES):
        x = _leaf(torch, name, shape, 2 * i)
        ct = _leaf(torch, name, shape, 2 * i + 1)
        for op, (cls, kw) in ops.items():
            args = (world,) + tuple(kw.values())
            if x.dtype in (torch.int8,):
                y = cls.apply(x, *args)
                dx = cls.backward(SimpleNamespace(group=world, **kw), ct)[0]
            else:
                xg = x.clone().requires_grad_(True)
                y = cls.apply(xg, *args)
                (dx,) = torch.autograd.grad(y, xg, grad_outputs=ct)
            if not (_same_bits(torch, y, x) and _same_bits(torch, dx, ct)):
                raise AssertionError(f"NCCL {op} of the {name} leaf "
                                     f"{tuple(shape)}: the bits moved")
            ms = time_ms(torch, lambda: cls.apply(x, *args), reps=NCCL_REPS)
            nbytes = x.numel() * x.element_size()
            records.append({"leaf": name, "shape": list(shape), "op": op,
                            "bytes": nbytes, "ms": ms,
                            "GB_per_s": nbytes / ms / 1e6})
            log(f"[nccl] {op} {name} {tuple(shape)} {x.dtype}: forward and "
                f"backward bitwise; {ms:.6f} ms for {nbytes} bytes")
    # the gradient all-reduce: one bucket of f32 gradients
    bucket = _leaf(torch, "f32", (collectives.BUCKET_BYTES // 4,), 99)
    got = collectives.raw_all_reduce_sum(bucket, world)
    if not _same_bits(torch, got, bucket):
        raise AssertionError("NCCL all_reduce of one rank changed the bits")
    ms = time_ms(torch, lambda: collectives.raw_all_reduce_sum(bucket, world),
                 reps=NCCL_REPS)
    records.append({"leaf": "f32 gradient bucket", "op": "all_reduce",
                    "shape": list(bucket.shape), "bytes": bucket.numel() * 4,
                    "ms": ms, "GB_per_s": bucket.numel() * 4 / ms / 1e6})
    log(f"[nccl] all_reduce f32 bucket {tuple(bucket.shape)}: bitwise; "
        f"{ms:.6f} ms for {bucket.numel() * 4} bytes")
    x = _leaf(torch, "bf16", NCCL_LEAVES[0][1], 0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for cls, kw in ops.values():
            cls.apply(x, world, *kw.values())
        collectives.raw_all_reduce_sum(bucket, world)
        torch.cuda.synchronize()
    _, lines = summarize(prof, 1, 1.0, top=6)
    for line in lines[:6]:                  # the top device ops of the pass
        log(f"[nccl] one pass {line}")
    log("[nccl] NCCL's ops in the pass (device ms): "
        + json.dumps(_nccl_kernels(prof.key_averages()), sort_keys=True))
    log("[nccl] " + json.dumps(records))
    return records


def _digest(torch, params):
    """Per leaf: the sum of its words and their position-weighted sum, as
    int64 (exact in any order), so equal digests mean equal bits with
    overwhelming odds."""
    from repro_torch.optim.adam import leaves
    out = []
    for p in leaves(params):
        w = p.detach().contiguous().view(-1)
        w = w.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[
            w.element_size()]).to(torch.int64)
        pos = torch.arange(w.numel(), device=w.device) % 65521 + 1
        out.append((int(w.sum()), int((w * pos).sum())))
    return out


def phase_mesh(torch, cfg, step_lib, data_lib, summarize, port_names,
               kernels, path_kernels):
    """The full config, 4 x 1024 tokens, through the mesh path on a (1, 1)
    mesh of the NCCL rank and through the mesh-free path, from the same
    seed: bf16 wire and int8 wire, LSH on, MESH_STEPS steps each.  The
    losses, the clip norms and every param leaf after the last step must
    be bit-equal (the collectives of a group of one rank make no call).
    Then one more step of each under the profiler: device busy ms,
    launches, the port's kernels and NCCL's.  Returns the summaries."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.launch.mesh import make_mesh
    dev = torch.device("cuda")
    mesh = make_mesh(1, 1)
    opt = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=8)
    ds = data_lib.SyntheticLMDataset(cfg.vocab_size, 1024, 4)
    out = {}
    for fmt in ("bf16", "int8"):
        c = with_wire(cfg, wire_format=fmt)
        runs = {}
        for tag, m in (("mesh-free", None), ("mesh (1, 1)", mesh)):
            t_run = time.time()
            state = step_lib.init_train_state(c, opt, seed=0, device=dev,
                                              mesh=m)
            step_fn = step_lib.make_train_step(c, opt, use_lsh=True, mesh=m)
            for k in kernels:
                k.launches = 0
            losses, norms, dts = [], [], []
            for s in range(MESH_STEPS):
                batch = step_lib.batch_to_device(ds.batch_at(s), dev)
                t0 = time.perf_counter()
                state, met = step_fn(state, batch)
                losses.append(met["loss"].item())
                norms.append(met["grad_norm"].item())
                dts.append((time.perf_counter() - t0) * 1e3)
            launches = {k.name: k.launches for k in kernels}
            digest = _digest(torch, state.params)
            # device activity only: kernels and their times, at a fraction
            # of the trace's cost with the host's ops
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                state, met = step_fn(state, step_lib.batch_to_device(
                    ds.batch_at(MESH_STEPS), dev))
                met["loss"].item()
                torch.cuda.synchronize()
            busy, _ = summarize(prof, 1, dts[-1], top=0)
            avgs = prof.key_averages()
            rec = dict(losses=losses, grad_norms=norms, step_ms=dts,
                       profiled_device_busy_ms=busy["device_busy_ms_per_step"],
                       profiled_kernels=busy["device_kernels_per_step"],
                       port_kernels_ms=_port_kernels(avgs, port_names),
                       nccl_kernels_ms=_nccl_kernels(avgs),
                       launches_per_step={n: v / MESH_STEPS
                                          for n, v in launches.items()})
            log(f"[mesh] {fmt} wire, LSH on, {tag} ({time.time() - t_run:.1f}"
                " s): " + json.dumps(rec, sort_keys=True))
            never = [k.name for k in path_kernels[fmt]
                     if launches[k.name] == 0]
            if never:
                raise AssertionError(f"{fmt} {tag}: kernels never launched "
                                     f"{never}")
            if not all(math.isfinite(v) for v in losses + norms):
                raise AssertionError(f"{fmt} {tag}: not finite {losses} "
                                     f"{norms}")
            runs[tag] = (rec, digest)
            del state, step_fn, prof
            torch.cuda.empty_cache()
        (a, da), (b, db) = runs["mesh-free"], runs["mesh (1, 1)"]
        same = (a["losses"] == b["losses"] and a["grad_norms"]
                == b["grad_norms"] and da == db)
        log(f"[mesh] {fmt} wire: mesh (1, 1) against mesh-free after "
            f"{MESH_STEPS} steps: losses, clip norms and all {len(da)} "
            f"param leaves {'bit-equal' if same else 'DIFFER'}; device "
            f"busy {b['profiled_device_busy_ms']:.3f} against "
            f"{a['profiled_device_busy_ms']:.3f} ms, launches "
            f"{b['profiled_kernels']} against {a['profiled_kernels']}")
        if not same:
            raise AssertionError(f"{fmt} wire: the mesh (1, 1) path is not "
                                 "bit-equal to the mesh-free path")
        out[fmt] = runs
    return out


# --------------------------------------------------------------- 10. comm --

COMM_CHUNKS = (2, 4)
# The pipelined layer against the flat one (bf16 model, one rank): the
# chunked expert MLP is the same product on fewer rows, which cuBLAS may
# round otherwise, and autograd sums each weight's chunk gradients in
# bf16.  So y within 2 bf16 steps of its largest magnitude, and each
# gradient within 2^-7 relative L2 (a few bf16 roundings of a sum).
COMM_Y_STEPS = 2 ** -7
COMM_GRAD_RTOL = 2 ** -7
COMM_DIFF = ("router_w", "w_gate", "w_up", "w_down")


def _chunked_raw(torch, collectives, x, group, chunks):
    """The chunked all-to-all as raw calls: every chunk of axis 2 issued
    asynchronously, then each waited."""
    parts = [c.contiguous() for c in x.split(x.shape[2] // chunks, 2)]
    pending = [collectives.raw_all_to_all_async(c, group) for c in parts]
    return torch.cat([p.wait() for p in pending], dim=2)


def comm_chunked_calls(torch, collectives):
    """Item 1: the asynchronous chunked all-to-all on the NCCL rank's
    group, on the nccl phase's wire leaves: bitwise the unchunked call,
    both timed (median of NCCL_REPS)."""
    import torch.distributed as dist
    world = dist.group.WORLD
    records = []
    for i, (name, shape) in enumerate(NCCL_LEAVES):
        x = _leaf(torch, name, shape, 2 * i)
        whole = collectives.raw_all_to_all(x, world)
        ms = {1: time_ms(torch, lambda: collectives.raw_all_to_all(x, world),
                         reps=NCCL_REPS)}
        for k in COMM_CHUNKS:
            got = _chunked_raw(torch, collectives, x, world, k)
            if not _same_bits(torch, got, whole):
                raise AssertionError(f"chunked ({k}) all-to-all of the "
                                     f"{name} leaf: the bits differ")
            ms[k] = time_ms(torch, lambda k=k: _chunked_raw(
                torch, collectives, x, world, k), reps=NCCL_REPS)
        records.append({"leaf": name, "shape": list(shape), "ms": ms})
        log(f"[comm] chunked all-to-all {name} {tuple(shape)}: chunks "
            f"{list(COMM_CHUNKS)} bitwise the unchunked call; ms by chunks "
            + json.dumps(ms))
    return records


@contextlib.contextmanager
def _planned(planner, plan, sends):
    """Every plan_collectives call returns ``plan``; every pipelined
    exchange's send tensor is kept in ``sends``."""
    orig_plan, orig_exchange = planner.plan_collectives, \
        planner.pipelined_moe_exchange

    def exchange(send, *a, **kw):
        sends.append(send.detach())
        return orig_exchange(send, *a, **kw)
    if plan is not None:
        planner.plan_collectives = lambda *a, **kw: plan
    planner.pipelined_moe_exchange = exchange
    try:
        yield
    finally:
        planner.plan_collectives = orig_plan
        planner.pipelined_moe_exchange = orig_exchange


def _rel_l2(torch, a, b):
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / max(float(torch.linalg.vector_norm(b)), 1e-30))


def comm_codec_chunks(torch, wire_lib, send):
    """Each chunk's encode (wire_quantize) and decode (wire_dequantize)
    bitwise the slice of the whole tensor's, int8 and fp8."""
    for fmt in WIRE_FORMATS:
        codec = wire_lib.make_codec(fmt, wire_dtype=send.dtype,
                                    compute_dtype=send.dtype)
        q, sc = codec.encode(send)
        dq = codec.decode((q, sc))
        for k in COMM_CHUNKS:
            n = send.shape[2] // k
            for j in range(k):
                sl = slice(j * n, (j + 1) * n)
                qc, scc = codec.encode(send[:, :, sl].contiguous())
                dqc = codec.decode((q[:, :, sl].contiguous(),
                                    sc[:, :, sl].contiguous()))
                if not (_same_bits(torch, qc, q[:, :, sl])
                        and _same_bits(torch, scc, sc[:, :, sl])
                        and _same_bits(torch, dqc, dq[:, :, sl])):
                    raise AssertionError(f"{fmt} chunk {j} of {k}: encode or "
                                         "decode is not the slice of the "
                                         "whole")
        log(f"[comm] {fmt} codec of the send {tuple(send.shape)} "
            f"{send.dtype}: each chunk's encode (payload, scales) and decode "
            f"bitwise the slice of the whole, chunks {list(COMM_CHUNKS)}")


def comm_pipelined_layer(torch, cfg, moe_lib, planner, wire_lib, topo_lib,
                         lsh_moe, mesh, kernels, summarize, port_names):
    """Item 2: one full-config MoE layer (4 x 1024 tokens, LSH on) forward
    and backward through pipelined plans of 2 and 4 chunks over the
    one-rank group, against the flat plan, bf16 and int8 wires; the
    codec's chunks against the whole; one profiled pass of each plan."""
    from torch.profiler import ProfilerActivity, profile
    dev = torch.device("cuda")
    H = cfg.d_model
    gen = torch.Generator(device=dev).manual_seed(5)
    x0 = torch.randn((4, 1024, H), generator=gen, device=dev).to(
        torch.bfloat16)
    ct = torch.randn((4, 1024, H), generator=gen, device=dev)
    out = {}
    for fmt in ("bf16", "int8"):
        c = with_wire(cfg, wire_format=fmt)
        params = lsh_moe.lsh_moe_init(gen, H, c.moe, mlp_act=c.mlp_act,
                                      dtype=torch.bfloat16, device=dev,
                                      mesh=mesh)
        plans = {"flat": None}
        plans.update({f"pipelined{k}": planner.CommPlan(
            planner.PIPELINED, "model", intra=1, chunks=k,
            reason=f"{k} chunks over the one-rank group",
            topology=topo_lib.build_topology(mesh), mesh=mesh)
            for k in COMM_CHUNKS})

        def run(plan, sends):
            p = {k: (v.detach().clone().requires_grad_(True)
                     if k in COMM_DIFF else v) for k, v in params.items()}
            x = x0.clone().requires_grad_(True)
            with _planned(planner, plan, sends):
                y, st = moe_lib.moe_expert_parallel(
                    x, p, c.moe, mlp_act=c.mlp_act, use_lsh=True, mesh=mesh)
                obj = (y.float() * ct).sum() + st["aux_loss"] + st["z_loss"]
                grads = torch.autograd.grad(obj, [x] + [p[k]
                                                        for k in COMM_DIFF])
            return y.detach(), grads

        res = {}
        for tag, plan in plans.items():
            sends = []
            y, grads = run(plan, sends)
            if plan is None and planner.last_plan("model").algorithm \
                    != planner.FLAT:
                raise AssertionError(f"{fmt}: the one-rank plan is "
                                     f"{planner.last_plan('model')}")
            if plan is not None and len(sends) != 1:
                raise AssertionError(f"{fmt} {tag}: the pipelined exchange "
                                     f"ran {len(sends)} times")
            for k in kernels:
                k.launches = 0
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                run(plan, [])
                torch.cuda.synchronize()
            busy, _ = summarize(prof, 1, 1.0, top=0)
            launches = {k.name: k.launches for k in kernels if k.launches}
            res[tag] = (y, grads, sends)
            out[(fmt, tag)] = {
                "device_busy_ms": busy["device_busy_ms_per_step"],
                "device_kernels": busy["device_kernels_per_step"],
                "launches": launches,
                "port_kernels_ms": _port_kernels(prof.key_averages(),
                                                 port_names)}
            log(f"[comm] layer {fmt} wire {tag}: fwd+bwd profile "
                + json.dumps(out[(fmt, tag)], sort_keys=True))
        y_f, g_f, _ = res["flat"]
        scale = float(y_f.float().abs().max())
        for tag in plans:
            if tag == "flat":
                continue
            y, grads, sends = res[tag]
            dy = float((y.float() - y_f.float()).abs().max())
            rel = {name: _rel_l2(torch, g, gf) for name, g, gf in
                   zip(("x",) + COMM_DIFF, grads, g_f)}
            same = torch.equal(y, y_f)
            bits = {name: torch.equal(g, gf) for name, g, gf in
                    zip(("x",) + COMM_DIFF, grads, g_f)}
            log(f"[comm] layer {fmt} wire {tag} against flat: y "
                f"{'bitwise' if same else f'max |diff| {dy:.6g}'} (bound "
                f"{COMM_Y_STEPS * scale:.6g} = 2^-7 x max |y| {scale:.6g}); "
                f"gradients bitwise {json.dumps(bits, sort_keys=True)}, "
                f"rel L2 {json.dumps(rel, sort_keys=True)} (bound "
                f"{COMM_GRAD_RTOL})")
            if dy > COMM_Y_STEPS * scale or max(rel.values()) > \
                    COMM_GRAD_RTOL:
                raise AssertionError(f"{fmt} {tag}: pipelined layer outside "
                                     "its bound against flat")
        comm_codec_chunks(torch, wire_lib, res["pipelined2"][2][0])
        del params, res
        torch.cuda.empty_cache()
    return out


def comm_probe_rows(torch, cfg, mesh):
    """Item 3: the tune probe suite's kernel rows at the reference's probe
    size and at the training shape; autotune on the one-rank axis stores
    no cache entry."""
    import os
    import tempfile

    from repro_torch.tune import cache
    from repro_torch.tune.autotune import autotune
    from repro_torch.tune.probe import probe_kernels
    dev = torch.device("cuda")
    rows = probe_kernels(sizes=((8, 256, 128),), device=dev)
    rows += probe_kernels(sizes=((40, 1024, cfg.d_model),),
                          num_hashes=cfg.moe.lsh.num_hashes, num_slots=208,
                          device=dev)
    for r in rows:
        log(f"[comm] probe row {r.kind} {r.name} {r.wire_format} "
            f"{r.msg_bytes} B: {r.seconds * 1e3:.6f} ms")
    prev = os.environ.get(cache.ENV_CACHE)
    with tempfile.TemporaryDirectory() as d:
        os.environ[cache.ENV_CACHE] = d
        try:
            choices = autotune(mesh, ladder=(1 << 16,),
                               wire_formats=("bf16", "int8"), warmup=1,
                               iters=3, device=dev)
        finally:
            if prev is None:
                os.environ.pop(cache.ENV_CACHE)
            else:
                os.environ[cache.ENV_CACHE] = prev
        if choices.cache_path or os.listdir(d):
            raise AssertionError("autotune stored an entry on a one-rank "
                                 "axis")
    log(f"[comm] autotune on the one-rank axis: {choices.n_rows} rows, all "
        "kernel rows, no cache entry written")
    return rows


def comm_degrade(torch, cfg, step_lib, data_lib, planner, mesh, flat_loss):
    """Item 4: a full-config train step with a2a_impl="pipelined",
    overlap_chunks=2 on mesh (1, 1) degrades to flat with the reference's
    reason, and its loss is bit-equal to the flat mesh step's."""
    import dataclasses
    import logging

    from repro_torch.configs.base import CommConfig, OptimizerConfig
    dev = torch.device("cuda")
    c = with_wire(cfg, wire_format="bf16")
    c = c.replace(moe=dataclasses.replace(c.moe, comm=CommConfig(
        a2a_impl="pipelined", overlap_chunks=2)))
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())
    handler = Keep(level=logging.WARNING)
    logging.getLogger(planner.__name__).addHandler(handler)
    try:
        opt = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=8)
        state = step_lib.init_train_state(c, opt, seed=0, device=dev,
                                          mesh=mesh)
        step_fn = step_lib.make_train_step(c, opt, use_lsh=True, mesh=mesh)
        ds = data_lib.SyntheticLMDataset(c.vocab_size, 1024, 4)
        _, met = step_fn(state, step_lib.batch_to_device(ds.batch_at(0),
                                                         dev))
        loss = met["loss"].item()
    finally:
        logging.getLogger(planner.__name__).removeHandler(handler)
    reason = planner.last_plan("model").reason
    want = "degraded: axis 'model' has size 1"
    log(f"[comm] pipelined config on mesh (1, 1): plan "
        f"{planner.last_plan('model').algorithm} ({reason}); logged "
        f"{sorted(set(records))}; loss {loss!r} against the flat step's "
        f"{flat_loss!r}")
    if reason != want or not any(want in r for r in records):
        raise AssertionError(f"the degrade was not logged: {reason!r}")
    if loss != flat_loss:
        raise AssertionError("the degraded step's loss differs from the "
                             "flat step's")
    del state, step_fn
    torch.cuda.empty_cache()


def phase_comm(torch, cfg, collectives, moe_lib, step_lib, data_lib,
               summarize, port_names, kernels, flat_loss):
    """The rest of comm/ on the NCCL rank: chunked calls, the pipelined
    layer, the probe rows, the degrade."""
    from repro_torch.comm import planner, topology
    from repro_torch.comm import wire as wire_lib
    from repro_torch.core import lsh_moe
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(1, 1)
    t0 = time.time()
    calls = comm_chunked_calls(torch, collectives)
    layer = comm_pipelined_layer(torch, cfg, moe_lib, planner, wire_lib,
                                 topology, lsh_moe, mesh, kernels, summarize,
                                 port_names)
    rows = comm_probe_rows(torch, cfg, mesh)
    comm_degrade(torch, cfg, step_lib, data_lib, planner, mesh, flat_loss)
    log(f"[comm] done in {time.time() - t0:.1f} s")
    return calls, layer, rows


# -------------------------------------------------------------- main --

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    import torch.distributed
    from repro_torch.comm import collectives
    from repro_torch.configs.registry import get_config
    from repro_torch.core import clustering, hashing
    from repro_torch.core import moe as moe_lib
    from repro_torch.data import synthetic
    from repro_torch.kernels import (build, dispatch, fused_wire, lsh_hash,
                                     ref, residual_apply, scatter_gather,
                                     segment_centroid, token_position,
                                     wire_quant)
    from repro_torch.launch import serve, train
    from repro_torch.launch.profiling import summarize
    from repro_torch.models import model as model_lib
    from repro_torch.runtime import step as step_lib

    t_start = time.time()
    kernels = list(dispatch.KERNELS)
    smi = phase_device(torch)
    # every comparison with a plain version runs in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[device] TF32 off (torch.backends.cuda.matmul.allow_tf32 = "
        "torch.backends.cudnn.allow_tf32 = False)")
    phase_build(build, kernels)
    fused_lsh = (wire_quant.QUANTIZE, wire_quant.DEQUANTIZE,
                 fused_wire.DEQUANTIZE_RESIDUAL)
    routing_k, lsh_k = dispatch.ROUTING_KERNELS, dispatch.LSH_KERNELS
    path_k = {"bf16": routing_k + lsh_k,
              "int8": routing_k + lsh_k + fused_lsh}
    mods = dict(token_position=token_position, scatter_gather=scatter_gather,
                lsh_hash=lsh_hash, segment_centroid=segment_centroid,
                residual_apply=residual_apply, dispatch=dispatch,
                wire_quant=wire_quant, fused_wire=fused_wire, build=build)
    res = phase_kernels(torch, mods, ref, moe_lib, hashing)
    log(f"[time] kernels done at {time.time() - t_start:.1f} s")
    cfg = get_config(ARCH)
    _, serve_launches = phase_serve(serve, kernels, routing_k, cfg)
    phase_parity(torch, model_lib, kernels, routing_k, cfg)
    log(f"[time] serve and decode parity done at "
        f"{time.time() - t_start:.1f} s")
    trained = phase_train(torch, train, kernels, routing_k, lsh_k,
                          dispatch.WIRE_KERNELS)
    torch.cuda.empty_cache()
    port_names = port_kernel_names(build)
    _, slot_sets = phase_train_profile(
        torch, cfg, step_lib, synthetic, summarize, port_names,
        lambda: spy_centroid_slots(dispatch, segment_centroid))
    torch.cuda.empty_cache()
    log(f"[time] training done at {time.time() - t_start:.1f} s")
    check_training_slots(torch, segment_centroid, ref, slot_sets)
    del slot_sets
    log(f"[time] training-slot kernels done at "
        f"{time.time() - t_start:.1f} s")
    wired = phase_train_wire(torch, cfg, step_lib, synthetic, kernels,
                             routing_k, lsh_k, summarize, port_names)
    log(f"[time] quantized training done at {time.time() - t_start:.1f} s")
    phase_train_parity(torch, model_lib, step_lib, clustering, lsh_hash,
                       kernels, path_k, cfg)
    log(f"[time] train parity done at {time.time() - t_start:.1f} s")
    phase_nccl(torch, collectives, summarize)
    meshed = phase_mesh(torch, cfg, step_lib, synthetic, summarize,
                        port_names, kernels, path_k)
    log(f"[time] mesh done at {time.time() - t_start:.1f} s")
    phase_comm(torch, cfg, collectives, moe_lib, step_lib, synthetic,
               summarize, port_names, kernels,
               meshed["bf16"]["mesh (1, 1)"][0]["losses"][0])
    torch.distributed.destroy_process_group()
    log(f"[time] comm done at {time.time() - t_start:.1f} s")

    # launches of the main path's runs: the bf16 wire with LSH on for the
    # routing and LSH kernels, the int8 wire with LSH on for the kernels
    # of its fused path, and with LSH off for the fused routing kernels
    launches = dict(trained["on"][1])
    launches.update({k.name: wired[("int8", True)][1][k.name]
                     for k in fused_lsh})
    launches.update({k.name: wired[("int8", False)][1][k.name]
                     for k in (fused_wire.SCATTER_QUANTIZE,
                               fused_wire.DEQUANTIZE_GATHER)})
    record = {"kernels": [
        {"name": k.name, "route": "cuda", "source": build.source_path(k),
         "replaces": k.replaces, "launches": launches[k.name],
         **{key: res[k.name][key] for key in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")}}
        for k in kernels]}
    log(f"[done] {time.time() - t_start:.1f} s; card {smi}; serve launches "
        f"{serve_launches}")
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
