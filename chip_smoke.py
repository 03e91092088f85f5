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
              terms' magnitudes.  combine_gather also swept over the
              shape classes its launcher separates (granite's and
              jamba's decode shapes, F = resident warps - 1 and F =
              resident warps at H = 1536, whose rows it splits in two
              and in one, and the training shape): bitwise, dropped
              entries +0.0, timed beside buf[ids, pos] * w and the
              bound, with the launcher's plan.  LSH kernels at the
              training shape (T=40960 hashed rows, L=6, Dr=64; G=40,
              C=1024, S=208) and a ragged small shape with out-of-range
              slots: lsh_hash equal
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
              Each kernel's host microseconds a call at the training
              shape, through its registered op (kernels/build.register_op)
              and its CUDA implementation called directly, and
              dispatch_scatter's through a torch.library.custom_op too.
  3b. dryrun  launch/dryrun.py's count (meta tensors) of granite-moe-3b-a800m
              at the phase-train size (4 x 1024, bf16 wire, LSH on, one
              rank), then one measured step of the same on the card:
              each kernel's launches equal the count of its op, the
              state and batch's allocations asked the caching allocator
              for the counted arg bytes exactly (their requested sizes
              in torch.cuda.memory_snapshot(), rounded to its 512-byte
              blocks; the blocks it gave sum to their memory_allocated()),
              arg_bytes + temp_bytes within 10% of the step's
              max_memory_allocated(); and the full-size train_4k cell on
              the 16 x 16 mesh traced by a process of its own (started
              at the script's start, no card), its roofline line
              printed.
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
              and NCCL's (none: a group of one rank makes no call); the
              param bytes a rank.  The mesh path places every leaf by its
              spec (runtime/params.py) and runs the FSDP / TP helpers and
              the vocabulary split at data = model = 1.
 9b. placement  on that rank: granite-8b at full width and 4 super-blocks
              (bf16, f32 AdamW moments), 2 steps at 4 x 1024 through the
              mesh path on a (1, 1) mesh (every leaf placed by its spec,
              attention and the dense FFN through runtime/tp.py, the
              vocabulary-split embedding, head and loss) and through the
              mesh-free path from the same seed: losses, clip norms and
              every param leaf bit-equal; step ms and peak memory of each.
              Then, from the specs on meta tensors, the param bytes a
              rank of granite-8b, nemotron-4-15b and internvl2-26b at
              (2, 2) and (1, 4).
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
 11. resilience  (a) the config cut to 2 super-blocks at full width,
              bf16, LSH on, 4 x 1024 tokens: 4 steps with
              CheckpointManager saving after step 2, then a state of
              another seed restored from it and steps 3-4 again: losses
              and every param and moment bit-equal, the restored steps
              launching every kernel of the path; bytes on disk, host copy
              ms, save thread ms, restore ms and the step times beside the
              save printed.  (b) launch/train.py on the smoke config on
              the card, in subprocesses: an uninterrupted run, SIGKILL at
              step 3 under --auto-restart, and ckpt_flip@1,
              ckpt_truncate@2, sigkill@3 (two steps quarantined): per-step
              losses bit-equal to the uninterrupted run's (the first in
              this process, the other two at once).  (c) microbatch
              2 at 4 x 64 tokens, 2 layers, f32 with the f32 wire, the
              card's step against the CPU's within the train-parity f32
              bounds; one full-depth bf16 step pair at 4 x 1024 with
              microbatch 2, step ms and peak memory beside phase train's
              whole-batch peak.  (d) prefill at 2 layers f32, f32 wire:
              last logits within 1e-3 of the CPU's, equal greedy tokens,
              every kernel of the path launched; the full depth's prefill
              of 8 x 1024 tokens timed.  Checkpoints go to a directory of the
              checkout that is removed afterwards.
 12. obs    (a) launch/train.py in this process at the full config, LSH
              on, 4 x 1024 tokens, 4 steps with --profile 2 --metrics-dir
              (bf16 wire), then 3 steps with --profile 1 (int8 wire, the
              config's wire_format replaced): each phase's measured device
              ms, launches and share a step beside the modeled share;
              every MoE phase measured above zero (with the bf16 wire on
              one card the exchange is the identity, so its two phases
              need only their ranges); the phases, other included, sum
              to the trace's own kernel time within 0.5%; no launch of a
              port kernel attributed to other.  (b) The full config, bf16
              wire, obs off and on from one seed: 4 steps and one
              profiled as phase train's profile is: losses and every
              param bit-equal, obs off's kernels a step equal to the
              training profile's (measured up to three more times while
              they differ, the differing events printed: a profile can
              miss or gain some at its edges),
              and obs on's surplus printed.  (c)
              obs_compression_rate equal to the host's wire / raw bytes
              (f32), and at 2 layers in f32 with the f32 wire the load
              imbalance, drop fraction and slot occupancy of a step on the
              card within 1e-6 of the CPU's.  (d) serve.py --bench-json
              at the full config: a row validate_row accepts; its tokens/s
              and p50 / p99 printed.  Files go to a directory of the
              checkout that is removed afterwards.
 13. pipeline  qwen3-moe-30b-a3b at full width (d_model 2048, 32 heads of
              128 with 4 KV heads, 128 experts top-8 of ffn 768, vocab
              151936, bf16), depth cut to 4 of its 48 super-blocks for
              memory.  The path's kernels at its shapes (one microbatch
              of 2 x 512 tokens: F = 8192 entries, E = 128, H = 2048, the
              LSH kernels at its slots, the backwards, the int8 wire
              kernels) against their plain versions as phase kernels
              holds them; then the 1F1B step with 4 stages
              (runtime/pipeline_schedule.py, one card: the stages are
              replicated over pipe) against the accumulation over 4
              microbatches (make_train_step(microbatch=2)), batch 8 x 512,
              2 steps each from one seed, LSH on, bf16 then int8 wire:
              losses, clip norms and every param after the last step
              bit-equal, each run launching every kernel of its path the
              same number of times; the schedule, step ms, peak memory
              and launches a step printed, and a kernels line of all
              eleven at this shape.
 14. hybrid  jamba-1.5-large-398b at full width (d_model 8192, Mamba-2
              d_inner 16384 in 256 heads of 64, d_state 64, chunk 256;
              64 attention heads with 8 KV heads; 16 experts top-2 of
              ffn 24576; vocab 65536; bf16, seeded random weights), depth
              cut from 72 layers to layout entries 4-5 (one Mamba + MoE
              block, one attention + dense block, 11.9 G params, 23.8 GB;
              one super-block is 90.3 GB).  The path's kernels at its
              shapes (2 x 2048 tokens: F = 8192, E = 16, C = 640, S =
              128, H = 8192; the backwards; and the decode step's F = 8,
              C = 4) against their plain versions as phase kernels holds
              them; prefill of 4 x 2048 tokens (finite last logits, every
              routing and LSH kernel launched) timed; the serve loop (8
              requests, 4 slots, 16 prompt + 16 generated tokens): each
              routing kernel once a MoE layer a decode step, no LSH
              kernel, tokens/s, p50 / p99, peak memory; loss_fn and its
              backward at 2 x 2048 tokens with LSH on, three times (the
              2nd and 3rd timed): finite loss and gradients, every kernel
              of the path launched, peak memory.  Then the smoke config
              in f32 on the card against the CPU: one train step with the
              f32 and the bf16 wires (slots and loss by phase train
              parity's rules; with the f32 wire gradients within 2e-3
              and params within 1e-4 relative L2, beside the CPU's own
              sensitivity to a 1e-7 move of the embedding, printed), and
              16 teacher-forced decode steps against the forward (LSH
              off) within 1e-3.
 15. tp      one NCCL rank again (a new HashStore group) and a (1, 1) mesh,
              whose one-rank model axis runs runtime/tp.py's collectives
              (Mesh.tp_group).  sp_gather, tp_in_project and tp_project at
              jamba's widths (x [2, 2048, 8192] bf16, w [8192, 16384]):
              forward and backward bit-equal to the copy and the products
              they stand for, each timed beside them; then phase hybrid's
              window: loss_fn and its backward at 2 x 2048 tokens, LSH
              on, mesh-free and through the tensor-parallel Mamba on the
              mesh: loss and every gradient bit-equal (digests; where
              not, within 1e-6 relative with the reason printed), every
              routing and LSH kernel of the path launched.
 16. xlstm   xlstm-350m at full width and depth (24 layers, 7 mLSTM + 1
              sLSTM a super-block, d_model 1024, vocab 50304, bf16, seeded
              weights): the serve loop (8 requests, 4 slots, 16 + 16
              tokens; tokens/s, p50, p99; no port kernel launched);
              launch/train.main, 3 steps at 4 x 1024, finite losses; one
              step under a CUDA-only profile (device ms, device events)
              and one mLSTM and one sLSTM layer's forward, recompute and
              backward at that shape, whose device ms give each mixer's
              share of the step; then 2 layers (mLSTM + sLSTM) in f32 on
              the card against the CPU: one train step (loss and
              gradients within phase train parity's f32 bounds, params
              within 1e-4, the zero-initialised biases within 1e-2 of
              their norm) and 16 teacher-forced decode steps against the
              forward within 1e-3.
 17. archs   the six dense, patch-prefix and encoder-decoder archs at full
              width (bf16, seeded weights; none launches a port kernel:
              no MoE layer): whisper-base, smollm-360m, phi3-mini-3.8b,
              granite-8b, internvl2-26b, nemotron-4-15b.  Each served at
              full depth (8 requests, 4 slots, 16 + 16 tokens: tokens/s,
              p50, p99, peak memory; the params freed before the next).
              Training, finite losses, no skips: whisper-base through
              runtime.step (the launcher's data has no frames) 3 steps
              of 4 x 448 tokens over 4 x 1500 seeded frames;
              launch/train.main 3 steps at 4 x 1024 for smollm-360m and
              phi3-mini-3.8b at full depth, and for granite-8b and
              internvl2-26b (on text) at the deepest whole super-block
              count whose step peaks within 90% of the card's memory,
              reckoned from one step's peak at 1 and 2 super-blocks (the
              reckoning printed); nemotron-4-15b a full step of one
              super-block where it fits, else (printed with its
              reckoning) loss_fn and its backward over the whole 256k
              vocab at 4 x 1024, twice, timed, peak memory.  Then f32 on
              the card against the CPU, TF32 off: whisper-base at 2 + 2
              layers, one train step (loss 1e-5, gradients 1e-4, params
              1e-4) and 16 decode steps (1e-3); internvl2-26b at 2
              layers with 4 patches: logits (1e-3), loss and gradients
              (1e-5, 1e-4).
 18. seqdecode  (a) granite-moe-3b-a800m's attention at full width (24
              heads, 8 KV heads of 64; f32 weights, a bf16 cache of 8 rows
              x 32768): the sequence-split decode attention emulated in
              one process (models/attention.split_decode_attention: each
              block's partial softmax from a copy of its rows, combined in
              block order, as the ranks of a split compute it) against the
              whole-cache decode_attention at positions 0, 2047, 2048 and
              32767: one block bitwise, 16 blocks within 1e-6 relative L2;
              one block of 2048 rows timed beside the whole cache.  (b) The
              full config, full depth, bf16: 8 teacher-forced decode steps
              of 8 rows over a 4096-row cache through decode_step on a
              (1, 1) NCCL mesh (a new HashStore group) with the state of
              init_decode_state(mesh=), and mesh-free: logits and every
              state leaf bit-equal, positions_in_expert, dispatch_scatter
              and combine_gather launched once a MoE layer a step (counts
              and profiler names).
 19. examples  the routing and LSH kernels and their backwards at the
              shapes the examples launch them (a MoE layer of train_lm's
              lm-100m, of the quickstart's and of elastic_restart's
              step; serve_batch's MoE decode step) against their plain
              versions; then the four scripts of
              src/repro_torch/examples, each in a
              subprocess that runs its module as `python -m` does and
              then prints the kernels' launch counters and the peak
              allocation: train_lm --steps 120 into a fresh directory of
              the checkout, alone; then at once train_lm --steps 140,
              which must resume at step 120 (its loss at step 100 below
              step 0's, no skip, the same launches a step in both runs,
              the steady step time read from the arrival of the first
              run's step 20 and 80 lines), quickstart, serve_batch on
              granite-moe-3b-a800m and
              xlstm-350m (4 rows of 20 tokens in the vocabulary, the
              routing kernels once a MoE layer a decode step, nothing
              else); elastic_restart, and its run again in this process
              against an uninterrupted 6-step run on a (1, 1) mesh:
              every loss bit-equal.  Each exits 0 and prints finite
              numbers; the training examples launch rows 1-6 of the
              kernel table and no wire kernel.
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
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
ARCH = "granite-moe-3b-a800m"
# H100 SXM peak rates, read from repro_torch/hw.py by main(): device
# memory, f32 outside the tensor cores, bf16 tensor cores (dense)
HBM_BYTES_PER_S = FP32_OPS_PER_S = BF16_OPS_PER_S = None
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


def _bound(bytes_moved, ops, ops_per_s=None):
    """The least time for the work, in ms: the larger of the bytes over
    the memory rate and the operations over the peak rate of their type
    (f32 unless ``ops_per_s`` says otherwise)."""
    ops_per_s = ops_per_s or FP32_OPS_PER_S
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


def _gather_record(torch, sg, ref, p, label):
    """combine_gather on plan ``p``: bitwise its plain version, dropped
    entries exactly +0.0, timed beside the indexing chain buf[ids, pos] *
    w (its index arithmetic done beforehand) and its bound."""
    F, E, C, H = p["F"], p["E"], p["C"], p["H"]
    flat, pos, buf, w, keep = p["flat"], p["pos"], p["buf"], p["w"], p["keep"]
    ids_c, pos_c = flat.long().clamp(0, E - 1), pos.long().clamp(0, C - 1)
    w_m = w * keep.float()
    out = sg.combine_gather(flat, pos, buf, w)
    if not bool((out[~keep].view(torch.int32) == 0).all()):
        raise AssertionError(f"[{label}] combine_gather: dropped entries "
                             "must gather +0.0")
    return _record(
        torch, label, "combine_gather",
        lambda: (sg.combine_gather(flat, pos, buf, w),),
        lambda: (ref.combine_gather_ref(flat, pos, buf, w),),
        lambda: buf[ids_c, pos_c] * w_m[:, None],
        _bound(F * 12 + int(keep.sum()) * H * 4 + F * H * 4, F * H))


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
        "combine_gather": _gather_record(torch, sg, ref, p, label),
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


def check_gather_sweep(torch, sg, ref, moe_lib, decode, train):
    """combine_gather over the shape classes its launcher separates (rows
    split over warps while the entries cannot fill the resident warps, one
    chunk a row once they can): granite's decode shape (``decode``: F =
    32, H = 1536), jamba's (F = 8, E = 16, C = 4, H = 8192), F = resident
    warps - 1 and F = resident warps at E = 40, H = 1536 (either side of
    the switch), and the training shape (``train``).  Each bitwise its
    plain version, dropped entries +0.0, timed beside the indexing chain,
    its bound and a contiguous copy of as many floats (the card's rate
    for reads and writes of the same size), with the launcher's plan."""
    warps = sg.gather_plan(1, 1536)["resident_warps"]
    cases = {"granite decode": decode,
             "jamba decode": make_plan(torch, ref, T=4, k=2, E=16, C=4,
                                       H=8192, skew=False, bad_frac=0.0,
                                       seed=51)}
    for F in (warps - 1, warps):
        cases[f"F = warps {F - warps:+d}"] = make_plan(
            torch, ref, T=F, k=1, E=40,
            C=moe_lib.expert_capacity(F, 40, 1, 1.25), H=1536, skew=True,
            bad_frac=0.01, seed=54 + F - warps)
    cases["train"] = train
    out = {}
    for name, p in cases.items():
        label = f"gather sweep {name}"
        plan = sg.gather_plan(p["F"], p["H"])
        r = out[name] = dict(_gather_record(torch, sg, ref, p, label),
                             **plan)
        n = min(p["F"] * p["H"], p["buf"].numel())
        dst = torch.empty(n, device="cuda")
        r["copy_ms"] = time_ms(
            torch, lambda: dst.copy_(p["buf"].view(-1)[:n]))
        del dst
        lib = r["library_ms"]
        log(f"[kernels] {label}: F={p['F']} E={p['E']} C={p['C']} "
            f"H={p['H']} split={plan['split']} chunk={plan['chunk']} "
            f"grid={plan['grid']} resident_warps={warps} "
            f"kernel_ms={r['ms']:.6f} call_ms={r['call_ms']:.6f} "
            f"plain_ms={r['plain_ms']:.6f} library_ms={lib:.6f} "
            f"copy_ms={r['copy_ms']:.6f} "
            f"bound_us={r['bound_ms'] * 1e3:.3f} "
            f"kernel_share_of_bound={r['bound_ms'] / r['ms']:.3f} "
            f"faster_than_library={r['ms'] <= lib} "
            f"max_abs_err={r['max_abs_err']}")
    splits = [out[f"F = warps {d:+d}"]["split"] for d in (-1, 0)]
    if splits != [2, 1]:
        raise AssertionError(f"gather sweep: splits either side of the "
                             f"switch {splits}, expected [2, 1]")
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
    timed beside the same library chains as at the training shape
    (printed only)."""
    wq, fw = mods["wire_quant"], mods["fused_wire"]
    E, C, H = p["E"], p["C"], p["H"]
    flat, pos, src, buf, w, keep = (p["flat"], p["pos"], p["src"], p["buf"],
                                    p["w"], p["keep"])
    g = torch.Generator(device="cuda").manual_seed(17)
    slots = torch.randint(0, 2 * C, (E, 2 * C), generator=g, device="cuda",
                          dtype=torch.int32)
    resid = torch.randn(E, 2 * C, H, generator=g, device="cuda")
    ids_c, pos_c = flat.long().clamp(0, E - 1), pos.long().clamp(0, C - 1)
    w_m = w * keep.float()
    rows = torch.where(keep, flat.long() * C + pos.long(), E * C)
    src32 = src.float()
    # slots at or past C read nothing
    slot_ok = (slots < C).float()[..., None]
    rows_c = (torch.arange(E, device="cuda")[:, None] * C
              + slots.clamp(max=C - 1)).reshape(-1)
    for fmt in WIRE_FORMATS:
        qb, sb = ref.wire_quantize_ref(buf, fmt)
        base = ref.wire_dequantize_ref(qb, sb)
        out = {
            "wire_quantize": _record(
                torch, label, f"wire_quantize {fmt}",
                lambda: tuple(map(_u8, wq.wire_quantize(buf, fmt))),
                lambda: tuple(map(_u8, ref.wire_quantize_ref(buf, fmt))),
                lambda: _quantize_chain(torch, buf, fmt),
                _bound(buf.numel() * 5, 0)),
            "wire_dequantize": _record(
                torch, label, f"wire_dequantize {fmt}",
                lambda: (wq.wire_dequantize(qb, sb),),
                lambda: (ref.wire_dequantize_ref(qb, sb),),
                lambda: qb.float() * sb[..., None],
                _bound(buf.numel() * 5, 0)),
            "dispatch_scatter_quantize": _record(
                torch, label, f"dispatch_scatter_quantize {fmt}",
                lambda: tuple(map(_u8, fw.dispatch_scatter_quantize(
                    flat, pos, src, E, C, fmt))),
                lambda: tuple(map(_u8, ref.dispatch_scatter_quantize_ref(
                    flat, pos, src, E, C, fmt))),
                lambda: _quantize_chain(torch, torch.zeros(
                    E * C + 1, H, device="cuda").index_put_(
                        (rows,), src32, accumulate=True), fmt),
                _bound(E * C * H * 3, 0)),
            "dequantize_combine_gather": _record(
                torch, label, f"dequantize_combine_gather {fmt}",
                lambda: (fw.dequantize_combine_gather(flat, pos, qb, sb,
                                                      w),),
                lambda: (ref.dequantize_combine_gather_ref(
                    flat, pos, qb, sb, w),),
                lambda: (qb[ids_c, pos_c].float()
                         * sb[ids_c, pos_c][:, None]) * w_m[:, None],
                _bound(p["F"] * H * 5, 0)),
            "dequantize_residual_apply": _record(
                torch, label, f"dequantize_residual_apply {fmt}",
                lambda: (fw.dequantize_residual_apply(slots, qb, sb, resid,
                                                      base),),
                lambda: (ref.dequantize_residual_apply_ref(
                    slots, qb, sb, resid, base),),
                lambda: (qb.float() * sb[..., None] - base).reshape(
                    E * C, H)[rows_c].view(E, 2 * C, H) * slot_ok + resid,
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
    check_gather_sweep(torch, sg, ref, moe_lib, decode, train)
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
    op_host_us(torch, mods, train, q)
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


PROFILE_EDGE_S = 0.1            # idle time on each side of a profile's edge


def profile_second_step(torch, run_step):
    """torch.profiler over two calls of ``run_step`` (each ending in a
    synchronize), counting the second: the first runs in the profiler's
    warm-up, whose events are dropped.  A profile started just before the
    step it counts missed that step's first 26-45 device events (the
    batch's copies, the embedding, the first norm and projections), in six
    runs of phase obs, also after waiting 0.5 s for it to settle.  With
    the warm-up step, the device's clock as the profile maps it onto the
    host's still strays by some ms, and with each step's last kernels
    ending just before an edge, four profiles of one training step counted
    29643, 29714, 29783 and 30038 device events in one run of this script.
    So the device idles ``PROFILE_EDGE_S`` on each side of both edges
    (``profile_edges`` reads the margins that a profile shows)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            time.sleep(PROFILE_EDGE_S)
            run_step()
            time.sleep(PROFILE_EDGE_S)
            prof.step()
    return prof


def profile_edges(prof):
    """(ms from the profiled step's start to its first device event, ms
    from its last device event to its end), by the profile's clock."""
    from torch.autograd import DeviceType
    evs = prof.events()
    dev = [e.time_range for e in evs if e.device_type == DeviceType.CUDA]
    step = next(e.time_range for e in evs
                if e.name.startswith("ProfilerStep")
                and e.device_type == DeviceType.CPU)
    return ((min(r.start for r in dev) - step.start) / 1e3,
            (step.end - max(r.end for r in dev)) / 1e3)


TRAIN_PROFILES = 4               # profiles of the training step, at most


def phase_train_profile(torch, cfg, step_lib, data_lib, summarize,
                        port_names, spy):
    """One steady-state training step under torch.profiler (LSH on), after
    two warm-up steps, a host-clock timing of two more and the profiler's
    own warm-up step; profiled again until two profiles agree.  The first
    warm-up step runs under ``spy`` (spy_centroid_slots): returns (the
    profile's record, that step's segment_centroid slot sets)."""
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
    # a profile of 30 thousand device events can lose or gain some at its
    # edges (see profile_second_step): steps 4 and 5 are profiled again
    # until two profiles count the same device events, and the record is
    # the first of them
    seen = {}
    for i in range(TRAIN_PROFILES):
        profiled = iter(range(4, 6))
        prof = profile_second_step(torch, lambda: run(next(profiled), 1))
        record, lines = summarize(prof, 1, wall_ms, top=15)
        n = record["device_kernels_per_step"]
        first, last = profile_edges(prof)
        log(f"[train-profile] profile {i + 1}: {n} device events a step; "
            f"the first {first:.3f} ms after the step's start, the last "
            f"{last:.3f} ms before its end")
        if n in seen:
            record, lines, prof = seen[n]
            break
        seen[n] = (record, lines, prof)
    else:
        raise AssertionError(f"no two of {TRAIN_PROFILES} profiles of one "
                             f"training step counted the same device "
                             f"events: {sorted(seen)}")
    del seen
    for line in lines:
        log(f"[train-profile] {line}")
    record["port_kernels_ms_per_step"] = _port_kernels(prof.key_averages(),
                                                       port_names)
    log("[train-profile] " + json.dumps(record, sort_keys=True))
    record["kernel_names"] = _device_names(torch, prof)   # for phase obs
    del state, prof
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

def _parity_runs(torch, model_lib, step_lib, clustering, kernels, expect,
                 cfg, opt, batch, microbatch=0, seed=5):
    """One train step of ``cfg`` on the card (kernels) and on the CPU
    (plain versions) from the same params and batch.  Returns per device
    its slots and hash inputs (every assign_slots call), the gradients
    AdamW was handed, the loss and the params after the step; the card's
    run must launch exactly the kernels named in ``expect``."""
    orig_assign, orig_update = clustering.assign_slots, step_lib.adamw_update
    cpu = torch.device("cpu")
    params_cpu = model_lib.init_params(cfg, seed=seed, device=cpu)
    runs = {}
    try:
        for name, dev in (("cuda", torch.device("cuda")), ("cpu", cpu)):
            rec = {"slots": [], "inputs": [], "grads": None}

            def spy(tokens, rotations, num_slots, hash_type, rec=rec):
                out = orig_assign(tokens, rotations, num_slots, hash_type)
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
            state = step_lib.TrainState(params,
                                        step_lib.adamw_init(params, opt))
            before = [k.launches for k in kernels]
            state, m = step_lib.make_train_step(cfg, opt,
                                                microbatch=microbatch)(
                state, step_lib.batch_to_device(batch, dev))
            ran = {k.name: k.launches - b for k, b in zip(kernels, before)}
            if {n for n, c in ran.items() if c} != (
                    expect if dev.type == "cuda" else set()):
                raise AssertionError(f"{name} run launched {ran}")
            rec["loss"] = float(m["loss"])
            rec["params"] = [p.detach().cpu()
                             for p in step_lib.leaves(state.params)]
            runs[name] = rec
    finally:
        clustering.assign_slots = orig_assign
        step_lib.adamw_update = orig_update
    return runs["cuda"], runs["cpu"]


def _parity_stats(torch, lh, a, b, n_moe):
    """(slot ids differing per record, smallest near-tie margin of the
    forward's hashes, loss rel, worst gradient rel L2, worst param rel
    L2) of two _parity_runs records."""
    n_diff = [int((x != y).sum()) for x, y in zip(a["slots"], b["slots"])]
    margin = min(float(lh.near_tie_margin(x, r).min())
                 for x, r in b["inputs"][:n_moe])

    def rel(u, v):
        return float((u.double() - v.double()).norm()
                     / v.double().norm().clamp_min(1e-30))

    loss_rel = abs(a["loss"] - b["loss"]) / abs(b["loss"])
    g_rel = max(rel(x, y) for x, y in zip(a["grads"], b["grads"])
                if y is not None and y.any())
    p_rel = max(rel(x, y) for x, y in zip(a["params"], b["params"])
                if y.is_floating_point())
    return n_diff, margin, loss_rel, g_rel, p_rel


def phase_train_parity(torch, model_lib, step_lib, clustering, lh, kernels,
                       path_kernels, cfg_full):
    """One train step on the card (kernels) and on the CPU (plain
    versions) from the same params and batch, per wire: f32, bf16 and
    int8 (``path_kernels``: the kernels each launches on the card)."""
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.data.synthetic import SyntheticLMDataset
    # the first step of a 10-step warm-up (lr 1e-4): a first AdamW step
    # moves each param by about lr * sign(g), so a tiny gradient whose sign
    # the two devices' f32 sums disagree on moves the param by a full lr
    opt = OptimizerConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    for wire, fmt in (("float32", "bf16"), ("bfloat16", "bf16"),
                      ("bfloat16", "int8")):
        cfg = with_wire(cfg_full.replace(num_super_blocks=2,
                                         dtype="float32"),
                        wire_dtype=wire, wire_format=fmt)
        batch = SyntheticLMDataset(cfg.vocab_size, 64, 2).batch_at(0)
        a, b = _parity_runs(torch, model_lib, step_lib, clustering, kernels,
                            {k.name for k in path_kernels[fmt]}, cfg, opt,
                            batch)
        n_moe = cfg.num_layers
        n_diff, margin, loss_rel, g_rel, p_rel = _parity_stats(
            torch, lh, a, b, n_moe)
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
DIGEST_SLICE = 1 << 26             # words a slice of _digest


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
        words = p.detach().contiguous().view(-1)
        words = words.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[
            words.element_size()])
        total = weighted = 0
        # in slices, so that the int64 copies stay small beside a leaf of
        # billions of words
        for lo in range(0, words.numel(), DIGEST_SLICE):
            w = words[lo:lo + DIGEST_SLICE].to(torch.int64)
            pos = (torch.arange(lo, lo + w.numel(), device=w.device)
                   % 65521 + 1)
            total += int(w.sum())
            weighted += int((w * pos).sum())
        out.append((total, weighted))
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
    from repro_torch.optim.adam import leaves
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
                       param_bytes_per_rank=sum(
                           t.numel() * t.element_size()
                           for t in leaves(state.params)),
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


# ---------------------------------------------------------- 9b. placement --

PLACEMENT_ARCH = "granite-8b"
PLACEMENT_SUPER_BLOCKS = 4
PLACEMENT_ARCHS = ("granite-8b", "nemotron-4-15b", "internvl2-26b")
PLACEMENT_MESHES = ((2, 2), (1, 4))


def param_bytes_per_rank(registry, params_lib, Mesh):
    """{arch: {"DxM": bytes}} of the full configs' params a rank over
    PLACEMENT_MESHES, from their specs on meta tensors (nothing
    allocated), with each one's whole bytes."""
    from repro_torch.models import model as model_lib
    from repro_torch.optim.adam import leaves
    out = {}
    for arch in PLACEMENT_ARCHS:
        cfg = registry.get_config(arch)
        rec = {"whole": sum(t.numel() * t.element_size() for t in
                            leaves(model_lib.logical_params(cfg)))}
        for shape in PLACEMENT_MESHES:
            mesh = Mesh(shape)
            rec[f"{shape[0]}x{shape[1]}"] = params_lib.local_bytes(
                model_lib.logical_params(cfg, mesh),
                params_lib.model_specs(cfg, mesh), mesh)
        out[arch] = rec
    return out


def phase_placement(torch, step_lib, data_lib, registry):
    """granite-8b at full width and PLACEMENT_SUPER_BLOCKS super-blocks,
    MESH_STEPS steps at 4 x 1024 through the mesh path on a (1, 1) mesh
    and the mesh-free path from the same seed: losses, clip norms and
    every leaf bit-equal; step ms and peak memory.  Then the param bytes
    a rank of the full configs over (2, 2) and (1, 4)."""
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.launch.mesh import Mesh, make_mesh
    from repro_torch.optim.adam import leaves
    from repro_torch.runtime import params as params_lib
    dev = torch.device("cuda")
    mesh = make_mesh(1, 1)
    cfg = registry.get_config(PLACEMENT_ARCH).replace(
        num_super_blocks=PLACEMENT_SUPER_BLOCKS)
    opt = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=8)
    ds = data_lib.SyntheticLMDataset(cfg.vocab_size, 1024, 4)
    runs = {}
    for tag, m in (("mesh-free", None), ("mesh (1, 1)", mesh)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        state = step_lib.init_train_state(cfg, opt, seed=0, device=dev,
                                          mesh=m)
        step_fn = step_lib.make_train_step(cfg, opt, mesh=m)
        losses, norms, dts = [], [], []
        for s in range(MESH_STEPS):
            batch = step_lib.batch_to_device(ds.batch_at(s), dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, met = step_fn(state, batch)
            losses.append(met["loss"].item())
            norms.append(met["grad_norm"].item())
            dts.append((time.perf_counter() - t0) * 1e3)
        rec = dict(losses=losses, grad_norms=norms, step_ms=dts,
                   peak_memory_bytes=torch.cuda.max_memory_allocated(dev),
                   param_bytes_per_rank=sum(
                       t.numel() * t.element_size()
                       for t in leaves(state.params)))
        log(f"[placement] {cfg.name} at {cfg.num_super_blocks} super-blocks, "
            f"{tag}: " + json.dumps(rec, sort_keys=True))
        if not all(math.isfinite(v) for v in losses + norms):
            raise AssertionError(f"placement {tag}: not finite {losses} "
                                 f"{norms}")
        runs[tag] = (rec, _digest(torch, state.params))
        del state, step_fn
    (a, da), (b, db) = runs["mesh-free"], runs["mesh (1, 1)"]
    same = (a["losses"] == b["losses"] and a["grad_norms"]
            == b["grad_norms"] and da == db)
    log(f"[placement] mesh (1, 1) against mesh-free after {MESH_STEPS} "
        f"steps: losses, clip norms and all {len(da)} param leaves "
        f"{'bit-equal' if same else 'DIFFER'}")
    if not same:
        raise AssertionError("placement: the mesh (1, 1) path is not "
                             "bit-equal to the mesh-free path")
    per_rank = param_bytes_per_rank(registry, params_lib, Mesh)
    log("[placement] param bytes a rank from the specs: "
        + json.dumps(per_rank, sort_keys=True))
    torch.cuda.empty_cache()
    return {"runs": {k: v[0] for k, v in runs.items()},
            "param_bytes": per_rank}


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


# --------------------------------------------------------- 11. resilience --

RESTORE_STEPS, RESTORE_AT = 4, 2           # train 4 steps, save after 2
SMOKE_ARGV = ["--arch", ARCH, "--smoke", "--steps", "6", "--batch", "4",
              "--seq", "32", "--log-every", "1"]
WHOLE_BATCH_PEAK = None                    # set by main from phase train
PREFILL_BATCH, PREFILL_SEQ = 8, 1024


def _tree_mismatch(torch, a, b):
    """Keys of the leaves of two trees whose bits differ (or are missing
    on one side)."""
    from repro_torch.checkpoint.checkpoint import _flatten
    fa = {k: v for k, v in _flatten(a)}
    fb = {k: v for k, v in _flatten(b)}
    bad = sorted(set(fa) ^ set(fb))
    for k in set(fa) & set(fb):
        x, y = fa[k].detach(), fb[k].detach()
        if x.dtype == torch.bfloat16:
            x, y = x.view(torch.int16), y.view(torch.int16)
        if x.dtype != y.dtype or x.shape != y.shape \
                or not torch.equal(x, y.to(x.device)):
            bad.append(k)
    return bad


def resilience_restore(torch, cfg_full, step_lib, data_lib, kernels,
                       path_kernels, dev, workdir, seq=1024):
    """(a) The config cut to 2 super-blocks (bf16, LSH on, bf16 wire), 4 x
    ``seq`` tokens: 4 steps with CheckpointManager saving after step 2
    (the write overlapping steps 3 and 4), then a state of another seed
    restored from step 2 and steps 3 and 4 again: losses and every param
    and moment bit-equal.  Returns the restored steps' kernel launches."""
    from repro_torch.checkpoint.checkpoint import (CheckpointManager,
                                                   load_checkpoint)
    from repro_torch.configs.base import OptimizerConfig
    cfg = cfg_full.replace(num_super_blocks=2)
    opt = OptimizerConfig(lr=1e-3, warmup_steps=0, total_steps=RESTORE_STEPS)
    ds = data_lib.SyntheticLMDataset(cfg.vocab_size, seq, 4)
    batches = [step_lib.batch_to_device(ds.batch_at(s), dev)
               for s in range(RESTORE_STEPS)]
    step = step_lib.make_train_step(cfg, opt)

    def run(state, first):
        losses, ms = [], []
        for s in range(first, RESTORE_STEPS):
            t0 = time.perf_counter()
            state, m = step(state, batches[s])
            losses.append(float(m["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
            if s + 1 == RESTORE_AT and first == 0:
                mgr.save_async(RESTORE_AT, state)
        return state, losses, ms

    mgr = CheckpointManager(str(workdir / "restore"))
    state, want, ms_a = run(step_lib.init_train_state(cfg, opt, seed=0,
                                                      device=dev), 0)
    overlapped = mgr.in_flight
    mgr.wait()
    fresh = step_lib.init_train_state(cfg, opt, seed=1, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored, start, _ = load_checkpoint(str(workdir / "restore"), fresh)
    restore_ms = (time.perf_counter() - t0) * 1e3
    del fresh
    for k in kernels:
        k.launches = 0
    restored, got, ms_b = run(restored, start)
    launches = {k.name: k.launches for k in kernels}
    bad = _tree_mismatch(torch, restored, state)
    n_leaves = len(step_lib.leaves(state.params))
    log(f"[resilience] restore: {cfg.num_layers} layers at full width, 4 x "
        f"{seq} tokens; checkpoint of step {RESTORE_AT}: "
        f"{mgr.last_bytes} bytes on disk, host copy "
        f"{mgr.last_host_copy_s * 1e3:.1f} ms (the only blocking part), save "
        f"thread {mgr.last_write_s * 1e3:.1f} ms, restore "
        f"{restore_ms:.1f} ms; the save was still writing after the last "
        f"step: {overlapped}; step ms {[round(x, 1) for x in ms_a]} (steps "
        f"{RESTORE_AT + 1}-{RESTORE_STEPS} beside the save) and restored "
        f"{[round(x, 1) for x in ms_b]}; losses {want} and restored {got}")
    if start != RESTORE_AT or got != want[RESTORE_AT:] or bad:
        raise AssertionError(f"restored run differs: step {start}, losses "
                             f"{got} vs {want[RESTORE_AT:]}, leaves {bad[:5]}"
                             f" of {n_leaves} params and their moments")
    never = [k.name for k in path_kernels if launches[k.name] == 0] \
        if dev.type == "cuda" else []
    if never:
        raise AssertionError(f"the restored steps never launched {never}")
    log("[resilience] restore: losses and every param and moment "
        "bit-equal; kernel launches of the restored steps "
        + json.dumps(launches))
    zlib_rates(torch, state)
    del state, restored
    return {"bytes": mgr.last_bytes,
            "host_copy_ms": mgr.last_host_copy_s * 1e3,
            "save_thread_ms": mgr.last_write_s * 1e3,
            "restore_ms": restore_ms, "launches": launches}


ZLIB_SAMPLE = 16 << 20


def zlib_rates(torch, state):
    """This host's zlib at levels 0, 1 and 3 and sha256 on 16 MiB of the
    first MoE layer's w_up (bf16) and of its f32 first moment: MB/s and
    the share of the bytes kept (why the checkpoint writes level 0)."""
    import hashlib
    import zlib
    ffn = state.params["layers"][0]["ffn"]
    for name, t in (("w_up bf16", ffn["w_up"].view(torch.int16)),
                    ("m(w_up) f32", state.opt.m["layers"][0]["ffn"]["w_up"])):
        raw = t.detach().cpu().numpy().tobytes()[:ZLIB_SAMPLE]
        parts = []
        for level in (0, 1, 3):
            t0 = time.perf_counter()
            n = len(zlib.compress(raw, level))
            dt = time.perf_counter() - t0
            parts.append(f"level {level} {len(raw) / dt / 1e6:.0f} MB/s "
                         f"keeps {n / len(raw):.3f}")
        t0 = time.perf_counter()
        hashlib.sha256(raw).digest()
        rate = len(raw) / (time.perf_counter() - t0) / 1e6
        parts.append(f"sha256 {rate:.0f} MB/s")
        log(f"[resilience] this host's CPU on 16 MiB of {name}: "
            + "; ".join(parts))


def _launcher_argv(argv, device):
    return [*SMOKE_ARGV, *([] if device == "cuda" else ["--device", device]),
            *argv]


def _run_events(d):
    with open(d / "events.jsonl") as f:
        return [json.loads(line) for line in f]


def resilience_kill(train, workdir, device="cuda"):
    """(b) The launcher on the smoke config on the card: an uninterrupted
    run (in this process), then, in two supervised subprocesses at once,
    a SIGKILL at step 3 and two damaged checkpoints followed by a SIGKILL
    (both under --auto-restart): each run's step losses bit for bit the
    uninterrupted run's (JSON floats: equal values are equal bits)."""
    t0 = time.perf_counter()
    base = workdir / "base"
    with contextlib.redirect_stdout(io.StringIO()):
        rc = train.main(_launcher_argv(
            ["--ckpt-every", "2", "--ckpt", str(base / "ckpt"),
             "--metrics-dir", str(base)], device))
    if rc != 0:
        raise AssertionError(f"the uninterrupted launcher run returned {rc}")
    want = {e["step"]: e["loss"] for e in _run_events(base)
            if e["kind"] == "step"}
    log(f"[resilience] launcher base: {time.perf_counter() - t0:.1f} s, "
        f"losses {[want[s] for s in sorted(want)]}")
    env = dict(os.environ, PYTHONPATH=str(SRC), RESTART_BACKOFF_S="0",
               MAX_RESTARTS="3")
    env.pop("REPRO_CHAOS", None)
    procs = {}
    for name, argv in (
            ("sigkill", ["--ckpt-every", "2", "--chaos", "sigkill@3"]),
            ("corrupt", ["--ckpt-every", "1", "--chaos",
                         "ckpt_flip@1,ckpt_truncate@2,sigkill@3"])):
        d = workdir / name
        procs[name] = (d, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train",
             *_launcher_argv([*argv, "--auto-restart", "--ckpt",
                              str(d / "ckpt"), "--metrics-dir", str(d)],
                             device)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env))
    for name, (d, proc) in procs.items():
        _, err = proc.communicate(timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"launcher run {name} exited "
                                 f"{proc.returncode}:\n{err[-3000:]}")
        ev = _run_events(d)
        losses = {e["step"]: e["loss"] for e in ev if e["kind"] == "step"}
        restarts = [e["classification"] for e in ev
                    if e["kind"] == "restart"]
        corrupt = [e["step"] for e in ev if e["kind"] == "checkpoint_corrupt"]
        log(f"[resilience] launcher {name}: restarts {restarts}, "
            f"quarantined {corrupt}, losses "
            f"{[losses[s] for s in sorted(losses)]}")
        if losses != want or restarts != ["signal_9"]:
            raise AssertionError(f"{name}: trajectory or restarts differ "
                                 "from the uninterrupted run")
        if name == "corrupt" and sorted(corrupt) != [2, 3]:
            raise AssertionError(f"corrupt run quarantined {corrupt}")
    log(f"[resilience] launcher: SIGKILL and damaged-checkpoint runs "
        f"bit-equal to the uninterrupted run ({time.perf_counter() - t0:.1f}"
        " s)")


def resilience_microbatch(torch, cfg_full, model_lib, step_lib, data_lib,
                          clustering, lh, kernels, path_kernels):
    """(c) microbatch 2 at 4 x 64 tokens, 2 layers at full width, f32 with
    the f32 wire: the card's step against the CPU's within the train-
    parity phase's f32-wire bounds.  Then one full-depth bf16 step at
    4 x 1024 tokens with microbatch 2: its time and peak memory beside the
    whole-batch run's.  Returns the full-depth params for the prefill."""
    from repro_torch.configs.base import OptimizerConfig
    opt = OptimizerConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    cfg = with_wire(cfg_full.replace(num_super_blocks=2, dtype="float32"),
                    wire_dtype="float32")
    batch = data_lib.SyntheticLMDataset(cfg.vocab_size, 64, 4).batch_at(0)
    a, b = _parity_runs(torch, model_lib, step_lib, clustering, kernels,
                        {k.name for k in path_kernels}, cfg, opt, batch,
                        microbatch=2)
    n_diff, margin, loss_rel, g_rel, p_rel = _parity_stats(
        torch, lh, a, b, cfg.num_layers)
    log(f"[resilience] microbatch 2 x 2 rows, f32 wire: slot ids differing "
        f"per record {n_diff}; smallest near-tie margin {margin:.3g}; last "
        f"microbatch's loss cuda {a['loss']} cpu {b['loss']} (rel "
        f"{loss_rel:.3g}); worst gradient rel L2 {g_rel:.3g}; worst param "
        f"rel L2 {p_rel:.3g}; TF32 off")
    if any(n_diff) or loss_rel > LOSS_RTOL or g_rel > GRAD_RTOL \
            or p_rel > PARAM_RTOL:
        raise AssertionError("CUDA and CPU microbatched steps disagree")
    dev = torch.device("cuda")
    opt = OptimizerConfig(lr=1e-3, warmup_steps=0, total_steps=2)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    state = step_lib.init_train_state(cfg_full, opt, seed=0, device=dev)
    step = step_lib.make_train_step(cfg_full, opt, microbatch=2)
    ds = data_lib.SyntheticLMDataset(cfg_full.vocab_size, 1024, 4)
    ms = []
    for s in range(2):
        batch = step_lib.batch_to_device(ds.batch_at(s), dev)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss = float(m["loss"])
        ms.append((time.perf_counter() - t0) * 1e3)
        if not math.isfinite(loss) or int(m["grad_skips"]):
            raise AssertionError("full-depth microbatched step failed")
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"[resilience] full depth, 4 x 1024 tokens, microbatch 2: step ms "
        f"{[round(x, 1) for x in ms]}, last loss {loss}, peak memory "
        f"{peak / 1e9:.2f} GB (the whole-batch run of phase train: "
        f"{(WHOLE_BATCH_PEAK or 0) / 1e9:.2f} GB)")
    params = state.params
    del state, m
    torch.cuda.empty_cache()
    return {"step_ms": ms, "peak_bytes": peak}, params


def resilience_prefill(torch, cfg_full, model_lib, step_lib, kernels,
                       path_kernels, params_full):
    """(d) prefill, 2 layers at full width in f32 with the f32 wire (as
    (c): the bf16 wire turns last-bit f32 differences into bf16 steps):
    the card's last logits against the CPU's within the decode parity's
    bound, equal greedy tokens; then the full depth's prefill of
    8 x 1024 tokens timed."""
    cfg = with_wire(cfg_full.replace(num_super_blocks=2, dtype="float32"),
                    wire_dtype="float32")
    cpu, dev = torch.device("cpu"), torch.device("cuda")
    params_cpu = model_lib.init_params(cfg, seed=7, device=cpu)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64),
                           generator=torch.Generator().manual_seed(8))
    before = [k.launches for k in kernels]
    got, st = step_lib.make_prefill_step(cfg)(tree_to(params_cpu, dev),
                                              {"tokens": tokens.to(dev)})
    ran = {k.name: k.launches - b for k, b in zip(kernels, before)}
    want, _ = step_lib.make_prefill_step(cfg)(params_cpu, {"tokens": tokens})
    err = float((got.cpu() - want).abs().max())
    same = bool(torch.equal(got.cpu().argmax(-1), want.argmax(-1)))
    never = [k.name for k in path_kernels if not ran[k.name]]
    log(f"[resilience] prefill 2 layers f32, f32 wire, 2 x 64 tokens: max "
        f"|last logits cuda - cpu| {err} (atol {PARITY_ATOL}), greedy tokens "
        f"equal {same}, position {st['position']}; launches {ran}")
    if err > PARITY_ATOL or not same or st["position"] != 64 or never:
        raise AssertionError(f"CUDA and CPU prefill disagree (never "
                             f"launched: {never})")
    fn = step_lib.make_prefill_step(cfg_full)
    toks = torch.randint(0, cfg_full.vocab_size, (PREFILL_BATCH, PREFILL_SEQ),
                         generator=torch.Generator().manual_seed(9)).to(dev)
    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = fn(params_full, {"tokens": toks})
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite full-depth prefill logits")
    log(f"[resilience] prefill full depth, {PREFILL_BATCH} x {PREFILL_SEQ} "
        f"tokens: ms {[round(x, 1) for x in ms]} (the first warms up), "
        f"{PREFILL_BATCH * PREFILL_SEQ / (min(ms[1:]) / 1e3):.0f} tokens/s")
    return {"prefill_ms": ms}


def phase_resilience(torch, train, cfg, model_lib, step_lib, data_lib,
                     clustering, lh, kernels, path_kernels):
    """(a) in-process restore, (b) kill and resume of the launcher, (c)
    microbatched steps, (d) prefill; the checkpoints go to a directory of
    the checkout that is removed afterwards."""
    import shutil
    import tempfile
    workdir = Path(tempfile.mkdtemp(prefix=".resilience-", dir=ROOT))
    t0 = time.time()
    try:
        out = {"restore": resilience_restore(
            torch, cfg, step_lib, data_lib, kernels, path_kernels,
            torch.device("cuda"), workdir)}
        torch.cuda.empty_cache()
        log(f"[time] resilience (a) {time.time() - t0:.1f} s")
        resilience_kill(train, workdir)
        log(f"[time] resilience (b) {time.time() - t0:.1f} s")
        out["microbatch"], params = resilience_microbatch(
            torch, cfg, model_lib, step_lib, data_lib, clustering, lh,
            kernels, path_kernels)
        log(f"[time] resilience (c) {time.time() - t0:.1f} s")
        out["prefill"] = resilience_prefill(
            torch, cfg, model_lib, step_lib, kernels, path_kernels, params)
        del params
        torch.cuda.empty_cache()
        log(f"[time] resilience (d) {time.time() - t0:.1f} s")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return out


# ---------------------------------------------------------------- 12. obs --

OBS_STEPS, OBS_PROFILE = 4, 2
MOE_PHASES = ("gate", "hash_compress", "dispatch_a2a", "expert_mlp",
              "combine_a2a", "decompress")
KERNEL_SUM_RTOL = 5e-3
OBS_REMEASURES = 3              # more profiles of the obs-off step, at most
OBS_METRIC_ATOL = 1e-6


def _port_kernel_name(event_name, names):
    """The port's kernel a device event name is, or None."""
    key = event_name.removeprefix("void ")
    ns = "(anonymous namespace)::"
    if not key.startswith(ns):
        return None
    name = re.split(r"[<(]", key[len(ns):])[0]
    return name if name in names else None


def obs_launcher(torch, train, registry, kernels, port_names, workdir,
                 wire, steps, profiled):
    """(a) launch/train.py with --profile in this process, LSH on, the
    ``wire`` format: the measured phases of metrics.json, the MoE phases
    non-zero (on one card the bf16 wire's exchange is the identity and
    launches nothing, so its two all-to-all phases hold only their
    ranges; the int8 wire's hold the codec), their sum against the
    trace's own kernel time, no port kernel in ``other``.  Returns
    metrics.json."""
    from repro_torch.launch.profile_phases import wire_format
    from repro_torch.obs import profile as obs_profile
    d = workdir / f"train-{wire}"
    argv = TRAIN_ARGV + ["--lsh", "on", "--steps", str(steps),
                         "--profile", str(profiled), "--metrics-dir",
                         str(d)]
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    buf = io.StringIO()
    with wire_format(registry, wire), contextlib.redirect_stdout(buf):
        rc = train.main(argv)
    t_run = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"train.main --profile returned {rc}")
    tag = f"[obs] {wire}"
    for line in buf.getvalue().splitlines():
        if line.startswith("[drift]") or line.startswith("error"):
            log(f"{tag} {line}")
    with open(d / "metrics.json") as f:
        m = json.load(f)
    t0 = time.perf_counter()
    trace_file = d / "torch_trace" / "rank0.pt.trace.json"
    with open(trace_file) as f:
        trace = json.load(f)
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    parsed = obs_profile.parse_trace_events(trace, steps=profiled)
    t_parse = time.perf_counter() - t0
    evs = trace["traceEvents"]
    kernel_s = sum(float(e["dur"]) for e in evs if e.get("ph") == "X"
                   and e.get("cat") in obs_profile.DEVICE_CATS) \
        * 1e-6 / profiled
    ranges = {p: sum(1 for e in evs if e.get("cat") == "user_annotation"
                     and e.get("name") == f"obs/{p}") / profiled
              for p in MOE_PHASES}
    del trace, evs
    log(f"{tag} launcher: {steps} steps, {profiled} profiled, full depth; "
        f"run {t_run:.1f} s (the trace's export included), trace "
        f"{trace_file.stat().st_size / 1e6:.1f} MB, load {t_load:.1f} s, "
        f"parse {t_parse:.1f} s; kernel launches "
        f"{ {k.name: k.launches for k in kernels if k.launches} }; "
        f"phase ranges a step {ranges}")
    if not m.get("measured_on_device"):
        raise AssertionError("metrics.json holds no measured device phases")
    total = 0.0
    for p in obs_profile.PHASE_ORDER:
        sec = m.get(f"measured_{p}_s", 0.0)
        total += sec
        log(f"{tag} phase {p:15s} measured {sec * 1e3:10.3f} ms/step "
            f"{m.get(f'measured_{p}_launches', 0.0):8.1f} launches/step  "
            f"share {sec / m['measured_step_s']:.4f}  modeled share "
            f"{m.get(f'weight_{p}', 0.0):.4f}")
    log(f"{tag} measured step {m['measured_step_s'] * 1e3:.3f} ms of device "
        f"time, trace kernel time {kernel_s * 1e3:.3f} ms/step; other share "
        f"{m.get('measured_other_s', 0.0) / m['measured_step_s']:.4f}; "
        f"comm share measured {m['measured_comm_share']:.6f} modeled "
        f"{m['comm_share']:.6f}; drift score {m.get('model_drift_score')}, "
        f"clock ratio {m.get('model_clock_ratio')}")
    top_other = sorted(parsed.other_names.items(), key=lambda kv: -kv[1])
    log(f"{tag} other's most frequent device events: {top_other[:6]}")
    need = MOE_PHASES if wire != "bf16" else tuple(
        p for p in MOE_PHASES if p not in ("dispatch_a2a", "combine_a2a"))
    zero = [p for p in need if not m.get(f"measured_{p}_s", 0.0) > 0]
    if zero or not all(ranges.values()):
        raise AssertionError(f"MoE phases with no measured time {zero} or "
                             f"no range {ranges}")
    if abs(total - kernel_s) > KERNEL_SUM_RTOL * kernel_s:
        raise AssertionError(f"phases sum to {total} s a step, the trace's "
                             f"kernels to {kernel_s} s")
    in_other = {}
    for name, n in parsed.other_names.items():
        k = _port_kernel_name(name, port_names)
        if k is not None:
            in_other[k] = in_other.get(k, 0) + n
    if in_other:
        raise AssertionError(f"port kernels attributed to other: {in_other}")
    return m


def _device_names(torch, prof):
    """How many device events (kernels, copies, sets) of each name a
    profile holds."""
    from collections import Counter

    from torch.autograd import DeviceType
    return Counter(e.name for e in prof.events()
                   if e.device_type == DeviceType.CUDA)


def obs_on_off(torch, cfg, step_lib, data_lib, summarize, steps=4,
               settings=(False, True)):
    """(b) The full config, bf16 wire, LSH on, 4 x 1024 tokens, from the
    same seed with obs off and on: ``steps`` steps, then one step under
    torch.profiler as phase train's profile takes it (after the profiler's
    warm-up step; the batch's copy to the card inside, the same
    optimizer).  Returns {obs: (losses,
    params, kernels per step, the last step's scalar metrics, the device
    events by name)}."""
    import dataclasses

    from repro_torch.configs.base import ObsConfig, OptimizerConfig
    opt = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=8)
    ds = data_lib.SyntheticLMDataset(cfg.vocab_size, 1024, 4)
    dev = torch.device("cuda")
    out = {}
    for on in settings:
        c = cfg.replace(moe=dataclasses.replace(
            cfg.moe, obs=ObsConfig(enabled=on)))
        state = step_lib.init_train_state(c, opt, seed=0, device=dev)
        step_fn = step_lib.make_train_step(c, opt)
        losses = []
        for s in range(steps):
            state, m = step_fn(state, step_lib.batch_to_device(
                ds.batch_at(s), dev))
            losses.append(float(m["loss"]))
        torch.cuda.synchronize()

        def run_step():
            nonlocal state, m
            state, m = step_fn(state, step_lib.batch_to_device(
                ds.batch_at(len(losses)), dev))
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()

        prof = profile_second_step(torch, run_step)
        rec, _ = summarize(prof, 1, 1.0, top=1)
        params = [p.detach().clone() for p in step_lib.leaves(state.params)]
        out[on] = (losses, params, rec["device_kernels_per_step"],
                   {k: float(v) for k, v in m.items() if v.ndim == 0},
                   _device_names(torch, prof))
        del state, step_fn, prof
        torch.cuda.empty_cache()
    return out


def obs_parity_metrics(torch, cfg_full, model_lib, step_lib):
    """(c) 2 layers at full width, f32, the f32 wire, obs on: one train
    step on the card and on the CPU from the same params and batch; the
    in-graph metrics within OBS_METRIC_ATOL."""
    import dataclasses

    from repro_torch.configs.base import ObsConfig, OptimizerConfig
    from repro_torch.data.synthetic import SyntheticLMDataset
    cfg = with_wire(cfg_full.replace(num_super_blocks=2, dtype="float32"),
                    wire_dtype="float32", wire_format="bf16")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                              obs=ObsConfig(enabled=True)))
    opt = OptimizerConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    batch = SyntheticLMDataset(cfg.vocab_size, 64, 2).batch_at(0)
    cpu = torch.device("cpu")
    params_cpu = model_lib.init_params(cfg, seed=5, device=cpu)
    got = {}
    for dev in (torch.device("cuda"), cpu):
        params = tree_to(params_cpu, dev) if dev.type == "cuda" \
            else params_cpu
        state = step_lib.TrainState(params, step_lib.adamw_init(params, opt))
        _, m = step_lib.make_train_step(cfg, opt)(
            state, step_lib.batch_to_device(batch, dev))
        got[dev.type] = {k: float(v) for k, v in m.items()
                         if k.startswith("obs_")}
    return got


def phase_obs(torch, train, serve, registry, cfg, model_lib, step_lib,
              data_lib, clustering, moe_lib, summarize, kernels, port_names,
              train_profile):
    """Phase obs: (a) the launcher's --profile, (b) obs off against on,
    (c) the in-graph metrics, (d) serve --bench-json."""
    import shutil

    from repro_torch.obs import benchrow
    workdir = ROOT / f".obs-{os.getpid()}"
    workdir.mkdir()
    try:
        m = obs_launcher(torch, train, registry, kernels, port_names,
                         workdir, "bf16", OBS_STEPS, OBS_PROFILE)
        torch.cuda.empty_cache()
        obs_launcher(torch, train, registry, kernels, port_names, workdir,
                     "int8", 3, 1)
        torch.cuda.empty_cache()

        runs = obs_on_off(torch, cfg, step_lib, data_lib, summarize)
        (l_off, p_off, k_off, _, n_off), (l_on, p_on, k_on, m_on, _) = \
            runs[False], runs[True]
        same = [_same_bits(torch, a, b) for a, b in zip(p_off, p_on)]
        want = train_profile["device_kernels_per_step"]
        log(f"[obs] obs off {l_off} obs on {l_on}; params bit-equal "
            f"{sum(same)}/{len(same)}; kernels per step off {k_off} on "
            f"{k_on} (obs adds {k_on - k_off}); the training profile's "
            f"{want}")
        if l_off != l_on or not all(same):
            raise AssertionError("obs on changed the losses or the params")
        del p_off, p_on, runs
        for _ in range(OBS_REMEASURES):
            if k_off == want:
                break
            # a profile of 30 thousand device events can lose or gain a
            # few at its edges (PR 23's final run: +74, then -2, each time
            # AdamW's first kernels); the obs-off step is measured again,
            # and one count must equal the training profile's
            names = train_profile["kernel_names"]
            diff = {n: n_off[n] - names[n] for n in set(n_off) | set(names)
                    if n_off[n] != names[n]}
            _, _, k_off, _, n_off = obs_on_off(torch, cfg, step_lib,
                                               data_lib, summarize,
                                               settings=(False,))[False]
            log(f"[obs] kernels differing by name {diff}; obs off again: "
                f"{k_off} kernels a step")
        if k_off != want:
            raise AssertionError(f"obs off runs {k_off} kernels a step, the "
                                 f"training profile {want}")
        torch.cuda.empty_cache()

        # (c) the Eq. 5 rate from the host's byte counts, in f32 as the
        # in-graph counters add them
        moe = cfg.moe
        n_moe = cfg.num_layers
        cap = moe_lib.expert_capacity(4 * 1024, moe.num_experts, moe.top_k,
                                      moe.capacity_factor)
        slots = moe_lib.num_lsh_slots(cap, moe.lsh.compression_rate)
        wire = clustering.wire_bytes(moe.num_experts, slots, cfg.d_model,
                                     moe.lsh.wire_format,
                                     wire_dtype=torch.bfloat16)
        raw = moe.num_experts * cap * cfg.d_model * 2
        want = float(torch.tensor(2.0 * wire * n_moe, dtype=torch.float32)
                     / torch.tensor(2.0 * raw * n_moe, dtype=torch.float32))
        log(f"[obs] obs_compression_rate {m['obs_compression_rate']} "
            f"(the launcher), {m_on['obs_compression_rate']} (full depth), "
            f"host wire / raw bytes {want} ({wire} / {raw} a leg); "
            f"load imbalance {m['obs_load_imbalance']}, drop fraction "
            f"{m['obs_drop_fraction']}, slot occupancy "
            f"{m['obs_slot_occupancy']}")
        if m["obs_compression_rate"] != want \
                or m_on["obs_compression_rate"] != want:
            raise AssertionError("obs_compression_rate is not the host's "
                                 "wire / raw bytes")
        got = obs_parity_metrics(torch, cfg, model_lib, step_lib)
        log(f"[obs] 2 layers f32, f32 wire: cuda {got['cuda']} cpu "
            f"{got['cpu']}")
        bad = {k: (got["cuda"][k], got["cpu"][k]) for k in (
            "obs_load_imbalance", "obs_drop_fraction", "obs_slot_occupancy")
            if abs(got["cuda"][k] - got["cpu"][k]) > OBS_METRIC_ATOL}
        if bad:
            raise AssertionError(f"in-graph metrics, card against CPU: {bad}")

        # (d) serve --bench-json at the full config
        d = workdir / "bench"
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = serve.main(["--arch", ARCH, "--bench-json", str(d),
                             "--bench-name", "serve_h100"])
        if rc != 0:
            raise AssertionError(f"serve.main --bench-json returned {rc}")
        rows = benchrow.load_rows(str(benchrow.bench_file(str(d),
                                                          "serve_h100")))
        if len(rows) != 1:
            raise AssertionError(f"bench file holds {len(rows)} valid rows")
        benchrow.validate_row(rows[0], name="serve_h100")
        r = rows[0]["metrics"]
        log(f"[obs] serve bench row: tokens/s {r['tokens_per_s']}, p50 "
            f"{r['latency_p50_s']} s, p99 {r['latency_p99_s']} s; context "
            f"{rows[0]['context']}")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


# ----------------------------------------------------------- 13. pipeline --

PIPE_ARCH = "qwen3-moe-30b-a3b"
# 4 of its 48 super-blocks: 3.1 G params, about 50 GB with AdamW's f32
# moments and the f32 gradient accumulators; all 48 (30.5 G params) do not
# train on one card
PIPE_SUPER_BLOCKS = 4
PIPE_STAGES = PIPE_MICROBATCHES = 4
PIPE_BATCH, PIPE_SEQ, PIPE_STEPS = 8, 512, 2


def config_kernels(torch, mods, ref, moe_lib, hashing, cfg, T, label,
                   seed, wire=True):
    """The path's kernels at a config's own shapes, T tokens through one
    of its MoE layers: the routing and LSH kernels and their backwards
    (and the int8 wire kernels when ``wire``), against their plain
    versions as phase kernels holds them."""
    moe = cfg.moe
    C = moe_lib.expert_capacity(T, moe.num_experts, moe.top_k,
                                moe.capacity_factor)
    p = make_plan(torch, ref, T=T, k=moe.top_k, E=moe.num_experts, C=C,
                  H=cfg.d_model, skew=True, bad_frac=0.01, seed=seed)
    res = check_kernels(torch, mods["token_position"],
                        mods["scatter_gather"], ref, p, label)
    S = moe_lib.num_lsh_slots(C, moe.lsh.compression_rate)
    q = lsh_inputs(torch, ref, hashing, p, S, L=moe.lsh.num_hashes,
                   Dr=moe.lsh.rotation_dim, seed=seed + 1)
    res.update(check_lsh_kernels(torch, mods["lsh_hash"],
                                 mods["segment_centroid"],
                                 mods["residual_apply"], ref, q, label))
    check_backwards(torch, mods["dispatch"], ref, p, q)
    if wire:
        res.update(check_wire_kernels(torch, mods, ref, p, q, label,
                                      "int8"))
    return res


def pipeline_run(torch, cfg, step_lib, pipe_lib, data_lib, kernels, tag):
    """PIPE_STEPS steps of the 1F1B step ("1f1b", PIPE_STAGES stages) or
    of the accumulation ("accumulation", microbatches of the same rows)
    from seed 0 -> (losses, clip norms, step ms, peak bytes, launches a
    step, the params after the last step, copied to the host so that the
    next run's peak is its own)."""
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.optim.adam import leaves
    dev = torch.device("cuda")
    opt = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=8)
    ds = data_lib.SyntheticLMDataset(cfg.vocab_size, PIPE_SEQ, PIPE_BATCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    state = step_lib.init_train_state(cfg, opt, seed=0, device=dev)
    if tag == "1f1b":
        step_fn = pipe_lib.make_pipeline_train_step(cfg, opt, use_lsh=True,
                                                    stages=PIPE_STAGES)
    else:
        step_fn = step_lib.make_train_step(
            cfg, opt, use_lsh=True,
            microbatch=PIPE_BATCH // PIPE_MICROBATCHES)
    for k in kernels:
        k.launches = 0
    losses, norms, dts = [], [], []
    for s in range(PIPE_STEPS):
        batch = step_lib.batch_to_device(ds.batch_at(s), dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step_fn(state, batch)
        losses.append(met["loss"].item())
        norms.append(met["grad_norm"].item())
        torch.cuda.synchronize()
        dts.append((time.perf_counter() - t0) * 1e3)
    launches = {k.name: k.launches / PIPE_STEPS for k in kernels}
    peak = torch.cuda.max_memory_allocated(dev)
    params = [p.detach().cpu() for p in leaves(state.params)]
    del state, step_fn
    return losses, norms, dts, peak, launches, params


def phase_pipeline(torch, mods, ref, moe_lib, hashing, step_lib, data_lib,
                   kernels, path_kernels):
    """Phase pipeline: the path's kernels at qwen3-moe-30b-a3b's shapes,
    then the config at full width and PIPE_SUPER_BLOCKS super-blocks,
    bf16, LSH on, PIPE_BATCH x PIPE_SEQ tokens: the 1F1B step with
    PIPE_STAGES stages against the accumulation over PIPE_MICROBATCHES
    microbatches, from one seed, with the bf16 and the int8 wires; the
    losses, the clip norms and every param after the last step must be
    bit-equal, and each run must launch every kernel of its path, the
    same number of times.  Returns the records."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import stage_bounds
    from repro_torch.runtime import pipeline_schedule as pipe_lib
    full = get_config(PIPE_ARCH)
    cfg = full.replace(num_super_blocks=PIPE_SUPER_BLOCKS,
                       pipeline_microbatches=PIPE_MICROBATCHES)
    log(f"[pipeline] {PIPE_ARCH} at full width (d_model {cfg.d_model}, "
        f"{cfg.num_heads} heads of {cfg.resolved_head_dim} with "
        f"{cfg.num_kv_heads} KV heads, {cfg.moe.num_experts} experts top-"
        f"{cfg.moe.top_k} of ffn {cfg.moe.expert_ffn_dim}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}), depth cut from "
        f"{full.num_super_blocks} to {PIPE_SUPER_BLOCKS} super-blocks for "
        "memory (AdamW's f32 moments and the f32 accumulators)")
    # one microbatch through a MoE layer (2 x 512 tokens, top-8 of E = 128,
    # H = 2048), with the int8 wire kernels
    res = config_kernels(torch, mods, ref, moe_lib, hashing, cfg,
                         PIPE_BATCH // PIPE_MICROBATCHES * PIPE_SEQ,
                         "pipeline", 31)
    sched = pipe_lib.build_1f1b(PIPE_STAGES, PIPE_MICROBATCHES)
    log(f"[pipeline] schedule: {PIPE_STAGES} stages x {PIPE_MICROBATCHES} "
        f"microbatches, {sched.ticks} ticks, bubble fraction "
        f"{sched.bubble_fraction()}; stage bounds "
        f"{stage_bounds(PIPE_SUPER_BLOCKS, PIPE_STAGES)}")
    for s in range(PIPE_STAGES):
        log(f"[pipeline] stage {s}: " + " ".join(
            "--" if u is None else f"{u[0]}{u[1]}" for u in sched.grid[s]))
    out = {}
    for fmt in ("bf16", "int8"):
        c = with_wire(cfg, wire_format=fmt)
        runs = {}
        for tag in ("1f1b", "accumulation"):
            t_run = time.time()
            losses, norms, dts, peak, launches, params = pipeline_run(
                torch, c, step_lib, pipe_lib, data_lib, kernels, tag)
            rec = dict(losses=losses, grad_norms=norms, step_ms=dts,
                       peak_memory_gb=peak / 1e9,
                       launches_per_step=launches)
            log(f"[pipeline] {fmt} wire, {tag} ({time.time() - t_run:.1f} "
                "s): " + json.dumps(rec, sort_keys=True))
            never = [k.name for k in path_kernels[fmt]
                     if launches[k.name] == 0]
            if never:
                raise AssertionError(f"pipeline {fmt} {tag}: kernels never "
                                     f"launched {never}")
            if not all(math.isfinite(v) for v in losses + norms):
                raise AssertionError(f"pipeline {fmt} {tag}: not finite "
                                     f"{losses} {norms}")
            runs[tag] = (rec, params)
            del params
        (a, pa), (b, pb) = runs["1f1b"], runs["accumulation"]
        n_same = sum(x.dtype == y.dtype and bool(torch.equal(x, y))
                     for x, y in zip(pa, pb))
        same = (a["losses"] == b["losses"] and a["grad_norms"]
                == b["grad_norms"] and n_same == len(pa) == len(pb))
        log(f"[pipeline] {fmt} wire: 1F1B against the accumulation after "
            f"{PIPE_STEPS} steps: losses, clip norms and {n_same} of "
            f"{len(pa)} param leaves bit-equal; launches a step "
            f"{'equal' if a['launches_per_step'] == b['launches_per_step'] else 'DIFFER'}")
        if not same:
            raise AssertionError(f"{fmt} wire: the 1F1B step is not "
                                 "bit-equal to the accumulation")
        if a["launches_per_step"] != b["launches_per_step"]:
            raise AssertionError(f"{fmt} wire: the 1F1B step launches the "
                                 "kernels other times than the accumulation")
        out[fmt] = a
        del runs, pa, pb
        torch.cuda.empty_cache()
    record = {"kernels": [
        {"name": k.name,
         "launches": {f: out[f]["launches_per_step"][k.name]
                      for f in out},
         **({key: res[k.name][key] for key in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")} if k.name in res else {})}
        for k in kernels]}
    log("[pipeline] kernels at this config's shapes, launches a 1F1B step "
        "by wire: " + json.dumps(record))
    return out


# ------------------------------------------------------------- 14. hybrid --

HYB_ARCH = "jamba-1.5-large-398b"
# layout entries 4-5 of 8 (from 1): (MAMBA, MOE), (ATTN, DENSE)
HYB_ENTRIES = (3, 5)
HYB_PREFILL = (4, 2048)
HYB_TRAIN = (2, 2048)
HYB_SERVE = dict(requests=8, batch_slots=4, prompt_len=16, gen=16)
HYB_RUNS = 3                     # forward + backward; the 2nd and 3rd timed
# The card against the CPU at the smoke config, f32 wire: the Mamba layers'
# gradients are sums over the sequence that cancel, and carry last-bit
# differences further than granite's layers do (moving the embedding by
# 1e-7 relative moves the CPU's own worst gradient leaf by 2.9e-5 to 6.2e-4
# relative L2, by params seed and batch), and a first AdamW step moves a
# param whose tiny gradient flipped sign by a whole lr.  Slots and the loss
# keep phase train_parity's rules; gradients and params are held to these.
# scripts/hybrid_parity_sweep.py reads the card's gaps on several seeds and
# under faults of the Mamba path; PERF.md gives the readings that place
# these bounds between the two.
HYB_GRAD_RTOL = 2e-3
HYB_PARAM_RTOL = 1e-4


def hybrid_window(full):
    lo, hi = HYB_ENTRIES
    return full.replace(layout=full.layout[lo:hi], num_super_blocks=1)


def hybrid_kernels(torch, mods, ref, moe_lib, hashing, cfg):
    """The path's kernels at jamba's shapes: the training forward's MoE
    layer (2 x 2048 tokens: F = 8192, E = 16, C = 640, S = 128, H = 8192,
    L = 6, Dr = 64; routing, LSH and the backwards) and the decode step's
    (4 slots, top-2 of 16, C = 4)."""
    moe = cfg.moe
    res = config_kernels(torch, mods, ref, moe_lib, hashing, cfg,
                         HYB_TRAIN[0] * HYB_TRAIN[1], "hybrid", 41,
                         wire=False)
    slots = HYB_SERVE["batch_slots"]
    cap = max(4, math.ceil(slots * moe.top_k / moe.num_experts * 2))
    decode = make_plan(torch, ref, T=slots, k=moe.top_k, E=moe.num_experts,
                       C=cap, H=cfg.d_model, skew=False, bad_frac=0.0,
                       seed=43)
    dec = check_kernels(torch, mods["token_position"],
                        mods["scatter_gather"], ref, decode, "hybrid decode")
    return res, dec


def hybrid_serve(torch, model_lib, serve, kernels, routing_kernels,
                 lsh_kernels, cfg, params, n_moe):
    """Prefill of HYB_PREFILL tokens (a first call, then a timed one),
    then the serve loop on ``cfg``: each routing kernel once a MoE layer
    a decode step, no LSH kernel."""
    dev = torch.device("cuda")
    B, S = HYB_PREFILL
    tokens = torch.randint(0, cfg.vocab_size, (B, S), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(7))
    for k in kernels:
        k.launches = 0
    logits, _ = model_lib.prefill(params, cfg, {"tokens": tokens})
    ran = {k.name: k.launches for k in kernels}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, info = model_lib.prefill(params, cfg, {"tokens": tokens})
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if tuple(logits.shape) != (B, 1, cfg.vocab_size) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits {tuple(logits.shape)} not "
                             "finite or of the wrong shape")
    never = [k.name for k in routing_kernels + lsh_kernels
             if ran[k.name] == 0]
    if never:
        raise AssertionError(f"prefill (LSH on) never launched {never}")
    log(f"[hybrid] prefill {B} x {S} tokens: {dt * 1e3:.3f} ms "
        f"({B * S / dt:.1f} tokens/s), position {info['position']}, "
        f"launches {ran}")
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    s = serve.serve_loop(cfg, dev, params=params, **HYB_SERVE)
    launches = {k.name: k.launches for k in kernels}
    steps = math.ceil(HYB_SERVE["requests"] / HYB_SERVE["batch_slots"]) \
        * (HYB_SERVE["prompt_len"] + HYB_SERVE["gen"])
    want = n_moe * steps
    routing = {k.name for k in routing_kernels}
    bad = {n: c for n, c in launches.items()
           if c != (want if n in routing else 0)}
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"[hybrid] serve: tokens/s {s['tokens_per_s']:.3f}, p50 "
        f"{s['latency_p50_s']:.4f} s, p99 {s['latency_p99_s']:.4f} s, "
        f"peak memory {peak / 1e9:.2f} GB; launches {launches} (want "
        f"{want} = {n_moe} MoE layer(s) x {steps} decode steps)")
    if bad:
        raise AssertionError(f"kernel launches on the serve path: {bad}")
    if s["tokens"] != HYB_SERVE["requests"] * HYB_SERVE["gen"] or not all(
            math.isfinite(s[k]) and s[k] > 0 for k in (
                "tokens_per_s", "latency_p50_s", "latency_p99_s")):
        raise AssertionError(f"serve summary wrong: {s}")
    return dict(prefill_ms=dt * 1e3, prefill_tokens_per_s=B * S / dt,
                tokens_per_s=s["tokens_per_s"],
                latency_p50_s=s["latency_p50_s"],
                latency_p99_s=s["latency_p99_s"], peak_memory_gb=peak / 1e9,
                launches=launches)


def hybrid_fwd_bwd(torch, model_lib, step_lib, data_lib, kernels,
                   path_kernels, cfg, params):
    """loss_fn and its backward (no optimizer step) over HYB_TRAIN
    tokens, LSH on, HYB_RUNS times; the 2nd and later timed."""
    from repro_torch.optim.adam import leaves
    dev = torch.device("cuda")
    B, S = HYB_TRAIN
    batch = step_lib.batch_to_device(
        data_lib.SyntheticLMDataset(cfg.vocab_size, S, B).batch_at(0), dev)
    train = [p for p in leaves(params) if p.is_floating_point()]
    for p in train:
        p.requires_grad_(True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    dts, losses = [], []
    for r in range(HYB_RUNS):
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = model_lib.loss_fn(params, cfg, batch, use_lsh=True)
        grads = torch.autograd.grad(loss, train, allow_unused=True)
        torch.cuda.synchronize()
        dts.append((time.perf_counter() - t0) * 1e3)
        launches = {k.name: k.launches for k in kernels}
        losses.append(float(loss.detach()))
        n_none = sum(g is None for g in grads)
        bad = [i for i, g in enumerate(grads)
               if g is not None and not bool(torch.isfinite(g).all())]
        del grads, loss
        if bad or not math.isfinite(losses[-1]):
            raise AssertionError(f"hybrid fwd + bwd run {r}: loss "
                                 f"{losses[-1]}, non-finite gradients {bad}")
        never = [k.name for k in path_kernels if launches[k.name] == 0]
        if never:
            raise AssertionError(f"hybrid fwd + bwd never launched {never}")
    for p in train:
        p.requires_grad_(False)
    peak = torch.cuda.max_memory_allocated(dev)
    rec = dict(losses=losses, ms=dts, timed_ms=dts[1:],
               peak_memory_gb=peak / 1e9, launches_per_step=launches,
               grads_none=n_none, grads=len(train))
    log(f"[hybrid] forward + backward {B} x {S} tokens, LSH on, bf16: "
        + json.dumps(rec, sort_keys=True))
    return rec


def hybrid_parity(torch, model_lib, step_lib, clustering, lh, kernels,
                  path_kernels, smoke):
    """jamba's smoke config in f32 on the card and on the CPU: one train
    step per wire (phase train_parity's rules), and the card's
    teacher-forced decode against its forward.  With the f32 wire the
    gradients and params are held to HYB_GRAD_RTOL / HYB_PARAM_RTOL (see
    there), the slots and the loss to phase train_parity's rules."""
    from repro_torch.configs.base import MOE, OptimizerConfig
    from repro_torch.data.synthetic import SyntheticLMDataset
    opt = OptimizerConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    n_moe = sum(f == MOE for _, f in smoke.layout) * smoke.num_super_blocks
    for wire in ("float32", "bfloat16"):
        cfg = with_wire(smoke, wire_dtype=wire)
        batch = SyntheticLMDataset(cfg.vocab_size, 64, 2).batch_at(0)
        a, b = _parity_runs(torch, model_lib, step_lib, clustering, kernels,
                            {k.name for k in path_kernels}, cfg, opt, batch)
        n_diff, margin, loss_rel, g_rel, p_rel = _parity_stats(
            torch, lh, a, b, n_moe)
        log(f"[hybrid] parity, smoke f32, wire {wire}: slot ids differing "
            f"per record {n_diff}; smallest near-tie margin {margin:.3g}; "
            f"loss cuda {a['loss']} cpu {b['loss']} (rel {loss_rel:.3g}); "
            f"worst gradient rel L2 {g_rel:.3g}; worst param-after-AdamW "
            f"rel L2 {p_rel:.3g}; TF32 off"
            + (f"; bounds {HYB_GRAD_RTOL} / {HYB_PARAM_RTOL}"
               if wire == "float32" else ""))
        if wire == "float32":
            ok = (not any(n_diff) and loss_rel <= LOSS_RTOL
                  and g_rel <= HYB_GRAD_RTOL and p_rel <= HYB_PARAM_RTOL)
        else:                                  # as phase train_parity
            ok = n_diff[0] == 0 and loss_rel <= BF16_WIRE_LOSS_RTOL
        if not ok:
            raise AssertionError(f"hybrid smoke, wire {wire}: CUDA and CPU "
                                 "train steps disagree")
    dev = torch.device("cuda")
    params = model_lib.init_params(smoke, seed=6, device=dev)
    tokens = torch.randint(0, smoke.vocab_size, (2, 16), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(8))
    with torch.no_grad():
        full, _ = model_lib.forward(params, smoke, tokens, use_lsh=False)
    state = model_lib.init_decode_state(smoke, 2, 16, device=dev)
    outs = []
    for i in range(16):
        logits, state = model_lib.decode_step(params, smoke, state,
                                              tokens[:, i:i + 1])
        outs.append(logits)
    err = float((torch.cat(outs, 1) - full).abs().max())
    log(f"[hybrid] decode against the forward on the card (smoke f32, LSH "
        f"off, 2 x 16): max |diff| {err} (atol {PARITY_ATOL})")
    if not err <= PARITY_ATOL:
        raise AssertionError("the card's decode disagrees with its forward")


def phase_hybrid(torch, mods, ref, moe_lib, hashing, model_lib, step_lib,
                 data_lib, serve, clustering, kernels, routing_kernels,
                 lsh_kernels):
    """Phase hybrid: jamba-1.5-large-398b's Mamba-2 + MoE path.  The
    path's kernels at its shapes; the full-width window (layout entries
    HYB_ENTRIES, one super-block, bf16, seeded random weights): prefill
    and serving, then forward + backward with LSH on; the smoke config
    on the card against the CPU.  Returns the records."""
    from repro_torch.configs.base import MOE, param_count
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.optim.adam import leaves
    t_phase = time.time()
    full = get_config(HYB_ARCH)
    cfg = hybrid_window(full)
    one = full.replace(num_super_blocks=1)
    lo, hi = HYB_ENTRIES
    log(f"[hybrid] {HYB_ARCH} at full width (d_model {cfg.d_model}, Mamba-2 "
        f"d_inner {cfg.ssm.expand * cfg.d_model} of {cfg.ssm.head_dim}-wide "
        f"heads, d_state {cfg.ssm.d_state}, chunk {cfg.ssm.chunk_size}; "
        f"{cfg.num_heads} heads with {cfg.num_kv_heads} KV heads; "
        f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k} of ffn "
        f"{cfg.moe.expert_ffn_dim}; vocab {cfg.vocab_size}; {cfg.dtype}), "
        f"depth cut from {full.num_layers} layers to layers {lo + 1}-{hi} "
        f"of the layout ({', '.join('+'.join(e) for e in cfg.layout)}): one "
        f"super-block is {param_count(one) * 2 / 1e9:.1f} GB, the window "
        f"{param_count(cfg) * 2 / 1e9:.1f} GB")
    res, dec = hybrid_kernels(torch, mods, ref, moe_lib, hashing, cfg)
    torch.cuda.empty_cache()
    log(f"[time] hybrid kernels done at {time.time() - t_phase:.1f} s of "
        "the phase")
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    params = model_lib.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in leaves(params))
    log(f"[hybrid] params: {n_params} ({param_count(cfg)} by param_count), "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB on the card, made "
        f"in {time.time() - t0:.1f} s")
    n_moe = sum(f == MOE for _, f in cfg.layout) * cfg.num_super_blocks
    served = hybrid_serve(torch, model_lib, serve, kernels, routing_kernels,
                          lsh_kernels, cfg, params, n_moe)
    trained = hybrid_fwd_bwd(torch, model_lib, step_lib, data_lib, kernels,
                             routing_kernels + lsh_kernels, cfg, params)
    del params
    torch.cuda.empty_cache()
    hybrid_parity(torch, model_lib, step_lib, clustering, mods["lsh_hash"],
                  kernels, routing_kernels + lsh_kernels,
                  get_smoke_config(HYB_ARCH).replace(dtype="float32"))
    record = {"kernels": [
        {"name": k.name, "launches": trained["launches_per_step"][k.name],
         **({key: res[k.name][key] for key in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")} if k.name in res else {}),
         **({"decode_ms": dec[k.name]["ms"]} if k.name in dec else {})}
        for k in kernels]}
    log("[hybrid] kernels at this config's shapes, launches a forward + "
        "backward: " + json.dumps(record))
    dt = time.time() - t_phase
    log(f"[hybrid] phase time {dt:.1f} s")
    return dict(serve=served, train=trained, seconds=dt)


# ----------------------------------------------------------------- 15. tp --

TP_X = (2, 2048, 8192)           # jamba's residual stream, bf16
TP_W = (8192, 16384)             # its Mamba's d_model x d_inner projections
TP_REPS = 10
# where the mesh path's gradients are not bit-equal to the mesh-free ones
TP_GRAD_RTOL = 1e-6
# the xLSTM mixers and the encoder-decoder with tensor parallelism on
# (dp_only off) at full width and depth, on the (1, 1) mesh
TP_MIXER_ARCHS = ("xlstm-350m", "whisper-base")
TP_MIXER_TRAIN = (2, 512)        # rows x tokens (whisper: x frames too)
TP_MIXER_STEPS = 8               # teacher-forced decode steps
TP_MIXER_CACHE = 64
# whisper runs in f32: its cross-attention gathers the encoder's output
# once for a layer's keys and values, so the output's gradient adds each
# layer's pair before adding it to the other layers' terms, where the
# mesh-free backward adds the terms one by one; in bf16 the two groupings
# round apart (6.7e-3 rel L2 at the smoke config on the CPU), in f32 they
# agree within TP_GRAD_RTOL (3.4e-7 there)
TP_MIXER_F32 = ("whisper-base",)


def _tp_case(torch, name, tp_fn, free_fn, inputs, ct):
    """One helper on the one-rank model axis against its mesh-free op:
    forward and the input gradients bit-equal; forward and forward +
    backward timed for both."""
    xs = [t.clone().requires_grad_(True) for t in inputs]
    outs = {}
    for tag, fn in (("tp", tp_fn), ("free", free_fn)):
        y = fn(*xs)
        outs[tag] = (y.detach(), torch.autograd.grad(y, xs, grad_outputs=ct))
    (y_tp, g_tp), (y_free, g_free) = outs["tp"], outs["free"]
    same = _same_bits(torch, y_tp, y_free) and all(
        _same_bits(torch, a, b) for a, b in zip(g_tp, g_free))
    rec = {"name": name, "bit_equal": same,
           "inputs": [list(t.shape) for t in inputs]}
    for tag, fn in (("tp", tp_fn), ("free", free_fn)):
        with torch.no_grad():
            rec[f"{tag}_fwd_ms"] = time_ms(torch, lambda: fn(*inputs),
                                           reps=TP_REPS)
        rec[f"{tag}_fwd_bwd_ms"] = time_ms(
            torch, lambda: torch.autograd.grad(fn(*xs), xs, grad_outputs=ct),
            reps=TP_REPS)
    log(f"[tp] {name}: " + json.dumps(rec, sort_keys=True))
    if not same:
        raise AssertionError(f"{name} on a one-rank model axis is not "
                             "bit-equal to the mesh-free op")
    return rec


def tp_helpers(torch, tp, mesh):
    """sp_gather, tp_in_project and tp_project at jamba's widths (x [2,
    2048, 8192] bf16, w [8192, 16384]) against the copy and the products
    they stand for."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(23)

    def r(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(torch.bfloat16)

    x, w = r(TP_X), r(TP_W, TP_W[0] ** -0.5)
    y, w_out = r(TP_X[:2] + (TP_W[1],)), r(TP_W[::-1], TP_W[1] ** -0.5)
    return [
        _tp_case(torch, "sp_gather", lambda a: tp.sp_gather(a, mesh),
                 lambda a: a * 1, [x], r(TP_X)),
        _tp_case(torch, "tp_in_project",
                 lambda a, b: tp.tp_in_project(
                     a, [b], mesh, [(("data",), ("model",))])[0],
                 lambda a, b: a @ b, [x, w], r(TP_X[:2] + (TP_W[1],))),
        _tp_case(torch, "tp_project",
                 lambda a, b: tp.tp_project(a, b, mesh,
                                            (("model",), ("data",))),
                 lambda a, b: a @ b, [y, w_out], r(TP_X))]


def _grads_rel(torch, a, b):
    """The worst relative L2 distance of two gradient lists (card)."""
    worst = 0.0
    for x, y in zip(a, b):
        if y is not None:
            y = y.to(x.device).double()
            worst = max(worst, float((x.double() - y).norm()
                                     / y.norm().clamp_min(1e-30)))
    return worst


def tp_window(torch, model_lib, step_lib, data_lib, kernels, path_kernels,
              mesh):
    """jamba's window (layout entries HYB_ENTRIES, full width, bf16):
    loss_fn and its backward at HYB_TRAIN tokens with LSH on, mesh-free
    and on the (1, 1) mesh, whose Mamba layer runs runtime/tp.py over a
    one-rank group; loss and gradients bit-equal (digests), every kernel
    of the path launched on the mesh run.  Where they are not bit-equal,
    both runs again with the mesh-free gradients kept on the host, each
    leaf within TP_GRAD_RTOL."""
    from repro_torch.configs.registry import get_config
    from repro_torch.optim.adam import leaves
    dev = torch.device("cuda")
    cfg = hybrid_window(get_config(HYB_ARCH))
    params = model_lib.init_params(cfg, seed=0, device=dev)
    B, S = HYB_TRAIN
    batch = step_lib.batch_to_device(
        data_lib.SyntheticLMDataset(cfg.vocab_size, S, B).batch_at(0), dev)
    train = [p for p in leaves(params) if p.is_floating_point()]
    for p in train:
        p.requires_grad_(True)

    def run(m, keep=None):
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = model_lib.loss_fn(params, cfg, batch, use_lsh=True,
                                    mesh=m)
        grads = torch.autograd.grad(loss, train, allow_unused=True)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        loss = loss.detach()
        bad = [i for i, g in enumerate(grads)
               if g is not None and not bool(torch.isfinite(g).all())]
        if bad or not math.isfinite(float(loss)):
            raise AssertionError(f"tp window: loss {float(loss)}, non-finite "
                                 f"gradients {bad}")
        rec = dict(loss=float(loss), loss_bits=_digest(torch, [loss]),
                   ms=ms, launches={k.name: k.launches for k in kernels},
                   digest=_digest(torch, [g for g in grads
                                          if g is not None]))
        if keep is not None:
            keep.extend(None if g is None else g.detach().cpu()
                        for g in grads)
        return rec, grads

    runs = {}
    for tag, m in (("mesh-free", None), ("mesh (1, 1)", mesh)):
        rec, grads = run(m)
        del grads
        runs[tag] = rec
        log(f"[tp] window {tag}: loss {rec['loss']}, fwd + bwd "
            f"{rec['ms']:.3f} ms, launches {rec['launches']}")
    a, b = runs["mesh-free"], runs["mesh (1, 1)"]
    never = [k.name for k in path_kernels if b["launches"][k.name] == 0]
    if never:
        raise AssertionError(f"tp window: kernels never launched {never}")
    same = a["loss_bits"] == b["loss_bits"] and a["digest"] == b["digest"]
    worst = 0.0
    if not same:
        kept = []
        run(None, keep=kept)
        _, grads = run(mesh)
        worst = _grads_rel(torch, grads, kept)
        del grads, kept
        log(f"[tp] window: the mesh path is not bit-equal to the mesh-free "
            f"one (loss {b['loss']} against {a['loss']}); the TP norm sums "
            f"each rank's mean of squares over the model axis and the "
            f"gathered projections accumulate x's gradient through one "
            f"gather, so the order of operations may differ: worst gradient "
            f"rel L2 {worst:.3g} (bound {TP_GRAD_RTOL})")
        if abs(b["loss"] - a["loss"]) > TP_GRAD_RTOL * abs(a["loss"]) \
                or worst > TP_GRAD_RTOL:
            raise AssertionError("tp window: the mesh path disagrees with "
                                 "the mesh-free path")
    log(f"[tp] window: mesh (1, 1) against mesh-free: loss and all "
        f"{len(a['digest'])} gradient leaves "
        f"{'bit-equal' if same else 'within the bound'}")
    for p in train:
        p.requires_grad_(False)
    del params
    torch.cuda.empty_cache()
    return dict(runs=runs, bit_equal=same, worst_rel=worst)


def tp_mixer(torch, model_lib, step_lib, data_lib, mesh, arch):
    """``arch`` at full width and depth with tensor parallelism on
    (``dp_only`` off; seeded weights, bf16 but TP_MIXER_F32) on the (1, 1)
    mesh against the mesh-free path: loss_fn and its backward at
    TP_MIXER_TRAIN (whisper's frames as many as its tokens), the loss and
    every gradient bit-equal
    (digests), or else within TP_GRAD_RTOL (the gradients compared on the
    host, as tp_window does); then TP_MIXER_STEPS teacher-forced decode
    steps on ``init_decode_state(mesh=)``'s state, the logits and every
    state leaf bit-equal, or else the logits within TP_GRAD_RTOL.  The
    path runs no MoE layer, so no kernel of the port."""
    from repro_torch.configs.registry import get_config
    from repro_torch.optim.adam import leaves
    dev = torch.device("cuda")
    cfg = get_config(arch).replace(dp_only=False)
    if arch in TP_MIXER_F32:
        cfg = cfg.replace(dtype="float32")
    params = model_lib.init_params(cfg, seed=0, device=dev)
    B, S = TP_MIXER_TRAIN
    batch = step_lib.batch_to_device(
        data_lib.SyntheticLMDataset(cfg.vocab_size, S, B).batch_at(0), dev)
    if cfg.encoder_decoder:
        batch["frames"] = torch.randn(
            (B, S, cfg.d_model), device=dev,
            generator=torch.Generator(device=dev).manual_seed(29)).to(
                model_lib.torch_dtype(cfg.dtype))
    train = [p for p in leaves(params) if p.is_floating_point()]
    for p in train:
        p.requires_grad_(True)

    def run(m, keep=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = model_lib.loss_fn(params, cfg, batch, mesh=m)
        grads = torch.autograd.grad(loss, train, allow_unused=True)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        loss = loss.detach()
        bad = [i for i, g in enumerate(grads)
               if g is not None and not bool(torch.isfinite(g).all())]
        if bad or not math.isfinite(float(loss)):
            raise AssertionError(f"[tp] {arch}: loss {float(loss)}, "
                                 f"non-finite gradients {bad}")
        if keep is not None:
            keep.extend(None if g is None else g.detach().cpu()
                        for g in grads)
        return dict(loss=float(loss), loss_bits=_digest(torch, [loss]),
                    ms=ms, digest=_digest(torch, [g for g in grads
                                                  if g is not None])), grads

    runs = {}
    for tag, m in (("mesh-free", None), ("mesh (1, 1)", mesh)):
        runs[tag], grads = run(m)
        del grads
        log(f"[tp] {arch} {tag}: loss {runs[tag]['loss']}, fwd + bwd at "
            f"{B} x {S} {runs[tag]['ms']:.3f} ms")
    a, b = runs["mesh-free"], runs["mesh (1, 1)"]
    same = a["loss_bits"] == b["loss_bits"] and a["digest"] == b["digest"]
    worst = 0.0
    if not same:
        kept = []
        run(None, keep=kept)
        _, grads = run(mesh)
        worst = _grads_rel(torch, grads, kept)
        del grads, kept
        log(f"[tp] {arch}: the mesh path is not bit-equal to the mesh-free "
            f"one (loss {b['loss']} against {a['loss']}): worst gradient "
            f"rel L2 {worst:.3g} (bound {TP_GRAD_RTOL})")
        if abs(b["loss"] - a["loss"]) > TP_GRAD_RTOL * abs(a["loss"]) \
                or worst > TP_GRAD_RTOL:
            raise AssertionError(f"[tp] {arch}: the mesh path disagrees "
                                 "with the mesh-free path")
    for p in train:
        p.requires_grad_(False)
    decode = {}
    tokens = batch["tokens"][:, :TP_MIXER_STEPS]
    for tag, m in (("mesh-free", None), ("mesh (1, 1)", mesh)):
        state = model_lib.init_decode_state(cfg, B, TP_MIXER_CACHE,
                                            device=dev, mesh=m)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = []
        for i in range(TP_MIXER_STEPS):
            lg, state = model_lib.decode_step(params, cfg, state,
                                              tokens[:, i:i + 1], mesh=m)
            logits.append(lg)
        torch.cuda.synchronize()
        decode[tag] = dict(logits=torch.cat(logits, 1), state=state,
                           ms=(time.perf_counter() - t0) * 1e3
                           / TP_MIXER_STEPS)
    da, db = decode["mesh-free"], decode["mesh (1, 1)"]
    same_logits = bool(torch.equal(da["logits"], db["logits"]))
    same_state = all(torch.equal(x[k], y[k]) for x, y in zip(
        da["state"]["layers"], db["state"]["layers"]) for k in x)
    rel = _grads_rel(torch, [db["logits"]], [da["logits"]])
    layout = {k: v for k, v in db["state"]["layout"].items()
              if k not in ("specs", "shapes")}
    log(f"[tp] {arch} decode, {TP_MIXER_STEPS} steps of {B} rows: "
        f"{da['ms']:.2f} / {db['ms']:.2f} ms a step (mesh-free / mesh); "
        f"layout {layout}; logits bit-equal {same_logits} (rel L2 "
        f"{rel:.3g}), every state leaf bit-equal {same_state}")
    if not bool(torch.isfinite(db["logits"]).all()) or not (
            same_logits and same_state) and rel > TP_GRAD_RTOL:
        raise AssertionError(f"[tp] {arch}: the (1, 1) mesh decode "
                             "disagrees with the mesh-free decode")
    log(f"[tp] {arch}: mesh (1, 1) against mesh-free: loss and all "
        f"{len(a['digest'])} gradient leaves "
        f"{'bit-equal' if same else 'within the bound'}")
    del params, decode, da, db
    torch.cuda.empty_cache()
    return dict(runs=runs, bit_equal=same, worst_rel=worst,
                decode_bit_equal=same_logits and same_state,
                decode_rel=rel)


def phase_tp(torch, model_lib, step_lib, data_lib, kernels, path_kernels):
    """Phase tp: one NCCL rank (a HashStore, no network) and a (1, 1) mesh
    whose one-rank model axis runs runtime/tp.py's collectives; the
    helpers at jamba's widths, then the window's loss and gradients
    through the tensor-parallel Mamba against the mesh-free path, then
    the xLSTM mixers' and the encoder-decoder's (``tp_mixer``)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.runtime import tp
    t0 = time.time()
    init_distributed(torch.device("cuda", 0), store=dist.HashStore(),
                     rank=0, world_size=1)
    try:
        mesh = make_mesh(1, 1)
        helpers = tp_helpers(torch, tp, mesh)
        torch.cuda.empty_cache()
        log(f"[time] tp helpers done at {time.time() - t0:.1f} s of the "
            "phase")
        window = tp_window(torch, model_lib, step_lib, data_lib, kernels,
                           path_kernels, mesh)
        log(f"[time] tp window done at {time.time() - t0:.1f} s of the "
            "phase")
        mixers = {arch: tp_mixer(torch, model_lib, step_lib, data_lib, mesh,
                                 arch) for arch in TP_MIXER_ARCHS}
    finally:
        dist.destroy_process_group()
    log(f"[tp] phase time {time.time() - t0:.1f} s")
    return dict(helpers=helpers, window=window, mixers=mixers)


# -------------------------------------------------------------- 16. xlstm --

XL_ARCH = "xlstm-350m"
XL_SERVE = dict(requests=8, batch_slots=4, prompt_len=16, gen=16)
XL_TRAIN = (4, 1024)
XL_STEPS = 3
XL_PARITY_SEQ = 256              # one whole mLSTM chunk
# After one AdamW step each param element moves by about lr * g / (|g| +
# eps): where an element's gradient sums terms that cancel to near zero
# (the gates' w_if and b_gates sum over every token), the two devices'
# last-bit differences become a visible fraction of lr, as in jamba's
# Mamba layers (HYB_PARAM_RTOL).  With the loss and gradients within phase
# train_parity's bounds (PR 23 calls 2 and 4: 8.4e-8 and 9.8e-6), the
# params are held to HYB_PARAM_RTOL (measured 1.02e-5, w_if), and the
# zero-initialised biases (b_if, b_gates), whose value is nothing but that
# update, to XL_ZERO_LEAF_RTOL of their norm (measured 5.35e-4, b_gates).
XL_ZERO_LEAF_RTOL = 1e-2


def xlstm_serve(torch, serve, kernels, cfg):
    dev = torch.device("cuda")
    for k in kernels:
        k.launches = 0
    s = serve.serve_loop(cfg, dev, **XL_SERVE)
    ran = {k.name: k.launches for k in kernels if k.launches}
    log(f"[xlstm] serve: tokens/s {s['tokens_per_s']:.3f}, p50 "
        f"{s['latency_p50_s']:.4f} s, p99 {s['latency_p99_s']:.4f} s")
    if ran:
        raise AssertionError(f"xlstm serving launched port kernels {ran}")
    if s["tokens"] != XL_SERVE["requests"] * XL_SERVE["gen"] or not all(
            math.isfinite(s[k]) and s[k] > 0 for k in (
                "tokens_per_s", "latency_p50_s", "latency_p99_s")):
        raise AssertionError(f"xlstm serve summary wrong: {s}")
    return {k: s[k] for k in ("tokens_per_s", "latency_p50_s",
                              "latency_p99_s")}


def xlstm_train(torch, train):
    B, S = XL_TRAIN
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train.main(["--arch", XL_ARCH, "--batch", str(B), "--seq",
                         str(S), "--steps", str(XL_STEPS), "--log-every",
                         "1"])
    events = _events(buf)
    steps = [e for e in events if e["kind"] == "step"]
    summary = [e for e in events if e["kind"] == "train_summary"]
    for e in steps + summary:
        log("[xlstm] train " + json.dumps(e, sort_keys=True))
    if rc != 0 or len(steps) != XL_STEPS or len(summary) != 1 or not all(
            math.isfinite(e["loss"]) and e["skips"] == 0 for e in steps):
        raise AssertionError(f"xlstm train.main: rc {rc}, steps {steps}")
    return summary[0]


def _device_ms(torch, fn):
    """(device ms, device events) of one call of ``fn`` under a CUDA-only
    profile: the durations of its kernels, copies and sets summed (one
    stream), read from the exported Chrome trace (the profiler's own
    Python event tree costs about 0.2 ms an event, over a minute for a
    step of the xLSTM's 400 thousand)."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    return sum(float(e["dur"]) for e in dev) / 1e3, len(dev)


def xlstm_profile(torch, cfg, step_lib, data_lib, xlstm_lib):
    """One training step under a CUDA-only profile (the first of a new
    state, after train.main's steps in this process: the same work as a
    later one; a capture started just before it may miss a few dozen of
    its first device events, PR 22): device ms and events; and one mLSTM
    and one sLSTM layer's forward, recompute and backward (the block
    checkpoint of remat "dots") at the step's shape, whose device ms
    times the layers of each kind give their share of the step."""
    from torch.utils.checkpoint import checkpoint

    from repro_torch.configs.base import MLSTM, OptimizerConfig
    from repro_torch.models.model import layer_kinds
    from repro_torch.optim.adam import leaves
    dev = torch.device("cuda")
    B, S = XL_TRAIN
    opt = OptimizerConfig()
    state = step_lib.init_train_state(cfg, opt, seed=0, device=dev)
    step_fn = step_lib.make_train_step(cfg, opt)
    ds = data_lib.SyntheticLMDataset(cfg.vocab_size, S, B)
    box = {"state": state}

    def one(s):
        box["state"], met = step_fn(box["state"], step_lib.batch_to_device(
            ds.batch_at(s), dev))
        met["loss"].item()

    t0 = time.perf_counter()
    step_ms, step_kernels = _device_ms(torch, lambda: one(0))
    wall = (time.perf_counter() - t0) * 1e3
    kinds = [m for m, _ in layer_kinds(cfg)]
    out = dict(step_device_ms=step_ms, step_kernels=step_kernels,
               profiled_wall_ms=wall)
    gen = torch.Generator(device=dev).manual_seed(29)
    x = torch.randn((B, S, cfg.d_model), generator=gen, device=dev).to(
        torch.bfloat16).requires_grad_(True)
    ct = torch.randn((B, S, cfg.d_model), generator=gen, device=dev).to(
        torch.bfloat16)
    for kind in sorted(set(kinds)):
        p = box["state"].params["layers"][kinds.index(kind)]["mixer"]
        ws = [t for t in leaves(p) if t.is_floating_point()]
        if kind == MLSTM:
            def mix(h, p=p):
                return xlstm_lib.mlstm_apply(
                    p, h, cfg.resolved_head_dim, cfg.xlstm.chunk_size,
                    cfg.norm_eps)
        else:
            def mix(h, p=p):
                return xlstm_lib.slstm_apply(p, h, cfg.norm_eps)

        def fwd_bwd(mix=mix, ws=ws):
            y = checkpoint(mix, x, use_reentrant=False)
            torch.autograd.grad(y, [x] + ws, grad_outputs=ct)

        fwd_bwd()                                    # warm
        ms, n = _device_ms(torch, fwd_bwd)
        n_layers = kinds.count(kind)
        out[kind] = dict(layer_device_ms=ms, layer_kernels=n,
                         layers=n_layers,
                         share_of_step=ms * n_layers / step_ms)
    log("[xlstm] profiled step (LSH n/a, bf16, "
        f"{B} x {S}): " + json.dumps(out, sort_keys=True))
    del box, state
    torch.cuda.empty_cache()
    return out


def _leaf_names(tree, prefix=""):
    """"a/b/0/c" of every leaf, in leaves() order."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items()
                for n in _leaf_names(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, f"{prefix}{i}/")]
    return [prefix[:-1]]


def xlstm_parity(torch, model_lib, step_lib, clustering, kernels, cfg_full):
    """2 layers (one mLSTM, one sLSTM) at full width in f32: one train
    step on the card and on the CPU, the loss and gradients within phase
    train_parity's f32 bounds, the params after AdamW within
    HYB_PARAM_RTOL and XL_ZERO_LEAF_RTOL (see there); 16 teacher-forced
    decode steps on the card against its forward within PARITY_ATOL."""
    from repro_torch.configs.base import MLSTM, NONE, SLSTM, OptimizerConfig
    from repro_torch.data.synthetic import SyntheticLMDataset
    cfg = cfg_full.replace(layout=((MLSTM, NONE), (SLSTM, NONE)),
                           num_super_blocks=1, dtype="float32")
    opt = OptimizerConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    batch = SyntheticLMDataset(cfg.vocab_size, XL_PARITY_SEQ, 2).batch_at(0)
    a, b = _parity_runs(torch, model_lib, step_lib, clustering, kernels,
                        set(), cfg, opt, batch)

    def rel(u, v):
        return float((u.double() - v.double()).norm()
                     / v.double().norm().clamp_min(1e-30))

    loss_rel = abs(a["loss"] - b["loss"]) / abs(b["loss"])
    g_rel = max(rel(x, y) for x, y in zip(a["grads"], b["grads"])
                if y is not None and y.any())
    # the params _parity_runs started from (its seed): which were zero
    init = model_lib.init_params(cfg, seed=5, device="cpu")
    names = _leaf_names(init)
    zero = [not bool(p.any()) for p in step_lib.leaves(init)]
    worst = {True: (0.0, ""), False: (0.0, "")}
    for x, y, z, name in zip(a["params"], b["params"], zero, names):
        if y.is_floating_point():
            worst[z] = max(worst[z], (rel(x, y), name))
    (p_rel, p_name), (z_rel, z_name) = worst[False], worst[True]
    log(f"[xlstm] parity, 2 layers f32, 2 x {XL_PARITY_SEQ}: loss cuda "
        f"{a['loss']} cpu {b['loss']} (rel {loss_rel:.3g}); worst gradient "
        f"rel L2 {g_rel:.3g}; worst param-after-AdamW rel L2 {p_rel:.3g} "
        f"({p_name}); of the zero-initialised leaves {z_rel:.3g} "
        f"({z_name}); bounds {LOSS_RTOL} / {GRAD_RTOL} / {HYB_PARAM_RTOL} "
        f"/ {XL_ZERO_LEAF_RTOL}; TF32 off")
    if not (loss_rel <= LOSS_RTOL and g_rel <= GRAD_RTOL
            and p_rel <= HYB_PARAM_RTOL and z_rel <= XL_ZERO_LEAF_RTOL):
        raise AssertionError("xlstm: CUDA and CPU train steps disagree")
    dev = torch.device("cuda")
    params = model_lib.init_params(cfg, seed=6, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(8))
    with torch.no_grad():
        full, _ = model_lib.forward(params, cfg, tokens)
    state = model_lib.init_decode_state(cfg, 2, 16, device=dev)
    outs = []
    for i in range(16):
        logits, state = model_lib.decode_step(params, cfg, state,
                                              tokens[:, i:i + 1])
        outs.append(logits)
    err = float((torch.cat(outs, 1) - full).abs().max())
    log(f"[xlstm] decode against the forward on the card (2 layers f32, 2 "
        f"x 16): max |diff| {err} (atol {PARITY_ATOL})")
    if not err <= PARITY_ATOL:
        raise AssertionError("xlstm: the card's decode disagrees with its "
                             "forward")
    return dict(loss_rel=loss_rel, grad_rel=g_rel, param_rel=p_rel,
                decode_err=err)


def phase_xlstm(torch, model_lib, step_lib, data_lib, serve, train,
                clustering, kernels):
    """Phase xlstm: xlstm-350m at full width and depth (bf16, seeded
    weights): serving, launch/train.main, one profiled step; then 2
    layers in f32 on the card against the CPU."""
    from repro_torch.configs.base import param_count
    from repro_torch.configs.registry import get_config
    from repro_torch.models import xlstm as xlstm_lib
    t0 = time.time()
    cfg = get_config(XL_ARCH)
    log(f"[xlstm] {XL_ARCH}: {cfg.num_layers} layers "
        f"({', '.join('+'.join(e) for e in cfg.layout)} x "
        f"{cfg.num_super_blocks}), d_model {cfg.d_model}, mLSTM heads of "
        f"{cfg.resolved_head_dim}, vocab {cfg.vocab_size}, {cfg.dtype}, "
        f"{param_count(cfg)} params")
    served = xlstm_serve(torch, serve, kernels, cfg)
    log(f"[time] xlstm serve done at {time.time() - t0:.1f} s of the phase")
    trained = xlstm_train(torch, train)
    log(f"[time] xlstm train done at {time.time() - t0:.1f} s of the phase")
    torch.cuda.empty_cache()
    profiled = xlstm_profile(torch, cfg, step_lib, data_lib, xlstm_lib)
    log(f"[time] xlstm profile done at {time.time() - t0:.1f} s of the "
        "phase")
    parity = xlstm_parity(torch, model_lib, step_lib, clustering, kernels,
                          cfg)
    log(f"[xlstm] phase time {time.time() - t0:.1f} s")
    return dict(serve=served, train=trained, profile=profiled,
                parity=parity)


# -------------------------------------------------------------- 17. archs --

# The dense, patch-prefix and encoder-decoder archs, lightest first.
ARCHS_NEW = ("whisper-base", "smollm-360m", "phi3-mini-3.8b", "granite-8b",
             "internvl2-26b", "nemotron-4-15b")
ARCHS_SERVE = dict(requests=8, batch_slots=4, prompt_len=16, gen=16)
ARCHS_TRAIN = (4, 1024)
ARCHS_STEPS = 3
# trained at full depth; granite-8b and internvl2-26b at the deepest whole
# super-block count that fits, nemotron-4-15b by archs_nemotron
ARCHS_FULL_DEPTH = ("smollm-360m", "phi3-mini-3.8b")
ARCHS_CUT = ("granite-8b", "internvl2-26b")
# the share of the card's memory the fitted depth may reach at its peak
ARCHS_FIT_SHARE = 0.9
# whisper's frontend stub takes frames: its 30 s window is 1500 encoder
# frames, and its decoder context 448 tokens
WHISPER_TRAIN = (4, 1500, 448)
ARCHS_PARITY_TOKENS = 32        # internvl parity: 4 patches + 28 tokens


def _gib(n):
    return round(n / 2 ** 30, 3)


def archs_serve(torch, serve, kernels, cfg):
    """The serve loop at full width and depth, seeded weights; the peak of
    allocated device memory over the run."""
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    for k in kernels:
        k.launches = 0
    s = serve.serve_loop(cfg, dev, **ARCHS_SERVE)
    peak = torch.cuda.max_memory_allocated(dev)
    ran = {k.name: k.launches for k in kernels if k.launches}
    out = {k: s[k] for k in ("tokens_per_s", "latency_p50_s",
                             "latency_p99_s")}
    out.update(peak_memory_gib=_gib(peak), layers=cfg.num_layers)
    log(f"[archs] serve {cfg.name}: " + json.dumps(out, sort_keys=True))
    if ran:
        raise AssertionError(f"{cfg.name} serving launched port kernels "
                             f"{ran}: it has no MoE layer")
    if s["tokens"] != ARCHS_SERVE["requests"] * ARCHS_SERVE["gen"] or not all(
            math.isfinite(s[k]) and s[k] > 0 for k in (
                "tokens_per_s", "latency_p50_s", "latency_p99_s")):
        raise AssertionError(f"{cfg.name} serve summary wrong: {s}")
    torch.cuda.empty_cache()
    return out


def archs_train_main(torch, train, registry, arch, cfg):
    """launch/train.main on ``cfg`` (the registry's config, or a depth cut
    of it handed to the launcher through the registry), 3 steps at 4 x
    1024; finite losses, no skips."""
    B, S = ARCHS_TRAIN
    orig = registry.get_config
    registry.get_config = lambda a: cfg if a == arch else orig(a)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = train.main(["--arch", arch, "--batch", str(B), "--seq",
                             str(S), "--steps", str(ARCHS_STEPS),
                             "--log-every", "1"])
    finally:
        registry.get_config = orig
        torch.cuda.empty_cache()
    events = _events(buf)
    steps = [e for e in events if e["kind"] == "step"]
    summary = [e for e in events if e["kind"] == "train_summary"]
    if rc != 0 or len(steps) != ARCHS_STEPS or len(summary) != 1 or not all(
            math.isfinite(e["loss"]) and e["skips"] == 0 for e in steps):
        raise AssertionError(f"{arch} train.main: rc {rc}, steps {steps}")
    s = summary[0]
    out = dict(layers=cfg.num_layers, losses=[e["loss"] for e in steps],
               mean_step_ms_after_first=s["mean_step_ms_after_first"],
               tokens_per_s=s["tokens_per_s"],
               peak_memory_gib=_gib(s["peak_memory_bytes"]))
    log(f"[archs] train {arch} ({cfg.num_layers} of "
        f"{registry.get_config(arch).num_layers} layers, {B} x {S}): "
        + json.dumps(out, sort_keys=True))
    return out


def _step_peak(torch, step_lib, data_lib, cfg, B, S):
    """The peak allocated bytes of one training step of ``cfg`` (init,
    forward, backward, AdamW) at B x S from a clean cache."""
    from repro_torch.configs.base import OptimizerConfig
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    opt = OptimizerConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    state = step_lib.init_train_state(cfg, opt, seed=0, device=dev)
    try:
        batch = step_lib.batch_to_device(
            data_lib.SyntheticLMDataset(cfg.vocab_size, S, B).batch_at(0),
            dev)
        state, m = step_lib.make_train_step(cfg, opt)(state, batch)
        if not math.isfinite(float(m["loss"])):
            raise AssertionError(f"{cfg.name}: non-finite loss")
    finally:
        del state
        torch.cuda.empty_cache()
    return torch.cuda.max_memory_allocated(dev)


def archs_fit_depth(torch, step_lib, data_lib, cfg):
    """The deepest whole super-block count whose training step's peak
    stays within ARCHS_FIT_SHARE of the card's memory, from the measured
    peaks of one step at 1 and 2 super-blocks (the growth a super-block
    is its params, gradients, f32 moments and saved input: linear)."""
    B, S = ARCHS_TRAIN
    total = torch.cuda.get_device_properties(0).total_memory
    p1 = _step_peak(torch, step_lib, data_lib,
                    cfg.replace(num_super_blocks=1), B, S)
    p2 = _step_peak(torch, step_lib, data_lib,
                    cfg.replace(num_super_blocks=2), B, S)
    per = p2 - p1
    n = min(cfg.num_super_blocks,
            1 + int((ARCHS_FIT_SHARE * total - p1) // per))
    rec = dict(peak_1_gib=_gib(p1), peak_2_gib=_gib(p2),
               per_super_block_gib=_gib(per), card_gib=_gib(total),
               budget_gib=_gib(ARCHS_FIT_SHARE * total),
               fit_super_blocks=n, of=cfg.num_super_blocks,
               full_depth_need_gib=_gib(p1 + (cfg.num_super_blocks - 1)
                                          * per))
    log(f"[archs] fit {cfg.name}: " + json.dumps(rec, sort_keys=True))
    if n < 1:
        raise AssertionError(f"{cfg.name}: one super-block does not fit")
    return n, rec


def archs_whisper_train(torch, step_lib, data_lib, cfg):
    """whisper-base at full width and depth through runtime.step (the
    launcher's synthetic data has no frames): 3 steps of 4 x 448 tokens
    over 4 x 1500 seeded frames, finite losses."""
    from repro_torch.configs.base import OptimizerConfig
    dev = torch.device("cuda")
    B, F, S = WHISPER_TRAIN
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    opt = OptimizerConfig(lr=1e-3, warmup_steps=0, total_steps=ARCHS_STEPS)
    state = step_lib.init_train_state(cfg, opt, seed=0, device=dev)
    step = step_lib.make_train_step(cfg, opt)
    ds = data_lib.SyntheticLMDataset(cfg.vocab_size, S, B)
    gen = torch.Generator(device=dev).manual_seed(17)
    losses, dts = [], []
    for s in range(ARCHS_STEPS):
        batch = step_lib.batch_to_device(ds.batch_at(s), dev)
        batch["frames"] = torch.randn((B, F, cfg.d_model), generator=gen,
                                      device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        dts.append(time.perf_counter() - t0)
        if int(m["grad_skips"]):
            raise AssertionError("whisper: a step was skipped")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"whisper losses {losses}")
    out = dict(layers=cfg.num_layers,
               encoder_layers=cfg.num_encoder_super_blocks, losses=losses,
               step_ms=[d * 1e3 for d in dts],
               tokens_per_s=B * S * (len(dts) - 1) / sum(dts[1:]),
               peak_memory_gib=_gib(torch.cuda.max_memory_allocated(dev)))
    log(f"[archs] train whisper-base ({B} x {S} tokens over {B} x {F} "
        "frames, runtime.step): " + json.dumps(out, sort_keys=True))
    del state
    torch.cuda.empty_cache()
    return out


def archs_nemotron(torch, model_lib, step_lib, data_lib, cfg):
    """nemotron-4-15b: a full training step of one super-block if it fits
    the card; where it does not, the reckoning, and loss_fn with its
    backward at full width (the 256k vocab whole) and 4 x 1024 tokens."""
    from repro_torch.configs.base import param_count
    from repro_torch.optim.adam import leaves
    dev = torch.device("cuda")
    B, S = ARCHS_TRAIN
    one = cfg.replace(num_super_blocks=1)
    n = param_count(one)
    vocab_leaf = cfg.vocab_size * cfg.d_model
    reckoning = dict(
        params_1_super_block=n, params_full=param_count(cfg),
        bf16_params_and_grads_gib=_gib(4 * n),
        f32_moments_gib=_gib(8 * n),
        f32_copy_of_the_vocab_leaf_gib=_gib(4 * vocab_leaf),
        card_gib=_gib(torch.cuda.get_device_properties(0).total_memory))
    out = dict(reckoning=reckoning)
    try:
        out["step_peak_gib"] = _gib(_step_peak(torch, step_lib, data_lib,
                                                 one, B, S))
        out["full_step"] = True
    except torch.OutOfMemoryError as exc:
        out["full_step"] = False
        out["oom"] = str(exc).splitlines()[0][:200]
        torch.cuda.empty_cache()
    log(f"[archs] nemotron-4-15b, one super-block: "
        + json.dumps(out, sort_keys=True))
    torch.cuda.reset_peak_memory_stats(dev)
    params = model_lib.init_params(one, seed=0, device=dev)
    train = [p for p in leaves(params) if p.is_floating_point()]
    for p in train:
        p.requires_grad_(True)
    batch = step_lib.batch_to_device(
        data_lib.SyntheticLMDataset(one.vocab_size, S, B).batch_at(0), dev)
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = model_lib.loss_fn(params, one, batch)
        grads = torch.autograd.grad(loss, train)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        finite = math.isfinite(float(loss.detach())) and all(
            bool(torch.isfinite(g).all()) for g in grads)
        del grads
    out.update(loss=float(loss.detach()), loss_and_backward_ms=times,
               loss_and_backward_peak_gib=_gib(
                   torch.cuda.max_memory_allocated(dev)))
    log(f"[archs] nemotron-4-15b loss_fn + backward, one super-block, "
        f"vocab {one.vocab_size}, {B} x {S}: loss {out['loss']}, ms "
        f"{times}, peak {out['loss_and_backward_peak_gib']} GiB")
    del params, train, loss
    torch.cuda.empty_cache()
    if not finite:
        raise AssertionError("nemotron: non-finite loss or gradient")
    return out


def archs_parity(torch, model_lib, step_lib, clustering, kernels,
                 registry):
    """f32 on the card against the CPU, TF32 off: whisper-base at 2 + 2
    layers, one train step (loss and gradients within phase train
    parity's f32 bounds, params within HYB_PARAM_RTOL) and 16 decode
    steps (within PARITY_ATOL); internvl2-26b at 2 layers with 4 patches,
    forward (within PARITY_ATOL), loss and gradients."""
    import numpy as np

    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.optim.adam import leaves
    cpu, dev = torch.device("cpu"), torch.device("cuda")

    def rel(u, v):
        return float((u.double() - v.double()).norm()
                     / v.double().norm().clamp_min(1e-30))

    out = {}
    cfg = registry.get_config("whisper-base").replace(
        num_super_blocks=2, num_encoder_super_blocks=2, dtype="float32")
    opt = OptimizerConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    batch = SyntheticLMDataset(cfg.vocab_size, 64, 2).batch_at(0)
    batch["frames"] = np.random.default_rng(5).standard_normal(
        (2, 128, cfg.d_model)).astype(np.float32)
    a, b = _parity_runs(torch, model_lib, step_lib, clustering, kernels,
                        set(), cfg, opt, batch)
    loss_rel = abs(a["loss"] - b["loss"]) / abs(b["loss"])
    g_rel = max(rel(x, y) for x, y in zip(a["grads"], b["grads"])
                if y is not None and y.any())
    p_rel = max(rel(x, y) for x, y in zip(a["params"], b["params"])
                if y.is_floating_point())
    params = model_lib.init_params(cfg, seed=6, device=cpu)
    tokens = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 16)))
    logits = {}
    for d in (dev, cpu):
        p = tree_to(params, d) if d.type == "cuda" else params
        state = model_lib.init_decode_state(cfg, 2, 16, device=d)
        outs = []
        for i in range(16):
            lg, state = model_lib.decode_step(p, cfg, state,
                                              tokens[:, i:i + 1].to(d))
            outs.append(lg.cpu())
        logits[d.type] = torch.cat(outs, 1)
    dec = float((logits["cuda"] - logits["cpu"]).abs().max())
    out["whisper"] = dict(loss_rel=loss_rel, grad_rel=g_rel,
                          param_rel=p_rel, decode_err=dec)
    log(f"[archs] parity whisper-base 2 + 2 layers f32 (2 x 64 tokens, "
        f"2 x 128 frames): loss cuda {a['loss']} cpu {b['loss']} (rel "
        f"{loss_rel:.3g}), worst gradient rel L2 {g_rel:.3g}, worst param "
        f"rel L2 {p_rel:.3g}; 16 decode steps max |diff| {dec:.3g}; bounds "
        f"{LOSS_RTOL} / {GRAD_RTOL} / {HYB_PARAM_RTOL} / {PARITY_ATOL}")
    if not (loss_rel <= LOSS_RTOL and g_rel <= GRAD_RTOL
            and p_rel <= HYB_PARAM_RTOL and dec <= PARITY_ATOL):
        raise AssertionError("whisper: CUDA and CPU disagree")
    del params, a, b

    cfg = registry.get_config("internvl2-26b").replace(
        num_super_blocks=2, num_patches=4, dtype="float32")
    rng = np.random.default_rng(9)
    T = ARCHS_PARITY_TOKENS - cfg.num_patches
    host = {"tokens": rng.integers(0, cfg.vocab_size, (2, T)),
            "labels": rng.integers(0, cfg.vocab_size, (2, T)),
            "patch_embeds": rng.standard_normal(
                (2, cfg.num_patches, cfg.d_model)).astype(np.float32)}
    # drawn on the card (seconds on the host for 1.9 G elements), then
    # copied to the host
    params = tree_to(model_lib.init_params(cfg, seed=7, device=dev), cpu)
    torch.cuda.empty_cache()
    runs = {}
    for d in (dev, cpu):
        p = tree_to(params, d) if d.type == "cuda" else params
        batch = step_lib.batch_to_device(host, d)
        train = [t for t in leaves(p) if t.is_floating_point()]
        for t in train:
            t.requires_grad_(True)
        with torch.no_grad():
            lg, _ = model_lib.forward(p, cfg, batch["tokens"],
                                      patch_embeds=batch["patch_embeds"])
        loss, _ = model_lib.loss_fn(p, cfg, batch)
        grads = torch.autograd.grad(loss, train)
        runs[d.type] = dict(logits=lg.cpu(), loss=float(loss),
                            grads=[g.cpu() for g in grads])
        for t in train:
            t.requires_grad_(False)
        del p, grads, train
    a, b = runs["cuda"], runs["cpu"]
    fwd = float((a["logits"] - b["logits"]).abs().max())
    loss_rel = abs(a["loss"] - b["loss"]) / abs(b["loss"])
    g_rel = max(rel(x, y) for x, y in zip(a["grads"], b["grads"])
                if y.any())
    out["internvl"] = dict(forward_err=fwd, loss_rel=loss_rel,
                           grad_rel=g_rel)
    log(f"[archs] parity internvl2-26b 2 layers f32 (2 x (4 patches + "
        f"{T} tokens)): logits max |diff| {fwd:.3g}, loss cuda {a['loss']} "
        f"cpu {b['loss']} (rel {loss_rel:.3g}), worst gradient rel L2 "
        f"{g_rel:.3g}; bounds {PARITY_ATOL} / {LOSS_RTOL} / {GRAD_RTOL}")
    if not (fwd <= PARITY_ATOL and loss_rel <= LOSS_RTOL
            and g_rel <= GRAD_RTOL):
        raise AssertionError("internvl: CUDA and CPU disagree")
    del params, runs
    torch.cuda.empty_cache()
    return out


def phase_archs(torch, model_lib, step_lib, data_lib, serve, train,
                clustering, kernels):
    """Phase archs: the six dense, patch-prefix and encoder-decoder archs
    at full width: serving at full depth; training (full depth, the
    deepest that fits, or nemotron's loss and backward); then whisper and
    internvl in f32 on the card against the CPU."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import param_count
    t0 = time.time()
    out = {"serve": {}, "train": {}}
    for arch in ARCHS_NEW:
        cfg = registry.get_config(arch)
        log(f"[archs] {arch}: {cfg.num_layers} layers"
            + (f" + {cfg.num_encoder_super_blocks} encoder"
               if cfg.encoder_decoder else "")
            + f", d_model {cfg.d_model}, {cfg.num_heads} heads "
            f"({cfg.num_kv_heads} KV) of {cfg.resolved_head_dim}, d_ff "
            f"{cfg.d_ff} {cfg.mlp_act}, vocab {cfg.vocab_size}, "
            f"pos {cfg.pos_emb}, {cfg.dtype}, {param_count(cfg)} params")
        out["serve"][arch] = archs_serve(torch, serve, kernels, cfg)
    log(f"[time] archs serve done at {time.time() - t0:.1f} s of the phase")
    out["train"]["whisper-base"] = archs_whisper_train(
        torch, step_lib, data_lib, registry.get_config("whisper-base"))
    for arch in ARCHS_FULL_DEPTH:
        out["train"][arch] = archs_train_main(
            torch, train, registry, arch, registry.get_config(arch))
    for arch in ARCHS_CUT:
        cfg = registry.get_config(arch)
        n, fit = archs_fit_depth(torch, step_lib, data_lib, cfg)
        out["train"][arch] = archs_train_main(
            torch, train, registry, arch, cfg.replace(num_super_blocks=n))
        out["train"][arch]["fit"] = fit
    out["train"]["nemotron-4-15b"] = archs_nemotron(
        torch, model_lib, step_lib, data_lib,
        registry.get_config("nemotron-4-15b"))
    log(f"[time] archs train done at {time.time() - t0:.1f} s of the phase")
    out["parity"] = archs_parity(torch, model_lib, step_lib, clustering,
                                 kernels, registry)
    log(f"[archs] phase time {time.time() - t0:.1f} s")
    return out


# -------------------------------------------------------------- main --

# ------------------------------------------------------------ dryrun --

DRYRUN_CELL = (ARCH, "train_4k", "single")
DRYRUN_PEAK_TOL = 0.10


def dryrun_cell_start():
    """The full-size granite-moe-3b-a800m / train_4k / single cell of
    launch/dryrun.py (a fake group of 256 ranks, meta tensors: no card),
    in a process of its own started now and read by ``phase_dryrun``;
    returns (process, its output file, its directory).  The process is
    stopped and the directory removed when this script exits, whatever
    way it does."""
    import atexit
    import shutil
    import tempfile
    d = tempfile.mkdtemp(prefix=".dryrun-", dir=ROOT)
    out = os.path.join(d, "cell.json")
    arch, shape, mesh = DRYRUN_CELL
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", mesh, "--workers", "1", "--out", out],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1"))

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(d, ignore_errors=True)
    atexit.register(stop)
    return proc, out, d


def _active_blocks(torch):
    """{address: block} of the caching allocator's allocated blocks."""
    return {b["address"]: b for seg in torch.cuda.memory_snapshot()
            for b in seg["blocks"] if b["state"] == "active_allocated"}


def phase_dryrun(torch, dryrun, step_lib, data_lib, kernels, cell):
    """launch/dryrun.py's count of granite-moe-3b-a800m at the phase-train
    size (4 x 1024, the bf16 wire, LSH on, one rank: no group) on meta
    tensors, then one measured step of the same on the card: each
    kernel's launches equal the count of its op, the state and batch's
    bytes (``arg_alloc_bytes``: each rounded to the allocator's 512-byte
    blocks) equal what their allocations asked the caching allocator for
    (``torch.cuda.memory_snapshot``'s requested sizes, so rounded; the
    blocks it gave them sum to their ``memory_allocated()``, which
    holds besides the rest of each segment it did not split), and
    arg_bytes + temp_bytes within 10% of the step's
    ``max_memory_allocated()``.  Then the full-size cell's roofline line,
    as traced by its own process under this torch."""
    import shutil
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import get_config
    cfg = get_config(ARCH)
    shape = ShapeSpec("phase_train", 1024, 4, "train")
    t0 = time.time()
    art = dryrun.lower_cell(ARCH, shape.name, None, shape=shape,
                            use_lsh=True)
    log(f"[dryrun] counted {ARCH} 4 x 1024 (one rank) in "
        f"{time.time() - t0:.1f} s: flops={art['flops_per_device']:.6g} "
        f"bytes={art['bytes_per_device']:.6g} arg_bytes={art['arg_bytes']} "
        f"arg_alloc_bytes={art['arg_alloc_bytes']} "
        f"temp_bytes={art['temp_bytes']} kernels="
        + json.dumps({k: v["calls"] for k, v in art["kernels"].items()}))
    opt = dryrun.opt_cfg_for(cfg)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    before = _active_blocks(torch)
    state = step_lib.init_train_state(cfg, opt, seed=0, device="cuda")
    batch = step_lib.batch_to_device(data_lib.SyntheticLMDataset(
        cfg.vocab_size, 1024, 4).batch_at(0), torch.device("cuda"))
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    new = [b for a, b in _active_blocks(torch).items() if a not in before]
    # the allocator's blocks of the state and batch: what each asked for,
    # in 512-byte units, and what it was given (a block the allocator did
    # not split keeps the rest of its segment)
    asked = sum(-(-b["requested_size"] // 512) * 512 for b in new)
    given = sum(b["size"] for b in new)
    step_fn = step_lib.make_train_step(cfg, opt, use_lsh=True)
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    state, m = step_fn(state, batch)
    loss = float(m["loss"])
    torch.cuda.synchronize()
    step_s = time.time() - t0
    peak = torch.cuda.max_memory_allocated() - base
    launches = {k.name: k.launches for k in kernels}
    counted = {k.name: art["kernels"].get(k.name, {}).get("calls", 0)
               for k in kernels}
    want = art["arg_bytes"] + art["temp_bytes"]
    log(f"[dryrun] measured step ({step_s:.2f} s, loss {loss:.4f}): "
        f"launches {json.dumps(launches)}; the state and batch: "
        f"{len(new)} blocks asked for {asked} bytes (counted "
        f"{art['arg_alloc_bytes']}), were given {given}, "
        f"memory_allocated {held}; peak {peak} against arg_bytes + "
        f"temp_bytes {want} (ratio {want / peak:.4f})")
    del state, batch, m, step_fn
    torch.cuda.empty_cache()
    if launches != counted:
        raise AssertionError(f"[dryrun] launches {launches} differ from the "
                             f"counted ops {counted}")
    if not any(launches.values()):
        raise AssertionError("[dryrun] the measured step launched no kernel")
    if asked != art["arg_alloc_bytes"] or given != held:
        raise AssertionError(f"[dryrun] the state and batch asked for "
                             f"{asked} bytes (given {given}, allocated "
                             f"{held}), counted {art['arg_alloc_bytes']}")
    if abs(want - peak) > DRYRUN_PEAK_TOL * peak:
        raise AssertionError(f"[dryrun] peak {peak} and arg_bytes + "
                             f"temp_bytes {want} differ by more than "
                             f"{DRYRUN_PEAK_TOL:.0%}")
    proc, out, d = cell
    try:
        _, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"[dryrun] the full-size cell exited "
                                 f"{proc.returncode}: {err[-2000:]}")
        with open(out) as f:
            (full,) = json.load(f)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(d, ignore_errors=True)
    log(f"[dryrun] {'/'.join(DRYRUN_CELL)} traced under torch "
        f"{torch.__version__} in {full['compile_s']} s: "
        + json.dumps({k: full[k] for k in (
            "mesh", "flops_per_device", "bytes_per_device",
            "wire_bytes_per_device", "collective_counts", "arg_bytes",
            "temp_bytes", "compute_s", "memory_s", "collective_s",
            "dominant", "model_flops_ratio", "roofline_fraction")}))
    return art, full


def op_host_us(torch, mods, p, q, n=100):
    """Host microseconds a call of each kernel at the training shape:
    through its registered op (the public wrapper), and its CUDA
    implementation called directly; dispatch_scatter also through a
    ``torch.library.custom_op`` around the same implementation."""
    sg, tp, lh = mods["scatter_gather"], mods["token_position"], \
        mods["lsh_hash"]
    scm, ram = mods["segment_centroid"], mods["residual_apply"]
    wq, fw = mods["wire_quant"], mods["fused_wire"]
    flat, pos, src, buf, w = p["flat"], p["pos"], p["src"], p["buf"], p["w"]
    E, C = p["E"], p["C"]
    S = q["S"]
    slots = torch.clamp(q["slots"], max=S - 1).contiguous()
    qb, sb = wq.wire_quantize(buf, "int8")
    qe, se = wq.wire_quantize(q["eout"], "int8")
    cases = {
        "positions_in_expert": (tp.positions_in_expert, tp._launch,
                                (p["ids"], E)),
        "dispatch_scatter": (sg.dispatch_scatter, sg._scatter_launch,
                             (flat, pos, src, E, C)),
        "combine_gather": (sg.combine_gather, sg._gather_launch,
                           (flat, pos, buf, w)),
        "lsh_hash": (lh.lsh_hash, lh._launch, (q["x"], q["rot"])),
        "segment_centroid": (scm.segment_centroid, scm._launch,
                             (slots, q["disp"], S)),
        "residual_apply": (ram.residual_apply, ram._launch,
                           (slots, q["eout"], q["resid"])),
        "wire_quantize": (wq.wire_quantize, wq._quantize_launch,
                          (q["eout"], "int8")),
        "wire_dequantize": (wq.wire_dequantize, wq._dequantize_launch,
                            (qe, se)),
        "dispatch_scatter_quantize": (fw.dispatch_scatter_quantize,
                                      fw._scatter_quantize_launch,
                                      (flat, pos, src, E, C, "int8")),
        "dequantize_combine_gather": (fw.dequantize_combine_gather,
                                      fw._dequantize_gather_launch,
                                      (flat, pos, qb, sb, w)),
        "dequantize_residual_apply": (fw.dequantize_residual_apply,
                                      fw._dequantize_residual_launch,
                                      (slots, qe, se, q["resid"], None)),
    }

    @torch.library.custom_op(
        "repro_smoke::dispatch_scatter", mutates_args=(),
        schema="(Tensor ids, Tensor pos, Tensor src, int e, int c) "
               "-> Tensor")
    def custom(ids, pos, src, e, c):
        return sg._scatter_launch(ids, pos, src, e, c)

    def host_us(fn, args):
        fn(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn(*args)
        us = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        return us

    out = {}
    for name, (op, direct, args) in cases.items():
        out[name] = {"op_us": host_us(op, args),
                     "direct_us": host_us(direct, args)}
    out["dispatch_scatter"]["custom_op_us"] = host_us(
        custom, (flat, pos, src, E, C))
    for name, r in out.items():
        log(f"[kernels] host us a call {name}: "
            + " ".join(f"{k}={v:.2f}" for k, v in r.items()))
    return out


# ---------------------------------------------------------- 18. seqdecode --

SEQ_ROWS = 8
SEQ_LEN = 32768                  # the decode_32k cells' cache
SEQ_BLOCKS = 16                  # the model axis of the production mesh
SEQ_POSITIONS = (0, 2047, 2048, 32767)
SEQ_RTOL = 1e-6
SEQ_PATH_LEN = 4096              # the full path's cache
SEQ_STEPS = 8
SEQ_PROFILES = 3                 # profiled runs of a decode path, at most
SEQ_PATH_KERNELS = ("positions_in_expert_kernel", "dispatch_scatter_kernel",
                    ("combine_gather_kernel", "combine_gather_scalar_kernel"))


def seqdecode_combine(torch, attn, cfg):
    """(a) granite-moe-3b-a800m's attention at full width (f32 weights and
    token, a bf16 cache of SEQ_ROWS x SEQ_LEN): the sequence-split form
    emulated in one process (``split_decode_attention``: each block's
    partial from a copy of its rows, combined in block order, as the
    ranks compute it) against the whole-cache ``decode_attention``, one
    block bitwise, SEQ_BLOCKS blocks within SEQ_RTOL relative L2, at each
    of SEQ_POSITIONS; then one block's decode attention (a rank's
    SEQ_LEN / SEQ_BLOCKS rows) timed beside the whole cache's."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(28)
    H, nh, nkv, dh = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                      cfg.resolved_head_dim)

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g, device=dev)
                * scale).to(dtype)
    params = {"wq": rnd(H, nh * dh, scale=H ** -0.5),
              "wk": rnd(H, nkv * dh, scale=H ** -0.5),
              "wv": rnd(H, nkv * dh, scale=H ** -0.5),
              "wo": rnd(nh * dh, H, scale=(nh * dh) ** -0.5)}
    x = rnd(SEQ_ROWS, 1, H)
    cache = {k: rnd(SEQ_ROWS, SEQ_LEN, nkv, dh, dtype=torch.bfloat16)
             for k in ("k", "v")}
    kw = dict(num_heads=nh, num_kv_heads=nkv, head_dim=dh,
              rope_theta=cfg.rope_theta)

    def fresh():
        return {k: v.clone() for k, v in cache.items()}
    rows = []
    for pos in SEQ_POSITIONS:
        whole, wc = attn.decode_attention(params, x, fresh(), pos, **kw)
        one, oc = attn.split_decode_attention(params, x, fresh(), pos, 1,
                                              **kw)
        split, sc = attn.split_decode_attention(params, x, fresh(), pos,
                                                SEQ_BLOCKS, **kw)
        written = all(torch.equal(wc[k], c[k]) for c in (oc, sc)
                      for k in wc)
        del wc, oc, sc
        rel = float(torch.linalg.norm((split - whole).double())
                    / torch.linalg.norm(whole.double()))
        rows.append(dict(position=pos, one_block_bitwise=bool(
            torch.equal(one, whole)), rel_l2=rel, written=written,
            finite=bool(torch.isfinite(split).all())))
        log(f"[seqdecode] position {pos}: 1 block bitwise "
            f"{rows[-1]['one_block_bitwise']}, {SEQ_BLOCKS} blocks rel L2 "
            f"{rel:.3g} (bound {SEQ_RTOL}), caches written alike {written}")
    bad = [r for r in rows if not (r["one_block_bitwise"] and r["written"]
                                   and r["finite"]
                                   and r["rel_l2"] <= SEQ_RTOL)]
    if bad:
        raise AssertionError(f"[seqdecode] the split combine disagrees with "
                             f"the whole cache: {bad}")
    n = SEQ_LEN // SEQ_BLOCKS
    block = {k: v[:, :n].contiguous() for k, v in cache.items()}
    pos = n // 2
    whole_ms = time_ms(torch, lambda: attn.decode_attention(
        params, x, cache, pos, **kw))
    block_ms = time_ms(torch, lambda: attn.decode_attention(
        params, x, block, pos, **kw))
    cache_bytes = 2 * SEQ_ROWS * SEQ_LEN * nkv * dh * 2
    log(f"[seqdecode] decode attention, {SEQ_ROWS} rows, bf16 cache: whole "
        f"{SEQ_LEN} rows {whole_ms:.4f} ms ({cache_bytes / 1e6:.1f} MB of "
        f"cache, {cache_bytes / whole_ms / 1e6:.1f} GB/s), one block of "
        f"{n} rows {block_ms:.4f} ms ({whole_ms / block_ms:.2f}x)")
    del cache, block
    torch.cuda.empty_cache()
    return dict(rows=rows, whole_ms=whole_ms, block_ms=block_ms)


def seqdecode_path(torch, model_lib, kernels, routing_kernels, mesh, cfg):
    """(b) granite-moe-3b-a800m at full width and depth (bf16, seeded
    weights): SEQ_STEPS teacher-forced ``decode_step``s of SEQ_ROWS rows
    over a SEQ_PATH_LEN cache, mesh-free and on the (1, 1) NCCL mesh with
    the state of ``init_decode_state(mesh=)``: logits and every state
    leaf bit-equal, each routing kernel launched once a MoE layer a step
    on both runs, and the mesh run's profile naming the three kernels
    (a run is profiled again, at most SEQ_PROFILES times, until its
    profile shows every launch)."""
    from torch.profiler import ProfilerActivity, profile
    dev = torch.device("cuda")
    params = model_lib.init_params(cfg, seed=0, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (SEQ_ROWS, SEQ_STEPS),
                           generator=torch.Generator().manual_seed(28)
                           ).to(dev)
    want = cfg.num_layers * SEQ_STEPS
    runs = {}
    for tag, m in (("mesh-free", None), ("mesh (1, 1)", mesh)):
        # a profile can lose device events at its edges (PR 29's run of
        # this phase: 255 of each kernel's 256 launches in the mesh run's
        # profile): the run is made again from a fresh state, at most
        # SEQ_PROFILES times, until its profile shows every launch
        for attempt in range(1, SEQ_PROFILES + 1):
            state = model_lib.init_decode_state(cfg, SEQ_ROWS, SEQ_PATH_LEN,
                                                device=dev, mesh=m)
            for k in kernels:
                k.launches = 0
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                logits = []
                for i in range(SEQ_STEPS):
                    lg, state = model_lib.decode_step(
                        params, cfg, state, tokens[:, i:i + 1], mesh=m)
                    logits.append(lg)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3 / SEQ_STEPS
            names = _device_names(torch, prof)
            launches = {k.name: k.launches for k in kernels}
            runs[tag] = dict(logits=torch.cat(logits, 1), state=state,
                             ms=ms, launches=launches, names=names)
            seen = {n if isinstance(n, str) else "/".join(n): sum(
                c for e, c in names.items()
                if any(x in e for x in ((n,) if isinstance(n, str) else n)))
                for n in SEQ_PATH_KERNELS}
            runs[tag]["seen"] = seen
            log(f"[seqdecode] {tag}: {SEQ_STEPS} steps, {ms:.2f} ms a step "
                f"(profiled, run {attempt}), launches {launches}, profile "
                f"{seen}")
            if all(c >= want for c in seen.values()):
                break
    a, b = runs["mesh-free"], runs["mesh (1, 1)"]
    same_logits = bool(torch.equal(a["logits"], b["logits"]))
    same_state = all(torch.equal(x[k], y[k]) for x, y in zip(
        a["state"]["layers"], b["state"]["layers"]) for k in x)
    layout = {k: v for k, v in b["state"]["layout"].items()
              if k not in ("specs", "shapes")}
    log(f"[seqdecode] mesh (1, 1) layout {layout}: logits bit-equal "
        f"{same_logits}, every state leaf bit-equal {same_state}")
    bad_launch = {tag: r["launches"] for tag, r in runs.items()
                  if any(r["launches"][k.name] != (want if k in
                                                   routing_kernels else 0)
                         for k in kernels)}
    if bad_launch:
        raise AssertionError(f"[seqdecode] launches {bad_launch}, want "
                             f"{want} of each routing kernel, no other")
    unseen = [n for n, c in b["seen"].items() if c < want]
    if unseen:
        raise AssertionError(f"[seqdecode] the mesh run's profile shows "
                             f"too few launches of {unseen}: {b['seen']}")
    if not (same_logits and same_state):
        raise AssertionError("[seqdecode] the (1, 1) mesh decode is not "
                             "bit-equal to the mesh-free decode")
    if not bool(torch.isfinite(b["logits"]).all()):
        raise AssertionError("[seqdecode] non-finite logits")
    out = {tag: dict(ms=r["ms"], launches=r["launches"], seen=r["seen"])
           for tag, r in runs.items()}
    del params, runs, a, b
    torch.cuda.empty_cache()
    return out


def phase_seqdecode(torch, model_lib, kernels, routing_kernels):
    """Phase seqdecode: (a) the split combine at the decode_32k cache,
    (b) the full path on a (1, 1) NCCL mesh (a HashStore, no network)
    with the sequence-split state layout, against the mesh-free path."""
    import torch.distributed as dist

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.models import attention as attn
    t0 = time.time()
    cfg = get_config(ARCH)
    combine = seqdecode_combine(torch, attn, cfg)
    init_distributed(torch.device("cuda", 0), store=dist.HashStore(),
                     rank=0, world_size=1)
    try:
        path = seqdecode_path(torch, model_lib, kernels, routing_kernels,
                              make_mesh(1, 1), cfg)
    finally:
        dist.destroy_process_group()
    log(f"[seqdecode] phase time {time.time() - t0:.1f} s")
    return dict(combine=combine, path=path)


# ---------------------------------------------------------- 19. examples --

EX_TRAIN_STEPS = (120, 140)      # train_lm's first run, then its resume
EX_TIMED = (20, 80)              # train_lm's logged steps timed between
#                                  (no save between them: saves follow
#                                  steps 99 and 119)
EX_SERVE_ARCHS = ("granite-moe-3b-a800m", "xlstm-350m")
EX_SERVE = (4, 12, 20)           # serve_batch's batch, prompt, generated
EX_TIMEOUT_S = 300
EX_NUMBER = re.compile(r"(?<![\w.])-?(?:\d+\.?\d*(?:e[-+]?\d+)?|nan|inf)\b",
                       re.IGNORECASE)
# A subprocess runs the example's module as `python -m` does (runpy, as
# __main__, with its argv), then prints the kernels' launch counters,
# which live in that process, and the card's peak allocation.
EX_RUNNER = """
import json, runpy, sys, torch
from repro_torch.kernels import dispatch
name = sys.argv[1]
sys.argv = [name, *sys.argv[2:]]
try:
    runpy.run_module(name, run_name="__main__", alter_sys=True)
finally:
    print("[launches] " + json.dumps({
        "launches": {k.name: k.launches for k in dispatch.KERNELS},
        "peak_bytes": torch.cuda.max_memory_allocated()}), flush=True)
"""


def example_run(name, args=()):
    """``repro_torch.examples.<name>`` in a subprocess on the card: its
    stdout lines with the seconds since the start at which each arrived,
    its launch counters and peak bytes; raises on a non-zero exit or a
    printed number that is not finite."""
    import tempfile
    import threading
    module = f"repro_torch.examples.{name}"
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.monotonic()
    with tempfile.TemporaryFile("w+") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", EX_RUNNER, module, *args], cwd=ROOT,
            env=env, stdout=subprocess.PIPE, stderr=err, text=True)
        timer = threading.Timer(EX_TIMEOUT_S, proc.kill)
        timer.start()
        try:
            lines = [(time.monotonic() - t0, line.rstrip("\n"))
                     for line in proc.stdout]
            rc = proc.wait()
        finally:
            timer.cancel()
        err.seek(0)
        stderr = err.read()
    if rc != 0:
        raise AssertionError(f"[examples] {name} {list(args)} exited {rc}:\n"
                             f"{stderr[-3000:]}")
    record = json.loads(lines.pop()[1].split(" ", 1)[1])
    text = [line for _, line in lines]
    for line in text:
        for num in EX_NUMBER.findall(line):
            if not math.isfinite(float(num)):
                raise AssertionError(f"[examples] {name}: {line!r}")
    return dict(name=name, lines=lines, text=text,
                wall_s=time.monotonic() - t0, **record)


def _log_run(run):
    for line in run["text"]:
        log(f"[examples] {run['name']}: {line}")
    log(f"[examples] {run['name']}: {run['wall_s']:.1f} s, peak "
        f"{run['peak_bytes'] / 2 ** 30:.3f} GiB, launches {run['launches']}")


def _launched(label, launches, kernels, want_on):
    """Each kernel of ``want_on`` launched, every other one not."""
    on = {k.name for k in want_on}
    bad = {k.name: launches[k.name] for k in kernels
           if (launches[k.name] > 0) != (k.name in on)}
    if bad:
        raise AssertionError(f"[examples] {label}: launches {bad}; want "
                             f"{sorted(on)} launched and no other kernel")


def examples_quickstart(run, kernels, path_kernels):
    if len(run["text"]) != 3 or not run["text"][2].startswith(
            "wire tensor: (1, 128, 64) tokens -> (1, 32, 64) centroids "
            "(25% of the bytes)"):
        raise AssertionError(f"[examples] quickstart printed {run['text']}")
    _launched("quickstart", run["launches"], kernels, path_kernels)


def examples_train_lm(runs, kernels, path_kernels):
    """train_lm --steps 120 into a fresh directory, then --steps 140:
    the second resumes at 120; the loss at step 100 below step 0's, no
    skip; the same launches a step in both runs; the steady step time
    from the arrival of the step 20 and step 80 lines of the first run,
    which runs alone (each step ends reading its loss)."""
    from repro_torch.examples import train_lm
    steps = {}
    for run in runs:
        for t, line in run["lines"]:
            m = re.fullmatch(r"step (\d+): loss (\S+) ce (\S+) skips (\d+)",
                             line)
            if m:
                steps[int(m[1])] = (t, float(m[2]), int(m[4]))
    first, resumed = runs
    want_logged = set(range(0, EX_TRAIN_STEPS[1], train_lm.LOG_EVERY))
    if set(steps) != want_logged or any(s[2] for s in steps.values()):
        raise AssertionError(f"[examples] train_lm logged steps "
                             f"{sorted(steps)} (skips "
                             f"{[s[2] for s in steps.values()]})")
    if f"resumed from step {EX_TRAIN_STEPS[0]}" not in resumed["text"] or \
            any(line.startswith("resumed") for line in first["text"]):
        raise AssertionError("[examples] train_lm did not resume at step "
                             f"{EX_TRAIN_STEPS[0]} (or resumed a fresh "
                             "directory)")
    if not all(r["text"][-1].startswith("done. final loss") for r in runs):
        raise AssertionError("[examples] a train_lm run did not finish: "
                             f"{[r['text'][-1] for r in runs]}")
    if not steps[100][1] < steps[0][1]:
        raise AssertionError(f"[examples] train_lm loss at step 100 "
                             f"{steps[100][1]} is not below step 0's "
                             f"{steps[0][1]}")
    per_step = [{k: run["launches"][k] / n for k in run["launches"]}
                for run, n in zip(runs, (EX_TRAIN_STEPS[0],
                                         EX_TRAIN_STEPS[1]
                                         - EX_TRAIN_STEPS[0]))]
    if per_step[0] != per_step[1]:
        raise AssertionError(f"[examples] train_lm launches a step differ: "
                             f"{per_step}")
    _launched("train_lm", first["launches"], kernels, path_kernels)
    a, b = EX_TIMED
    step_s = (steps[b][0] - steps[a][0]) / (b - a)
    tokens = train_lm.SEQ * train_lm.BATCH
    out = dict(loss_0=steps[0][1], loss_100=steps[100][1],
               step_ms=1e3 * step_s, tokens_per_s=tokens / step_s,
               peak_bytes=[r["peak_bytes"] for r in runs],
               launches_per_step=per_step[0],
               wall_s=[r["wall_s"] for r in runs])
    log(f"[examples] train_lm: steady step {out['step_ms']:.2f} ms (steps "
        f"{a + 1}-{b} by the host clock), {out['tokens_per_s']:.1f} "
        f"tokens/s, peak {out['peak_bytes']} bytes (first run, resumed "
        f"run), loss step 0 {out['loss_0']} -> step 100 {out['loss_100']}")
    return out


def examples_serve(runs, kernels, routing_kernels, registry):
    """serve_batch on a MoE arch and on xlstm-350m: 4 rows of 20 tokens
    in the vocabulary; the routing kernels once a MoE layer a decode
    step (12 prompt + 20 generated steps), nothing else launched."""
    from repro_torch.configs.base import MOE
    B, P, G = EX_SERVE
    out = {}
    for arch, run in zip(EX_SERVE_ARCHS, runs):
        cfg = registry.get_smoke_config(arch)
        head = re.fullmatch(rf"arch={arch} generated \({B}, {G}\) tokens "
                            r"in (\S+)s", run["text"][0])
        rows = [json.loads(line.split(":", 1)[1]) for line in run["text"][1:]]
        if head is None or len(rows) != B or any(
                len(r) != G or not all(0 <= t < cfg.vocab_size for t in r)
                for r in rows):
            raise AssertionError(f"[examples] serve_batch {arch} printed "
                                 f"{run['text']}")
        n_moe = cfg.num_super_blocks * sum(f == MOE for _, f in cfg.layout)
        want = {k.name: n_moe * (P + G) if k in routing_kernels else 0
                for k in kernels}
        if run["launches"] != want:
            raise AssertionError(f"[examples] serve_batch {arch} launches "
                                 f"{run['launches']}, want {want}")
        secs = float(head[1])               # printed to 2 decimals
        tps = B * G / secs if secs > 0 else None
        out[arch] = dict(seconds=secs, tokens_per_s=tps, moe_layers=n_moe)
        log(f"[examples] serve_batch {arch}: {tps} tokens/s from the "
            f"printed {secs} s ({B} x {G} generated after {P} prompt "
            "steps, the first steps' warm-up included, beside the other "
            "examples' processes)")
    return out


def examples_elastic(torch, run, kernels, path_kernels):
    """The example's printed lines and launches, then its run in this
    process against an uninterrupted 6-step run on a (1, 1) mesh from
    the same seed: every loss bit-equal (the printed ones have 4
    decimals)."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.data.pipeline import place
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.examples import elastic_restart as ex
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.runtime.step import init_train_state, make_train_step
    want_text = ["[mesh A {'data': 1, 'model': 1}] step 3 loss",
                 "[mesh B {'data': 1, 'model': 1}] resumed at 3, step 6 "
                 "loss", "elastic restore OK"]
    if len(run["text"]) != 3 or not all(
            line.startswith(w) for line, w in zip(run["text"], want_text)):
        raise AssertionError(f"[examples] elastic_restart printed "
                             f"{run['text']}")
    _launched("elastic_restart", run["launches"], kernels, path_kernels)
    dev = torch.device("cuda", 0)
    cfg, opt = ex.build_config(), ex.build_optimizer()
    with tempfile.TemporaryDirectory(prefix=".examples-", dir=ROOT) as d, \
            contextlib.redirect_stdout(io.StringIO()):
        got = ex.run(cfg, opt, d, dev)["losses"]
    ds = SyntheticLMDataset(cfg.vocab_size, ex.SEQ, ex.BATCH)
    init_distributed(dev, store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh(1, 1)
        state = init_train_state(cfg, opt, seed=0, device=dev, mesh=mesh)
        step = make_train_step(cfg, opt, mesh=mesh)
        want = {}
        for s in range(2 * ex.STEPS):
            state, m = step(state, place(ds.batch_at(s), dev))
            want[s + 1] = float(m["loss"])
    finally:
        dist.destroy_process_group()
    if got != want:
        raise AssertionError(f"[examples] elastic_restart losses {got} are "
                             f"not an uninterrupted run's {want}")
    log(f"[examples] elastic_restart on the card: losses {got}, bit-equal "
        "to an uninterrupted 6-step run on a (1, 1) mesh")
    return dict(losses=got, launches=run["launches"])


def examples_kernels(torch, mods, ref, moe_lib, hashing, registry):
    """The path's kernels at the shapes the examples launch them, against
    their plain versions: one MoE layer of each training example's step
    (train_lm's lm-100m, 8 x 128 tokens: top-2 of E = 8, C = 320, H =
    512, S = 64, L = 6, Dr = 64; the quickstart's 8 x 64: H = 64, Dr =
    32; elastic_restart's qwen3 smoke config, 4 x 32: H = 96), routing,
    LSH and the backwards, and serve_batch's MoE decode step (EX_SERVE's
    4 slots, the decode capacity of core/moe.moe_dense_dispatch)."""
    from repro_torch.configs.base import MOE
    from repro_torch.examples import elastic_restart, quickstart, train_lm
    for seed, ex in enumerate((train_lm, quickstart, elastic_restart), 51):
        name = ex.__name__.rsplit(".", 1)[1]
        config_kernels(torch, mods, ref, moe_lib, hashing, ex.build_config(),
                       ex.SEQ * ex.BATCH, f"examples {name}", seed,
                       wire=False)
    slots = EX_SERVE[0]
    for arch in EX_SERVE_ARCHS:
        cfg = registry.get_smoke_config(arch)
        if not any(f == MOE for _, f in cfg.layout):
            continue
        moe = cfg.moe
        cap = max(4, math.ceil(slots * moe.top_k / moe.num_experts * 2))
        decode = make_plan(torch, ref, T=slots, k=moe.top_k,
                           E=moe.num_experts, C=cap, H=cfg.d_model,
                           skew=False, bad_frac=0.0, seed=57)
        check_kernels(torch, mods["token_position"], mods["scatter_gather"],
                      ref, decode, f"examples serve_batch {arch} decode")


def phase_examples(torch, mods, ref, moe_lib, hashing, registry, kernels,
                   routing_kernels, path_kernels):
    """Phase examples: the path's kernels at the examples' shapes
    (examples_kernels), then the four scripts of repro_torch.examples on
    the card, each in a subprocess as ``python -m`` runs it.  train_lm's
    first run (the timed one) runs alone; then its resume and the other
    examples run at once, each process on the card beside the others.
    train_lm's checkpoints go to a directory of the checkout, removed
    afterwards."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.time()
    examples_kernels(torch, mods, ref, moe_lib, hashing, registry)
    torch.cuda.empty_cache()
    log(f"[time] examples kernels done at {time.time() - t0:.1f} s of the "
        "phase")
    workdir = ROOT / f".examples-{os.getpid()}"
    ckpt = ["--ckpt", str(workdir / "train_lm")]
    jobs = {"resumed": ("train_lm", ["--steps", str(EX_TRAIN_STEPS[1]),
                                     *ckpt]),
            "quickstart": ("quickstart", []),
            **{arch: ("serve_batch", ["--arch", arch])
               for arch in EX_SERVE_ARCHS},
            "elastic_restart": ("elastic_restart", [])}
    try:
        first = example_run("train_lm",
                            ["--steps", str(EX_TRAIN_STEPS[0]), *ckpt])
        with ThreadPoolExecutor(len(jobs)) as pool:
            futures = {k: pool.submit(example_run, *job)
                       for k, job in jobs.items()}
            runs = {k: f.result() for k, f in futures.items()}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    for run in (first, *runs.values()):
        _log_run(run)
    examples_quickstart(runs["quickstart"], kernels, path_kernels)
    out = {"train_lm": examples_train_lm([first, runs["resumed"]], kernels,
                                         path_kernels),
           "serve_batch": examples_serve(
               [runs[a] for a in EX_SERVE_ARCHS], kernels, routing_kernels,
               registry),
           "elastic_restart": examples_elastic(
               torch, runs["elastic_restart"], kernels, path_kernels)}
    log(f"[examples] phase time {time.time() - t0:.1f} s")
    return out


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
    from repro_torch import hw
    global HBM_BYTES_PER_S, FP32_OPS_PER_S, BF16_OPS_PER_S
    HBM_BYTES_PER_S, FP32_OPS_PER_S, BF16_OPS_PER_S = (
        hw.HBM_BYTES_PER_S, hw.FP32_FLOPS, hw.DEVICE_FLOPS)
    from repro_torch.comm import collectives
    from repro_torch.configs import registry
    from repro_torch.configs.registry import get_config
    from repro_torch.core import clustering, hashing
    from repro_torch.core import moe as moe_lib
    from repro_torch.data import synthetic
    from repro_torch.kernels import (build, dispatch, fused_wire, lsh_hash,
                                     ref, residual_apply, scatter_gather,
                                     segment_centroid, token_position,
                                     wire_quant)
    from repro_torch.launch import dryrun, serve, train
    from repro_torch.launch.profiling import summarize
    from repro_torch.models import model as model_lib
    from repro_torch.runtime import step as step_lib

    t_start = time.time()
    kernels = list(dispatch.KERNELS)
    smi = phase_device(torch)
    cell = dryrun_cell_start()
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
    phase_dryrun(torch, dryrun, step_lib, synthetic, kernels, cell)
    log(f"[time] dryrun done at {time.time() - t_start:.1f} s")
    cfg = get_config(ARCH)
    _, serve_launches = phase_serve(serve, kernels, routing_k, cfg)
    phase_parity(torch, model_lib, kernels, routing_k, cfg)
    log(f"[time] serve and decode parity done at "
        f"{time.time() - t_start:.1f} s")
    trained = phase_train(torch, train, kernels, routing_k, lsh_k,
                          dispatch.WIRE_KERNELS)
    torch.cuda.empty_cache()
    port_names = port_kernel_names(build)
    train_profile, slot_sets = phase_train_profile(
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
    torch.cuda.empty_cache()
    phase_placement(torch, step_lib, synthetic, registry)
    log(f"[time] placement done at {time.time() - t_start:.1f} s")
    phase_comm(torch, cfg, collectives, moe_lib, step_lib, synthetic,
               summarize, port_names, kernels,
               meshed["bf16"]["mesh (1, 1)"][0]["losses"][0])
    torch.distributed.destroy_process_group()
    log(f"[time] comm done at {time.time() - t_start:.1f} s")
    global WHOLE_BATCH_PEAK
    WHOLE_BATCH_PEAK = trained["on"][0]["peak_memory_bytes"]
    torch.cuda.empty_cache()
    phase_resilience(torch, train, cfg, model_lib, step_lib, synthetic,
                     clustering, lsh_hash, kernels, routing_k + lsh_k)
    log(f"[time] resilience done at {time.time() - t_start:.1f} s")
    torch.cuda.empty_cache()
    phase_obs(torch, train, serve, registry, cfg, model_lib, step_lib,
              synthetic, clustering, moe_lib, summarize, kernels,
              port_names, train_profile)
    log(f"[time] obs done at {time.time() - t_start:.1f} s")
    torch.cuda.empty_cache()
    phase_pipeline(torch, mods, ref, moe_lib, hashing, step_lib, synthetic,
                   kernels, path_k)
    log(f"[time] pipeline done at {time.time() - t_start:.1f} s")
    torch.cuda.empty_cache()
    phase_hybrid(torch, mods, ref, moe_lib, hashing, model_lib, step_lib,
                 synthetic, serve, clustering, kernels, routing_k, lsh_k)
    log(f"[time] hybrid done at {time.time() - t_start:.1f} s")
    torch.cuda.empty_cache()
    phase_tp(torch, model_lib, step_lib, synthetic, kernels,
             routing_k + lsh_k)
    log(f"[time] tp done at {time.time() - t_start:.1f} s")
    torch.cuda.empty_cache()
    phase_xlstm(torch, model_lib, step_lib, synthetic, serve, train,
                clustering, kernels)
    log(f"[time] xlstm done at {time.time() - t_start:.1f} s")
    torch.cuda.empty_cache()
    phase_archs(torch, model_lib, step_lib, synthetic, serve, train,
                clustering, kernels)
    log(f"[time] archs done at {time.time() - t_start:.1f} s")
    torch.cuda.empty_cache()
    phase_seqdecode(torch, model_lib, kernels, routing_k)
    log(f"[time] seqdecode done at {time.time() - t_start:.1f} s")
    torch.cuda.empty_cache()
    phase_examples(torch, mods, ref, moe_lib, hashing, registry, kernels,
                   routing_k, routing_k + lsh_k)
    log(f"[time] examples done at {time.time() - t_start:.1f} s")

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
