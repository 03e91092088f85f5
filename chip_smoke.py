#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one H100 and check it.

  python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:
  1. device   CUDA with compute capability (9, 0); prints nvidia-smi's
              name and power limit.
  2. build    builds every kernel from src/repro_torch/kernels/csrc with
              nvcc for sm_90a (one nvcc per source, in parallel).
  3. kernels  holds each CUDA kernel against its plain PyTorch version on
              the card at the decode shape (F=32, E=40, C=4, H=1536) and at
              a train-like shape (F=32768, E=40, C=1024, H=1536), bitwise
              for integers and unique plans, and a duplicate-(e, c) scatter
              at a tolerance relative to the sum of the magnitudes; times
              kernel, plain version and the nearest single PyTorch call with
              CUDA events, beside each kernel's bound at 3.35 TB/s.
  4. serve    repro_torch.launch.serve.main at the full granite-moe-3b-a800m
              config (bf16, random weights from a seeded torch.Generator):
              8 requests, 4 slots, 16 prompt + 16 generated tokens, and
              checks each kernel ran once per MoE layer per decode step.
  5. parity   the same config cut to 2 layers in f32, 8 teacher-forced
              decode steps on the card (kernels) and on the CPU (plain
              versions) with the same params, TF32 off: logits within 1e-3
              and equal greedy tokens.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device, or without the rest
of the repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
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
DUP_RTOL = 1e-6
PARITY_ATOL = 1e-3
REPS = 30
SLEEP_CYCLES = 4_000_000           # ~2 ms at the H100's clocks


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
    logs = build.build_all(sorted({k.source for k in kernels}))
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


def _bound(bytes_moved, ops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _record(torch, label, name, kernel, plain, library, bound):
    """Hold ``kernel()`` against ``plain()`` bitwise and time the kernel
    (device time, and the whole call with the host's launch time), the plain
    version and the library call."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    for g, r in zip(got, want):
        if not torch.equal(g, r):
            raise AssertionError(f"[{label}] {name} differs from its plain "
                                 "version")
    b, by = bound
    return dict(
        max_abs_err=max(float((g.float() - r.float()).abs().max())
                        for g, r in zip(got, want)),
        ms=time_ms(torch, kernel), call_ms=time_ms(torch, kernel,
                                                   queued=False),
        plain_ms=time_ms(torch, plain),
        library_ms=None if library is None else time_ms(torch, library),
        bound_ms=b, bound_by=by)


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
            lambda: ref.positions_in_expert_ref(ids, E), None,
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
    if not bool((sg.combine_gather(flat, pos, buf, w)[~keep] == 0).all()):
        raise AssertionError(f"[{label}] dropped entries must gather zero")
    log(f"[kernels] {label}: F={F} E={E} C={C} H={H} kept={n_kept} "
        f"dropped={F - n_kept} (ids out of range or over capacity)")
    for name, r in out.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.6f}"
        log(f"[kernels] {label} {name}: kernel_ms={r['ms']:.6f} "
            f"call_ms={r['call_ms']:.6f} plain_ms={r['plain_ms']:.6f} "
            f"library_ms={lib} bound_us={r['bound_ms'] * 1e3:.3f} "
            f"({r['bound_by']}) max_abs_err={r['max_abs_err']}")
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
    want = ref.dispatch_scatter_ref(ids, pos, src, E, C)
    scale = ref.dispatch_scatter_ref(ids, pos, src.abs(), E, C)
    err = (got - want).abs()
    ok = bool((err <= DUP_RTOL * scale).all())
    log(f"[kernels] duplicates: F={F} into {E}x{C // 8} rows, max_abs_err="
        f"{float(err.max())} max rel-to-magnitude "
        f"{float((err / scale.clamp_min(1e-30)).max())} (rtol {DUP_RTOL})")
    if not ok:
        raise AssertionError("duplicate scatter outside tolerance")


def phase_kernels(torch, tp, sg, ref, moe_lib):
    # decode shape: 4 batch slots, top-8 of 40, capacity max(4, ceil(1.6))
    decode = make_plan(torch, ref, T=4, k=8, E=40, C=4, H=1536,
                       skew=False, bad_frac=0.0, seed=11)
    res_decode = check_kernels(torch, tp, sg, ref, decode, "decode")
    C_train = moe_lib.expert_capacity(4096, 40, 8, 1.25)
    train = make_plan(torch, ref, T=4096, k=8, E=40, C=C_train, H=1536,
                      skew=True, bad_frac=0.01, seed=12)
    if int(((train["ids"] >= 0) & (train["ids"] < 40)
            & ~train["keep"]).sum()) == 0:
        raise AssertionError("train-like plan has no over-capacity entries")
    res_train = check_kernels(torch, tp, sg, ref, train, "train-like")
    check_duplicates(torch, sg, ref, 40, C_train, 1536, 32768, seed=13)
    return res_decode, res_train


# ------------------------------------------------------------- 4. serve --

def phase_serve(serve, kernels, cfg):
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
    bad = {n: c for n, c in launches.items() if c != want}
    if bad:
        raise AssertionError(f"kernel launches on the serve path: {bad}, "
                             f"want {want} each")
    return s, launches


# ------------------------------------------------------------ 5. parity --

def phase_parity(torch, model_lib, kernels, cfg_full):
    """Same params on the card (kernels) and on the CPU (plain versions),
    f32 with TF32 off on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg_full.replace(num_super_blocks=2, dtype="float32")
    cpu = torch.device("cpu")
    params_cpu = model_lib.init_params(cfg, seed=3, device=cpu)

    def to_cuda(tree):
        if isinstance(tree, dict):
            return {k: to_cuda(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_cuda(v) for v in tree]
        return tree.to("cuda")

    params_gpu = to_cuda(params_cpu)
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
        if name == "cuda" and ran != [cfg.num_layers * 8] * len(kernels):
            raise AssertionError(f"parity run launched {ran}")
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
    from repro_torch.configs.registry import get_config
    from repro_torch.core import moe as moe_lib
    from repro_torch.kernels import build, dispatch, ref
    from repro_torch.kernels import scatter_gather as sg
    from repro_torch.kernels import token_position as tp
    from repro_torch.launch import serve
    from repro_torch.models import model as model_lib

    t_start = time.time()
    kernels = list(dispatch.KERNELS)
    smi = phase_device(torch)
    phase_build(build, kernels)
    res_decode, _ = phase_kernels(torch, tp, sg, ref, moe_lib)
    cfg = get_config(ARCH)
    _, launches = phase_serve(serve, kernels, cfg)
    phase_parity(torch, model_lib, kernels, cfg)

    record = {"kernels": [
        {"name": k.name, "route": "cuda", "source": build.source_path(k),
         "replaces": k.replaces, "launches": launches[k.name],
         **{key: res_decode[k.name][key] for key in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")}}
        for k in kernels]}
    log(f"[done] {time.time() - t_start:.1f} s; card {smi}")
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
