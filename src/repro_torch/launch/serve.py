"""Batched serving loop (counterpart of ``repro/launch/serve.py``): prompts
fed through teacher-forced decode steps, then greedy generation, in
batches of ``--batch-slots`` requests.

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch granite-moe-3b-a800m --requests 8 --gen 16

Runs on the CUDA device unless ``--device cpu``.  ``serve_loop`` runs the
same loop on a given ``ModelConfig`` (a config cut to size, for example).
Latency is per request, arrival -> completion, with every request arriving at t0 (so it includes
queueing behind earlier batches), as the JAX launcher defines it.  The
events go through obs/events.py: one JSON line per request
(``serve_request``) and a final ``serve_summary`` line with requests,
tokens, tokens/s and p50/p99 latency, printed; ``--metrics-dir DIR``
appends them to ``DIR/events.jsonl``.  ``--bench-json DIR`` appends a
``serve`` row (p50 / p99 latency, tokens/s per device) to
``DIR/BENCH_<--bench-name>.json`` (obs/benchrow.py), which the JAX
package's ``load_rows`` reads too.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List

_JSON_KINDS = ("serve_request", "serve_summary")


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile on an already-sorted list."""
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1,
            max(0, int(round(q / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[i]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--metrics-dir", default="",
                    help="also append the events (JSON lines) to "
                         "DIR/events.jsonl")
    ap.add_argument("--bench-json", default="",
                    help="append a serve bench row (p50/p99 latency, "
                         "tokens/s per device) to BENCH_<name>.json in "
                         "this directory (obs/benchrow.py)")
    ap.add_argument("--bench-name", default="serve_smoke",
                    help="trajectory name for --bench-json")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch import resolve_device
    from repro_torch.obs import events as obs_events
    from repro_torch.obs import export as obs_export

    dev = resolve_device(args.device)
    log = obs_events.global_log()
    sinks = [log.add_sink(lambda ev: print(
        ev.to_json() if ev.kind in _JSON_KINDS else obs_events.render(ev),
        file=sys.stderr if ev.kind == "error" else sys.stdout,
        flush=True))]
    jsonl = None
    if args.metrics_dir:
        jsonl = obs_events.JsonlSink(
            os.path.join(args.metrics_dir, obs_export.EVENTS_NAME))
        sinks.append(log.add_sink(jsonl))
    try:
        return _serve(args, dev)
    finally:
        for s in sinks:
            log.remove_sink(s)
        if jsonl is not None:
            jsonl.close()


def _serve(args, dev) -> int:
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.obs import benchrow
    from repro_torch.obs.events import emit

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    s = serve_loop(cfg, dev, requests=args.requests, gen=args.gen,
                   prompt_len=args.prompt_len, batch_slots=args.batch_slots,
                   smoke=args.smoke)
    if args.bench_json:
        row = benchrow.bench_row(
            name=args.bench_name, kind="serve",
            metrics={k: float(s[k]) for k in (
                "latency_p50_s", "latency_p99_s", "tokens_per_s",
                "tokens_per_s_device", "requests", "tokens")},
            context={"arch": args.arch, "smoke": args.smoke,
                     "gen": args.gen, "prompt_len": args.prompt_len,
                     "batch_slots": args.batch_slots, "devices": 1,
                     "device": s["device"]})
        path = benchrow.append_row(args.bench_json, row)
        emit("bench_row", name=args.bench_name, row_kind="serve",
             path=path)
    return 0


def serve_loop(cfg, dev, *, requests: int = 8, gen: int = 16,
               prompt_len: int = 16, batch_slots: int = 4,
               params=None, smoke: bool = False) -> dict:
    """The serving loop on ``cfg`` (seeded random params unless ``params``
    are given) on device ``dev``: emits one ``serve_request`` event a
    request and a ``serve_summary``, and returns the summary's fields."""
    import torch

    from repro_torch.models import model as model_lib
    from repro_torch.obs.events import emit

    B = batch_slots
    max_len = prompt_len + gen
    n_dev = 1
    if params is None:
        params = model_lib.init_params(cfg, seed=0, device=dev)
    prompt_gen = torch.Generator().manual_seed(1)
    done = 0
    tokens_out = 0
    latencies = []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.time()                    # every request "arrives" at t0
    while done < requests:
        n = min(B, requests - done)
        prompts = torch.randint(0, cfg.vocab_size, (B, prompt_len),
                                generator=prompt_gen).to(dev)
        state = model_lib.init_decode_state(cfg, B, max_len, device=dev)
        # prefill via teacher-forced decode (exercises the cache path)
        for i in range(prompt_len):
            logits, state = model_lib.decode_step(params, cfg, state,
                                                  prompts[:, i:i + 1])
        tok = torch.argmax(logits, -1)
        for _ in range(gen):
            logits, state = model_lib.decode_step(params, cfg, state, tok)
            tok = torch.argmax(logits, -1)
            tokens_out += n
        tok.cpu()                       # waits for the batch to finish
        t_done = time.time()
        for r in range(done, done + n):
            latencies.append(t_done - t0)
            emit("serve_request", request=r, latency_s=t_done - t0,
                 tokens=gen)
        done += n
    dt = max(1e-9, time.time() - t0)
    latencies.sort()
    device = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else "cpu"
    summary = dict(requests=requests, tokens=tokens_out, dt=dt,
                   tokens_per_s=tokens_out / dt,
                   tokens_per_s_device=tokens_out / dt / n_dev,
                   latency_p50_s=_percentile(latencies, 50),
                   latency_p99_s=_percentile(latencies, 99), device=device,
                   arch=cfg.name, smoke=smoke)
    emit("serve_summary", **summary)
    return summary


if __name__ == "__main__":
    raise SystemExit(main())
