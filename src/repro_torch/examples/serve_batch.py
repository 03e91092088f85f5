"""Batched serving example (counterpart of ``examples/serve_batch.py``):
greedy-decode a batch of prompts from a small model using the KV-cache /
recurrent-state decode path (the same ``decode_step`` the decode_32k /
long_500k dry-run cells trace).

  PYTHONPATH=src python -m repro_torch.examples.serve_batch --arch smollm-360m
  PYTHONPATH=src python -m repro_torch.examples.serve_batch --arch xlstm-350m

(xlstm-350m takes the recurrent-state path, an SSM's.)

The prompts come from a ``torch.Generator`` seeded 1, so they are not the
JAX example's ``jax.random.randint`` draws (the tests hand both the same
prompts).  whisper-base decodes without audio frames, as in JAX.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.models import model as model_lib


def run(cfg: ModelConfig, params, prompts: torch.Tensor, gen: int) -> dict:
    """Prefill ``prompts`` ([B, P] integers on the params' device) one
    token a decode step, then decode ``gen`` tokens greedily.  Returns
    {"tokens": [B, gen] numpy, "seconds": host time from the first
    decode step to the last token on the host}."""
    B, P = prompts.shape
    state = model_lib.init_decode_state(cfg, B, P + gen,
                                        device=prompts.device)
    t0 = time.time()
    for i in range(P):                          # prefill (cache fill)
        logits, state = model_lib.decode_step(params, cfg, state,
                                              prompts[:, i:i + 1])
    generated = []
    tok = torch.argmax(logits, -1)
    for _ in range(gen):                        # autoregressive decode
        generated.append(tok[:, 0])
        logits, state = model_lib.decode_step(params, cfg, state, tok)
        tok = torch.argmax(logits, -1)
    tokens = torch.stack(generated, 1).cpu().numpy()
    return {"tokens": tokens, "seconds": time.time() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--gen", type=int, default=20)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    params = model_lib.init_params(cfg, seed=0, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=torch.Generator().manual_seed(1)
                            ).to(dev)
    out = run(cfg, params, prompts, args.gen)
    gen = out["tokens"]
    print(f"arch={args.arch} generated {gen.shape} tokens in "
          f"{out['seconds']:.2f}s")
    for b in range(args.batch):
        print(f"  seq{b}: {gen[b].tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
