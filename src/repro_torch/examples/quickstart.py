"""Quickstart: LSH-MoE in ~60 lines (counterpart of
``examples/quickstart.py``).

Builds a small MoE transformer, runs one training step with the LSH
compression ON and OFF on the same params/batch, and prints the loss and
the measured wire-compression rate.

  PYTHONPATH=src python -m repro_torch.examples.quickstart
  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

The port's train step updates params and moments in place
(runtime/step.py), so each run steps its own copy of the initial state:
stepping one state twice, as the JAX script's functional step allows,
would start the LSH step from the params the baseline already moved.
"""
from __future__ import annotations

import argparse
import copy

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import (ATTN, MOE, LSHConfig, ModelConfig,
                                      MoEConfig, OptimizerConfig)
from repro_torch.core import clustering
from repro_torch.core.hashing import make_rotations
from repro_torch.data.pipeline import place
from repro_torch.data.synthetic import SyntheticLMDataset
from repro_torch.optim.adam import leaves
from repro_torch.runtime.step import (TrainState, init_train_state,
                                      make_train_step)

SEQ, BATCH = 64, 8
RUNS = ((False, "baseline (uncompressed a2a)"),
        (True, "LSH-MoE  (compressed a2a)"))


def build_config() -> ModelConfig:
    """The JAX example's ``quickstart-moe`` (bf16, bf16 wire)."""
    return ModelConfig(
        name="quickstart-moe", family="moe", d_model=64, num_heads=4,
        num_kv_heads=2, d_ff=128, vocab_size=512,
        layout=((ATTN, MOE),), num_super_blocks=2,
        moe=MoEConfig(num_experts=8, top_k=2, expert_ffn_dim=128,
                      lsh=LSHConfig(enabled=True, num_hashes=6,
                                    rotation_dim=32, compression_rate=0.25,
                                    wire_dtype="bfloat16")),
        remat_policy="dots", kv_chunk=32, dtype="bfloat16")


def build_optimizer() -> OptimizerConfig:
    return OptimizerConfig(lr=1e-3, warmup_steps=5, total_steps=50)


def run(cfg: ModelConfig, opt: OptimizerConfig, state: TrainState) -> dict:
    """One step of batch 0 with LSH off, then on, each from its own copy
    of ``state`` (which stays unstepped), then one group of 128 tokens
    compressed to the wire; prints the JAX example's lines and returns
    {"losses": [baseline, lsh], "wire": (tokens shape, centroids
    shape)}."""
    dev = leaves(state.params)[0].device
    batch = place(SyntheticLMDataset(cfg.vocab_size, SEQ, BATCH).batch_at(0),
                  dev)
    losses = []
    for use_lsh, tag in RUNS:
        step = make_train_step(cfg, opt, use_lsh=use_lsh)
        _, metrics = step(copy.deepcopy(state), batch)
        losses.append(float(metrics["loss"]))
        print(f"{tag}: loss={losses[-1]:.4f}")

    # what actually crosses the wire: centroids instead of tokens
    toks = torch.randn((1, 128, 64), device=dev,
                       generator=torch.Generator(dev).manual_seed(1))
    rot = make_rotations(torch.Generator(dev).manual_seed(2), 6, 64, 32,
                         torch.float32, device=dev)
    comp = clustering.compress(toks, torch.ones((1, 128), dtype=torch.bool,
                                                device=dev),
                               rot, 32, "cross_polytope")
    tokens, centroids = tuple(comp.tokens.shape), tuple(comp.centroids.shape)
    print(f"wire tensor: {tokens} tokens -> {centroids} centroids "
          f"({centroids[1] / tokens[1]:.0%} of the bytes); residuals stay "
          "local (error compensation).")
    return {"losses": losses, "wire": (tokens, centroids)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg, opt = build_config(), build_optimizer()
    run(cfg, opt, init_train_state(cfg, opt, seed=0, device=dev))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
