"""End-to-end training (counterpart of ``examples/train_lm.py``): pre-train
a ~100M-param MoE LM for a few hundred steps on the synthetic Zipfian
stream with the full production loop (async checkpointing, NaN-skip,
watchdog, straggler monitor, LSH-MoE on).

  PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300
  # interrupted? re-run the same command: it resumes from the last
  # committed checkpoint.

~100M params: d_model=512, 8 layers (4 MoE x 8 experts of d_ff=1024,
active ~62M), vocab 8192.  The checkpoints go to repro_torch_train_lm
in the temporary directory (``$TMPDIR``, else /tmp) unless ``--ckpt``
says otherwise: not the JAX example's directory, whose files this one
would otherwise resume.  A
resumed run is bitwise the uninterrupted one when its arguments are the
same: the batches are a function of the step, the restore gives back
every byte of the state, and ``--steps`` fixes the schedule.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

from repro_torch import resolve_device
from repro_torch.checkpoint.checkpoint import (CheckpointManager,
                                               load_checkpoint)
from repro_torch.configs.base import (ATTN, DENSE, MOE, LSHConfig,
                                      ModelConfig, MoEConfig,
                                      OptimizerConfig, active_param_count,
                                      param_count)
from repro_torch.data.pipeline import place
from repro_torch.data.synthetic import SyntheticLMDataset
from repro_torch.optim.adam import leaves
from repro_torch.runtime.fault import StepWatchdog, StragglerMonitor
from repro_torch.runtime.step import (TrainState, init_train_state,
                                      make_train_step)

CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_train_lm")
CKPT_EVERY = 100                  # steps between saves; one more at the end
LOG_EVERY = 20
SEQ, BATCH = 128, 8
WATCHDOG_S = 600.0


def build_config() -> ModelConfig:
    """The JAX example's ``lm-100m`` (bf16, bf16 wire)."""
    return ModelConfig(
        name="lm-100m", family="moe", d_model=512, num_heads=8,
        num_kv_heads=4, d_ff=2048, vocab_size=8192,
        layout=((ATTN, DENSE), (ATTN, MOE)),
        num_super_blocks=4,
        moe=MoEConfig(num_experts=8, top_k=2, expert_ffn_dim=1024,
                      lsh=LSHConfig(enabled=True, num_hashes=6,
                                    rotation_dim=64, compression_rate=0.2,
                                    wire_dtype="bfloat16")),
        remat_policy="dots", kv_chunk=128, dtype="bfloat16")


def build_optimizer(steps: int) -> OptimizerConfig:
    return OptimizerConfig(lr=3e-4, warmup_steps=30, total_steps=steps)


def run(cfg: ModelConfig, opt: OptimizerConfig, state: TrainState, *,
        steps: int, ckpt: str) -> dict:
    """Train ``state`` (a fresh state: its tensors are updated in place),
    or the newest committed checkpoint in ``ckpt`` restored into it, up
    to ``steps``; saves every CKPT_EVERY steps and at the end, and lets
    a save in flight finish when the loop is interrupted.  Prints
    the JAX example's lines and returns {"start": the step it began at,
    "losses": {step: loss}, "state": the final state}."""
    dev = leaves(state.params)[0].device
    ds = SyntheticLMDataset(cfg.vocab_size, SEQ, BATCH)
    mgr = CheckpointManager(ckpt, keep=2)
    watchdog = StepWatchdog(WATCHDOG_S)
    mon = StragglerMonitor()
    losses = {}
    try:
        start = 0
        if mgr.latest_step() is not None:
            state, start, _ = load_checkpoint(ckpt, state)
            print(f"resumed from step {start}")
        step_fn = make_train_step(cfg, opt)
        for s in range(start, steps):
            watchdog.arm()
            t0 = time.time()
            state, m = step_fn(state, place(ds.batch_at(s), dev))
            losses[s] = loss = float(m["loss"])
            watchdog.disarm()
            mon.record(s, time.time() - t0)
            if s % LOG_EVERY == 0:
                print(f"step {s}: loss {loss:.4f} ce {float(m['ce']):.4f} "
                      f"skips {int(m['grad_skips'])}", flush=True)
            if (s + 1) % CKPT_EVERY == 0:
                mgr.save_async(s + 1, state)
        if start < steps:
            mgr.save_async(steps, state)
    finally:
        watchdog.stop()
        mgr.wait()        # a save in flight is committed, interrupted or not
    final = f"final loss {losses[steps - 1]:.4f}" if losses else \
        f"nothing to run from step {start}"
    print(f"done. {final}; checkpoints in {ckpt}")
    return {"start": start, "losses": losses, "state": state}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt", default=CKPT_DIR)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = build_config()
    print(f"params: {param_count(cfg) / 1e6:.1f}M "
          f"(active/token ~{active_param_count(cfg) / 1e6:.1f}M)")
    opt = build_optimizer(args.steps)
    run(cfg, opt, init_train_state(cfg, opt, seed=0, device=dev),
        steps=args.steps, ckpt=args.ckpt)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
