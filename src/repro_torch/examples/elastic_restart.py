"""Elastic-scaling demo (counterpart of ``examples/elastic_restart.py``):
train, checkpoint, then RESTORE THE SAME CHECKPOINT onto a different
mesh shape -- the checkpoint stores logical arrays, so resharding
happens at load.

In one process both meshes are 1x1 over the same device, but the restore
path exercises the real reshard machinery (``load_checkpoint`` cuts each
leaf by the new mesh's specs, runtime/params.py).  The mesh path runs
its collectives over a process group: a one-rank group on a
``HashStore`` (no network) is started unless one already is.

  PYTHONPATH=src python -m repro_torch.examples.elastic_restart
"""
from __future__ import annotations

import argparse
import tempfile

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.checkpoint.checkpoint import (load_checkpoint,
                                               save_checkpoint)
from repro_torch.configs.base import ModelConfig, OptimizerConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.data.pipeline import place
from repro_torch.data.synthetic import SyntheticLMDataset
from repro_torch.launch.mesh import init_distributed, make_mesh
from repro_torch.runtime.params import train_state_specs
from repro_torch.runtime.step import init_train_state, make_train_step

ARCH = "qwen3-moe-30b-a3b"
STEPS = 3                         # on each mesh
SEQ, BATCH = 32, 4


def build_config() -> ModelConfig:
    return get_smoke_config(ARCH)


def build_optimizer() -> OptimizerConfig:
    return OptimizerConfig(lr=1e-3, warmup_steps=0, total_steps=20)


def run(cfg: ModelConfig, opt: OptimizerConfig, ckpt: str,
        device: torch.device) -> dict:
    """STEPS steps on mesh A from seed 0, a save to ``ckpt``, a restore
    into a freshly initialised state on mesh B, STEPS more steps.  Prints
    the JAX example's lines and returns {"state_a": mesh A's state as
    saved, "step0": the restored step, "losses": {step: loss} of both
    meshes, "state_b": mesh B's final state}."""
    started = not dist.is_initialized()
    init_distributed(device, store=dist.HashStore(), rank=0, world_size=1)
    try:
        return _run(cfg, opt, ckpt, device)
    finally:
        if started:
            dist.destroy_process_group()


def _run(cfg, opt, ckpt, device) -> dict:
    ds = SyntheticLMDataset(cfg.vocab_size, SEQ, BATCH)
    losses = {}

    mesh_a = make_mesh(1, 1)
    state = init_train_state(cfg, opt, seed=0, device=device, mesh=mesh_a)
    step = make_train_step(cfg, opt, mesh=mesh_a)
    for s in range(STEPS):
        state, m = step(state, place(ds.batch_at(s), device))
        losses[s + 1] = float(m["loss"])
    print(f"[mesh A {mesh_a.shape}] step {STEPS} loss {losses[STEPS]:.4f}")
    save_checkpoint(ckpt, STEPS, state, mesh=mesh_a,
                    specs=train_state_specs(cfg, mesh_a, opt.moment_dtype))

    # "new cluster shape": rebuild mesh, restore with ITS specs
    mesh_b = make_mesh(1, 1)
    template = init_train_state(cfg, opt, seed=0, device=device, mesh=mesh_b)
    state_b, step0, _ = load_checkpoint(
        ckpt, template, mesh=mesh_b,
        specs=train_state_specs(cfg, mesh_b, opt.moment_dtype))
    step_b = make_train_step(cfg, opt, mesh=mesh_b)
    for s in range(step0, step0 + STEPS):
        state_b, m = step_b(state_b, place(ds.batch_at(s), device))
        losses[s + 1] = float(m["loss"])
    print(f"[mesh B {mesh_b.shape}] resumed at {step0}, step "
          f"{step0 + STEPS} loss {losses[step0 + STEPS]:.4f}")
    print("elastic restore OK: same logical state, new mesh")
    return {"state_a": state, "step0": step0, "losses": losses,
            "state_b": state_b}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    with tempfile.TemporaryDirectory(prefix="elastic_") as ckpt:
        run(build_config(), build_optimizer(), ckpt, dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
