"""The training step on one card (counterpart of ``repro/runtime/step.py``).

  train_step(state, batch) -> (state, metrics)

forward + loss (models/model.py), gradients by autograd, then the shared
optimizer tail ``apply_gradients``: the warm-up-cosine learning rate, the
non-finite-loss skip and AdamW.  The state's params and moments are
updated in place (optim/adam.py); the returned state holds the same
tensors.  Microbatching is not ported, and neither are meshes: pipeline
stages (ROADMAP Queue 1 item 6) and data parallelism over several cards
(item 3).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike
from repro_torch.configs.base import ModelConfig, OptimizerConfig
from repro_torch.models import model as model_lib
from repro_torch.optim.adam import (OptState, adamw_init, adamw_update,
                                    leaves)
from repro_torch.optim.schedule import warmup_cosine


class TrainState(NamedTuple):
    params: Any
    opt: OptState


def init_train_state(cfg: ModelConfig, opt_cfg: OptimizerConfig, *,
                     seed: int = 0, device: DeviceLike = None) -> TrainState:
    params = model_lib.init_params(cfg, seed=seed, device=device)
    return TrainState(params, adamw_init(params, opt_cfg))


def apply_gradients(state: TrainState, opt_cfg: OptimizerConfig,
                    loss: torch.Tensor, metrics: Dict,
                    grads) -> Tuple[TrainState, Dict]:
    """Shared optimizer tail: lr schedule, non-finite skip, AdamW."""
    lr = warmup_cosine(state.opt.step, opt_cfg.lr, opt_cfg.warmup_steps,
                       opt_cfg.total_steps)
    skip = ~torch.isfinite(loss)
    new_opt = adamw_update(state.params, grads, state.opt, opt_cfg, lr,
                           skip=skip)
    metrics = dict(metrics, lr=lr, grad_skips=new_opt.grad_skips)
    return TrainState(state.params, new_opt), metrics


def batch_to_device(batch: Dict[str, np.ndarray],
                    device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig, *,
                    use_lsh: Optional[bool] = None, microbatch: int = 0):
    """Returns train_step(state, batch) -> (state, metrics); batch holds
    "tokens" and "labels" [B, S] integer tensors on the params' device."""
    if microbatch:
        raise NotImplementedError(
            "microbatched gradient accumulation is not ported (ROADMAP "
            "Queue 1 item 5, the trainer)")

    def train_step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        params = leaves(state.params)
        trainable = [p for p in params if p.is_floating_point()]
        for p in trainable:
            p.requires_grad_(True)
        with torch.enable_grad():
            loss, metrics = model_lib.loss_fn(state.params, cfg, batch,
                                              use_lsh=use_lsh)
            got = iter(torch.autograd.grad(loss, trainable,
                                           allow_unused=True))
        # a floating leaf without a gradient (the detached hash rotations)
        # gets zeros, as JAX gives it; integer leaves get None
        grads = []
        for p in params:
            g = next(got) if p.is_floating_point() else None
            if g is None and p.is_floating_point():
                g = torch.zeros_like(p)
            grads.append(g)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return apply_gradients(state, opt_cfg, loss.detach(), metrics, grads)

    return train_step
