"""Learning-rate schedules (counterpart of ``repro/optim/schedule.py``)."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step: torch.Tensor, lr: float, warmup_steps: int,
                  total_steps: int, min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warm-up (never 0 at step 0), then cosine decay to
    ``min_ratio * lr``; f32 arithmetic on the step tensor, as in JAX."""
    s = step.to(torch.float32)
    warm = lr * (s + 1.0) / max(1, warmup_steps)
    prog = torch.clamp((s - warmup_steps) / max(1, total_steps - warmup_steps),
                       0.0, 1.0)
    cos = lr * (min_ratio + (1 - min_ratio) * 0.5
                * (1 + torch.cos(math.pi * prog)))
    return torch.where(s < warmup_steps, warm, cos)
