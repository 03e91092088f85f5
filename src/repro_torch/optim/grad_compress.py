"""Error-feedback int8 gradient all-reduce (counterpart of
``repro/optim/grad_compress.py``).

Each rank quantizes (gradient + carried error) to int8 with one absmax
scale a tensor, the dequantized values are averaged over the group, and
the quantization error is carried into the next step, so the bias
telescopes instead of accumulating.  As in the JAX package, no train step
calls it (``OptimizerConfig.grad_compression`` is a config field only).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.comm import collectives


def init_error_state(grads: List[Optional[torch.Tensor]]
                     ) -> List[Optional[torch.Tensor]]:
    """A zero f32 carry per gradient (None where the gradient is None)."""
    return [None if g is None else torch.zeros_like(g, dtype=torch.float32)
            for g in grads]


def compressed_psum(grads: List[Optional[torch.Tensor]],
                    error: List[Optional[torch.Tensor]], group
                    ) -> Tuple[List[Optional[torch.Tensor]],
                               List[Optional[torch.Tensor]]]:
    """(the gradients averaged over ``group`` through the int8 codec, the
    new error carry), leaf for leaf."""
    n = collectives.group_size(group)
    synced, carry = [], []
    for g, e in zip(grads, error):
        if g is None:
            synced.append(None)
            carry.append(e)
            continue
        gf = g.to(torch.float32) + e
        scale = torch.amax(torch.abs(gf)) / 127.0
        q = torch.round(gf / torch.clamp(scale, min=1e-12)).to(torch.int8)
        deq = q.to(torch.float32) * scale
        carry.append(gf - deq)
        synced.append((collectives.all_reduce_sum(deq, group) / n)
                      .to(g.dtype))
    return synced, carry
