"""Public routing ops (counterpart of the routing entries of
``repro/kernels/dispatch.py``).

The JAX registry chooses a backend by name, config and environment.  The
port chooses by device alone: a CUDA tensor takes the hand-written kernel,
a CPU tensor the plain version, and there is no switch between them.

Overflow-bin contract, as in the JAX package: an integer id outside its
valid range contributes nothing on the scatter direction and gathers zero
on the gather direction, so "dropped" is encoded by pointing the id at the
overflow bin instead of carrying a mask.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import scatter_gather, token_position

KERNELS = (token_position.KERNEL, scatter_gather.SCATTER,
           scatter_gather.GATHER)


def positions_in_expert(expert_ids: torch.Tensor, num_experts: int,
                        capacity: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stable dispatch-buffer row of each flattened (token, choice).

    expert_ids: [F] int32, token-major (earlier tokens win capacity).
    Returns (pos [F] int32, keep [F] bool, counts [E] int32).  Dropped
    entries land outside [0, capacity): over-capacity entries keep their
    raw rank (>= capacity), out-of-range ids get exactly capacity.  keep =
    landed within capacity; counts = uncapped per-expert demand."""
    pos, counts = token_position.positions_in_expert(expert_ids, num_experts)
    in_range = (expert_ids >= 0) & (expert_ids < num_experts)
    pos = torch.where(in_range, pos, capacity).to(torch.int32)
    return pos, pos < capacity, counts


# The scatter and gather wrappers are the public ops as they stand.
dispatch_scatter = scatter_gather.dispatch_scatter
combine_gather = scatter_gather.combine_gather
