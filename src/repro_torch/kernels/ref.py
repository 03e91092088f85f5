"""Plain PyTorch versions of the routing kernels (counterpart of
``repro/kernels/ref.py``).  The kernel wrappers run these for tensors on the
CPU; ``chip_smoke.py`` holds each CUDA kernel against them on the card.

All three keep the registry's overflow-bin contract: an entry whose expert
id lies outside [0, E) (or whose position lies outside [0, C)) contributes
nothing to a scatter and gathers exactly zero.
"""
from __future__ import annotations

from typing import Tuple

import torch


def positions_in_expert_ref(expert_ids: torch.Tensor, num_experts: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[F] int32 ids -> (pos [F] int32, counts [E] int32): pos[f] = number
    of earlier entries routed to the same expert (token-major stability),
    counts[e] = uncapped total.  Ids outside [0, E) get pos 0 and are
    counted nowhere.  Cumsum over a one-hot, as the JAX oracle."""
    experts = torch.arange(num_experts, device=expert_ids.device)
    onehot = (expert_ids[:, None] == experts[None, :]).to(torch.int32)
    incl = torch.cumsum(onehot, dim=0, dtype=torch.int32)
    pos = torch.sum(onehot * (incl - 1), dim=1, dtype=torch.int32)
    return pos, onehot.sum(dim=0, dtype=torch.int32)


def _flat_rows(expert_ids: torch.Tensor, pos: torch.Tensor, num_experts: int,
               capacity: int) -> torch.Tensor:
    """Row e*C + c of the flattened [E*C] buffer for in-range entries, and
    the dump row E*C for every other entry."""
    in_range = ((expert_ids >= 0) & (expert_ids < num_experts)
                & (pos >= 0) & (pos < capacity))
    rows = expert_ids.long() * capacity + pos.long()
    return torch.where(in_range, rows, num_experts * capacity)


def dispatch_scatter_ref(expert_ids: torch.Tensor, pos: torch.Tensor,
                         src: torch.Tensor, num_experts: int,
                         capacity: int) -> torch.Tensor:
    """[F] ids, [F] positions, [F, H] tokens -> [E, C, H] f32 buffer with
    buf[e, c] = sum of src[f] over entries with (id, pos) == (e, c)."""
    H = src.shape[1]
    rows = _flat_rows(expert_ids, pos, num_experts, capacity)
    buf = torch.zeros(num_experts * capacity + 1, H, dtype=torch.float32,
                      device=src.device)
    buf.index_add_(0, rows, src.to(torch.float32))
    return buf[:-1].view(num_experts, capacity, H)


def combine_gather_ref(expert_ids: torch.Tensor, pos: torch.Tensor,
                       buf: torch.Tensor, weights: torch.Tensor
                       ) -> torch.Tensor:
    """[F] ids, [F] positions, [E, C, H] buffer, [F] weights -> [F, H] f32
    = weights[f] * buf[id_f, pos_f]; out-of-range entries gather zero."""
    E, C, _ = buf.shape
    in_range = ((expert_ids >= 0) & (expert_ids < E)
                & (pos >= 0) & (pos < C))
    gathered = buf.to(torch.float32)[expert_ids.long().clamp(0, E - 1),
                                     pos.long().clamp(0, C - 1)]
    return gathered * (weights.to(torch.float32)
                       * in_range.to(torch.float32))[:, None]
