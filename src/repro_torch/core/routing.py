"""Token routing behind a DispatchPlan (counterpart of
``repro/core/routing.py``).

  top_k_gating -> build_dispatch_plan -> dispatch_tokens ([E, C, H])
                                      -> combine_tokens  ([T, H])

Drops use the overflow-bin contract (kernels/dispatch.py): a dropped
(token, choice) carries expert id == num_experts and a position outside
[0, capacity), so the scatter ignores it and the gather returns zero.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import dispatch


class DispatchPlan(NamedTuple):
    """Routing state for one MoE layer invocation.  F = T * top_k
    flattened (token, choice) entries, token-major.  Expert ids are
    physical (post-placement)."""
    expert_ids: torch.Tensor   # [T, k] int32
    weights: torch.Tensor      # [T, k] f32 renormalized combine weights
    flat_ids: torch.Tensor     # [F] int32; == num_experts where dropped
    positions: torch.Tensor    # [F] int32; >= capacity where dropped
    keep: torch.Tensor         # [F] bool
    counts: torch.Tensor       # [E] int32 uncapped demand (physical)
    num_experts: int
    capacity: int
    top_k: int

    @property
    def num_tokens(self) -> int:
        return self.expert_ids.shape[0]

    @property
    def occupancy(self) -> torch.Tensor:
        """[E, C] bool: the dispatch-buffer rows that filled.  A property,
        not a field as in JAX, so that decode (which never reads it)
        launches nothing for it."""
        return (torch.arange(self.capacity, device=self.counts.device)[None]
                < torch.clamp(self.counts, max=self.capacity)[:, None])

    def load(self) -> torch.Tensor:
        """[E] f32 routed-token counts (uncapped, physical order)."""
        return self.counts.to(torch.float32)

    def drop_fraction(self) -> torch.Tensor:
        F = self.keep.shape[0]
        return 1.0 - self.keep.sum().to(torch.float32) / max(1, F)


def build_dispatch_plan(expert_ids: torch.Tensor, weights: torch.Tensor,
                        num_experts: int, capacity: int) -> DispatchPlan:
    """expert_ids/weights: [T, k] from the gate (physical ids)."""
    T, k = expert_ids.shape
    e_flat = expert_ids.reshape(T * k).to(torch.int32).contiguous()
    pos, keep, counts = dispatch.positions_in_expert(e_flat, num_experts,
                                                     capacity)
    flat_ids = torch.where(keep, e_flat, num_experts).to(torch.int32)
    return DispatchPlan(expert_ids, weights, flat_ids, pos, keep, counts,
                        num_experts, capacity, k)


def dispatch_tokens(plan: DispatchPlan, tokens: torch.Tensor) -> torch.Tensor:
    """tokens: [T, H] -> dispatch buffer [E, C, H] f32."""
    src = torch.repeat_interleave(tokens, plan.top_k, dim=0)  # [F, H]
    return dispatch.dispatch_scatter(plan.flat_ids, plan.positions,
                                     src.contiguous(), plan.num_experts,
                                     plan.capacity)


def combine_tokens(plan: DispatchPlan, buf: torch.Tensor) -> torch.Tensor:
    """buf: [E, C, H] per-expert outputs -> [T, H] f32 weighted top-k
    combine; dropped entries contribute a zero row."""
    T, k = plan.weights.shape
    w_flat = plan.weights.reshape(T * k).to(torch.float32).contiguous()
    out = dispatch.combine_gather(plan.flat_ids, plan.positions,
                                  buf.contiguous(), w_flat)  # [F, H]
    return out.reshape(T, k, -1).sum(dim=1)
