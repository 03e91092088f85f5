"""Top-k softmax gating, and its load-balance and router-z auxiliary losses
(counterpart of ``repro/core/gating.py``).

The JAX ``top_k_gating`` returns the losses with the routing; under jit the
decode path's unused losses are deleted.  Eager PyTorch would launch them
anyway, so here they are a function of their own, ``gating_losses``, which
only a caller that reads them (a training step, the tests) calls."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class GateOut(NamedTuple):
    expert_ids: torch.Tensor   # [T, k] int32 (physical slots when placed)
    weights: torch.Tensor      # [T, k] f32 (renormalized top-k softmax)
    logits: torch.Tensor       # [T, E] f32 router logits, logical order


class GateLosses(NamedTuple):
    aux_loss: torch.Tensor     # scalar
    z_loss: torch.Tensor       # scalar
    load: torch.Tensor         # [E] f32 token counts, physical order


def top_k_gating(x: torch.Tensor, router_w: torch.Tensor, top_k: int,
                 placement: Optional[torch.Tensor] = None) -> GateOut:
    """x: [T, H]; router_w: [H, E]; placement: optional permutation logical
    expert -> physical slot.

    Ties between equal probabilities go to the lower expert index, as
    ``jax.lax.top_k`` does: a stable descending sort, then the first k
    (``torch.topk`` promises no order among ties)."""
    logits = x.to(torch.float32) @ router_w.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                    # [T, E]
    sorted_p, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = sorted_p[:, :top_k], order[:, :top_k]
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    if placement is not None:
        ids = placement[ids]
    return GateOut(ids.to(torch.int32), weights, logits)


def gating_losses(gate: GateOut,
                  placement: Optional[torch.Tensor] = None) -> GateLosses:
    """The JAX ``top_k_gating``'s aux / z losses and load for ``gate``, made
    with the same ``placement``.  The losses stay in logical space; ``load``
    is reported in physical slot order."""
    logits = gate.logits
    probs = torch.softmax(logits, dim=-1)                    # [T, E]
    E = logits.shape[-1]
    ids = gate.expert_ids.long()
    if placement is not None:
        ids = torch.argsort(placement)[ids]                  # back to logical
    # Switch-style load balance: E * sum_e f_e * p_e
    mask = torch.zeros_like(probs).scatter_add_(
        1, ids, torch.ones(ids.shape, dtype=probs.dtype, device=ids.device))
    f = mask.mean(dim=0)
    p = probs.mean(dim=0)
    aux = E * torch.sum(f * p)
    z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    load = mask.sum(dim=0)                                   # logical order
    if placement is not None:
        load = torch.zeros_like(load).index_copy_(0, placement.long(), load)
    return GateLosses(aux, z, load)
