"""Mixture-of-Experts layer, dense-dispatch (decode) path on one card
(counterpart of ``repro/core/moe.py``).

    top_k_gating -> routing.build_dispatch_plan -> routing.dispatch_tokens
    -> expert MLP -> routing.combine_tokens

The three routing ops run the hand-written CUDA kernels for CUDA tensors
(kernels/dispatch.py).  The expert-parallel path (train / prefill, with LSH
compression and the all-to-all) and a model axis above one card come with
later slices (ROADMAP.md).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.core import routing
from repro_torch.core.gating import top_k_gating
from repro_torch.models.layers import activation


def padded_num_experts(num_experts: int, model_axis: int = 1) -> int:
    """Experts padded to a multiple of the model (expert-parallel) axis."""
    return int(math.ceil(num_experts / model_axis) * model_axis)


def expert_capacity(tokens_per_device: int, num_experts_padded: int,
                    top_k: int, capacity_factor: float) -> int:
    cap = int(math.ceil(tokens_per_device * top_k / num_experts_padded
                        * capacity_factor))
    return max(8, int(math.ceil(cap / 8) * 8))


def _expert_mlp(tok: torch.Tensor, w_gate: Optional[torch.Tensor],
                w_up: torch.Tensor, w_down: torch.Tensor,
                mlp_act: str) -> torch.Tensor:
    """[E, t, H] tokens through the per-expert MLP stack -> [E, t, H]."""
    h = torch.bmm(tok, w_up)
    g = torch.bmm(tok, w_gate) if mlp_act == "swiglu" else None
    return torch.bmm(activation(h, g, mlp_act), w_down)


def moe_dense_dispatch(x: torch.Tensor, params: Dict, cfg: MoEConfig, *,
                       mlp_act: str, model_axis: int = 1) -> torch.Tensor:
    """x: [B, S, H] with tiny B*S (decode) -> y [B, S, H].

    The JAX package's ``_moe_dense_gspmd`` on one card: no collectives.
    The f32 dispatch buffer is cast to the model dtype before the expert
    MLP, and the expert output back to f32 before the combine.  The JAX
    stats (aux / z losses, expert load) are not made: decode reads none of
    them, and ``gating.gating_losses`` gives them to a caller that does."""
    if model_axis > 1:
        raise NotImplementedError(
            "moe_dense_dispatch over a model axis of more than one card is "
            "ROADMAP Queue 1 item 3 (expert parallelism over "
            "torch.distributed)")
    e_pad = params["w_up"].shape[0]
    B, S, H = x.shape
    xf = x.reshape(B * S, H)
    gate = top_k_gating(xf, params["router_w"], cfg.top_k,
                        params["placement"])
    cap = max(4, int(math.ceil(B * S * cfg.top_k / e_pad * 2)))
    plan = routing.build_dispatch_plan(gate.expert_ids, gate.weights, e_pad,
                                       cap)
    disp = routing.dispatch_tokens(plan, xf).to(x.dtype)
    eo = _expert_mlp(disp, params.get("w_gate"), params["w_up"],
                     params["w_down"], mlp_act)
    y = routing.combine_tokens(plan, eo.to(torch.float32))
    return y.reshape(B, S, H).to(x.dtype)
