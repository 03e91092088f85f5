"""Mixture-of-Experts layers on one card (counterpart of
``repro/core/moe.py``).  Both paths share one pipeline:

    top_k_gating -> routing.build_dispatch_plan -> routing.dispatch_tokens
    -> expert MLP -> routing.combine_tokens

1. ``moe_expert_parallel`` (train / prefill, the paper's setting): the
   dispatch buffer is optionally LSH-compressed (core/clustering.py),
   exchanged over the model axis, run through the experts, exchanged back
   and error-compensated.  On one card the model axis has size 1, so each
   exchange is the identity up to the casts of its wire format; a model
   axis above one card is ROADMAP Queue 1 item 3.
2. ``moe_dense_dispatch`` (decode): tiny token counts, no compression.

The kernel ops run the hand-written CUDA kernels for CUDA tensors
(kernels/dispatch.py).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.core import clustering, routing
from repro_torch.core.gating import gating_losses, top_k_gating
from repro_torch.models.layers import activation


def padded_num_experts(num_experts: int, model_axis: int = 1) -> int:
    """Experts padded to a multiple of the model (expert-parallel) axis."""
    return int(math.ceil(num_experts / model_axis) * model_axis)


def expert_capacity(tokens_per_device: int, num_experts_padded: int,
                    top_k: int, capacity_factor: float) -> int:
    cap = int(math.ceil(tokens_per_device * top_k / num_experts_padded
                        * capacity_factor))
    return max(8, int(math.ceil(cap / 8) * 8))


def num_lsh_slots(capacity: int, rate: float, multiple: int = 1) -> int:
    """Slot count: ceil(rate * capacity) rounded up to lcm(8, multiple)."""
    unit = math.lcm(8, max(1, multiple))
    return max(unit, int(math.ceil(capacity * rate / unit) * unit))


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


# ---------------------------------------------------------------------------
# Path 1: expert-parallel (train / prefill) on one card.
# ---------------------------------------------------------------------------

def _bf16_exchange(t: torch.Tensor, wire_dtype: torch.dtype,
                   dtype: torch.dtype) -> torch.Tensor:
    """One leg of the "bf16" wire codec over a model axis of one card:
    encode to ``wire_dtype``, move (the identity), decode to ``dtype``.
    Autograd through the two casts gives the JAX codec's backward: the
    cotangent is cast to ``wire_dtype``, then to the primal's dtype."""
    return t.to(wire_dtype).to(dtype)


def _local_moe(x: torch.Tensor, params: Dict, cfg: MoEConfig, *,
               mlp_act: str, e_pad: int, capacity: int, use_lsh: bool,
               lsh_slots: int, wire_dtype: torch.dtype
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """The JAX ``_local_moe`` with a model axis of one card, in its order
    of casts.  x: [B, S, H] -> (y, aux, z, load)."""
    B, S, H = x.shape
    xf = x.reshape(B * S, H)
    gate = top_k_gating(xf, params["router_w"], cfg.top_k,
                        params["placement"])
    plan = routing.build_dispatch_plan(gate.expert_ids, gate.weights, e_pad,
                                       capacity)
    disp = routing.dispatch_tokens(plan, xf).to(x.dtype)
    wg, wu, wd = params.get("w_gate"), params["w_up"], params["w_down"]
    if use_lsh:
        comp = clustering.compress(disp, plan.occupancy, params["lsh_rot"],
                                   lsh_slots, cfg.lsh.hash_type,
                                   cfg.lsh.error_compensation,
                                   wire_format=cfg.lsh.wire_format,
                                   wire_dtype=wire_dtype)
        recv = _bf16_exchange(comp.centroids, wire_dtype, x.dtype)
        out = _expert_mlp(recv, wg, wu, wd, mlp_act)
        ret = _bf16_exchange(out, wire_dtype, x.dtype)
        out_tok = clustering.decompress(ret.to(torch.float32), comp)
    else:
        # no codec: the buffer crosses in the model dtype, unrounded
        out = _expert_mlp(disp.to(wire_dtype), wg, wu, wd, mlp_act)
        out_tok = out.to(wire_dtype).to(torch.float32)
    y = routing.combine_tokens(plan, out_tok)
    losses = gating_losses(gate, params["placement"])
    return (y.reshape(B, S, H).to(x.dtype), losses.aux_loss, losses.z_loss,
            plan.load())


def moe_expert_parallel(x: torch.Tensor, params: Dict, cfg: MoEConfig, *,
                        mlp_act: str, use_lsh: Optional[bool] = None
                        ) -> Tuple[torch.Tensor, Dict]:
    """x: [B, S, H] -> (y, {"aux_loss", "z_loss", "expert_load"}).

    params: router_w [H, E], w_gate / w_up [E_pad, H, F], w_down
    [E_pad, F, H], lsh_rot [L, H, Dr], placement [E].  The capacity is
    ``expert_capacity(B*S, E_pad, k, capacity_factor)`` and the slots
    ``num_lsh_slots(capacity, rate, multiple=overlap_chunks)``, as the JAX
    path has them with its default (auto) transport.  One card: a model
    axis over several is ROADMAP Queue 1 item 3."""
    B, S, _ = x.shape
    e_pad = params["w_up"].shape[0]
    capacity = expert_capacity(B * S, e_pad, cfg.top_k, cfg.capacity_factor)
    use_lsh = cfg.lsh.enabled if use_lsh is None else use_lsh
    if use_lsh or cfg.lsh.wire_format in clustering.QUANT_FORMATS:
        clustering.validate_wire_format(cfg.lsh.wire_format)
    chunk_mult = cfg.comm.overlap_chunks \
        if (cfg.comm.a2a_impl or "auto") in ("auto", "pipelined") else 1
    lsh_slots = num_lsh_slots(capacity, cfg.lsh.compression_rate,
                              multiple=chunk_mult) if use_lsh else 0
    wire_dtype = getattr(torch, cfg.lsh.wire_dtype) if use_lsh else x.dtype
    y, aux, z, load = _local_moe(
        x, params, cfg, mlp_act=mlp_act, e_pad=e_pad, capacity=capacity,
        use_lsh=use_lsh, lsh_slots=lsh_slots, wire_dtype=wire_dtype)
    return y, {"aux_loss": aux, "z_loss": z, "expert_load": load}

