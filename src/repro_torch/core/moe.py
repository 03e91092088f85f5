"""Mixture-of-Experts layers on one card (counterpart of
``repro/core/moe.py``).  Both paths share one pipeline:

    top_k_gating -> routing.build_dispatch_plan -> routing.dispatch_tokens
    -> expert MLP -> routing.combine_tokens

1. ``moe_expert_parallel`` (train / prefill, the paper's setting): the
   dispatch buffer is optionally LSH-compressed (core/clustering.py),
   exchanged over the model axis, run through the experts, exchanged back
   and error-compensated.  On one card the model axis has size 1, so each
   exchange is the identity up to its wire format's codec (comm/wire.py:
   bf16 casts, or an int8 / fp8 payload with scales, fused into the
   routing kernels unless $REPRO_FUSED_WIRE=0); a model axis above one
   card is ROADMAP Queue 1 item 3.
2. ``moe_dense_dispatch`` (decode): tiny token counts, no compression.

The kernel ops run the hand-written CUDA kernels for CUDA tensors
(kernels/dispatch.py).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.comm import wire as wire_lib
from repro_torch.configs.base import MoEConfig
from repro_torch.core import clustering, routing
from repro_torch.core.gating import gating_losses, top_k_gating
from repro_torch.kernels.wire_quant import QUANT_FORMATS
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

def _local_moe(x: torch.Tensor, params: Dict, cfg: MoEConfig, *,
               mlp_act: str, e_pad: int, capacity: int, use_lsh: bool,
               lsh_slots: int, wire_dtype: torch.dtype,
               codec: Optional[wire_lib.WireCodec]
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """The JAX ``_local_moe`` with a model axis of one card, in its order
    of casts.  x: [B, S, H] -> (y, aux, z, load)."""
    R = 1                                     # the model axis
    B, S, H = x.shape
    T = B * S
    xf = x.reshape(T, H)
    gate = top_k_gating(xf, params["router_w"], cfg.top_k,
                        params["placement"])
    plan = routing.build_dispatch_plan(gate.expert_ids, gate.weights, e_pad,
                                       capacity)
    wg, wu, wd = params.get("w_gate"), params["w_up"], params["w_down"]
    # Fused codec path: a quantized wire whose leaves move whole, the codec
    # inside the routing kernels (kernels/fused_wire.py);
    # $REPRO_FUSED_WIRE=0 takes the composed path, with the same bits.
    fused = (codec is not None and codec.quantized
             and wire_lib.fused_wire_enabled())

    if use_lsh:
        disp = routing.dispatch_tokens(plan, xf).to(x.dtype)
        comp = clustering.compress(disp, plan.occupancy, params["lsh_rot"],
                                   lsh_slots, cfg.lsh.hash_type,
                                   cfg.lsh.error_compensation,
                                   wire_format=cfg.lsh.wire_format,
                                   wire_dtype=wire_dtype)
        wire, c_wire = comp.centroids, lsh_slots
    elif codec is not None:
        # the coded baseline (int8 / fp8 with LSH off): the f32 dispatch
        # buffer crosses coded; the fused path never builds it
        comp, c_wire = None, capacity
        wire = None if fused else routing.dispatch_tokens(plan, xf)
    else:
        # no codec: the buffer crosses in the model dtype, unrounded
        disp = routing.dispatch_tokens(plan, xf).to(x.dtype)
        out = _expert_mlp(disp.to(wire_dtype), wg, wu, wd, mlp_act)
        y = routing.combine_tokens(plan, out.to(wire_dtype).to(torch.float32))
        return _finish(x, y, gate, plan, params)

    def expert_chunk(recv: torch.Tensor) -> torch.Tensor:
        """[R, E, c, H] decoded wire tensor -> the experts' outputs, same
        shape and dtype x.dtype (not cast to the wire: the codec is)."""
        out = _expert_mlp(recv.reshape(e_pad, -1, H).to(x.dtype), wg, wu, wd,
                          mlp_act)
        return out.reshape(R, e_pad, -1, H)

    fwd_leaf, bwd_leaf = wire_lib.flat_leaves(R)
    if fused and use_lsh:
        # dispatch leg: the payload compress() encoded; combine leg: the
        # decode fused with decompress on the received payload
        recv = wire_lib.precoded_transfer(
            wire.reshape(R, e_pad, c_wire, H),
            comp.payload.reshape(R, e_pad, c_wire, H),
            comp.scales.reshape(R, e_pad, c_wire), codec, fwd_leaf,
            bwd_leaf)
        slots, base, residual = clustering.fused_decompress_operands(comp)
        out_tok = wire_lib.fused_decode_residual_transfer(
            expert_chunk(recv), slots, base, residual, codec, fwd_leaf,
            bwd_leaf)
        y = routing.combine_tokens(plan, out_tok)
    elif fused:
        # both legs inside the routing kernels: scatter + quantize out,
        # dequantize + gather back
        src = torch.repeat_interleave(xf, cfg.top_k, dim=0)
        recv = wire_lib.fused_dispatch_transfer(
            plan.flat_ids, plan.positions, src, codec, fwd_leaf, bwd_leaf,
            R, e_pad, capacity)
        w_flat = plan.weights.reshape(T * cfg.top_k).to(torch.float32)
        y_f = wire_lib.fused_combine_transfer(
            expert_chunk(recv), plan.flat_ids, plan.positions, w_flat, codec,
            fwd_leaf, bwd_leaf, R)
        y = y_f.reshape(T, cfg.top_k, H).sum(dim=1)
    else:
        ret = wire_lib.coded_moe_exchange(
            wire.reshape(R, e_pad, c_wire, H), expert_chunk, codec, fwd_leaf,
            bwd_leaf)
        out_tok = ret.reshape(e_pad, c_wire, H).to(torch.float32)
        if use_lsh:
            out_tok = clustering.decompress(out_tok, comp)
        y = routing.combine_tokens(plan, out_tok)
    return _finish(x, y, gate, plan, params)


def _finish(x, y, gate, plan, params):
    losses = gating_losses(gate, params["placement"])
    return (y.reshape(x.shape).to(x.dtype), losses.aux_loss, losses.z_loss,
            plan.load())


def moe_expert_parallel(x: torch.Tensor, params: Dict, cfg: MoEConfig, *,
                        mlp_act: str, use_lsh: Optional[bool] = None
                        ) -> Tuple[torch.Tensor, Dict]:
    """x: [B, S, H] -> (y, {"aux_loss", "z_loss", "expert_load"}).

    params: router_w [H, E], w_gate / w_up [E_pad, H, F], w_down
    [E_pad, F, H], lsh_rot [L, H, Dr], placement [E].  The capacity is
    ``expert_capacity(B*S, E_pad, k, capacity_factor)`` and the slots
    ``num_lsh_slots(capacity, rate, multiple=overlap_chunks)``, as the JAX
    path has them with its default (auto) transport.  The wire codec is
    the JAX one's: ``cfg.lsh.wire_format`` with LSH on, and with LSH off
    only a quantized format (the coded baseline).  One card: a model axis
    over several is ROADMAP Queue 1 item 3."""
    B, S, _ = x.shape
    e_pad = params["w_up"].shape[0]
    capacity = expert_capacity(B * S, e_pad, cfg.top_k, cfg.capacity_factor)
    use_lsh = cfg.lsh.enabled if use_lsh is None else use_lsh
    chunk_mult = cfg.comm.overlap_chunks \
        if (cfg.comm.a2a_impl or "auto") in ("auto", "pipelined") else 1
    lsh_slots = num_lsh_slots(capacity, cfg.lsh.compression_rate,
                              multiple=chunk_mult) if use_lsh else 0
    wire_dtype = getattr(torch, cfg.lsh.wire_dtype) if use_lsh else x.dtype
    wire_fmt = cfg.lsh.wire_format if (
        use_lsh or cfg.lsh.wire_format in QUANT_FORMATS) else None
    codec = None if wire_fmt is None else wire_lib.make_codec(
        wire_fmt, wire_dtype=wire_dtype, compute_dtype=x.dtype)
    y, aux, z, load = _local_moe(
        x, params, cfg, mlp_act=mlp_act, e_pad=e_pad, capacity=capacity,
        use_lsh=use_lsh, lsh_slots=lsh_slots, wire_dtype=wire_dtype,
        codec=codec)
    return y, {"aux_loss": aux, "z_loss": z, "expert_load": load}
