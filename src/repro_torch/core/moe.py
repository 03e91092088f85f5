"""Mixture-of-Experts layers (counterpart of ``repro/core/moe.py``).  Both
paths share one pipeline:

    top_k_gating -> routing.build_dispatch_plan -> routing.dispatch_tokens
    -> expert MLP -> routing.combine_tokens

1. ``moe_expert_parallel`` (train / prefill, the paper's setting): the
   dispatch buffer is optionally LSH-compressed (core/clustering.py),
   exchanged over the mesh's model axis (expert parallelism), run through
   this rank's experts, exchanged back and error-compensated.  Each
   exchange moves the wire format's leaves (comm/wire.py: a bf16 cast, or
   an int8 / fp8 payload with scales, fused into the routing kernels
   unless $REPRO_FUSED_WIRE=0 or the transport is pipelined) through the
   transport ``comm.planner`` resolves: the flat all-to-all over the
   model axis's process group, the 2-hop over its node subgroups, or the
   chunk-pipelined exchange, which encodes each slot chunk on its own.
2. ``moe_dense_dispatch`` (decode): tiny token counts, no compression;
   over a model axis of several ranks the exchange goes through the same
   plan (``_moe_dense_planned``).

With a mesh, x is this rank's tokens (batch shard d, sequence slice m:
runtime/sharding.py) and the expert weights are its shard [E_pad / model,
H / data, F] (``P("model", "data", None)`` in the JAX package); the layer
all-gathers them over ``data`` once, before the exchange, and their
gradients come back reduce-scattered.  ``mesh`` None is one card: every
collective is the identity, and the layer is the JAX one on one device.
The kernel ops run the hand-written CUDA kernels for CUDA tensors
(kernels/dispatch.py).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch.profiler import record_function

from repro_torch.comm import collectives
from repro_torch.comm import planner as comm_planner
from repro_torch.comm import wire as wire_lib
from repro_torch.configs.base import MoEConfig
from repro_torch.core import clustering, routing
from repro_torch.core.gating import gating_losses, top_k_gating
from repro_torch.kernels.wire_quant import QUANT_FORMATS
from repro_torch.models.layers import activation
from repro_torch.runtime import sharding


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


def _gathered_experts(params: Dict, cplan: comm_planner.CommPlan):
    """The expert weights with their ``data`` (FSDP) shards gathered, once
    a layer: [e_local, H, F] / [e_local, F, H]."""
    wg = params.get("w_gate")
    return (None if wg is None else cplan.all_gather(wg, "data", 1),
            cplan.all_gather(params["w_up"], "data", 1),
            cplan.all_gather(params["w_down"], "data", 1))


def _experts_fn(weights, mlp_act: str, dtype: torch.dtype,
                out_dtype: Optional[torch.dtype]):
    """[R, e_local, c, H] received wire tensor -> this rank's experts'
    outputs, same shape: the R ranks' slots of an expert run as one
    [e_local, R * c, H] batch.  ``out_dtype`` casts the result (None
    keeps ``dtype``: a codec encodes it)."""
    wg, wu, wd = weights

    def expert_chunk(recv: torch.Tensor) -> torch.Tensor:
        r, el, c, h = recv.shape
        tok = recv.transpose(0, 1).reshape(el, r * c, h)
        out = _expert_mlp(tok.to(dtype), wg, wu, wd, mlp_act)
        out = out.reshape(el, r, c, h).transpose(0, 1)
        return out if out_dtype is None else out.to(out_dtype)
    return expert_chunk


def moe_dense_dispatch(x: torch.Tensor, params: Dict, cfg: MoEConfig, *,
                       mlp_act: str, mesh=None) -> torch.Tensor:
    """x: [B, S, H] with tiny B*S (decode) -> y [B, S, H].  With a mesh,
    x is this rank's batch shard, the same on every rank of a model slice.

    Over a model axis of several ranks the exchange runs through the
    planned all-to-all (``_moe_dense_planned``).  Otherwise it is the
    JAX package's ``_moe_dense_gspmd``: one plan over every token of the
    batch (over data ranks, their tokens are gathered first and this
    rank's rows kept), the f32 dispatch buffer cast to the model dtype
    before the expert MLP and the expert output back to f32 before the
    combine.  Decode reads no stats, so none are made here;
    ``gating.gating_losses`` gives them to a caller that wants them."""
    if sharding.axis_size(mesh, "model") > 1:
        y, _ = _moe_dense_planned(x, params, cfg, mesh=mesh, mlp_act=mlp_act)
        return y
    dp = sharding.dp_group(mesh)
    n_dp = collectives.group_size(dp)
    cplan = comm_planner.flat_plan(mesh=mesh)
    wg, wu, wd = _gathered_experts(params, cplan)
    B_loc = x.shape[0]
    if n_dp > 1:
        x = collectives.raw_all_gather(x, dp, 0)
    e_pad = wu.shape[0]
    B, S, H = x.shape
    xf = x.reshape(B * S, H)
    gate = top_k_gating(xf, params["router_w"], cfg.top_k,
                        params["placement"])
    cap = max(4, int(math.ceil(B * S * cfg.top_k / e_pad * 2)))
    plan = routing.build_dispatch_plan(gate.expert_ids, gate.weights, e_pad,
                                       cap)
    disp = routing.dispatch_tokens(plan, xf).to(x.dtype)
    eo = _expert_mlp(disp, wg, wu, wd, mlp_act)
    y = routing.combine_tokens(plan, eo.to(torch.float32))
    y = y.reshape(B, S, H).to(x.dtype)
    if n_dp > 1:
        d = sharding.axis_index(mesh, "data")
        y = y[d * B_loc:(d + 1) * B_loc]
    return y


def _moe_dense_planned(x: torch.Tensor, params: Dict, cfg: MoEConfig, *,
                       mesh, mlp_act: str
                       ) -> Tuple[torch.Tensor, Dict]:
    """Decode dispatch over a model axis of several ranks, the JAX
    ``_moe_dense_planned`` / ``_local_decode``: x [B_loc, S, H] is the
    rank's batch shard, replicated along ``model``; every model rank
    builds the same plan and the all-to-all moves each rank's slots to
    the ranks that own their experts.  Returns (y, stats), the stats
    reduced over the dp axes only (each token is on model_r ranks)."""
    model_r = sharding.axis_size(mesh, "model")
    e_local = params["w_up"].shape[0]
    e_pad = e_local * model_r
    B_loc, S, H = x.shape
    capacity = expert_capacity(B_loc * S, e_pad, cfg.top_k, 2.0)
    cplan = comm_planner.plan_collectives(
        mesh, cfg.comm, axis_name="model",
        msg_bytes=e_pad * capacity * H * x.element_size(),
        chunk_extent=capacity)
    xf = x.reshape(B_loc * S, H)
    gate = top_k_gating(xf, params["router_w"], cfg.top_k,
                        params["placement"])
    plan = routing.build_dispatch_plan(gate.expert_ids, gate.weights, e_pad,
                                       capacity)
    disp = routing.dispatch_tokens(plan, xf).to(x.dtype)
    send = disp.reshape(model_r, e_local, capacity, H)
    expert_chunk = _experts_fn(_gathered_experts(params, cplan), mlp_act,
                               x.dtype, x.dtype)
    ret = cplan.moe_exchange(send, expert_chunk)
    y = routing.combine_tokens(
        plan, ret.reshape(e_pad, capacity, H).to(torch.float32))
    losses = gating_losses(gate, params["placement"])
    dp = sharding.dp_group(mesh)
    stats = {"aux_loss": collectives.all_reduce_mean(losses.aux_loss, dp),
             "z_loss": collectives.all_reduce_mean(losses.z_loss, dp),
             "expert_load": collectives.all_reduce_sum(plan.load(), dp)}
    return y.reshape(B_loc, S, H).to(x.dtype), stats


# ---------------------------------------------------------------------------
# Path 1: expert-parallel (train / prefill), the paper's setting.
# ---------------------------------------------------------------------------

def _local_moe(x: torch.Tensor, params: Dict, cfg: MoEConfig, *,
               mlp_act: str, e_pad: int, capacity: int, use_lsh: bool,
               lsh_slots: int, wire_dtype: torch.dtype,
               codec: Optional[wire_lib.WireCodec],
               cplan: comm_planner.CommPlan, mesh
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """The JAX ``_local_moe``, in its order of casts.  x: [B_loc, S_loc,
    H] -> (y, aux, z, load), the stats reduced over every rank."""
    R = sharding.axis_size(mesh, "model")
    e_local = e_pad // R
    B, S, H = x.shape
    T = B * S
    xf = x.reshape(T, H)
    gate = top_k_gating(xf, params["router_w"], cfg.top_k,
                        params["placement"])
    plan = routing.build_dispatch_plan(gate.expert_ids, gate.weights, e_pad,
                                       capacity)
    # Fused codec path: a quantized wire whose leaves move whole, the codec
    # inside the routing kernels (kernels/fused_wire.py).  The pipelined
    # transport keeps the per-chunk coded path (it slices the float tensor
    # before it encodes); $REPRO_FUSED_WIRE=0 takes the composed path,
    # with the same bits.
    fused = (codec is not None and codec.quantized
             and cplan.transport != comm_planner.PIPELINED
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
        comp, c_wire = None, capacity
        wire = routing.dispatch_tokens(plan, xf).to(x.dtype)

    # the expert weights' FSDP gathers over data, once, before the exchange
    expert_chunk = _experts_fn(_gathered_experts(params, cplan), mlp_act,
                               x.dtype, None if codec is not None
                               else wire_dtype)
    if fused:
        fwd_leaf, bwd_leaf = cplan.leaf_transports()
    if fused and use_lsh:
        # dispatch leg: the payload compress() encoded; combine leg: the
        # decode fused with decompress on the received payload
        with record_function("dispatch"):
            recv = wire_lib.precoded_transfer(
                wire.reshape(R, e_local, c_wire, H),
                comp.payload.reshape(R, e_local, c_wire, H),
                comp.scales.reshape(R, e_local, c_wire), codec, fwd_leaf,
                bwd_leaf)
        eo = expert_chunk(recv)
        slots, base, residual = clustering.fused_decompress_operands(comp)
        with record_function("combine"):
            out_tok = wire_lib.fused_decode_residual_transfer(
                eo, slots, base, residual, codec, fwd_leaf, bwd_leaf)
        y = routing.combine_tokens(plan, out_tok)
    elif fused:
        # both legs inside the routing kernels: scatter + quantize out,
        # dequantize + gather back
        src = torch.repeat_interleave(xf, cfg.top_k, dim=0)
        with record_function("dispatch"):
            recv = wire_lib.fused_dispatch_transfer(
                plan.flat_ids, plan.positions, src, codec, fwd_leaf,
                bwd_leaf, R, e_pad, capacity)
        eo = expert_chunk(recv)
        w_flat = plan.weights.reshape(T * cfg.top_k).to(torch.float32)
        with record_function("combine"):
            y_f = wire_lib.fused_combine_transfer(
                eo, plan.flat_ids, plan.positions, w_flat, codec, fwd_leaf,
                bwd_leaf, R)
        y = y_f.reshape(T, cfg.top_k, H).sum(dim=1)
    else:
        if codec is None:
            wire = wire.to(wire_dtype)
        ret = cplan.moe_exchange(wire.reshape(R, e_local, c_wire, H),
                                 expert_chunk, codec=codec)
        out_tok = ret.reshape(e_pad, c_wire, H).to(torch.float32)
        if use_lsh:
            out_tok = clustering.decompress(out_tok, comp)
        y = routing.combine_tokens(plan, out_tok)
    losses = gating_losses(gate, params["placement"])
    world = sharding.all_group(mesh)
    return (y.reshape(x.shape).to(x.dtype),
            collectives.all_reduce_mean(losses.aux_loss, world),
            collectives.all_reduce_mean(losses.z_loss, world),
            collectives.all_reduce_sum(plan.load(), world))


def moe_expert_parallel(x: torch.Tensor, params: Dict, cfg: MoEConfig, *,
                        mlp_act: str, use_lsh: Optional[bool] = None,
                        mesh=None) -> Tuple[torch.Tensor, Dict]:
    """x: [B_loc, S_loc, H], this rank's tokens -> (y, {"aux_loss",
    "z_loss", "expert_load"}), y this rank's and the stats over all ranks
    (aux / z averaged, load summed, as the JAX package's).

    params: router_w [H, E], w_gate / w_up [e_local, H / data, F], w_down
    [e_local, F / data, H], lsh_rot [L, H, Dr], placement [E]; e_local =
    E_pad / model.  The capacity is ``expert_capacity(B_loc * S_loc,
    E_pad, k, capacity_factor)`` (the JAX ``t_loc``) and the slots
    ``num_lsh_slots(capacity, rate, multiple=overlap_chunks)``.  The wire
    codec is the JAX one's: ``cfg.lsh.wire_format`` with LSH on, and with
    LSH off only a quantized format (the coded baseline)."""
    B, S, H = x.shape
    model_r = sharding.axis_size(mesh, "model")
    e_pad = params["w_up"].shape[0] * model_r
    if cfg.num_experts > e_pad:
        raise ValueError(f"{e_pad} padded experts for {cfg.num_experts}")
    capacity = expert_capacity(B * S, e_pad, cfg.top_k, cfg.capacity_factor)
    use_lsh = cfg.lsh.enabled if use_lsh is None else use_lsh
    chunk_mult = cfg.comm.overlap_chunks \
        if (cfg.comm.a2a_impl or "auto") in ("auto", "pipelined") else 1
    c_wire = num_lsh_slots(capacity, cfg.lsh.compression_rate,
                           multiple=chunk_mult) if use_lsh else capacity
    wire_dtype = getattr(torch, cfg.lsh.wire_dtype) if use_lsh else x.dtype
    wire_fmt = cfg.lsh.wire_format if (
        use_lsh or cfg.lsh.wire_format in QUANT_FORMATS) else None
    codec = None if wire_fmt is None else wire_lib.make_codec(
        wire_fmt, wire_dtype=wire_dtype, compute_dtype=x.dtype)
    # one resolution a layer call; the message size is the true wire
    # bytes, scales sidecar included
    cplan = comm_planner.plan_collectives(
        mesh, cfg.comm, axis_name="model",
        msg_bytes=clustering.wire_bytes(e_pad, c_wire, H, wire_fmt,
                                        wire_dtype=wire_dtype),
        chunk_extent=c_wire) if mesh is not None \
        else comm_planner.flat_plan()
    y, aux, z, load = _local_moe(
        x, params, cfg, mlp_act=mlp_act, e_pad=e_pad, capacity=capacity,
        use_lsh=use_lsh, lsh_slots=c_wire if use_lsh else 0,
        wire_dtype=wire_dtype, codec=codec, cplan=cplan, mesh=mesh)
    return y, {"aux_loss": aux, "z_loss": z, "expert_load": load}
