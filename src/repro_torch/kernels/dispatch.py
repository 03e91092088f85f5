"""Public kernel ops (counterpart of the public ops of
``repro/kernels/dispatch.py``).

The JAX registry chooses a backend by name, config and environment.  The
port chooses by device alone: a CUDA tensor takes the hand-written kernel,
a CPU tensor the plain version, and there is no switch between them.

Overflow-bin contract, as in the JAX package: an integer id outside its
valid range contributes nothing on the scatter direction and gathers zero
on the gather direction, so "dropped" is encoded by pointing the id at the
overflow bin instead of carrying a mask.

The differentiable ops are ``torch.autograd.Function`` pairs that mirror the
JAX custom VJPs (``repro/kernels/dispatch.py:142-253``): segment_centroid
and residual_apply are each other's backward, and so are dispatch_scatter
and combine_gather.  Each backward is a kernel call, and returns its
cotangent in the primal's dtype, as the JAX code does with
``.astype(proto.dtype)``.  Integer inputs get no gradient.

The wire codec ops are forward only: a one-byte payload carries no
cotangent.  ``wire_roundtrip`` / ``wire_encode_roundtrip`` are the
quantize-dequantize pair as one unit with a straight-through backward
(``repro/kernels/dispatch.py:509-563``), and the fused codec ops are
differentiated one level up, by the transfers of ``comm/wire.py``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import (fused_wire, lsh_hash as lsh_hash_k,
                                 residual_apply as residual_apply_k,
                                 scatter_gather,
                                 segment_centroid as segment_centroid_k,
                                 token_position, wire_quant)

# the routing kernels run on every MoE path; the LSH kernels on train and
# prefill with LSH on; the wire kernels with an int8 / fp8 wire format
ROUTING_KERNELS = (token_position.KERNEL, scatter_gather.SCATTER,
                   scatter_gather.GATHER)
LSH_KERNELS = (lsh_hash_k.KERNEL, segment_centroid_k.KERNEL,
               residual_apply_k.KERNEL)
WIRE_KERNELS = (wire_quant.QUANTIZE, wire_quant.DEQUANTIZE,
                fused_wire.SCATTER_QUANTIZE, fused_wire.DEQUANTIZE_GATHER,
                fused_wire.DEQUANTIZE_RESIDUAL)
KERNELS = ROUTING_KERNELS + LSH_KERNELS + WIRE_KERNELS

# The hash is not differentiable (the JAX caller stop_gradient's it).
lsh_hash = lsh_hash_k.lsh_hash


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


class _SegmentCentroid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, slots, x, num_slots):
        cent, counts = segment_centroid_k.segment_centroid(slots, x,
                                                           num_slots)
        ctx.save_for_backward(slots, counts)
        ctx.x_dtype = x.dtype
        ctx.mark_non_differentiable(counts)
        return cent, counts

    @staticmethod
    def backward(ctx, d_cent, _d_counts):
        slots, counts = ctx.saved_tensors
        # centroid_s = sum_c x_c / count_s  =>  dx_c = d_cent[slot_c] / count
        scaled = d_cent / torch.clamp(counts, min=1.0)[..., None]
        dx = residual_apply_k.residual_apply(slots, scaled.contiguous())
        return None, dx.to(ctx.x_dtype), None


def residual_apply_transpose(slots: torch.Tensor, ct: torch.Tensor,
                             num_slots: int) -> torch.Tensor:
    """The transpose of out = expert_out[g, slots] + residual in its
    [G, S, H] operand: the segment sums of the [G, C, H] f32 cotangent
    over the slots, the centroid kernel times the counts."""
    cent, counts = segment_centroid_k.segment_centroid(slots, ct, num_slots)
    return cent * counts[..., None]


class _ResidualApply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, slots, expert_out, residual):
        ctx.save_for_backward(slots)
        ctx.num_slots = expert_out.shape[1]
        return residual_apply_k.residual_apply(slots, expert_out, residual)

    @staticmethod
    def backward(ctx, ct):
        (slots,) = ctx.saved_tensors
        # out = gather(expert_out, slots) + residual: the gather's transpose
        # is a segment sum over slots -- the centroid kernel times counts.
        ct = ct.contiguous()
        d_eout = d_res = None
        if ctx.needs_input_grad[1]:
            d_eout = residual_apply_transpose(slots, ct, ctx.num_slots)
        if ctx.needs_input_grad[2]:
            d_res = ct
        return None, d_eout, d_res


class _DispatchScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ids, pos, src, num_experts, capacity):
        ctx.save_for_backward(ids, pos)
        ctx.src_dtype = src.dtype
        return scatter_gather.dispatch_scatter(ids, pos, src, num_experts,
                                               capacity)

    @staticmethod
    def backward(ctx, ct):
        ids, pos = ctx.saved_tensors
        # the transpose of the scatter: gather the cotangent, unit weights
        ones = torch.ones(ids.shape, dtype=torch.float32, device=ids.device)
        dsrc = scatter_gather.combine_gather(ids, pos, ct.contiguous(), ones)
        return None, None, dsrc.to(ctx.src_dtype), None, None


class _CombineGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ids, pos, buf, weights):
        ctx.save_for_backward(ids, pos, buf, weights)
        return scatter_gather.combine_gather(ids, pos, buf, weights)

    @staticmethod
    def backward(ctx, ct):
        ids, pos, buf, weights = ctx.saved_tensors
        E, C, _ = buf.shape
        dbuf = dw = None
        if ctx.needs_input_grad[2]:
            wct = ct * weights.to(torch.float32)[:, None]
            dbuf = scatter_gather.dispatch_scatter(
                ids, pos, wct.contiguous(), E, C).to(buf.dtype)
        if ctx.needs_input_grad[3]:
            ones = torch.ones(ids.shape, dtype=torch.float32,
                              device=ids.device)
            gathered = scatter_gather.combine_gather(ids, pos, buf, ones)
            dw = torch.sum(ct * gathered, dim=-1).to(weights.dtype)
        return None, None, dbuf, dw


def segment_centroid(slots: torch.Tensor, x: torch.Tensor, num_slots: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """slots: [G, C] int32; x: [G, C, H] bf16 / f32 ->
    (centroids [G, S, H] f32, counts [G, S] f32).  Out-of-range slot ids
    (>= num_slots) contribute to nothing -- the overflow bin.
    Differentiable in ``x``."""
    return _SegmentCentroid.apply(slots, x, num_slots)


def residual_apply(slots: torch.Tensor, expert_out: torch.Tensor,
                   residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[G, C] ids, [G, S, H] outputs, [G, C, H] residuals (None: zero, with
    no gradient) -> [G, C, H] f32 = expert_out[g, slots] + residual.
    Out-of-range slot ids gather zero.  Differentiable in ``expert_out``
    and ``residual``; both are taken in f32, and the casts to f32 carry
    their cotangents back to the callers' dtypes."""
    if residual is not None:
        residual = residual.to(torch.float32).contiguous()
    return _ResidualApply.apply(slots, expert_out.to(torch.float32)
                                .contiguous(), residual)


def dispatch_scatter(expert_ids: torch.Tensor, pos: torch.Tensor,
                     src: torch.Tensor, num_experts: int,
                     capacity: int) -> torch.Tensor:
    """[F] ids, [F] positions, [F, H] bf16 / f32 tokens -> [E, C, H] f32
    dispatch buffer: buf[e, c] = sum of src[f] over entries with
    (id, pos) == (e, c).  Differentiable in ``src`` (the backward pass is
    ``combine_gather`` with unit weights)."""
    return _DispatchScatter.apply(expert_ids, pos, src, num_experts,
                                  capacity)


def combine_gather(expert_ids: torch.Tensor, pos: torch.Tensor,
                   buf: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """[F] ids, [F] positions, [E, C, H] f32 buffer, [F] f32 weights ->
    [F, H] f32 = weights[f] * buf[id_f, pos_f]; out-of-range entries give
    zero.  Differentiable in ``buf`` (the backward is ``dispatch_scatter``
    of the weighted cotangent) and ``weights`` (a row dot product with the
    unweighted gather, plain torch as in JAX)."""
    return _CombineGather.apply(expert_ids, pos, buf, weights)


# ------------------------------------------------------------ wire codec --

def wire_quantize(x: torch.Tensor, fmt: str
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [G, S, H] -> (q [G, S, H] int8 | float8_e4m3fn, scales [G, S]
    f32): one power-of-two absmax scale per row; empty rows get scale 1
    and a zero payload.  Forward only."""
    return wire_quant.wire_quantize(x, fmt)


def wire_dequantize(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(q [G, S, H], scales [G, S]) -> [G, S, H] f32 = q * scale.  Forward
    only."""
    return wire_quant.wire_dequantize(q, scales)


class _WireRoundtrip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fmt):
        q, scales = wire_quant.wire_quantize(x.contiguous(), fmt)
        dq = wire_quant.wire_dequantize(q, scales)
        ctx.mark_non_differentiable(q, scales)
        ctx.x_dtype = x.dtype
        return dq, q, scales

    @staticmethod
    def backward(ctx, ct_dq, _ct_q, _ct_scales):
        # straight-through: d/dx [dequantize(quantize(x))] := identity
        return ct_dq.to(ctx.x_dtype), None


def wire_roundtrip(x: torch.Tensor, fmt: str
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dequantize(quantize(x)) [G, S, H] f32, scales [G, S] f32) with a
    straight-through backward: the values the expert will see on the far
    side of the wire, with the input still on the gradient path."""
    dq, _q, scales = _WireRoundtrip.apply(x, fmt)
    return dq, scales


def wire_encode_roundtrip(x: torch.Tensor, fmt: str
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """``wire_roundtrip`` that also returns the payload: (dq f32, q int8 |
    float8_e4m3fn, scales f32); q and scales are not differentiable.  The
    payload lets the LSH dispatch leg ship the encoded centroids as they
    are (comm/wire.precoded_transfer)."""
    return _WireRoundtrip.apply(x, fmt)


def dispatch_scatter_quantize(expert_ids: torch.Tensor, pos: torch.Tensor,
                              src: torch.Tensor, num_experts: int,
                              capacity: int, fmt: str
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``wire_quantize(dispatch_scatter(...))`` bit for bit, without the f32
    buffer: (q [E, C, H], scales [E, C] f32).  Forward only."""
    return fused_wire.dispatch_scatter_quantize(
        expert_ids, pos, src.contiguous(), num_experts, capacity, fmt)


def dequantize_combine_gather(expert_ids: torch.Tensor, pos: torch.Tensor,
                              q: torch.Tensor, scales: torch.Tensor,
                              weights: torch.Tensor) -> torch.Tensor:
    """``combine_gather(ids, pos, wire_dequantize(q, scales), weights)``
    bit for bit: [F, H] f32.  Forward only."""
    return fused_wire.dequantize_combine_gather(
        expert_ids, pos, q.contiguous(), scales.contiguous(),
        weights.to(torch.float32).contiguous())


def dequantize_residual_apply(slots: torch.Tensor, q: torch.Tensor,
                              scales: torch.Tensor, residual: torch.Tensor,
                              base: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """``residual_apply(slots, wire_dequantize(q, scales) - base,
    residual)`` bit for bit (no subtraction when ``base`` is None):
    [G, C, H] f32.  Forward only."""
    return fused_wire.dequantize_residual_apply(
        slots, q.contiguous(), scales.contiguous(),
        residual.to(torch.float32).contiguous(),
        None if base is None else base.to(torch.float32).contiguous())
