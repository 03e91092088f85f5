"""Wire codec: the on-wire representation of the MoE exchange
(counterpart of ``repro/comm/wire.py``).

A ``WireCodec`` says how the [R, e_local, c, H] wire tensor travels:

  "bf16"   one leaf, the payload cast to ``wire_dtype``;
  "int8"   two leaves: a one-byte payload and an [R, e_local, c] f32
  "fp8"    power-of-two scale sidecar (kernels/wire_quant.py).

``coded_transfer`` is one exchange of a float tensor under a codec: encode,
move every leaf, decode.  A payload carries no cotangent, so its backward
is the transposed move of the float cotangent in ``grad_dtype`` (bf16),
straight through the codec: gradients are never quantized.

The fused transfers run the fused codec kernels (kernels/fused_wire.py) in
their forward and build their backward from the unfused ops of
kernels/dispatch.py, with every cast of the composed chain in its order,
so that fused and composed paths give the same values and gradients bit
for bit.  ``$REPRO_FUSED_WIRE=0`` sends the MoE layer down the composed
path (core/moe.py), as in the JAX package.

Moving a leaf is ``flat_leaves``' all-to-all over the model axis's
process group (comm/collectives.py), the identity on one card, or
``hierarchical_leaves``' 2-hop (comm/hierarchical.py), which every leaf,
the scales sidecar included, crosses hop by hop.

A ``Leg`` is one planned transfer of a float tensor that can also be
issued and waited in two halves (``start`` / ``wait``): the pipelined
transport (comm/pipeline.py) moves each slot chunk with one, so that a
chunk's transfer is in flight while the previous chunk's experts run.
``transfer_fn(codec, group)`` is the coded one.  Quantization is per slot
row, so encoding a chunk is bitwise the chunk of the encoded tensor,
payload and scales alike.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from repro_torch.comm import collectives
from repro_torch.comm.hierarchical import two_hop
from repro_torch.kernels import dispatch
from repro_torch.kernels.wire_quant import (BF16_FORMAT, QUANT_FORMATS,
                                            validate_wire_format)

FUSED_ENV = "REPRO_FUSED_WIRE"

Leaf = Callable[[torch.Tensor], torch.Tensor]


def fused_wire_enabled() -> bool:
    """Gate of the fused codec transfers ($REPRO_FUSED_WIRE; "0" forces
    the composed path)."""
    return os.environ.get(FUSED_ENV, "1") != "0"


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


@dataclass(frozen=True)
class WireCodec:
    """The wire format.  The kernel that runs each op is chosen by the
    device its tensors live on, so the codec carries no backend."""
    fmt: str                              # "bf16" | "int8" | "fp8"
    wire_dtype: str = "bfloat16"          # payload dtype of "bf16"
    compute_dtype: str = "bfloat16"       # dtype handed to the expert MLP

    @property
    def quantized(self) -> bool:
        return self.fmt in QUANT_FORMATS

    @property
    def grad_dtype(self) -> torch.dtype:
        """The backward wire's dtype: the bf16 format's payload dtype, or
        bf16 under a quantized format."""
        return _dtype(self.wire_dtype) if self.fmt == BF16_FORMAT \
            else torch.bfloat16

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Float wire tensor [..., c, H] -> leaves (payload, [scales])."""
        if not self.quantized:
            return (x.to(_dtype(self.wire_dtype)),)
        lead = x.shape[:-2]
        q, scales = dispatch.wire_quantize(
            x.reshape((-1,) + tuple(x.shape[-2:])).contiguous(), self.fmt)
        return q.reshape(x.shape), scales.reshape(lead + x.shape[-2:-1])

    def decode(self, leaves: Tuple[torch.Tensor, ...]) -> torch.Tensor:
        """Leaves -> float tensor in ``compute_dtype`` (exact for the
        quantized formats: their dequantized values are bf16 values)."""
        if not self.quantized:
            return leaves[0].to(_dtype(self.compute_dtype))
        q, scales = leaves
        out = dispatch.wire_dequantize(
            q.reshape((-1,) + tuple(q.shape[-2:])),
            scales.reshape(-1, scales.shape[-1]))
        return out.reshape(q.shape).to(_dtype(self.compute_dtype))


def make_codec(fmt: str, *, wire_dtype="bfloat16",
               compute_dtype="bfloat16") -> WireCodec:
    """Validate the format; dtypes may be given as names or torch dtypes."""
    validate_wire_format(fmt)

    def name(dt):
        return dt if isinstance(dt, str) else str(dt).split(".")[-1]

    return WireCodec(fmt=fmt, wire_dtype=name(wire_dtype),
                     compute_dtype=name(compute_dtype))


def _identity(v: torch.Tensor) -> torch.Tensor:
    return v


def flat_leaves(group=None) -> Tuple[Leaf, Leaf]:
    """(fwd, bwd) movers of one leaf for the flat all-to-all over the model
    axis's process group ``group`` (self-transpose): the leaf's leading
    [R, ...] axis, payload and f32 scales sidecar alike.  A group of one
    rank (or None) moves nothing: both are the identity."""
    if collectives.group_size(group) == 1:
        return _identity, _identity

    def leaf(v: torch.Tensor) -> torch.Tensor:
        return collectives.raw_all_to_all(v, group)
    return leaf, leaf


def hierarchical_leaves(groups) -> Tuple[Leaf, Leaf]:
    """(fwd, bwd) movers of one leaf over the 2-hop (``groups``: this
    rank's (intra, inter) subgroups): fwd the 2-hop, bwd its mirror."""
    def fwd(v: torch.Tensor) -> torch.Tensor:
        return two_hop(v, groups)

    def bwd(v: torch.Tensor) -> torch.Tensor:
        return two_hop(v, groups, mirrored=True)
    return fwd, bwd


# ------------------------------------------------------- coded transfer --

class _CodedTransfer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, codec, fwd_leaf, bwd_leaf):
        ctx.codec, ctx.bwd_leaf, ctx.x_dtype = codec, bwd_leaf, x.dtype
        return codec.decode(tuple(fwd_leaf(leaf)
                                  for leaf in codec.encode(x)))

    @staticmethod
    def backward(ctx, ct):
        dx = ctx.bwd_leaf(ct.to(ctx.codec.grad_dtype)).to(ctx.x_dtype)
        return dx, None, None, None


def coded_transfer(x: torch.Tensor, codec: WireCodec, fwd_leaf: Leaf,
                   bwd_leaf: Leaf) -> torch.Tensor:
    """One exchange of float ``x`` under ``codec``: encode, move each leaf
    with ``fwd_leaf``, decode.  Backward: ``bwd_leaf`` of the cotangent
    in ``codec.grad_dtype``, returned in x's dtype."""
    return _CodedTransfer.apply(x, codec, fwd_leaf, bwd_leaf)


# ------------------------------------------------------------- legs --

class _Issue(torch.autograd.Function):
    """The first half of a leg: issue the transfer of x into ``handle``;
    the output only links the second half to x for autograd."""

    @staticmethod
    def forward(ctx, x, leg, handle):
        ctx.leg, ctx.x_dtype = leg, x.dtype
        handle.pending = leg.issue(x.detach())
        return torch.empty((), dtype=leg.out_dtype(x),
                           device=x.device).expand(x.shape)

    @staticmethod
    def backward(ctx, ct):
        return ctx.leg.transpose(ct).to(ctx.x_dtype), None, None


class _Wait(torch.autograd.Function):
    """The second half: wait for the transfer and return its result."""

    @staticmethod
    def forward(ctx, link, handle):
        out, handle.pending = handle.pending.wait(), None
        return out

    @staticmethod
    def backward(ctx, ct):
        return ct, None


class Handle:
    """A leg's transfer in flight (``Leg.start``)."""
    link = pending = None

    def wait(self) -> torch.Tensor:
        return _Wait.apply(self.link, self)


class Leg:
    """One transfer of a float tensor over the model axis's ``group``,
    whole (``__call__``) or in two halves (``start`` returns a
    ``Handle``; its ``wait`` gives the result, and the backward runs the
    transposed move at once).  Subclasses give ``issue`` (start the move
    of a detached tensor; returns an object whose ``wait`` gives the
    result), ``out_dtype`` and ``transpose`` (the backward's move of a
    cotangent)."""

    def __init__(self, group):
        self.group = group

    def start(self, x: torch.Tensor) -> Handle:
        handle = Handle()
        handle.link = _Issue.apply(x, self, handle)
        return handle


class RawLeg(Leg):
    """The flat all-to-all of a tensor as it is (no codec)."""

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return collectives.all_to_all(x, self.group)

    def issue(self, x: torch.Tensor) -> collectives.Pending:
        return collectives.all_to_all_async(x, self.group)

    def out_dtype(self, x: torch.Tensor) -> torch.dtype:
        return x.dtype

    def transpose(self, ct: torch.Tensor) -> torch.Tensor:
        return collectives.all_to_all(ct, self.group)


class _Decoding:
    def __init__(self, codec: "WireCodec", pending):
        self.codec, self.pending = codec, pending

    def wait(self) -> torch.Tensor:
        return self.codec.decode(tuple(p.wait() for p in self.pending))


class CodedLeg(Leg):
    """``coded_transfer`` over the flat all-to-all: encode, move every
    leaf, decode; backward straight through in ``codec.grad_dtype``."""

    def __init__(self, codec: "WireCodec", group):
        super().__init__(group)
        self.codec = codec
        self.fwd, self.bwd = flat_leaves(group)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return coded_transfer(x, self.codec, self.fwd, self.bwd)

    def issue(self, x: torch.Tensor) -> _Decoding:
        return _Decoding(self.codec, [
            collectives.all_to_all_async(leaf, self.group)
            for leaf in self.codec.encode(x)])

    def out_dtype(self, x: torch.Tensor) -> torch.dtype:
        return _dtype(self.codec.compute_dtype)

    def transpose(self, ct: torch.Tensor) -> torch.Tensor:
        return self.bwd(ct.to(self.codec.grad_dtype))


def transfer_fn(codec: WireCodec, group) -> CodedLeg:
    """The coded flat transfer, as a leg: the pipelined transport runs it
    on each slot chunk, payload and scales sliced in lockstep."""
    return CodedLeg(codec, group)


def coded_moe_exchange(send: torch.Tensor, compute_fn, codec: WireCodec,
                       fwd_leaf: Leaf, bwd_leaf: Leaf) -> torch.Tensor:
    """dispatch exchange -> compute_fn -> combine exchange, both coded."""
    recv = coded_transfer(send, codec, fwd_leaf, bwd_leaf)
    return coded_transfer(compute_fn(recv), codec, fwd_leaf, bwd_leaf)


# ------------------------------------------------------ fused transfers --

class _PrecodedTransfer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, q, scales, codec, fwd_leaf, bwd_leaf):
        ctx.codec, ctx.bwd_leaf, ctx.x_dtype = codec, bwd_leaf, x.dtype
        return codec.decode((fwd_leaf(q), fwd_leaf(scales)))

    @staticmethod
    def backward(ctx, ct):
        dx = ctx.bwd_leaf(ct.to(ctx.codec.grad_dtype)).to(ctx.x_dtype)
        return dx, None, None, None, None, None


def precoded_transfer(x: torch.Tensor, q: torch.Tensor,
                      scales: torch.Tensor, codec: WireCodec, fwd_leaf: Leaf,
                      bwd_leaf: Leaf) -> torch.Tensor:
    """``coded_transfer`` of ``x`` when the caller already holds its
    encoding (q, scales), as the LSH dispatch leg does (compress encoded
    the centroids): ships the payload instead of quantizing again, which
    power-of-two idempotence makes the same values.  Backward: that of
    ``coded_transfer``, to ``x``; q and scales get none."""
    return _PrecodedTransfer.apply(x, q, scales, codec, fwd_leaf, bwd_leaf)


class _FusedDispatchTransfer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, flat_ids, pos, src, codec, fwd_leaf, bwd_leaf, model_r,
                num_experts, capacity):
        q, scales = dispatch.dispatch_scatter_quantize(
            flat_ids, pos, src, num_experts, capacity, codec.fmt)
        H = src.shape[-1]
        e_local = num_experts // model_r
        leaves = (q.reshape(model_r, e_local, capacity, H),
                  scales.reshape(model_r, e_local, capacity))
        ctx.save_for_backward(flat_ids, pos)
        ctx.codec, ctx.bwd_leaf, ctx.src_dtype = codec, bwd_leaf, src.dtype
        ctx.shape = (num_experts, capacity, H)
        return codec.decode(tuple(fwd_leaf(leaf) for leaf in leaves))

    @staticmethod
    def backward(ctx, ct):
        flat_ids, pos = ctx.saved_tensors
        # the composed backward: the transposed move of the wire cotangent
        # in grad_dtype, back to the f32 buffer, then the scatter's
        # transpose (the gather with unit weights)
        dbuf = ctx.bwd_leaf(ct.to(ctx.codec.grad_dtype)).to(torch.float32)
        ones = torch.ones(flat_ids.shape, dtype=torch.float32,
                          device=flat_ids.device)
        dsrc = dispatch.combine_gather(flat_ids, pos,
                                       dbuf.reshape(ctx.shape), ones)
        return (None, None, dsrc.to(ctx.src_dtype), None, None, None, None,
                None, None)


def fused_dispatch_transfer(flat_ids: torch.Tensor, pos: torch.Tensor,
                            src: torch.Tensor, codec: WireCodec,
                            fwd_leaf: Leaf, bwd_leaf: Leaf, model_r: int,
                            num_experts: int, capacity: int) -> torch.Tensor:
    """The fused dispatch leg of the coded baseline (LSH off): [F] entries
    and [F, H] tokens -> the decoded [R, e_local, C, H] on the far side,
    through ``dispatch_scatter_quantize``.  The same bits as
    ``coded_transfer(dispatch_scatter(...))``, values and gradient."""
    return _FusedDispatchTransfer.apply(flat_ids, pos, src, codec, fwd_leaf,
                                        bwd_leaf, model_r, num_experts,
                                        capacity)


def _received(codec: WireCodec, fwd_leaf: Leaf, expert_out: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode ``expert_out`` [R, e_local, c, H], move the leaves and
    flatten them to the kernels' (q [G, c, H], scales [G, c])."""
    q, scales = tuple(fwd_leaf(leaf) for leaf in codec.encode(expert_out))
    G = q.shape[0] * q.shape[1]
    return (q.reshape((G,) + tuple(q.shape[2:])),
            scales.reshape(G, scales.shape[-1]))


class _FusedCombineTransfer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, expert_out, flat_ids, pos, weights, codec, fwd_leaf,
                bwd_leaf, model_r):
        qb, sb = _received(codec, fwd_leaf, expert_out)
        ctx.save_for_backward(flat_ids, pos, qb, sb, weights)
        ctx.codec, ctx.bwd_leaf, ctx.model_r = codec, bwd_leaf, model_r
        ctx.e_dtype = expert_out.dtype
        return dispatch.dequantize_combine_gather(flat_ids, pos, qb, sb,
                                                  weights)

    @staticmethod
    def backward(ctx, ct):
        flat_ids, pos, qb, sb, weights = ctx.saved_tensors
        codec = ctx.codec
        E, C, H = qb.shape
        d_eo = d_w = None
        if ctx.needs_input_grad[3]:
            # d_w from the unweighted gather of the received buffer
            ones = torch.ones(flat_ids.shape, dtype=torch.float32,
                              device=flat_ids.device)
            gathered = dispatch.dequantize_combine_gather(flat_ids, pos, qb,
                                                          sb, ones)
            d_w = torch.sum(ct * gathered, dim=-1).to(weights.dtype)
        if ctx.needs_input_grad[0]:
            # d_buf: the scatter of the weighted cotangent, to the decode's
            # compute_dtype, moved back transposed in grad_dtype
            wct = ct * weights.to(torch.float32)[:, None]
            dbuf = dispatch.dispatch_scatter(flat_ids, pos, wct.contiguous(),
                                             E, C)
            dbuf = dbuf.to(_dtype(codec.compute_dtype)).reshape(
                ctx.model_r, E // ctx.model_r, C, H)
            d_eo = ctx.bwd_leaf(dbuf.to(codec.grad_dtype)).to(ctx.e_dtype)
        return d_eo, None, None, d_w, None, None, None, None


def fused_combine_transfer(expert_out: torch.Tensor, flat_ids: torch.Tensor,
                           pos: torch.Tensor, weights: torch.Tensor,
                           codec: WireCodec, fwd_leaf: Leaf, bwd_leaf: Leaf,
                           model_r: int) -> torch.Tensor:
    """The fused combine leg of the coded baseline (LSH off): expert
    outputs [R, e_local, C, H], encoded in transit, then
    ``dequantize_combine_gather`` on the received payload: the [F, H] f32
    weighted entries (callers sum over k).  The same bits as
    ``combine_gather(ids, pos, coded_transfer(eo), w)``, values and
    gradients."""
    return _FusedCombineTransfer.apply(expert_out, flat_ids, pos, weights,
                                       codec, fwd_leaf, bwd_leaf, model_r)


class _FusedDecodeResidual(torch.autograd.Function):
    @staticmethod
    def forward(ctx, expert_out, slots, base, residual, codec, fwd_leaf,
                bwd_leaf):
        qb, sb = _received(codec, fwd_leaf, expert_out)
        ctx.save_for_backward(slots)
        ctx.codec, ctx.bwd_leaf = codec, bwd_leaf
        ctx.e_shape, ctx.e_dtype = expert_out.shape, expert_out.dtype
        ctx.b_dtype = None if base is None else base.dtype
        ctx.r_dtype = residual.dtype
        return dispatch.dequantize_residual_apply(slots, qb, sb, residual,
                                                  base)

    @staticmethod
    def backward(ctx, ct):
        (slots,) = ctx.saved_tensors
        codec = ctx.codec
        R, el, S, H = ctx.e_shape
        # Y = (eo - base)[slot] + residual: d_residual = ct; the gather's
        # transpose seg (residual_apply's backward, as on the composed
        # path) flows to eo (to compute_dtype, then moved back in
        # grad_dtype) and, negated, to base
        seg = dispatch.residual_apply_transpose(slots, ct.contiguous(), S)
        d_eo = ctx.bwd_leaf(seg.reshape(R, el, S, H)
                            .to(_dtype(codec.compute_dtype))
                            .to(codec.grad_dtype)).to(ctx.e_dtype)
        d_base = None if ctx.b_dtype is None else (-seg).to(ctx.b_dtype)
        return (d_eo, None, d_base, ct.to(ctx.r_dtype), None, None, None)


def fused_decode_residual_transfer(expert_out: torch.Tensor,
                                   slots: torch.Tensor,
                                   base: Optional[torch.Tensor],
                                   residual: torch.Tensor, codec: WireCodec,
                                   fwd_leaf: Leaf, bwd_leaf: Leaf
                                   ) -> torch.Tensor:
    """The fused combine leg of the LSH path: expert outputs [R, e_local,
    S, H] encoded in transit, then ``dequantize_residual_apply`` decodes
    and decompresses in one pass: Y = ((q * scale) - base)[slot] +
    residual, [G, C, H] f32; ``base`` None is the branch without error
    compensation.  The same bits as decode -> f32 -> decompress, values
    and gradients."""
    return _FusedDecodeResidual.apply(expert_out, slots, base, residual,
                                      codec, fwd_leaf, bwd_leaf)
