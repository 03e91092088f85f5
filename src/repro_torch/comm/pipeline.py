"""The chunk-pipelined all-to-all and MoE exchange (counterpart of
``repro/comm/pipeline.py``).

The exchange dispatch -> expert MLP -> combine moves a wire tensor
[R, e_local, c, H] whose slot axis c chunks freely: the expert MLP works
token by token.  ``pipelined_moe_exchange`` runs it in K slot chunks, in
the reference's schedule: chunk k's dispatch transfer is issued before
chunk k-1's MLP and combine, and waited only just before chunk k is used,
so on NCCL the transfer runs on NCCL's stream while the MLP runs on the
current one (on gloo, on gloo's thread).  Each chunk is a contiguous copy
of its slice, and the transfer holds it until its wait.  The combine
transfers are waited together at the end.  The backward runs each
chunk's legs in turn (ROADMAP lists its overlap as later work).

The transfer of a chunk is a leg (comm/wire.py): by default the flat
all-to-all of the tensor as it is, or ``wire.transfer_fn(codec, group)``,
which encodes each chunk in transit.  Quantization is per slot row, so
the chunked coded transfer is bitwise the unchunked one.

A chunk count that does not divide the slot axis raises: the planner
degrades such a request to flat when it plans (core/moe.py pads the LSH
slot count so that the configured chunks divide it).

``pipelined_all_to_all`` is the chunked transfer alone: every chunk in
flight at once, values and gradients bit-equal to the flat all-to-all.
The exchange adds the chunked MLP, whose forward is the same product on
fewer rows and whose weight gradients are sums over chunks.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.profiler import record_function

from repro_torch.comm import wire as wire_lib


def _check_divides(chunks: int, extent: int) -> None:
    if chunks > 1 and extent % chunks:
        raise ValueError(
            f"overlap_chunks={chunks} does not divide the slot extent "
            f"{extent}; the planner must validate this at plan time "
            "(degrade to flat / pad the slot count); see comm/planner.py")


def _split(x: torch.Tensor, chunks: int, axis: int):
    """``chunks`` contiguous copies of x's equal slices along ``axis``."""
    if axis == 0:
        raise ValueError("the chunk axis cannot be the block axis 0")
    _check_divides(chunks, x.shape[axis])
    return [c.contiguous() for c in x.split(x.shape[axis] // chunks, axis)]


def pipelined_all_to_all(x: torch.Tensor, group, chunks: int, *,
                         chunk_axis: int = 2,
                         transfer: Optional[wire_lib.Leg] = None
                         ) -> torch.Tensor:
    """The flat all-to-all of x [R, ...] moved in ``chunks`` slices of
    ``chunk_axis``, all in flight at once.  ``transfer`` (a leg) moves
    each chunk; by default the tensor as it is, bitwise the flat
    all-to-all.  The output's dtype is the leg's (a codec decodes to its
    compute dtype)."""
    leg = transfer if transfer is not None else wire_lib.RawLeg(group)
    if chunks <= 1:
        return leg(x)
    handles = [leg.start(c) for c in _split(x, chunks, chunk_axis)]
    return torch.cat([h.wait() for h in handles], dim=chunk_axis)


def pipelined_moe_exchange(send: torch.Tensor, compute_fn: Callable, group,
                           chunks: int, *, chunk_axis: int = 2,
                           transfer: Optional[wire_lib.Leg] = None
                           ) -> torch.Tensor:
    """dispatch -> compute_fn -> combine of send [R, e_local, c, H],
    pipelined over ``chunks`` slot chunks; compute_fn maps a received
    chunk [R, e_local, c / K, H] to the same shape.  ``transfer`` is the
    leg (default: the flat all-to-all of the tensor as it is)."""
    leg = transfer if transfer is not None else wire_lib.RawLeg(group)
    if chunks <= 1:
        with record_function("dispatch"):
            recv = leg(send)
        out = compute_fn(recv)
        with record_function("combine"):
            return leg(out)
    parts = _split(send, chunks, chunk_axis)
    with record_function("dispatch"):
        inflight = leg.start(parts[0])
    combines = []
    for k in range(1, chunks + 1):
        nxt = None
        if k < chunks:
            with record_function("dispatch"):
                nxt = leg.start(parts[k])      # chunk k in flight ...
        recv = inflight.wait()                 # ... while k - 1 computes
        out = compute_fn(recv)
        with record_function("combine"):
            combines.append(leg.start(out))
        inflight = nxt
    with record_function("combine"):
        return torch.cat([h.wait() for h in combines], dim=chunk_axis)
