"""Differentiable collectives over a process group (counterpart of
``repro/comm/collectives.py``).

Each is a ``torch.autograd.Function`` whose backward is its transpose:

  all_gather      <-transpose->  reduce_scatter (sum)
  all_to_all      <-transpose->  all_to_all (split = concat = dim 0)

They move words, as the JAX package's ``_bits`` / ``_unbits`` do, so that
no backend converts or widens the wire: bf16 (and f16) and fp8 move as
their bytes (a uint8 view, the last dimension times the item size; gloo
rejects float8 dtypes, and neither gloo nor NCCL moves int16), f32 and
int8 as they are.  The reduce-scatter is the JAX one's: an
all-to-all of the addends, then a sum in f32 in rank order, cast back;
so it is deterministic and the same on every backend.

``raw_all_to_all_async`` issues the all-to-all with ``async_op=True``
and returns a ``Pending`` (the result, the backend's ``Work`` and the
buffers it uses), waited just before the result is read: the pipelined
transport's chunks (comm/pipeline.py).  The hierarchical transport's two
hops are ``raw_all_to_all`` over a rank's subgroups (comm/hierarchical.py).

A group of one rank (``None``, or a group of size 1) is the identity
with no call, as XLA drops a collective over one device.  The
``AllToAll``, ``AllGather`` and ``ReduceScatter`` classes always call
the backend; the functions below them take the shortcut.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

_BYTES = (torch.bfloat16, torch.float16, torch.float8_e4m3fn,
          torch.float8_e5m2)


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _bits(x: torch.Tensor) -> torch.Tensor:
    x = x.detach().contiguous()
    return x.view(torch.uint8) if x.dtype in _BYTES else x


def _unbits(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.view(dtype) if dtype in _BYTES else x


def raw_all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """x [R, ...] -> [R, ...]: block r goes to rank r, and block r of the
    result came from rank r."""
    b = _bits(x)
    out = torch.empty_like(b)
    dist.all_to_all_single(out, b, group=group)
    return _unbits(out, x.dtype)


class Pending:
    """An all-to-all in flight: its result ``out`` (filled once ``work``
    completes) and the backend's ``work`` (None: nothing in flight).  It
    holds the send and receive buffers until ``wait``, so that the
    caching allocator cannot hand them out while the backend uses them."""

    def __init__(self, out: torch.Tensor, work=None, buffers=()):
        self.out, self.work, self._buffers = out, work, buffers

    def wait(self) -> torch.Tensor:
        """The result, once it is there: on NCCL the current stream waits
        for the transfer (the host does not), on gloo the host waits."""
        if self.work is not None:
            self.work.wait()
            self.work, self._buffers = None, ()
        return self.out


def raw_all_to_all_async(x: torch.Tensor, group) -> Pending:
    """``raw_all_to_all`` issued with ``async_op=True``: returns at once,
    the transfer in flight; ``wait()`` before reading the result."""
    b = _bits(x)
    out = torch.empty_like(b)
    work = dist.all_to_all_single(out, b, group=group, async_op=True)
    return Pending(_unbits(out, x.dtype), work, (b, out))


def all_to_all_async(x: torch.Tensor, group) -> Pending:
    """``raw_all_to_all_async``; over a group of one rank, x, no call."""
    return Pending(x) if group_size(group) == 1 \
        else raw_all_to_all_async(x, group)


def raw_all_gather(x: torch.Tensor, group, axis: int) -> torch.Tensor:
    """[..., n, ...] -> [..., g * n, ...] along ``axis``, rank r's block at
    r (tiled)."""
    g = group_size(group)
    b = _bits(x)
    out = torch.empty((g * b.shape[0],) + tuple(b.shape[1:]), dtype=b.dtype,
                      device=b.device)
    dist.all_gather_into_tensor(out, b, group=group)
    out = _unbits(out, x.dtype).reshape((g,) + tuple(x.shape)).movedim(
        0, axis)
    shape = list(x.shape)
    shape[axis] *= g
    return out.reshape(shape)


def raw_reduce_scatter(x: torch.Tensor, group, axis: int) -> torch.Tensor:
    """Sum the ranks' ``x`` and keep block r of ``axis`` on rank r: an
    all-to-all of the addends, then their sum in f32 in rank order."""
    g = group_size(group)
    shape = list(x.shape)
    if shape[axis] % g:
        raise ValueError(f"axis {axis} of {tuple(x.shape)} does not split "
                         f"over {g} ranks")
    parts = x.reshape(shape[:axis] + [g, shape[axis] // g]
                      + shape[axis + 1:]).movedim(axis, 0)
    got = raw_all_to_all(parts, group)
    acc = got[0].to(torch.float32)
    for r in range(1, g):
        acc = acc + got[r].to(torch.float32)
    return acc.to(x.dtype)


def raw_all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group's ranks, in a new tensor."""
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


class AllToAll(torch.autograd.Function):
    """Self-transpose all-to-all over dim 0."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return raw_all_to_all(x, group)

    @staticmethod
    def backward(ctx, ct):
        return raw_all_to_all(ct, ctx.group), None


class AllGather(torch.autograd.Function):
    """Tiled all-gather along ``axis``; backward: the reduce-scatter."""

    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return raw_all_gather(x, group, axis)

    @staticmethod
    def backward(ctx, ct):
        return raw_reduce_scatter(ct, ctx.group, ctx.axis), None, None


class ReduceScatter(torch.autograd.Function):
    """Reduce-scatter (sum) along ``axis``; backward: the all-gather."""

    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return raw_reduce_scatter(x, group, axis)

    @staticmethod
    def backward(ctx, ct):
        return raw_all_gather(ct, ctx.group, ctx.axis), None, None


class AllReduceMean(torch.autograd.Function):
    """The mean over the group's ranks of a tensor each rank holds; each
    rank gets the same result.  Backward: the mean of the cotangents."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return raw_all_reduce_sum(x, group) / group_size(group)

    @staticmethod
    def backward(ctx, ct):
        return raw_all_reduce_sum(ct, ctx.group) / group_size(ctx.group), \
            None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    return x if group_size(group) == 1 else AllToAll.apply(x, group)


def all_gather(x: torch.Tensor, group, axis: int) -> torch.Tensor:
    return x if group_size(group) == 1 else AllGather.apply(x, group, axis)


def reduce_scatter(x: torch.Tensor, group, axis: int) -> torch.Tensor:
    return x if group_size(group) == 1 else ReduceScatter.apply(x, group,
                                                                axis)


def all_reduce_mean(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable mean over the group (the JAX package's ``pmean``)."""
    return x if group_size(group) == 1 else AllReduceMean.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group, no gradient (counts, loads, reported
    metrics)."""
    return x if group_size(group) == 1 else raw_all_reduce_sum(x, group)


BUCKET_BYTES = 256 << 20


def all_reduce_sum_(tensors: List[Optional[torch.Tensor]], group) -> None:
    """Sum every tensor over the group IN PLACE, in buckets of one dtype
    and about ``BUCKET_BYTES`` (the tensors flattened into one buffer a
    call); None entries are skipped."""
    if group_size(group) == 1:
        return
    by_dtype = {}
    for t in tensors:
        if t is not None:
            by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        bucket, nbytes = [], 0
        for i, t in enumerate(ts):
            bucket.append(t)
            nbytes += t.numel() * t.element_size()
            if nbytes >= BUCKET_BYTES or i == len(ts) - 1:
                _reduce_bucket(bucket, group)
                bucket, nbytes = [], 0


def _reduce_bucket(ts: List[torch.Tensor], group) -> None:
    flat = torch.cat([t.reshape(-1) for t in ts])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    off = 0
    for t in ts:
        n = t.numel()
        t.copy_(flat[off:off + n].view_as(t))
        off += n
