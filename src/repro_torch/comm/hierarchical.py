"""The 2-hop all-to-all over a model axis that factors into nodes
(counterpart of ``repro/comm/hierarchical.py``).

With ranks node-major (rank = node * intra + local, as launch/mesh.py
lays them out), the flat all-to-all of x [R, ...] (block p * intra + q
bound for rank (p, q)) is two all-to-alls over subgroups:

  hop 1, intra-node  over the ranks of this node, on the local-index axis
                     q: y[p, j'] = x_(i, j')[p, q] on rank (i, q);
  hop 2, inter-node  over the ranks with this local index, on the node
                     axis p: z[i', j'] = x_(i', j')[p, q] on rank (p, q),

which is the flat result: the slow link carries (inter - 1) large
messages instead of (R - intra) small ones.  Each hop is a plain
all-to-all over this rank's own subgroup (``collectives.raw_all_to_all``,
so bf16 and fp8 move as bytes), and each is its own transpose, so the
backward is the mirrored 2-hop, inter then intra.  It moves data only:
values and gradients are bit-equal to the flat all-to-all's.

``groups`` is (intra_group, inter_group), this rank's subgroups, from
``launch.mesh.Mesh.hop_groups``.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch.profiler import record_function

from repro_torch.comm import collectives


def intra_groups(r: int, intra: int):
    """Rank groups sharing a node: [[0..intra-1], [intra..2*intra-1], ...]."""
    return tuple(tuple(n * intra + j for j in range(intra))
                 for n in range(r // intra))


def inter_groups(r: int, intra: int):
    """Rank groups sharing a local index q, one rank a node."""
    return tuple(tuple(p * intra + q for p in range(r // intra))
                 for q in range(intra))


def _hop(x: torch.Tensor, group, axis: int) -> torch.Tensor:
    """The all-to-all of x over ``group`` on block axis ``axis``."""
    if axis == 0:
        return collectives.raw_all_to_all(x, group)
    return collectives.raw_all_to_all(x.movedim(axis, 0), group).movedim(
        0, axis)


def two_hop(x: torch.Tensor, groups: Tuple, mirrored: bool = False
            ) -> torch.Tensor:
    """x [R, ...], block axis 0 by destination rank, through both hops
    (``mirrored``: inter first, the transpose)."""
    intra_group, inter_group = groups
    intra = collectives.group_size(intra_group)
    r = x.shape[0]
    out = x.reshape((r // intra, intra) + tuple(x.shape[1:]))
    hops = [(1, intra_group), (0, inter_group)]
    if mirrored:
        hops.reverse()
    for axis, group in hops:
        out = _hop(out, group, axis)
    return out.reshape(x.shape)


class HierarchicalAllToAll(torch.autograd.Function):
    """The 2-hop all-to-all; backward: the mirrored 2-hop."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return two_hop(x, groups)

    @staticmethod
    def backward(ctx, ct):
        return two_hop(ct, ctx.groups, mirrored=True), None


def hierarchical_all_to_all(x: torch.Tensor, groups: Tuple) -> torch.Tensor:
    """Differentiable 2-hop all-to-all of x [R, ...]: the flat
    ``collectives.all_to_all``'s values and gradients."""
    return HierarchicalAllToAll.apply(x, groups)


def hierarchical_moe_exchange(send: torch.Tensor, compute_fn: Callable,
                              groups: Tuple) -> torch.Tensor:
    """dispatch -> compute_fn -> combine, both legs over the 2-hop, under
    the profiler ranges "dispatch" and "combine"; send [R, e_local, c,
    H], compute_fn keeps that shape."""
    with record_function("dispatch"):
        recv = hierarchical_all_to_all(send, groups)
    out = compute_fn(recv)
    with record_function("combine"):
        return hierarchical_all_to_all(out, groups)
