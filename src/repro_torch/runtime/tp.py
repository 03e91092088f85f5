"""Tensor parallelism over the ``model`` axis (counterpart of
``repro/runtime/tp.py``): the sequence-parallel residual stream meets a
mixer whose heads are split over the axis.

  sp_gather      the rank's sequence slice [B, S / g, H] -> the whole
                 sequence [B, S, H] (all-gather; backward: the
                 reduce-scatter of the cotangents);
  tp_in_project  SP -> TP: one all-gather of the activations, then this
                 rank's column slice of each weight, [B, S, D_i / g];
                 a projection marked ``replicate`` is instead computed
                 whole on the rank's own sequence slice and all-gathered
                 (the K / V of models/attention.py);
  tp_project     TP -> SP: this rank's row slice of the weight, the
                 partial product in the model dtype, and a
                 reduce-scatter of it back to the rank's sequence slice.

The collectives are comm/collectives.py's ``AllGather`` / ``ReduceScatter``
(each the other's backward, as the JAX package's ``all_gather_bf16`` /
``reduce_scatter_bf16`` VJPs) and ``AllReduceSum`` (``tp_rmsnorm``'s
cross-rank sum of squares, which GSPMD inserts in JAX).  They are called
on every mesh, over a one-rank group where the model axis has one rank
(``Mesh.tp_group``), so one card runs the code that four do.

The weights stay replicated, as runtime/sharding.py places them: this
module shards the compute, not the placement.  A replicated leaf read
through a slice gets a gradient of zeros outside it, and a projection
marked ``replicate`` reads only the rank's own tokens, so the step's sum
of the replicated gradients over the ranks (runtime/step.py) counts every
term once.  JAX's ``REPRO_DISABLE_TP_OPT`` switch and its GSPMD fallback
have no counterpart: a width that does not split over the axis raises.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.comm import collectives
from repro_torch.runtime import sharding


def _split(n: int, g: int, what: str) -> int:
    if n % g:
        raise ValueError(f"{what} does not split over a model axis of {g}")
    return n // g


def rank_slice(t: torch.Tensor, mesh, dim: int = -1) -> torch.Tensor:
    """This rank's block of ``dim`` of a replicated tensor (a view): block
    m of g along ``dim`` on model rank m."""
    g, m = sharding.axis_size(mesh, "model"), sharding.axis_index(mesh,
                                                                  "model")
    n = _split(t.shape[dim], g, f"dim {dim} of {tuple(t.shape)}")
    return t.narrow(dim, m * n, n)


def sp_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """[B, S / g, ...] (this rank's sequence slice) -> [B, S, ...]."""
    return collectives.AllGather.apply(x, mesh.tp_group(), 1)


def tp_in_project(x: torch.Tensor, ws: Sequence[torch.Tensor], mesh,
                  replicate: Sequence[bool] = ()) -> Tuple[torch.Tensor, ...]:
    """x: [B, S / g, H], this rank's sequence slice; each w: [H, D_i],
    replicated.  Returns, for each w, [B, S, D_i / g]: the whole sequence
    times this rank's column slice of w.  ``replicate[i]`` True gives
    [B, S, D_i] instead: x @ w on the rank's own slice, all-gathered, for
    a small projection every rank needs whole (its gradient then comes
    from the rank's own tokens only)."""
    g = sharding.axis_size(mesh, "model")
    rep = tuple(replicate) + (False,) * (len(ws) - len(replicate))
    for w, r in zip(ws, rep):
        if not r:
            _split(w.shape[1], g, f"a [{w.shape[0]}, {w.shape[1]}] "
                   f"projection of x {tuple(x.shape)}")
    xg = sp_gather(x, mesh)
    # a replicated projection reads the rank's own slice of the gathered
    # x (the values of x): every projection then reads x through the one
    # gather, in the order of ws, as the mesh-free products read x, so
    # that x's gradient sums its terms in the mesh-free order
    return tuple(sp_gather(rank_slice(xg, mesh, 1) @ w, mesh) if r
                 else xg @ rank_slice(w, mesh) for w, r in zip(ws, rep))


def tp_project(y: torch.Tensor, w: torch.Tensor, mesh) -> torch.Tensor:
    """y: [B, S, D / g], this rank's column slice; w: [D, H], replicated
    -> [B, S / g, H]: the sum over the ranks of y @ (this rank's rows of
    w), in the model dtype, scattered by sequence."""
    g = sharding.axis_size(mesh, "model")
    if w.shape[0] != y.shape[-1] * g:
        raise ValueError(f"y {tuple(y.shape)} holds {y.shape[-1]} of the "
                         f"{w.shape[0]} rows of w {tuple(w.shape)} over a "
                         f"model axis of {g}")
    _split(y.shape[1], g, f"the sequence of y {tuple(y.shape)}")
    part = y @ rank_slice(w, mesh, 0)
    return collectives.ReduceScatter.apply(part, mesh.tp_group(), 1)


def tp_rmsnorm(params, y: torch.Tensor, mesh,
               eps: float = 1e-5) -> torch.Tensor:
    """``layers.rmsnorm`` over a last dimension split over the model axis:
    y [..., D / g] is this rank's slice; the mean of squares is each
    rank's local mean, summed over the ranks (``AllReduceSum``) and
    divided by g, so on a one-rank axis it is the mesh-free mean, bit for
    bit; ``params["scale"]`` is the whole [D] scale."""
    g = sharding.axis_size(mesh, "model")
    yf = y.to(torch.float32)
    var = collectives.AllReduceSum.apply(
        torch.mean(yf * yf, dim=-1, keepdim=True),
        mesh.tp_group()) / g
    out = yf * torch.rsqrt(var + eps)
    scale = rank_slice(params["scale"], mesh).to(torch.float32)
    return (out * scale).to(y.dtype)
