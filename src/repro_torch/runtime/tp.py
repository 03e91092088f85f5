"""Tensor parallelism over ``model`` and FSDP over ``data``
(counterpart of ``repro/runtime/tp.py``): the sequence-parallel residual
stream meets a mixer or FFN whose heads / hidden columns are split over
``model``, with weights that are the rank's shards (runtime/params.py).

  sp_gather      the rank's sequence slice [B, S / g, H] -> the whole
                 sequence [B, S, H] (all-gather; backward: the
                 reduce-scatter of the cotangents);
  tp_in_project  SP -> TP: one all-gather of the activations, each weight
                 [H / data, D_i / g] all-gathered over ``data`` (FSDP),
                 then [B, S, D_i / g]; a projection marked ``replicate``
                 also gathers its columns over ``model`` and is computed
                 whole on the rank's own sequence slice, then
                 all-gathered (the K / V of models/attention.py);
  tp_project     TP -> SP: the weight [D / g, H / data] all-gathered over
                 ``data``, the partial product in the model dtype, and a
                 reduce-scatter of it back to the rank's sequence slice;
  decode_project the decode step's one token, replicated over ``model``:
                 no sequence to gather or scatter, so the rank's columns
                 times its rows of the whole weight, summed over the
                 ranks in rank order (``rank_sum``);
  replicated     a mixer run whole on every rank of ``model`` (the
                 fallback below, for a whole mixer at once).

The collectives are comm/collectives.py's ``AllGather`` / ``ReduceScatter``
(each the other's backward, as the JAX package's ``all_gather_bf16`` /
``reduce_scatter_bf16`` VJPs) and ``AllReduceSum`` (``tp_rmsnorm``'s
cross-rank sum of squares, which GSPMD inserts in JAX).  The model-axis
ones are called on every mesh, over a one-rank group where the model
axis has one rank (``Mesh.tp_group``), so one card runs the code that
four do; the FSDP gather is made only where the weight is split over
``data``.  Each weight comes with its spec (runtime/params.py), which
says where it splits: the helpers gather by it.

Gradients: the FSDP gather's backward reduce-scatters a weight's
gradient over ``data``, and a weight whose columns (rows) split over
``model`` reads the whole sequence, so its gradient leaves complete; a
weight the rules keep whole over ``model`` (a ``replicate`` projection
of uncut columns, the norm scale ``tp_rmsnorm`` reads in slices) gets
the terms of the rank's own tokens, or zeros outside its slice, and the
step sums it over the axes it does not split over (runtime/step.py).

Widths that do not split take the JAX package's fallback
(``repro/runtime/tp.py:99-108``): where a projection's columns do not
split over ``model``, or its rows over ``data`` (``projects_whole``), or
the caller asks for it (attention whose query heads do not split),
``tp_in_project`` computes every projection of the call replicated over
``model``: every rank takes the whole sequence and the whole weights
(gathered by their specs) and gets the whole [B, S, D_i].  ``tp_project``
then multiplies the whole [B, S, D] by the whole weight and keeps the
rank's sequence slice.  The slice makes the cotangents that flow back
into the replicated region the rank's own tokens' terms, so every
gather's backward (a reduce-scatter) sums them over the ranks as on the
split path.  ``replicated`` is that fallback for a whole mixer: every
leaf gathered whole, the mesh-free function over the whole sequence, the
rank's slice kept.  JAX's ``REPRO_DISABLE_TP_OPT`` switch has no
counterpart.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.comm import collectives
from repro_torch.runtime import params as params_lib
from repro_torch.runtime import sharding


def rank_slice(t: torch.Tensor, mesh, dim: int = -1) -> torch.Tensor:
    """This rank's block of ``dim`` of a replicated tensor (a view): block
    m of g along ``dim`` on model rank m (``dim`` a multiple of g)."""
    g, m = sharding.axis_size(mesh, "model"), sharding.axis_index(mesh,
                                                                  "model")
    n = t.shape[dim] // g
    return t.narrow(dim, m * n, n)


def sp_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """[B, S / g, ...] (this rank's sequence slice) -> [B, S, ...]."""
    return collectives.AllGather.apply(x, mesh.tp_group(), 1)


def fsdp_gather(w: torch.Tensor, spec, mesh, dim: int) -> torch.Tensor:
    """The weight whole along ``dim``: all-gathered over ``data`` where
    its spec splits ``dim`` over it (backward: the reduce-scatter of its
    gradient), else ``w`` itself."""
    if "data" in spec[dim] and sharding.axis_size(mesh, "data") > 1:
        return collectives.AllGather.apply(w, sharding.group(mesh, "data"),
                                           dim)
    return w


def projects_whole(mesh, specs: Sequence,
                   replicate: Sequence[bool] = ()) -> bool:
    """Whether ``tp_in_project`` takes the replicated fallback for weights
    of ``specs``: a ``model`` axis of more than one rank, and a projection
    (not marked ``replicate``) whose columns do not split over it, or a
    weight whose rows do not split over a ``data`` axis of more than one
    rank (the JAX package's divisibility test)."""
    if sharding.axis_size(mesh, "model") == 1:
        return False
    rep = tuple(replicate) + (False,) * (len(specs) - len(replicate))
    d = sharding.axis_size(mesh, "data")
    return any(not r and "model" not in spec[1]
               or d > 1 and "data" not in spec[0]
               for spec, r in zip(specs, rep))


def tp_in_project(x: torch.Tensor, ws: Sequence[torch.Tensor], mesh,
                  specs: Sequence, replicate: Sequence[bool] = (),
                  whole: Optional[bool] = None) -> Tuple[torch.Tensor, ...]:
    """x: [B, S / g, H], this rank's sequence slice; each w the rank's
    shard of an [H, D_i] weight of spec ``specs[i]``: [H / data or H,
    D_i / g] (or [., D_i] for a replicated projection whose columns the
    rules keep whole).  Returns, for each w, [B, S, D_i / g]: the whole
    sequence times the rank's columns.  ``replicate[i]`` True gives
    [B, S, D_i] instead: x @ (the whole w) on the rank's own slice,
    all-gathered, for a small projection every rank needs whole (its
    gradient then comes from the rank's own tokens only, summed over
    ``model`` by the columns' gather or by the step).  ``whole`` (None:
    ``projects_whole``) computes every projection replicated over
    ``model``, [B, S, D_i] each (module docstring)."""
    g = sharding.axis_size(mesh, "model")
    rep = tuple(replicate) + (False,) * (len(ws) - len(replicate))
    if whole is None:
        whole = projects_whole(mesh, specs, rep)
    xg = sp_gather(x, mesh)
    if whole:
        return tuple(xg @ params_lib.gather(w, spec, mesh, grad=True)
                     for w, spec in zip(ws, specs))
    outs = []
    # a replicated projection reads the rank's own slice of the gathered
    # x (the values of x): every projection then reads x through the one
    # gather, in the order of ws, as the mesh-free products read x, so
    # that x's gradient sums its terms in the mesh-free order
    for w, spec, r in zip(ws, specs, rep):
        w = fsdp_gather(w, spec, mesh, 0)
        if r:
            if g > 1 and "model" in spec[1]:
                w = collectives.AllGather.apply(w, sharding.model_group(mesh),
                                                1)
            outs.append(sp_gather(rank_slice(xg, mesh, 1) @ w, mesh))
        else:
            outs.append(xg @ w)
    return tuple(outs)


def tp_project(y: torch.Tensor, w: torch.Tensor, mesh,
               spec) -> torch.Tensor:
    """y: [B, S, D / g], this rank's column slice; w the rank's shard of
    a [D, out] weight of ``spec``, [D / g, out / data or out] ->
    [B, S / g, out]: the sum over the ranks of y @ (the rank's rows of
    w), in the model dtype, scattered by sequence.  A whole y [B, S, D]
    (``tp_in_project``'s fallback) is multiplied by the whole w, and the
    rank keeps its sequence slice."""
    g = sharding.axis_size(mesh, "model")
    if g > 1 and (y.shape[-1] != w.shape[0] or "model" not in spec[0]):
        return rank_slice(y @ params_lib.gather(w, spec, mesh, grad=True),
                          mesh, 1)
    part = y @ fsdp_gather(w, spec, mesh, 1)
    return collectives.ReduceScatter.apply(part, mesh.tp_group(), 1)


def replicated(fn, params, specs, x: torch.Tensor, mesh) -> torch.Tensor:
    """``fn(whole params, whole x)`` replicated over ``model``: every leaf
    of ``params`` gathered whole by its spec in ``specs`` (with its
    gradient), x [B, S / g, H] gathered to the whole sequence, and the
    rank's slice [B, S / g, out] of fn's [B, S, out] kept (the module
    docstring's fallback; on a one-rank axis the mesh-free function, bit
    for bit)."""
    whole = params_lib.map_specs(
        lambda t, s: params_lib.gather(t, s, mesh, grad=True), params, specs)
    return rank_slice(fn(whole, sp_gather(x, mesh)), mesh, 1)


def decode_project(y: torch.Tensor, w: torch.Tensor, mesh) -> torch.Tensor:
    """The decode step's output projection over heads split over
    ``model``: y [B, D / g], this rank's columns of one replicated token;
    w the whole [D, out] weight.  Returns the whole [B, out] on every
    rank: the ranks' y @ (their rows of w), all-gathered and summed in
    rank order (no reduce-scatter: the token is not split by sequence;
    no all-reduce: the sum's order, so its bits, is fixed)."""
    return rank_sum(y @ rank_slice(w, mesh, 0), mesh)


def rank_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over the ranks of ``model`` of each rank's ``t``, the same
    bits on every rank: one all-gather, then the parts added in rank
    order (no all-reduce, whose order is not fixed)."""
    got = collectives.raw_all_gather(t[None].contiguous(), mesh.tp_group(),
                                     0)
    out = got[0]
    for r in range(1, got.shape[0]):
        out = out + got[r]
    return out


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
