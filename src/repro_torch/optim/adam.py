"""AdamW with optional block-quantized int8 moments (counterpart of
``repro/optim/adam.py``).

Params, grads and moments are dicts / lists of tensors of one structure;
over a mesh they are the rank's shards (runtime/params.py), and the
moments lie by the JAX package's ``moment_specs``: a float moment as its
param.  An int8 moment is quantized in blocks of 128 along the logical
last dimension, as in JAX; where that dimension splits
(``params.int8_splits``) a block's absmax is max-reduced over the split,
and ``q``, padded to a multiple of 128, is laid by its own spec (``scale``
whole along the last dimension), so the moments gather to JAX's.
Integer leaves (the MoE ``placement``) have no moments and are skipped;
every floating leaf is updated, with a zero gradient where it has none
(JAX gives the hash rotations ``lsh_rot`` a zero gradient, so weight decay
still moves them).  Unlike the JAX function, which returns new arrays,
``adamw_update`` writes the new params and moments IN PLACE (no second
copy of the training state) and returns the same objects.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.comm import collectives
from repro_torch.configs.base import OptimizerConfig
from repro_torch.runtime import params as params_lib
from repro_torch.runtime.params import Int8Split

_BLOCK = 128


class OptState(NamedTuple):
    step: torch.Tensor          # int32 scalar
    m: Any
    v: Any
    grad_skips: torch.Tensor    # int32 scalar, non-finite-loss skip counter


def leaves(tree: Any, spec: bool = False) -> List:
    """Leaves of a dict / list tree, in insertion order; ``spec``: a tree
    of specs (runtime/params.py), whose tuples are leaves."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v, spec)]
    if isinstance(tree, list) or isinstance(tree, tuple) and not spec:
        return [x for v in tree for x in leaves(v, spec)]
    return [tree]


def _map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _quant(x: torch.Tensor) -> Dict:
    """Blockwise absmax int8 along the last axis: q keeps the shape (last
    dim padded to a multiple of 128), scale is [..., n_blocks] f32."""
    shape = x.shape
    pad = (-shape[-1]) % _BLOCK
    xf = torch.nn.functional.pad(x.to(torch.float32), (0, pad))
    xb = xf.reshape(*shape[:-1], -1, _BLOCK)
    scale = torch.amax(torch.abs(xb), dim=-1) / 127.0
    q = torch.round(xb / torch.clamp(scale[..., None], min=1e-12)).to(
        torch.int8)
    return {"q": q.reshape(*shape[:-1], -1), "scale": scale}


def _dequant(d: Dict, shape) -> torch.Tensor:
    nb = d["scale"].shape[-1]
    xb = d["q"].to(torch.float32).reshape(*shape[:-1], nb, _BLOCK)
    x = (xb * d["scale"][..., None]).reshape(*shape[:-1], nb * _BLOCK)
    return x[..., :shape[-1]]


def _quant_floor(d: Dict, shape) -> torch.Tensor:
    """Half a quantization step per element: below it a stored value is
    zero."""
    s = torch.repeat_interleave(d["scale"], _BLOCK, dim=-1)[..., :shape[-1]]
    return 0.5 * s


def _positions(sp: Int8Split, n: int, device) -> Tuple[int, torch.Tensor]:
    """The start of the rank's n elements along the logical last
    dimension, and the block of each."""
    start, _ = params_lib.block(sp.p[-1], sp.mesh, sp.size)
    return start, (start + torch.arange(n, device=device)) // _BLOCK


def _quant_split(x: torch.Tensor, sp: Int8Split) -> Dict:
    """``_quant`` of the logical leaf, from the rank's shard x: each
    block's absmax max-reduced over the ranks that hold a part of it,
    then q re-laid from the param's split to its own (a gather over the
    one, a cut by the other) unless they are ``aligned``."""
    lead, n = x.shape[:-1], x.shape[-1]
    start, blocks = _positions(sp, n, x.device)
    xf = x.to(torch.float32)
    head = start % _BLOCK
    xb = torch.nn.functional.pad(xf, (head, (-(head + n)) % _BLOCK))
    part = torch.amax(torch.abs(xb.reshape(*lead, -1, _BLOCK)), dim=-1)
    amax = torch.zeros(*lead, -(-sp.size // _BLOCK), dtype=torch.float32,
                       device=x.device)
    amax[..., start // _BLOCK:start // _BLOCK + part.shape[-1]] = part
    axes = params_lib.split_axes(sp.p, sp.mesh)
    if axes:
        amax = collectives.raw_all_reduce_max(amax, sp.mesh.group(axes))
    scale = amax / 127.0
    q = torch.round(xf / torch.clamp(scale[..., blocks], min=1e-12)).to(
        torch.int8)
    if not sp.aligned:
        q = torch.nn.functional.pad(
            params_lib.gather(q, sp.p, sp.mesh),
            (0, scale.shape[-1] * _BLOCK - sp.size))
        q = params_lib.shard(q, sp.q, sp.mesh)
    return {"q": q, "scale": scale}


def _dequant_split(d: Dict, shape, sp: Int8Split
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rank's elements of an int8 moment laid as ``_quant_split``
    lays it, and each one's scale (``_quant_floor``'s)."""
    _, blocks = _positions(sp, shape[-1], d["q"].device)
    s = d["scale"][..., blocks]
    q = d["q"]
    if not sp.aligned:
        q = params_lib.shard(params_lib.gather(q, sp.q, sp.mesh)
                             [..., :sp.size], sp.p, sp.mesh)
    return q.to(torch.float32) * s, s


def _moment_init(p: torch.Tensor, dtype: str,
                 split: Optional[Int8Split] = None):
    if not p.is_floating_point():
        return None
    if dtype == "int8":
        if split is None:
            return _quant(torch.zeros_like(p, dtype=torch.float32))
        nb = -(-split.size // _BLOCK)
        q = params_lib.local_shape(tuple(p.shape[:-1]) + (nb * _BLOCK,),
                                   split.q, split.mesh)
        return {"q": torch.zeros(q, dtype=torch.int8, device=p.device),
                "scale": torch.zeros(*p.shape[:-1], nb, dtype=torch.float32,
                                     device=p.device)}
    return torch.zeros_like(p, dtype=getattr(torch, dtype))


def adamw_init(params: Any, cfg: OptimizerConfig,
               splits: Optional[List[Optional[Int8Split]]] = None
               ) -> OptState:
    """Zero moments of the params' shapes; ``splits``
    (``params.int8_splits``, int8 moments over a mesh) lays the int8
    moments whose last dimension splits."""
    dev = leaves(params)[0].device

    def moments():
        it = iter(splits or [])
        return _map(lambda p: _moment_init(p, cfg.moment_dtype,
                                           next(it, None)), params)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return OptState(torch.zeros((), dtype=torch.int32), moments(), moments(),
                    zero)


def global_norm(grads: List[Optional[torch.Tensor]],
                split: Optional[List[Tuple[str, ...]]] = None,
                mesh=None) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in f32, summed leaf
    by leaf in leaf order.

    Over a mesh it is the norm of the logical gradient: ``split[i]``
    names the mesh axes (of more than one rank) that leaf i's shards
    split over (runtime/params.split_axes), and its sum of squares is
    summed over them, one all-reduce for the leaves that split over the
    same axes; a leaf whole on every rank counts once."""
    sq = [None if g is None else torch.sum(torch.square(g.to(torch.float32)))
          for g in grads]
    by_axes: Dict[Tuple[str, ...], List[int]] = {}
    for i, g in enumerate(grads):
        if g is not None and split is not None and split[i]:
            by_axes.setdefault(tuple(split[i]), []).append(i)
    for axes, idx in by_axes.items():
        tot = collectives.all_reduce_sum(torch.stack([sq[i] for i in idx]),
                                         mesh.group(axes))
        for j, i in enumerate(idx):
            sq[i] = tot[j]
    return torch.sqrt(sum(s for s in sq if s is not None))


def adamw_update(params: Any, grads: List[Optional[torch.Tensor]],
                 state: OptState, cfg: OptimizerConfig, lr: torch.Tensor,
                 skip: Optional[torch.Tensor] = None, *,
                 grad_norm: Optional[torch.Tensor] = None,
                 splits: Optional[List[Optional[Int8Split]]] = None
                 ) -> OptState:
    """One AdamW step over ``leaves(params)``.  ``grads`` lists one entry
    per leaf: a tensor for a floating leaf (zeros where it has none), None
    for an integer leaf.  ``skip`` (a bool scalar tensor: non-finite loss),
    or a non-finite gradient norm, leaves params and moments unchanged and
    counts one skip.  Params and moments are updated in place.
    ``grad_norm`` is the clip norm when the caller has it (over a mesh:
    ``global_norm`` of the logical gradient), else ``global_norm(grads)``.
    ``splits`` as ``adamw_init``'s."""
    step = state.step + 1
    gn = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
    bad = ~torch.isfinite(gn)
    skip = bad if skip is None else (skip | bad)
    bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1), step.to(torch.float32))
    bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2), step.to(torch.float32))
    int8 = cfg.moment_dtype == "int8"
    splits = splits or [None] * len(grads)
    for p, g, m, v, sp in zip(leaves(params), grads, _moment_leaves(state.m),
                              _moment_leaves(state.v), splits):
        if g is None or not p.is_floating_point():
            continue
        with torch.no_grad():
            gf = g.to(torch.float32) * scale
            if int8 and sp is not None:
                mf, _ = _dequant_split(m, p.shape, sp)
                vf, vs = _dequant_split(v, p.shape, sp)
                vf = torch.maximum(vf, 0.5 * vs)
                del vs
            elif int8:
                mf = _dequant(m, p.shape)
                # absmax int8 flushes small v entries to zero: clamp the
                # dequantized variance to its own quantization floor
                vf = torch.maximum(_dequant(v, p.shape),
                                   _quant_floor(v, p.shape))
            else:
                mf, vf = m.to(torch.float32), v.to(torch.float32)
            mf = cfg.b1 * mf + (1 - cfg.b1) * gf
            vf = cfg.b2 * vf + (1 - cfg.b2) * torch.square(gf)
            upd = (mf / bc1) / (torch.sqrt(vf / bc2) + cfg.eps)
            pf = p.to(torch.float32)
            upd = upd + cfg.weight_decay * pf
            # an explicit where: keep * NaN would still poison the params
            p.copy_(torch.where(skip, pf, pf - lr * upd))
            if int8:
                quant = _quant if sp is None else \
                    (lambda x: _quant_split(x, sp))
                for old, new in ((m, quant(mf)), (v, quant(vf))):
                    for key in ("q", "scale"):
                        old[key].copy_(torch.where(skip, old[key], new[key]))
            else:
                m.copy_(torch.where(skip, m, mf.to(m.dtype)))
                v.copy_(torch.where(skip, v, vf.to(v.dtype)))
            # free this leaf's f32 copies before the next leaf makes its
            # own: at a billion elements a leaf each is gigabytes
            del gf, mf, vf, upd, pf
    return OptState(step, state.m, state.v,
                    state.grad_skips + skip.to(torch.int32))


def _moment_leaves(tree: Any) -> List:
    """Moment leaves aligned with ``leaves(params)``: an int8 moment is one
    {"q", "scale"} dict per param leaf, not two leaves."""
    if isinstance(tree, dict) and set(tree) == {"q", "scale"}:
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _moment_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _moment_leaves(v)]
    return [tree]
