"""AdamW with optional block-quantized int8 moments (counterpart of
``repro/optim/adam.py``).

Params, grads and moments are dicts / lists of tensors of one structure.
Integer leaves (the MoE ``placement``) have no moments and are skipped;
every floating leaf is updated, with a zero gradient where it has none
(JAX gives the hash rotations ``lsh_rot`` a zero gradient, so weight decay
still moves them).  Unlike the JAX function, which returns new arrays,
``adamw_update`` writes the new params and moments IN PLACE (no second
copy of the training state) and returns the same objects.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import torch

from repro_torch.comm import collectives
from repro_torch.configs.base import OptimizerConfig

_BLOCK = 128


class OptState(NamedTuple):
    step: torch.Tensor          # int32 scalar
    m: Any
    v: Any
    grad_skips: torch.Tensor    # int32 scalar, non-finite-loss skip counter


def leaves(tree: Any) -> List:
    """Leaves of a dict / list tree, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
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


def _moment_init(p: torch.Tensor, dtype: str):
    if not p.is_floating_point():
        return None
    if dtype == "int8":
        return _quant(torch.zeros_like(p, dtype=torch.float32))
    return torch.zeros_like(p, dtype=getattr(torch, dtype))


def adamw_init(params: Any, cfg: OptimizerConfig) -> OptState:
    dev = leaves(params)[0].device
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return OptState(
        torch.zeros((), dtype=torch.int32),
        _map(lambda p: _moment_init(p, cfg.moment_dtype), params),
        _map(lambda p: _moment_init(p, cfg.moment_dtype), params),
        zero)


def global_norm(grads: List[Optional[torch.Tensor]],
                sharded: Optional[List[bool]] = None,
                group=None) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in f32, summed leaf
    by leaf in leaf order.

    Over a mesh it is the norm of the logical gradient: a replicated
    leaf (the same on every rank) counts once, and the squares of a leaf
    whose ``sharded`` entry is True (each rank holds a distinct shard)
    are summed over ``group``'s ranks, in one all-reduce of those leaves'
    sums."""
    sq = [None if g is None else torch.sum(torch.square(g.to(torch.float32)))
          for g in grads]
    idx = [i for i, g in enumerate(grads)
           if g is not None and sharded is not None and sharded[i]]
    if idx and collectives.group_size(group) > 1:
        tot = collectives.all_reduce_sum(torch.stack([sq[i] for i in idx]),
                                         group)
        for j, i in enumerate(idx):
            sq[i] = tot[j]
    return torch.sqrt(sum(s for s in sq if s is not None))


def adamw_update(params: Any, grads: List[Optional[torch.Tensor]],
                 state: OptState, cfg: OptimizerConfig, lr: torch.Tensor,
                 skip: Optional[torch.Tensor] = None, *,
                 grad_norm: Optional[torch.Tensor] = None) -> OptState:
    """One AdamW step over ``leaves(params)``.  ``grads`` lists one entry
    per leaf: a tensor for a floating leaf (zeros where it has none), None
    for an integer leaf.  ``skip`` (a bool scalar tensor: non-finite loss),
    or a non-finite gradient norm, leaves params and moments unchanged and
    counts one skip.  Params and moments are updated in place.
    ``grad_norm`` is the clip norm when the caller has it (over a mesh:
    ``global_norm`` of the logical gradient), else ``global_norm(grads)``."""
    step = state.step + 1
    gn = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
    bad = ~torch.isfinite(gn)
    skip = bad if skip is None else (skip | bad)
    bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1), step.to(torch.float32))
    bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2), step.to(torch.float32))
    int8 = cfg.moment_dtype == "int8"
    for p, g, m, v in zip(leaves(params), grads, _moment_leaves(state.m),
                          _moment_leaves(state.v)):
        if g is None or not p.is_floating_point():
            continue
        with torch.no_grad():
            gf = g.to(torch.float32) * scale
            mf = _dequant(m, p.shape) if int8 else m.to(torch.float32)
            if int8:
                # absmax int8 flushes small v entries to zero: clamp the
                # dequantized variance to its own quantization floor
                vf = torch.maximum(_dequant(v, p.shape),
                                   _quant_floor(v, p.shape))
            else:
                vf = v.to(torch.float32)
            mf = cfg.b1 * mf + (1 - cfg.b1) * gf
            vf = cfg.b2 * vf + (1 - cfg.b2) * torch.square(gf)
            upd = (mf / bc1) / (torch.sqrt(vf / bc2) + cfg.eps)
            pf = p.to(torch.float32)
            upd = upd + cfg.weight_decay * pf
            # an explicit where: keep * NaN would still poison the params
            p.copy_(torch.where(skip, pf, pf - lr * upd))
            if int8:
                for old, new in ((m, _quant(mf)), (v, _quant(vf))):
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
