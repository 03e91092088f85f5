"""JAX param pytree -> the port's params, and the port's params over a
mesh.

The caller hands over the JAX package's params with numpy leaves (for
example ``jax.tree.map(np.asarray, params)``); this module imports neither
JAX nor ``repro``.  bfloat16 leaves arrive as ``ml_dtypes.bfloat16`` arrays,
which ``torch.from_numpy`` rejects, so they travel as their uint16 bits and
are viewed as ``torch.bfloat16`` again.

JAX stores ``blocks`` as one entry per layout position, each stacked
[num_super_blocks, ...]; the port's ``layers`` list is super-block major with
the layout interleaved inside (models/model.py), the order the JAX scan runs
the blocks in.

``shard_params`` cuts full params to a rank's part by the reference's
partition spec of the expert weights (``P("model", "data", None)``;
everything else is replicated: runtime/sharding.py), and
``gather_params`` puts the ranks' parts together again.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.comm import collectives
from repro_torch.runtime import sharding


def tensor_from_numpy(a: Any, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _index(tree: Any, i: int) -> Any:
    return _map(tree, lambda a: np.asarray(a)[i])


def params_from_jax(tree: Dict, *, device: DeviceLike = None) -> Dict:
    """The JAX ``init_params`` pytree (numpy leaves) -> port params on
    ``device`` (the CUDA device unless "cpu" is asked for)."""
    dev = resolve_device(device)
    blocks: List[Dict] = list(tree["blocks"])
    n_super = np.asarray(next(_leaves(blocks[0]))).shape[0] if blocks else 0
    layers = [_index(blocks[i], sb) for sb in range(n_super)
              for i in range(len(blocks))]
    out = {k: v for k, v in tree.items() if k != "blocks"}
    if "encoder" in out:
        raise NotImplementedError("encoder-decoder params are not ported")
    out["layers"] = layers
    return _map(out, lambda a: tensor_from_numpy(a, dev))


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _map_experts(params: Dict, fn) -> Dict:
    """``params`` with ``fn`` applied to every expert weight (the others
    are the same tensors)."""
    mask = iter(sharding.expert_leaf_mask(params))
    return _map(params, lambda t: fn(t) if next(mask) else t)


def shard_params(params: Dict, mesh) -> Dict:
    """Full port params (``params_from_jax``, or ``init_params`` without
    a mesh) -> this rank's part: each expert weight [E_pad, X, Y] cut to
    [E_pad / model, X / data, Y]; E_pad must split over the model axis
    (the JAX ``init_params`` on the same mesh pads it so)."""
    def cut(t):
        s0, s1 = sharding.expert_slices(mesh, t.shape)
        return t[s0, s1].contiguous()
    return _map_experts(params, cut)


def gather_params(params: Dict, mesh) -> Dict:
    """The inverse of ``shard_params``: the full expert weights, gathered
    over ``data`` then ``model`` (a collective: every rank calls it)."""
    def gather(t):
        t = collectives.raw_all_gather(t, sharding.group(mesh, "data"), 1) \
            if sharding.axis_size(mesh, "data") > 1 else t
        return collectives.raw_all_gather(t, sharding.model_group(mesh), 0) \
            if sharding.axis_size(mesh, "model") > 1 else t
    return _map_experts(params, gather)
