"""LSH-MoE as a composable module (counterpart of
``repro/core/lsh_moe.py``).

``lsh_moe_init`` builds the param dict (router, padded expert stack, LSH
rotations, expert placement permutation) with the JAX package's keys and
shapes; with a mesh the experts pad to a multiple of the model axis and
each rank keeps its shard of them (runtime/sharding.py).
``lsh_moe_apply`` routes to the expert-parallel path (train / prefill, LSH
compression on unless ``use_lsh`` says otherwise) or the dense-dispatch
decode path.  Over a mesh the layer's leaves lie by runtime/params.py's
rules: the experts [E_pad / model, X / data, Y], the rest whole.
``apply_placement_update`` moves the expert weights to a new placement
(hot-expert rebalancing, runtime/fault.py).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.convert import gather_params, shard_params
from repro_torch.core import moe as moe_lib
from repro_torch.core.hashing import make_rotations
from repro_torch.models.layers import expert_mlp_init, fanin_init
from repro_torch.runtime import sharding

EXPERT_KEYS = ("w_gate", "w_up", "w_down")


def lsh_moe_init(gen: torch.Generator, d_model: int, cfg: MoEConfig, *,
                 mlp_act: str, dtype, device, mesh=None,
                 place: bool = True) -> Dict:
    """Every rank draws the same full params from ``gen``, the experts
    padded to a multiple of the model axis, and (``place``) keeps its
    shard of them."""
    e_pad = moe_lib.padded_num_experts(
        cfg.num_experts, sharding.axis_size(mesh, "model"))
    p = expert_mlp_init(gen, e_pad, d_model, cfg.expert_ffn_dim, mlp_act,
                        dtype, device)
    p["router_w"] = fanin_init(gen, (d_model, cfg.num_experts),
                               torch.float32, device)
    p["lsh_rot"] = make_rotations(gen, cfg.lsh.num_hashes, d_model,
                                  min(cfg.lsh.rotation_dim, d_model), dtype,
                                  device)
    p["placement"] = torch.arange(cfg.num_experts, dtype=torch.int32,
                                  device=device)
    return p if mesh is None or not place else shard_params(p, mesh)


def lsh_moe_apply(params: Dict, x: torch.Tensor, cfg: MoEConfig, *,
                  mlp_act: str, mode: str = "train",
                  use_lsh: Optional[bool] = None, mesh=None
                  ) -> Union[torch.Tensor, Tuple[torch.Tensor, Dict]]:
    """mode "train" | "prefill" -> expert-parallel path (+ LSH), returning
    (y, stats) with "aux_loss", "z_loss" and "expert_load" as the JAX
    function does.  "decode" -> dense dispatch, returning y only: decode
    reads no losses, and ``gating.gating_losses`` gives them to a caller
    that wants them."""
    if mode == "decode":
        return moe_lib.moe_dense_dispatch(x, params, cfg, mlp_act=mlp_act,
                                          mesh=mesh)
    if mode in ("train", "prefill"):
        return moe_lib.moe_expert_parallel(x, params, cfg, mlp_act=mlp_act,
                                           use_lsh=use_lsh, mesh=mesh)
    raise ValueError(f"unknown mode {mode!r}")


def apply_placement_update(params: Dict, new_placement: torch.Tensor,
                           old_placement: torch.Tensor, mesh=None,
                           specs: Optional[Dict] = None) -> Dict:
    """A MoE layer's params with logical expert e moved from physical slot
    old_placement[e] to new_placement[e] (padded slots past E keep their
    rows).  The params only: the AdamW moments stay where they were, as
    in the JAX function.  Over a mesh (``specs``: the layer's,
    runtime/params.py) it is a collective: the expert weights are
    gathered, permuted and cut again."""
    if mesh is not None and specs is None:
        raise ValueError("apply_placement_update over a mesh needs the "
                         "layer's specs (params.model_specs)")
    out = dict(params if mesh is None else gather_params(params, mesh,
                                                         specs))
    old = old_placement.to(torch.long)
    new = new_placement.to(device=params["placement"].device,
                           dtype=torch.int32)
    for name in EXPERT_KEYS:
        if name in out:
            w = out[name]
            moved = w.clone()
            moved[new.long().to(w.device)] = w[old.to(w.device)]
            out[name] = moved
    out["placement"] = new
    return out if mesh is None else shard_params(out, mesh, specs)
