"""Model assembly for decoding (counterpart of ``init_params``,
``init_decode_state`` and ``decode_step`` in ``repro/models/model.py``).

The JAX package stacks block params per layout entry, [num_super_blocks,
...], and scans over super-blocks with the layout unrolled inside.  The
port keeps one param dict per layer in ``params["layers"]``, in the same
order: super-block major, layout entries interleaved inside, so layer
``sb * len(layout) + i`` is layout entry ``i`` of super-block ``sb``
(convert.py keeps that order).

Supported: attention mixers with MoE, dense or no FFN, RoPE or no position
embedding.  Other mixers, learned positions and encoder-decoder raise.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ATTN, DENSE, MOE, NONE, ModelConfig
from repro_torch.core.lsh_moe import lsh_moe_apply, lsh_moe_init
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import (embed, embedding_init, fanin_init,
                                       mlp_apply, mlp_init, rmsnorm,
                                       rmsnorm_init, unembed)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {name!r}; known: {sorted(_DTYPES)}")
    return _DTYPES[name]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what the port does not run yet."""
    for mixer, ffn in cfg.layout:
        if mixer != ATTN:
            raise NotImplementedError(
                f"mixer {mixer!r} is not ported (ROADMAP Queue 1 item 7)")
        if ffn not in (DENSE, MOE, NONE):
            raise ValueError(f"unknown ffn kind {ffn!r}")
    if cfg.encoder_decoder:
        raise NotImplementedError(
            "encoder-decoder models are not ported (ROADMAP Queue 1 item 7)")
    if cfg.pos_emb not in ("rope", "none"):
        raise NotImplementedError(
            f"pos_emb={cfg.pos_emb!r} is not ported (ROADMAP Queue 1 item 7)")


def layer_kinds(cfg: ModelConfig) -> List[Tuple[str, str]]:
    """(mixer, ffn) of every layer, in params["layers"] order."""
    return list(cfg.layout) * cfg.num_super_blocks


def _layer_init(gen, cfg: ModelConfig, ffn: str, dtype, device) -> Dict:
    h = cfg.d_model
    p: Dict = {"norm1": rmsnorm_init(h, dtype, device),
               "mixer": attn_lib.attention_init(
                   gen, h, cfg.num_heads, cfg.num_kv_heads,
                   cfg.resolved_head_dim, dtype, device)}
    if ffn == DENSE:
        p["norm2"] = rmsnorm_init(h, dtype, device)
        p["ffn"] = mlp_init(gen, h, cfg.d_ff, cfg.mlp_act, dtype, device)
    elif ffn == MOE:
        p["norm2"] = rmsnorm_init(h, dtype, device)
        p["ffn"] = lsh_moe_init(gen, h, cfg.moe, mlp_act=cfg.mlp_act,
                                dtype=dtype, device=device)
    return p


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device: DeviceLike = None) -> Dict:
    """Random params from a ``torch.Generator`` seeded with ``seed``, made
    on ``device`` (the CUDA device unless "cpu" is asked for).  The
    distributions are the JAX package's; the numbers are not (the tests
    share params through convert.params_from_jax)."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params: Dict = {
        "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model, dtype, dev),
        "final_norm": rmsnorm_init(cfg.d_model, dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = {"w": fanin_init(gen, (cfg.d_model, cfg.vocab_size),
                                          dtype, dev)}
    params["layers"] = [_layer_init(gen, cfg, ffn, dtype, dev)
                        for _, ffn in layer_kinds(cfg)]
    return params


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, *,
                      device: DeviceLike = None) -> Dict:
    """One KV cache per layer, and the decode position."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    caches = [attn_lib.init_kv_cache(batch, max_len, cfg.num_kv_heads,
                                     cfg.resolved_head_dim, dtype, dev)
              for _ in layer_kinds(cfg)]
    return {"layers": caches, "position": 0}


@torch.no_grad()
def decode_step(params: Dict, cfg: ModelConfig, state: Dict,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """One decode step.  tokens: [B, 1] -> (logits [B, 1, V] f32, state).
    The KV caches in ``state`` are updated in place; the returned state
    holds the same caches and the next position."""
    pos = int(state["position"])
    x = embed(params["embed"], tokens)
    dh = cfg.resolved_head_dim
    for (_, ffn), p, cache in zip(layer_kinds(cfg), params["layers"],
                                  state["layers"]):
        h = rmsnorm(p["norm1"], x, cfg.norm_eps)
        y, _ = attn_lib.decode_attention(
            p["mixer"], h, cache, pos, num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, head_dim=dh,
            rope_theta=cfg.rope_theta, use_rope=(cfg.pos_emb == "rope"))
        x = x + y
        if ffn == DENSE:
            x = x + mlp_apply(p["ffn"], rmsnorm(p["norm2"], x, cfg.norm_eps),
                              cfg.mlp_act)
        elif ffn == MOE:
            x = x + lsh_moe_apply(p["ffn"], rmsnorm(p["norm2"], x,
                                                    cfg.norm_eps),
                                  cfg.moe, mlp_act=cfg.mlp_act,
                                  mode="decode")
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = unembed(params["embed"], x)
    else:
        logits = (x @ params["head"]["w"]).to(torch.float32)
    return logits, {"layers": state["layers"], "position": pos + 1}
