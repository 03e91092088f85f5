"""GQA attention, single-token decode against a KV cache (counterpart of
the decode half of ``repro/models/attention.py``; the chunked training /
prefill attention comes with the training slice)."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models.layers import apply_rope, fanin_init

NEG_INF = -1e30


def attention_init(gen, d_model: int, num_heads: int, num_kv_heads: int,
                   head_dim: int, dtype, device) -> Dict:
    return {
        "wq": fanin_init(gen, (d_model, num_heads * head_dim), dtype, device),
        "wk": fanin_init(gen, (d_model, num_kv_heads * head_dim), dtype,
                         device),
        "wv": fanin_init(gen, (d_model, num_kv_heads * head_dim), dtype,
                         device),
        "wo": fanin_init(gen, (num_heads * head_dim, d_model), dtype, device),
    }


def init_kv_cache(batch: int, max_len: int, num_kv_heads: int, head_dim: int,
                  dtype, device) -> Dict:
    shape = (batch, max_len, num_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attention(params: Dict, x: torch.Tensor, cache: Dict,
                     position: int, *, num_heads: int, num_kv_heads: int,
                     head_dim: int, rope_theta: float, use_rope: bool = True
                     ) -> Tuple[torch.Tensor, Dict]:
    """One-token decode.  x: [B, 1, H]; cache {"k", "v"}: [B, max_len, nkv,
    dh]; position: the current index.  Returns (out [B, 1, H], cache).

    Unlike the JAX function, which returns a new cache, this one writes the
    new key and value into ``cache`` IN PLACE and returns the same dict.
    The softmax is the JAX package's: f32 scores over the whole cache, with
    positions above ``position`` masked to NEG_INF."""
    B = x.shape[0]
    S = cache["k"].shape[1]
    if not 0 <= position < S:
        raise IndexError(f"position {position} outside the cache [0, {S})")
    q = (x @ params["wq"]).reshape(B, 1, num_heads, head_dim)
    kx = (x @ params["wk"]).reshape(B, 1, num_kv_heads, head_dim)
    vx = (x @ params["wv"]).reshape(B, 1, num_kv_heads, head_dim)
    if use_rope:
        pos = torch.full((B, 1), position, dtype=torch.int32, device=x.device)
        q = apply_rope(q, pos, rope_theta)
        kx = apply_rope(kx, pos, rope_theta)
    cache["k"][:, position] = kx[:, 0].to(cache["k"].dtype)
    cache["v"][:, position] = vx[:, 0].to(cache["v"].dtype)
    k, v = cache["k"], cache["v"]
    g = num_heads // num_kv_heads
    qg = q.reshape(B, num_kv_heads, g, head_dim).to(torch.float32) \
        * head_dim ** -0.5
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.to(torch.float32))
    future = torch.arange(S, device=x.device) > position
    s = s.masked_fill(future[None, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v.to(torch.float32))
    out = out.reshape(B, 1, num_heads * head_dim).to(x.dtype)
    return out @ params["wo"], cache
