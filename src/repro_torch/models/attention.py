"""GQA attention (counterpart of ``repro/models/attention.py``): the
chunked, exact online-softmax training / prefill path, and single-token
decode against a KV cache, whole or the rank's block of it
(``CacheSplit``: a sequence split combined from the ranks' partial
softmax, or kv heads / head dimension over ``model``); both also as
cross-attention over encoder states (whisper).  Plain torch, with the
JAX package's f32 softmax; no SDPA, so that the two packages stay like
for like.

Over a mesh the residual stream is sharded by sequence over ``model``
and the weights are the rank's shards, with their specs
(runtime/params.py): as in JAX,
``tp_in_project`` (runtime/tp.py) gathers the sequence and projects the
rank's heads of q, k and v over all of it (K and V whole, on every rank,
where the kv heads are fewer than the model ranks), and ``tp_project``
reduce-scatters the output projection back to the rank's sequence slice;
attention itself runs over the whole sequence on the rank's heads, whose
kv chunks are then the one-device ones.  Query (or kv) heads that do not
split over ``model`` take runtime/tp.py's replicated fallback: every head
on every rank, and the output projection sliced back to the rank's
sequence."""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.comm import collectives
from repro_torch.models.layers import apply_rope, fanin_init
from repro_torch.runtime import sharding, tp

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


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, kv_chunk: int,
                      q_offset: int = 0) -> torch.Tensor:
    """Exact flash-style attention: a loop over KV chunks with an online
    softmax in f32.  q: [B, Sq, nh, dh], k / v: [B, Sk, nkv, dh] ->
    [B, Sq, nh, dh] in q's dtype.  KV heads are expanded with
    ``repeat_interleave`` (``jnp.repeat``)."""
    B, Sq, nh, dh = q.shape
    Sk, nkv = k.shape[1], k.shape[2]
    g = nh // nkv
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    kv_chunk = min(kv_chunk, Sk)
    n_chunks = math.ceil(Sk / kv_chunk)
    qf = q.to(torch.float32) * dh ** -0.5
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    m = torch.full((B, Sq, nh), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Sq, nh), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Sq, nh, dh), dtype=torch.float32, device=q.device)
    for c in range(n_chunks):
        kb = k[:, c * kv_chunk:(c + 1) * kv_chunk].to(torch.float32)
        vb = v[:, c * kv_chunk:(c + 1) * kv_chunk].to(torch.float32)
        kv_pos = c * kv_chunk + torch.arange(kb.shape[1], device=q.device)
        s = torch.einsum("bqhd,bchd->bqhc", qf, kb)
        if causal:
            mask = kv_pos[None, :] <= q_pos[:, None]
            s = torch.where(mask[None, :, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqhc,bchd->bqhd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


def attention_apply(params: Dict, x: torch.Tensor, *, num_heads: int,
                    num_kv_heads: int, head_dim: int, rope_theta: float,
                    causal: bool = True, kv_chunk: int = 1024,
                    pos_offset: int = 0, use_rope: bool = True,
                    kv_x: Optional[torch.Tensor] = None,
                    mesh=None, specs: Optional[Dict] = None
                    ) -> torch.Tensor:
    """Full-sequence attention (training / prefill).  x: [B, S, H]; with a
    mesh, this rank's sequence slice, its queries at their global
    positions, and the params the rank's shards of ``specs``: the result
    is the rank's slice of the output (module docstring).  ``kv_x``
    [B, S_kv, H] makes it cross-attention: the keys and values come from
    it (encoder states, of another length than x), without RoPE (the
    caller passes causal=False, as the JAX package's does)."""
    B, S, H = x.shape
    src = x if kv_x is None else kv_x
    if mesh is None:
        q = x @ params["wq"]
        k = src @ params["wk"]
        v = src @ params["wv"]
        nh, nkv = num_heads, num_kv_heads
    else:
        g = sharding.axis_size(mesh, "model")
        sq, sk, sv = specs["wq"], specs["wk"], specs["wv"]
        # kv heads fewer than the model ranks: K and V whole on every rank
        rep = num_kv_heads < g
        # heads that do not split: every head on every rank (runtime/tp.py)
        whole = bool(num_heads % g or not rep and num_kv_heads % g) \
            or tp.projects_whole(mesh, (sq, sk, sv), (False, rep, rep))
        if kv_x is None:
            q, k, v = tp.tp_in_project(
                x, (params["wq"], params["wk"], params["wv"]), mesh,
                (sq, sk, sv), replicate=(False, rep, rep), whole=whole)
        else:
            (q,) = tp.tp_in_project(x, (params["wq"],), mesh, (sq,),
                                    whole=whole)
            k, v = tp.tp_in_project(src, (params["wk"], params["wv"]), mesh,
                                    (sk, sv), replicate=(rep, rep),
                                    whole=whole)
        S, nh = q.shape[1], num_heads // g
        if whole:
            nh, nkv = num_heads, num_kv_heads
        elif rep:
            # each rank's query heads read their kv heads of the whole K / V
            m, grp = sharding.axis_index(mesh, "model"), \
                num_heads // num_kv_heads
            heads = torch.arange(m * nh, (m + 1) * nh, device=x.device) // grp
            k = k.reshape(B, -1, num_kv_heads, head_dim)[:, :, heads]
            v = v.reshape(B, -1, num_kv_heads, head_dim)[:, :, heads]
            nkv = nh
        else:
            nkv = num_kv_heads // g
    S_kv = k.shape[1]
    q = q.reshape(B, S, nh, head_dim)
    k = k.reshape(B, S_kv, nkv, head_dim)
    v = v.reshape(B, S_kv, nkv, head_dim)
    if use_rope and kv_x is None:
        pos = pos_offset + torch.arange(S, device=x.device)[None, :]
        q = apply_rope(q, pos, rope_theta)
        k = apply_rope(k, pos, rope_theta)
    out = chunked_attention(q, k, v, causal=causal, kv_chunk=kv_chunk,
                            q_offset=pos_offset)
    out = out.reshape(B, S, nh * head_dim)
    if mesh is None:
        return out @ params["wo"]
    return tp.tp_project(out, params["wo"], mesh, specs["wo"])


def init_kv_cache(batch: int, max_len: int, num_kv_heads: int, head_dim: int,
                  dtype, device) -> Dict:
    shape = (batch, max_len, num_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


class CacheSplit(NamedTuple):
    """Where a rank's KV cache lies in the whole one
    (runtime/params.decode_layout): ``blocks`` sequence blocks, the
    rank's starting at global row ``offset``, over ``group`` (rank r of
    it holds block r; None for one block); and where ``model`` splits
    the kv heads (``feature`` "heads") or the head dimension ("dh")
    instead, its ``parts`` ranks, the rank's ``index`` and ``fgroup``."""
    blocks: int = 1
    offset: int = 0
    group: Any = None
    feature: str = ""
    parts: int = 1
    index: int = 0
    fgroup: Any = None


def decode_partial(s: torch.Tensor, v: torch.Tensor):
    """A block's partial softmax: s [B, nkv, g, S] f32 scores (masked
    entries NEG_INF), v [B, S, nkv, dh] -> (m [B, nkv, g], the row max;
    l, the sum of exp(s - m); o [B, nkv, g, dh], the unnormalised
    p @ v), all f32."""
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    return m, p.sum(dim=-1), torch.einsum("bkgs,bskd->bkgd", p,
                                           v.to(torch.float32))


def combine_partials(parts) -> torch.Tensor:
    """The softmax of the whole sequence from its blocks' partials
    ``[(m, l, o), ...]``, summed in block order: M = max m_r,
    L = sum exp(m_r - M) l_r, out = sum exp(m_r - M) o_r / L.  A block
    wholly in the future (m = NEG_INF) weighs exp(NEG_INF - M) = 0."""
    M = parts[0][0]
    for m, _, _ in parts[1:]:
        M = torch.maximum(M, m)
    L = acc = None
    for m, l, o in parts:
        w = torch.exp(m - M)
        L = w * l if L is None else L + w * l
        acc = w[..., None] * o if acc is None else acc + w[..., None] * o
    return acc / L[..., None]


def _gather_partials(m, l, o, group, n: int):
    """Every rank's (m, l, o) of ``group`` in rank order: one all-gather
    of the three packed along the last dimension."""
    pack = torch.cat([o, m[..., None], l[..., None]], dim=-1)
    got = collectives.raw_all_gather(pack[None].contiguous(), group, 0)
    return [(got[r, ..., -2], got[r, ..., -1], got[r, ..., :-2])
            for r in range(n)]


def decode_attention(params: Dict, x: torch.Tensor, cache: Dict,
                     position: int, *, num_heads: int, num_kv_heads: int,
                     head_dim: int, rope_theta: float, use_rope: bool = True,
                     cross: bool = False, split: Optional[CacheSplit] = None
                     ) -> Tuple[torch.Tensor, Dict]:
    """One-token decode.  x: [B, 1, H]; cache {"k", "v"}: [B, max_len, nkv,
    dh]; position: the current index.  Returns (out [B, 1, H], cache).

    Unlike the JAX function, which returns a new cache, this one writes the
    new key and value into ``cache`` IN PLACE and returns the same dict.
    The softmax is the JAX package's: f32 scores over the whole cache, with
    positions above ``position`` masked to NEG_INF.  ``cross``: attention
    over a cache of encoder keys and values, as the JAX function's: nothing
    is written, nothing masked, the softmax runs over the whole cache.

    ``split`` (a ``CacheSplit``): the cache is this rank's block of the
    whole one, as JAX's ``decode_state_specs`` lays it out.  Every rank
    computes q, k and v of all heads of the new token (the weights are
    whole); the new key and value are written on the rank whose block
    holds ``position`` only, at ``position - offset``.  Over a sequence
    split each rank's scores cover its block, masked by the global index
    ``offset + j > position``, and give a partial softmax
    (``decode_partial``); the ranks' partials are all-gathered and
    combined in rank order (``combine_partials``): no all-reduce, so the
    bits repeat.  Where ``model`` splits the kv heads instead, each rank
    attends with its heads and the outputs are gathered; where it splits
    the head dimension, the partial scores are gathered and summed in
    rank order, and the outputs gathered.  One sequence block and no
    feature split is the whole-cache function, bit for bit."""
    split = split or CacheSplit()
    B = x.shape[0]
    S = cache["k"].shape[1]
    qg, kx, vx = _decode_qkv(params, x, position, num_heads, num_kv_heads,
                             head_dim, rope_theta, use_rope, cross)
    if not cross:
        if not 0 <= position < S * split.blocks:
            raise IndexError(f"position {position} outside the cache "
                             f"[0, {S * split.blocks})")
        row = position - split.offset
        if 0 <= row < S:
            dim = {"heads": 2, "dh": 3}.get(split.feature)
            if dim is not None:
                kx, vx = (t.narrow(dim, split.index * cache["k"].shape[dim],
                                   cache["k"].shape[dim]) for t in (kx, vx))
            cache["k"][:, row] = kx[:, 0].to(cache["k"].dtype)
            cache["v"][:, row] = vx[:, 0].to(cache["v"].dtype)
    k, v = cache["k"], cache["v"]
    if split.feature == "heads":
        qg = qg.narrow(1, split.index * k.shape[2], k.shape[2])
    elif split.feature == "dh":
        qg = qg.narrow(3, split.index * k.shape[3], k.shape[3])
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.to(torch.float32))
    if split.feature == "dh":
        got = collectives.raw_all_gather(s[None].contiguous(), split.fgroup,
                                         0)
        s = got[0]
        for r in range(1, split.parts):
            s = s + got[r]
    if not cross:
        s = _mask_future(s, split.offset, position)
    if split.blocks == 1:
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bkgs,bskd->bkgd", p, v.to(torch.float32))
    else:
        out = combine_partials(_gather_partials(
            *decode_partial(s, v), split.group, split.blocks))
    if split.feature:
        out = collectives.raw_all_gather(
            out.contiguous(), split.fgroup, 1 if split.feature == "heads"
            else 3)
    out = out.reshape(B, 1, num_heads * head_dim).to(x.dtype)
    return out @ params["wo"], cache


def _decode_qkv(params, x, position, num_heads, num_kv_heads, head_dim,
                rope_theta, use_rope, cross):
    """The new token's queries, grouped by kv head, f32 and scaled
    ([B, nkv, g, dh]), and its key and value [B, 1, nkv, dh] (None for
    cross-attention), RoPE'd at ``position``."""
    B = x.shape[0]
    q = (x @ params["wq"]).reshape(B, 1, num_heads, head_dim)
    kx = vx = None
    if not cross:
        kx = (x @ params["wk"]).reshape(B, 1, num_kv_heads, head_dim)
        vx = (x @ params["wv"]).reshape(B, 1, num_kv_heads, head_dim)
        if use_rope:
            pos = torch.full((B, 1), position, dtype=torch.int32,
                             device=x.device)
            q = apply_rope(q, pos, rope_theta)
            kx = apply_rope(kx, pos, rope_theta)
    qg = q.reshape(B, num_kv_heads, num_heads // num_kv_heads,
                   head_dim).to(torch.float32) * head_dim ** -0.5
    return qg, kx, vx


def _mask_future(s: torch.Tensor, offset: int, position: int):
    """Scores of cache rows whose global index ``offset + j`` lies past
    ``position`` set to NEG_INF."""
    future = torch.arange(offset, offset + s.shape[-1],
                          device=s.device) > position
    return s.masked_fill(future[None, None, None, :], NEG_INF)


def split_decode_attention(params: Dict, x: torch.Tensor, cache: Dict,
                           position: int, blocks: int, *, num_heads: int,
                           num_kv_heads: int, head_dim: int,
                           rope_theta: float, use_rope: bool = True,
                           cross: bool = False) -> Tuple[torch.Tensor, Dict]:
    """``decode_attention`` over a sequence split into ``blocks``,
    emulated in one process on the whole ``cache``: each block's partial
    softmax from a contiguous copy of its rows (as a rank holds them),
    combined in block order, as the ranks of a split compute it, bit for
    bit.  One block is ``decode_attention`` itself."""
    if blocks == 1:
        return decode_attention(
            params, x, cache, position, num_heads=num_heads,
            num_kv_heads=num_kv_heads, head_dim=head_dim,
            rope_theta=rope_theta, use_rope=use_rope, cross=cross)
    B, S = x.shape[0], cache["k"].shape[1]
    n = S // blocks
    qg, kx, vx = _decode_qkv(params, x, position, num_heads, num_kv_heads,
                             head_dim, rope_theta, use_rope, cross)
    if not cross:
        if not 0 <= position < S:
            raise IndexError(f"position {position} outside the cache "
                             f"[0, {S})")
        cache["k"][:, position] = kx[:, 0].to(cache["k"].dtype)
        cache["v"][:, position] = vx[:, 0].to(cache["v"].dtype)
    parts = []
    for r in range(blocks):
        k, v = (cache[c][:, r * n:(r + 1) * n].contiguous()
                for c in ("k", "v"))
        s = torch.einsum("bkgd,bskd->bkgs", qg, k.to(torch.float32))
        if not cross:
            s = _mask_future(s, r * n, position)
        parts.append(decode_partial(s, v))
    out = combine_partials(parts)
    out = out.reshape(B, 1, num_heads * head_dim).to(x.dtype)
    return out @ params["wo"], cache
