"""Primitive layers: norms, rotary embeddings, MLPs, initializers
(counterpart of ``repro/models/layers.py``).

Plain functions on explicit param dicts, like the JAX package's.  Compute
runs in the param dtype with f32 where the JAX package uses it (norms, RoPE,
the swiglu activation), rounding at the same places.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.comm import collectives
from repro_torch.runtime import sharding


def normal_init(gen: torch.Generator, shape, dtype, device,
                scale: float = 0.02) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device) * scale).to(dtype)


def fanin_init(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    """Normal with scale 1/sqrt(shape[0]), as the JAX package's (for a
    stacked [E, H, F] expert weight that is 1/sqrt(E))."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    return normal_init(gen, shape, dtype, device,
                       scale=1.0 / math.sqrt(max(1, fan_in)))


# ---------------------------------------------------------------- RMSNorm --

def rmsnorm_init(d: int, dtype, device) -> Dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params: Dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Computed in f32 and cast back to x's dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32)).to(x.dtype)


# ------------------------------------------------------------------ RoPE --

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, n, dh]; positions: [..., S] int.  Rotates the two HALVES
    of the head dim (not interleaved pairs), in f32."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, device=x.device)           # [dh/2]
    ang = positions[..., None].to(torch.float32) * freqs     # [..., S, dh/2]
    cos = torch.cos(ang)[..., None, :]                   # [..., S, 1, dh/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------- sinusoidal positions --

# The decode step's table length: it adds row ``position % DECODE_TABLE``.
DECODE_TABLE = 8192


def sinusoidal(seq: int, d: int, device=None) -> torch.Tensor:
    """The JAX package's ``_sinusoidal``: f32 [seq, d], sin at the even
    columns and cos at the odd ones (interleaved, not RoPE's halves), of
    pos / 10000 ** (2i / d), computed in f32 as there."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, dim / d)
    out = torch.zeros((seq, d), dtype=torch.float32, device=device)
    out[:, 0::2] = torch.sin(ang)
    out[:, 1::2] = torch.cos(ang)
    return out


_SINUSOID_TABLES: Dict = {}


def sinusoid_rows(start: int, n: int, d: int, device) -> torch.Tensor:
    """Rows [start, start + n) of the sinusoid table, f32 [n, d].  One
    table per (width, device) is kept and grown when a longer one is asked
    for (a row does not depend on the table's length), so a decode step
    reads its row without building the table again."""
    key = (d, str(torch.device(device)))
    table = _SINUSOID_TABLES.get(key)
    if table is None or table.shape[0] < start + n:
        rows = max(start + n, DECODE_TABLE)
        table = _SINUSOID_TABLES[key] = sinusoidal(rows, d, device)
    return table[start:start + n]


def clear_sinusoid_tables() -> None:
    """Forget the kept tables, so that each cell of the dry run counts a
    table's build, as a fresh process does."""
    _SINUSOID_TABLES.clear()


# ------------------------------------------------------------------ MLPs --

def activation(h: torch.Tensor, g: torch.Tensor, act: str) -> torch.Tensor:
    """swiglu: silu(g) in f32, cast to h's dtype, times h; relu2; gelu
    (tanh approximation, jax.nn.gelu's default)."""
    if act == "swiglu":
        return F.silu(g.to(torch.float32)).to(h.dtype) * h
    if act == "relu2":
        return torch.square(torch.relu(h))
    if act == "gelu":
        return F.gelu(h, approximate="tanh")
    raise ValueError(f"unknown act {act}")


def mlp_init(gen, d_model: int, d_ff: int, act: str, dtype, device) -> Dict:
    p = {"w_up": fanin_init(gen, (d_model, d_ff), dtype, device),
         "w_down": fanin_init(gen, (d_ff, d_model), dtype, device)}
    if act == "swiglu":
        p["w_gate"] = fanin_init(gen, (d_model, d_ff), dtype, device)
    return p


def mlp_apply(params: Dict, x: torch.Tensor, act: str) -> torch.Tensor:
    h = x @ params["w_up"]
    g = x @ params["w_gate"] if act == "swiglu" else None
    return activation(h, g, act) @ params["w_down"]


def expert_mlp_init(gen, num_experts: int, d_model: int, d_ff: int, act: str,
                    dtype, device) -> Dict:
    """Stacked expert FFNs: leading dim = experts."""
    p = {"w_up": fanin_init(gen, (num_experts, d_model, d_ff), dtype, device),
         "w_down": fanin_init(gen, (num_experts, d_ff, d_model), dtype,
                              device)}
    if act == "swiglu":
        p["w_gate"] = fanin_init(gen, (num_experts, d_model, d_ff), dtype,
                                 device)
    return p


# ------------------------------------------------------------- Embedding --

def embedding_init(gen, vocab: int, d_model: int, dtype, device) -> Dict:
    return {"table": normal_init(gen, (vocab, d_model), dtype, device,
                                 scale=0.02)}


def embed(params: Dict, tokens: torch.Tensor, mesh=None,
          spec=None) -> torch.Tensor:
    """The rows of ``tokens``.  Over a mesh whose ``model`` axis of g
    ranks splits the table (its ``spec``, runtime/params.py: rank m holds
    rows [m V / g, (m + 1) V / g) of the vocabulary V), tokens [B, L] is
    the rank's slice of the model group's sequence: each rank looks up
    its own rows for the tokens of the whole group (a token outside
    them, or a negative one, counts zero) and a reduce-scatter returns
    the sums to the rank's slice, [B, L, H] (the ``tp_project`` pattern;
    backward: the all-gather of the cotangents, so the rank's rows get
    the whole sequence's gradient)."""
    table = params["table"]
    if spec is None or "model" not in spec[0] \
            or sharding.axis_size(mesh, "model") == 1:
        return table[tokens]
    group = mesh.tp_group()
    n = table.shape[0]
    ids = collectives.raw_all_gather(tokens.contiguous(), group, 1) \
        - sharding.axis_index(mesh, "model") * n
    mine = (ids >= 0) & (ids < n)
    rows = torch.where(mine[..., None], table[ids.clamp(0, n - 1)],
                       torch.zeros((), dtype=table.dtype,
                                   device=table.device))
    return collectives.ReduceScatter.apply(rows, group, 1)


def unembed(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """Tied head: logits in f32 from a product in x's dtype."""
    return (x @ params["table"].T.to(x.dtype)).to(torch.float32)
