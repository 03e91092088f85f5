"""Mamba-2 mixer in the SSD chunked formulation (counterpart of
``repro/models/ssm.py``): ``mamba_init``, the full-sequence forward
(``mamba_apply``, training and prefill) and the one-token recurrence
(``init_mamba_state``, ``mamba_decode``).

Scalar decay per head, so a chunk of the sequence becomes two batched
products (the intra-chunk quadratic term and the carried state) with a
loop over the S / chunk chunks.  No Pallas kernel stands behind it in the
JAX package, so its products, cumsum and exp stay plain PyTorch.

Numerics follow the JAX function op for op: ``dt_bias``, ``a_log`` and
``d_skip`` are f32 leaves even in a bf16 model; the depthwise conv is W
unrolled multiply-adds in the input's dtype (no call that accumulates in
f32); ``dt``, ``B``, ``C`` and the scan's state are f32; each chunk's
output is cast to the input's dtype; silu runs in f32 and is cast back.
Decode computes its conv as an f32 product over the [B, W, d_inner]
buffer, a different rounding from the training path's conv, as in JAX.

On a mesh ``mamba_apply`` splits the heads over the ``model`` axis
(runtime/tp.py), as the JAX function does: the residual stream arrives
sharded by sequence, one all-gather gives every rank the whole sequence,
and rank m of g computes heads [m nh / g, (m + 1) nh / g), which the conv
and the scan need whole along the sequence.  Its params are its shards
(runtime/params.py): those heads' columns of ``w_z``, ``w_x`` and
``conv_w``, entries of ``w_dt``, ``dt_bias``, ``a_log`` and ``d_skip``
and rows of ``w_out``, each matrix also cut over ``data`` (FSDP) and
gathered inside the projection.  ``w_b`` and ``w_c`` are shared by every
head: each rank projects its own tokens and all-gathers the result, so
that their gradient is counted once.  The
norm over d_inner sums each rank's mean of squares across the ranks
(``tp.tp_rmsnorm``); ``w_out``'s partial products are reduce-scattered
back to the sequence slices.  Heads that do not split over ``model`` (or
rows over ``data``) take the JAX package's fallback: the layer runs
replicated over ``model`` (``tp.replicated``).  In decode the token is
replicated over ``model`` and the state split by heads:
``mamba_decode(mesh=)`` steps
the rank's heads and sums ``w_out``'s partial products over the ranks
(``tp.decode_project``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import (fanin_init, normal_init, rmsnorm,
                                       rmsnorm_init)
from repro_torch.runtime import sharding, tp


def mamba_init(gen, d_model: int, cfg, dtype, device) -> Dict:
    """The JAX leaves and distributions (``cfg`` an SSMConfig); the
    numbers are not JAX's (tests share params through convert.py)."""
    d_inner = cfg.expand * d_model
    nh = d_inner // cfg.head_dim
    return {
        "w_z": fanin_init(gen, (d_model, d_inner), dtype, device),
        "w_x": fanin_init(gen, (d_model, d_inner), dtype, device),
        "w_b": fanin_init(gen, (d_model, cfg.d_state), dtype, device),
        "w_c": fanin_init(gen, (d_model, cfg.d_state), dtype, device),
        "w_dt": fanin_init(gen, (d_model, nh), dtype, device),
        "dt_bias": torch.zeros((nh,), dtype=torch.float32, device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, nh,
                                          dtype=torch.float32,
                                          device=device)),
        "d_skip": torch.ones((nh,), dtype=torch.float32, device=device),
        "conv_w": normal_init(gen, (cfg.conv_width, d_inner), dtype, device,
                              scale=0.2),
        "w_out": fanin_init(gen, (d_inner, d_model), dtype, device),
        "norm": rmsnorm_init(d_inner, dtype, device),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` = logaddexp(x, 0) as JAX computes it:
    max(x, 0) + log1p(exp(-|x|)), with no threshold."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  x: [B, S, D]; w: [W, D].  W unrolled
    multiply-adds in x's dtype, in the JAX order."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for i in range(W):
        out = out + xp[:, i:i + S, :] * w[i]
    return out


def _chunk_body(h, xb, dtb, lb, Bb, Cb, out_dtype):
    """One chunk: (carried state h [B, nh, dh, N] f32, the chunk's inputs)
    -> (the next state, y [B, c, nh, dh] in ``out_dtype``)."""
    c = xb.shape[1]
    xb = xb.to(torch.float32)
    L = torch.cumsum(lb, dim=1)                               # [B, c, nh]
    # intra-chunk: G[t, s] = (C_t . B_s) exp(L_t - L_s) dt_s for s <= t
    cb = torch.einsum("btn,bsn->bts", Cb, Bb)                 # [B, c, c]
    decay = L[:, :, None, :] - L[:, None, :, :]               # [B, t, s, nh]
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                 device=xb.device))
    # the min keeps the masked (s > t) entries from overflowing: their
    # exp would be inf, and the backward pass would turn it into NaN
    G = torch.where(mask[None, :, :, None],
                    torch.exp(torch.clamp(decay, max=0.0)) * cb[..., None],
                    torch.zeros((), dtype=torch.float32, device=xb.device))
    y = torch.einsum("btsh,bshd->bthd", G * dtb[:, None, :, :], xb)
    # inter-chunk: the carried state's contribution, and the state update
    y = y + torch.einsum("btn,bhdn,bth->bthd", Cb, h, torch.exp(L))
    tail = torch.exp(L[:, -1:, :] - L)                        # [B, c, nh]
    dB = torch.einsum("bsh,bsn->bshn", dtb * tail, Bb)        # [B, c, nh, N]
    h_new = h * torch.exp(L[:, -1, :])[:, :, None, None] + \
        torch.einsum("bshn,bshd->bhdn", dB, xb)
    return h_new, y.to(out_dtype)


def _ssd_chunk_scan(xh: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor,
                    chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.  xh: [B, S, nh, dh]; dt: [B, S, nh] (after
    softplus, f32); Bm, Cm: [B, S, N] f32; a_log: [nh] (A = -exp(a_log))
    -> (y [B, S, nh, dh] in xh's dtype, the final state [B, nh, dh, N]
    f32).  With gradients on, each chunk is recomputed in the backward
    pass (``jax.checkpoint(..., nothing_saveable)`` in JAX): otherwise
    the backward keeps every chunk's [B, c, c, nh] f32 tensors at once."""
    B, S, nh, dh = xh.shape
    N = Bm.shape[-1]
    c = min(chunk, S)
    n_chunks = S // c
    if n_chunks * c != S:
        raise ValueError(f"seq {S} must be divisible by chunk {c}")
    A = -torch.exp(a_log)                                     # [nh] < 0
    l = dt * A[None, None, :]                                 # log decay
    h = torch.zeros((B, nh, dh, N), dtype=torch.float32, device=xh.device)
    remat = torch.is_grad_enabled()
    ys = []
    for n in range(n_chunks):
        sl = slice(n * c, (n + 1) * c)
        args = (h, xh[:, sl], dt[:, sl], l[:, sl], Bm[:, sl], Cm[:, sl],
                xh.dtype)
        if remat:
            h, y = checkpoint(_chunk_body, *args, use_reentrant=False)
        else:
            h, y = _chunk_body(*args)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def mamba_apply(params: Dict, x: torch.Tensor, cfg, norm_eps: float = 1e-5,
                mesh=None, specs=None) -> torch.Tensor:
    """Full-sequence forward (train / prefill).  x: [B, S, H] -> [B, S, H];
    with a mesh, this rank's sequence slice, the heads split over the
    ``model`` axis and the params the rank's shards of ``specs`` (module
    docstring)."""
    B, S, H = x.shape
    d_inner = cfg.expand * H
    nh = d_inner // cfg.head_dim
    if mesh is None:
        z = x @ params["w_z"]
        xr = x @ params["w_x"]
        Bm = x @ params["w_b"]
        Cm = x @ params["w_c"]
        dt = x @ params["w_dt"]
    else:
        # where w_dt's nh columns split over the axis, the d_inner
        # columns of the rank's shards fall on whole heads, and the head
        # vectors and conv_w are the rank's shards too (runtime/params.py);
        # heads that do not split run replicated (the JAX fallback)
        g = sharding.axis_size(mesh, "model")
        names = ("w_z", "w_x", "w_b", "w_c", "w_dt")
        rep = (False, False, True, True, False)
        if tp.projects_whole(mesh, [specs[k] for k in names], rep):
            return tp.replicated(
                lambda p, xs: mamba_apply(p, xs, cfg, norm_eps), params,
                specs, x, mesh)
        z, xr, Bm, Cm, dt = tp.tp_in_project(
            x, [params[k] for k in names], mesh, [specs[k] for k in names],
            replicate=rep, whole=False)
        nh, d_inner, S = nh // g, d_inner // g, S * g
    Bm, Cm = Bm.to(torch.float32), Cm.to(torch.float32)
    dt = softplus(dt.to(torch.float32) + params["dt_bias"])
    xs = _causal_conv(xr, params["conv_w"])
    xs = F.silu(xs.to(torch.float32)).to(x.dtype)
    xh = xs.reshape(B, S, nh, cfg.head_dim)
    y, _ = _ssd_chunk_scan(xh, dt, params["a_log"], Bm, Cm, cfg.chunk_size)
    y = y + params["d_skip"].to(x.dtype)[None, None, :, None] * xh
    y = y.reshape(B, S, d_inner)
    y = y * F.silu(z.to(torch.float32)).to(x.dtype)
    if mesh is None:
        return rmsnorm(params["norm"], y, norm_eps) @ params["w_out"]
    y = tp.tp_rmsnorm(params["norm"], y, mesh, norm_eps)
    return tp.tp_project(y, params["w_out"], mesh, specs["w_out"])


# ------------------------------------------------------------------ decode --

def init_mamba_state(batch: int, d_model: int, cfg, dtype, device) -> Dict:
    """{"h": f32 [B, nh, dh, N], "conv": [B, W - 1, d_inner] in ``dtype``}
    (over a mesh, models/model.init_decode_state allocates the rank's
    block of these by runtime/params.decode_layout)."""
    d_inner = cfg.expand * d_model
    nh = d_inner // cfg.head_dim
    return {
        "h": torch.zeros((batch, nh, cfg.head_dim, cfg.d_state),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, d_inner),
                            dtype=dtype, device=device),
    }


def mamba_decode(params: Dict, x: torch.Tensor, state: Dict, cfg,
                 norm_eps: float = 1e-5, mesh=None
                 ) -> Tuple[torch.Tensor, Dict]:
    """One step of the recurrence.  x: [B, 1, H] -> ([B, 1, H], the new
    state, new tensors).  O(1) in the sequence length.

    ``mesh``: the state holds this rank's heads of ``model`` (``h``
    [B, nh / g, dh, N], ``conv`` [B, W - 1, d_inner / g]; JAX's
    ``decode_state_specs``), and the params are whole.  The rank steps
    its heads only: its columns of ``w_z``, ``w_x``, ``w_dt`` and
    ``conv_w`` and its entries of ``dt_bias``, ``a_log`` and ``d_skip``
    (``w_b`` and ``w_c`` whole), the gated norm over the split d_inner
    (``tp.tp_rmsnorm``), and ``w_out``'s rows of its heads, summed over
    ``model`` (``tp.decode_project``).  x is one token, the same on
    every rank of ``model``."""
    B, _, H = x.shape
    d_inner = cfg.expand * H
    nh = d_inner // cfg.head_dim
    p = params
    if mesh is not None:
        g = sharding.axis_size(mesh, "model")
        p = dict(params)
        for k in ("w_z", "w_x", "w_dt", "conv_w", "dt_bias", "a_log",
                  "d_skip"):
            p[k] = tp.rank_slice(params[k], mesh, -1)
        nh, d_inner = nh // g, d_inner // g
    xt = x[:, 0, :]
    z = xt @ p["w_z"]
    xr = xt @ p["w_x"]                                        # [B, d_inner]
    conv_buf = torch.cat([state["conv"], xr[:, None, :]], dim=1)
    xc = torch.einsum("bwd,wd->bd", conv_buf.to(torch.float32),
                      p["conv_w"].to(torch.float32))
    xs = F.silu(xc)
    Bm = (xt @ p["w_b"]).to(torch.float32)                   # [B, N]
    Cm = (xt @ p["w_c"]).to(torch.float32)
    dt = softplus((xt @ p["w_dt"]).to(torch.float32)
                  + p["dt_bias"])                             # [B, nh]
    a = torch.exp(dt * (-torch.exp(p["a_log"]))[None, :])
    xh = xs.reshape(B, nh, cfg.head_dim)
    h = state["h"] * a[..., None, None] + torch.einsum(
        "bhd,bn,bh->bhdn", xh, Bm, dt)
    y = torch.einsum("bhdn,bn->bhd", h, Cm) + \
        p["d_skip"][None, :, None] * xh
    y = y.reshape(B, d_inner) * F.silu(z.to(torch.float32))
    if mesh is None:
        y = rmsnorm(p["norm"], y.to(x.dtype), norm_eps)
        out = y @ p["w_out"]
    else:
        y = tp.tp_rmsnorm(p["norm"], y.to(x.dtype), mesh, norm_eps)
        out = tp.decode_project(y, p["w_out"], mesh)
    return out[:, None, :], {"h": h, "conv": conv_buf[:, 1:, :]}
