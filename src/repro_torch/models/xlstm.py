"""xLSTM mixers (counterpart of ``repro/models/xlstm.py``,
arXiv:2405.04517): the mLSTM (matrix memory, computed chunkwise) and the
sLSTM (scalar memory, a recurrence over time), each with its one-token
decode step and its zero state.

The mLSTM is exponentially gated linear attention.  ``_mlstm_chunk``
computes it a chunk at a time, as models/ssm.py's scan does: within a
chunk two batched products (the gated q k^T v term and the carried (C,
n) state's term) stabilised by a running max ``m``; each chunk's body is
recomputed in the backward pass (``jax.checkpoint(..., nothing_saveable)``
in JAX).  The sLSTM has a hidden-to-hidden recurrence, so it is a Python
loop over the sequence (JAX's ``lax.scan``).  No Pallas kernel stands
behind either in the JAX package: both stay plain PyTorch.

Numerics follow the JAX functions op for op: the gates, the stabiliser
and the states are f32 (``b_if`` and ``b_gates`` are f32 leaves even in a
bf16 model); the stabiliser is not detached, and its maxima are ``amax``
and ``torch.maximum``, which split a gradient evenly between ties as
JAX's ``max`` and ``maximum`` do; ``log_sigmoid`` is JAX's
``-softplus(-x)`` in one kernel; gelu is the tanh approximation
(``jax.nn.gelu``'s default).  The masked (s > t) pair weights are -inf before their exp,
whose value and gradient there are 0, so no NaN reaches the backward.

Over a (data, model) mesh (``mesh=``, ``specs=``: the rank's shards of
the params, runtime/params.py) the mLSTM follows the JAX
``mlstm_apply(mesh)``: u whole over the gathered sequence, the rank's
heads of q, k, v and z (runtime/tp.py's ``tp_in_project``), its heads'
gates from ``w_if`` gathered whole (its ``2 nh`` columns are [i | f], so
the split of the leaf does not fall on the rank's heads), the chunkwise
mLSTM on those heads, the norm over the split d_in (``tp_rmsnorm``) and
``w_down`` through ``tp_project``; where the heads do not split over
``model`` it runs replicated (``tp.replicated``).  The sLSTM has no
heads, and its gates [z | i | f | o] do not align with a split of the
width: it always runs replicated over ``model``, on the whole sequence.

Decode (``mesh=`` with the state's split, runtime/params.decode_layout)
steps the rank's block of JAX's ``decode_state_specs``: the mLSTM by
heads (as models/ssm.mamba_decode does: the rank's columns, the split
norm, ``tp.decode_project``), or on the first head-dimension index of
``C`` and ``n`` (their update is local; ``q C`` and ``q n`` are partial
over that index and summed over ``model`` in rank order); the sLSTM
gathers its state whole, steps it as one card does and keeps the rank's
slice of the width.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.comm import collectives
from repro_torch.models.layers import fanin_init, rmsnorm, rmsnorm_init
from repro_torch.runtime import params as params_lib
from repro_torch.runtime import sharding, tp

NEG_INF = float("-inf")


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid`` = -softplus(-x) = min(x, 0) - log1p(exp(-|x|)),
    the formula ``F.logsigmoid`` computes in one kernel; its backward is
    the derivative sigmoid(-x), which JAX's logaddexp rule gives too (0.5
    at 0, where the composite's clamp would give 1)."""
    return F.logsigmoid(x)


def mlstm_width(d_model: int, head_dim: int, proj_factor: float) -> int:
    """d_in: proj_factor * d_model, cut down to a multiple of head_dim."""
    d_in = int(proj_factor * d_model)
    return d_in - d_in % head_dim


# ----------------------------------------------------------------- mLSTM --

def mlstm_init(gen, d_model: int, head_dim: int, proj_factor: float, dtype,
               device) -> Dict:
    """The JAX leaves and distributions; the numbers are not JAX's (tests
    share params through convert.py)."""
    d_in = mlstm_width(d_model, head_dim, proj_factor)
    nh = d_in // head_dim
    return {
        "w_up": fanin_init(gen, (d_model, d_in), dtype, device),
        "w_z": fanin_init(gen, (d_model, d_in), dtype, device),
        "w_q": fanin_init(gen, (d_in, d_in), dtype, device),
        "w_k": fanin_init(gen, (d_in, d_in), dtype, device),
        "w_v": fanin_init(gen, (d_in, d_in), dtype, device),
        "w_if": fanin_init(gen, (d_in, 2 * nh), dtype, device),
        "b_if": torch.zeros((2 * nh,), dtype=torch.float32, device=device),
        "w_down": fanin_init(gen, (d_in, d_model), dtype, device),
        "norm": rmsnorm_init(d_in, dtype, device),
    }


def _mlstm_body(C, n, m, qb, kb, vb, li, lf, out_dtype):
    """One chunk: (the carried C [B, nh, dh, dh], n [B, nh, dh], m [B,
    nh], f32; the chunk's q / k / v [B, c, nh, dh] and log gates [B, c,
    nh]) -> (C, n, m after the chunk, y [B, c, nh, dh] in out_dtype)."""
    c, dh = qb.shape[1], qb.shape[-1]
    qb, kb, vb = (t.to(torch.float32) for t in (qb, kb, vb))
    Fc = torch.cumsum(lf, dim=1)                             # [B, c, nh]
    # pairwise log weights b[t, s] = F_t - F_s + li_s (s <= t)
    bmat = Fc[:, :, None, :] - Fc[:, None, :, :] + li[:, None, :, :]
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=qb.device))
    bmat = torch.where(mask[None, :, :, None], bmat,
                       torch.full((), NEG_INF, device=qb.device))
    inter_log = Fc + m[:, None, :]                           # [B, c, nh]
    m_t = torch.maximum(bmat.amax(dim=2), inter_log)
    m_t = torch.maximum(m_t, torch.full((), -1e30, device=qb.device))
    w = torch.exp(bmat - m_t[:, :, None, :])                 # [B, t, s, nh]
    inter = torch.exp(inter_log - m_t)                       # [B, c, nh]
    scale = dh ** -0.5
    qk = torch.einsum("bthd,bshd->btsh", qb, kb) * scale
    num = torch.einsum("btsh,bshd->bthd", qk * w, vb) + \
        torch.einsum("bthd,bhde,bth->bthe", qb * scale, C, inter)
    den_vec = torch.einsum("btsh,bshd->bthd", w, kb) + \
        n[:, None, :, :] * inter[..., None]
    den = torch.abs(torch.einsum("bthd,bthd->bth", qb * scale, den_vec))
    y = num / torch.maximum(den, torch.exp(-m_t))[..., None]
    # the chunk-end state
    m_new = torch.maximum(Fc[:, -1, :] + m,
                          (Fc[:, -1:, :] - Fc + li).amax(dim=1))
    carry_scale = torch.exp(Fc[:, -1, :] + m - m_new)        # [B, nh]
    tok_scale = torch.exp(Fc[:, -1:, :] - Fc + li - m_new[:, None, :])
    C_new = C * carry_scale[..., None, None] + torch.einsum(
        "bshd,bshe,bsh->bhde", kb, vb, tok_scale)
    n_new = n * carry_scale[..., None] + torch.einsum(
        "bshd,bsh->bhd", kb, tok_scale)
    return C_new, n_new, m_new, y.to(out_dtype)


def _mlstm_chunk(q, k, v, log_i, log_f, state: Tuple, chunk: int):
    """q / k / v: [B, S, nh, dh]; log_i / log_f: [B, S, nh] f32; state
    (C, n, m) -> (y [B, S, nh, dh] in q's dtype, the state after the
    sequence).  S must be a multiple of the chunk, or shorter.  With
    gradients on, each chunk is recomputed in the backward pass."""
    B, S, nh, dh = q.shape
    c = min(chunk, S)
    if S % c:
        raise ValueError(f"seq {S} must be divisible by chunk {c}")
    C, n, m = state
    remat = torch.is_grad_enabled()
    ys = []
    for i in range(S // c):
        sl = slice(i * c, (i + 1) * c)
        args = (C, n, m, q[:, sl], k[:, sl], v[:, sl], log_i[:, sl],
                log_f[:, sl], q.dtype)
        if remat:
            C, n, m, y = checkpoint(_mlstm_body, *args, use_reentrant=False)
        else:
            C, n, m, y = _mlstm_body(*args)
        ys.append(y)
    return torch.cat(ys, dim=1), (C, n, m)


def _mlstm_gates(params: Dict, u: torch.Tensor, nh: int):
    gf = (u @ params["w_if"]).to(torch.float32) + params["b_if"]
    return gf[..., :nh], log_sigmoid(gf[..., nh:])


def _mlstm_out(params: Dict, y: torch.Tensor, z: torch.Tensor, dtype,
               norm_eps: float) -> torch.Tensor:
    y = rmsnorm(params["norm"], y.to(dtype), norm_eps)
    y = y * F.silu(z.to(torch.float32)).to(dtype)
    return y @ params["w_down"]


def mlstm_apply(params: Dict, x: torch.Tensor, head_dim: int, chunk: int,
                norm_eps: float = 1e-5, mesh=None,
                specs: Optional[Dict] = None) -> torch.Tensor:
    """Full-sequence forward.  x: [B, S, H] -> [B, S, H]; over a mesh,
    the rank's sequence slice [B, S / g, H] -> [B, S / g, H], the params
    the rank's shards of ``specs`` (module docstring)."""
    if mesh is not None:
        return _mlstm_apply_tp(params, x, head_dim, chunk, norm_eps, mesh,
                               specs)
    B, S, _ = x.shape
    d_in = params["w_up"].shape[1]
    nh = d_in // head_dim
    u = x @ params["w_up"]
    z = x @ params["w_z"]
    q, k, v = ((u @ params[w]).reshape(B, S, nh, head_dim)
               for w in ("w_q", "w_k", "w_v"))
    log_i, log_f = _mlstm_gates(params, u, nh)
    state = init_mlstm_state(B, nh, head_dim, x.device)
    y, _ = _mlstm_chunk(q, k, v, log_i, log_f,
                        (state["C"], state["n"], state["m"]), chunk)
    return _mlstm_out(params, y.reshape(B, S, d_in), z, x.dtype, norm_eps)


def _mlstm_apply_tp(params: Dict, x: torch.Tensor, head_dim: int,
                    chunk: int, norm_eps: float, mesh, specs: Dict
                    ) -> torch.Tensor:
    d_in = params["norm"]["scale"].shape[0]
    nh = d_in // head_dim
    g = sharding.axis_size(mesh, "model")
    names = ("w_up", "w_z", "w_q", "w_k", "w_v")
    if nh % g or tp.projects_whole(mesh, [specs[k] for k in names],
                                   (True,) + (False,) * 4):
        return tp.replicated(
            lambda p, xs: mlstm_apply(p, xs, head_dim, chunk, norm_eps),
            params, specs, x, mesh)
    # u whole (each rank's slice times the whole w_up, gathered), z and
    # q / k / v on the rank's columns: its nh / g heads
    u, z = tp.tp_in_project(x, [params["w_up"], params["w_z"]], mesh,
                            [specs["w_up"], specs["w_z"]],
                            replicate=(True, False), whole=False)
    B, S = u.shape[:2]
    nl = nh // g
    q, k, v = ((u @ tp.fsdp_gather(params[w], specs[w], mesh, 0)).reshape(
        B, S, nl, head_dim) for w in ("w_q", "w_k", "w_v"))
    whole = {k: params_lib.gather(params[k], specs[k], mesh, grad=True)
             for k in ("w_if", "b_if")}
    log_i, log_f = _mlstm_gates(whole, u, nh)
    log_i, log_f = (tp.rank_slice(t, mesh) for t in (log_i, log_f))
    state = init_mlstm_state(B, nl, head_dim, x.device)
    y, _ = _mlstm_chunk(q, k, v, log_i, log_f,
                        (state["C"], state["n"], state["m"]), chunk)
    y = tp.tp_rmsnorm(params["norm"], y.reshape(B, S, nl * head_dim).to(
        x.dtype), mesh, norm_eps)
    y = y * F.silu(z.to(torch.float32)).to(x.dtype)
    return tp.tp_project(y, params["w_down"], mesh, specs["w_down"])


def init_mlstm_state(batch: int, nh: int, head_dim: int, device) -> Dict:
    """{"C": [B, nh, dh, dh], "n": [B, nh, dh], "m": [B, nh]}, f32 zeros."""
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, nh, head_dim, head_dim), **f32),
            "n": torch.zeros((batch, nh, head_dim), **f32),
            "m": torch.zeros((batch, nh), **f32)}


def mlstm_decode(params: Dict, x: torch.Tensor, state: Dict, head_dim: int,
                 norm_eps: float = 1e-5, mesh=None, split: str = ""
                 ) -> Tuple[torch.Tensor, Dict]:
    """One step.  x: [B, 1, H] -> ([B, 1, H], the new state, new
    tensors).  ``mesh`` with ``split`` "heads" or "dh": the state is the
    rank's block of it over ``model`` (runtime/params.decode_layout), the
    params are whole and x is the same on every rank of ``model``; the
    result is whole on every rank (module docstring)."""
    B = x.shape[0]
    d_in = params["w_up"].shape[1]
    nh = d_in // head_dim
    heads = mesh is not None and split == "heads"
    on_dh = mesh is not None and split == "dh"
    nl = nh // sharding.axis_size(mesh, "model") if heads else nh
    u = x[:, 0, :] @ params["w_up"]

    def cols(w):                    # the rank's heads' columns of w
        return tp.rank_slice(params[w], mesh) if heads else params[w]
    z = x[:, 0, :] @ cols("w_z")
    q, k, v = ((u @ cols(w)).reshape(B, nl, head_dim).to(torch.float32)
               for w in ("w_q", "w_k", "w_v"))
    log_i, log_f = _mlstm_gates(params, u, nh)
    if heads:
        log_i, log_f = (tp.rank_slice(t, mesh) for t in (log_i, log_f))
    C, n, m = state["C"], state["n"], state["m"]
    m_new = torch.maximum(log_f + m, log_i)
    f_s = torch.exp(log_f + m - m_new)
    i_s = torch.exp(log_i - m_new)
    scale = head_dim ** -0.5
    qs = q * scale
    if on_dh:
        # C and n hold the rank's block of their first dh index
        k, qs = (tp.rank_slice(t, mesh) for t in (k, qs))
    C = C * f_s[..., None, None] + torch.einsum("bhd,bhe,bh->bhde", k, v,
                                                i_s)
    n = n * f_s[..., None] + k * i_s[..., None]
    num = torch.einsum("bhd,bhde->bhe", qs, C)
    den = torch.einsum("bhd,bhd->bh", qs, n)
    if on_dh:
        # partial over the split index: summed over model in rank order
        part = tp.rank_sum(torch.cat([num, den[..., None]], -1), mesh)
        num, den = part[..., :-1], part[..., -1]
    y = num / torch.maximum(torch.abs(den), torch.exp(-m_new))[..., None]
    new = {"C": C, "n": n, "m": m_new}
    if not heads:
        out = _mlstm_out(params, y.reshape(B, d_in), z, x.dtype, norm_eps)
        return out[:, None, :], new
    y = tp.tp_rmsnorm(params["norm"], y.reshape(B, nl * head_dim).to(
        x.dtype), mesh, norm_eps)
    y = y * F.silu(z.to(torch.float32)).to(x.dtype)
    return tp.decode_project(y, params["w_down"], mesh)[:, None, :], new


# ----------------------------------------------------------------- sLSTM --

def slstm_init(gen, d_model: int, proj_factor: float, dtype,
               device) -> Dict:
    d_up = int(proj_factor * d_model)
    return {
        "w_gates": fanin_init(gen, (d_model, 4 * d_model), dtype, device),
        "r_gates": fanin_init(gen, (d_model, 4 * d_model), dtype, device),
        "b_gates": torch.zeros((4 * d_model,), dtype=torch.float32,
                               device=device),
        "w_up": fanin_init(gen, (d_model, 2 * d_up), dtype, device),
        "w_down": fanin_init(gen, (d_up, d_model), dtype, device),
        "norm": rmsnorm_init(d_model, dtype, device),
    }


def _slstm_cell(params: Dict, xt: torch.Tensor, state: Tuple,
                r_gates: torch.Tensor, one: torch.Tensor) -> Tuple:
    """xt: [B, 4H] f32 (W x, computed ahead); state (c, n, h, m), each
    [B, H] f32; r_gates: params["r_gates"] in f32 and ``one`` a scalar 1,
    made once for the whole loop -> the next state."""
    c, n, h, m = state
    g = xt + h @ r_gates + params["b_gates"]
    zi, ii, fi, oi = torch.chunk(g, 4, dim=-1)
    z = torch.tanh(zi)
    o = torch.sigmoid(oi)
    log_f = log_sigmoid(fi)
    f_m = log_f + m
    m_new = torch.maximum(f_m, ii)
    i_s = torch.exp(ii - m_new)
    f_s = torch.exp(f_m - m_new)
    c_new = f_s * c + i_s * z
    n_new = f_s * n + i_s
    # n_new is exactly 1 wherever the input gate sets the stabiliser (the
    # first step, for one): the tie's gradient is split, as JAX's is
    h_new = o * c_new / torch.maximum(n_new, one)
    return c_new, n_new, h_new, m_new


def _slstm_out(params: Dict, y: torch.Tensor, norm_eps: float):
    y = rmsnorm(params["norm"], y, norm_eps)
    u = y @ params["w_up"]
    d_up = u.shape[-1] // 2
    y = F.gelu(u[..., :d_up].to(torch.float32),
               approximate="tanh").to(y.dtype) * u[..., d_up:]
    return y @ params["w_down"]


def slstm_apply(params: Dict, x: torch.Tensor, norm_eps: float = 1e-5,
                mesh=None, specs: Optional[Dict] = None) -> torch.Tensor:
    """The recurrence over the sequence.  x: [B, S, H] -> [B, S, H]; over
    a mesh, replicated over ``model`` on the whole sequence (the rank's
    slice in and out, the params the rank's shards of ``specs``)."""
    if mesh is not None:
        return tp.replicated(lambda p, xs: slstm_apply(p, xs, norm_eps),
                             params, specs, x, mesh)
    B, S, H = x.shape
    xw = (x @ params["w_gates"]).to(torch.float32)            # [B, S, 4H]
    st = tuple(init_slstm_state(B, H, x.device).values())
    r_gates, one = _loop_constants(params, x.device)
    hs = []
    for t in range(S):
        st = _slstm_cell(params, xw[:, t], st, r_gates, one)
        hs.append(st[2])
    y = torch.stack(hs, dim=1).to(x.dtype)
    return _slstm_out(params, y, norm_eps)


def _loop_constants(params: Dict, device):
    """The recurrence's f32 r_gates (its gradient then sums the steps' in
    f32 and rounds once) and the normaliser's floor 1, made once."""
    return (params["r_gates"].to(torch.float32),
            torch.ones((), dtype=torch.float32, device=device))


def init_slstm_state(batch: int, d_model: int, device) -> Dict:
    """{"c", "n", "h", "m"}: [B, H] f32 zeros each."""
    return {k: torch.zeros((batch, d_model), dtype=torch.float32,
                           device=device) for k in ("c", "n", "h", "m")}


def slstm_decode(params: Dict, x: torch.Tensor, state: Dict,
                 norm_eps: float = 1e-5, mesh=None
                 ) -> Tuple[torch.Tensor, Dict]:
    """One step.  x: [B, 1, H] -> ([B, 1, H], the new state).  ``mesh``:
    the state is the rank's slice of the width [B, H / g] over ``model``;
    it is gathered whole, stepped as on one card, and the rank's slice
    of the new state returned (the output is whole)."""
    keys = ("c", "n", "h", "m")
    st = tuple(state[k] for k in keys)
    if mesh is not None:
        got = collectives.raw_all_gather(torch.stack(st).contiguous(),
                                         mesh.tp_group(), 2)
        st = tuple(got.unbind(0))
    xw = (x[:, 0, :] @ params["w_gates"]).to(torch.float32)
    st = _slstm_cell(params, xw, st, *_loop_constants(params, x.device))
    y = st[2].to(x.dtype)[:, None, :]
    if mesh is not None:
        st = tuple(tp.rank_slice(t, mesh) for t in st)
    return _slstm_out(params, y, norm_eps), dict(zip(keys, st))
