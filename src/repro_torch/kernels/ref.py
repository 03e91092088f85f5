"""Plain PyTorch versions of the kernels (counterpart of
``repro/kernels/ref.py``).  The kernel wrappers run these for tensors on the
CPU; ``chip_smoke.py`` holds each CUDA kernel against them on the card.

All keep the registry's overflow-bin contract: an entry whose id lies
outside its valid range (expert id outside [0, E), position outside
[0, C), slot outside [0, S)) contributes nothing to a scatter or segment
sum and gathers exactly zero.

The wire codec (``po2_scale``, ``encode``, ``wire_quantize_ref`` and the
fused ops) follows ``repro/kernels/wire_quant.py`` and ``ref.py`` op for op
in f32.  The reference runs where subnormal floats flush to zero (a TPU,
and XLA on the CPU), and two of its flushes are emulated: a row whose
absmax is below 2**-126 counts as empty (scale 1, zero payload;
``po2_scale`` tests ``absmax >= TINY`` where the reference tests
``absmax > 0``), and a dequantized value below 2**-126 in magnitude is a
zero of its sign (``wire_dequantize_ref``, which the fused plain versions
go through).  Nothing else flushes.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

TINY = 2.0 ** -126          # the smallest normal f32


def positions_in_expert_ref(expert_ids: torch.Tensor, num_experts: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[F] int32 ids -> (pos [F] int32, counts [E] int32): pos[f] = number
    of earlier entries routed to the same expert (token-major stability),
    counts[e] = uncapped total.  Ids outside [0, E) get pos 0 and are
    counted nowhere.  Cumsum over a one-hot, as the JAX oracle."""
    experts = torch.arange(num_experts, device=expert_ids.device)
    onehot = (expert_ids[:, None] == experts[None, :]).to(torch.int32)
    incl = torch.cumsum(onehot, dim=0, dtype=torch.int32)
    pos = torch.sum(onehot * (incl - 1), dim=1, dtype=torch.int32)
    return pos, onehot.sum(dim=0, dtype=torch.int32)


def _flat_rows(expert_ids: torch.Tensor, pos: torch.Tensor, num_experts: int,
               capacity: int) -> torch.Tensor:
    """Row e*C + c of the flattened [E*C] buffer for in-range entries, and
    the dump row E*C for every other entry."""
    in_range = ((expert_ids >= 0) & (expert_ids < num_experts)
                & (pos >= 0) & (pos < capacity))
    rows = expert_ids.long() * capacity + pos.long()
    return torch.where(in_range, rows, num_experts * capacity)


def dispatch_scatter_ref(expert_ids: torch.Tensor, pos: torch.Tensor,
                         src: torch.Tensor, num_experts: int,
                         capacity: int) -> torch.Tensor:
    """[F] ids, [F] positions, [F, H] tokens -> [E, C, H] f32 buffer with
    buf[e, c] = sum of src[f] over entries with (id, pos) == (e, c)."""
    H = src.shape[1]
    rows = _flat_rows(expert_ids, pos, num_experts, capacity)
    buf = torch.zeros(num_experts * capacity + 1, H, dtype=torch.float32,
                      device=src.device)
    buf.index_add_(0, rows, src.to(torch.float32))
    return buf[:-1].view(num_experts, capacity, H)


def combine_gather_ref(expert_ids: torch.Tensor, pos: torch.Tensor,
                       buf: torch.Tensor, weights: torch.Tensor
                       ) -> torch.Tensor:
    """[F] ids, [F] positions, [E, C, H] buffer, [F] weights -> [F, H] f32
    = weights[f] * buf[id_f, pos_f]; out-of-range entries gather zero."""
    E, C, _ = buf.shape
    in_range = ((expert_ids >= 0) & (expert_ids < E)
                & (pos >= 0) & (pos < C))
    gathered = buf.to(torch.float32)[expert_ids.long().clamp(0, E - 1),
                                     pos.long().clamp(0, C - 1)]
    return gathered * (weights.to(torch.float32)
                       * in_range.to(torch.float32))[:, None]


def lsh_hash_ref(x: torch.Tensor, rotations: torch.Tensor) -> torch.Tensor:
    """x: [T, H]; rotations: [L, H, Dr] -> [T, L] int32 cross-polytope
    vertex ids 2 * argmax|v| + (v[argmax] < 0), v = x . R_l in f32.  Ties
    go to the first index (``torch.argmax`` and ``jnp.argmax`` agree), the
    sign is that element's; an all-zero row gives vertex 0.  On the CPU
    the products are summed in f64 and rounded to f32: MKL sums the
    columns of one product in different orders once it runs 3 or more
    threads, which breaks exact ties between equal or negated columns of
    R; the f64 sums of such columns round to the same f32."""
    acc = torch.float64 if x.device.type == "cpu" else torch.float32
    v = torch.einsum("th,lhd->tld", x.to(acc),
                     rotations.to(acc)).to(torch.float32)
    idx = torch.argmax(torch.abs(v), dim=-1)
    sign = torch.gather(v, -1, idx[..., None])[..., 0] < 0
    return (2 * idx + sign.to(idx.dtype)).to(torch.int32)


def segment_centroid_ref(slots: torch.Tensor, x: torch.Tensor,
                         num_slots: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """slots: [G, C]; x: [G, C, H] -> (centroids [G, S, H] f32, counts
    [G, S] f32): the one-hot contraction of the JAX oracle.  Slots outside
    [0, S) match no one-hot column and count nowhere."""
    s_range = torch.arange(num_slots, device=slots.device)
    onehot = (slots[..., None] == s_range).to(torch.float32)   # [G, C, S]
    counts = onehot.sum(dim=1)
    sums = torch.einsum("gcs,gch->gsh", onehot, x.to(torch.float32))
    return sums / torch.clamp(counts, min=1.0)[..., None], counts


def residual_apply_ref(slots: torch.Tensor, expert_out: torch.Tensor,
                       residual: torch.Tensor = None) -> torch.Tensor:
    """[G, C] ids, [G, S, H] outputs, [G, C, H] residuals (None: zero) ->
    [G, C, H] f32 = expert_out[g, slots] + residual; out-of-range slots
    gather zero."""
    S = expert_out.shape[1]
    in_range = (slots >= 0) & (slots < S)
    idx = slots.long().clamp(0, S - 1)[..., None].expand(
        *slots.shape, expert_out.shape[-1])
    gathered = torch.gather(expert_out.to(torch.float32), 1, idx)
    gathered = gathered * in_range[..., None].to(torch.float32)
    if residual is None:
        return gathered
    return gathered + residual.to(torch.float32)


# ------------------------------------------------------------ wire codec --

def po2_scale(absmax: torch.Tensor, qmax_val: float) -> torch.Tensor:
    """Smallest power of two >= absmax / qmax, by exponent-bit arithmetic
    on the int32 view of the f32 quotient (exact at every power-of-two
    boundary), clipped to [2**-126, 2**126].  A row with absmax below
    TINY (or NaN) is empty: scale 1."""
    v = absmax.to(torch.float32) / qmax_val
    bits = v.view(torch.int32)
    exp = ((bits >> 23) & 0xFF) - 127                  # floor(log2 v)
    frac = ((bits & 0x7FFFFF) != 0).to(torch.int32)
    k = torch.clamp(exp + frac, -126, 126)             # ceil(log2 v)
    scale = ((k + 127) << 23).to(torch.int32).view(torch.float32)
    return torch.where(absmax >= TINY, scale, torch.ones_like(scale))


def encode(y: torch.Tensor, fmt: str) -> torch.Tensor:
    """Scaled f32 values -> payload: int8 rounds half to even and clips to
    +-127; fp8-e4m3 clips to +-448, then rounds to nearest even."""
    if fmt == "int8":
        return torch.clamp(torch.round(y), -127.0, 127.0).to(torch.int8)
    if fmt == "fp8":
        return torch.clamp(y, -448.0, 448.0).to(torch.float8_e4m3fn)
    raise ValueError(f"unknown quantized wire format {fmt!r}")


def wire_quantize_ref(x: torch.Tensor, fmt: str
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [G, S, H] -> (q [G, S, H] int8 | float8_e4m3fn, scales [G, S]
    f32): one power-of-two absmax scale per row; empty rows get scale 1
    and a zero payload."""
    xf = x.to(torch.float32)
    qmax_val = 127.0 if fmt == "int8" else 448.0
    scales = po2_scale(torch.amax(torch.abs(xf), dim=-1), qmax_val)
    return encode(xf / scales[..., None], fmt), scales


def wire_dequantize_ref(q: torch.Tensor, scales: torch.Tensor
                        ) -> torch.Tensor:
    """(q [G, S, H], scales [G, S]) -> [G, S, H] f32 = q * scale; a
    product below TINY in magnitude flushes to a zero of its sign, as the
    reference's does (an fp8 payload under a row scale of 2**-117 or
    less can give one)."""
    out = q.to(torch.float32) * scales[..., None].to(torch.float32)
    return torch.where(out.abs() < TINY, out * 0.0, out)


def dispatch_scatter_quantize_ref(expert_ids: torch.Tensor, pos: torch.Tensor,
                                  src: torch.Tensor, num_experts: int,
                                  capacity: int, fmt: str
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """wire_quantize_ref(dispatch_scatter_ref(...)): (q [E, C, H], scales
    [E, C] f32)."""
    return wire_quantize_ref(dispatch_scatter_ref(
        expert_ids, pos, src, num_experts, capacity), fmt)


def dequantize_combine_gather_ref(expert_ids: torch.Tensor, pos: torch.Tensor,
                                  q: torch.Tensor, scales: torch.Tensor,
                                  weights: torch.Tensor) -> torch.Tensor:
    """combine_gather_ref(ids, pos, wire_dequantize_ref(q, scales), w):
    [F, H] f32."""
    return combine_gather_ref(expert_ids, pos,
                              wire_dequantize_ref(q, scales), weights)


def dequantize_residual_apply_ref(slots: torch.Tensor, q: torch.Tensor,
                                  scales: torch.Tensor,
                                  residual: torch.Tensor,
                                  base: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """residual_apply_ref(slots, wire_dequantize_ref(q, scales) - base,
    residual), the subtraction skipped when ``base`` is None: [G, C, H]
    f32."""
    dq = wire_dequantize_ref(q, scales)
    if base is not None:
        dq = dq - base.to(torch.float32)
    return residual_apply_ref(slots, dq, residual)
