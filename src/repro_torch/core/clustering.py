"""Fixed-slot LSH clustering with residual error compensation, paper §3.2
(counterpart of ``repro/core/clustering.py``).

``compress`` clusters each expert's token group into ``S`` slot centroids;
``decompress`` reconstructs per-token expert outputs in the reassociated
form of Eq. 5, Y = token + (E(c_dq) - c_dq)[slot]:

  tokens [G, C, H]  --compress-->  centroids [G, S, H], slot ids [G, C]
  expert outputs on centroids [G, S, H]  --decompress-->  [G, C, H]

Wire formats (LSHConfig.wire_format): the centroids cross the exchange
in bf16, or quantized to int8 / fp8-e4m3 with one f32 scale per (group,
slot) (kernels/wire_quant.py).  ``compress`` computes the residuals against
the dequantized centroids, so in the reassociated form the wire
representation cancels out of Y wherever the expert preserves its input.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.hashing import lsh_hash
from repro_torch.kernels import dispatch
from repro_torch.kernels.wire_quant import (BF16_FORMAT, quant_dtype,
                                            validate_wire_format)

_SCALE_BYTES = 4                          # one f32 scale per (group, slot)


class Compressed(NamedTuple):
    centroids: torch.Tensor   # [G, S, H] wire values (dequantized under a
    #                           quantized format), in tokens.dtype
    residuals: Optional[torch.Tensor]   # [G, C, H] zeros without error
    #                           compensation, where decompress reads them;
    #                           None with it (the JAX field is then a
    #                           diagnostic that XLA deletes under jit)
    slots: torch.Tensor       # [G, C] int32 slot id per token (clamped)
    counts: torch.Tensor      # [G, S] f32 tokens per slot
    tokens: Optional[torch.Tensor] = None   # [G, C, H] originals when
    #                           error compensation is on
    scales: Optional[torch.Tensor] = None   # [G, S] f32 (int8 / fp8)
    payload: Optional[torch.Tensor] = None  # [G, S, H] int8 | fp8: the
    #                           centroids' encoding, which the fused
    #                           dispatch leg ships as it is


def wire_bytes(num_groups: int, num_slots: int, hidden: int,
               wire_format: Optional[str] = None, *,
               wire_dtype=torch.bfloat16) -> int:
    """Per-rank wire bytes of one dispatch (or combine) leg: the payload in
    ``wire_dtype`` for None / "bf16"; for "int8" / "fp8" a one-byte
    payload plus one f32 scale per (group, slot)."""
    if wire_format in (None, BF16_FORMAT):
        itemsize = torch.empty((), dtype=wire_dtype).element_size()
        return num_groups * num_slots * hidden * itemsize
    payload = torch.empty((), dtype=quant_dtype(wire_format)).element_size()
    return num_groups * num_slots * (hidden * payload + _SCALE_BYTES)


def assign_slots(tokens: torch.Tensor, rotations: torch.Tensor,
                 num_slots: int, hash_type: str) -> torch.Tensor:
    """Bucket ids folded into [0, num_slots): abs, then a floor-mod, as
    JAX's ``%`` (``torch.remainder``; abs(INT_MIN) stays negative and maps
    into range only under the floor-mod)."""
    ids = lsh_hash(tokens, rotations, hash_type)
    return torch.remainder(torch.abs(ids), num_slots).to(torch.int32)


def _to_wire(centroids: torch.Tensor, wire_format: Optional[str],
             wire_dtype):
    """f32 centroids -> (the values the far side of the exchange sees, f32;
    scales or None; payload or None)."""
    if wire_format is None:
        return centroids, None, None
    if validate_wire_format(wire_format) == BF16_FORMAT:
        return centroids.to(wire_dtype).to(torch.float32), None, None
    dq, payload, scales = dispatch.wire_encode_roundtrip(centroids,
                                                         wire_format)
    return dq, scales, payload


def compress(tokens: torch.Tensor, valid: torch.Tensor,
             rotations: torch.Tensor, num_slots: int,
             hash_type: str = "cross_polytope",
             error_compensation: bool = True, *,
             wire_format: Optional[str] = None,
             wire_dtype=torch.bfloat16) -> Compressed:
    """tokens: [G, C, H]; valid: [G, C] bool (occupied buffer rows).
    Centroids are rounded to their wire representation before anything
    reads them, so the compensation absorbs the rounding."""
    G, C, H = tokens.shape
    slots = assign_slots(tokens, rotations, num_slots, hash_type)
    slots = torch.where(valid, slots, num_slots).to(torch.int32)  # overflow
    cent_f32, counts = dispatch.segment_centroid(slots, tokens.contiguous(),
                                                 num_slots)
    cent_f32, scales, payload = _to_wire(cent_f32, wire_format, wire_dtype)
    centroids = cent_f32.to(tokens.dtype)
    if error_compensation:
        residuals, kept_tokens = None, tokens
    else:
        residuals = torch.zeros(G, C, H, dtype=tokens.dtype,
                                device=tokens.device)
        kept_tokens = None
    slots = torch.clamp(slots, max=num_slots - 1)   # clamp the overflow bin
    return Compressed(centroids, residuals, slots, counts, kept_tokens,
                      scales, payload)


def decompress(expert_out: torch.Tensor, comp: Compressed) -> torch.Tensor:
    """expert_out: [G, S, H] = E(centroids) -> [G, C, H] ~ E(tokens).

    Eq. 5 reassociated: Y = token + (E(c_dq) - c_dq)[slot]; without error
    compensation Y = E(c_dq)[slot] + 0."""
    if comp.tokens is None:
        out = dispatch.residual_apply(comp.slots, expert_out, comp.residuals)
    else:
        delta = expert_out - comp.centroids.to(torch.float32)
        out = dispatch.residual_apply(comp.slots, delta, comp.tokens)
    return out.to(expert_out.dtype)


def fused_decompress_operands(comp: Compressed):
    """(slots, base, residual) of comm/wire.fused_decode_residual_transfer,
    ``decompress``'s two branches as the fused kernel's operands:

      base None (no error compensation):  Y = dq[slot] + residuals
      base = centroids (compensation on): Y = tokens + (dq - centroids)[slot]

    with dq the dequantized expert output the kernel reconstructs."""
    if comp.tokens is None:
        return comp.slots, None, comp.residuals.to(torch.float32)
    return (comp.slots, comp.centroids.to(torch.float32),
            comp.tokens.to(torch.float32))


def compression_stats(comp: Compressed, valid: torch.Tensor,
                      wire_format: Optional[str] = None,
                      wire_dtype=None) -> dict:
    """Measured compression: occupied slots / valid tokens, and the wire
    bytes of one leg, the scales included (``wire_bytes``)."""
    G, num_slots = comp.counts.shape
    capacity = comp.slots.shape[1]
    hidden = comp.centroids.shape[-1]
    if wire_format is None and comp.scales is not None:
        wire_format = "int8"              # one-byte payload; fp8 the same
    wire_dtype = torch.bfloat16 if wire_dtype is None else wire_dtype
    occupied = (comp.counts > 0).sum(dim=-1).to(torch.float32)     # [G]
    tokens = torch.clamp(valid.sum(dim=-1).to(torch.float32), min=1.0)
    wbytes = wire_bytes(G, num_slots, hidden, wire_format,
                        wire_dtype=wire_dtype)
    return {
        "configured_rate": float(num_slots) / float(max(1, capacity)),
        "occupied_slots": occupied.mean(),
        "effective_rate": (occupied / tokens).mean(),
        "wire_bytes": wbytes,
        "wire_bytes_ratio_vs_bf16": wbytes / max(1, wire_bytes(
            G, num_slots, hidden, BF16_FORMAT)),
    }
