"""The wire codec fused into the routing ops: CUDA kernel wrappers
(counterpart of ``repro/kernels/fused_wire.py``; source
``csrc/fused_wire.cu``).

  dispatch_scatter_quantize   wire_quantize(dispatch_scatter(...)), the f32
                              buffer never in device memory
  dequantize_combine_gather   combine_gather(..., wire_dequantize(q, s), w)
  dequantize_residual_apply   residual_apply(slots, wire_dequantize(q, s)
                              - base, residual), base optional

Each is bitwise its composition of the unfused ops, and an op of
``repro_torch`` (kernels/build.register_op): a CUDA tensor launches the
kernel, a CPU tensor takes the plain version in ``kernels/ref.py`` (the
composition itself), a fake tensor gives the output shapes.  Anything
else raises.
Forward only: the differentiable transfers around them are in
``comm/wire.py``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import CudaKernel, register_op
from repro_torch.kernels.scatter_gather import _check_routing, check_cuda
from repro_torch.kernels.wire_quant import (FP8, check_scales, payload_format,
                                            quant_dtype)

_P, _I = ctypes.c_void_p, ctypes.c_int

SCATTER_QUANTIZE = CudaKernel(
    name="dispatch_scatter_quantize", source="fused_wire.cu",
    symbol="dispatch_scatter_quantize_launch",
    argtypes=(_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    replaces="src/repro/kernels/fused_wire.py:75")

DEQUANTIZE_GATHER = CudaKernel(
    name="dequantize_combine_gather", source="fused_wire.cu",
    symbol="dequantize_combine_gather_launch",
    argtypes=(_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    replaces="src/repro/kernels/fused_wire.py:138")

DEQUANTIZE_RESIDUAL = CudaKernel(
    name="dequantize_residual_apply", source="fused_wire.cu",
    symbol="dequantize_residual_apply_launch",
    argtypes=(_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    replaces="src/repro/kernels/fused_wire.py:204")


def dispatch_scatter_quantize(expert_ids: torch.Tensor, pos: torch.Tensor,
                              src: torch.Tensor, num_experts: int,
                              capacity: int, fmt: str
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[F] ids, [F] positions, [F, H] bf16 / f32 tokens -> (q [E, C, H]
    int8 | float8_e4m3fn, scales [E, C] f32); out-of-range entries
    contribute nothing, empty rows get scale 1 and a zero payload.  On the
    card one launch runs a memset and two kernels: the row index (into a
    [2, E * C] int32 scratch) and the per-row scatter-quantize."""
    F = _check_routing(expert_ids, pos)
    quant_dtype(fmt)
    if src.dim() != 2 or src.shape[0] != F:
        raise ValueError(f"src must be [F={F}, H], got {tuple(src.shape)}")
    if src.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"src must be bfloat16 or float32, got {src.dtype}")
    return SCATTER_QUANTIZE_OP(expert_ids, pos, src, num_experts, capacity,
                               fmt)


def _scatter_quantize_launch(expert_ids, pos, src, num_experts: int,
                             capacity: int, fmt: str
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    check_cuda(expert_ids, pos, src)
    dt = quant_dtype(fmt)
    F, H = src.shape
    q = torch.empty(num_experts, capacity, H, dtype=dt, device=src.device)
    scales = torch.empty(num_experts, capacity, dtype=torch.float32,
                         device=src.device)
    if q.numel() == 0:
        return q, scales.fill_(1.0)
    scratch = torch.empty(2, num_experts * capacity, dtype=torch.int32,
                          device=src.device)
    with torch.cuda.device(src.device):
        SCATTER_QUANTIZE.launch(
            expert_ids.data_ptr(), pos.data_ptr(), src.data_ptr(),
            int(src.dtype == torch.bfloat16), int(fmt == FP8), F,
            num_experts, capacity, H, q.data_ptr(), scales.data_ptr(),
            scratch.data_ptr(),
            stream=torch.cuda.current_stream().cuda_stream)
    return q, scales


def dequantize_combine_gather(expert_ids: torch.Tensor, pos: torch.Tensor,
                              q: torch.Tensor, scales: torch.Tensor,
                              weights: torch.Tensor) -> torch.Tensor:
    """[F] ids, [F] positions, (q [E, C, H], scales [E, C]), [F] f32
    weights -> [F, H] f32 = weights[f] * (q * scale)[id_f, pos_f];
    out-of-range entries give zero."""
    F = _check_routing(expert_ids, pos)
    fmt = payload_format(q)
    check_scales(q, scales)
    if weights.shape != (F,) or weights.dtype != torch.float32:
        raise ValueError(f"weights must be [F={F}] float32, got "
                         f"{tuple(weights.shape)} {weights.dtype}")
    return DEQUANTIZE_GATHER_OP(expert_ids, pos, q, scales, weights)


def _dequantize_gather_launch(expert_ids, pos, q, scales, weights
                              ) -> torch.Tensor:
    check_cuda(expert_ids, pos, q, scales, weights)
    fmt = payload_format(q)
    F = expert_ids.shape[0]
    E, C, H = q.shape
    out = torch.empty(F, H, dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        DEQUANTIZE_GATHER.launch(
            expert_ids.data_ptr(), pos.data_ptr(), q.data_ptr(),
            scales.data_ptr(), weights.data_ptr(), int(fmt == FP8), F, E, C,
            H, out.data_ptr(),
            stream=torch.cuda.current_stream().cuda_stream)
    return out


def dequantize_residual_apply(slots: torch.Tensor, q: torch.Tensor,
                              scales: torch.Tensor, residual: torch.Tensor,
                              base: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """[G, C] int32 slots, (q [G, S, H], scales [G, S]), [G, C, H] f32
    residual, optional [G, S, H] f32 base -> [G, C, H] f32 =
    ((q * scale) - base)[g, slot] + residual; out-of-range slots gather
    zero."""
    fmt = payload_format(q)
    check_scales(q, scales)
    G, S, H = q.shape
    if slots.dim() != 2 or slots.shape[0] != G or slots.dtype != torch.int32:
        raise ValueError(f"slots must be [G={G}, C] int32, got "
                         f"{tuple(slots.shape)} {slots.dtype}")
    C = slots.shape[1]
    if residual.shape != (G, C, H) or residual.dtype != torch.float32:
        raise ValueError(f"residual must be [{G}, {C}, {H}] float32, got "
                         f"{tuple(residual.shape)} {residual.dtype}")
    if base is not None:
        if base.shape != (G, S, H) or base.dtype != torch.float32:
            raise ValueError(f"base must be [{G}, {S}, {H}] float32, got "
                             f"{tuple(base.shape)} {base.dtype}")
    return DEQUANTIZE_RESIDUAL_OP(slots, q, scales, residual, base)


def _dequantize_residual_launch(slots, q, scales, residual, base
                                ) -> torch.Tensor:
    check_cuda(*[t for t in (slots, q, scales, residual, base)
                 if t is not None])
    fmt = payload_format(q)
    G, S, H = q.shape
    C = slots.shape[1]
    out = torch.empty(G, C, H, dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        DEQUANTIZE_RESIDUAL.launch(
            slots.data_ptr(), q.data_ptr(), scales.data_ptr(),
            None if base is None else base.data_ptr(), residual.data_ptr(),
            int(fmt == FP8), G, C, S, H, out.data_ptr(),
            stream=torch.cuda.current_stream().cuda_stream)
    return out


SCATTER_QUANTIZE_OP = register_op(
    "dispatch_scatter_quantize(Tensor expert_ids, Tensor pos, Tensor src, "
    "int num_experts, int capacity, str fmt) -> (Tensor, Tensor)",
    cuda=_scatter_quantize_launch, cpu=ref.dispatch_scatter_quantize_ref,
    fake=lambda ids, pos, src, e, c, fmt: (
        src.new_empty((e, c, src.shape[1]), dtype=quant_dtype(fmt)),
        src.new_empty((e, c), dtype=torch.float32)))

DEQUANTIZE_GATHER_OP = register_op(
    "dequantize_combine_gather(Tensor expert_ids, Tensor pos, Tensor q, "
    "Tensor scales, Tensor weights) -> Tensor",
    cuda=_dequantize_gather_launch, cpu=ref.dequantize_combine_gather_ref,
    fake=lambda ids, pos, q, s, w: w.new_empty((ids.shape[0], q.shape[2])))

DEQUANTIZE_RESIDUAL_OP = register_op(
    "dequantize_residual_apply(Tensor slots, Tensor q, Tensor scales, "
    "Tensor residual, Tensor? base) -> Tensor",
    cuda=_dequantize_residual_launch, cpu=ref.dequantize_residual_apply_ref,
    fake=lambda slots, q, s, r, b: r.new_empty(r.shape))
