"""The quantized wire format: ``wire_quantize`` and ``wire_dequantize``
CUDA kernel wrappers and the format names (counterpart of
``repro/kernels/wire_quant.py``; source ``csrc/wire_quant.cu``).

A [G, S, H] wire tensor crosses the all-to-all as a one-byte payload
(int8, or fp8-e4m3) with one f32 power-of-two absmax scale per (group,
slot) row.  Power-of-two scales make the pair idempotent on its own
output: quantize(dequantize(quantize(x))) gives the same int8 payload, and
for fp8 the same dequantized values (kernels/ref.py, ``po2_scale``).

Each is an op of ``repro_torch`` (kernels/build.register_op): a CUDA
tensor launches the kernel, a CPU tensor takes the plain version in
``kernels/ref.py``, a fake tensor gives the output shapes.  Anything else
raises.  No autograd here: the
straight-through pair is ``kernels/dispatch.wire_roundtrip``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import CudaKernel, register_op
from repro_torch.kernels.scatter_gather import check_cuda

INT8 = "int8"
FP8 = "fp8"
BF16_FORMAT = "bf16"
QUANT_FORMATS = (INT8, FP8)
WIRE_FORMATS = (BF16_FORMAT,) + QUANT_FORMATS

_P, _I = ctypes.c_void_p, ctypes.c_int

QUANTIZE = CudaKernel(
    name="wire_quantize", source="wire_quant.cu",
    symbol="wire_quantize_launch", argtypes=(_P, _I, _I, _I, _I, _P, _P),
    replaces="src/repro/kernels/wire_quant.py:123")

DEQUANTIZE = CudaKernel(
    name="wire_dequantize", source="wire_quant.cu",
    symbol="wire_dequantize_launch", argtypes=(_P, _P, _I, _I, _I, _P),
    replaces="src/repro/kernels/wire_quant.py:154")


def validate_wire_format(fmt: str) -> str:
    """One check for every wire-format entry point (clustering._to_wire,
    comm.wire.make_codec)."""
    if fmt not in WIRE_FORMATS:
        raise ValueError(f"unknown wire format {fmt!r}; available: "
                         f"{sorted(WIRE_FORMATS)}")
    return fmt


def quant_dtype(fmt: str) -> torch.dtype:
    if fmt == INT8:
        return torch.int8
    if fmt == FP8:
        return torch.float8_e4m3fn
    raise ValueError(f"unknown quantized wire format {fmt!r}; available: "
                     f"{sorted(QUANT_FORMATS)}")


def qmax(fmt: str) -> float:
    """Largest payload magnitude: 127 for int8, 448 for fp8-e4m3."""
    quant_dtype(fmt)
    return 127.0 if fmt == INT8 else 448.0


def payload_format(q: torch.Tensor) -> str:
    """The wire format of a payload tensor, from its dtype."""
    for fmt in QUANT_FORMATS:
        if q.dtype == quant_dtype(fmt):
            return fmt
    raise ValueError(f"payload must be int8 or float8_e4m3fn, got {q.dtype}")


def check_scales(q: torch.Tensor, scales: torch.Tensor) -> None:
    if q.dim() != 3 or scales.shape != q.shape[:2] \
            or scales.dtype != torch.float32:
        raise ValueError(f"q must be [G, S, H] and scales [G, S] float32, "
                         f"got {tuple(q.shape)} and {tuple(scales.shape)} "
                         f"{scales.dtype}")


def wire_quantize(x: torch.Tensor, fmt: str
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [G, S, H] f32 / bf16 -> (q [G, S, H] int8 | float8_e4m3fn,
    scales [G, S] f32); empty rows get scale 1 and a zero payload."""
    quant_dtype(fmt)
    if x.dim() != 3 or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x must be [G, S, H] bfloat16 or float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    return QUANTIZE_OP(x, fmt)


def _quantize_launch(x: torch.Tensor, fmt: str
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    check_cuda(x)
    dt = quant_dtype(fmt)
    G, S, H = x.shape
    q = torch.empty(G, S, H, dtype=dt, device=x.device)
    scales = torch.empty(G, S, dtype=torch.float32, device=x.device)
    if q.numel() == 0:
        return q, scales.fill_(1.0)
    with torch.cuda.device(x.device):
        QUANTIZE.launch(x.data_ptr(), int(x.dtype == torch.bfloat16),
                        int(fmt == FP8), G * S, H, q.data_ptr(),
                        scales.data_ptr(),
                        stream=torch.cuda.current_stream().cuda_stream)
    return q, scales


def wire_dequantize(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(q [G, S, H] int8 | float8_e4m3fn, scales [G, S] f32) -> [G, S, H]
    f32 = q * scale."""
    payload_format(q)
    check_scales(q, scales)
    return DEQUANTIZE_OP(q, scales)


def _dequantize_launch(q: torch.Tensor, scales: torch.Tensor
                       ) -> torch.Tensor:
    check_cuda(q, scales)
    fmt = payload_format(q)
    G, S, H = q.shape
    out = torch.empty(G, S, H, dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        DEQUANTIZE.launch(q.data_ptr(), scales.data_ptr(), int(fmt == FP8),
                          G * S, H, out.data_ptr(),
                          stream=torch.cuda.current_stream().cuda_stream)
    return out


QUANTIZE_OP = register_op(
    "wire_quantize(Tensor x, str fmt) -> (Tensor, Tensor)",
    cuda=_quantize_launch, cpu=ref.wire_quantize_ref,
    fake=lambda x, fmt: (x.new_empty(x.shape, dtype=quant_dtype(fmt)),
                         x.new_empty(x.shape[:2], dtype=torch.float32)))

DEQUANTIZE_OP = register_op(
    "wire_dequantize(Tensor q, Tensor scales) -> Tensor",
    cuda=_dequantize_launch, cpu=ref.wire_dequantize_ref,
    fake=lambda q, s: q.new_empty(q.shape, dtype=torch.float32))
