"""``residual_apply``: CUDA kernel wrapper (counterpart of
``repro/kernels/residual_apply.py``; source ``csrc/residual_apply.cu``).

The op ``repro_torch::residual_apply`` (kernels/build.register_op): a
CUDA tensor launches the kernel, a CPU tensor takes the plain version in
``kernels/ref.py``, a fake tensor gives the output shape.  Anything else
raises.  No autograd here: the
differentiable op is ``kernels/dispatch.residual_apply``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import CudaKernel, register_op
from repro_torch.kernels.scatter_gather import check_cuda

_P, _I = ctypes.c_void_p, ctypes.c_int

KERNEL = CudaKernel(
    name="residual_apply", source="residual_apply.cu",
    symbol="residual_apply_launch",
    argtypes=(_P, _P, _P, _I, _I, _I, _I, _P),
    replaces="src/repro/kernels/residual_apply.py:32")


def residual_apply(slots: torch.Tensor, expert_out: torch.Tensor,
                   residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[G, C] int32 slots, [G, S, H] f32 outputs, [G, C, H] f32 residuals
    (None: no residual, the same values as a zero one up to the sign of a
    zero) -> [G, C, H] f32 = expert_out[g, slot] + residual; out-of-range
    slots gather zero."""
    if (slots.dim() != 2 or expert_out.dim() != 3
            or expert_out.shape[0] != slots.shape[0]
            or slots.dtype != torch.int32):
        raise ValueError("slots must be [G, C] int32 and expert_out "
                         f"[G, S, H], got {tuple(slots.shape)} {slots.dtype}"
                         f" and {tuple(expert_out.shape)}")
    G, C = slots.shape
    H = expert_out.shape[2]
    tensors = [slots, expert_out]
    if residual is not None:
        if residual.shape != (G, C, H):
            raise ValueError(f"residual must be [{G}, {C}, {H}], got "
                             f"{tuple(residual.shape)}")
        tensors.append(residual)
    if any(t.dtype != torch.float32 for t in tensors[1:]):
        raise ValueError("expert_out and residual must be float32")
    return OP(slots, expert_out, residual)


def _launch(slots: torch.Tensor, expert_out: torch.Tensor,
            residual: Optional[torch.Tensor]) -> torch.Tensor:
    check_cuda(*[t for t in (slots, expert_out, residual) if t is not None])
    G, C = slots.shape
    H = expert_out.shape[2]
    out = torch.empty(G, C, H, dtype=torch.float32, device=slots.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(slots.device):
        KERNEL.launch(slots.data_ptr(), expert_out.data_ptr(),
                      None if residual is None else residual.data_ptr(),
                      G, C, expert_out.shape[1], H, out.data_ptr(),
                      stream=torch.cuda.current_stream().cuda_stream)
    return out


OP = register_op(
    "residual_apply(Tensor slots, Tensor expert_out, Tensor? residual) "
    "-> Tensor", cuda=_launch, cpu=ref.residual_apply_ref,
    fake=lambda slots, eo, r: eo.new_empty(
        (slots.shape[0], slots.shape[1], eo.shape[2])))
