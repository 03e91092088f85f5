"""``positions_in_expert``: CUDA kernel wrapper (counterpart of
``repro/kernels/token_position.py``; source ``csrc/token_position.cu``).

A CUDA tensor launches the kernel; a CPU tensor takes the plain version in
``kernels/ref.py``.  Anything else raises.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import CudaKernel

KERNEL = CudaKernel(
    name="positions_in_expert", source="token_position.cu",
    symbol="positions_in_expert_launch",
    argtypes=(ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
              ctypes.c_void_p),
    replaces="src/repro/kernels/token_position.py:51")

# The kernel keeps (32 warps + 1) x E int32 in shared memory, at most 227 KB.
MAX_EXPERTS = 232448 // (4 * 33)


def positions_in_expert(expert_ids: torch.Tensor, num_experts: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[F] int32 ids -> (pos [F] int32, counts [E] int32): the stable
    token-major rank of each entry within its expert and the uncapped
    per-expert totals.  Ids outside [0, E) get pos 0 and no count."""
    if expert_ids.dim() != 1 or expert_ids.dtype != torch.int32:
        raise ValueError("expert_ids must be a 1-D int32 tensor, got "
                         f"{tuple(expert_ids.shape)} {expert_ids.dtype}")
    if expert_ids.device.type == "cpu":
        return ref.positions_in_expert_ref(expert_ids, num_experts)
    if expert_ids.device.type != "cuda":
        raise ValueError(f"unsupported device {expert_ids.device}")
    if not expert_ids.is_contiguous():
        raise ValueError("expert_ids must be contiguous")
    if not 0 < num_experts <= MAX_EXPERTS:
        raise ValueError(f"num_experts={num_experts} outside (0, "
                         f"{MAX_EXPERTS}] (shared-memory layout)")
    F = expert_ids.shape[0]
    pos = torch.empty_like(expert_ids)
    counts = torch.empty(num_experts, dtype=torch.int32,
                         device=expert_ids.device)
    with torch.cuda.device(expert_ids.device):
        stream = torch.cuda.current_stream().cuda_stream
        KERNEL.launch(expert_ids.data_ptr(), F, num_experts, pos.data_ptr(),
                      counts.data_ptr(), stream=stream)
    return pos, counts
