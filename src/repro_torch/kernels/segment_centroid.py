"""``segment_centroid``: CUDA kernel wrapper (counterpart of
``repro/kernels/segment_centroid.py``; source ``csrc/segment_centroid.cu``).

A CUDA tensor launches the kernel; a CPU tensor takes the plain version in
``kernels/ref.py``.  Anything else raises.  No autograd here: the
differentiable op is ``kernels/dispatch.segment_centroid``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import CudaKernel
from repro_torch.kernels.scatter_gather import check_cuda

_P, _I = ctypes.c_void_p, ctypes.c_int

KERNEL = CudaKernel(
    name="segment_centroid", source="segment_centroid.cu",
    symbol="segment_centroid_launch",
    argtypes=(_P, _P, _I, _I, _I, _I, _I, _P, _P),
    replaces="src/repro/kernels/segment_centroid.py:42")

# The kernel keeps 2 x C int32 in shared memory, at most 227 KB.
MAX_CAPACITY = 232448 // 8


def segment_centroid(slots: torch.Tensor, x: torch.Tensor, num_slots: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """slots: [G, C] int32; x: [G, C, H] bf16 / f32 -> (centroids
    [G, S, H] f32, counts [G, S] f32).  Slots outside [0, S) count
    nowhere."""
    if (slots.dim() != 2 or x.dim() != 3 or x.shape[:2] != slots.shape
            or slots.dtype != torch.int32):
        raise ValueError("slots must be [G, C] int32 and x [G, C, H], got "
                         f"{tuple(slots.shape)} {slots.dtype} and "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x must be bfloat16 or float32, got {x.dtype}")
    if slots.device.type == "cpu" and x.device.type == "cpu":
        return ref.segment_centroid_ref(slots, x, num_slots)
    check_cuda(slots, x)
    G, C, H = x.shape
    if C > MAX_CAPACITY:
        raise ValueError(f"C={C} above {MAX_CAPACITY} (shared-memory layout)")
    cent = torch.empty(G, num_slots, H, dtype=torch.float32, device=x.device)
    counts = torch.empty(G, num_slots, dtype=torch.float32, device=x.device)
    if counts.numel() == 0:
        return cent, counts
    with torch.cuda.device(x.device):
        KERNEL.launch(slots.data_ptr(), x.data_ptr(),
                      int(x.dtype == torch.bfloat16), G, C, num_slots, H,
                      cent.data_ptr(), counts.data_ptr(),
                      stream=torch.cuda.current_stream().cuda_stream)
    return cent, counts
