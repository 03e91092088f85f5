"""``positions_in_expert``: CUDA kernel wrapper (counterpart of
``repro/kernels/token_position.py``; source ``csrc/token_position.cu``).

The op ``repro_torch::positions_in_expert`` (kernels/build.register_op):
a CUDA tensor launches the kernel, a CPU tensor takes the plain version in
``kernels/ref.py``, a fake tensor gives the output shapes.  Anything else
raises.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import CudaKernel, register_op

_P, _I = ctypes.c_void_p, ctypes.c_int

KERNEL = CudaKernel(
    name="positions_in_expert", source="token_position.cu",
    symbol="positions_in_expert_launch",
    argtypes=(_P, ctypes.c_longlong, _I, _I, _I, _P, _P, _P),
    replaces="src/repro/kernels/token_position.py:51")

# One entry a thread, 256 threads a block: a tile of 256 entries.
TILE = 256
# A block keeps run[E] and two [8 warps, E] histograms of int32 in shared
# memory, at most 227 KB: E <= 3418.  The largest num_experts of the
# configs is 128.
MAX_EXPERTS = 232448 // (4 * 17)

_SMS: Dict[int, int] = {}


def _sm_count(device: torch.device) -> int:
    """The card's SM count, asked once a device and kept."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    n = _SMS.get(index)
    if n is None:
        n = _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return n


def grid_layout(F: int, sms: int) -> Tuple[int, int]:
    """(grid, tiles a block): the F entries' tiles spread over at most
    ``sms`` blocks, one an SM, each owning a run of consecutive tiles and
    none empty."""
    tiles = max(1, -(-F // TILE))
    per_block = -(-tiles // min(tiles, sms))
    return -(-tiles // per_block), per_block


def positions_in_expert(expert_ids: torch.Tensor, num_experts: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[F] int32 ids -> (pos [F] int32, counts [E] int32): the stable
    token-major rank of each entry within its expert and the uncapped
    per-expert totals.  Ids outside [0, E) get pos 0 and no count."""
    if expert_ids.dim() != 1 or expert_ids.dtype != torch.int32:
        raise ValueError("expert_ids must be a 1-D int32 tensor, got "
                         f"{tuple(expert_ids.shape)} {expert_ids.dtype}")
    return OP(expert_ids, num_experts)


def _launch(expert_ids: torch.Tensor, num_experts: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    if not expert_ids.is_contiguous():
        raise ValueError("expert_ids must be contiguous")
    if not 0 < num_experts <= MAX_EXPERTS:
        raise ValueError(f"num_experts={num_experts} outside (0, "
                         f"{MAX_EXPERTS}] (shared-memory layout)")
    F = expert_ids.shape[0]
    dev = expert_ids.device
    pos = torch.empty_like(expert_ids)
    counts = torch.empty(num_experts, dtype=torch.int32, device=dev)
    grid, per_block = grid_layout(F, _sm_count(dev))
    # the blocks' totals, from the caching allocator on the current stream
    scratch = torch.empty(grid * num_experts if grid > 1 else 0,
                          dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        KERNEL.launch(expert_ids.data_ptr(), F, num_experts, grid, per_block,
                      pos.data_ptr(), counts.data_ptr(), scratch.data_ptr(),
                      stream=stream)
    return pos, counts


def _fake(expert_ids: torch.Tensor, num_experts: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    return torch.empty_like(expert_ids), expert_ids.new_empty(num_experts)


OP = register_op("positions_in_expert(Tensor expert_ids, int num_experts) "
                 "-> (Tensor, Tensor)", cuda=_launch,
                 cpu=ref.positions_in_expert_ref, fake=_fake)
