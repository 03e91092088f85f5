"""``segment_centroid``: CUDA kernel wrapper (counterpart of
``repro/kernels/segment_centroid.py``; source ``csrc/segment_centroid.cu``).

The op ``repro_torch::segment_centroid`` (kernels/build.register_op): a
CUDA tensor launches the kernel, a CPU tensor takes the plain version in
``kernels/ref.py``, a fake tensor gives the output shapes.  Anything else
raises.  No autograd here: the
differentiable op is ``kernels/dispatch.segment_centroid``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import CudaKernel, register_op
from repro_torch.kernels.scatter_gather import check_cuda

_P, _I = ctypes.c_void_p, ctypes.c_int

KERNEL = CudaKernel(
    name="segment_centroid", source="segment_centroid.cu",
    symbol="segment_centroid_launch",
    argtypes=(_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I),
    replaces="src/repro/kernels/segment_centroid.py:42")

# Rows of one work item of the kernel's reduction (at most its 192 threads).
ROWS_PER_ITEM = 64
# The index pass keeps S int32 counters a warp, for one warp at least, in
# shared memory: at most 227 KB less 1 KB.
MAX_SLOTS = (232448 - 1024) // 4


@functools.lru_cache(maxsize=64)
def work_bounds(capacity: int, num_slots: int) -> Tuple[int, int, int]:
    """The kernel's work layout per group, whatever the slots: (work
    items, slots of more than R rows, their items); R = ROWS_PER_ITEM.  An
    empty slot is one item, a slot of n rows ceil(n / R).  So at most
    S + ceil(C / R) items, C // (R + 1) slots of several items, and
    ceil(C / R) + C // (R + 1) items of those (each has a partial-sum
    row), none when C <= R."""
    pieces = -(-capacity // ROWS_PER_ITEM)
    multi = capacity // (ROWS_PER_ITEM + 1)
    return num_slots + pieces, multi, (pieces + multi if multi else 0)


@functools.lru_cache(maxsize=64)
def scratch_sizes(groups: int, capacity: int, num_slots: int, hidden: int
                  ) -> Tuple[int, int]:
    """(int32 words, f32 values) of the kernel's scratch, in one
    allocation: the index, per group four words an item and a slot of
    several items, the member list (C) and two counters, rounded up to
    16 bytes; then an H-row of partial sums an item of such a slot."""
    items, multi, partials = work_bounds(capacity, num_slots)
    words = groups * (4 * items + 4 * multi + capacity + 2)
    return -(-words // 4) * 4, groups * partials * hidden


def segment_centroid(slots: torch.Tensor, x: torch.Tensor, num_slots: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """slots: [G, C] int32; x: [G, C, H] bf16 / f32 -> (centroids
    [G, S, H] f32, counts [G, S] f32).  Slots outside [0, S) count
    nowhere.  On the card one launch runs three kernels (index, reduce,
    combine) on scratch allocated here."""
    if (slots.dim() != 2 or x.dim() != 3 or x.shape[:2] != slots.shape
            or slots.dtype != torch.int32):
        raise ValueError("slots must be [G, C] int32 and x [G, C, H], got "
                         f"{tuple(slots.shape)} {slots.dtype} and "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x must be bfloat16 or float32, got {x.dtype}")
    return OP(slots, x, num_slots)


def _launch(slots: torch.Tensor, x: torch.Tensor, num_slots: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    check_cuda(slots, x)
    G, C, H = x.shape
    if num_slots > MAX_SLOTS:
        raise ValueError(f"num_slots={num_slots} above {MAX_SLOTS} "
                         "(shared-memory counters)")
    cent = torch.empty(G, num_slots, H, dtype=torch.float32, device=x.device)
    counts = torch.empty(G, num_slots, dtype=torch.float32, device=x.device)
    if counts.numel() == 0:
        return cent, counts
    words, floats = scratch_sizes(G, C, num_slots, H)
    scratch = torch.empty(words + floats, dtype=torch.int32, device=x.device)
    base = scratch.data_ptr()
    with torch.cuda.device(x.device):
        KERNEL.launch(slots.data_ptr(), x.data_ptr(),
                      int(x.dtype == torch.bfloat16), G, C, num_slots, H,
                      cent.data_ptr(), counts.data_ptr(), base,
                      base + 4 * words, ROWS_PER_ITEM,
                      *work_bounds(C, num_slots),
                      stream=torch.cuda.current_stream().cuda_stream)
    return cent, counts


OP = register_op(
    "segment_centroid(Tensor slots, Tensor x, int num_slots) "
    "-> (Tensor, Tensor)", cuda=_launch, cpu=ref.segment_centroid_ref,
    fake=lambda slots, x, s: (
        x.new_empty((x.shape[0], s, x.shape[2]), dtype=torch.float32),
        x.new_empty((x.shape[0], s), dtype=torch.float32)))
