"""``dispatch_scatter`` and ``combine_gather``: CUDA kernel wrappers
(counterpart of ``repro/kernels/scatter_gather.py``; source
``csrc/scatter_gather.cu``).

Each is an op of ``repro_torch`` (kernels/build.register_op): a CUDA
tensor launches the kernel, a CPU tensor takes the plain version in
``kernels/ref.py``, a fake tensor gives the output shape.  Anything else
raises.  No autograd here: the
differentiable pair (each op is the other's backward) is in
``kernels/dispatch.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import CudaKernel, load_library, register_op

_P, _I = ctypes.c_void_p, ctypes.c_int

SCATTER = CudaKernel(
    name="dispatch_scatter", source="scatter_gather.cu",
    symbol="dispatch_scatter_launch",
    argtypes=(_P, _P, _P, _I, _I, _I, _I, _I, _P),
    replaces="src/repro/kernels/scatter_gather.py:63")

GATHER = CudaKernel(
    name="combine_gather", source="scatter_gather.cu",
    symbol="combine_gather_launch",
    argtypes=(_P, _P, _P, _P, _I, _I, _I, _I, _P),
    replaces="src/repro/kernels/scatter_gather.py:109")


PLAN_KEYS = ("split", "chunk", "grid", "resident_warps")


def gather_plan(num_entries: int, hidden: int) -> dict:
    """How ``combine_gather``'s vector path (H % 4 == 0) tiles F entries of
    H columns on the current CUDA device: ``split`` column chunks a row of
    ``chunk`` float4s each, ``grid`` blocks of 4 warps, and the device's
    ``resident_warps``, which decide the split (``csrc/scatter_gather.cu``).
    The launcher computes the same; this reports it."""
    fn = load_library(GATHER.source).combine_gather_plan
    fn.argtypes = [_I, _I, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    plan = (ctypes.c_int * len(PLAN_KEYS))()
    err = fn(num_entries, hidden, plan)
    if err != 0:
        raise RuntimeError(f"combine_gather_plan failed: cudaError {err}")
    return dict(zip(PLAN_KEYS, plan))


def _check_routing(expert_ids: torch.Tensor, pos: torch.Tensor) -> int:
    if (expert_ids.dim() != 1 or pos.shape != expert_ids.shape
            or expert_ids.dtype != torch.int32 or pos.dtype != torch.int32):
        raise ValueError("expert_ids and pos must be 1-D int32 of one length,"
                         f" got {tuple(expert_ids.shape)} {expert_ids.dtype},"
                         f" {tuple(pos.shape)} {pos.dtype}")
    return expert_ids.shape[0]


def check_cuda(*tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {t.device} vs "
                             f"{dev}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")


def dispatch_scatter(expert_ids: torch.Tensor, pos: torch.Tensor,
                     src: torch.Tensor, num_experts: int,
                     capacity: int) -> torch.Tensor:
    """[F] ids, [F] positions, [F, H] bf16/f32 tokens -> [E, C, H] f32 with
    buf[e, c] = sum of src[f] over entries with (id, pos) == (e, c);
    out-of-range entries contribute nothing."""
    F = _check_routing(expert_ids, pos)
    if src.dim() != 2 or src.shape[0] != F:
        raise ValueError(f"src must be [F={F}, H], got {tuple(src.shape)}")
    if src.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"src must be bfloat16 or float32, got {src.dtype}")
    return SCATTER_OP(expert_ids, pos, src, num_experts, capacity)


def _scatter_launch(expert_ids, pos, src, num_experts: int,
                    capacity: int) -> torch.Tensor:
    check_cuda(expert_ids, pos, src)
    F, H = src.shape
    out = torch.empty(num_experts, capacity, H, dtype=torch.float32,
                      device=src.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(src.device):
        SCATTER.launch(expert_ids.data_ptr(), pos.data_ptr(), src.data_ptr(),
                       int(src.dtype == torch.bfloat16), F, num_experts,
                       capacity, H, out.data_ptr(),
                       stream=torch.cuda.current_stream().cuda_stream)
    return out


def combine_gather(expert_ids: torch.Tensor, pos: torch.Tensor,
                   buf: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """[F] ids, [F] positions, [E, C, H] f32 buffer, [F] f32 weights ->
    [F, H] f32 = weights[f] * buf[id_f, pos_f]; out-of-range entries give
    exactly zero."""
    F = _check_routing(expert_ids, pos)
    if buf.dim() != 3 or buf.dtype != torch.float32:
        raise ValueError(f"buf must be [E, C, H] float32, got "
                         f"{tuple(buf.shape)} {buf.dtype}")
    if weights.shape != (F,) or weights.dtype != torch.float32:
        raise ValueError(f"weights must be [F={F}] float32, got "
                         f"{tuple(weights.shape)} {weights.dtype}")
    return GATHER_OP(expert_ids, pos, buf, weights)


def _gather_launch(expert_ids, pos, buf, weights) -> torch.Tensor:
    check_cuda(expert_ids, pos, buf, weights)
    F = expert_ids.shape[0]
    E, C, H = buf.shape
    out = torch.empty(F, H, dtype=torch.float32, device=buf.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(buf.device):
        GATHER.launch(expert_ids.data_ptr(), pos.data_ptr(), buf.data_ptr(),
                      weights.data_ptr(), F, E, C, H, out.data_ptr(),
                      stream=torch.cuda.current_stream().cuda_stream)
    return out


SCATTER_OP = register_op(
    "dispatch_scatter(Tensor expert_ids, Tensor pos, Tensor src, "
    "int num_experts, int capacity) -> Tensor", cuda=_scatter_launch,
    cpu=ref.dispatch_scatter_ref,
    fake=lambda ids, pos, src, e, c: src.new_empty(
        (e, c, src.shape[1]), dtype=torch.float32))

GATHER_OP = register_op(
    "combine_gather(Tensor expert_ids, Tensor pos, Tensor buf, "
    "Tensor weights) -> Tensor", cuda=_gather_launch,
    cpu=ref.combine_gather_ref,
    fake=lambda ids, pos, buf, w: buf.new_empty((ids.shape[0],
                                                 buf.shape[2])))
