"""``lsh_hash``: CUDA kernel wrapper (counterpart of
``repro/kernels/lsh_hash.py``; source ``csrc/lsh_hash.cu``).

The op ``repro_torch::lsh_hash`` (kernels/build.register_op): a CUDA
tensor launches the kernel, a CPU tensor takes the plain version in
``kernels/ref.py``, a fake tensor gives the output shape.  Anything else
raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import CudaKernel, register_op
from repro_torch.kernels.scatter_gather import check_cuda

_P, _I = ctypes.c_void_p, ctypes.c_int

KERNEL = CudaKernel(
    name="lsh_hash", source="lsh_hash.cu", symbol="lsh_hash_launch",
    argtypes=(_P, _I, _P, _I, _I, _I, _I, _I, _P),
    replaces="src/repro/kernels/lsh_hash.py:38")

MAX_ROTATION_DIM = 64      # the kernels' column tiles (csrc/lsh_hash.cu)


def uses_tensor_cores(x: torch.Tensor, rotations: torch.Tensor) -> bool:
    """bf16 x and rotations that TMA can read (rows a multiple of 16 bytes,
    16-byte-aligned x) take the tensor-core kernel; any other input the
    f32-FMA kernel."""
    H, Dr = rotations.shape[1], rotations.shape[2]
    return (x.dtype == rotations.dtype == torch.bfloat16 and H % 8 == 0
            and Dr % 8 == 0 and x.data_ptr() % 16 == 0)


def pack_rotations(rotations: torch.Tensor) -> torch.Tensor:
    """[L, H, Dr] -> [L * Dr, H], row l * Dr + d = R[l, :, d]: all hashes'
    columns as one K-major operand, so x . R_l for every l is one GEMM
    (x @ packed.T viewed as [T, L, Dr])."""
    L, H, Dr = rotations.shape
    return rotations.transpose(1, 2).reshape(L * Dr, H).contiguous()


def lsh_hash(x: torch.Tensor, rotations: torch.Tensor) -> torch.Tensor:
    """x: [T, H] bf16 / f32; rotations: [L, H, Dr] -> [T, L] int32 vertex
    ids.  bf16 x with bf16 rotations (the training path) runs on the
    tensor cores, exact products summed in f32, against the rotations
    packed by ``pack_rotations`` (a copy of 2 L H Dr bytes each call);
    anything else on the f32-FMA kernel, bf16 x read as it is (its values
    are exact in f32)."""
    if x.dim() != 2 or rotations.dim() != 3 or rotations.shape[1] != x.shape[1]:
        raise ValueError(f"x must be [T, H] and rotations [L, H, Dr], got "
                         f"{tuple(x.shape)} and {tuple(rotations.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x must be bfloat16 or float32, got {x.dtype}")
    return OP(x, rotations)


def _launch(x: torch.Tensor, rotations: torch.Tensor) -> torch.Tensor:
    check_cuda(x, rotations.contiguous())
    T, H = x.shape
    L, _, Dr = rotations.shape
    if not 0 < Dr <= MAX_ROTATION_DIM:
        raise ValueError(f"rotation_dim={Dr} outside (0, {MAX_ROTATION_DIM}]")
    tensor_cores = uses_tensor_cores(x, rotations)
    rot = (pack_rotations(rotations) if tensor_cores
           else rotations.to(torch.float32).contiguous())
    out = torch.empty(T, L, dtype=torch.int32, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        KERNEL.launch(x.data_ptr(), int(x.dtype == torch.bfloat16),
                      rot.data_ptr(), int(tensor_cores), T, H, L, Dr,
                      out.data_ptr(),
                      stream=torch.cuda.current_stream().cuda_stream)
    return out


OP = register_op("lsh_hash(Tensor x, Tensor rotations) -> Tensor",
                 cuda=_launch, cpu=ref.lsh_hash_ref,
                 fake=lambda x, r: x.new_empty((x.shape[0], r.shape[0]),
                                               dtype=torch.int32))


def near_tie_margin(x: torch.Tensor, rotations: torch.Tensor) -> torch.Tensor:
    """[T, L] f32: (largest |v| - second largest |v|) / max|v| of each
    (token, hash), v = x . R_l in f32 (1 where v is all zero: such a row
    hashes to vertex 0 in any order of summation).  The hash
    is discontinuous: where this margin is tiny, two f32 products summed in
    another order may pick another vertex, so comparisons of vertex ids
    hold only where it exceeds a stated bound."""
    v = torch.einsum("th,lhd->tld", x.to(torch.float32),
                     rotations.to(torch.float32)).abs()
    top = torch.topk(v, 2, dim=-1).values
    return torch.where(top[..., 0] > 0,
                       (top[..., 0] - top[..., 1])
                       / torch.clamp(top[..., 0], min=1e-30), 1.0)
