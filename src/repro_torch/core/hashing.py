"""Locality-sensitive hashing, paper §2.3 and §3.2 (counterpart of
``repro/core/hashing.py``).

Cross-polytope hashing maps x, under each of L random rotations, to one of
2·Dr vertices (the ``lsh_hash`` kernel); spherical hashing takes the sign
pattern of L hyperplanes and stays plain torch, as in JAX.  The L per-hash
ids fold into one int32 bucket id.  The input is detached, as the JAX
package's ``stop_gradient``: the hash carries no gradient.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch

_FOLD_MULT = 1000003  # large odd multiplier for bucket-id folding


def make_rotations(generator: torch.Generator, num_hashes: int, d_model: int,
                   rotation_dim: int, dtype=torch.bfloat16,
                   device=None) -> torch.Tensor:
    """[L, H, Dr] random Gaussian rotations scaled by 1/sqrt(H)."""
    r = torch.randn((num_hashes, d_model, rotation_dim), generator=generator,
                    dtype=torch.float32, device=device) / d_model ** 0.5
    return r.to(dtype)


def cross_polytope_hash(x: torch.Tensor,
                        rotations: torch.Tensor) -> torch.Tensor:
    """x: [..., H]; rotations: [L, H, Dr] -> int32 bucket ids [...].

    JAX casts x and the rotations to f32 before the kernel; the port hands
    them over in their own dtypes (bf16 values are exact in f32), which
    saves an f32 copy of x and lets bf16 inputs use the tensor cores."""
    xd = x.detach()
    lead = xd.shape[:-1]
    vertex = dispatch.lsh_hash(xd.reshape(-1, xd.shape[-1]).contiguous(),
                               rotations.detach())
    return _fold(vertex.reshape(*lead, rotations.shape[0]))


def spherical_hash(x: torch.Tensor, rotations: torch.Tensor) -> torch.Tensor:
    """Sign-pattern (hyperplane) hashing; uses column 0 of each rotation."""
    rot = rotations.detach().to(torch.float32)[..., 0]          # [L, H]
    xf = x.detach().to(torch.float32)
    bits = (torch.einsum("...h,lh->...l", xf, rot) >= 0).to(torch.int32)
    return _fold(bits)


def _fold(per_hash_ids: torch.Tensor) -> torch.Tensor:
    """[..., L] int32 -> [...] int32 via iterated affine folding.  int32
    tensors throughout, so the products wrap on overflow as JAX's do (a
    Python int scalar does not widen an int32 tensor in torch; a tensor
    multiplier would cost a host-to-device copy per call)."""
    ids = per_hash_ids.to(torch.int32)
    out = torch.zeros(ids.shape[:-1], dtype=torch.int32, device=ids.device)
    for l in range(ids.shape[-1]):
        out = out * _FOLD_MULT + ids[..., l]
    return out


def lsh_hash(x: torch.Tensor, rotations: torch.Tensor,
             hash_type: str) -> torch.Tensor:
    if hash_type == "cross_polytope":
        return cross_polytope_hash(x, rotations)
    if hash_type == "spherical":
        return spherical_hash(x, rotations)
    raise ValueError(f"unknown hash_type {hash_type}")
