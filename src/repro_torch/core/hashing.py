"""Locality-sensitive hashing (counterpart of ``repro/core/hashing.py``).

Only the rotation initializer is ported so far, so that the MoE params hold
``lsh_rot`` as the JAX package's do; the hashing itself (the ``lsh_hash``
kernel) comes with the training slice.
"""
from __future__ import annotations

import torch


def make_rotations(generator: torch.Generator, num_hashes: int, d_model: int,
                   rotation_dim: int, dtype=torch.bfloat16,
                   device=None) -> torch.Tensor:
    """[L, H, Dr] random Gaussian rotations scaled by 1/sqrt(H)."""
    r = torch.randn((num_hashes, d_model, rotation_dim), generator=generator,
                    dtype=torch.float32, device=device) / d_model ** 0.5
    return r.to(dtype)
