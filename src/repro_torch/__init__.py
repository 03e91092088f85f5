"""PyTorch + CUDA port of the LSH-MoE system (the JAX package ``repro`` is
the reference it is held against).

Module names mirror ``repro``'s, so each file names its counterpart.  Entry
points run on the CUDA device unless the caller asks for the CPU; with no
CUDA device and no explicit CPU request they raise (``resolve_device``).
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the CUDA device.  A CUDA request without a CUDA device
    raises; the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; pass "
            "device='cpu' (or --device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
