"""Device datasheet constants (counterpart of ``repro/hw.py``), the one home
for the peak rates the port's analytic models price against: the modeled
phase split (obs/timeline.py), the comm cost model's link priors
(comm/topology.py) and the kernel bounds of ``chip_smoke.py``.

The part is the NVIDIA H100 SXM5 80 GB, from the NVIDIA H100 Tensor Core
GPU datasheet: 989.4 TFLOP/s of dense bf16 on the tensor cores (1,979
with 2:4 sparsity), 67 TFLOP/s of f32 outside them, 3.35 TB/s of HBM3,
and 900 GB/s of NVLink 4 per GPU counting both directions, so 450 GB/s
each way.  A card run below its 700 W limit runs slower than these.

The measured counterparts live elsewhere: ``tune/`` fits the link
constants of a mesh from probes, and ``obs/profile.py`` measures the
per-phase device seconds from a ``torch.profiler`` trace; the constants
below are the uncalibrated fallback.
"""
from __future__ import annotations

DEVICE_FLOPS = 989.4e12         # bf16 dense tensor-core peak, FLOP/s
FP32_FLOPS = 67e12              # f32 outside the tensor cores, FLOP/s
HBM_BYTES_PER_S = 3.35e12       # HBM3, B/s
NVLINK_BYTES_PER_S = 450e9      # NVLink 4, each way, B/s
