"""Summaries of a ``torch.profiler`` run over a few steps: device busy time
per step (the sum of the CUDA kernels' durations; one stream, so kernels
do not overlap), the device's idle share of the host-clock wall time, the
host time in kernel launch calls, and the top ops by device and by host
time.  Shared by ``profile_decode`` and
``chip_smoke.py``'s training profile."""
from __future__ import annotations

from typing import Dict, List, Tuple


def summarize(prof, steps: int, wall_ms: float,
              top: int = 12) -> Tuple[Dict, List[str]]:
    """(record, lines): record holds device_busy_ms_per_step,
    device_idle_share (None when the trace holds no device events: not
    measured), device_kernels_per_step, and host_launch_ms_per_step and
    host_launches_per_step (the host's own time in the CUDA runtime's and
    driver's kernel launch calls, PyTorch's and the port's kernels alike);
    lines are one per top op."""
    from torch.autograd import DeviceType

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = idle = None
    if kernels:
        busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 \
            / steps
        idle = max(0.0, 1.0 - busy_ms / wall_ms)
    avgs = prof.key_averages()
    launch = [a for a in avgs
              if a.key.startswith(("cudaLaunchKernel", "cuLaunchKernel",
                                   "cudaLaunchCooperativeKernel"))]
    by_dev = sorted(avgs, key=lambda a: a.self_device_time_total,
                    reverse=True)[:top]
    by_cpu = sorted(avgs, key=lambda a: a.self_cpu_time_total,
                    reverse=True)[:top]
    lines = [f"[device] {a.self_device_time_total / 1e3 / steps:9.4f} "
             f"ms/step  {a.count / steps:7.1f} calls/step  {a.key}"
             for a in by_dev]
    lines += [f"[host]   {a.self_cpu_time_total / 1e3 / steps:9.4f} "
              f"ms/step  {a.count / steps:7.1f} calls/step  {a.key}"
              for a in by_cpu]
    return {"wall_ms_per_step": wall_ms,
            "device_busy_ms_per_step": busy_ms,
            "device_idle_share": idle,
            "device_kernels_per_step": len(kernels) / steps,
            "host_launch_ms_per_step":
                sum(a.self_cpu_time_total for a in launch) / 1e3 / steps,
            "host_launches_per_step":
                sum(a.count for a in launch) / steps}, lines
