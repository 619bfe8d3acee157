"""The card a measurement names (``nvidia-smi``'s name and power limit) and
the device time of a call under ``torch.profiler``."""
from __future__ import annotations

import subprocess

__all__ = ["nvidia_smi_name_power", "device_ms"]


def device_ms(fn, reps: int = 20) -> float:
    """Kernel time per call on the card: the profiler's device time summed
    over every kernel the call launched, mean of ``reps`` calls after one
    warm-up call.  A profile that comes back without device events (seen
    about once in a hundred profiles taken in a row) is taken again."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "self_device_time_total", 0)
                 for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / reps
    raise AssertionError("the profiler recorded no device time")


def nvidia_smi_name_power() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` for
    the first card, e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]
