"""A kernel's device time, read from ``torch.profiler``'s trace.

The scripts that measure the port on the card (``chip_smoke.py``,
``profile_torch.py``) use it; nothing on a user's path calls it.
"""

from __future__ import annotations

import statistics
from typing import Callable, Tuple

import torch


def device_ms(fn: Callable[[], object], name: str, reps: int
              ) -> Tuple[float, int]:
    """Median device time (ms) of the kernels whose name contains ``name``
    over ``reps`` back-to-back calls of ``fn`` after one warm-up call, and
    how many of them the trace holds (it can miss its first few); NaN and
    0 when it holds none.  The host's time per call does not enter."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.end - e.time_range.start for e in prof.events()
          if e.device_type == DeviceType.CUDA and name in e.name]
    return (statistics.median(us) / 1e3 if us else float("nan")), len(us)
