"""Each kernel's work from its shapes, and the chip's published peaks.

``roofline/<kernel>.py`` gives ``KERNEL`` (the substring that names the
kernel in a device trace) and ``work(shape) -> (operations, bytes)``: the
operations the algorithm needs and each input byte read once and each
output byte written once, so that a kernel a later change rewrites is held
to the same work.  :func:`bound_s` is the least time the chip could take.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def peaks() -> dict:
    return json.loads((HERE / "peaks.json").read_text())


def kernel(name: str):
    """The module ``roofline/<name>.py``."""
    path = HERE / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_roofline_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bound_s(ops: float, nbytes: float) -> float:
    """The larger of ``ops`` at the fp32 peak and ``nbytes`` at the HBM
    rate, in seconds."""
    p = peaks()
    return max(ops / p["fp32_flops_per_s"], nbytes / p["hbm_bytes_per_s"])
