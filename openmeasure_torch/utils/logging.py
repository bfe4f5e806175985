"""Structured logging and profiling hooks (port of
``openmeasure_tpu/utils/logging.py``): a stdlib logger, a wall-clock
context manager, and a device trace over ``torch.profiler`` where the JAX
package wraps ``jax.profiler``."""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Iterator, Optional

logger = logging.getLogger("openmeasure_torch")
if not logger.handlers:  # don't double-configure under pytest reimports
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter(
        "%(asctime)s %(name)s %(levelname)s %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.WARNING)


def set_verbosity(level: int) -> None:
    """level: logging.DEBUG/INFO/WARNING/..."""
    logger.setLevel(level)


@contextlib.contextmanager
def timed(label: str, verbose: bool = True) -> Iterator[None]:
    """Wall-clock a block; logs at INFO."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if verbose:
        logger.info("%s: %.4f s", label, dt)


@contextlib.contextmanager
def device_trace(logdir: Optional[str] = None) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the block (the host, and the
    card when one is present) and write it to ``logdir`` as a Chrome
    trace (view with Perfetto or TensorBoard).  No-op if logdir is
    None."""
    if logdir is None:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
