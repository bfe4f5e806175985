"""Structured logging and profiling hooks (port of
``openmeasure_tpu/utils/logging.py``): a stdlib logger, the program's own
span and counter recorder, and a device trace over ``torch.profiler``
where the JAX package wraps ``jax.profiler``.

The recorder is off unless a :func:`recording` block is open.  While it
is on, each instrumented layer boundary of the port records a
:class:`Span` (name, start and end on ``time.time_ns()``, the Unix-epoch
clock that ``torch.profiler``'s events carry, the index of its parent
and the call id of its root) and adds to named counters (:func:`count`)
where the work happens::

    with recording() as rec:
        sensor.predict_batch(Y, S)
    rec.spans       # serve.predict_batch > serve.solve, boxls.admm >
                    # boxls.iter × admm_iters, serve.reconstruct
    rec.counters    # e.g. {"host_reads": 2} after a fit on the card

Off, an instrumented site costs one check of a module-level reference:
no clock read, no allocation.  On or off, the recorder launches nothing
on the device and reads nothing back from it.  Spans nest by a stack, so
record one thread at a time.

The spans and counters of the port:

- ``serve.predict_batch`` (root of a served batch), ``serve.solve``,
  ``serve.reconstruct`` (``serving.py``); ``boxls.admm`` and one
  ``boxls.iter`` an ADMM iteration (``linalg/boxls.py``);
- ``fit.spr_end_to_end`` (root of a fit), ``fit.scale``, ``fit.place``,
  ``fit.solve`` (``pipelines.py``); ``svd.gram``, ``svd.eigh``,
  ``svd.panel`` (``linalg/svd.py``);
- ``gpr.fit``, ``gpr.train``, ``gpr.predict``, ``gpr.reconstruct`` (the
  methods of ``gp/gpr.py``'s ``GPR``; ``train`` also of ``PIGPR``);
  ``gp.adam`` (the Adam loop of ``gp/exact_gp.py``) holding one
  ``gp.iter`` an Adam iteration; ``gp.posterior`` (each posterior, inside
  ``gpr.predict`` and a ``GPRSensor`` request);
- counter ``host_reads``: the reads of the card that the host waits on,
  counted where they are made (each ``torch.linalg.eigh`` on the card,
  whose error check reads its ``info``; each stop test of the Adam loop
  on the card, one a block of ``unroll`` iterations).
- counter ``gp.overlapped_reads``: the stop tests of the Adam loop that
  the host read while a later block was already enqueued, so that the
  card kept working while the host waited (``gp/exact_gp.py``'s
  ``_StopTest``): how often that schedule engages.  On the card, where
  the loop captures, it equals the loop's stop tests in ``host_reads``;
  elsewhere it stays 0.
- counter ``boxls.kernel_solves``: the ADMM solves that ran the CUDA
  kernel pair of ``linalg/admm_cuda.py`` instead of the loop.
- counter ``gp.fused_iters``: the Adam iterations of ``gp/exact_gp.py``'s
  trainer that took the two-launch step (``csrc/chol.cu``, then
  ``csrc/gp_step.cu``; ``gp/gp_step.py``), counted on the host: how often
  that route engages.
- counters ``chol.kernel_launches``, ``qrcp.kernel_launches``,
  ``admm.kernel_launches``, ``gp_step.kernel_launches``: the launches of
  the hand-written kernels of ``csrc/`` (:func:`launched`, called by their
  wrappers in ``linalg/chol_cuda.py``, ``linalg/qrcp_cuda.py``,
  ``linalg/admm_cuda.py`` and ``gp/gp_step.py``).

A CUDA graph's capture launches nothing: while the trainer captures one
(:func:`capture_tally`), the counts of the block go to a tally instead, which
each replay of the graph adds again (:func:`count_all`).
"""

from __future__ import annotations

import contextlib
import functools
import json
import logging
import time
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

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


@dataclass
class Span:
    """One recorded interval.  Times in ns on ``time.time_ns()``."""
    name: str
    start_ns: int
    end_ns: int         # 0 while the span is open
    parent: int         # index of the enclosing span, -1 for a root
    call: int           # index of the root span: one id a request or fit


class Recording:
    """What the recorder holds while it is on: the spans in the order
    they began, and the counters by name."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}
        self._open: List[int] = []

    def begin(self, name: str) -> int:
        """Open a span under the innermost open one; returns its index."""
        i = len(self.spans)
        parent = self._open[-1] if self._open else -1
        call = self.spans[parent].call if parent >= 0 else i
        self.spans.append(Span(name, time.time_ns(), 0, parent, call))
        self._open.append(i)
        return i

    def end(self, i: int) -> None:
        """Close span ``i``, and any span opened inside it that an
        exception left open (its end stays 0)."""
        self.spans[i].end_ns = time.time_ns()
        if i in self._open:
            del self._open[self._open.index(i):]


_REC: Optional[Recording] = None      # the open recording; None is off


def recorder() -> Optional[Recording]:
    """The open :class:`Recording`, or ``None`` while the recorder is off.
    A loop takes it once and guards each iteration's span inline."""
    return _REC


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """Turn the recorder on for the block; yields the block's
    :class:`Recording`.  A nested block records apart and hands the
    outer one back on exit."""
    global _REC
    outer, _REC = _REC, Recording()
    try:
        yield _REC
    finally:
        _REC = outer


class _Spanned:
    __slots__ = ("rec", "name", "i")

    def __init__(self, rec: Recording, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        self.i = self.rec.begin(self.name)

    def __exit__(self, *exc):
        self.rec.end(self.i)
        return False


_OFF = contextlib.nullcontext()


def span(name: str):
    """A span around the ``with`` block while the recorder is on; off,
    the shared no-op context."""
    return _OFF if _REC is None else _Spanned(_REC, name)


def spanned(name: str):
    """Decorator: each call of the function is one span ``name`` while the
    recorder is on."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


_TALLY: Optional[Dict[str, int]] = None   # the counts of a graph's capture


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while the recorder is on; while a
    CUDA graph is captured (:func:`capture_tally`), to the capture's tally
    instead."""
    counts = _TALLY if _TALLY is not None else \
        None if _REC is None else _REC.counters
    if counts is not None:
        counts[name] = counts.get(name, 0) + n


def launched(kernel: str, n: int = 1) -> None:
    """Count ``n`` launches of the hand-written kernel ``kernel``
    (``"chol"``, ``"qrcp"``, ``"admm"``, ``"gp_step"``) in counter
    ``<kernel>.kernel_launches``, as :func:`count` does."""
    count(kernel + ".kernel_launches", n)


@contextlib.contextmanager
def capture_tally() -> Iterator[Dict[str, int]]:
    """For the capture of a CUDA graph, which runs nothing: yields the
    tally that holds the block's counts in place of the recorder, for each
    replay of the graph to add (:func:`count_all`)."""
    global _TALLY
    outer, _TALLY = _TALLY, {}
    try:
        yield _TALLY
    finally:
        _TALLY = outer


def count_all(tally: Dict[str, int]) -> None:
    """Add each count of ``tally``, as :func:`count` does: a captured
    graph's counts, once a replay."""
    if _REC is not None or _TALLY is not None:
        for name, n in tally.items():
            count(name, n)


def _write_spans(rec: Recording, path: str, base_ns: int) -> None:
    """``rec``'s spans as Chrome-trace complete events (µs from
    ``base_ns``, the origin ``torch.profiler``'s export gives its own
    trace; index, parent and call id in their ``args``), and its
    counters."""
    events = [{"name": s.name, "ph": "X", "pid": "spans", "tid": 0,
               "ts": (s.start_ns - base_ns) / 1e3,
               "dur": (max(s.end_ns, s.start_ns) - s.start_ns) / 1e3,
               "args": {"index": i, "parent": s.parent, "call": s.call}}
              for i, s in enumerate(rec.spans)]
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "baseTimeNanoseconds": base_ns,
                   "counters": rec.counters}, f)


@contextlib.contextmanager
def device_trace(logdir: Optional[str] = None) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the block (the host, and the
    card when one is present) and write it to ``logdir`` as a Chrome
    trace (view with Perfetto or TensorBoard), with the recorder on: its
    spans go beside it as ``spans.json``, on the trace's clock and
    origin.  No-op if logdir is None."""
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
    with recording() as rec, profile(activities=activities) as prof:
        yield
    trace = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        base = json.load(f).get("baseTimeNanoseconds", 0)
    _write_spans(rec, os.path.join(logdir, "spans.json"), int(base))
