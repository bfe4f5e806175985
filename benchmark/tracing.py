"""The traced run: a ``torch.profiler`` window over a few timed calls, the
benchmark's spans around the program's layers, and the reductions of the
trace that the per-layer metrics and the ``breakdown`` read.

Spans: for a traced run the harness wraps the functions a traffic kind
names (``"module:attribute"``, the program's layer entry points) in
``record_function`` ranges named ``layer:<module>.<attribute>``, from the
benchmark's own files; nothing of the program is edited.  The window runs,
on the host's clock, from just before the first traced call to just after
the last synchronization; a few small launches go first, because a trace
can miss its first device events.

Reductions, in seconds: the device's busy time is the union of the device
operations' intervals inside the window; each idle gap between them is
put down to the innermost host range (a span or an operator) open at its
middle, "python" where none is.
"""

from __future__ import annotations

import contextlib
import heapq
import importlib
import shutil
import subprocess
import time
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

WINDOW = "bench.window"
NAME_CHARS = 160        # a kernel's name in the breakdown, cut to this


@contextlib.contextmanager
def layer_spans(targets):
    """Wrap each ``"module:attribute"`` (or ``"module:Class.method"``) of
    ``targets`` in a ``record_function`` range for the duration of the
    block."""
    from torch.profiler import record_function
    saved = []

    def wrap(fn, name):
        def spanned(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return spanned

    try:
        for t in targets:
            mod_name, path = t.split(":")
            owner = importlib.import_module(mod_name)
            *outer, attr = path.split(".")
            for part in outer:                 # "Class.method"
                owner = getattr(owner, part)
            fn = getattr(owner, attr)
            short = mod_name.split(".")[-1]
            saved.append((owner, attr, fn))
            setattr(owner, attr, wrap(fn, f"layer:{short}.{path}"))
        yield
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)


@dataclass
class Trace:
    """What a traced window holds.  Times in seconds from the window's
    start."""
    window_s: float
    device_ops: List[Tuple[str, float, float]]      # (name, start, end)
    host_ranges: List[Tuple[str, float, float]]   # (name, start, end)
    call_walls: List[float] = field(default_factory=list)
    counters: Dict[str, object] = field(default_factory=dict)

    def kernels(self, contains: Optional[str] = None):
        """Device kernels (no copies or fills), optionally those whose name
        holds ``contains``."""
        return [e for e in self.device_ops
                if not e[0].startswith(("Memcpy", "Memset"))
                and (contains is None or contains in e[0])]

    def busy_s(self, start: float = 0.0, end: Optional[float] = None
               ) -> float:
        """Union of the device operations' intervals within [start, end]."""
        end = self.window_s if end is None else end
        busy, cur = 0.0, None
        for _, s, e in sorted(self.device_ops, key=lambda x: x[1]):
            s, e = max(s, start), min(e, end)
            if e <= s:
                continue
            if cur is None or s > cur[1]:
                if cur is not None:
                    busy += cur[1] - cur[0]
                cur = [s, e]
            else:
                cur[1] = max(cur[1], e)
        if cur is not None:
            busy += cur[1] - cur[0]
        return busy

    def idle_pct(self) -> Optional[float]:
        """The device's idle share of the window in %, ``None`` where the
        trace holds no device operation (no card)."""
        if not self.device_ops or self.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def idle_gaps(self) -> List[Tuple[float, float]]:
        """The intervals of the window in which no device operation ran."""
        gaps, at = [], 0.0
        for _, s, e in sorted(self.device_ops, key=lambda x: x[1]):
            if s > at:
                gaps.append((at, min(s, self.window_s)))
            at = max(at, e)
        if at < self.window_s:
            gaps.append((at, self.window_s))
        return [g for g in gaps if g[1] > g[0]]

    def top_device_ops(self, n: int = 10) -> List[List]:
        by = defaultdict(float)
        for name, s, e in self.device_ops:
            by[name] += e - s
        return [[k[:NAME_CHARS], v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])][:n]

    def top_idle_gaps(self, n: int = 10) -> List[List]:
        """Idle seconds by what the host was doing: the innermost host
        range open at each gap's middle, with the innermost benchmark span
        around it first (``span > operator``)."""
        ranges = sorted(self.host_ranges, key=lambda x: x[1])
        by = defaultdict(float)
        spans, ops, i = [], [], 0          # max-heaps on the start time
        for a, b in sorted(self.idle_gaps()):
            mid = 0.5 * (a + b)
            while i < len(ranges) and ranges[i][1] <= mid:
                name, s, e = ranges[i]
                heapq.heappush(spans if name.startswith("layer:") else ops,
                               (-s, e, name))
                i += 1
            label = []
            for heap in (spans, ops):
                while heap and heap[0][1] < mid:   # ended: never open again
                    heapq.heappop(heap)
                if heap:
                    label.append(heap[0][2])
            by[" > ".join(label) or "python"] += b - a
        return [[k[:NAME_CHARS], v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])][:n]


def trace_calls(run: Callable[[], None], device: torch.device,
                host: bool, warm: Callable[[], None] = lambda: None
                ) -> Trace:
    """Profile ``run`` (the traced calls, synchronized inside); returns the
    window's :class:`Trace`.  The window runs from just before the first
    call to the return of the last synchronization, on the host's clock,
    which the profiler's events share (Unix time in ns).  ``host=False``
    records the device alone: recording the host's operators slows the
    host's dispatch severalfold, so the device's busy and idle shares come
    from such a trace, and the host's ranges from a second one.  ``warm``
    runs inside the profile before the window opens: the profiler's own
    start-up (its buffers, the first records) lands on the first call it
    sees, and the window should not hold it."""
    from torch.profiler import ProfilerActivity, profile, record_function
    on_card = device.type == "cuda"
    acts = ([ProfilerActivity.CPU] if host or not on_card else []) + (
        [ProfilerActivity.CUDA] if on_card else [])
    lead = torch.zeros(1, device=device)
    with profile(activities=acts) as prof:
        for _ in range(8):
            lead.add_(1.0)
        warm()
        _sync(device)
        t0 = time.time_ns()
        with record_function(WINDOW):
            run()
            _sync(device)
        t1 = time.time_ns()
    Dev = torch.autograd.DeviceType
    dev_ops, host_ranges = [], []
    for e in prof.profiler.kineto_results.events():
        s, en = e.start_ns(), e.end_ns()
        if s < t0 or s >= t1 or e.name() == WINDOW:
            continue
        rel = ((s - t0) * 1e-9, (min(en, t1) - t0) * 1e-9)
        if e.device_type() == Dev.CUDA:
            if not e.is_user_annotation():
                dev_ops.append((e.name(), *rel))
        else:
            host_ranges.append((e.name(), *rel))
    return Trace((t1 - t0) * 1e-9, dev_ops, host_ranges)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class SmiSampler:
    """``nvidia-smi`` sampling the card's clocks, power, power limit and
    temperature every 200 ms into ``path`` while the block runs."""

    QUERY = ("timestamp,name,clocks.sm,clocks.mem,power.draw,power.limit,"
             "temperature.gpu")

    def __init__(self, path: Path, index: int = 0):
        self.path, self.index, self.proc, self.fh = path, index, None, None

    def __enter__(self):
        exe = shutil.which("nvidia-smi")
        if exe is not None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self.fh = open(self.path, "w")
            self.proc = subprocess.Popen(
                [exe, f"--query-gpu={self.QUERY}", "--format=csv",
                 f"--id={self.index}", "-lms", "200"],
                stdout=self.fh, stderr=subprocess.DEVNULL)
        return self

    def __exit__(self, *exc):
        if self.proc is not None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        if self.fh is not None:
            self.fh.close()
        return False


def card_line(index: int = 0) -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "nvidia-smi not found"
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader",
         f"--id={index}"], capture_output=True, text=True, timeout=30)
    return out.stdout.strip() or out.stderr.strip()
