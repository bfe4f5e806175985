"""The benchmark's run of one cell: the specification, the plug-ins found
by name, set-up, the measured or traced window, the comparison with the
plain reference, and the result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric sits in a file of its own, found by the name that
``BENCHMARK.json`` gives:

- ``configs/<config>.json``: the configuration's sizes and precision;
- ``traffic/<traffic>.json``: the mix's parameters, ``kind`` among them;
- ``traffic/<kind>.py``: the driver of that kind of traffic;
- ``workloads/<cell>.json``: the limits of the cell's compared numbers;
- ``metrics/<metric>.py``: the reader of one per-layer metric;
- ``roofline/<kernel>.py``: a kernel's work from its shapes.

A driver module gives ``SPANS`` (the program's layer entry points the
traced run wraps in spans), ``CONFIG_KEYS`` and ``MIX_KEYS`` (the keys of
a configuration and of a mix that it reads) and the functions ``setup``
(build and warm), ``call`` (one timed call), ``end_to_end`` (the cell's
end-to-end metrics from the window), ``counters`` (what the per-layer readers divide by),
``evidence`` (what the comparison needs, taken before the program is
freed), ``outputs`` (the program's judged outputs), ``reference`` (the
plain reference in an arithmetic, optionally following a tested side's
state) and ``compare`` (the numbers); see ``traffic/serve.py``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import random
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import torch

from . import tracing


def load_module(path: Path, tag: str):
    """A Python file of the benchmark as a module of its own."""
    spec = importlib.util.spec_from_file_location(tag, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no such file: {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Ctx:
    """One run's cell, its files' contents, seed and device."""
    cell: str
    spec: dict                 # the cell's entry of BENCHMARK.json
    bench: dict                # all of BENCHMARK.json
    config: dict
    mix: dict
    limits: dict
    seed: int
    device: torch.device
    root: Path                 # the benchmark's folder
    checkout: Path             # the folder BENCHMARK.json is in

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.config["dtype"])


def load_ctx(checkout: Path, cell: str, seed: int, device,
             overrides: Optional[dict] = None) -> Ctx:
    """The cell's context from ``checkout/BENCHMARK.json`` and the
    benchmark's files; ``overrides`` replaces configuration keys (the CPU
    tests' tiny sizes)."""
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell not in cells:
        raise KeyError(f"no workload named {cell!r} in BENCHMARK.json")
    spec = cells[cell]
    root = checkout / bench["paths"][0]
    config = json.loads((root / "configs" / f"{spec['config']}.json")
                        .read_text())
    config.update(overrides or {})
    mix = json.loads((root / "traffic" / f"{spec['traffic']}.json")
                     .read_text())
    cell_file = root / "workloads" / f"{cell}.json"
    limits = (json.loads(cell_file.read_text()).get("limits", {})
              if cell_file.exists() else {})
    return Ctx(cell, spec, bench, config, mix, limits, int(seed),
               torch.device(device), root, checkout)


# keys that every configuration and every mix may hold besides those that
# its driver reads (``CONFIG_KEYS``, ``MIX_KEYS``): the configuration's
# name, provenance and precision, and what the harness reads of a mix
CONFIG_COMMON = {"name", "source", "reduced", "assumed", "dtype", "tf32"}
MIX_COMMON = {"kind", "sample", "trace_calls"}


def driver(ctx: Ctx):
    """The driver of the cell's kind of traffic.  A key of the
    configuration that no driver reads, or of the mix that its driver
    does not read, is refused, so that a file never says what a run does
    not do; and the configuration's
    precision is set: TF32 products on or off as ``tf32`` states (after
    the program's import, which pins them off)."""
    drivers = {p.stem: load_module(p, f"bench_traffic_{p.stem}")
               for p in sorted((ctx.root / "traffic").glob("*.py"))}
    drv = drivers[ctx.mix["kind"]]
    # a configuration serves cells of several kinds: a key of it counts
    # as read where any driver reads it
    read = set().union(*(d.CONFIG_KEYS for d in drivers.values()))
    for what, have, known in (
            ("configuration", ctx.config, CONFIG_COMMON | read),
            ("traffic mix", ctx.mix, MIX_COMMON | drv.MIX_KEYS)):
        extra = sorted(set(have) - known)
        if extra:
            raise ValueError(f"the {what} of {ctx.cell} has keys that "
                             f"nothing reads: {', '.join(extra)}")
    import openmeasure_torch  # noqa: F401
    tf32 = bool(ctx.config["tf32"])
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    return drv


def applies(metric: dict, cell: str) -> bool:
    """Whether a metric of BENCHMARK.json is reported in ``cell``."""
    return "workloads" not in metric or cell in metric["workloads"]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Window:
    """The calls of a measured or traced window."""
    t0: float = 0.0
    t1: float = 0.0
    submit: List[float] = field(default_factory=list)
    done: List[float] = field(default_factory=list)
    failed: int = 0
    kept: List[tuple] = field(default_factory=list)   # (index, output)

    @property
    def calls(self) -> int:
        return len(self.done)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    @property
    def latencies(self) -> List[float]:
        return [d - s for s, d in zip(self.submit, self.done)]


def run_window(drv, ctx: Ctx, state, seconds: float, max_calls: int,
               keep: int) -> Window:
    """Closed loop: each call starts when the one before it has ended on
    the device; calls start until ``seconds`` have passed (or
    ``max_calls`` are made; at least one is), and the window ends when
    the last call ends.  ``keep`` outputs are kept, drawn uniformly from
    the calls by a reservoir seeded from the run's seed."""
    rng = random.Random(ctx.seed * 7919 + 17)
    w = Window()
    # the cyclic collector stays off in the window: its pauses are not
    # the program's (reference counting still frees every tensor)
    gc.collect()
    gc.disable()
    try:
        _calls(drv, ctx, state, seconds, max_calls, keep, rng, w)
    finally:
        gc.enable()
    return w


def _calls(drv, ctx, state, seconds, max_calls, keep, rng, w):
    sync(ctx.device)
    w.t0 = time.perf_counter()
    i = 0
    while i < max_calls and (i == 0 or time.perf_counter() - w.t0
                             < seconds):
        t = time.perf_counter()
        try:
            out = drv.call(ctx, state, i)
            sync(ctx.device)
        except RuntimeError:
            w.failed += 1
            i += 1
            continue
        w.submit.append(t)
        w.done.append(time.perf_counter())
        n = w.calls
        if len(w.kept) < keep:
            w.kept.append((i, out))
        else:
            j = rng.randrange(n)
            if j < keep:
                w.kept[j] = (i, out)
        i += 1
    w.t1 = w.done[-1] if w.done else time.perf_counter()


def _finite(v) -> bool:
    return isinstance(v, (int, float)) and math.isfinite(v)


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """``(correct, checks)``: every number that has a limit is compared;
    a cell with no limit, or a number that is missing or not finite, is
    not correct."""
    checks = {}
    ok = bool(limits)
    for name, limit in limits.items():
        v = numbers.get(name)
        checks[name] = {"value": v if _finite(v) else None, "limit": limit}
        if not (_finite(v) and v <= limit):
            ok = False
    return ok, checks


def run_cell(checkout: Path, cell: str, seed: int, seconds: float,
             trace: bool, device="cuda", overrides: Optional[dict] = None,
             t_start: Optional[float] = None, out_dir: Optional[Path] = None
             ) -> dict:
    """One run of ``cell``; returns the result line's object.  ``t_start``
    is the process's start on the ``perf_counter`` clock (set-up is timed
    from it)."""
    t_start = time.perf_counter() if t_start is None else t_start
    ctx = load_ctx(checkout, cell, seed, device, overrides)
    drv = driver(ctx)
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    state = drv.setup(ctx)
    sync(ctx.device)
    keep = int(ctx.mix.get("sample", 1))
    result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}}
    if not trace:
        setup_s = time.perf_counter() - t_start
        w = run_window(drv, ctx, state, seconds, 10 ** 9, keep)
        values = drv.end_to_end(ctx, w)
        values["setup_s"] = setup_s
        for m in ctx.bench["end_to_end"]:
            if applies(m, cell):
                if m["name"] not in values:
                    raise KeyError(f"the {ctx.mix['kind']} driver gives no "
                                   f"{m['name']!r}")
                result["metrics"][m["name"]] = {"value": values[m["name"]],
                                                "unit": m["unit"]}
    else:
        n = int(ctx.mix.get("trace_calls", 1))
        holder = {}

        def traced():
            holder["w"] = run_window(drv, ctx, state, seconds, n, keep)

        def labelled():
            run_window(drv, ctx, state, seconds, 1, 0)

        def warm():
            drv.call(ctx, state, 0)

        smi = (out_dir or checkout / "build" / "benchmark") / \
            f"{cell}-{seed}-smi.csv"
        with tracing.SmiSampler(smi):
            # the device alone over the traced calls, then one call with
            # the host's operators and the benchmark's spans recorded
            tr = tracing.trace_calls(traced, ctx.device, host=False,
                                     warm=warm)
            with tracing.layer_spans(drv.SPANS):
                host_tr = tracing.trace_calls(labelled, ctx.device,
                                              host=True, warm=warm)
        w = holder["w"]
        tr.call_walls = w.latencies
        tr.counters = drv.counters(ctx, state, w)
        for m in ctx.bench["per_layer"]:
            if applies(m, cell):
                reader = load_module(ctx.root / "metrics" / f"{m['name']}.py",
                                     f"bench_metric_{m['name']}")
                v = reader.read(tr, ctx)
                if v is not None:
                    result["metrics"][m["name"]] = {"value": v,
                                                    "unit": m["unit"]}
        if tr.device_ops:
            result["breakdown"] = {"device_ops": tr.top_device_ops(),
                                   "idle_gaps": host_tr.top_idle_gaps()}
    result["attempted"] = w.calls + w.failed
    result["failed"] = w.failed
    dev = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(ctx.device)
                    if ctx.device.type == "cuda" else "cpu"),
           "count": int(ctx.spec["chips"]),
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(ctx.device)
                                 if ctx.device.type == "cuda" else 0)}
    if trace:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
    result["device"] = dev
    # the comparison runs after the peak is read and the program is freed
    ev = drv.evidence(ctx, state, w.kept)
    del state, w
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = compare(drv, ctx, ev, "program")
    result["correct"], result["checks"] = judge(numbers, ctx.limits)
    return result


def compare(drv, ctx: Ctx, ev, side: str) -> Dict[str, float]:
    """The compared numbers of ``side``: ``"program"`` (the program's
    outputs) or ``"control"`` (the reference in the control's arithmetic
    in the program's place), each against the float64 reference, which
    may follow the tested side's state (``follow``) where a driver says
    so."""
    test = (drv.outputs(ctx, ev) if side == "program"
            else drv.reference(ctx, ev, "tf32"))
    ref = drv.reference(ctx, ev, "float64", follow=test)
    return drv.compare(ctx, ev, test, ref)
