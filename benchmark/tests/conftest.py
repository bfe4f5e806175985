"""Shared helpers of the benchmark's tests: the checkout on ``sys.path``,
the tiny sizes at which every cell runs on the CPU, and a copy of the
benchmark that a test may add files to."""

import shutil
import sys
from pathlib import Path

import pytest

CHECKOUT = Path(__file__).resolve().parents[2]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

# configuration keys replaced on the CPU: the same flows, a few hundred
# cells per feature instead of the published 18,362 and 191,511
TINY = {"flame2d": {"n_cells": 300}, "flame3d": {"n_cells": 400}}

# a cell whose files are in the benchmark but that BENCHMARK.json does not
# list while the program's fp32 posterior σ is at fault (PERF.md): its
# entries, which the tests merge into a copy of BENCHMARK.json
GP = "flame2d.gpr_fit"
UNLISTED = {
    "workloads": [{"name": GP, "config": "flame2d", "traffic": "gpr_fit",
                   "chips": 1, "why": "GPR fit, train, predict and "
                   "reconstruct back to back: the Adam loop and chol.cu"}],
    "end_to_end": [{"name": "gp_train_s", "unit": "s", "better": "lower",
                    "bound": 0.25, "source": "host_clock",
                    "workloads": [GP]}],
    "per_layer": [
        {"name": name, "unit": unit, "better": better,
         "source": source, "layer": layer, "moves": "gp_train_s",
         "workloads": [GP]}
        for name, unit, better, source, layer in [
            ("gp.ms_per_iter", "ms", "lower", "program_counter",
             "GP trainer (gp/exact_gp.py, gp/gpr.py)"),
            ("gp.launches_per_iter", "launches", "lower", "device_trace",
             "GP trainer (gp/exact_gp.py, gp/gpr.py)"),
            ("chol_roofline", "%", "higher", "device_trace",
             "kernel csrc/chol.cu"),
            ("device_idle.gp", "%", "lower", "device_trace", "device")]],
}


def tiny(cell: str, **more) -> dict:
    cfg = cell.split(".")[0]
    return dict(TINY[cfg], **more)


def listing(cell: str, tmp_path: Path) -> Path:
    """A checkout that lists ``cell``: the real one where BENCHMARK.json
    lists it, else a copy of the benchmark under ``tmp_path`` whose
    BENCHMARK.json also holds the cell's entries of ``UNLISTED``."""
    import json
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    if cell in {w["name"] for w in bench["workloads"]}:
        return CHECKOUT
    root = _copy(tmp_path)
    for group, entries in UNLISTED.items():
        bench[group] += [e for e in entries
                         if cell in (e["name"], *e.get("workloads", ()))]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _copy(dest: Path) -> Path:
    shutil.copy(CHECKOUT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(CHECKOUT / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return dest


@pytest.fixture
def bench_copy(tmp_path):
    """A checkout of the benchmark alone (``BENCHMARK.json`` and its
    folder) under ``tmp_path``; the program is imported from the real
    checkout."""
    return _copy(tmp_path)


@pytest.fixture
def one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
