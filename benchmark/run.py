"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, the benchmark's
folder and the program (``openmeasure_torch``).  The run makes its inputs
on the card from ``--seed``, builds and warms the cell's own shapes, then
measures for ``--seconds`` (``--trace 0``: the end-to-end metrics) or
traces a few calls (``--trace 1``: the per-layer metrics), compares what
the timed path produced with the plain reference, and prints one JSON
object as the last line of its standard output.  The numbers compared go,
each beside its limit, to the last lines of standard error and, under
``checks``, to the end of the result line.

It exits with a code other than 0 and prints no result where no CUDA card
is present, where the card count is below the cell's, where the program
is not the checkout's own, or where JAX or the JAX package was loaded.
Build caches stay inside the checkout (``build/``).
"""

from __future__ import annotations

import os
import sys
import time


def _process_start() -> float:
    """The process's start on the ``perf_counter`` clock."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        since = time.clock_gettime(time.CLOCK_BOOTTIME) - started
        return now - max(0.0, since)
    except (OSError, ValueError, IndexError):
        return now


T_START = _process_start()
FORBIDDEN = ("jax", "jaxlib", "flax", "openmeasure_tpu")


def _fail(msg: str, code: int) -> int:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    import argparse
    from pathlib import Path
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    checkout = Path(__file__).resolve().parent.parent
    build = checkout / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    sys.path.insert(0, str(checkout))

    import json
    import torch
    torch.set_num_threads(1)
    from benchmark import harness, tracing

    try:
        spec = json.loads((checkout / "BENCHMARK.json").read_text())
        chips = {w["name"]: w["chips"] for w in spec["workloads"]}[
            args.workload]
    except (OSError, KeyError, ValueError) as e:
        return _fail(f"no workload {args.workload!r} in BENCHMARK.json "
                     f"({e!r})", 2)
    if not torch.cuda.is_available():
        return _fail("no CUDA card is available", 3)
    if torch.cuda.device_count() < chips:
        return _fail(f"{args.workload} needs {chips} cards, "
                     f"{torch.cuda.device_count()} present", 3)
    try:
        import openmeasure_torch
    except ImportError as e:
        return _fail(f"the program (openmeasure_torch) is missing: {e}", 4)
    where = Path(openmeasure_torch.__file__).resolve()
    if checkout not in where.parents:
        return _fail(f"openmeasure_torch comes from {where}, not from the "
                     f"checkout {checkout}", 4)
    print(f"benchmark: card {tracing.card_line(0)}; rooflines against the "
          "published H100 SXM peaks (3.35 TB/s, 67 TFLOP/s fp32)",
          file=sys.stderr, flush=True)

    result = harness.run_cell(checkout, args.workload, args.seed,
                              args.seconds, bool(args.trace),
                              device="cuda", t_start=T_START)
    found = sorted({m.split(".")[0] for m in sys.modules}
                   & set(FORBIDDEN))
    if found:
        return _fail(f"modules loaded that the port must not load: "
                     f"{', '.join(found)}", 5)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
