"""The readings that a cell's limits are set from: for each seed, a short
window at the cell's own load, then the compared numbers of the program
(its outputs against the float64 reference) and of the control (the
reference in float32 with TF32 products, put in the program's place).

    python3 benchmark/readings.py --workload <cell> --seeds 1 2 3 \
        [--seconds 3] [--control-seeds 3] [--fault <name>] \
        [--device cuda] [--out <file.jsonl>]

One JSON line per seed and side goes to standard output (and ``--out``).
The control runs on the first ``--control-seeds`` seeds.  ``--fault``
plants one of :mod:`benchmark.faults` in the program for the program's
side (its line says ``"side": "fault:<name>"``).  Run it on the card:
TF32 exists only there.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--fault")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    checkout = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(checkout))
    import torch
    from benchmark import faults, harness

    out = open(args.out, "a") if args.out else None
    for k, seed in enumerate(args.seeds):
        t = time.perf_counter()
        ctx = harness.load_ctx(checkout, args.workload, seed, args.device)
        drv = harness.driver(ctx)
        undo = faults.plant(args.fault) if args.fault else None
        try:
            state = drv.setup(ctx)
            w = harness.run_window(drv, ctx, state, args.seconds, 10 ** 9,
                                   int(ctx.mix.get("sample", 1)))
            ev = drv.evidence(ctx, state, w.kept)
        finally:
            if undo:
                undo()
        del state, w
        gc.collect()
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        sides = ["program"] + (["control"] if k < args.control_seeds else [])
        for side in sides:
            nums = harness.compare(drv, ctx, ev, side)
            tag = (f"fault:{args.fault}" if args.fault and side == "program"
                   else side)
            line = json.dumps({"workload": args.workload, "seed": seed,
                               "side": tag, "numbers": nums,
                               "seconds": time.perf_counter() - t})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
        del ev
        gc.collect()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
