"""On the card, at each cell's own size: the control (the plain
reference computed in float32 with TF32 products, put in the program's
place) comes out not correct, and the program on the same seed comes out
correct.  Skips without a card; run it on the card with

    python -m pytest benchmark/tests/test_bench_control.py -m cuda
"""

import json

import pytest
import torch

from conftest import CHECKOUT

CELLS = [w["name"] for w in json.loads(
    (CHECKOUT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 products exist only there")
    import gc
    import openmeasure_torch  # noqa: F401  (the program's precision pins)
    from benchmark import harness
    ctx = harness.load_ctx(CHECKOUT, cell, 987654321, "cuda")
    drv = harness.driver(ctx)
    state = drv.setup(ctx)
    w = harness.run_window(drv, ctx, state, 2.0, 10 ** 9,
                           int(ctx.mix.get("sample", 1)))
    ev = drv.evidence(ctx, state, w.kept)
    del state, w
    gc.collect()
    ok, checks = harness.judge(harness.compare(drv, ctx, ev, "program"),
                               ctx.limits)
    assert ok, checks
    ok, checks = harness.judge(harness.compare(drv, ctx, ev, "control"),
                               ctx.limits)
    assert not ok, checks
