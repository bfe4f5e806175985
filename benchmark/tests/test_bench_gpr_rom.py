"""The ``flame2d.gpr_rom`` cell's traffic module (``traffic/gpr_rom.py``)
at a tiny size on the CPU: the campaigns it makes from the seed, the
float64 reference against the program, the evidence taken from the kept
call's campaign, the recorded flow of its counters, and the reader
``metrics/gp.host_reads_per_iter.py``."""

import pytest
import torch

from conftest import CHECKOUT, tiny

CELL = "flame2d.gpr_rom"
SEED = 2 ** 31 + 4321


def _ctx(max_iter=30):
    from benchmark import harness
    ctx = harness.load_ctx(CHECKOUT, CELL, SEED, "cpu", tiny(CELL))
    ctx.mix["max_iter"] = max_iter
    return ctx, harness.driver(ctx)


def test_campaigns_are_seeded_and_distinct(one_thread):
    ctx, drv = _ctx()
    a, b = drv.setup(ctx), drv.setup(ctx)
    n = ctx.mix["campaigns"]
    assert len(a["campaigns"]) == n == 8
    for ca, cb in zip(a["campaigns"], b["campaigns"]):
        assert torch.equal(ca["X"], cb["X"]) and torch.equal(ca["P"], cb["P"])
    X = [c["X"] for c in a["campaigns"]]
    assert all(x.shape == (9 * 300, 41) for x in X)
    assert all(not torch.equal(X[0], x) for x in X[1:])


@pytest.mark.parametrize("i", [0, 5, 13])
def test_reference_agrees_and_evidence_follows_the_kept_call(i, one_thread):
    """The kept call i's evidence holds campaign i mod 8's snapshots, and
    the float64 reference agrees with the program there: every compared
    number within the cell's limits."""
    from benchmark import harness
    ctx, drv = _ctx()
    state = drv.setup(ctx)
    out = drv.call(ctx, state, i)
    ev = drv.evidence(ctx, state, [(i, out)])
    camp = state["campaigns"][i % 8]
    assert ev["X"] is camp["X"] and ev["Pt"] is camp["Pt"]
    ok, checks = harness.judge(harness.compare(drv, ctx, ev, "program"),
                               ctx.limits)
    assert ok, checks


def test_counters_record_one_more_flow(one_thread):
    """The counters' recorded flow runs the traced call's campaign to its
    stop: its Adam iterations are the ``gp.iter`` spans, at least the
    slowest mode's count; on the CPU no card is read."""
    from benchmark.harness import Window
    ctx, drv = _ctx()
    state = drv.setup(ctx)
    out = drv.call(ctx, state, 3)
    w = Window(kept=[(3, out)], done=[1.0])
    c = drv.counters(ctx, state, w)
    slowest = int(out[0]._iterations.max())
    assert c["trainings"] == 1 and c["iterations"] == slowest
    assert c["chol_shape"] == (14, 41)
    assert slowest <= c["gp_iters"] <= ctx.mix["max_iter"]
    assert c["gp_iters"] % 4 == 0 or c["gp_iters"] == ctx.mix["max_iter"]
    assert c["host_reads"] == 0


def _reader():
    from benchmark.harness import load_module
    return load_module(CHECKOUT / "benchmark" / "metrics"
                       / "gp.host_reads_per_iter.py", "bench_metric_hr")


@pytest.mark.parametrize("counters, device_ops, want", [
    ({"host_reads": 66, "gp_iters": 240}, [("k", 0.0, 1.0)], 0.275),
    ({"host_reads": 3, "gp_iters": 0}, [("k", 0.0, 1.0)], None),
    ({"host_reads": 66, "gp_iters": 240}, [], None),
    ({}, [("k", 0.0, 1.0)], None)])
def test_host_reads_reader(counters, device_ops, want):
    """Reads over iterations where a card ran and iterations were
    recorded; nothing otherwise (no card, or a program without the
    ``gp.iter`` spans)."""
    from benchmark.tracing import Trace
    tr = Trace(1.0, device_ops, [], counters=counters)
    assert _reader().read(tr, None) == want
