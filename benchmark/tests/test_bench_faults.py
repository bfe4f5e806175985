"""A run whose timed path is broken underneath comes out not correct.

Each test drives a whole run at a tiny size on the CPU (the harness's
look for a card skipped), the configuration in float64 so that the sound
run's numbers sit at round-off, once sound and once with a fault of
:mod:`benchmark.faults` planted in the program's timed path: an answer
altered where it is produced (in every frame, or in a tenth of each
batch's), half of a batch left out, a basis tilted, a placement out of
greedy order or with one sensor swapped, and a training step that returns
its state unchanged.  No cell spans chips, so no exchange between chips
can be left out."""

import pytest

from conftest import listing, tiny


def _run(cell, fault, tmp_path, seed=11):
    from benchmark import faults, harness
    undo = faults.plant(fault) if fault != "sound" else None
    try:
        return harness.run_cell(listing(cell, tmp_path), cell, seed, 0.3,
                                False, device="cpu",
                                overrides=tiny(cell, dtype="float64"),
                                out_dir=tmp_path)
    finally:
        if undo:
            undo()


@pytest.mark.parametrize("cell, fault, caught_by", [
    ("flame2d.serve_cols", "sound", None),
    ("flame2d.serve_cols", "coef_altered", "coef_gap_p95"),
    ("flame2d.serve_cols", "tenth_altered", "coef_gap_p95"),
    ("flame2d.serve_cols", "half_batch", "field_gap_p95"),
    ("flame3d.fit", "sound", None),
    ("flame3d.fit", "rec_altered", "rec_gap"),
    ("flame3d.fit", "basis_tilted", "pod_excess"),
    ("flame3d.fit", "pivots_reversed", "pivot_slack"),
    ("flame3d.fit", "pivot_swapped", "pivot_slack"),
    ("flame2d.gpr_fit", "sound", None),
    ("flame2d.gpr_fit", "step_unchanged", "loss_shortfall"),
    ("flame2d.gpr_fit", "pred_altered", "pred_gap"),
])
def test_fault_is_caught(cell, fault, caught_by, tmp_path, one_thread):
    res = _run(cell, fault, tmp_path)
    assert res["correct"] is (fault == "sound"), res["checks"]
    if caught_by:
        c = res["checks"][caught_by]
        assert c["value"] is None or c["value"] > c["limit"], res["checks"]
