"""The plain reference agrees with the program run in float64 at a tiny
size: the same answers, so that the fp32 runs' gaps are the fp32
arithmetic's and nothing else."""

import pytest

from conftest import listing, tiny

# float64 against float64: the same formulas in a different order
F64_TOL = 1e-9


def _numbers(cell, tmp_path, seed=7, **mix):
    from benchmark import harness
    ctx = harness.load_ctx(listing(cell, tmp_path), cell, seed, "cpu",
                           tiny(cell, dtype="float64"))
    ctx.mix.update(mix)
    drv = harness.driver(ctx)
    state = drv.setup(ctx)
    w = harness.run_window(drv, ctx, state, 0.0, 2, 2)
    ev = drv.evidence(ctx, state, w.kept)
    return harness.compare(drv, ctx, ev, "program"), ev, ctx


@pytest.mark.parametrize("method", ["COLS", "OLS"])
def test_serving_reference_agrees_in_float64(method, tmp_path, one_thread):
    """Both serving methods: the OLS sensor is the same serving code
    without the ADMM."""
    nums, _, _ = _numbers("flame2d.serve_cols", tmp_path, method=method)
    for name in ("field_gap_max", "coef_gap_max", "sigma_gap_max",
                 "pod_excess"):
        assert abs(nums[name]) <= F64_TOL, (name, nums[name])


@pytest.mark.parametrize("cell", ["flame3d.fit", "flame2d.gpr_fit"])
def test_reference_agrees_in_float64(cell, tmp_path, one_thread):
    from benchmark import harness
    nums, ev, ctx = _numbers(cell, tmp_path)
    for name in ctx.limits:
        want = 1.0 if name == "nrmse_ratio" else 0.0
        assert abs(nums[name] - want) <= F64_TOL, (name, nums[name])
    if cell == "flame2d.gpr_fit":
        # the reference's Adam stops every mode on the program's iteration
        ref = harness.driver(ctx).reference(ctx, ev, "float64")
        assert ref["model"]["iters"].tolist() == \
            ev["model"]["iters"].tolist()
