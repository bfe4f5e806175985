"""Serving on the card (``openmeasure_torch/serving.py``): the fp32 COLS
``SoftSensor`` against a float64 sensor of the same model, a fixed-budget
batch with no read back to the host, and a ``GPRSensor`` request's σ
against float64, with no launch of the chol kernel (``csrc/chol.cu``).

Every test here needs a CUDA card and skips without one; this file imports
neither JAX nor the JAX package, so on a machine with a card it runs as::

    python -m pytest tests/test_torch_serving_cuda.py --noconftest -q

Tolerances, ``chip_smoke.py``'s serving bars: the fp32 COLS coefficients
within 2e-3 of max|a| of the float64 sensor's at the same budget (300
iterations, each adding ~u of round-off that the non-expansive iteration
carries, scaled by the (r, r) solves' conditioning); the fields within
1e-3 of each feature's span of the limits (the primal residual left after
the budget).  With the limits padded inward, so that field entries reach
them, the float64 sensor's fields stray past them too, and the fp32 fields
may stray by that excursion plus 1e-3.  A ``GPRSensor``'s σ within 5e-4
of the largest float64 σ: ``tests/test_torch_gp_posterior.py``'s bound for
the posterior's triangular solve.
"""

import numpy as np
import pytest
import torch

from openmeasure_torch import GPR, SPR, GPRSensor, SoftSensor
from openmeasure_torch.datasets.synthetic import make_flame_dataset
from openmeasure_torch.utils import logging as L

COEF_REL, VIOL_REL = 2e-3, 1e-3
GP_SIGMA_REL = 5e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: serving runs the card's kernels")
    return torch.device("cuda")


@pytest.fixture
def medium():
    """A medium flame set: 9 features × 3000 cells, 20 + 4 snapshots."""
    return make_flame_dataset(n_cells=3000, m_train=20, m_test=4,
                              dtype=np.float32, seed=2)


def _cols_model(d, r=10, pad_sign=1.0):
    """COLS under per-feature limits padded by 5 % of the span: outward
    (``pad_sign=1``, out of the fields' reach) or inward (``-1``, binding)."""
    npts = d["xyz"].shape[0]
    Xb = d["X_train"].astype(np.float64).reshape(9, npts, -1)
    f_lo, f_hi = Xb.min(axis=(1, 2)), Xb.max(axis=(1, 2))
    pad = pad_sign * 0.05 * (f_hi - f_lo)
    spr = SPR(d["X_train"], 9, d["xyz"])
    spr.fit(select_modes="number", n_modes=r)
    C = spr.optimal_placement()
    spr.train(C, method="COLS", limits=[f_lo - pad, f_hi + pad])
    rows = C.argmax(dim=1).cpu().numpy()
    return spr, rows, (f_lo - pad, f_hi + pad, f_hi - f_lo)


@pytest.mark.cuda
@pytest.mark.parametrize("limits", ["padded", "binding"])
@pytest.mark.parametrize("admm_rho", ["adaptive", "fixed"])
def test_cols_sensor_fp32_against_float64(card, medium, admm_rho, limits):
    spr, rows, (lo, hi, span) = _cols_model(
        medium, pad_sign=1.0 if limits == "padded" else -1.0)
    Y = torch.as_tensor(np.tile(medium["X_test"][rows].T, (4, 1)),
                        device=card)
    s32 = SoftSensor.from_spr(spr, admm_rho=admm_rho)
    s64 = SoftSensor.from_spr(spr, dtype=torch.float64, admm_rho=admm_rho)
    x32, a32, _ = s32.predict_batch(Y)
    x64, a64, _ = s64.predict_batch(Y)
    assert x32.dtype == torch.float32 and a64.dtype == torch.float64
    err = float((a32.double() - a64).abs().max() / a64.abs().max())
    assert err <= COEF_REL, err
    npts = medium["xyz"].shape[0]
    lo_r, hi_r, span_r = (np.repeat(v, npts) for v in (lo, hi, span))

    def excursion(x):
        x = x.double().cpu().numpy()
        viol = np.maximum(lo_r - x, x - hi_r)
        return (np.maximum(viol, 0.0) / span_r).max(), \
            int((viol >= -1e-6 * span_r).sum())

    v32, at32 = excursion(x32)
    if limits == "padded":
        assert v32 <= VIOL_REL
    else:
        assert at32 > 0
        assert v32 <= excursion(x64)[0] + VIOL_REL


@pytest.mark.cuda
def test_fixed_budget_batch_reads_nothing_back(card, medium):
    spr, rows, _ = _cols_model(medium)
    Y = torch.as_tensor(medium["X_test"][rows].T, device=card)
    sensor = SoftSensor.from_spr(spr, admm_iters=50).warmup()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        x, _, _ = sensor.predict_batch(Y)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(x).all())


@pytest.mark.cuda
def test_gpr_sensor_sigma_against_float64_without_chol(card, medium):
    """A ``GPRSensor`` request on the card takes its posterior by a
    Cholesky factor and triangular solves: no launch of ``csrc/chol.cu``,
    and σ within ``GP_SIGMA_REL`` of the float64 posterior of the same
    trained model (``engine='host'``), as ``tests/test_torch_gp_posterior.py``
    bounds it; the coefficients equal ``GPR.predict``'s to 1e-5."""
    gpr = GPR(medium["X_train"], 9, medium["xyz"], medium["P_train"],
              gpr_type="MultiTask")
    gpr.fit(select_modes="number", n_modes=6)
    gpr.train(max_iter=50)
    sensor = GPRSensor.from_gpr(gpr)
    with L.recording() as rec:
        for _ in range(3):
            fields, A, A_sigma = sensor(medium["P_test"])
    torch.cuda.synchronize()
    assert "chol.kernel_launches" not in rec.counters
    A_ref, _ = gpr.predict(medium["P_test"])
    assert float((A - A_ref).abs().max() / A_ref.abs().max()) <= 1e-5
    assert tuple(fields.shape) == (4, medium["X_train"].shape[0])
    gpr.engine = "host"
    _, s64 = gpr.predict(medium["P_test"])
    assert s64.dtype == torch.float64 and A_sigma.dtype == torch.float32
    gap = float((A_sigma.cpu().double() - s64).abs().max() / s64.abs().max())
    assert gap <= GP_SIGMA_REL, gap
