"""Failed factorizations and singular solves give NaN in the port where
they give NaN in the JAX package (CPU, float64 against JAX x64).

``torch.linalg.cholesky_ex`` leaves a partial factor where a matrix is not
positive definite, and ``torch.linalg.solve`` raises (after a host read)
where ``jnp.linalg.solve`` returns NaN.  The port's call sites with a
``jnp.linalg.cholesky`` counterpart go through
``linalg.chol.cholesky_nan``, and the dense solves through
``torch.linalg.solve_ex``.  Each is held against its JAX counterpart on a
singular positive semi-definite matrix and on an indefinite one: NaN in
the same places; and on an SPD matrix the finite results are unchanged
(``rtol=1e-12``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmeasure_tpu.gp import exact_gp as JE
from openmeasure_tpu.gp import kernels as JK
from openmeasure_tpu.linalg import boxls as JB
from openmeasure_tpu.linalg import chol_pallas as JC
from openmeasure_torch import pipelines as TP
from openmeasure_torch.gp import exact_gp as TE
from openmeasure_torch.gp import kernels as TK
from openmeasure_torch.linalg import boxls as TB
from openmeasure_torch.linalg import chol as TC

MATRICES = {
    "singular": np.ones((3, 3)),
    "indefinite": np.array([[1.0, 2.0, 0.0], [2.0, 1.0, 0.0],
                            [0.0, 0.0, 1.0]]),
    "spd": np.array([[4.0, 1.0, 0.5], [1.0, 3.0, 0.2], [0.5, 0.2, 2.0]]),
}


def _same(got, want, rtol=1e-12):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=1e-14)


@pytest.mark.parametrize("name", list(MATRICES))
def test_cholesky_nan_and_chol_inv_logdet(name):
    K = MATRICES[name]
    Kb = np.stack([K, MATRICES["spd"]])     # a failing and a good matrix
    _same(TC.cholesky_nan(torch.as_tensor(Kb)),
          np.stack([np.asarray(jnp.linalg.cholesky(jnp.asarray(k)))
                    for k in Kb]))
    kj, lj = JC.chol_inv_logdet_jnp(jnp.asarray(Kb))
    for fn in (TC.chol_inv_logdet_torch, TC.chol_inv_logdet):
        kt, lt = fn(torch.as_tensor(Kb))
        _same(kt, kj)
        _same(lt, lj)
    if name != "spd":
        assert np.isnan(np.asarray(lj)[0]) and np.isfinite(np.asarray(lj)[1])


def _gp(noise):
    """A ConstantMean × LinearKernel GP on three equal sites: K = v·11ᵀ is
    singular, and ``noise`` −1e-8 (minus the jitter) keeps it so, −3 makes
    it indefinite, 0.5 makes it SPD."""
    X, y = np.ones((3, 1)), np.array([0.5, -0.2, 0.1])
    Xs = np.array([[0.5], [2.0]])
    pj = {"mean": {"constant": jnp.asarray(0.1)},
          "kernel": {"raw_variance": jnp.asarray(0.0)}}
    pt = {"mean": {"constant": torch.tensor(0.1, dtype=torch.float64)},
          "kernel": {"raw_variance": torch.tensor(0.0, dtype=torch.float64)}}
    jargs = (JK.ConstantMean(), JK.LinearKernel(), pj, jnp.asarray(noise),
             jnp.asarray(X), jnp.asarray(y))
    targs = (TK.ConstantMean(), TK.LinearKernel(), pt,
             torch.tensor(noise, dtype=torch.float64), torch.as_tensor(X),
             torch.as_tensor(y))
    return jargs, targs, Xs


@pytest.mark.parametrize("noise", [-1e-8, -3.0, 0.5],
                         ids=["singular", "indefinite", "spd"])
def test_gp_log_prob_and_posterior(noise):
    jargs, targs, Xs = _gp(noise)
    _same(TE.gp_log_prob(*targs), JE.gp_log_prob(*jargs))
    mj, vj = JE.gp_posterior(*jargs, jnp.asarray(Xs))
    mt, vt = TE.gp_posterior(*targs, torch.as_tensor(Xs))
    _same(mt, mj)
    _same(vt, vj)
    if noise < 0:
        assert np.isnan(np.asarray(mj)).all()


@pytest.mark.parametrize("name", list(MATRICES))
def test_box_constrained_map_covariance(name):
    cov = MATRICES[name]
    mean = np.array([0.3, -0.1, 0.2])
    A = np.eye(3)
    lo, hi = -0.2 * np.ones(3), 0.2 * np.ones(3)
    vj, _ = JB.box_constrained_map(*(jnp.asarray(a) for a in
                                     (mean, cov, A, lo, hi)), max_iter=200)
    vt, _ = TB.box_constrained_map(*(torch.as_tensor(a) for a in
                                     (mean, cov, A, lo, hi)), max_iter=200)
    _same(vt, vj, rtol=1e-9)
    if name != "spd":
        assert np.isnan(np.asarray(vj)).all()


def test_spr_solve_of_a_singular_theta_is_nan(monkeypatch):
    """A Θ with two equal sensor rows (the placement forced to repeat a
    pivot) is singular: ``spr_end_to_end`` returns NaN coefficients, as
    ``jnp.linalg.solve`` does on the same Θ, instead of raising."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((60, 8)) + 3.0
    real = TP.qrcp_pivots_auto

    def repeated(B, k, row_scale=None):
        p = real(B, k, row_scale=row_scale)
        return torch.cat([p[:1], p[:k - 1]])

    monkeypatch.setattr(TP, "qrcp_pivots_auto", repeated)
    res = TP.spr_end_to_end(X, X[:, :2], n_features=2, r=4, device="cpu")
    assert bool(torch.isnan(res.Ar).all())
    B = torch.ones((4, 4), dtype=torch.float64)
    want = np.asarray(jnp.linalg.solve(jnp.asarray(B.numpy()),
                                       jnp.ones((4, 2))))
    _same(torch.linalg.solve_ex(B, torch.ones((4, 2), dtype=torch.float64))[0],
          want)
