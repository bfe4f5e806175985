"""Port parity for the ADMM box-QP (``openmeasure_torch/linalg/boxls.py``)
against ``openmeasure_tpu/linalg/boxls.py`` on the same numpy inputs, CPU,
float64 on both sides (JAX x64).

Where the JAX package ``vmap``s a solve, the port takes the batch as a
leading axis; each element must stop where its own JAX solve stops.

Tolerances, float64:
* coefficients ``rtol=1e-9`` with ``atol=1e-9 · max|g|`` (a coefficient
  near zero has no relative scale): the two packages' BLAS round
  differently at ~1e-16, and the ADMM map is non-expansive, so the
  difference stays at round-off over thousands of iterations;
* iteration counts EQUAL, element by element;
* residual diagnostics ``rtol=1e-6``, or within 1e-13 absolute once they
  reach round-off (they are norms of differences of nearly equal iterates;
  these problems are O(1));
* a batch against the solves of its elements one at a time, in the port:
  ``rtol=1e-12``, iteration counts equal.
"""

import jax
import numpy as np
import pytest
import torch

from openmeasure_tpu.linalg import boxls as J
from openmeasure_torch.linalg import boxls as T

RTOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The ADMM runs thousands of tiny torch ops; beside the other workers
    of a parallel test run, torch's OpenMP threads spin between them and
    starve everyone (beside five busy processes, six tests of
    ``tests/test_torch_boxls.py`` took 80 s with 8 threads and 11 s with
    one).  One intra-op thread for this module, the previous count
    restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=RTOL, atol=None):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(
        got, want, rtol=rtol,
        atol=rtol * np.abs(want).max() if atol is None else atol)


def _same_info(ti, ji, dual_nan=False):
    np.testing.assert_array_equal(ti.iterations.numpy(),
                                  np.asarray(ji.iterations))
    _close(ti.primal_residual, ji.primal_residual, rtol=1e-6, atol=1e-13)
    if dual_nan:
        assert np.isnan(ti.dual_residual.numpy()).all()
        assert np.isnan(np.asarray(ji.dual_residual)).all()
    else:
        _close(ti.dual_residual, ji.dual_residual, rtol=1e-6, atol=1e-13)


def _cols_problem(seed, b, s=15, r=4, n=30, box=0.3):
    rng = np.random.default_rng(seed)
    Theta = rng.standard_normal((s, r))
    Y = 3.0 * rng.standard_normal((b, s))
    W = rng.random((b, s)) + 0.5
    A, _ = np.linalg.qr(rng.standard_normal((n, r)))
    return Theta, Y, W, A, -box * np.ones(n), box * np.ones(n)


@pytest.mark.parametrize("adapt_rho", [True, False])
@pytest.mark.parametrize("tol", [1e-9, 0.0])
def test_batched_lstsq_matches_jax_vmap(adapt_rho, tol):
    Theta, Y, W, A, lo, hi = _cols_problem(0, b=5)
    kw = dict(max_iter=1500, tol=tol, adapt_rho=adapt_rho)
    gj, ij = jax.vmap(lambda y, w: J.box_constrained_lstsq(
        Theta, y, w, A, lo, hi, **kw))(Y, W)
    gt, it = T.box_constrained_lstsq(torch.as_tensor(Theta), Y, W, A, lo,
                                     hi, **kw)
    assert gt.shape == (5, 4) and it.iterations.shape == (5,)
    _close(gt, gj)
    _same_info(it, ij, dual_nan=not adapt_rho and tol == 0.0)
    if tol > 0:
        # the elements stop at different iterations: the mask matters
        assert len(set(it.iterations.tolist())) > 1
    else:
        assert (it.iterations == 1500).all()


@pytest.mark.parametrize("adapt_rho", [True, False])
def test_admm_box_qp_single_matches_jax(adapt_rho):
    Theta, Y, W, A, lo, hi = _cols_problem(1, b=1)
    H = Theta.T @ Theta
    c = Theta.T @ Y[0]
    gj, ij = J.admm_box_qp(H, c, A, lo, hi, max_iter=3000, tol=1e-10,
                           adapt_rho=adapt_rho)
    gt, it = T.admm_box_qp(H, c, A, lo, hi, max_iter=3000, tol=1e-10,
                           adapt_rho=adapt_rho)
    assert gt.shape == (4,) and it.iterations.shape == ()
    _close(gt, gj)
    _same_info(it, ij)


@pytest.mark.parametrize("adapt_rho", [True, False])
def test_batch_equals_its_elements_alone(adapt_rho):
    Theta, Y, W, A, lo, hi = _cols_problem(2, b=4)
    Th = torch.as_tensor(Theta)
    gb, ib = T.box_constrained_lstsq(Th, Y, W, A, lo, hi, max_iter=2000,
                                     tol=1e-10, adapt_rho=adapt_rho)
    for i in range(4):
        g1, i1 = T.box_constrained_lstsq(Th, Y[i], W[i], A, lo, hi,
                                         max_iter=2000, tol=1e-10,
                                         adapt_rho=adapt_rho)
        assert int(i1.iterations) == int(ib.iterations[i])
        _close(gb[i], g1.numpy(), rtol=1e-12)


def test_host_read_interval_does_not_change_the_result(monkeypatch):
    """Iterations past an element's stop are masked no-ops, so how often
    the loop asks the host whether all have stopped changes nothing."""
    Theta, Y, W, A, lo, hi = _cols_problem(3, b=6)
    Th = torch.as_tensor(Theta)
    runs = []
    for every in (1, 7, T.CHECK_EVERY):
        monkeypatch.setattr(T, "CHECK_EVERY", every)
        runs.append(T.box_constrained_lstsq(Th, Y, W, A, lo, hi,
                                            max_iter=2000, tol=1e-9))
    for g, info in runs[1:]:
        assert torch.equal(g, runs[0][0])
        assert torch.equal(info.iterations, runs[0][1].iterations)


def test_batched_bounds_pins_infinities_and_infeasible_rows():
    """Per-element bounds (lo/hi (b, q)), equality pins (lo == hi), ±inf
    bounds and an infeasible row (lo > hi: the clip gives hi, in JAX and
    in torch) — against JAX's vmap over the bounds."""
    Theta, Y, W, A, lo, hi = _cols_problem(4, b=3, box=0.5)
    rng = np.random.default_rng(4)
    LO = np.tile(lo, (3, 1))
    HI = np.tile(hi, (3, 1))
    pins = rng.uniform(-0.2, 0.2, 3)
    LO[:, 5] = HI[:, 5] = pins
    LO[:, 7] = -np.inf
    HI[:, 8] = np.inf
    LO[:, 9], HI[:, 9] = 0.1, -0.1                       # infeasible row
    kw = dict(max_iter=4000, tol=1e-11)
    gj, ij = jax.vmap(lambda y, w, l, h: J.box_constrained_lstsq(
        Theta, y, w, A, l, h, **kw))(Y, W, LO, HI)
    gt, it = T.box_constrained_lstsq(torch.as_tensor(Theta), Y, W, A, LO,
                                     HI, **kw)
    _close(gt, gj)
    np.testing.assert_array_equal(it.iterations.numpy(),
                                  np.asarray(ij.iterations))
    clipped = torch.clamp(torch.as_tensor(np.zeros((3, 30))),
                          torch.as_tensor(LO), torch.as_tensor(HI))
    np.testing.assert_array_equal(
        clipped.numpy(), np.asarray(jax.numpy.clip(np.zeros((3, 30)), LO,
                                                   HI)))
    assert (clipped[:, 9] == -0.1).all()


@pytest.mark.parametrize("with_gram", [True, False])
def test_batched_map_matches_jax_vmap(with_gram):
    rng = np.random.default_rng(5)
    r, n, b = 5, 40, 4
    Ls = rng.standard_normal((b, r, r))
    covs = Ls @ np.swapaxes(Ls, 1, 2) + r * np.eye(r)
    means = rng.standard_normal((b, r))
    A, _ = np.linalg.qr(rng.standard_normal((n, r)))
    A = A * np.logspace(0, 2, r)[None, :]
    lo, hi = -0.1 * np.ones(n), 0.1 * np.ones(n)
    AtA = A.T @ A if with_gram else None
    kw = dict(AtA=AtA, max_iter=3000, tol=1e-11)
    vj, ij = jax.vmap(lambda m, c: J.box_constrained_map(
        m, c, A, lo, hi, **kw))(means, covs)
    vt, it = T.box_constrained_map(means, covs, A, lo, hi, **kw)
    _close(vt, vj)
    _same_info(it, ij)
    # one point alone: the unbatched shapes
    v1, i1 = T.box_constrained_map(means[0], covs[0], A, lo, hi, **kw)
    assert v1.shape == (r,) and int(i1.iterations) == int(it.iterations[0])


@pytest.mark.parametrize("adapt_rho", [True, False])
def test_fixed_budget_map_matches_jax(adapt_rho):
    """The serving form: a diagonal covariance per point, shared Gram,
    ``tol = 0``, fixed budget."""
    rng = np.random.default_rng(6)
    r, n, b = 4, 30, 3
    var = rng.random((b, r)) + 0.05
    covs = np.stack([np.diag(v) for v in var])
    means = rng.standard_normal((b, r))
    A, _ = np.linalg.qr(rng.standard_normal((n, r)))
    lo, hi = -0.2 * np.ones(n), 0.2 * np.ones(n)
    kw = dict(AtA=np.eye(r), max_iter=300, tol=0.0, adapt_rho=adapt_rho)
    vj, ij = jax.vmap(lambda m, c: J.box_constrained_map(
        m, c, A, lo, hi, **kw))(means, covs)
    vt, it = T.box_constrained_map(means, covs, A, lo, hi, **kw)
    _close(vt, vj)
    _same_info(it, ij, dual_nan=not adapt_rho)


def test_fixed_rho_normless_budget_reports_nan_dual():
    Theta, Y, W, A, lo, hi = _cols_problem(7, b=1)
    g, info = T.box_constrained_lstsq(Theta, Y[0], np.ones(15), A, lo, hi,
                                      max_iter=400, tol=0.0,
                                      adapt_rho=False)
    assert int(info.iterations) == 400
    assert np.isfinite(float(info.primal_residual))
    assert np.isnan(float(info.dual_residual))


def test_singular_hessian_and_thin_constraints_stay_finite():
    """H rank-deficient AND AᵀA rank-deficient (3 sensors < 5 modes, 2 pin
    rows): the eps-ridge keeps the factor finite (JAX
    ``tests/test_linalg.py``'s case)."""
    rng = np.random.default_rng(8)
    r = 5
    Theta = rng.standard_normal((3, r))
    y = rng.standard_normal(3)
    A = rng.standard_normal((2, r))
    v = A @ rng.standard_normal(r) * 0.1
    gt, _ = T.box_constrained_lstsq(Theta, y, np.ones(3), A, v, v,
                                    max_iter=500)
    gj, _ = J.box_constrained_lstsq(Theta, y, np.ones(3), A, v, v,
                                    max_iter=500)
    assert torch.isfinite(gt).all()
    np.testing.assert_allclose((torch.as_tensor(A) @ gt).numpy(), v,
                               atol=1e-4)
    _close(gt, gj, rtol=1e-7)


def test_fp32_relative_tolerance_converges_and_budget_holds():
    """An O(1) fp32 problem with an active box stops well before max_iter
    (the relative floor); ``tol = 0`` runs exactly the budget."""
    rng = np.random.default_rng(9)
    r = 6
    Theta = rng.standard_normal((8, r)).astype(np.float32)
    y = (Theta @ rng.standard_normal(r) + 2.0).astype(np.float32)
    w = np.ones(8, np.float32)
    A = np.eye(r, dtype=np.float32)
    lo, hi = -0.5 * np.ones(r, np.float32), 0.5 * np.ones(r, np.float32)
    g, info = T.box_constrained_lstsq(Theta, y, w, A, lo, hi, max_iter=4000,
                                      tol=1e-9)
    assert g.dtype == torch.float32
    assert (torch.abs(g) <= 0.5 + 1e-5).all()
    assert int(info.iterations) < 2000
    _, info0 = T.box_constrained_lstsq(Theta, y, w, A, lo, hi, max_iter=300,
                                       tol=0.0)
    assert int(info0.iterations) == 300


def test_concat_constraints_batched_and_errors():
    rng = np.random.default_rng(10)
    A1 = rng.standard_normal((6, 3))
    A2 = rng.standard_normal((2, 3))
    vals = rng.standard_normal((4, 2))
    parts = [(A1, -np.ones(6), np.ones(6)), (A2, vals, vals)]
    cs = T.concat_constraints([T.LinearConstraints(*p) for p in parts])
    cj = J.concat_constraints([J.LinearConstraints(*p) for p in parts])
    assert cs.batched and tuple(cs.lo.shape) == (4, 8)
    for got, want in zip(cs, cj):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="batch sizes"):
        T.concat_constraints([
            T.LinearConstraints(A1, np.zeros((3, 6)), np.ones((3, 6))),
            T.LinearConstraints(A2, vals, vals)])
    # unbatched parts with scalar bounds broadcast to each part's rows
    cs = T.concat_constraints([T.LinearConstraints(A1, -1.0, 1.0),
                               T.LinearConstraints(A2, -np.ones(2),
                                                   np.ones(2))])
    assert not cs.batched and tuple(cs.lo.shape) == (8,)
    np.testing.assert_array_equal(cs.lo.numpy()[:6], -1.0)


def test_concat_constraints_keeps_a_tensor_device_and_promotes():
    A1 = torch.ones((2, 3), dtype=torch.float32)
    cs = T.concat_constraints([T.LinearConstraints(A1, 0.0, 1.0),
                               (np.ones((1, 3)), np.zeros(1), np.ones(1))])
    assert cs.A.dtype == torch.float64 and cs.A.device == A1.device


def test_build_constraint_set_cases():
    rng = np.random.default_rng(11)
    for q in (3, 5):
        A = rng.standard_normal((q, 4))
        cs, box_only = T.build_constraint_set((A, -np.ones(q), np.ones(q)))
        assert tuple(cs.A.shape) == (q, 4) and not box_only
        np.testing.assert_array_equal(np.asarray(cs.A), A)
    sets = [T.LinearConstraints(rng.standard_normal((2, 4)), -np.ones(2),
                                np.ones(2)) for _ in range(3)]
    cs, box_only = T.build_constraint_set(sets)
    assert tuple(cs.A.shape) == (6, 4) and not box_only
    A = rng.standard_normal((4, 2))
    cs, box_only = T.build_constraint_set([], (A, -np.ones(4), np.ones(4)))
    assert box_only is True and cs.A.shape == (4, 2)
    cs, box_only = T.build_constraint_set(
        sets[0], (rng.standard_normal((3, 4)), 0.0, 1.0))
    assert not box_only and tuple(cs.lo.shape) == (5,)
    assert T.build_constraint_set(None, None) == (None, False)
