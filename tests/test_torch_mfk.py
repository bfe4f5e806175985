"""Port parity for the recursive co-kriging core (CPU, float64):
``multifi/mfk.py`` and ``pipelines.mfk_end_to_end`` against the JAX
package on the same numpy inputs.

Two regimes, two kinds of bar:

* **Deterministic or well-conditioned** — the NLL and its derivatives at
  given θ, the fit terms and posteriors at a fixed θ, and the θ search in
  a box where every correlation matrix is well conditioned (cond₂ ≤ ~300):
  the JAX package's arithmetic is reproduced to round-off, so values,
  gradients, Hessians and predictions are held at ``rtol=1e-9`` and the
  searched θ at ``rtol=1e-8``.
* **The default search box** (θ in [1e-6, 100], nugget 1e-10): it reaches
  correlation matrices with cond₂ ≈ 3e11, where the concentrated NLL
  carries float64 round-off of ~1e-8 relative and the stop rule
  (|Δnll| < 1e-6) resolves that noise — a lane's path follows the last
  bits of its LAPACK.  The JAX package does not reproduce itself there: on
  configuration A with the training sites permuted (the same NLL
  mathematically) its θ moves by up to 6.4e-4 in log10, its means by
  1.9e-8 of their maximum and its MSEs by 5.2e-5 (three permutations;
  ``test_default_box_floor_of_the_jax_package`` re-measures one).  Port
  and JAX are held above that floor: means within ``MEAN_REL = 1e-7`` of
  max|mean|, MSEs within ``MSE_REL = 5e-4`` of max MSE, log10 θ within
  ``LOG_THETA_ABS = 5e-3``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmeasure_tpu.multifi import mfk as JM
from openmeasure_tpu.pipelines import mfk_end_to_end as j_mfk
from openmeasure_torch.multifi import mfk as TM
from openmeasure_torch.pipelines import mfk_end_to_end as t_mfk

RTOL = 1e-9
MEAN_REL, MSE_REL, LOG_THETA_ABS = 1e-7, 5e-4, 5e-3


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Hundreds of tiny torch ops a Newton step: one intra-op thread, so
    torch's OpenMP threads do not spin beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(a):
    return torch.as_tensor(np.array(a))


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def forrester_hf(x):
    return (6 * x - 2) ** 2 * np.sin(12 * x - 4)


def forrester_lf(x):
    return 0.5 * forrester_hf(x) + 10 * (x - 0.5) - 5


def mfk_problem(K=8, n_lf=40, n_hf=15, n_test=25, d=2, seed=3):
    """Configuration A, the JAX benchmark's co-kriging row
    (``bench.py:138-153``): K outputs on shared two-fidelity sites."""
    rng = np.random.default_rng(seed)
    X_lf = rng.random((n_lf, d))
    X_hf = X_lf[::max(1, n_lf // n_hf)][:n_hf]
    X_test = rng.random((n_test, d))

    def hf(X, k):
        return np.sin(3 * X[:, 0] + 0.7 * k) + 0.5 * np.cos(2 * X[:, 1] + k)

    Y_hf = np.stack([hf(X_hf, k) for k in range(K)])
    Y_lf = np.stack([0.6 * hf(X_lf, k) - 0.3 + 0.2 * X_lf[:, 0]
                     for k in range(K)])
    return X_lf, Y_lf, X_hf, Y_hf, X_test


def _grid_problem(K=3, seed=5):
    """12 sites on a jittered 4 × 3 grid of spacing ~0.8, linear regression
    and K outputs: with θ ≥ 0.3 every correlation matrix has cond₂ ≤ ~300."""
    g = np.random.default_rng(seed)
    X = np.stack(np.meshgrid(np.linspace(-1.2, 1.2, 4),
                             np.linspace(-1.2, 1.2, 3)), -1).reshape(-1, 2)
    X = X + 0.05 * g.standard_normal(X.shape)
    Y = np.stack([np.sin(2 * X[:, 0] + k) + 0.3 * X[:, 1] ** 2
                  for k in range(K)])
    F = np.concatenate([np.ones((12, 1)), X], 1)[None].repeat(K, 0)
    return X, F, Y


# ---------------------------------------------------------------------- #
# The NLL, its derivatives, the starts
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("regr", ["constant", "linear"])
@pytest.mark.parametrize("lt", [(0.3, -0.2), (1.0, 0.5), (-0.5, 0.8)])
def test_level_nll_value_gradient_hessian(regr, lt):
    """The Cholesky branch against ``jax.value_and_grad`` and
    ``jax.hessian`` of the JAX NLL; the explicit-inverse branch (the CUDA
    fp32 formulation, here on the Cholesky-based plain inverse in float64)
    against the Cholesky branch."""
    rng = np.random.default_rng(7)
    X = rng.random((12, 2)) * 3.0
    y = np.sin(X[:, 0]) + 0.5 * X[:, 1]
    F = np.asarray(JM._regr(regr, jnp.asarray(X)))
    lt = np.asarray(lt)
    Xj, Fj, yj = (jnp.asarray(a) for a in (X, F, y))
    fj, gj = jax.value_and_grad(
        lambda t: JM._level_nll(t, Xj, Fj, yj))(jnp.asarray(lt))
    Hj = jax.hessian(lambda t: JM._level_nll(t, Xj, Fj, yj))(jnp.asarray(lt))
    R = np.exp(-np.sum(10 ** lt * (X[:, None] - X[None]) ** 2, -1))
    assert np.linalg.cond(R) < 1e4

    def vgh(fn):
        x = T(lt)[None].requires_grad_(True)
        f = fn(x, T(X), T(F)[None], T(y)[None])
        (g,) = torch.autograd.grad(f.sum(), x, create_graph=True)
        H = torch.stack([torch.autograd.grad(g[:, i].sum(), x,
                                             retain_graph=True)[0]
                         for i in range(2)], 1)
        return f.detach()[0], g.detach()[0], H[0]

    f_c, g_c, H_c = vgh(TM._level_nll_chol)
    assert _rel(f_c, fj) <= RTOL and _rel(g_c, gj) <= RTOL
    assert _rel(H_c, Hj) <= RTOL
    f_i, g_i, H_i = vgh(TM._level_nll_inv)
    assert _rel(f_i, f_c) <= RTOL and _rel(g_i, g_c) <= RTOL
    assert _rel(H_i, H_c) <= RTOL
    # the batched helper used by the search: the same numbers, lane by lane
    f_b, g_b, H_b = TM._value_grad_hess(T(lt)[None].repeat(3, 1), T(X),
                                        T(F)[None].repeat(3, 1, 1),
                                        T(y)[None].repeat(3, 1))
    for b in range(3):
        assert torch.equal(f_b[b], f_c) and torch.equal(g_b[b], g_c)
        assert torch.equal(H_b[b], H_c)


def test_gls_solve_is_the_lu_solve_to_every_order():
    """The θ search's GLS solve: ``torch.linalg.solve``'s values, and its
    hand-written backward passes gradcheck and gradgradcheck; a singular
    Gram gives NaN."""
    g = torch.Generator().manual_seed(0)
    A = torch.randn(3, 3, 3, dtype=torch.float64, generator=g)
    A = (A @ A.mT + 3 * torch.eye(3, dtype=torch.float64)).requires_grad_()
    b = torch.randn(3, 3, dtype=torch.float64, generator=g).requires_grad_()
    assert torch.equal(TM._gls_solve(A, b), torch.linalg.solve(A, b))
    assert torch.autograd.gradcheck(TM._gls_solve, (A, b))
    assert torch.autograd.gradgradcheck(TM._gls_solve, (A, b))
    S = torch.ones((2, 2, 2), dtype=torch.float64)
    assert bool(torch.isnan(TM._gls_solve(S, torch.ones((2, 2),
                                                         dtype=torch.float64))
                            ).all())


def test_level_nll_failed_factorization_is_nan(monkeypatch):
    """Without its nugget, R = exp(−θD) at θ = 1e-6 and 1e-3 does not
    factor in float64: both packages give NaN (never −inf, which the
    search would rank first), on both port branches."""
    monkeypatch.setattr(JM, "_nugget_for", lambda dtype: 0.0)
    monkeypatch.setattr(TM, "_nugget_for", lambda dtype: 0.0)
    X = np.linspace(0, 1, 11)[:, None]
    X = (X - X.mean()) / X.std()
    y = forrester_lf(X[:, 0])
    F = np.ones((11, 1))
    for lt in (-6.0, -3.0):
        fj = float(JM._level_nll(jnp.asarray([lt]), jnp.asarray(X),
                                 jnp.asarray(F), jnp.asarray(y)))
        assert np.isnan(fj)
        for fn in (TM._level_nll_chol, TM._level_nll_inv):
            ft = fn(T([lt])[None], T(X), T(F)[None], T(y)[None])
            assert bool(torch.isnan(ft).all())


@pytest.mark.parametrize("d", [1, 2, 3])
def test_starts_and_halton_cloud_equal_jax(d):
    args = (np.full(d, 0.5), np.full(d, 1e-6), np.full(d, 100.0), 0.3)
    np.testing.assert_array_equal(TM._make_starts(*args),
                                  np.asarray(JM._make_starts(*args)))
    # the JAX screening cloud (openmeasure_tpu/multifi/mfk.py:239-254),
    # its loop written out
    primes = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)
    u = np.zeros((27, d))
    for j in range(d):
        b, k_cur, x, denom = primes[j], np.arange(1, 28), np.zeros(27), primes[j]
        while k_cur.max() > 0:
            x += (k_cur % b) / denom
            k_cur //= b
            denom *= b
        u[:, j] = x
    np.testing.assert_array_equal(TM._halton_unit(d), u)
    assert TM._halton_unit(13) is None


# ---------------------------------------------------------------------- #
# The θ search
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("box", [(1.0, 50.0, 2.0), (0.3, 30.0, 1.0)])
def test_multistart_theta_matches_jax_well_conditioned(box):
    tL, tU, t0 = box
    X, F, Y = _grid_problem()
    d = 2
    starts = JM._make_starts(np.full(d, t0), np.full(d, tL), np.full(d, tU),
                             0.3)
    lo, hi = np.log10(np.full(d, tL)), np.log10(np.full(d, tU))
    lj = np.asarray(JM._multistart_opt_batch(
        *(jnp.asarray(a) for a in (starts, X, F, Y, lo, hi))))
    lt, _ = TM._multistart_opt_batch(*(T(a) for a in (starts, X, F, Y, lo,
                                                      hi)))
    np.testing.assert_allclose(lt.numpy(), lj, rtol=1e-8,
                               atol=1e-8 * np.abs(lj).max())
    # single output: the K = 1 case
    l1 = TM._multistart_opt(T(starts), T(X), T(F[0]), T(Y[0]), T(lo), T(hi))
    np.testing.assert_allclose(l1.numpy(), lj[0], rtol=1e-8, atol=1e-10)


def test_flag_interval_does_not_change_the_result():
    """Steps past a lane's stop are masked no-ops: reading the "all done"
    flag after every step, every 8 or never before the 100-step cap gives
    the same θ bit for bit, and the same step count."""
    X_lf, Y_lf, _, _, _ = mfk_problem(K=3, n_lf=20)
    d = 2
    starts = TM._make_starts(np.full(d, 0.5), np.full(d, 1e-6),
                             np.full(d, 100.0), 0.3)
    lo, hi = np.log10(np.full(d, 1e-6)), np.log10(np.full(d, 100.0))
    F = np.ones((3, 20, 1))
    outs = [TM._multistart_opt_batch(*(T(a) for a in (starts, X_lf, F, Y_lf,
                                                      lo, hi)),
                                     check_every=c)
            for c in (1, 8, 100)]
    for lt, steps in outs[1:]:
        assert torch.equal(lt, outs[0][0]) and int(steps) == int(outs[0][1])
    assert 0 < int(outs[0][1]) <= 100


def test_nan_theta0_start_does_not_win():
    """JAX's case (``tests/test_multifi.py:430``): θ0 at the lower bound,
    whose correlation matrix does not factor, is kept in launch slot 0 with
    a NaN NLL; it must not win the final argmin.  Both packages' fits then
    agree at the default-box bars."""
    X_lf = np.linspace(0, 1, 11)[:, None]
    X_hf = np.array([0.0, 0.3, 0.55, 0.8, 1.0])[:, None]
    Y_lf = forrester_lf(X_lf[:, 0])[None]
    Y_hf = forrester_hf(X_hf[:, 0])[None]
    X_t = np.linspace(0, 1, 31)[:, None]
    good = TM.BatchedMFK(device="cpu").fit([X_lf, X_hf], [Y_lf, Y_hf])
    bad0 = TM.BatchedMFK(theta0=1e-6, device="cpu").fit([X_lf, X_hf],
                                                        [Y_lf, Y_hf])
    jbad = JM.BatchedMFK(theta0=1e-6).fit([X_lf, X_hf], [Y_lf, Y_hf])
    m_good, _ = good.predict(X_t)
    m_bad0, s_bad0 = bad0.predict(X_t)
    ref = forrester_hf(X_t[:, 0])
    err_good = np.sqrt(np.mean((m_good[0].numpy() - ref) ** 2))
    err_bad0 = np.sqrt(np.mean((m_bad0[0].numpy() - ref) ** 2))
    assert np.isfinite(err_bad0)
    assert err_bad0 < 3 * max(err_good, 1e-3), (err_bad0, err_good)
    for lev in bad0.levels:
        assert bool(torch.isfinite(lev["theta"]).all())
    m_j, s_j = jbad.predict(X_t)
    assert _rel(m_bad0, m_j) <= MEAN_REL
    assert _rel(s_bad0, s_j) <= MSE_REL


# ---------------------------------------------------------------------- #
# Posteriors and the classes
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("regr,rho_regr", [("constant", "constant"),
                                           ("linear", "linear")])
def test_predict_levels_batch_fixed_theta(regr, rho_regr):
    """At a fixed θ there is no search: the level state, the recursive
    posterior and its mean-only twin equal the JAX package's to
    round-off."""
    X_lf, Y_lf, X_hf, Y_hf, X_t = mfk_problem(K=3, n_lf=30, n_hf=10)
    # a discrepancy outside the span of [ρ·m_prev, f]: with linear ρ and
    # regression the HF outputs of configuration A are fitted exactly,
    # leaving γ at round-off
    Y_hf = Y_hf + 0.1 * np.sin(5.0 * X_hf[:, 1])[None]
    kw = dict(regr=regr, rho_regr=rho_regr, theta=[3.0, 1.5])
    jb = JM.BatchedMFK(**kw).fit([X_lf, X_hf], [Y_lf, Y_hf])
    tb = TM.BatchedMFK(**kw, device="cpu").fit([X_lf, X_hf], [Y_lf, Y_hf])
    for lj, lt in zip(jb.levels, tb.levels):
        assert lj["rho_cols"] == lt["rho_cols"]
        for key in ("F", "theta", "beta", "gamma", "sigma2", "L", "G"):
            assert _rel(lt[key], lj[key]) <= RTOL, key
    Xn = (X_t - jb._X_mean) / jb._X_std
    seq = tuple(lev["rho_cols"] for lev in jb.levels)
    mj, vj = JM.predict_levels_batch(jb.levels, seq, regr, rho_regr, 1,
                                     jnp.asarray(Xn))
    mt, vt = TM.predict_levels_batch(tb.levels, seq, regr, rho_regr, 1,
                                     T(Xn))
    assert _rel(mt, mj) <= RTOL and _rel(vt, vj) <= RTOL
    m0 = TM.predict_levels_mean_batch(tb.levels, seq, regr, rho_regr, 1,
                                      T(Xn))
    assert _rel(m0, mj) <= RTOL
    means, mses = tb.predict(X_t)
    jm, js = jb.predict(X_t)
    assert _rel(means, jm) <= RTOL and _rel(mses, js) <= RTOL
    # truncated prediction slices the state first
    m2, s2 = tb.predict(X_t, n_outputs=2)
    assert m2.shape == (2, 25) and m2.dtype == torch.float64
    assert _rel(m2, jm[:2]) <= RTOL and _rel(s2, js[:2]) <= RTOL


def _mfck_case(name):
    X_lf = np.linspace(0, 1, 11)[:, None]
    X_hf = np.array([0.0, 0.4, 0.6, 1.0])[:, None]
    two = ([X_lf, X_hf], [forrester_lf(X_lf[:, 0]), forrester_hf(X_hf[:, 0])])
    if name == "three_levels":
        X0 = np.linspace(0, 1, 21)[:, None]
        X1, X2 = X0[::2], X0[::4]
        return {}, ([X0, X1, X2], [forrester_lf(X0[:, 0]),
                                   0.7 * forrester_hf(X1[:, 0])
                                   + 5 * (X1[:, 0] - 0.5),
                                   forrester_hf(X2[:, 0])])
    if name == "linear":
        Xl, Xh = np.linspace(0, 1, 12)[:, None], np.linspace(0, 1, 5)[:, None]
        return dict(regr="linear", rho_regr="linear"), (
            [Xl, Xh], [forrester_lf(Xl[:, 0]), forrester_hf(Xh[:, 0])])
    if name == "fixed_theta":
        return dict(theta=5.0), two
    if name == "host":
        return dict(engine="host"), two
    return {}, two


@pytest.mark.parametrize("name", ["two_levels", "three_levels", "linear",
                                  "fixed_theta", "host"])
def test_multificokriging_matches_jax(name):
    kw, (X, y) = _mfck_case(name)
    jm = JM.MultiFiCoKriging(**kw).fit(X, y)
    tm = TM.MultiFiCoKriging(**kw, device="cpu").fit(X, y)
    X_t = np.linspace(0, 1, 31)[:, None]
    mj, sj = jm.predict(X_t)
    mt, st = tm.predict(X_t)
    assert mt.shape == (31, 1) and st.shape == (31, 1)
    assert mt.dtype == torch.float64 and mt.device.type == "cpu"
    if name == "fixed_theta":
        assert _rel(mt, mj) <= RTOL and _rel(st, sj) <= RTOL
        assert float(tm.levels[0]["theta"][0]) == 5.0
    else:
        assert _rel(mt, mj) <= MEAN_REL and _rel(st, sj) <= MSE_REL
        for lj, lt in zip(jm.levels, tm.levels):
            np.testing.assert_allclose(np.log10(lt["theta"].numpy()),
                                       np.log10(np.asarray(lj["theta"])),
                                       rtol=0, atol=LOG_THETA_ABS)


def test_engine_validation_and_pinning():
    X = [np.linspace(0, 1, 6)[:, None]]
    b = TM.BatchedMFK(engine="half", device="cpu")
    with pytest.raises(ValueError, match="engine"):
        b.fit(X, [np.random.default_rng(0).random((2, 6))])
    # predict re-enters the fit's engine, whatever engine says now
    m = TM.MultiFiCoKriging(engine="host", device="cpu", theta=2.0)
    m.fit(X, [np.sin(X[0][:, 0])])
    m.engine = "device"
    mean, _ = m.predict(X[0])
    assert mean.dtype == torch.float64
    # the device engine keeps float32 outputs in float32
    m32 = TM.MultiFiCoKriging(device="cpu", theta=2.0).fit(
        X, [np.sin(X[0][:, 0]).astype(np.float32)])
    assert m32.predict(X[0])[0].dtype == torch.float32


def test_batched_matches_individual_fits():
    """The port's batched multi-output fit reproduces its own per-output
    fits (the JAX package's test, ``tests/test_multifi.py:406``, its
    bars)."""
    X_lf = np.linspace(0, 1, 11)[:, None]
    X_hf = np.array([0.0, 0.4, 0.6, 1.0])[:, None]
    Y_lf = np.stack([forrester_lf(X_lf[:, 0]), 0.8 * forrester_lf(X_lf[:, 0])
                     + 1.0])
    Y_hf = np.stack([forrester_hf(X_hf[:, 0]), 0.5 * forrester_hf(X_hf[:, 0])
                     + 1.0])
    batch = TM.BatchedMFK(device="cpu").fit([X_lf, X_hf], [Y_lf, Y_hf])
    X_t = np.linspace(0, 1, 31)[:, None]
    m_b, s_b = batch.predict(X_t)
    for k in range(2):
        m = TM.MultiFiCoKriging(device="cpu").fit([X_lf, X_hf],
                                                  [Y_lf[k], Y_hf[k]])
        m_i, s_i = m.predict(X_t)
        np.testing.assert_allclose(m_b[k].numpy(), m_i.numpy().ravel(),
                                   rtol=1e-4,
                                   atol=1e-6 * np.abs(m_i.numpy()).max())
        np.testing.assert_allclose(s_b[k].numpy(), s_i.numpy().ravel(),
                                   rtol=1e-2,
                                   atol=1e-6 * np.abs(s_i.numpy()).max())


def test_views_memoize_and_refit_invalidates():
    X_lf = np.linspace(0, 1, 11)[:, None]
    X_hf = np.array([0.0, 0.3, 0.55, 0.8, 1.0])[:, None]
    Y_lf = forrester_lf(X_lf[:, 0])[None]
    Y_hf = forrester_hf(X_hf[:, 0])[None]
    b = TM.BatchedMFK(theta=[4.0], device="cpu").fit([X_lf, X_hf],
                                                     [Y_lf, Y_hf])
    v = TM._BatchedMFKView(b, 0)
    X_t = np.linspace(0, 1, 7)[:, None]
    m1, s1 = v.predict(X_t)
    assert m1.shape == (7, 1) and s1.shape == (7, 1)
    assert b._predict_cache is not None
    m1b, _ = v.predict(X_t)
    assert m1b is not m1 and torch.equal(m1b, m1)
    b.fit([X_lf, X_hf], [Y_lf * 2.0, Y_hf * 2.0])
    m2, _ = v.predict(X_t)
    np.testing.assert_allclose(m2.numpy(), 2.0 * m1.numpy(), rtol=1e-9)
    # the knobs have one source
    b.regr = "linear"
    assert b._proto.regr == "linear" and b.regr == "linear"


# ---------------------------------------------------------------------- #
# The pipeline, configuration A
# ---------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def config_a():
    args = mfk_problem()
    rj = j_mfk(*(jnp.asarray(a) for a in args))
    rt = t_mfk(*args, device="cpu")
    return args, rj, rt


def test_mfk_end_to_end_matches_jax(config_a):
    _, rj, rt = config_a
    assert rt.mean.shape == (8, 25) and rt.mse.shape == (8, 25)
    assert rt.theta.shape == (2, 8, 2) and rt.mean.dtype == torch.float64
    assert bool(torch.isfinite(rt.mean).all() and torch.isfinite(rt.mse).all())
    assert _rel(rt.mean, rj.mean) <= MEAN_REL
    assert _rel(rt.mse, rj.mse) <= MSE_REL
    np.testing.assert_allclose(np.log10(rt.theta.numpy()),
                               np.log10(np.asarray(rj.theta)), rtol=0,
                               atol=LOG_THETA_ABS)
    steps = rt.newton_steps.tolist()
    assert len(steps) == 2 and all(0 < s <= 100 for s in steps)


def test_default_box_floor_of_the_jax_package(config_a):
    """The floor the default-box bars stand on: the JAX package against
    itself with the LF and HF sites permuted moves θ by far more than
    1e-8 (so no θ bar of that order can hold across packages there), and
    the port lands within the bars of JAX."""
    (X_lf, Y_lf, X_hf, Y_hf, X_t), rj, rt = config_a
    g = np.random.default_rng(2)
    p0, p1 = g.permutation(X_lf.shape[0]), g.permutation(X_hf.shape[0])
    rp = j_mfk(*(jnp.asarray(a) for a in (X_lf[p0], Y_lf[:, p0], X_hf[p1],
                                          Y_hf[:, p1], X_t)))
    floor = np.abs(np.log10(np.asarray(rp.theta))
                   - np.log10(np.asarray(rj.theta))).max()
    assert 1e-6 < floor <= LOG_THETA_ABS
    assert _rel(rp.mean, rj.mean) <= MEAN_REL
    assert _rel(rp.mse, rj.mse) <= MSE_REL


def test_mfk_end_to_end_matches_batched(config_a):
    """The functional pipeline and the class give the same model (the JAX
    package's own test of its pair, ``tests/test_multifi.py:518``)."""
    (X_lf, Y_lf, X_hf, Y_hf, X_t), _, rt = config_a
    b = TM.BatchedMFK(device="cpu").fit([X_lf, X_hf], [Y_lf, Y_hf])
    m_b, s_b = b.predict(X_t)
    assert _rel(rt.mean, m_b) <= MEAN_REL
    assert _rel(rt.mse, s_b) <= MSE_REL
