"""Port parity for the temporal layer (``openmeasure_torch/dynamics/dmd.py``,
``dynamics/kalman.py`` and ``serving.DynamicSensor``), CPU, float64 against
JAX x64, on the series of ``tests/test_dynamics.py``.

Tolerances: the host functions (numpy and scipy on both sides) to 1e-12;
DMD eigenvalues, amplitudes, modes, forecasts and reconstructions to 1e-9
(the same Gram-route SVD in another summation order, then the same host
complex128 analysis), growth rates and frequencies to 1e-9 of |ω|; the
Kalman filter and smoother to 1e-10 (1e-6 where exact readings leave the
innovation covariance at its 1e-6 relative floor), rejection masks equal;
the served series, forecasts and carries to 1e-9.  A disabled gate
(``None``, ``inf``, or one so wide that nothing is rejected) is held
bit-equal with ``torch.equal``.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmeasure_tpu import SPR as JSPR
from openmeasure_tpu.dynamics import dmd as jdmd
from openmeasure_tpu.dynamics import kalman as jkf
from openmeasure_tpu.serving import DynamicSensor as JDynamicSensor
from openmeasure_torch import DMD, DynamicSensor, SoftSensor
from openmeasure_torch.dynamics import kalman as tkf
from openmeasure_torch.utils.convert import (ARRAY_KEYS, META_KEYS,
                                             spr_from_numpy)
from test_dynamics import _oscillatory_series, _timeseries_dataset


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The filter loops run many tiny torch ops; one intra-op thread keeps
    torch's OpenMP threads from spinning beside the other workers of a
    parallel run (the count is restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


def _order(lam):
    return np.lexsort((np.round(lam.imag, 9), np.round(lam.real, 9)))


# ---------------------------------------------------------------------- #
# host functions
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("ridge", [0.0, 0.3])
def test_host_functions_match_jax(ridge):
    rng = np.random.default_rng(3)
    Ar = np.cumsum(rng.standard_normal((30, 5)), axis=0) * 0.1
    A_j = jkf.fit_reduced_operator(Ar, ridge=ridge)
    A_t = tkf.fit_reduced_operator(Ar, ridge=ridge)
    _close(A_t, A_j, 1e-12)
    _close(tkf.estimate_process_noise(A_t, Ar, floor_rel=1e-6),
           jkf.estimate_process_noise(A_j, Ar, floor_rel=1e-6), 1e-12)
    Q = jkf.estimate_process_noise(A_j, Ar)
    for A in (0.8 * A_j / np.max(np.abs(np.linalg.eigvals(A_j))),
              1.1 * np.eye(5)):                  # stable, unstable
        _close(tkf.stationary_covariance(A, Q),
               jkf.stationary_covariance(A, Q), 1e-12)
    for bad in (np.zeros((1, 3)), np.zeros(4)):
        msgs = []
        for fn in (jkf.fit_reduced_operator, tkf.fit_reduced_operator):
            with pytest.raises(ValueError) as e:
                fn(bad)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------- #
# DMD
# ---------------------------------------------------------------------- #

def _dmd_pair(X, n_features, **fit_kw):
    n_points = X.shape[0] // n_features
    xyz = np.zeros((n_points, 3))
    jd = jdmd.DMD(X, n_features, xyz)
    jd.fit(**fit_kw)
    td = DMD(X, n_features, xyz, device="cpu")
    td.fit(**fit_kw)
    return jd, td


@pytest.mark.parametrize("series,fit_kw", [
    ("oscillatory", dict(dt=0.5, select_modes="number", n_modes=4)),
    ("timeseries", dict(dt=1.0, select_modes="number", n_modes=6)),
    ("timeseries", dict(dt=2.0, select_modes="variance", n_modes=99.9,
                        scale_type="range"))])
def test_dmd_matches_jax(series, fit_kw):
    if series == "oscillatory":
        X, nf = _oscillatory_series()[0], 2
    else:
        X, nf = _timeseries_dataset(noise=0.02)[0], 2
    jd, td = _dmd_pair(X, nf, **fit_kw)
    assert td.r == jd.r
    oj, ot = _order(jd.eigs), _order(td.eigs)
    _close(td.eigs[ot], jd.eigs[oj], 1e-9)
    _close(td.omega[ot], jd.omega[oj], 1e-9)
    _close(td.amplitudes[ot], jd.amplitudes[oj], 1e-9)
    # the real and imaginary parts of ω, each to 1e-9 of |ω| (a pure
    # rotation's growth rate is a round-off zero)
    w_scale = 1e-9 * np.abs(jd.omega).max()
    for part in ("frequencies", "growth_rates"):
        np.testing.assert_allclose(getattr(td, part)[ot],
                                   getattr(jd, part)[oj], rtol=1e-9,
                                   atol=w_scale)
    _close(td.A_tilde, jd.A_tilde, 1e-9)
    for exact in (True, False):
        _close(td.modes(exact)[:, ot], jd.modes(exact)[:, oj], 1e-9)
        _close(td.forecast([0, 3, 7], exact=exact),
               jd.forecast([0, 3, 7], exact=exact), 1e-9)
        _close(td.forecast_horizon(5, exact=exact),
               jd.forecast_horizon(5, exact=exact), 1e-9)
        _close(td.reconstruct_dmd(exact=exact),
               jd.reconstruct_dmd(exact=exact), 1e-9)
    _close(td.Ar, jd.Ar, 1e-9)
    _close(td.Sigma_r, jd.Sigma_r, 1e-9)
    assert isinstance(td.forecast(2), torch.Tensor)


def test_dmd_rank_clamp_warns_as_jax():
    """The series of ``TestDMDGuards`` (rank 2 plus a constant, unscaled):
    asking for 5 modes clamps with JAX's warning, and the kept spectrum
    holds the true eigenvalues.  Where the clamp lands (2 or 3) depends on
    whether a round-off singular value falls under the eps·max·√n floor,
    in both packages, so the clamped rank is held to JAX's own bar (≤ 3),
    not to JAX's value."""
    rng = np.random.default_rng(0)
    U = np.linalg.qr(rng.standard_normal((60, 2)))[0]
    a = rng.standard_normal(2)
    X = U @ np.stack([a * np.array([0.9, 0.7]) ** k for k in range(20)],
                     axis=1) + 5.0
    for cls, kw in ((jdmd.DMD, {}), (DMD, {"device": "cpu"})):
        d = cls(X, 1, None, **kw)
        with pytest.warns(UserWarning, match=r"DMD rank clamped 5 -> \d: "
                          "the requested mode count exceeds"):
            d.fit(select_modes="number", n_modes=5, scale_type="none",
                  axis_cnt=None)
        assert d.r <= 3
        mags = np.sort(np.abs(d.eigs))[::-1]
        assert mags[0] < 1.0 + 1e-6
        for lam_true in (0.9, 0.7):
            assert np.min(np.abs(mags - lam_true)) < 1e-6, (mags, lam_true)


def test_dmd_validation_matches_jax():
    X = _oscillatory_series()[0]
    xyz = np.zeros((40, 3))
    jd, td = _dmd_pair(X, 2, select_modes="number", n_modes=4)
    fresh = (jdmd.DMD(X, 2, xyz), DMD(X, 2, xyz, device="cpu"))
    cases = [
        (ValueError, lambda d: d.fit(dt=0.0)),
        (ValueError, lambda d: type(d)(X[:, :1], 2, xyz,
                                       **({} if type(d) is jdmd.DMD
                                          else {"device": "cpu"})).fit()),
    ]
    for exc, call in cases:
        msgs = []
        for d in fresh:
            with pytest.raises(exc) as e:
                call(d)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    for exc, call in [(ValueError, lambda d: d.forecast([[1, 2]])),
                      (ValueError, lambda d: d.forecast([0.5])),
                      (NotImplementedError, lambda d: d.update_basis(X))]:
        msgs = []
        for d in (jd, td):
            with pytest.raises(exc) as e:
                call(d)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    msgs = []
    for d in fresh:
        with pytest.raises(AttributeError) as e:
            d.forecast(1)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------- #
# Kalman filter and smoother
# ---------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def lgs():
    """The linear-Gaussian system of ``TestInnovationGating``, with one
    outlier, a missing-reading variance and a σ = 0 entry."""
    rng = np.random.default_rng(23)
    r, s, K = 4, 6, 30
    A = 0.9 * np.linalg.qr(rng.standard_normal((r, r)))[0]
    M = rng.standard_normal((r, r))
    Q = 0.05 * (M @ M.T) + 0.01 * np.eye(r)
    H = rng.standard_normal((s, r))
    a0 = rng.standard_normal(r)
    P0 = np.eye(r)
    Lq = np.linalg.cholesky(Q)
    a = a0.copy()
    Y = []
    for _ in range(K):
        a = A @ a + Lq @ rng.standard_normal(r)
        Y.append(H @ a + 0.2 * rng.standard_normal(s))
    Y = np.array(Y)
    Y[12, 2] += 50.0                                  # stuck-sensor spike
    R = np.full((K, s), 0.04)
    R[5, 1] = 1e12                                    # missing reading
    R[9, 4] = 0.0                                     # exact reading
    return A, Q, H, a0, P0, Y, R


@pytest.mark.parametrize("smoother", [False, True])
@pytest.mark.parametrize("gate", [None, 4.0, 1.5])
def test_kalman_matches_jax(lgs, smoother, gate):
    jfn = jkf.kalman_smoother if smoother else jkf.kalman_filter
    tfn = tkf.kalman_smoother if smoother else tkf.kalman_filter
    m_j, v_j, (a_j, P_j), rej_j = jfn(*map(jnp.asarray, lgs), gate=gate,
                                      return_rejected=True)
    m_t, v_t, (a_t, P_t), rej_t = tfn(*map(torch.as_tensor, lgs), gate=gate,
                                      return_rejected=True)
    for got, want in ((m_t, m_j), (v_t, v_j), (a_t, a_j), (P_t, P_j)):
        _close(got, want, 1e-10)
    np.testing.assert_array_equal(rej_t.numpy(), np.asarray(rej_j))
    if gate is not None:
        assert rej_t[12, 2]
    out = tfn(*map(torch.as_tensor, lgs), gate=gate)
    assert len(out) == 3 and torch.equal(out[0], m_t)


@pytest.mark.parametrize("smoother", [False, True])
def test_disabled_gate_is_bit_identical(lgs, smoother):
    fn = tkf.kalman_smoother if smoother else tkf.kalman_filter
    args = list(map(torch.as_tensor, lgs))
    args[5] = torch.as_tensor(lgs[5] - np.where(
        np.arange(lgs[5].shape[0])[:, None] == 12, 50.0, 0.0)
        * (np.arange(lgs[5].shape[1])[None, :] == 2))
    ref = fn(*args, gate=None, return_rejected=True)
    assert not bool(ref[3].any())
    for gate in (float("inf"), 1e30):
        got = fn(*args, gate=gate, return_rejected=True)
        for g, w in ((got[0], ref[0]), (got[1], ref[1]),
                     (got[2][0], ref[2][0]), (got[2][1], ref[2][1]),
                     (got[3], ref[3])):
            assert torch.equal(g, w)


def test_kalman_edge_cases_match_jax(lgs):
    A, Q, H, a0, P0, Y, R = lgs
    # an empty series: the filter returns empty results, the smoother raises
    m_j, v_j, (aK, _) = jkf.kalman_filter(*map(jnp.asarray, (A, Q, H, a0, P0,
                                                             Y[:0], R[:0])))
    m_t, v_t, (aK_t, _), rej = tkf.kalman_filter(
        *map(torch.as_tensor, (A, Q, H, a0, P0, Y[:0], R[:0])),
        return_rejected=True)
    assert m_t.shape == np.asarray(m_j).shape and rej.shape == (0, 6)
    _close(aK_t, aK, 1e-12)
    msgs = []
    for fn, conv in ((jkf.kalman_smoother, jnp.asarray),
                     (tkf.kalman_smoother, torch.as_tensor)):
        with pytest.raises(ValueError) as e:
            fn(*map(conv, (A, Q, H, a0, P0, Y[:0], R[:0])))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    # one frame: the smoother is the filter
    sm = tkf.kalman_smoother(*map(torch.as_tensor,
                                  (A, Q, H, a0, P0, Y[:1], R[:1])))
    fi = tkf.kalman_filter(*map(torch.as_tensor,
                                (A, Q, H, a0, P0, Y[:1], R[:1])))
    assert torch.equal(sm[0], fi[0]) and torch.equal(sm[1], fi[1])
    # more sensors than modes with exact readings: the relative R floor
    # keeps S = H P Hᵀ + R positive definite, with a condition number up to
    # 1/_R_FLOOR_REL = 1e6, so float64 round-off reaches ~1e-10 a solve and
    # the means are held to 1e-6
    Rz = np.zeros_like(R)
    _close(tkf.kalman_filter(*map(torch.as_tensor, (A, Q, H, a0, P0, Y,
                                                    Rz)))[0],
           jkf.kalman_filter(*map(jnp.asarray, (A, Q, H, a0, P0, Y, Rz)))[0],
           1e-6)


# ---------------------------------------------------------------------- #
# DynamicSensor
# ---------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def served():
    """The JAX SPR of ``TestDynamicSensor`` and the port SPR carrying its
    state; a noisy measurement series of the continuation, with dropped
    readings."""
    X_train, X_test = _timeseries_dataset(noise=0.02)
    xyz = np.random.default_rng(0).standard_normal((75, 3))
    js = JSPR(X_train, 2, xyz)
    js.fit(select_modes="number", n_modes=6)
    C = np.array(js.optimal_placement(calc_type="qr"))
    js.train(C)
    state = {a: np.array(getattr(js, a)) for a in ARRAY_KEYS
             if a != "C" and getattr(js, a, None) is not None}
    state["C"] = C
    meta = {k: getattr(js, k) for k in META_KEYS if hasattr(js, k)}
    ts = spr_from_numpy(state, meta, device="cpu")
    rng = np.random.default_rng(21)
    Y_clean = (C @ X_test).T
    sigma = 0.5 * np.std(Y_clean, axis=0)
    Y = Y_clean + rng.standard_normal(Y_clean.shape) * sigma[None, :]
    Y[3, :] = np.nan                                  # a lost frame
    Y[7, 0] = np.nan                                  # one dead sensor
    S = np.broadcast_to(sigma, Y.shape).copy()
    S[11, 2] = np.inf                                 # infinite σ: ignore
    return js, ts, X_test, Y, S


def _sensors(js, ts, **kw):
    return (JDynamicSensor.from_spr(js, dtype=jnp.float64, **kw),
            DynamicSensor.from_spr(ts, dtype=torch.float64, **kw))


def _same(got, want, rtol=1e-9):
    for g, w in zip(got, want):
        _close(g, w, rtol)


@pytest.mark.parametrize("kw", [{}, dict(gate=3.0, ridge=0.1, q_floor=1e-6,
                                          r_floor=1e-4)])
def test_dynamic_sensor_batches_match_jax(served, kw):
    js, ts, _, Y, S = served
    jsen, tsen = _sensors(js, ts, **kw)
    _same(tsen.filter_batch(Y, S), jsen.filter_batch(Y, S))
    np.testing.assert_array_equal(tsen.last_rejected.numpy(),
                                  np.asarray(jsen.last_rejected))
    _same(tsen.smooth_batch(Y, S), jsen.smooth_batch(Y, S))
    assert tsen.rejected_fraction() == pytest.approx(
        jsen.rejected_fraction(), abs=1e-12)
    _same(tsen.filter_batch(Y[:, :]), jsen.filter_batch(Y))   # σ = None
    _same(tsen.forecast(6), jsen.forecast(6))
    # streaming: persist, step, and the carry
    _same(tsen.filter_batch(Y[:10], S[:10], persist=True),
          jsen.filter_batch(Y[:10], S[:10], persist=True))
    _same(tsen.step(Y[10], S[10]), jsen.step(Y[10], S[10]))
    _same(tsen.forecast(4, from_carry=True), jsen.forecast(4, from_carry=True))
    _same(tsen.smooth_batch(Y[11:20], S[11:20], persist=True),
          jsen.smooth_batch(Y[11:20], S[11:20], persist=True))
    _same(tsen.forecast(3, persist=True), jsen.forecast(3, persist=True))
    _same((tsen._a, tsen._P), (jsen._a, jsen._P))
    _same(tsen.step(Y[20]), jsen.step(Y[20]))
    tsen.reset()
    jsen.reset()
    _same((tsen._a, tsen._P), (jsen._a, jsen._P))


def test_dynamic_sensor_filters_and_holds_its_contracts(served):
    js, ts, X_test, Y, S = served
    _, tsen = _sensors(js, ts)
    static = SoftSensor.from_spr(ts, dtype=torch.float64)
    ok = np.isfinite(Y).all(axis=1) & np.isfinite(S).all(axis=1)
    X_kf = tsen.filter_batch(Y, S)[0]
    X_st = static.predict_batch(Y[ok], S[ok])[0]
    err_kf = np.linalg.norm(X_kf.numpy()[ok] - X_test.T[ok])
    err_st = np.linalg.norm(X_st.numpy() - X_test.T[ok])
    assert np.isfinite(X_kf.numpy()).all() and err_kf < 0.8 * err_st
    # step by step equals the batch filter
    tsen.reset()
    batch = tsen.filter_batch(Y[:5], S[:5])[0]
    for k in range(5):
        x_k = tsen.step(Y[k], S[k])[0]
    assert torch.allclose(x_k, batch[4], rtol=1e-12, atol=1e-12)
    tsen.warmup(batch=3)


def test_dynamic_sensor_validation_matches_jax(served):
    js, ts, _, Y, _ = served
    jsen, tsen = _sensors(js, ts)
    for call in (lambda s: s.filter_batch(Y[0]),
                 lambda s: s.step(Y[:2]),
                 lambda s: s.forecast(0)):
        msgs = []
        for s in (jsen, tsen):
            with pytest.raises(ValueError) as e:
                call(s)
            msgs.append(str(e.value).replace("torch.Size", ""))
        assert msgs[0].split(";")[0] == msgs[1].split(";")[0]
    msgs = []
    for cls, spr in ((JDynamicSensor, js), (DynamicSensor, ts)):
        with pytest.raises(ValueError) as e:
            cls.from_spr(spr, gate=-1.0)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    untrained = spr_from_numpy(
        {k: np.array(getattr(js, k)) for k in ("X_cnt", "X_scl", "Ur", "Ar")},
        {"n_features": 2}, device="cpu")
    with pytest.raises(ValueError, match="needs a trained SPR"):
        DynamicSensor.from_spr(untrained)
    with pytest.raises(FileNotFoundError):
        DynamicSensor.load("x.npz", device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        tsen.shard(None)
    from openmeasure_torch.parallel.harness import local_world
    with local_world("cpu") as mesh:
        got = tsen.shard(mesh).filter_batch(Y)
    for a, b in zip(got, tsen.filter_batch(Y)):
        assert torch.equal(a, b)
    assert DynamicSensor.from_spr(ts).filter_batch(Y)[0].dtype == torch.float32
