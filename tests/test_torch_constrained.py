"""Port parity for the constrained entry points (CPU, float64 on both
sides): SPR COLS, ``ROM.CPOD``, ``ROM.adaptive_sampling`` and the
constrained ``GPR.predict`` — each against the JAX package on the same
numpy inputs, mirroring the JAX package's own tests of the behaviour
(``tests/test_spr.py``, ``tests/test_rom.py``, ``tests/test_gpr.py``).

Tolerances, float64:
* ADMM coefficients (COLS, CPOD, the constrained GP MAP): ``rtol=1e-9``
  with ``atol=1e-9 · max|a|``, and per-element iteration counts EQUAL
  where the model exposes them (``admm_info``): the fitted bases agree to
  ~1e-15 and the solver to round-off (``tests/test_torch_boxls.py``);
* the constraints themselves (limits, pins): the JAX tests' bars;
* ``adaptive_sampling``: the same candidate point, exactly (the candidates
  are the same LatinHypercube draws; only the argmax is compared).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmeasure_tpu import GPR as JGPR
from openmeasure_tpu import ROM as JROM
from openmeasure_tpu import SPR as JSPR
from openmeasure_tpu.core.config import SolverConfig as JSolverConfig
from openmeasure_tpu.linalg import boxls as JB
from openmeasure_tpu.utils import checkpoint as JCK
from openmeasure_torch import GPR as TGPR
from openmeasure_torch import ROM as TROM
from openmeasure_torch import SPR as TSPR
from openmeasure_torch.core.config import SolverConfig
from openmeasure_torch.linalg import boxls as TB
from openmeasure_torch.utils.convert import (GPR_ARRAY_KEYS, GPR_META_KEYS,
                                             gpr_from_numpy)

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


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _same_iterations(tmodel, jmodel):
    np.testing.assert_array_equal(tmodel.admm_info.iterations.numpy(),
                                  np.asarray(jmodel.admm_info.iterations))


# --------------------------------------------------------------------- #
# SPR COLS (the JAX package's TestSPR set-up; 4 modes, not all 5: the
# row-centred 5-snapshot set has rank 4, and the fifth mode's direction is
# arbitrary in both packages)
# --------------------------------------------------------------------- #

N_POINTS, NF, M = 10, 2, 5


@pytest.fixture(scope="module")
def spr_data():
    rng = np.random.default_rng(11)
    X = rng.random((N_POINTS * NF, M))
    xyz = rng.random((N_POINTS, 3))
    return X, xyz


def _spr_pair(spr_data, **fit_kw):
    X, xyz = spr_data
    js = JSPR(X, NF, xyz)
    ts = TSPR(X, NF, xyz, device="cpu")
    js.fit(**fit_kw)
    ts.fit(**fit_kw)
    _close(ts.Ur, js.Ur, rtol=1e-12)
    return js, ts


def _identity_y(X, col=0):
    y = np.zeros((X.shape[0], 3))
    y[:, 0] = X[:, col]
    for i in range(NF):
        y[i * N_POINTS:(i + 1) * N_POINTS, 2] = i
    return y


def _train_both(js, ts, C, **kw):
    js.train(C, **kw)
    ts.train(C, **kw)


def test_cols_inactive_limits_match_ols(spr_data):
    X, _ = spr_data
    js, ts = _spr_pair(spr_data, select_modes="number", n_modes=4)
    C = np.eye(X.shape[0])
    limits = [np.array([-1e7, -1e7]), np.array([1e7, 1e7])]
    _train_both(js, ts, C, method="COLS", limits=limits)
    at, _ = ts.predict(_identity_y(X))
    aj, _ = js.predict(_identity_y(X))
    _close(at, aj)
    _same_iterations(ts, js)
    ts.train(C, method="OLS")
    a_ols, _ = ts.predict(_identity_y(X))
    assert ts.admm_info is None
    np.testing.assert_allclose(at.numpy(), a_ols.numpy(), atol=1e-5)


def test_cols_enforces_limits(spr_data):
    X, _ = spr_data
    js, ts = _spr_pair(spr_data, select_modes="number", n_modes=4)
    limits = [np.array([0.25, 0.25]), np.array([0.75, 0.75])]
    _train_both(js, ts, np.eye(X.shape[0]), method="COLS", limits=limits)
    ys = [_identity_y(X, 0), _identity_y(X, 3)]
    at, st = ts.predict(ys)
    aj, sj = js.predict(ys)
    _close(at, aj)
    _close(st, sj)
    _same_iterations(ts, js)
    x = ts.reconstruct(at).numpy()
    assert np.all(x >= 0.25 - 1e-4) and np.all(x <= 0.75 + 1e-4)


def test_cols_general_constraints_with_per_vector_pins(spr_data):
    X, _ = spr_data
    js, ts = _spr_pair(spr_data, select_modes="number", n_modes=3)
    C = np.asarray(js.optimal_placement())
    np.testing.assert_array_equal(ts.optimal_placement().numpy(), C)
    Ur = np.asarray(js.Ur)
    n = Ur.shape[0]
    rows = np.argmax(C, axis=1)
    ys = []
    for col in (0, 2):
        y = np.zeros((len(rows), 3))
        y[:, 0] = X[rows, col]
        y[:, 2] = rows // N_POINTS
        ys.append(y)
    pin_vals = np.array([np.asarray(js.X0)[6, 0], np.asarray(js.X0)[6, 2]]) * 0.5
    parts = [(Ur, -5.0 * np.ones(n), 5.0 * np.ones(n)),
             (Ur[6][None, :], pin_vals[:, None], pin_vals[:, None])]
    js.train(C, method="COLS", constraints=[JB.LinearConstraints(*p)
                                            for p in parts],
             admm_max_iter=20000, admm_tol=1e-12)
    ts.train(C, method="COLS", constraints=[TB.LinearConstraints(*p)
                                            for p in parts],
             admm_max_iter=20000, admm_tol=1e-12)
    at, _ = ts.predict(ys)
    aj, _ = js.predict(ys)
    _close(at, aj)
    _same_iterations(ts, js)
    for v in range(2):
        np.testing.assert_allclose(Ur[6] @ at.numpy()[v], pin_vals[v],
                                   atol=1e-6)


def test_masked_placement_then_cols(spr_data):
    """After a masked placement zeroes rows of Ur, COLS solves with the
    exact (non-identity) Gram of the masked basis."""
    X, _ = spr_data
    js, ts = _spr_pair(spr_data, select_modes="number", n_modes=3)
    mask = np.ones(X.shape[0], dtype=bool)
    mask[12:] = False
    C = np.asarray(js.optimal_placement(mask=mask))
    np.testing.assert_array_equal(ts.optimal_placement(mask=mask).numpy(), C)
    limits = [np.array([-0.5, -0.5]), np.array([1.2, 1.2])]
    _train_both(js, ts, C, method="COLS", limits=limits)
    rows = np.argmax(C, axis=1)
    y = np.zeros((len(rows), 3))
    y[:, 0] = 3.0 * X[rows, 0]            # overshoot: the box is active
    y[:, 2] = rows // N_POINTS
    at, _ = ts.predict(y)
    aj, _ = js.predict(y)
    _close(at, aj)
    _same_iterations(ts, js)
    A_c, _, _, AtA = ts._cols_cache
    assert not torch.allclose(AtA, torch.eye(3, dtype=AtA.dtype))
    lo, hi = (t.numpy() for t in ts.scale_limits(limits))
    z = ts.Ur.numpy() @ at.numpy()[0]
    assert np.all(z >= lo - 1e-5) and np.all(z <= hi + 1e-5)
    assert np.any(np.isclose(z, hi, atol=1e-4)) or \
        np.any(np.isclose(z, lo, atol=1e-4))


def test_jax_style_train_call(spr_data):
    """The JAX signature, positionally and with ``solver_config``; the
    knobs land on the model and reach the solver."""
    X, _ = spr_data
    js, ts = _spr_pair(spr_data, select_modes="number", n_modes=4)
    C = np.eye(X.shape[0])
    limits = [np.array([0.3, 0.3]), np.array([0.7, 0.7])]
    args = (C, False, limits, "COLS", "ADMM", False, False, 3000, 1e-10, 1.3)
    js.train(*args)
    ts.train(*args)
    assert (ts.solver, ts.admm_max_iter, ts.admm_tol, ts.admm_over_relax) \
        == ("ADMM", 3000, 1e-10, 1.3)
    _close(ts.predict(_identity_y(X))[0], js.predict(_identity_y(X))[0])
    _same_iterations(ts, js)
    js.train(C, limits=limits, method="COLS", cond=True,
             solver_config=JSolverConfig(max_iter=50, tol=0.0,
                                         over_relax=1.5))
    ts.train(C, limits=limits, method="COLS", cond=True,
             solver_config=SolverConfig(max_iter=50, tol=0.0,
                                        over_relax=1.5))
    assert (ts.admm_max_iter, ts.admm_tol, ts.admm_over_relax) == \
        (50, 0.0, 1.5)
    np.testing.assert_allclose(ts.k, js.k, rtol=1e-10)
    at, _ = ts.predict(_identity_y(X, 1))
    _close(at, js.predict(_identity_y(X, 1))[0])
    assert (ts.admm_info.iterations == 50).all()


def test_cols_errors_and_refit(spr_data):
    X, _ = spr_data
    _, ts = _spr_pair(spr_data, select_modes="number", n_modes=4)
    ts.train(np.eye(X.shape[0]), method="COLS")
    with pytest.raises(ValueError, match="limits"):
        ts.predict(_identity_y(X))
    ts.train(np.eye(X.shape[0]), method="COLS", limits=[0.0, 1.0])
    ts.predict(_identity_y(X))
    assert ts._cols_cache is not None
    ts.fit(select_modes="number", n_modes=4)
    assert ts._cols_cache is None
    # a raw (A, lo, hi) triple is one constraint set, not three
    A = np.asarray(ts.Ur)[:3]
    ts.train(np.eye(X.shape[0]), method="COLS",
             constraints=(A, -np.ones(3), np.ones(3)))
    assert tuple(ts.constraints.A.shape) == A.shape


# --------------------------------------------------------------------- #
# ROM.CPOD and adaptive_sampling (the JAX package's TestROM set-up)
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def rom_data():
    rng = np.random.default_rng(0)
    X = rng.random((20, 6))
    xyz = rng.random((10, 3))
    return X, xyz


def _rom_pair(rom_data):
    X, xyz = rom_data
    jr, tr = JROM(X, 2, xyz), TROM(X, 2, xyz, device="cpu")
    jr.fit(select_modes="number", n_modes=3)
    tr.fit(select_modes="number", n_modes=3)
    _close(tr.Ur, jr.Ur, rtol=1e-12)
    return jr, tr


def test_cpod_mixed_equality_and_box(rom_data):
    """Box on every row plus a per-snapshot equality pin: all m snapshots
    in one batched solve (JAX: one vmapped program)."""
    jr, tr = _rom_pair(rom_data)
    Ur = np.asarray(jr.Ur)
    X0 = np.asarray(jr.X0)
    n, m = X0.shape
    pins = X0[4, :] * 0.5
    parts = [(Ur, -2.0 * np.ones(n), 2.0 * np.ones(n)),
             (Ur[4][None, :], pins[:, None], pins[:, None])]
    jr.CPOD(constraints=[JB.LinearConstraints(*p) for p in parts],
            max_iter=20000, tol=1e-12)
    tr.CPOD(constraints=[TB.LinearConstraints(*p) for p in parts],
            max_iter=20000, tol=1e-12)
    _close(tr.Ar, jr.Ar)
    _close(tr.Vr, jr.Vr)
    _same_iterations(tr, jr)
    np.testing.assert_allclose(Ur[4] @ tr.Ar.numpy().T, pins, atol=1e-6)


def test_cpod_limits_compose_with_constraints(rom_data):
    jr, tr = _rom_pair(rom_data)
    limits = [np.array([0.2, 0.2]), np.array([0.8, 0.8])]
    jr.CPOD(limits=limits, max_iter=20000, tol=1e-12)
    tr.CPOD(limits=limits, max_iter=20000, tol=1e-12)
    _close(tr.Ar, jr.Ar)
    _same_iterations(tr, jr)
    Ur = tr.Ur.numpy()
    pins = Ur[4] @ tr.Ar.numpy().T
    cs = (Ur[4][None, :], pins[:, None], pins[:, None])
    jr.CPOD(limits=limits, constraints=JB.LinearConstraints(*cs),
            max_iter=20000, tol=1e-12)
    tr.CPOD(limits=limits, constraints=TB.LinearConstraints(*cs),
            max_iter=20000, tol=1e-12)
    _close(tr.Ar, jr.Ar)
    _same_iterations(tr, jr)
    lo, hi = (t.numpy() for t in tr.scale_limits(limits))
    recon = Ur @ tr.Ar.numpy().T
    assert np.all(recon >= lo[:, None] - 1e-4)
    assert np.all(recon <= hi[:, None] + 1e-4)


def test_cpod_solver_config_solver_fn_and_errors(rom_data):
    jr, tr = _rom_pair(rom_data)
    limits = [np.array([0.3, 0.3]), np.array([0.7, 0.7])]
    jr.CPOD(limits=limits, solver_config=JSolverConfig(max_iter=80, tol=0.0))
    tr.CPOD(limits=limits, solver_config=SolverConfig(max_iter=80, tol=0.0))
    _close(tr.Ar, jr.Ar)
    assert (tr.admm_info.iterations == 80).all()
    Ar0 = tr.Ar.clone()
    tr.CPOD(solver_fn=lambda Ur, x0, g: 2.0 * g)
    assert tr.admm_info is None
    np.testing.assert_allclose(tr.Ar.numpy(), 2.0 * Ar0.numpy())
    with pytest.raises(ValueError, match="limits"):
        tr.CPOD()


def test_adaptive_sampling_matches_jax(rom_data):
    X, xyz = rom_data
    rng = np.random.default_rng(3)
    P = rng.random((X.shape[1], 2))
    jr, tr = JROM(X, 2, xyz), TROM(X, 2, xyz, device="cpu")
    for seed in (0, 5):
        sj = np.asarray(jr.adaptive_sampling(P, seed=seed))
        st = tr.adaptive_sampling(P, seed=seed)
        assert st.shape == (2,)
        np.testing.assert_array_equal(st, sj)
    np.testing.assert_array_equal(
        tr.adaptive_sampling(P, scale_type="range", seed=1),
        np.asarray(jr.adaptive_sampling(P, scale_type="range", seed=1)))
    assert not hasattr(tr, "X_cnt")          # the fit state is untouched


# --------------------------------------------------------------------- #
# Constrained GPR.predict (MultiTask), on state carried from JAX
# --------------------------------------------------------------------- #

def _gpr_state(jg):
    state = {a: np.asarray(getattr(jg, a)) for a in GPR_ARRAY_KEYS
             if getattr(jg, a, None) is not None}
    JCK._flatten_tree(jg.params, "params", state)
    meta = {k: getattr(jg, k) for k in GPR_META_KEYS if hasattr(jg, k)}
    meta.update(mean_spec=JCK._spec_to_json(jg.mean),
                kernel_spec=JCK._spec_to_json(jg.kernel),
                likelihood_spec=JCK._spec_to_json(jg.likelihood))
    return state, meta


@pytest.fixture(scope="module", params=["device", "host"])
def gp_pair(request):
    rng = np.random.default_rng(5)
    X = rng.random((30, 8))
    P = np.linspace(0, 1, 8)[:, None] + 0.01 * rng.random((8, 1))
    jg = JGPR(X, 2, rng.random((15, 3)), P, gpr_type="MultiTask")
    jg.fit(select_modes="number", n_modes=3)
    jg.train(max_iter=60, engine=request.param)
    tg = gpr_from_numpy(*_gpr_state(jg), device="cpu")
    assert tg.engine == request.param
    return jg, tg, X


def _both_predict(jg, tg, P_star, **kw):
    aj, sj = jg.predict(P_star, **kw)
    at, st = tg.predict(P_star, **kw)
    _close(at, aj)
    _close(st, sj, rtol=1e-10)
    if tg.engine == "host":
        assert at.device.type == "cpu" and at.dtype == torch.float64
    return at


def test_constrained_gpr_limits_and_per_point_bc(gp_pair):
    jg, tg, X = gp_pair
    limits = [np.array([X[:15].min(), X[15:].min()]) + 0.05,
              np.array([X[:15].max(), X[15:].max()]) - 0.05]
    P_star = np.array([[0.15], [0.55], [0.9]])
    at = _both_predict(jg, tg, P_star, limits=limits)
    x = tg.reconstruct(at).numpy()                       # (n, 3)
    lo = np.repeat(limits[0], 15)[:, None]
    hi = np.repeat(limits[1], 15)[:, None]
    assert np.all(x >= lo - 1e-5) and np.all(x <= hi + 1e-5)
    # per-point pins at the limits-only MAP's values: jointly feasible with
    # the box by construction (an arbitrary pin may not be, in 3 modes)
    pins = np.round(x[4][None, :], 3)                   # (n_bc, n_p)
    at = _both_predict(jg, tg, P_star, limits=limits, bc=([4], pins),
                       max_iter=8000, tol=1e-11)
    np.testing.assert_allclose(tg.reconstruct(at).numpy()[4], pins[0],
                               atol=1e-6)
    # problem_dict carries the same contract
    at2 = _both_predict(jg, tg, P_star,
                        problem_dict={"limits": limits, "bc": ([4], pins)},
                        max_iter=8000, tol=1e-11)
    _close(at2, at.numpy(), rtol=1e-12)


def test_constrained_gpr_general_constraints(gp_pair):
    jg, tg, _ = gp_pair
    P_star = np.array([[0.2], [0.7]])
    A = np.array([[1.0, 0.5, 0.0], [0.0, 1.0, -1.0]])
    lo = np.array([[-0.1, -0.2], [0.0, -0.1]])           # per point
    hi = np.array([[0.1, 0.2], [0.05, 0.1]])
    aj, _ = jg.predict(P_star, constraints=JB.LinearConstraints(A, lo, hi))
    at, _ = tg.predict(P_star, constraints=TB.LinearConstraints(A, lo, hi))
    _close(at, aj)
    v = at.numpy() / tg.Sigma_r.numpy()[None, :]
    z = np.einsum("qr,pr->pq", A, v)
    assert np.all(z >= lo - 1e-6) and np.all(z <= hi + 1e-6)


def test_constrained_gpr_errors(gp_pair):
    jg, tg, X = gp_pair
    with pytest.raises(ValueError, match="bc values"):
        tg.predict(np.array([[0.2], [0.4]]), bc=([1], np.ones((1, 3))))
    rng = np.random.default_rng(6)
    single = TGPR(X, 2, rng.random((15, 3)), np.linspace(0, 1, 8)[:, None],
                  device="cpu")
    single.fit(select_modes="number", n_modes=2)
    single.train(max_iter=5)
    with pytest.raises(NotImplementedError, match="MultiTask"):
        single.predict(np.array([[0.5]]), limits=[0.0, 1.0])
