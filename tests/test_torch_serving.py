"""Port parity for serving (``openmeasure_torch/serving.py``): ``SoftSensor``
and ``GPRSensor`` against the JAX package's on the same models, CPU,
float64 — each port model built from the JAX model's state by
``spr_from_numpy``/``gpr_from_numpy``, so both sensors package the same
numbers (mirrors the JAX tests in ``tests/test_utils.py``).

Tolerances, float64:
* OLS fields, coefficients and σ: ``rtol=1e-10`` (one QR solve with a
  refinement step, or one pinv product);
* COLS and the constrained GP MAP at a fixed ADMM budget: ``rtol=1e-9``
  with ``atol=1e-9 · max``, the solver's parity bar
  (``tests/test_torch_boxls.py``);
* a sensor against the eager model it packages: the JAX tests' bars.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from openmeasure_tpu import GPR as JGPR
from openmeasure_tpu import SPR as JSPR
from openmeasure_tpu import serving as JS
from openmeasure_tpu.linalg import boxls as JB
from openmeasure_tpu.utils import checkpoint as JCK
from openmeasure_torch import GPR as TGPR
from openmeasure_torch import GPRSensor, SoftSensor
from openmeasure_torch import serving as TS
from openmeasure_torch.linalg import boxls as TB
from openmeasure_torch.utils.convert import (ARRAY_KEYS, GPR_ARRAY_KEYS,
                                             GPR_META_KEYS, META_KEYS,
                                             gpr_from_numpy, spr_from_numpy)


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


def _close(got, want, rtol):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


def _spr_state(js):
    """A JAX SPR's state under the checkpoint's key names."""
    state = {a: np.asarray(getattr(js, a)) for a in ARRAY_KEYS
             if a != "C" and getattr(js, a, None) is not None}
    state["C"] = js.C if sp.issparse(js.C) else np.asarray(js.C)
    if getattr(js, "limits", None) is not None:
        state["limits/lo"], state["limits/hi"] = map(np.asarray, js.limits)
    if getattr(js, "constraints", None) is not None:
        for k, v in zip(("A", "lo", "hi"), js.constraints):
            state[f"constraints/{k}"] = np.asarray(v)
    meta = {k: getattr(js, k) for k in META_KEYS if hasattr(js, k)}
    return state, meta


def _spr_pair(seed, n_modes=4, C_kind="dense", **train_kw):
    """A trained JAX SPR (30 rows, 2 features, 6 snapshots) and the port
    SPR carrying its state; the QR placement's rows."""
    rng = np.random.default_rng(seed)
    X = rng.random((30, 6))
    js = JSPR(X, 2, rng.random((15, 3)))
    js.fit(select_modes="number", n_modes=n_modes)
    C = np.asarray(js.optimal_placement())
    js.train(sp.csr_matrix(C) if C_kind == "sparse" else C, **train_kw)
    ts = spr_from_numpy(*_spr_state(js), device="cpu")
    return js, ts, X, np.argmax(C, axis=1)


def _sensors(js, ts, **kw):
    return (JS.SoftSensor.from_spr(js, dtype=np.float64, **kw),
            SoftSensor.from_spr(ts, dtype=torch.float64, **kw).warmup())


def _same_outputs(got, want, rtol):
    for g, w in zip(got, want):
        _close(g, w, rtol)


def test_ols_sensor_matches_jax_and_the_eager_model():
    js, ts, X, rows = _spr_pair(2)
    sj, st = _sensors(js, ts)
    assert st.method == "OLS" and st.Ur.dtype == torch.float64
    y = X[rows, 1]
    _close(st(y), sj(y), 1e-10)
    _same_outputs(st.predict_full(y, 0.3 * np.ones(4)),
                  sj.predict_full(y, 0.3 * np.ones(4)), 1e-10)
    # the sensor reproduces the eager SPR.predict + reconstruct it packages
    yv = np.zeros((4, 3))
    yv[:, 0], yv[:, 2] = y, rows // 15
    a_ref, _ = ts.predict(yv)
    _close(st(y), ts.reconstruct(a_ref).numpy()[:, 0], 1e-8)
    rng = np.random.default_rng(5)
    Yv = X[rows, :1].T + 0.02 * rng.standard_normal((7, 4))
    Ys = np.abs(0.1 * rng.standard_normal((7, 4)))
    Ys[2] = 0.0                                  # one unweighted request
    xb, ab, sb = st.predict_batch(Yv, Ys)
    assert tuple(xb.shape) == (7, 30) and tuple(ab.shape) == (7, 4)
    _same_outputs((xb, ab, sb), sj.predict_batch(Yv, Ys), 1e-10)
    for i in range(7):
        _same_outputs(st.predict_full(Yv[i], Ys[i]), (xb[i], ab[i], sb[i]),
                      1e-12)


@pytest.mark.parametrize("sigma", [[0.1, 0.0, 0.3, 0.2],
                                   [0.1, -0.2, 0.3, 0.2]],
                         ids=["zero", "negative"])
def test_weighted_sigma_rules_match_jax_and_spr(sigma):
    """σ = 0 inside a weighted vector takes the largest weight, a negative
    σ takes the weighted path as in ``SPR.predict``."""
    js, ts, X, rows = _spr_pair(21)
    sj, st = _sensors(js, ts)
    rng = np.random.default_rng(21)
    y = np.zeros((4, 3))
    y[:, 0] = X[rows, 1] + 0.01 * rng.standard_normal(4)
    y[:, 1] = sigma
    y[:, 2] = rows // 15
    out = st.predict_full(y[:, 0], y[:, 1])
    _same_outputs(out, sj.predict_full(y[:, 0], y[:, 1]), 1e-10)
    a_ref, s_ref = ts.predict(y)
    _close(out[0], ts.reconstruct(a_ref).numpy()[:, 0], 1e-8)
    _close(out[2], s_ref.numpy()[0], 1e-8)


def test_nan_sigma_propagates_and_shapes_are_checked():
    js, ts, X, rows = _spr_pair(2)
    st = SoftSensor.from_spr(ts, dtype=torch.float64)
    _, a, _ = st.predict_full(X[rows, 1], np.array([np.nan, 0.1, 0.1, 0.1]))
    assert torch.isnan(a).all()
    with pytest.raises(ValueError, match="y_values must be"):
        st(3.7)
    with pytest.raises(ValueError, match="y_values must be"):
        st(np.array([3.7]))
    x, _, _ = st.predict_full(X[rows, 1], 0.1)          # scalar σ broadcasts
    assert torch.isfinite(x).all()
    with pytest.raises(ValueError, match="batch"):
        st.predict_batch(np.zeros((5,)))


@pytest.mark.parametrize("admm_rho", ["adaptive", "fixed"])
def test_cols_limits_sensor_matches_jax(admm_rho):
    js, ts, X, rows = _spr_pair(
        9, n_modes=3, method="COLS",
        limits=[np.array([-0.4, -0.4]), np.array([1.3, 1.3])],
        admm_max_iter=3000, admm_tol=1e-11)
    assert ts.method == "COLS" and ts.admm_tol == 1e-11
    sj, st = _sensors(js, ts, admm_iters=3000, admm_rho=admm_rho)
    assert st.method == "COLS" and st.admm_rho == admm_rho
    y = 3.0 * X[rows, 1]                  # overshoot: the limits are active
    out = st.predict_full(y)
    _same_outputs(out, sj.predict_full(y), 1e-9)
    x = out[0].numpy()
    assert x[:15].max() <= 1.3 + 1e-5 and x[:15].min() >= -0.4 - 1e-5
    # against the eager COLS predict of the same model
    yv = np.zeros((3, 3))
    yv[:, 0], yv[:, 2] = y, rows // 15
    a_ref, _ = ts.predict(yv)
    _close(out[0], ts.reconstruct(a_ref).numpy()[:, 0], 1e-6)
    Yv = 3.0 * X[rows, :2].T
    xb, ab, sb = st.predict_batch(Yv)
    _same_outputs((xb, ab, sb), sj.predict_batch(Yv), 1e-9)
    _close(xb[1], st(Yv[1]).numpy(), 1e-12)


def test_cols_general_constraints_sensor_matches_jax():
    rng = np.random.default_rng(10)
    X = rng.random((30, 6))
    js = JSPR(X, 2, rng.random((15, 3)))
    js.fit(select_modes="number", n_modes=3)
    C = np.asarray(js.optimal_placement())
    Ur = np.asarray(js.Ur)
    pin = float(np.asarray(js.X0)[7, 1]) * 0.5
    js.train(C, method="COLS", constraints=[
        JB.LinearConstraints(Ur, -5.0 * np.ones(30), 5.0 * np.ones(30)),
        JB.LinearConstraints(Ur[7][None, :], np.array([pin]),
                             np.array([pin]))],
        admm_max_iter=5000, admm_tol=1e-12)
    ts = spr_from_numpy(*_spr_state(js), device="cpu")
    assert tuple(ts.constraints.A.shape) == (31, 3)
    sj, st = _sensors(js, ts, admm_iters=5000)
    y = X[np.argmax(C, axis=1), 1]
    out = st.predict_full(y)
    _same_outputs(out, sj.predict_full(y), 1e-9)
    np.testing.assert_allclose(float(Ur[7] @ out[1].numpy()), pin, atol=1e-6)


def test_sparse_C_feature_ids_and_one_hot_detection():
    js, ts, X, rows = _spr_pair(4, C_kind="sparse")
    assert sp.issparse(ts.C)
    sj, st = _sensors(js, ts)
    _close(st(X[rows, 2]), sj(X[rows, 2]), 1e-10)
    rng = np.random.default_rng(4)
    C2 = sp.csr_matrix(rng.random((5, 30)))
    ts.train(C2)
    with pytest.raises(ValueError, match="feature_ids"):
        SoftSensor.from_spr(ts)
    s2 = SoftSensor.from_spr(ts, feature_ids=np.zeros(5, int),
                             dtype=torch.float64)
    js.train(C2)
    j2 = JS.SoftSensor.from_spr(js, feature_ids=np.zeros(5, int),
                                dtype=np.float64)
    y2 = np.asarray(C2 @ X[:, 0])
    _close(s2(y2), j2(y2), 1e-10)
    # duplicate COO entries summing to 2 are not one-hot
    Cd = sp.coo_matrix((np.ones(2), ([0, 0], [3, 3])), shape=(1, 30))
    with pytest.raises(ValueError, match="feature_ids"):
        TS._measurement_scaling(Cd, np.arange(30.0), np.ones(30), 15)


def test_knob_validation_and_over_relax():
    js, ts, _, _ = _spr_pair(
        13, n_modes=3, method="COLS",
        limits=[np.array([-1.0, -1.0]), np.array([2.0, 2.0])],
        admm_over_relax=1.3)
    assert SoftSensor.from_spr(ts).admm_over_relax == 1.3
    with pytest.raises(ValueError, match="admm_rho"):
        SoftSensor.from_spr(ts, admm_rho="bogus")
    ts.train(ts.C, method="COLS", limits=[0.0, 1.0],
             constraints=TB.LinearConstraints(np.asarray(ts.Ur)[:2],
                                              np.zeros((3, 2)),
                                              np.ones((3, 2))))
    with pytest.raises(ValueError, match="batched"):
        SoftSensor.from_spr(ts)


def test_rank_deficient_and_tiny_scale_theta():
    """A singular Θ gives finite (regularized) weighted output; a
    well-conditioned tiny-scale fp32 Θ is not over-regularized."""
    rng = np.random.default_rng(12)
    n, r, s = 30, 3, 4
    Ur, _ = np.linalg.qr(rng.standard_normal((n, r)))
    Theta = Ur[:s].copy()
    Theta[:, 2] = Theta[:, 1]
    st = SoftSensor(Ur, Theta, np.zeros(s), np.ones(s), np.zeros(n),
                    np.ones(n), dtype=torch.float64, device="cpu")
    x, _, sig = st.predict_full(rng.standard_normal(s), 0.1 * np.ones(s))
    assert torch.isfinite(x).all() and torch.isfinite(sig).all()
    rng = np.random.default_rng(14)
    s = 5
    Theta = 1e-8 * rng.standard_normal((s, r))
    st = SoftSensor(Ur, Theta, np.zeros(s), np.ones(s), np.zeros(n),
                    np.ones(n), dtype=torch.float32, device="cpu")
    yv = 1e-8 * rng.standard_normal(s)
    _, a, _ = st.predict_full(yv.astype(np.float32),
                              0.5 * np.ones(s, np.float32))
    a64, *_ = np.linalg.lstsq(Theta * 2.0, 2.0 * yv, rcond=None)
    assert np.max(np.abs(a.numpy() - a64)) / np.max(np.abs(a64)) < 1e-4


def test_load_and_shard_name_item_14():
    js, ts, _, _ = _spr_pair(2)
    st = SoftSensor.from_spr(ts)
    for call in (lambda: st.shard(None),
                 lambda: TS.shard_state_rows({}, None)):
        with pytest.raises(TypeError, match="DeviceMesh"):
            call()
    # a world of one in this process serves the unsharded results
    from openmeasure_torch.parallel.harness import local_world
    Y = np.random.default_rng(1).standard_normal((3, st.s))
    with local_world("cpu") as mesh:
        got = st.shard(mesh).predict_batch(Y)
    for a, b in zip(got, st.predict_batch(Y)):
        assert torch.equal(a, b)
    # the checkpoints are ported: load reads the file it is given
    for cls in (SoftSensor, GPRSensor):
        with pytest.raises(FileNotFoundError):
            cls.load("absent.npz", device="cpu")


# --------------------------------------------------------------------- #
# GPRSensor
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


def _gpr_pair(seed, gpr_type):
    rng = np.random.default_rng(seed)
    X = rng.random((30, 8))
    P = np.linspace(0, 1, 8)[:, None] + 0.01 * rng.random((8, 1))
    jg = JGPR(X, 2, rng.random((15, 3)), P, gpr_type=gpr_type)
    jg.fit(select_modes="number", n_modes=3)
    jg.train(max_iter=60)
    return jg, gpr_from_numpy(*_gpr_state(jg), device="cpu"), X


@pytest.mark.parametrize("gpr_type", ["SingleTask", "MultiTask"])
def test_gpr_sensor_matches_jax_and_the_eager_model(gpr_type):
    jg, tg, _ = _gpr_pair(3, gpr_type)
    P_star = np.array([[0.25], [0.8]])
    sensor = GPRSensor.from_gpr(tg).warmup(batch=2)
    assert not sensor.constrained
    got = sensor(P_star)
    _same_outputs(got, JS.GPRSensor.from_gpr(jg)(P_star), 1e-10)
    A_ref, S_ref = tg.predict(P_star)
    _close(got[1], A_ref.numpy(), 1e-8)
    _close(got[2], S_ref.numpy(), 1e-8)
    _close(got[0], tg.reconstruct(A_ref).numpy().T, 1e-8)
    _close(sensor(P_star[0])[1], got[1].numpy()[:1], 1e-12)


@pytest.mark.parametrize("admm_rho", ["adaptive", "fixed"])
def test_constrained_gpr_sensor_matches_jax_and_eager(admm_rho):
    jg, tg, X = _gpr_pair(5, "MultiTask")
    limits = [np.array([X[:15].min(), X[15:].min()]) + 0.05,
              np.array([X[:15].max(), X[15:].max()]) - 0.05]
    pin_val = np.array([float(X[4].mean())])
    P_star = np.array([[0.15], [0.55], [0.9]])
    kw = dict(limits=limits, bc=([4], pin_val), admm_iters=1500,
              admm_rho=admm_rho)
    sensor = GPRSensor.from_gpr(tg, **kw).warmup(batch=3)
    assert sensor.constrained
    got = sensor(P_star)
    _same_outputs(got, JS.GPRSensor.from_gpr(jg, **kw)(P_star), 1e-9)
    np.testing.assert_allclose(got[0].numpy()[:, 4], pin_val[0] * np.ones(3),
                               atol=1e-4)
    if admm_rho == "adaptive":
        # the eager constrained predict at the same budget (tol = 0)
        A_ref, S_ref = tg.predict(P_star, limits=limits,
                                  bc=([4], pin_val[:, None] * np.ones((1, 3))),
                                  max_iter=1500, tol=0.0)
        _close(got[1], A_ref.numpy(), 1e-6)
        _close(got[2], S_ref.numpy(), 1e-8)


def test_gpr_sensor_validation():
    rng = np.random.default_rng(9)
    g = TGPR(rng.random((30, 8)), 2, rng.random((15, 3)),
             np.linspace(0, 1, 8)[:, None], device="cpu")
    with pytest.raises(AttributeError, match="fit"):
        GPRSensor.from_gpr(g)
    g.fit(select_modes="number", n_modes=2)
    with pytest.raises(AttributeError, match="train"):
        GPRSensor.from_gpr(g)
    g.train(max_iter=5)
    with pytest.raises(ValueError, match="batch"):
        GPRSensor.from_gpr(g)(np.zeros((2, 5)))
    with pytest.raises(NotImplementedError, match="MultiTask"):
        GPRSensor.from_gpr(g, limits=[-1.0, 2.0])
    with pytest.raises(ValueError, match="admm_rho"):
        GPRSensor.from_gpr(g, admm_rho="sometimes")
    _, multi, _ = _gpr_pair(6, "MultiTask")
    A_c = multi.Ur.numpy() * multi.Sigma_r.numpy()[None, :]
    with pytest.raises(ValueError, match="batched"):
        GPRSensor.from_gpr(multi, constraints=TB.LinearConstraints(
            A_c, -np.ones((2, 30)), np.ones((2, 30))))
    with pytest.raises(ValueError, match="fixed"):
        GPRSensor.from_gpr(multi, bc=([1], np.ones((1, 2))))


def test_gpr_sensor_casts_a_host_engine_model_to_the_basis_dtype():
    """The documented deviation from the JAX package: the host engine's
    float64 parameters and training set are cast to the sensor's dtype
    (the basis's, here fp32) on its device."""
    rng = np.random.default_rng(7)
    X = rng.random((30, 8)).astype(np.float32)
    P = (np.linspace(0, 1, 8)[:, None] + 0.01 * rng.random((8, 1))
         ).astype(np.float32)
    g = TGPR(X, 2, rng.random((15, 3)), P, gpr_type="MultiTask",
             device="cpu")
    g.fit(select_modes="number", n_modes=3)
    g.train(max_iter=40, engine="host")
    assert g.params["likelihood"]["raw_noise"].dtype == torch.float64
    sensor = GPRSensor.from_gpr(g)
    leaves = [sensor._state["P0_train"], sensor._state["Y"]]
    stack = [sensor._state["params"]]
    while stack:
        for v in stack.pop().values():
            (stack if isinstance(v, dict) else leaves).append(v)
    assert all(t.dtype == torch.float32 for t in leaves)
    fields, A, _ = sensor(np.array([[0.3], [0.6]], np.float32))
    assert fields.dtype == torch.float32
    A_ref, _ = g.predict(np.array([[0.3], [0.6]]))      # host float64
    np.testing.assert_allclose(A.numpy(), A_ref.numpy(), rtol=1e-4,
                               atol=1e-4 * np.abs(A_ref.numpy()).max())
