"""Port parity for PIGPR and ``GPR.update`` (CPU, float64): the port
against the JAX package on the same numpy inputs, at a small size (200
cells × 3 features, 16 + 3 snapshots, r = 5, at most 50 Adam iterations).

PIGPR's added loss is the same physics penalty written twice, in jnp for
the JAX model and in torch for the port (the callback is user code in each
package's own array library): the temperature-block excursion outside a
band, at the 9 constraint points (the corners and the centre of the
parameter box), weighted by a coefficient calibrated from ``compute_mll``.

Tolerances, float64: losses, parameters and predictions at ``rtol=1e-8``,
the bar of ``tests/test_torch_gpr.py`` (two Cholesky libraries differ at
~1e-15, which up to 50 Adam steps may lift by a few decades); Adam
iteration counts EQUAL.
"""

import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from openmeasure_tpu import GPR as JGPR
from openmeasure_tpu import PIGPR as JPIGPR
from openmeasure_torch import GPR as TGPR
from openmeasure_torch import PIGPR as TPIGPR
from openmeasure_torch.datasets.synthetic import make_flame_dataset
from openmeasure_torch.gp import kernels as TK
from openmeasure_torch.gp.exact_gp import tree_leaves

N_CELLS, NF, R, MAX_ITER = 200, 3, 5, 50
RTOL = 1e-8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch intra-op thread: beside the other test workers torch's
    OpenMP threads spin between the many tiny ops of a GP training."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def flame():
    return make_flame_dataset(n_cells=N_CELLS, n_features=NF, m_train=16,
                              m_test=3, seed=0)


def _constraint_points(P):
    lo_p, hi_p = P.min(axis=0), P.max(axis=0)
    corners = np.stack(np.meshgrid(*zip(lo_p, hi_p))).reshape(3, -1).T
    return np.vstack([corners, (lo_p + hi_p) / 2])


def _close(a, b, rtol=RTOL):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
    b = np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=rtol * max(np.abs(b).max(), 1e-300))


def _params_close(tp, jp, rtol=RTOL):
    lt, lj = tree_leaves(tp), jtu.tree_leaves(jp)
    assert len(lt) == len(lj)
    for a, b in zip(lt, lj):
        _close(a, b, rtol)


@pytest.fixture(scope="module")
def pig_pair(flame):
    """A fitted JAX PIGPR and port PIGPR with the same penalty, one in jnp
    and one in torch, and the calibrated coefficient."""
    P = flame["P_train"]
    P_cstr = _constraint_points(P)
    jp = JPIGPR(flame["X_train"], NF, flame["xyz"], P, P_cstr, None)
    jp.fit(select_modes="number", n_modes=R)
    tp = TPIGPR(flame["X_train"], NF, flame["xyz"], P, P_cstr, None,
                device="cpu")
    tp.fit(select_modes="number", n_modes=R)
    npts, n_train = N_CELLS, P.shape[0]
    band = np.percentile(flame["X_train"][:npts], [40, 60])
    lo_b, hi_b = float(band[0]), float(band[1])
    UrS = np.asarray(jp.Ur)[:npts] * np.asarray(jp.Sigma_r)[None, :]
    Xc, Xs = np.asarray(jp.X_cnt)[:npts], np.asarray(jp.X_scl)[:npts]
    UrS_j, Xc_j, Xs_j = (jnp.asarray(a) for a in (UrS, Xc, Xs))
    UrS_t = tp.Ur[:npts] * tp.Sigma_r[None, :]
    Xc_t, Xs_t = tp.X_cnt[:npts], tp.X_scl[:npts]

    def added_jnp(ctx):
        V = ctx["output"].mean[n_train:]
        T = Xs_j * (UrS_j @ V.T) + Xc_j
        return -ctx["loss_dict"]["coef"] * jnp.mean(
            jnp.maximum(T - hi_b, 0.0) ** 2 + jnp.maximum(lo_b - T, 0.0) ** 2)

    def added_torch(ctx):
        V = ctx["output"].mean[n_train:]
        T = Xs_t * (UrS_t @ V.T) + Xc_t
        return -ctx["loss_dict"]["coef"] * torch.mean(
            torch.clamp(T - hi_b, min=0.0) ** 2
            + torch.clamp(lo_b - T, min=0.0) ** 2)

    jp.AddedLoss, tp.AddedLoss = added_jnp, added_torch
    loss_j, V0 = jp.compute_mll()
    T0 = Xs * (UrS @ np.asarray(V0)[n_train:].T) + Xc
    v0 = float(np.mean(np.maximum(T0 - hi_b, 0) ** 2
                       + np.maximum(lo_b - T0, 0) ** 2))
    coef = abs(float(loss_j)) / max(v0, 1.0)
    return jp, tp, coef


def test_compute_mll_matches_jax(pig_pair):
    jp, tp, _ = pig_pair
    loss_j, V_j = jp.compute_mll()
    loss_t, V_t = tp.compute_mll()
    assert isinstance(loss_t, np.ndarray)
    np.testing.assert_allclose(loss_t, np.asarray(loss_j), rtol=1e-12)
    assert tuple(V_t.shape) == (16 + 9, R)
    _close(V_t, V_j, 1e-12)
    # compute_mll leaves a model without specs as it found it
    assert not hasattr(tp, "params")


def test_train_matches_jax(pig_pair, flame):
    jp, tp, coef = pig_pair
    seen = []
    tp_cb = tp.AddedLoss

    def spy(ctx):
        seen.append(ctx)
        return tp_cb(ctx)

    tp.AddedLoss = spy
    try:
        jp.train(max_iter=MAX_ITER, loss_dict={"coef": coef})
        tp.train(max_iter=MAX_ITER, loss_dict={"coef": coef})
    finally:
        tp.AddedLoss = tp_cb
    # the callback gets the JAX package's ctx: the posterior at [train +
    # constraint] points, the detached training log-prob, the knobs
    ctx = seen[0]
    assert set(ctx) == {"output", "loss_ml", "verbose", "loss_dict"}
    assert tuple(ctx["output"].mean.shape) == (16 + 9, R)
    assert not ctx["loss_ml"].requires_grad
    assert ctx["loss_dict"] == {"coef": coef}
    _close(tp._final_loss, np.asarray(jp._final_loss))
    assert int(tp._iterations[0]) == MAX_ITER
    _params_close(tp.params, jp.params)
    _close(tp.Vr_sigma, jp.Vr_sigma)
    aj, sj = jp.predict(flame["P_test"])
    at, st = tp.predict(flame["P_test"])
    _close(at, aj)
    _close(st, sj)
    assert len(tp.models) == 1 and tp.likelihoods[0] is tp.likelihood


def test_pigpr_refuses_host_engine_and_standard_retrain(pig_pair, flame):
    _, tp, coef = pig_pair
    tp.engine = "host"
    try:
        with pytest.raises(ValueError, match="host"):
            tp.train(max_iter=2, loss_dict={"coef": coef})
    finally:
        tp.engine = "device"
    tp.train(max_iter=2, loss_dict={"coef": coef})
    n0 = tp._train_X.shape[0]
    with pytest.raises(ValueError, match="PIGPR cannot retrain"):
        tp.update(flame["P_test"], np.zeros((3, R)), retrain=True)
    assert tp._train_X.shape[0] == n0          # rejected before any change
    with pytest.raises(NotImplementedError, match="item 14"):
        tp.update_basis(flame["X_test"], flame["P_test"])


def _trained_pair(flame, gpr_type, engine="device"):
    jg = JGPR(flame["X_train"], NF, flame["xyz"], flame["P_train"], gpr_type)
    jg.fit(select_modes="number", n_modes=R)
    jg.train(max_iter=MAX_ITER, engine=engine)
    tg = TGPR(flame["X_train"], NF, flame["xyz"], flame["P_train"], gpr_type,
              device="cpu")
    tg.fit(select_modes="number", n_modes=R)
    tg.train(max_iter=MAX_ITER, engine=engine)
    return jg, tg


def _new_points(flame, jg):
    """Two new (P, A, A_sigma) triples: the test parameters and their
    projected coefficients, with a 5 % uncertainty."""
    P_new = flame["P_test"][:2]
    X0 = (flame["X_test"][:, :2] - np.asarray(jg.X_cnt)) / np.asarray(jg.X_scl)
    A_new = X0.T @ np.asarray(jg.Ur)
    return P_new, A_new, 0.05 * np.abs(A_new) + 1e-3


@pytest.mark.parametrize("case", [
    ("SingleTask", "device", False, False),
    ("SingleTask", "host", False, True),
    ("MultiTask", "device", False, False),
    ("MultiTask", "device", True, False),
    ("MultiTask", "host", True, True),
    ("SingleTask", "device", True, True),
    ("SingleTask", "host", True, True),
], ids=lambda c: f"{c[0]}-{c[1]}-retrain{c[2]}-sigma{c[3]}")
def test_update_matches_jax(flame, case):
    gpr_type, engine, retrain, with_sigma = case
    jg, tg = _trained_pair(flame, gpr_type, engine)
    P_new, A_new, A_sig = _new_points(flame, jg)
    sig = A_sig if with_sigma else None
    jg.update(P_new, A_new, sig, retrain=retrain)
    tg.update(P_new, A_new, sig, retrain=retrain)
    assert tg._train_X.shape[0] == 18 and tg.Vr_sigma.shape[0] == 18
    if engine == "host":
        assert tg.Vr_sigma.device.type == "cpu"
        assert tg.Vr_sigma.dtype == torch.float64
    _close(tg._train_X, jg._train_X)
    _close(tg._train_Y, jg._train_Y)
    _close(tg.Vr_sigma, jg.Vr_sigma)
    _params_close(tg.params, jg.params)
    if retrain and gpr_type == "SingleTask":
        assert isinstance(tg.likelihood, TK.FixedNoiseGaussianLikelihood)
        assert tuple(tg.params["likelihood"]["fixed_noise"].shape) == (R, 18)
    aj, sj = jg.predict(flame["P_test"])
    at, st = tg.predict(flame["P_test"])
    _close(at, aj)
    _close(st, sj)
    # a second assimilation after a fixed-noise retrain extends the
    # installed noise vector with the new variances
    if retrain and gpr_type == "SingleTask":
        P2, A2, S2 = P_new + 0.1, A_new * 0.9, A_sig
        jg.update(P2, A2, S2)
        tg.update(P2, A2, S2)
        assert tuple(tg.params["likelihood"]["fixed_noise"].shape) == (R, 20)
        _params_close(tg.params, jg.params)
        _close(tg.predict(flame["P_test"])[0], jg.predict(flame["P_test"])[0])


def test_single_task_retrain_needs_sigma(flame):
    tg = TGPR(flame["X_train"], NF, flame["xyz"], flame["P_train"],
              device="cpu")
    tg.fit(select_modes="number", n_modes=R)
    tg.train(max_iter=5)
    with pytest.raises(ValueError, match="A_sigma_new"):
        tg.update(flame["P_test"][:2], np.zeros((2, R)), retrain=True)
