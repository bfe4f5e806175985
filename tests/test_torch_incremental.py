"""Port parity for the incremental basis update
(``openmeasure_torch/linalg/incremental.py`` and the ``update_basis``
methods of ``ROM``, ``SPR``, ``GPR`` and ``PIGPR``) against the JAX
package on the same numpy inputs, CPU, float64.

Bars: the three update functions to 1e-10 (a handful of GEMMs, a thin QR
or a (q, q) eigendecomposition and an (r+q)² SVD, from two LAPACKs); the
models' states after ``update_basis`` to 1e-9; the GP states after a
retrain to 1e-8, the bar of ``tests/test_torch_pigpr.py`` (two Cholesky
libraries differ at ~1e-15, which up to 50 Adam steps lift by a few
decades), with Adam iteration counts EQUAL.
"""

import jax.tree_util as jtu
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from openmeasure_tpu import GPR as JGPR
from openmeasure_tpu import PIGPR as JPIGPR
from openmeasure_tpu import ROM as JROM
from openmeasure_tpu import SPR as JSPR
from openmeasure_tpu.linalg import incremental as JI
from openmeasure_torch import GPR as TGPR
from openmeasure_torch import PIGPR as TPIGPR
from openmeasure_torch import ROM as TROM
from openmeasure_torch import SPR as TSPR
from openmeasure_torch.datasets.synthetic import make_flame_dataset
from openmeasure_torch.gp import kernels as TK
from openmeasure_torch.gp.exact_gp import tree_leaves
from openmeasure_torch.linalg import incremental as TI

CPU = "cpu"
N_CELLS, NF, R, MAX_ITER = 200, 3, 5, 50
FN = ["svd_append_columns", "svd_append_columns_eager",
      "svd_append_columns_cholqr"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch intra-op thread: beside the other test workers torch's
    OpenMP threads spin between the many tiny ops of a GP training."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


# --------------------------------------------------------------------- #
# The update functions
# --------------------------------------------------------------------- #

CASE_SEEDS = {"full rank": 0, "truncated": 1, "near span": 2,
              "rank-deficient residual": 3}


def _case(name):
    rng = np.random.default_rng(CASE_SEEDS[name])
    if name == "full rank":
        A, B, r = rng.standard_normal((60, 8)), rng.standard_normal((60, 3)), 8
    elif name == "truncated":
        A, B, r = rng.standard_normal((50, 7)), rng.standard_normal((50, 2)), 4
    elif name == "near span":
        A = rng.standard_normal((40, 5))
        U, _, _ = np.linalg.svd(A, full_matrices=False)
        B = U @ rng.standard_normal((5, 2)) + 1e-3 * rng.standard_normal(
            (40, 2))
        r = 5
    else:                           # a rank-deficient residual
        A = rng.standard_normal((40, 6))
        B = rng.standard_normal((40, 1)) @ np.ones((1, 3)) \
            + np.linspace(0, 1, 3)[None, :] * rng.standard_normal((40, 1))
        r = 6
    U, S, Vt = np.linalg.svd(A, full_matrices=False)
    return U[:, :r], S[:r], Vt[:r], B


@pytest.mark.parametrize("reorth", [True, False], ids=["reorth", "cgs"])
@pytest.mark.parametrize("case", ["full rank", "truncated", "near span",
                                  "rank-deficient residual"])
@pytest.mark.parametrize("fn", FN)
def test_update_functions_equal_jax(fn, case, reorth):
    U, S, Vt, B = _case(case)
    out_j = getattr(JI, fn)(jnp.asarray(U), jnp.asarray(S), jnp.asarray(Vt),
                            jnp.asarray(B), reorth=reorth)
    out_t = getattr(TI, fn)(torch.as_tensor(U), torch.as_tensor(S),
                            torch.as_tensor(Vt), torch.as_tensor(B),
                            reorth=reorth)
    r, q = S.size, B.shape[1]
    assert tuple(out_t[0].shape) == (U.shape[0], r + q)
    assert tuple(out_t[2].shape) == (r + q, Vt.shape[1] + q)
    # a rank-deficient residual leaves a zero singular value (cholqr:
    # floored at ~1e-8 relative), whose singular vectors either LAPACK may
    # choose: compare the others.  A triplet's joint sign (u, v) → (−u, −v)
    # is the SVD's own freedom, and where the (q, q) eigenvectors' signs
    # differ between the two LAPACKs (cholqr), the core's SVD may take the
    # other one: align it per triplet first
    keep = int(np.sum(np.asarray(out_j[1]) > 1e-6 * float(out_j[1][0])))
    assert keep == (r + q - 1 if case == "rank-deficient residual"
                    else r + q)
    Uj, Vtj = np.asarray(out_j[0])[:, :keep], np.asarray(out_j[2])[:keep]
    sign = np.sign(np.sum(out_t[0][:, :keep].numpy() * Uj, axis=0))
    if fn != "svd_append_columns_cholqr":
        assert np.all(sign == 1)
    _close(out_t[0][:, :keep] * torch.as_tensor(sign), Uj, 1e-10)
    _close(out_t[1], out_j[1], 1e-10)
    _close(out_t[2][:keep] * torch.as_tensor(sign)[:, None], Vtj, 1e-10)
    assert all(a.dtype == torch.float64 for a in out_t)
    if case != "rank-deficient residual":
        # the factorization reproduces [U S Vt, B]
        rec = out_t[0] @ torch.diag(out_t[1]) @ out_t[2]
        M = np.concatenate([U @ np.diag(S) @ Vt, B], axis=1)
        np.testing.assert_allclose(rec.numpy(), M, atol=1e-9)


def test_helpers_equal_jax():
    U, S, Vt, B = _case("truncated")
    Ut, Bt = torch.as_tensor(U), torch.as_tensor(B)
    for reorth in (True, False):
        for a, b in zip(TI._project_residual(Ut, Bt, reorth),
                        JI._project_residual(jnp.asarray(U), jnp.asarray(B),
                                             reorth)):
            _close(a, b, 1e-12)
        for a, b in zip(TI._residual_qr(Ut, Bt, reorth),
                        JI._residual_qr(jnp.asarray(U), jnp.asarray(B),
                                        reorth)):
            _close(a, b, 1e-12)
    M, Q, R_ = TI._residual_qr(Ut, Bt)
    K_t = TI._assemble_K(torch.as_tensor(S), M, R_, 4, 2, torch.float64)
    K_j = JI._assemble_K(jnp.asarray(S), jnp.asarray(M.numpy()),
                         jnp.asarray(R_.numpy()), 4, 2, jnp.float64)
    _close(K_t, K_j, 1e-15)
    Vk = np.linalg.svd(K_t.numpy())[2].T
    _close(TI._finish_V(torch.as_tensor(Vt), torch.as_tensor(Vk), 4,
                        torch.float64),
           JI._finish_V(jnp.asarray(Vt), jnp.asarray(Vk), 4, jnp.float64),
           1e-12)


def test_eager_reads_the_core_in_one_copy(monkeypatch):
    """S, M and R come to the host together (the JAX code reads each)."""
    from openmeasure_torch.core import device as dev_mod
    calls = []
    orig = dev_mod.to_numpy_once

    def spy(*ts):
        calls.append(len(ts))
        return orig(*ts)
    monkeypatch.setattr(TI, "to_numpy_once", spy)
    U, S, Vt, B = _case("full rank")
    TI.svd_append_columns_eager(torch.as_tensor(U), torch.as_tensor(S),
                                torch.as_tensor(Vt), torch.as_tensor(B))
    assert calls == [3]


# --------------------------------------------------------------------- #
# ROM and SPR
# --------------------------------------------------------------------- #

def _rom_data(seed=0, n_points=30, n_features=2, m=8):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n_points * n_features, m)) * 10 + 5
    return X, rng.random((n_points, 3)), rng


def _states_close(tm, jm, rtol=1e-9):
    assert tm.r == jm.r
    for a in ("Ur", "Ar", "Vr", "Sigma_r", "X0"):
        _close(getattr(tm, a), getattr(jm, a), rtol)
    _close(tm.X, jm.X, 1e-15)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(n_modes=8),
    dict(select_modes="variance", n_modes=99),
    dict(n_modes=6, reorth=False),
], ids=["keep r", "grow to 8", "variance 99", "no reorth"])
def test_rom_update_basis_equals_jax(kw):
    X, xyz, rng = _rom_data()
    Xn = rng.standard_normal((X.shape[0], 3)) * 10 + 5
    jr, tr = JROM(X, 2, xyz), TROM(X, 2, xyz, device=CPU)
    for m in (jr, tr):
        m.fit(select_modes="number", n_modes=5)
        m.update_basis(Xn, **kw)
    _states_close(tr, jr)
    assert tr.X.shape == (X.shape[0], 11) and tr.X0.shape[1] == 11
    # a second, one-column update (a 1-D snapshot becomes a column)
    for m in (jr, tr):
        m.update_basis(Xn[:, 0] * 0.9)
    _states_close(tr, jr)


def test_rom_update_basis_exact_for_full_rank():
    """Keeping every triplet reproduces the direct SVD of the scaled data
    under the frozen statistics."""
    X, xyz, rng = _rom_data()
    Xn = rng.standard_normal((X.shape[0], 3)) * 10 + 5
    rom = TROM(X, 2, xyz, device=CPU)
    rom.fit(select_modes="number", n_modes=8)
    cnt, scl = rom.X_cnt.numpy(), rom.X_scl.numpy()
    rom.update_basis(torch.as_tensor(Xn), n_modes=10)
    X0_cat = np.concatenate([(X - cnt) / scl, (Xn - cnt) / scl], axis=1)
    S_ref = np.linalg.svd(X0_cat, compute_uv=False)
    _close(rom.Sigma_r, S_ref[:10], 1e-9)
    np.testing.assert_allclose((rom.Ur @ rom.Ar.T).numpy(), X0_cat,
                               atol=1e-9)
    assert rom.r == 10 and tuple(rom.Ar.shape) == (11, 10)


def test_rom_update_basis_errors_and_tensor_snapshots():
    X, xyz, _ = _rom_data(seed=5)
    for m in (JROM(X, 2, xyz), TROM(X, 2, xyz, device=CPU)):
        with pytest.raises(AttributeError, match="fit"):
            m.update_basis(X[:, :1])
        m.fit(select_modes="number", n_modes=5)
        with pytest.raises(ValueError, match="rows"):
            m.update_basis(np.zeros((7, 2)))
        with pytest.raises(ValueError, match="range"):
            m.update_basis(X[:, :1], n_modes=9)
    # X given as a tensor stays a tensor and grows on its device
    tr = TROM(torch.as_tensor(X), 2, xyz, device=CPU)
    tr.fit(select_modes="number", n_modes=5)
    tr.update_basis(torch.as_tensor(X[:, :2]) * 1.1)
    assert isinstance(tr.X, torch.Tensor) and tuple(tr.X.shape) == (60, 10)


def _sparse_forms(C):
    coo = sp.coo_matrix(C)
    T = torch.sparse_coo_tensor(np.vstack([coo.row, coo.col]), coo.data,
                                size=coo.shape, check_invariants=True)
    return {"dense": C, "scipy": sp.csr_matrix(C), "torch_coo": T,
            "torch_csr": T.to_sparse_csr()}


@pytest.mark.parametrize("form", ["dense", "scipy", "torch_coo",
                                  "torch_csr"])
def test_spr_update_basis_refreshes_theta_like_jax(form):
    rng = np.random.default_rng(6)
    n, m = 40, 6
    X = rng.standard_normal((n, m)) * 3 + 1
    xyz = rng.random((n // 2, 3))
    C = rng.random((12, n)) * (rng.random((12, n)) < 0.3)
    Xn = rng.standard_normal((n, 2)) * 3 + 1
    js, ts = JSPR(X, 2, xyz), TSPR(X, 2, xyz, device=CPU)
    for mdl, Cm in ((js, C), (ts, _sparse_forms(C)[form])):
        # m − 1 modes: the row-centred snapshots have rank m − 1, and a
        # null mode's vector is either LAPACK's choice
        mdl.fit(select_modes="number", n_modes=m - 1)
        mdl.train(Cm, method="COLS", limits=[[-10.0, -10.0], [10.0, 10.0]],
                  admm_max_iter=300)
        mdl.predict(np.column_stack([C @ X[:, 0], np.zeros(12),
                                     np.zeros(12)]))
        mdl.update_basis(Xn, n_modes=m)
    assert ts._cols_cache is None
    _states_close(ts, js)
    _close(ts.Theta, js.Theta, 1e-9)
    y = np.column_stack([C @ Xn[:, 0], np.zeros(12), np.zeros(12)])
    _close(ts.predict(y)[0], js.predict(y)[0], 1e-9)


def test_spr_update_basis_identity_operator_reconstructs_new_snapshot():
    rng = np.random.default_rng(6)
    n, m = 40, 6
    X = rng.standard_normal((n, m)) * 3 + 1
    spr = TSPR(X, 2, rng.random((n // 2, 3)), device=CPU)
    spr.fit(select_modes="number", n_modes=m)
    spr.train(np.eye(n))
    Xn = rng.standard_normal((n, 2)) * 3 + 1
    spr.update_basis(Xn, n_modes=m + 2)
    np.testing.assert_allclose(spr.Theta.numpy(), spr.Ur.numpy(),
                               atol=1e-12)
    y = np.stack([Xn[:, 0], np.zeros(n), np.repeat([0.0, 1.0], n // 2)],
                 axis=1)
    rec = spr.reconstruct(spr.predict(y)[0])
    np.testing.assert_allclose(rec.numpy()[:, 0], Xn[:, 0], rtol=1e-6,
                               atol=1e-8)


def test_spr_is_theta_sensor_must_train_again():
    rng = np.random.default_rng(8)
    n, m = 20, 5
    X = rng.standard_normal((n, m))
    spr = TSPR(X, 1, rng.random((n, 3)), device=CPU)
    spr.fit(select_modes="number", n_modes=4)
    C1 = spr.optimal_placement()
    spr.train(C1)
    spr.train(spr.Ur[2:6, :], is_Theta=True)
    assert spr.C is None
    spr.update_basis(X[:, :1] * 1.05)
    with pytest.raises(AttributeError, match="update_basis on an "
                                             "is_Theta=True sensor"):
        spr.predict(np.zeros((4, 3)))
    spr.train(spr.optimal_placement())
    assert spr.predict(np.zeros((4, 3)))[0].shape == (1, 4)


# --------------------------------------------------------------------- #
# GPR and PIGPR
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def flame():
    return make_flame_dataset(n_cells=N_CELLS, n_features=NF, m_train=16,
                              m_test=3, seed=0)


def _spy_iterations(jg):
    """Record the Adam iteration counts of the JAX model's runs (it keeps
    none itself)."""
    seen = []
    st, mt = jg._single_task_adam, jg._multitask_adam

    def single(*a, **k):
        res = st(*a, **k)
        seen.append(np.asarray(res.iterations))
        return res

    def multi(*a, **k):
        out = mt(*a, **k)
        seen.append(np.asarray(out[1].iterations))
        return out
    jg._single_task_adam, jg._multitask_adam = single, multi
    return seen


def _gp_pair(flame, gpr_type, engine, train=True):
    X, P = flame["X_train"][:, :13], flame["P_train"][:13]
    jg = JGPR(X, NF, flame["xyz"], P, gpr_type)
    tg = TGPR(X, NF, flame["xyz"], P, gpr_type, device=CPU)
    for g in (jg, tg):
        g.fit(select_modes="number", n_modes=R)
        if train:
            g.train(max_iter=MAX_ITER, engine=engine)
    return jg, tg


def _params_close(tp, jp, rtol=1e-8):
    lt, lj = tree_leaves(tp), jtu.tree_leaves(jp)
    assert len(lt) == len(lj)
    for a, b in zip(lt, lj):
        _close(a, b, rtol)


def _gp_states_close(tg, jg, rtol=1e-8):
    assert tg.r == jg.r
    for a in ("Ur", "Sigma_r", "Vr", "P0"):
        _close(getattr(tg, a), getattr(jg, a), 1e-9)
    np.testing.assert_array_equal(tg.P, jg.P)
    if hasattr(jg, "params"):
        _params_close(tg.params, jg.params, rtol)
        _close(tg._train_X, jg._train_X, 1e-9)
        _close(tg._train_Y, jg._train_Y, 1e-9)
        _close(tg.Vr_sigma, jg.Vr_sigma, rtol)
    else:
        assert not hasattr(tg, "params")


@pytest.mark.parametrize("case", [
    ("SingleTask", "device", False),
    ("SingleTask", "device", True),
    ("SingleTask", "host", True),
    ("MultiTask", "device", False),
    ("MultiTask", "device", True),
    ("MultiTask", "host", True),
], ids=lambda c: f"{c[0]}-{c[1]}-retrain{c[2]}")
def test_gpr_update_basis_equals_jax(flame, case):
    gpr_type, engine, retrain = case
    jg, tg = _gp_pair(flame, gpr_type, engine)
    seen = _spy_iterations(jg)
    X_new, P_new = flame["X_train"][:, 13:], flame["P_train"][13:]
    jg.update_basis(X_new, P_new, retrain=retrain)
    tg.update_basis(X_new, P_new, retrain=retrain)
    _gp_states_close(tg, jg)
    assert tg._train_X.shape[0] == 16 and tg.Vr_sigma.shape[0] == 16
    if engine == "host":
        assert tg.Vr_sigma.device.type == "cpu"
        assert tg.Vr_sigma.dtype == torch.float64
    if retrain:
        assert len(seen) == 1
        np.testing.assert_array_equal(tg._iterations.numpy(), seen[0])
    else:
        assert not seen
    aj, sj = jg.predict(flame["P_test"])
    at, st = tg.predict(flame["P_test"])
    _close(at, aj, 1e-8)
    _close(st, sj, 1e-8)


@pytest.mark.parametrize("gpr_type", ["SingleTask", "MultiTask"])
@pytest.mark.parametrize("retrain", [False, True])
def test_gpr_update_basis_rank_change_equals_jax(flame, gpr_type, retrain):
    """A change of rank drops the trained state; retrain=True trains
    afresh at the new rank (a multitask likelihood rebuilt for it)."""
    jg, tg = _gp_pair(flame, gpr_type, "device")
    seen = _spy_iterations(jg)
    X_new, P_new = flame["X_train"][:, 13:], flame["P_train"][13:]
    jg.update_basis(X_new, P_new, n_modes=R + 1, retrain=retrain)
    tg.update_basis(X_new, P_new, n_modes=R + 1, retrain=retrain)
    assert tg.r == R + 1 and hasattr(tg, "params") == retrain
    _gp_states_close(tg, jg)
    if not retrain:
        assert not seen and not hasattr(tg, "_iterations")
        with pytest.raises(AttributeError):
            tg.predict(flame["P_test"])
        return
    np.testing.assert_array_equal(tg._iterations.numpy(), seen[0])
    if gpr_type == "MultiTask":
        assert tg.likelihood.num_tasks == R + 1
    _close(tg.predict(flame["P_test"])[0], jg.predict(flame["P_test"])[0],
           1e-8)


def test_gpr_rank_change_retrain_keeps_the_host_engine(flame):
    """The port's documented deviation: the fresh training at a new rank
    runs under the model's engine (the JAX package's falls back to
    'device')."""
    _, tg = _gp_pair(flame, "SingleTask", "host")
    tg.update_basis(flame["X_train"][:, 13:], flame["P_train"][13:],
                    n_modes=R + 1, retrain=True)
    assert tg.engine == "host" and tg.Vr_sigma.dtype == torch.float64
    assert all(t.device.type == "cpu" for t in tree_leaves(tg.params))


def test_gpr_update_basis_untrained_and_errors(flame):
    X, P = flame["X_train"], flame["P_train"]
    jg, tg = _gp_pair(flame, "SingleTask", "device", train=False)
    for g in (jg, tg):
        with pytest.raises(Exception, match="number of parameters"):
            g.update_basis(X[:, 13:], P[13:15])
        with pytest.raises(ValueError, match="columns; expected"):
            g.update_basis(X[:, 13:], np.zeros((3, 2)))
        with pytest.raises(ValueError, match="needs a trained model"):
            g.update_basis(X[:, 13:], P[13:], retrain=True)
    # a failed retrain=True on an untrained model left the basis updated in
    # both packages; the next update continues from there
    _gp_states_close(tg, jg)
    for g in (jg, tg):
        g.update_basis(X[:, 13], P[13])            # a single 1-D snapshot
    _gp_states_close(tg, jg)
    assert tg.P.shape == (17, 3) and tuple(tg.P0.shape) == (17, 3)
    np.testing.assert_allclose(
        tg.P0.numpy()[13:],
        (tg.P[13:] - tg.P_cnt.numpy()[0]) / tg.P_scl.numpy()[0], rtol=1e-12)


def test_gpr_update_basis_refuses_orphaned_updates(flame):
    jg, tg = _gp_pair(flame, "MultiTask", "device")
    P_new = flame["P_test"][:2]
    for g in (jg, tg):
        A_new = np.zeros((2, R))
        g.update(P_new, A_new)
        n0 = g.Ur.shape[1]
        with pytest.raises(ValueError, match="silently discard"):
            g.update_basis(flame["X_test"][:, :2], P_new)
        assert g.Ur.shape[1] == n0


def test_pigpr_update_basis_equals_jax_and_refuses_retrain(flame):
    X, P = flame["X_train"][:, :13], flame["P_train"][:13]
    P_cstr = P[:2] + 0.01
    jp = JPIGPR(X, NF, flame["xyz"], P, P_cstr, lambda ctx: 0.0)
    tp = TPIGPR(X, NF, flame["xyz"], P, P_cstr, lambda ctx: 0.0, device=CPU)
    for g in (jp, tp):
        g.fit(select_modes="number", n_modes=R)
        with pytest.raises(ValueError, match="added-loss"):
            g.update_basis(flame["X_train"][:, 13:], flame["P_train"][13:],
                           retrain=True)
        assert g.P0.shape[0] == 13               # refused before any change
        g.update_basis(flame["X_train"][:, 13:], flame["P_train"][13:])
    _gp_states_close(tp, jp)
    assert tuple(tp.P0.shape) == (16, 3)
    tp.train(max_iter=3)
    assert tp._scaled_constraint_points().shape[0] == 18


def test_single_task_fixed_noise_survives_update_basis_shape(flame):
    """update_basis on a model with no retrain keeps its likelihood type;
    GPR.update's fixed-noise retrain then grows from the new set."""
    _, tg = _gp_pair(flame, "SingleTask", "device")
    tg.update_basis(flame["X_train"][:, 13:], flame["P_train"][13:])
    assert isinstance(tg.likelihood, TK.GaussianLikelihood)
    A = np.zeros((1, R))
    tg.update(flame["P_test"][:1], A, A + 1e-2, retrain=True)
    assert tuple(tg.params["likelihood"]["fixed_noise"].shape) == (R, 17)
