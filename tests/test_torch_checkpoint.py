"""Checkpoints across the two packages (``openmeasure_torch/utils/
checkpoint.py``), the five sensors' ``load`` and
``linalg.svd.randomized_svd``, against the JAX package on the same numpy
inputs, CPU, float64.

A checkpoint written by the JAX package loads in the port and predicts as
the JAX model does, and one written by the port loads in the JAX package
and predicts as the port model does, to 1e-9 relative: SPR with the
operator C dense, scipy CSR, JAX BCOO or torch sparse (COO and CSR), a
COLS SPR, GPR (SingleTask, MultiTask, the host engine's float64 state),
PIGPR (restored as a GPR, as in JAX), CoKriging, ShallowDecoder, DMD and
the streaming fits (restored as their in-core classes).  The loaded
model's state is the saved one (no refit, no retraining), so the bar is
round-off of the predict arithmetic alone.  ``randomized_svd`` is held to
JAX's on JAX's Ω to 1e-9, and to the exact SVD on a matrix with a
spectral gap.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax.experimental import sparse as jsparse

import openmeasure_tpu as J
import openmeasure_tpu.streaming as JS
import openmeasure_torch as T
from openmeasure_tpu.linalg import svd as jsvd
from openmeasure_tpu.sensing import decoder as jdec
from openmeasure_tpu.utils import checkpoint as jck
from openmeasure_torch.datasets.synthetic import make_flame_dataset
from openmeasure_torch.linalg import svd as tsvd
from openmeasure_torch.utils import checkpoint as tck

CPU = "cpu"
NF, N_CELLS, R, TOL = 3, 200, 5, 1e-9


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


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _rel(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _measurements(flame, C):
    rows = np.asarray(C.argmax(axis=1)).reshape(-1)
    return [np.column_stack([flame["X_test"][rows, k], 0.01 * np.ones(
        rows.size), rows // N_CELLS]) for k in range(3)]


def _onehot(flame):
    js = J.SPR(flame["X_train"], NF, flame["xyz"])
    js.fit(select_modes="number", n_modes=R)
    return np.asarray(js.optimal_placement())


JAX_FORMS = {"dense": lambda C: C, "scipy": sp.csr_matrix,
             "bcoo": lambda C: jsparse.BCOO.fromdense(jnp.asarray(C))}
PORT_FORMS = {"dense": lambda C: torch.as_tensor(C), "scipy": sp.csr_matrix,
              "coo": lambda C: torch.as_tensor(C).to_sparse(),
              "csr": lambda C: torch.as_tensor(C).to_sparse_csr()}


# --------------------------------------------------------------------- #
# SPR and its sensors
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("form", list(JAX_FORMS))
def test_jax_spr_checkpoint_loads_in_the_port(tmp_path, flame, form):
    C = _onehot(flame)
    js = J.SPR(flame["X_train"], NF, flame["xyz"])
    js.fit(select_modes="number", n_modes=R)
    js.train(JAX_FORMS[form](C))
    p = str(tmp_path / "spr.npz")
    jck.save_model(js, p)
    ts = tck.load_model(p, device=CPU)
    assert type(ts) is T.SPR and ts.r == R and ts.device.type == "cpu"
    if form == "scipy":
        assert sp.issparse(ts.C)
    elif form == "bcoo":
        assert ts.C.layout == torch.sparse_coo
        assert torch.equal(ts.C.to_dense(), torch.as_tensor(C))
    ys = _measurements(flame, C)
    aj, _ = js.predict(ys)
    at, _ = ts.predict(ys)
    assert _rel(at, aj) <= TOL
    assert _rel(ts.reconstruct(at), js.reconstruct(aj)) <= TOL
    if form == "dense":
        Y = np.stack([y[:, 0] for y in ys])
        sj = J.SoftSensor.load(p, dtype=jnp.float64)
        st = T.SoftSensor.load(p, dtype=torch.float64, device=CPU)
        assert _rel(st.predict_batch(Y)[0], sj.predict_batch(Y)[0]) <= TOL
        dj = J.DynamicSensor.load(p, dtype=jnp.float64)
        dt = T.DynamicSensor.load(p, dtype=torch.float64, device=CPU)
        assert _rel(dt.filter_batch(Y)[0], dj.filter_batch(Y)[0]) <= TOL


@pytest.mark.parametrize("form", list(PORT_FORMS))
def test_port_spr_checkpoint_loads_in_jax(tmp_path, flame, form):
    C = _onehot(flame)
    ts = T.SPR(flame["X_train"], NF, flame["xyz"], device=CPU)
    ts.fit(select_modes="number", n_modes=R)
    ts.train(PORT_FORMS[form](C))
    p = str(tmp_path / "spr.npz")
    tck.save_model(ts, p)
    js = jck.load_model(p)
    if form in ("coo", "csr"):
        assert isinstance(js.C, jsparse.BCOO)
        np.testing.assert_array_equal(np.asarray(js.C.todense()), C)
    ys = _measurements(flame, C)
    at, _ = ts.predict(ys)
    aj, _ = js.predict(ys)
    assert _rel(aj, at) <= TOL
    back = tck.load_model(p, device=CPU)
    assert _rel(back.predict(ys)[0], at) <= TOL


def test_cols_spr_round_trips(tmp_path, flame):
    C = _onehot(flame)
    X = flame["X_train"]
    Xb = X.reshape(NF, N_CELLS, -1)
    lims = [Xb.min(axis=(1, 2)) + 0.05 * np.ptp(Xb, axis=(1, 2)),
            Xb.max(axis=(1, 2))]
    A = np.eye(R)[:2]
    cons = (A, -1e3 * np.ones(2), 1e3 * np.ones(2))
    js = J.SPR(X, NF, flame["xyz"])
    js.fit(select_modes="number", n_modes=R)
    from openmeasure_tpu.linalg.boxls import LinearConstraints
    # a fixed ADMM budget (tol 0): the port tests its stop every 16
    # iterations (a documented deviation, ROADMAP.md §C), so with a
    # tolerance the two packages may stop a few iterations apart
    js.train(C, method="COLS", limits=lims,
             constraints=LinearConstraints(*cons), admm_max_iter=50,
             admm_tol=0.0)
    p = str(tmp_path / "cols.npz")
    jck.save_model(js, p)
    ts = tck.load_model(p, device=CPU)
    assert ts.method == "COLS" and ts.constraints is not None
    assert ts.admm_max_iter == 50 and ts.admm_tol == 0.0
    ys = _measurements(flame, C)
    assert _rel(ts.predict(ys)[0], js.predict(ys)[0]) <= TOL
    q = str(tmp_path / "cols_port.npz")
    tck.save_model(ts, q)
    assert _rel(jck.load_model(q).predict(ys)[0], ts.predict(ys)[0]) <= TOL


# --------------------------------------------------------------------- #
# The GP family
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("gpr_type,engine", [("SingleTask", "device"),
                                             ("MultiTask", "device"),
                                             ("SingleTask", "host")])
def test_gpr_checkpoints_cross_both_ways(tmp_path, flame, gpr_type, engine):
    args = (flame["X_train"], NF, flame["xyz"], flame["P_train"])
    jg = J.GPR(*args, gpr_type=gpr_type)
    jg.fit(select_modes="number", n_modes=4)
    jg.train(max_iter=30, engine=engine)
    p = str(tmp_path / "gpr.npz")
    jck.save_model(jg, p)
    tg = tck.load_model(p, device=CPU)
    assert type(tg) is T.GPR and tg.gpr_type == gpr_type
    if engine == "host":
        leaves = [v for v in tg.params["kernel"].values()]
        assert all(v.dtype == torch.float64 and v.device.type == "cpu"
                   for v in leaves)
    aj, sj = jg.predict(flame["P_test"])
    at, st = tg.predict(flame["P_test"])
    assert _rel(at, aj) <= TOL and _rel(st, sj) <= TOL
    q = str(tmp_path / "gpr_port.npz")
    tck.save_model(tg, q)
    jg2 = jck.load_model(q)
    assert _rel(jg2.predict(flame["P_test"])[0], at) <= TOL
    # the host engine's float64 parameters survive a round trip exactly
    tg2 = tck.load_model(q, device=CPU)
    for a, b in zip(T.gp.exact_gp.tree_leaves(tg2.params),
                    T.gp.exact_gp.tree_leaves(tg.params)):
        assert torch.equal(a, b)
    fields = T.GPRSensor.load(q, device=CPU)(flame["P_test"])[0]
    assert _rel(fields, tg.reconstruct(at).T) <= TOL


def test_pigpr_restores_as_a_gpr(tmp_path, flame):
    P = flame["P_train"]
    P_cstr = np.vstack([P.min(axis=0), P.max(axis=0)])
    tp = T.PIGPR(flame["X_train"], NF, flame["xyz"], P, P_cstr,
                 lambda ctx: -0.1 * torch.mean(ctx["output"].mean ** 2),
                 device=CPU)
    tp.fit(select_modes="number", n_modes=4)
    tp.train(max_iter=20, loss_dict={})
    p = str(tmp_path / "pigpr.npz")
    tck.save_model(tp, p)
    for back in (tck.load_model(p, device=CPU), jck.load_model(p)):
        assert type(back).__name__ == "GPR"
        assert back.gpr_type == "MultiTask"
        assert _rel(back.predict(flame["P_test"])[0],
                    tp.predict(flame["P_test"])[0]) <= TOL


# --------------------------------------------------------------------- #
# CoKriging, the decoder, DMD
# --------------------------------------------------------------------- #

def test_cokriging_checkpoints_cross_both_ways(tmp_path):
    rng = np.random.default_rng(0)
    Xl, Xu, Xt = rng.random((8, 3)), rng.random((5, 3)), rng.random((4, 3))

    def fields(X, npts):
        t = np.linspace(0, 1, npts * 2)[:, None]
        return (np.sin(3 * t * X[:, 0][None, :])
                + 0.5 * np.cos(2 * t * (X[:, 1] + X[:, 2])[None, :]))

    args = (Xl, Xu, fields(Xl, 30), fields(Xu, 30), fields(Xl, 50) * 1.1,
            rng.random((30, 3)), rng.random((50, 3)), 2)
    jc = J.CoKriging(*args)
    jc.manifold_alignment(select_modes="number", n_modes_hf=3, n_modes_lf=3)
    jc.fit()
    p = str(tmp_path / "ck.npz")
    jck.save_model(jc, p)
    tc = tck.load_model(p, device=CPU)
    Yj, Sj = jc.predict(Xt)
    Yt, St = tc.predict(Xt)
    assert _rel(Yt, Yj) <= TOL and _rel(St, Sj) <= TOL
    Ys, _ = T.CoKrigingSensor.load(p, device=CPU)(Xt)
    assert _rel(Ys, Yj) <= TOL
    q = str(tmp_path / "ck_port.npz")
    tck.save_model(tc, q)
    assert _rel(jck.load_model(q).predict(Xt)[0], Yt) <= TOL


def test_decoder_checkpoints_cross_both_ways(tmp_path):
    flame = make_flame_dataset(n_cells=150, n_features=NF, m_train=14,
                               m_test=3, seed=2)
    js = J.SPR(flame["X_train"], NF, flame["xyz"])
    js.fit(select_modes="number", n_modes=6)
    C = np.array(js.optimal_placement())
    jd = jdec.ShallowDecoder(flame["X_train"], NF, flame["xyz"],
                             hidden=(9, 7))
    jd.fit(C, epochs=20, lr=3e-3, seed=5)
    p = str(tmp_path / "dec.npz")
    jck.save_model(jd, p)
    td = tck.load_model(p, device=CPU)
    rows = C.argmax(axis=1)
    ys = [np.column_stack([flame["X_test"][rows, k], np.zeros(rows.size),
                           rows // 150]) for k in range(3)]
    assert _rel(td.predict(ys), jd.predict(ys)) <= TOL
    Y = np.stack([y[:, 0] for y in ys])
    fields = T.DecoderSensor.load(p, dtype=torch.float64,
                                  device=CPU).predict_batch(Y)
    assert _rel(fields.T, jd.predict(ys)) <= TOL
    q = str(tmp_path / "dec_port.npz")
    tck.save_model(td, q)
    assert _rel(jck.load_model(q).predict(ys), td.predict(ys)) <= TOL


def _series():
    rng = np.random.default_rng(2)
    n, m = 3 * 300, 20
    lam = np.array([0.95, 0.9, 0.8, 0.7])
    return rng.standard_normal((n, 4)) @ (lam[:, None]
                                          ** np.arange(m)[None, :]) \
        + 5.0 + 1e-3 * rng.standard_normal((n, m))


def test_dmd_checkpoints_cross_both_ways(tmp_path):
    Xd = _series()
    jd = J.DMD(Xd, NF, None)
    jd.fit(dt=0.5, select_modes="number", n_modes=4)
    p = str(tmp_path / "dmd.npz")
    jck.save_model(jd, p)
    td = tck.load_model(p, device=CPU)
    assert type(td) is T.DMD
    np.testing.assert_array_equal(td.eigs, np.asarray(jd.eigs))
    assert _rel(td.forecast_horizon(3), jd.forecast_horizon(3)) <= TOL
    q = str(tmp_path / "dmd_port.npz")
    tck.save_model(td, q)
    assert _rel(jck.load_model(q).forecast_horizon(3),
                td.forecast_horizon(3)) <= TOL


# --------------------------------------------------------------------- #
# The streaming fits
# --------------------------------------------------------------------- #

def test_streaming_fits_restore_as_in_core_classes(tmp_path, flame):
    mat = str(tmp_path / "X.npy")
    np.save(mat, flame["X_train"])
    C = _onehot(flame)
    ys = _measurements(flame, C)
    ss = T.StreamingSPR(mat, NF, flame["xyz"], chunk_rows=97,
                        dtype=np.float64, device=CPU)
    ss.fit(select_modes="number", n_modes=R)
    ss.train(torch.as_tensor(C).to_sparse())
    p = str(tmp_path / "sspr.npz")
    tck.save_model(ss, p)
    with pytest.raises(ValueError, match="in-core X"):
        tck.save_model(ss, str(tmp_path / "x.npz"), include_data=True)
    a0 = ss.predict(ys)[0]
    back = tck.load_model(p, device=CPU)
    assert type(back) is T.SPR
    assert _rel(back.predict(ys)[0], a0) <= TOL
    assert _rel(jck.load_model(p).predict(ys)[0], a0) <= TOL
    Y = np.stack([y[:, 0] for y in ys])
    ref = T.SoftSensor.from_spr(ss, dtype=torch.float64)
    got = T.SoftSensor.load(p, dtype=torch.float64, device=CPU)
    assert torch.equal(got.predict_batch(Y)[0], ref.predict_batch(Y)[0])

    js = JS.StreamingSPR(mat, NF, flame["xyz"], chunk_rows=97,
                         dtype=np.float64)
    js.fit(select_modes="number", n_modes=R)
    js.train(C)
    q = str(tmp_path / "jspr.npz")
    jck.save_model(js, q)
    assert _rel(tck.load_model(q, device=CPU).predict(ys)[0],
                js.predict(ys)[0]) <= TOL

    sg = T.StreamingGPR(mat, NF, flame["xyz"], flame["P_train"],
                        chunk_rows=97, dtype=np.float64, device=CPU)
    sg.fit(select_modes="number", n_modes=4)
    sg.train(max_iter=20)
    g = str(tmp_path / "sgpr.npz")
    tck.save_model(sg, g)
    for back in (tck.load_model(g, device=CPU), jck.load_model(g)):
        assert type(back).__name__ == "GPR"
        assert _rel(back.predict(flame["P_test"])[0],
                    sg.predict(flame["P_test"])[0]) <= TOL

    dmat = str(tmp_path / "D.npy")
    np.save(dmat, _series())
    sd = T.StreamingDMD(dmat, NF, chunk_rows=77, dtype=np.float64,
                        device=CPU)
    sd.fit(dt=0.5, select_modes="number", n_modes=4)
    d = str(tmp_path / "sdmd.npz")
    tck.save_model(sd, d)
    for back in (tck.load_model(d, device=CPU), jck.load_model(d)):
        assert type(back).__name__ == "DMD"
        assert _rel(back.forecast_horizon(2), sd.forecast_horizon(2)) <= TOL


def test_save_and_load_errors(tmp_path, flame):
    ts = T.SPR(flame["X_train"], NF, flame["xyz"], device=CPU)
    with pytest.raises(ValueError, match="must be fit"):
        tck.save_model(ts, str(tmp_path / "a.npz"))
    ts.fit(select_modes="number", n_modes=R)
    with pytest.raises(NotImplementedError, match="orbax"):
        tck.save_model(ts, str(tmp_path / "a"), backend="orbax")
    with pytest.raises(ValueError, match="unknown checkpoint backend"):
        tck.save_model(ts, str(tmp_path / "a"), backend="hdf5")
    with pytest.raises(NotImplementedError, match="JAX"):
        tck.load_model(str(tmp_path), device=CPU)
    p = str(tmp_path / "nosuffix")
    tck.save_model(ts, p, include_data=True)
    back = tck.load_model(p, device=CPU)
    np.testing.assert_array_equal(back.X, flame["X_train"])
    assert type(back) is T.SPR and back.C is None \
        if hasattr(back, "C") else True
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tck.load_model(p)


# --------------------------------------------------------------------- #
# randomized_svd
# --------------------------------------------------------------------- #

def test_randomized_svd_on_jax_omega(monkeypatch):
    rng = np.random.default_rng(4)
    X = rng.standard_normal((300, 40))
    k, key = 6, jax.random.PRNGKey(3)
    p = min(40, k + 10)
    # JAX's Ω, rebuilt as randomized_svd draws it, stands in for torch's
    omega = torch.as_tensor(np.asarray(
        jax.random.normal(key, (40, p), dtype=jnp.float64)))
    drawn = []

    def jax_omega(shape, generator=None, dtype=None, device=None):
        drawn.append(tuple(shape))
        return omega.to(dtype=dtype, device=device)

    Uj, Sj, Vtj = jsvd.randomized_svd(jnp.asarray(X), k, key=key)
    monkeypatch.setattr(tsvd.torch, "randn", jax_omega)
    Ut, St, Vtt = tsvd.randomized_svd(torch.as_tensor(X), k)
    monkeypatch.undo()
    assert drawn == [(40, p)]
    assert _rel(St, Sj) <= TOL
    assert _rel(Ut, Uj) <= TOL and _rel(Vtt, Vtj) <= TOL


def test_randomized_svd_against_the_exact_svd():
    rng = np.random.default_rng(5)
    U, _ = np.linalg.qr(rng.standard_normal((400, 30)))
    V, _ = np.linalg.qr(rng.standard_normal((30, 30)))
    s = np.concatenate([np.geomspace(100.0, 10.0, 5), 1e-3 * np.ones(25)])
    X = torch.as_tensor((U * s) @ V.T)
    Ue, Se, Vte = torch.linalg.svd(X, full_matrices=False)
    g = torch.Generator().manual_seed(11)
    Ur, Sr, Vtr = tsvd.randomized_svd(X, 5, generator=g, n_iter=2)
    assert _rel(Sr, Se[:5]) <= 1e-12
    assert torch.allclose(torch.abs(torch.sum(Ur * Ue[:, :5], dim=0)),
                          torch.ones(5, dtype=X.dtype), atol=1e-12)
    # canonical signs: the largest-|.| entry of each column is positive
    idx = torch.argmax(torch.abs(Ur), dim=0)
    assert bool((Ur[idx, torch.arange(5)] > 0).all())
    # no generator: a new one seeded with 0, so the factors repeat
    again = tsvd.randomized_svd(X, 5)
    assert torch.equal(again[0], tsvd.randomized_svd(X, 5)[0])
    g0 = torch.Generator().manual_seed(0)
    assert torch.equal(again[0], tsvd.randomized_svd(X, 5, generator=g0)[0])
    assert Vtr.shape == (5, 30)
