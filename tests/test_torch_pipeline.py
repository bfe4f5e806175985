"""Port parity for the SPR soft-sensing slice as a whole (CPU): the
functional ``spr_end_to_end``, the class flow ``SPR.fit → optimal_placement
→ train → predict → reconstruct``, and ``spr_from_numpy`` — each against
the JAX package on the same numpy inputs.

Tolerances, float64:
* pivots EQUAL — the same greedy algorithm on the same float64 numbers;
* ``X_rec``/``Ar`` at ``rtol=1e-8`` — two LAPACK eigensolvers and two
  summation orders differ at ~1e-15; the gappy solve's conditioning
  (cond(Θ) ≲ 1e4 here) leaves ample room;
* ``nrmse`` at ``rtol=1e-6`` — a ratio of small differences of the above;
* ``exp_variance`` at ``rtol=1e-10`` — a cumulative sum of the same S².
The float32 case only checks that both NRMSEs are small and within 2× of
each other: fp32 near-ties can legitimately pick different pivots.
"""

import numpy as np
import pytest
import torch

from openmeasure_tpu import SPR as JSPR
from openmeasure_tpu.pipelines import spr_end_to_end as j_spr
from openmeasure_torch import SPR as TSPR
from openmeasure_torch.core.config import FitConfig, PlacementConfig
from openmeasure_torch.datasets.synthetic import make_flame_dataset
from openmeasure_torch.pipelines import pod_fit, spr_end_to_end as t_spr
from openmeasure_torch.utils import metrics as TM
from openmeasure_torch.utils.convert import ARRAY_KEYS, META_KEYS, spr_from_numpy

N_CELLS, NF, R = 400, 3, 6


@pytest.fixture(scope="module")
def flame():
    return make_flame_dataset(n_cells=N_CELLS, n_features=NF, m_train=12,
                              m_test=3, seed=0)


def _compare_results(rt, rj):
    np.testing.assert_array_equal(rt.pivots.numpy(), np.asarray(rj.pivots))
    np.testing.assert_allclose(rt.X_rec.numpy(), np.asarray(rj.X_rec),
                               rtol=1e-8)
    # porting trap 8: with canonicalize=False each mode's sign is the
    # eigensolver's choice, so the coefficients match per mode up to sign
    Aj = np.asarray(rj.Ar)
    At = rt.Ar.numpy() * np.sign(np.sum(rt.Ar.numpy() * Aj, axis=0))
    np.testing.assert_allclose(At, Aj, rtol=1e-8,
                               atol=1e-8 * np.abs(Aj).max())
    np.testing.assert_allclose(float(rt.nrmse), float(rj.nrmse), rtol=1e-6)
    np.testing.assert_allclose(rt.exp_variance.numpy(),
                               np.asarray(rj.exp_variance), rtol=1e-10)


@pytest.mark.parametrize("refine", [1, 2])
def test_spr_end_to_end_matches_jax_f64(flame, refine):
    rj = j_spr(flame["X_train"], flame["X_test"], n_features=NF, r=R,
               refine=refine)
    rt = t_spr(flame["X_train"], flame["X_test"], n_features=NF, r=R,
               refine=refine, device="cpu")
    assert rt.X_rec.dtype == torch.float64 and rt.pivots.dtype == torch.int32
    _compare_results(rt, rj)


def test_spr_end_to_end_svd_width_matches_jax(flame):
    rj = j_spr(flame["X_train"], flame["X_test"], n_features=NF, r=R,
               svd_width=9)
    rt = t_spr(flame["X_train"], flame["X_test"], n_features=NF, r=R,
               svd_width=9, device="cpu")
    _compare_results(rt, rj)


def test_spr_end_to_end_fp32_accuracy():
    d = make_flame_dataset(n_cells=N_CELLS, n_features=NF, m_train=20,
                           m_test=3, seed=0, dtype=np.float32)
    rj = j_spr(d["X_train"], d["X_test"], n_features=NF, r=10)
    rt = t_spr(d["X_train"], d["X_test"], n_features=NF, r=10, device="cpu")
    assert rt.X_rec.dtype == torch.float32
    nt, nj = float(rt.nrmse), float(rj.nrmse)
    assert nt < 1e-3 and nj < 1e-3
    assert 0.5 <= nt / nj <= 2.0


def test_pod_fit_matches_basis_of_the_class_api(flame):
    """pod_fit (deflate=0) spans the same leading subspace as ROM.fit."""
    Ur, Ar, Sr, cnt, scl = pod_fit(flame["X_train"], NF, R, device="cpu")
    spr = TSPR(flame["X_train"], NF, flame["xyz"], device="cpu")
    spr.fit(config=FitConfig(select_modes="number", n_modes=R))
    np.testing.assert_allclose(Sr.numpy(), spr.Sigma_r.numpy(), rtol=1e-9)
    P = Ur.numpy() @ Ur.numpy().T
    np.testing.assert_allclose(P @ spr.Ur.numpy(), spr.Ur.numpy(), atol=1e-8)


def _measure(C, X_test, j, sigma):
    y = np.zeros((C.shape[0], 3))
    y[:, 0] = C @ X_test[:, j]
    y[:, 1] = sigma
    y[:, 2] = np.argmax(C, axis=1) // N_CELLS
    return y


@pytest.fixture(scope="module")
def fitted_pair(flame):
    js = JSPR(flame["X_train"], NF, flame["xyz"])
    js.fit(select_modes="number", n_modes=R)
    Cj = np.asarray(js.optimal_placement())
    js.train(Cj)
    ts = TSPR(flame["X_train"], NF, flame["xyz"], device="cpu")
    ts.fit(select_modes="number", n_modes=R)
    Ct = ts.optimal_placement(config=PlacementConfig(calc_type="qr"))
    ts.train(Ct)
    return js, ts, Cj, Ct


def test_class_flow_placement_matches_jax(fitted_pair):
    js, ts, Cj, Ct = fitted_pair
    np.testing.assert_array_equal(Ct.numpy(), Cj)
    np.testing.assert_allclose(ts.Sigma_r.numpy(), np.asarray(js.Sigma_r),
                               rtol=1e-9)


@pytest.mark.parametrize("sigma", [0.0, 0.01])
def test_class_flow_predict_reconstruct_matches_jax(flame, fitted_pair, sigma):
    """OLS predict (host f64 pinv, weighted when σ > 0) and reconstruct of
    all three test snapshots, against the JAX SPR."""
    js, ts, Cj, _ = fitted_pair
    ys = [_measure(Cj, flame["X_test"], j, sigma) for j in range(3)]
    aj, sj = js.predict(ys)
    at, st = ts.predict(ys)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=1e-8,
                               atol=1e-8 * np.abs(np.asarray(aj)).max())
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-8,
                               atol=1e-12)
    xt = ts.reconstruct(at).numpy()
    np.testing.assert_allclose(xt, np.asarray(js.reconstruct(aj)), rtol=1e-8)
    assert float(TM.nrmse(xt, flame["X_test"])) < 1e-2


def test_class_flow_mask_and_fit_predict(flame, fitted_pair):
    """A region mask zeroes the excluded rows of Ur in both packages and
    gives the same placement; fit_predict is fit + train + predict."""
    js, ts, Cj, _ = fitted_pair
    mask = np.ones(N_CELLS * NF, dtype=bool)
    mask[np.argmax(Cj, axis=1)[:2]] = False          # forbid two sensors
    j2 = JSPR(flame["X_train"], NF, flame["xyz"])
    j2.fit(select_modes="number", n_modes=R)
    t2 = TSPR(flame["X_train"], NF, flame["xyz"], device="cpu")
    t2.fit(select_modes="number", n_modes=R)
    Cj2 = np.asarray(j2.optimal_placement(mask=mask))
    Ct2 = t2.optimal_placement(mask=mask)
    np.testing.assert_array_equal(Ct2.numpy(), Cj2)
    y = _measure(Cj, flame["X_test"], 0, 0.0)
    t3 = TSPR(flame["X_train"], NF, flame["xyz"], device="cpu")
    a3, _ = t3.fit_predict(Cj, y, select_modes="number", n_modes=R)
    at, _ = ts.predict(y)
    np.testing.assert_allclose(a3.numpy(), at.numpy(), rtol=1e-10)


def test_spr_from_numpy_matches_jax(flame, fitted_pair):
    """The JAX-fitted basis carried across gives the same predict and
    reconstruct to 1e-10 (same basis, same host-f64 solve)."""
    js, _, Cj, _ = fitted_pair
    state = {k: np.asarray(getattr(js, k)) for k in ARRAY_KEYS
             if k != "C" and getattr(js, k, None) is not None}
    state["C"] = Cj
    meta = {k: getattr(js, k) for k in META_KEYS if hasattr(js, k)}
    tp = spr_from_numpy(state, meta, device="cpu")
    assert tp.r == R and tp.n_points == N_CELLS
    ys = [_measure(Cj, flame["X_test"], j, 0.02) for j in range(3)]
    aj, _ = js.predict(ys)
    at, _ = tp.predict(ys)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=1e-10,
                               atol=1e-10 * np.abs(np.asarray(aj)).max())
    np.testing.assert_allclose(tp.reconstruct(at).numpy(),
                               np.asarray(js.reconstruct(aj)), rtol=1e-10)


def test_unported_methods_raise_with_roadmap_item():
    """Sharding is ported: the serving row sharding, a sensor's shard and
    the streaming fit's mesh branch reject an argument that is not a
    ``DeviceMesh`` with a clear error, and on a world of one in this
    process they give the unsharded results."""
    from openmeasure_torch import DecoderSensor, DynamicSensor, SoftSensor
    from openmeasure_torch.parallel.harness import local_world
    from openmeasure_torch.serving import shard_state_rows
    from openmeasure_torch.streaming import StreamingROM, StreamingSPR
    with pytest.raises(TypeError, match="DeviceMesh"):
        shard_state_rows({}, None)
    for cls in (SoftSensor, DecoderSensor, DynamicSensor):
        with pytest.raises(TypeError, match="DeviceMesh"):
            cls.shard(None, None)
    X = np.random.default_rng(0).standard_normal((40, 6)) + 5.0
    with pytest.raises(TypeError, match="DeviceMesh"):
        StreamingROM(X, 2, device="cpu").fit(mesh=object())
    fits = []
    with local_world("cpu") as mesh:
        for m_ in (None, mesh):
            s = StreamingSPR(X, 2, dtype=np.float64, device="cpu")
            s.fit(select_modes="number", n_modes=3, mesh=m_)
            s.train(s.optimal_placement())
            fits.append(s)
    assert fits[1].fit_mesh_ is not None and fits[0].fit_mesh_ is None
    for k in ("Ur", "Sigma_r", "Ar", "Theta", "X_cnt", "X_scl"):
        assert torch.equal(getattr(fits[1], k), getattr(fits[0], k)), k


def test_class_flow_operator_forms_match_jax(flame):
    """train() with a scipy.sparse C and cond=True, then predict;
    reconstruct and unscale through the sampling operator; train() with
    Theta itself (is_Theta=True); ROM.scale_limits — each against the JAX
    SPR (float64, same tolerances as above; k at 1e-10: the same host f64
    SVD of the same Theta)."""
    import scipy.sparse as sp
    js = JSPR(flame["X_train"], NF, flame["xyz"])
    js.fit(select_modes="number", n_modes=R)
    ts = TSPR(flame["X_train"], NF, flame["xyz"], device="cpu")
    ts.fit(select_modes="number", n_modes=R)
    C = np.asarray(js.optimal_placement())
    Cs = sp.csr_matrix(C)
    js.train(Cs, cond=True)
    ts.train(Cs, cond=True)
    assert ts.k == pytest.approx(js.k, rel=1e-10)
    y = _measure(C, flame["X_test"], 1, 0.0)
    aj, _ = js.predict(y)
    at, _ = ts.predict(y)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=1e-8,
                               atol=1e-8 * np.abs(np.asarray(aj)).max())
    np.testing.assert_allclose(ts.reconstruct(at, sampling=Cs).numpy(),
                               np.asarray(js.reconstruct(aj, sampling=Cs)),
                               rtol=1e-8)
    for lt, lj in zip(ts.scale_limits([0.0, 1e4]),
                      js.scale_limits([0.0, 1e4])):
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-12)
    Th = np.asarray(js.Theta)
    ts.train(Th, is_Theta=True)
    assert ts.C is None
    np.testing.assert_array_equal(ts.Theta.numpy(), Th)


def test_refit_invalidates_training_and_basis_fit_matches_jax(flame):
    """A refit drops the trained Theta (predict then asks for train());
    fit(basis=(Ur, Ar)) derives Sigma_r and Vr as the JAX package does."""
    ts = TSPR(flame["X_train"], NF, flame["xyz"], device="cpu")
    ts.fit(select_modes="number", n_modes=R)
    C = ts.optimal_placement()
    ts.train(C)
    y = _measure(C.numpy(), flame["X_test"], 0, 0.0)
    ts.fit(select_modes="number", n_modes=R)
    with pytest.raises(AttributeError, match="invalidated"):
        ts.predict(y)
    basis = (ts.Ur.numpy(), ts.Ar.numpy())
    tb = TSPR(flame["X_train"], NF, flame["xyz"], device="cpu")
    tb.fit(basis=basis)
    jb = JSPR(flame["X_train"], NF, flame["xyz"])
    jb.fit(basis=basis)
    assert tb.r == jb.r == R
    np.testing.assert_allclose(tb.Sigma_r.numpy(), np.asarray(jb.Sigma_r),
                               rtol=1e-12)
    np.testing.assert_allclose(tb.Vr.numpy(), np.asarray(jb.Vr), rtol=1e-12,
                               atol=1e-15)
