"""Port parity for multifidelity CoKriging (CPU, float64):
``multifi/cokriging.py``, ``serving.CoKrigingSensor`` and
``utils/convert.cokriging_from_numpy`` against the JAX package on the same
numpy inputs — the setup of ``tests/test_conformance_x64.py:158-185`` (2
features, 30 LF and 50 HF cells, 8 linked + 5 unlinked conditions in 3
parameters, 4 modes each side).

Tolerances, float64: the manifold alignment (two POD fits and a Procrustes
rotation, no search) at ``rtol=1e-10``; the predictions, which run through
the θ search of the default box, within ``MEAN_REL = 1e-7`` of the HF
field's span and ``MSE_REL = 5e-4`` of max|MSE| — the floor set out in
``tests/test_torch_mfk.py``; a model carried across with its fitted state
(no search) and the serving function against ``CoKriging.predict`` at
``1e-12``: the same operations on the same state.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmeasure_tpu import CoKriging as JCK
from openmeasure_tpu.serving import CoKrigingSensor as JSensor
from openmeasure_torch import CoKriging as TCK
from openmeasure_torch import CoKrigingSensor
from openmeasure_torch.core.config import CoKrigingConfig
from openmeasure_torch.utils.convert import (COK_BATCH_SCALARS,
                                             COK_LEVEL_KEYS,
                                             cokriging_from_numpy)

NF, N_LF, N_HF = 2, 30, 50
MEAN_REL, MSE_REL, EXACT = 1e-7, 5e-4, 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Hundreds of tiny torch ops a Newton step: one intra-op thread, so
    torch's OpenMP threads do not spin beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem():
    rng = np.random.default_rng(0)
    Xl, Xu, Xt = rng.random((8, 3)), rng.random((5, 3)), rng.random((4, 3))

    def fields(X, npts):
        t = np.linspace(0, 1, npts * NF)[:, None]
        return (np.sin(3 * t * X[:, 0][None, :])
                + 0.5 * np.cos(2 * t * (X[:, 1] + X[:, 2])[None, :]))

    return dict(Xl=Xl, Xu=Xu, Xt=Xt, Ylf_l=fields(Xl, N_LF),
                Ylf_u=fields(Xu, N_LF), Yhf_l=fields(Xl, N_HF) * 1.1 + 0.05,
                xyz_lf=rng.random((N_LF, 3)), xyz_hf=rng.random((N_HF, 3)))


@pytest.fixture(scope="module")
def prob():
    return _problem()


def _args(p):
    return (p["Xl"], p["Xu"], p["Ylf_l"], p["Ylf_u"], p["Yhf_l"],
            p["xyz_lf"], p["xyz_hf"], NF)


def _fit(cls, p, engine, **kw):
    ck = cls(*_args(p), **kw)
    ck.engine = engine
    ck.manifold_alignment(select_modes="number", n_modes_hf=4, n_modes_lf=4)
    ck.fit()
    return ck


@pytest.fixture(scope="module", params=["device", "host"])
def pair(request, prob):
    engine = request.param
    return (engine, _fit(JCK, prob, engine),
            _fit(TCK, prob, engine, device="cpu"))


def _rel(got, want, scale=None):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    scale = np.abs(want).max() if scale is None else scale
    return float(np.abs(got - want).max() / scale)


def test_alignment_and_predict_match_jax(pair, prob):
    engine, jc, tc = pair
    assert tc.n_latent == jc.n_latent == 4
    for key in ("Zr_aligned", "Zr_hf", "Ur_hf", "Sigma_hf", "Sigma_lf"):
        assert _rel(getattr(tc, key), getattr(jc, key)) <= 1e-10, key
    Yj, Sj = jc.predict(prob["Xt"])
    Yt, St = tc.predict(prob["Xt"])
    assert Yt.shape == (N_HF * NF, 4) and Yt.dtype == torch.float64
    assert _rel(Yt, Yj, np.ptp(Yj)) <= MEAN_REL
    assert _rel(St, Sj) <= MSE_REL
    lev = tc._batch.levels[0]
    assert lev["theta"].device.type == "cpu"
    assert lev["theta"].dtype == torch.float64
    assert tc._batch._proto._fit_engine == engine
    # truncated predict projects with the first k columns of Ur_hf
    Y2j, _ = jc.predict(prob["Xt"], n_truncated=2)
    Y2t, _ = tc.predict(prob["Xt"], n_truncated=2)
    assert _rel(Y2t, Y2j, np.ptp(Y2j)) <= MEAN_REL


def test_model_list_views_match_batched_predict(pair, prob):
    _, _, tc = pair
    Yt, St = tc.predict(prob["Xt"])
    views = object.__new__(TCK)
    views.__dict__.update({k: v for k, v in tc.__dict__.items()
                           if k != "_batch"})
    Yv, Sv = views.predict(prob["Xt"])
    assert _rel(Yv, Yt) <= EXACT and _rel(Sv, St) <= EXACT


def test_sensor_matches_cokriging_predict(pair, prob):
    _, jc, tc = pair
    sensor = CoKrigingSensor.from_cokriging(tc).warmup(batch=2)
    Ys, Ss = sensor(prob["Xt"])
    Yt, St = tc.predict(prob["Xt"])
    assert Ys.dtype == tc.Ur_hf.dtype == torch.float64
    assert _rel(Ys, Yt) <= EXACT and _rel(Ss, St) <= EXACT
    Ysj, _ = JSensor.from_cokriging(jc)(prob["Xt"])
    assert _rel(Ys, Ysj, np.ptp(np.asarray(Ysj))) <= MEAN_REL
    with pytest.raises(ValueError, match="X_test"):
        sensor(np.zeros((2, 2)))
    with pytest.raises(FileNotFoundError):
        CoKrigingSensor.load("model.npz", device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        sensor.shard(None)
    from openmeasure_torch.parallel.harness import local_world
    with local_world("cpu") as mesh:
        got = sensor.shard(mesh)(prob["Xt"])
    for a, b in zip(got, sensor(prob["Xt"])):
        assert torch.equal(a, b)


def test_sensor_casts_to_the_basis_dtype(prob):
    """A host-engine fit keeps float64 levels on the host; its sensor
    serves in the basis's dtype (float32 here) on the basis's device — the
    port's documented deviation from the JAX cast to the ambient float."""
    p32 = {k: (v.astype(np.float32) if k.startswith("Y") else v)
           for k, v in prob.items()}
    ck = _fit(TCK, p32, "host", device="cpu")
    assert ck.Ur_hf.dtype == torch.float32
    assert ck._batch.levels[0]["L"].dtype == torch.float64
    sensor = CoKrigingSensor.from_cokriging(ck)
    assert all(v.dtype == torch.float32
               for lev in sensor._state["levels"] for v in lev.values())
    Ys, _ = sensor(prob["Xt"])
    Yp, _ = ck.predict(prob["Xt"])
    assert Ys.dtype == torch.float32
    assert _rel(Ys, Yp, float(Yp.max() - Yp.min())) <= 1e-5


def test_from_numpy_round_trip(pair, prob):
    """The JAX model's fitted state under its checkpoint keys
    (``openmeasure_tpu/utils/checkpoint.py:235-319``) carried into a port
    CoKriging: the same predictions without refitting."""
    engine, jc, _ = pair
    b = jc._batch
    state = {"attr/Ur_hf": np.asarray(jc.Ur_hf),
             "attr/Zr_hf": np.asarray(jc.Zr_hf),
             "attr/Zr_aligned": np.asarray(jc.Zr_aligned),
             "romhf/X_cnt": np.asarray(jc.rom_hf.X_cnt),
             "romhf/X_scl": np.asarray(jc.rom_hf.X_scl),
             "romhf/xyz": np.asarray(jc.xyz_hf)}
    for name in COK_BATCH_SCALARS:
        state[f"batch/{name}"] = np.asarray(getattr(b, name))
    for l, lev in enumerate(b.levels):
        for key in COK_LEVEL_KEYS:
            state[f"batch/level{l}/{key}"] = np.asarray(lev[key])
    meta = {"n_features": NF, "n_latent": jc.n_latent,
            "regr_type": jc.regr_type, "rho_regr": jc.rho_regr,
            "normalize": jc.normalize, "engine": engine,
            "batch": {"n_levels": b.n_levels, "K": b.K,
                      "rho_cols": [lev["rho_cols"] for lev in b.levels]}}
    tc = cokriging_from_numpy(state, meta, device="cpu")
    Yj, Sj = jc.predict(prob["Xt"])
    Yt, St = tc.predict(prob["Xt"])
    assert _rel(Yt, Yj) <= EXACT and _rel(St, Sj) <= EXACT
    Y1j, _ = jc.predict(prob["Xt"], n_truncated=1)
    Y1t, _ = tc.predict(prob["Xt"], n_truncated=1)
    assert _rel(Y1t, Y1j) <= EXACT
    assert len(tc.model_list) == jc.n_latent
    Ys, _ = CoKrigingSensor.from_cokriging(tc)(prob["Xt"])
    assert _rel(Ys, Yj) <= EXACT
    with pytest.raises(KeyError, match="attr/Ur_hf"):
        cokriging_from_numpy({k: v for k, v in state.items()
                              if k != "attr/Ur_hf"}, meta, device="cpu")


def test_validation_messages_equal_jax(prob):
    p = prob
    bad = [(p["Xl"], p["Xu"], p["Ylf_l"][:, :-1], p["Ylf_u"], p["Yhf_l"]),
           (p["Xl"], p["Xu"], p["Ylf_l"], p["Ylf_u"][:, :-1], p["Yhf_l"])]
    for args in bad:
        with pytest.raises(Exception) as ej:
            JCK(*args, p["xyz_lf"], p["xyz_hf"], NF)
        with pytest.raises(Exception) as et:
            TCK(*args, p["xyz_lf"], p["xyz_hf"], NF, device="cpu")
        assert type(et.value) is type(ej.value) is Exception
        assert str(et.value) == str(ej.value)


def test_config_realignment_and_truncation(prob):
    cfg = CoKrigingConfig(regr_type="constant", theta=[2.0, 1.0, 1.5])
    ck = TCK(*_args(prob), config=cfg, device="cpu")
    assert ck.regr_type == "constant" and ck.engine == "device"
    with pytest.raises(AttributeError, match="fit"):
        ck.predict(prob["Xt"])
    ck.manifold_alignment(select_modes="number", n_modes_hf=3, n_modes_lf=3)
    ck.fit()
    assert ck._batch.regr == "constant"
    assert torch.equal(ck._batch.levels[1]["theta"][0],
                       torch.tensor([2.0, 1.0, 1.5], dtype=torch.float64))
    with pytest.raises(ValueError, match="n_truncated"):
        ck.predict(prob["Xt"], n_truncated=ck.n_latent + 1)
    with pytest.raises(ValueError, match="n_truncated"):
        ck.predict(prob["Xt"], n_truncated=0)
    # re-alignment drops the fitted kriging state
    ck.manifold_alignment(select_modes="number", n_modes_hf=2, n_modes_lf=2)
    with pytest.raises(AttributeError, match="fit"):
        ck.predict(prob["Xt"])
    ck.fit()
    Y, _ = ck.predict(prob["Xt"])
    assert Y.shape == (N_HF * NF, 4) and bool(torch.isfinite(Y).all())
    # fewer LF modes than HF modes: the LF scores are zero-padded
    ck.manifold_alignment(select_modes="number", n_modes_hf=3, n_modes_lf=2)
    assert ck.n_latent == 3 and ck.Zr_aligned.shape == (3, 13)
