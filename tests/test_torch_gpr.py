"""Port parity for the GP-ROM slice as a whole (CPU, float64): the
functional ``gpr_end_to_end``, the class flow ``GPR.fit → train → predict →
reconstruct`` (SingleTask and MultiTask, both engines) and
``gpr_from_numpy`` — each against the JAX package on the same numpy
inputs, at a small size (200 cells × 3 features, 16 + 3 snapshots, r = 5,
at most 60 Adam iterations).

Tolerances, float64:
* ``nrmse`` to 1e-10 absolute, the bar of
  ``tests/test_conformance_x64.py``;
* Adam iteration counts EQUAL;
* ``X_rec``, ``A_pred``, ``A_sigma``, losses at ``rtol=1e-8`` — two LAPACK
  eigensolvers and two Cholesky libraries differ at ~1e-15, which the GP
  training (up to 60 Adam steps, each a function of the last) may lift by
  a few decades;
* ``gpr_end_to_end``'s ``A_pred`` per mode up to sign: ``pod_fit`` leaves
  each mode's sign to the eigensolver (a GP on −y with ConstantMean gives
  −mean, so ``X_rec``, ``nrmse`` and ``gp_loss`` do not depend on it);
* ``gpr_from_numpy``: ``rtol=1e-10`` — the same parameters and training
  set, one posterior solve.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmeasure_tpu import GPR as JGPR
from openmeasure_tpu.core import scaling as JS
from openmeasure_tpu.gp import exact_gp as JE
from openmeasure_tpu.gp import kernels as JK
from openmeasure_tpu.pipelines import gpr_end_to_end as j_gpr, pod_fit as j_pod
from openmeasure_tpu.utils import checkpoint as JCK
from openmeasure_torch import GPR as TGPR
from openmeasure_torch import ROM
from openmeasure_torch.core.config import FitConfig, GPTrainConfig
from openmeasure_torch.datasets.synthetic import make_flame_dataset
from openmeasure_torch.pipelines import gpr_end_to_end as t_gpr
from openmeasure_torch.utils.convert import (GPR_ARRAY_KEYS, GPR_META_KEYS,
                                             gpr_from_numpy)

N_CELLS, NF, R, MAX_ITER = 200, 3, 5, 60


@pytest.fixture(scope="module")
def flame():
    return make_flame_dataset(n_cells=N_CELLS, n_features=NF, m_train=16,
                              m_test=3, seed=0)


def _jax_iterations(d, r, max_iter, rel_error):
    """The Adam iteration counts inside the JAX ``gpr_end_to_end`` (its
    result does not carry them): the same steps, called one by one."""
    Ur, Ar, S, _, _ = j_pod(jnp.asarray(d["X_train"]), NF, r, "std",
                            deflate=r // 2)
    Vr = Ar / S[None, :]
    P0, _, _ = JS.scale_parameters(jnp.asarray(d["P_train"]), "std")
    mean, kern, lik = JK.ConstantMean(), JK.MaternKernel(2.5), \
        JK.GaussianLikelihood()
    dd = P0.shape[1]
    task0 = {"mean": mean.init_params(dd), "kernel": kern.init_params(dd),
             "likelihood": lik.init_params()}
    params0 = {k: {kk: jnp.broadcast_to(v, (r,) + v.shape)
                   for kk, v in sub.items()} for k, sub in task0.items()}
    res = JE.adam_early_stop(
        JE.make_single_task_loss(mean, kern, lik, P0, Vr.T), params0,
        max_iter=max_iter, rel_error=rel_error,
        value_and_grad=JE.make_single_task_value_and_grad(mean, kern, lik,
                                                          P0, Vr.T))
    return np.asarray(res.iterations)


@pytest.mark.parametrize("rel_error", [1e-5, 1e-3])
def test_gpr_end_to_end_matches_jax_f64(flame, rel_error):
    args = (flame["X_train"], flame["P_train"], flame["P_test"],
            flame["X_test"])
    rj = j_gpr(*[jnp.asarray(a) for a in args], NF, R, max_iter=MAX_ITER,
               rel_error=rel_error)
    rt = t_gpr(*args, NF, R, max_iter=MAX_ITER, rel_error=rel_error,
               device="cpu")
    assert rt.X_rec.dtype == torch.float64
    assert abs(float(rt.nrmse) - float(rj.nrmse)) <= 1e-10
    np.testing.assert_array_equal(
        rt.iterations.numpy(),
        _jax_iterations(flame, R, MAX_ITER, rel_error))
    np.testing.assert_allclose(rt.X_rec.numpy(), np.asarray(rj.X_rec),
                               rtol=1e-8)
    np.testing.assert_allclose(rt.gp_loss.numpy(), np.asarray(rj.gp_loss),
                               rtol=1e-8)
    Aj, At = np.asarray(rj.A_pred), rt.A_pred.numpy()
    sign = np.sign(np.sum(At * Aj, axis=0))
    np.testing.assert_allclose(At * sign, Aj, rtol=1e-8,
                               atol=1e-10 * np.abs(Aj).max())
    np.testing.assert_allclose(rt.A_sigma.numpy(), np.asarray(rj.A_sigma),
                               rtol=1e-8)


def _fit_pair(flame, gpr_type, **fit_kw):
    jg = JGPR(flame["X_train"], NF, flame["xyz"], flame["P_train"], gpr_type)
    jg.fit(select_modes="number", n_modes=R, **fit_kw)
    tg = TGPR(flame["X_train"], NF, flame["xyz"], flame["P_train"], gpr_type,
              device="cpu")
    tg.fit(config=FitConfig(select_modes="number", n_modes=R), **fit_kw)
    return jg, tg


def _compare_predictions(jg, tg, P, rtol):
    aj, sj = jg.predict(P)
    at, st = tg.predict(P)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=rtol,
                               atol=rtol * np.abs(np.asarray(aj)).max())
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=rtol)
    return at, aj


@pytest.mark.parametrize("engine", ["device", "host"])
@pytest.mark.parametrize("gpr_type", ["SingleTask", "MultiTask"])
def test_class_flow_matches_jax(flame, gpr_type, engine):
    jg, tg = _fit_pair(flame, gpr_type)
    np.testing.assert_allclose(tg.Sigma_r.numpy(), np.asarray(jg.Sigma_r),
                               rtol=1e-10)
    np.testing.assert_allclose(tg.P0.numpy(), np.asarray(jg.P0), rtol=1e-12)
    jg.train(max_iter=MAX_ITER, engine=engine)
    models, liks = tg.train(config=GPTrainConfig(max_iter=MAX_ITER,
                                                 engine=engine))
    assert tg.engine == engine
    assert len(models) == len(jg.models) and len(liks) == len(jg.likelihoods)
    np.testing.assert_allclose(tg._final_loss.numpy(),
                               np.asarray(jg._final_loss), rtol=1e-8)
    np.testing.assert_allclose(tg.Vr_sigma.numpy(), np.asarray(jg.Vr_sigma),
                               rtol=1e-8)
    at, aj = _compare_predictions(jg, tg, flame["P_test"], rtol=1e-8)
    if engine == "host":
        assert at.device.type == "cpu" and at.dtype == torch.float64
    xt = tg.reconstruct(at).numpy()
    np.testing.assert_allclose(xt, np.asarray(jg.reconstruct(aj)), rtol=1e-8)
    # one parameter row (d,) predicts like a (1, d) batch
    a1, _ = tg.predict(flame["P_test"][0])
    np.testing.assert_allclose(a1.numpy(), at.numpy()[:1], rtol=1e-12)


@pytest.mark.parametrize("specs", ["linearmean-scale-rbf", "linear-kernel"])
def test_class_flow_other_specs_match_jax(flame, specs):
    """Specs beyond the defaults: a LinearMean with a ScaleKernel(RBF)
    trains through the closed-form oracle, a LinearKernel through autograd
    of the loss (the oracle does not cover it).  The LinearKernel case
    takes a ZeroMean: with centred parameters the ones vector is an
    eigenvector of K = v·P0·P0ᵀ + σ²I and the POD coefficients are centred,
    so a constant mean's gradient 1ᵀK⁻¹y is zero up to round-off, which
    Adam's normalized step turns into steps of any size and sign."""
    from openmeasure_torch.gp import kernels as TK
    if specs == "linear-kernel":
        jkw = dict(mean=JK.ZeroMean(), kernel=JK.LinearKernel())
        tkw = dict(mean=TK.ZeroMean(), kernel=TK.LinearKernel())
    else:
        jkw = dict(mean=JK.LinearMean(), kernel=JK.ScaleKernel(JK.RBFKernel()))
        tkw = dict(mean=TK.LinearMean(), kernel=TK.ScaleKernel(TK.RBFKernel()))
    jg, tg = _fit_pair(flame, "SingleTask")
    jg.train(max_iter=20, **jkw)
    tg.train(max_iter=20, **tkw)
    np.testing.assert_allclose(tg._final_loss.numpy(),
                               np.asarray(jg._final_loss), rtol=1e-8)
    _compare_predictions(jg, tg, flame["P_test"], rtol=1e-8)


def test_deflate_and_basis_fit_match_jax(flame):
    jg, tg = _fit_pair(flame, "SingleTask", deflate=True)
    np.testing.assert_allclose(tg.Ar.numpy(), np.asarray(jg.Ar), rtol=1e-8,
                               atol=1e-8 * np.abs(np.asarray(jg.Ar)).max())
    basis = (tg.Ur.numpy(), tg.Ar.numpy())
    jb = JGPR(flame["X_train"], NF, flame["xyz"], flame["P_train"])
    jb.fit(basis=basis)
    tb = TGPR(flame["X_train"], NF, flame["xyz"], flame["P_train"],
              device="cpu")
    tb.fit(basis=basis)
    np.testing.assert_allclose(tb.Vr.numpy(), np.asarray(jb.Vr), rtol=1e-12,
                               atol=1e-15)
    jb.train(max_iter=20)
    tb.train(max_iter=20)
    _compare_predictions(jb, tb, flame["P_test"], rtol=1e-8)
    with pytest.raises(ValueError, match="deflate"):
        tb.fit(basis=basis, deflate=True)


def test_refit_drops_the_trained_state(flame):
    tg = TGPR(flame["X_train"], NF, flame["xyz"], flame["P_train"],
              device="cpu")
    tg.fit(select_modes="number", n_modes=R)
    tg.train(max_iter=5)
    tg.fit(select_modes="number", n_modes=R)
    assert not hasattr(tg, "params") and not hasattr(tg, "_train_X")
    with pytest.raises(AttributeError, match="fit"):
        tg.predict(flame["P_test"])


def test_errors_and_unported_parts(flame):
    tg = TGPR(flame["X_train"], NF, flame["xyz"], flame["P_train"],
              device="cpu")
    tg.fit(select_modes="number", n_modes=R)
    with pytest.raises(TypeError, match="GaussianLikelihood"):
        from openmeasure_torch.gp import kernels as TK
        tg.train(likelihood=TK.MultitaskGaussianLikelihood(R))
    with pytest.raises(ValueError, match="engine"):
        tg.train(engine="tpu")
    tg.train(max_iter=5)
    # constrained prediction is MultiTask only, as in the JAX package
    with pytest.raises(NotImplementedError, match="MultiTask"):
        tg.predict(flame["P_test"], limits=[0.0, 1.0])
    with pytest.raises(NotImplementedError, match="MultiTask"):
        tg.predict(flame["P_test"], problem_dict={"bc": ([0], np.ones((1, 3)))})
    with pytest.raises(NotImplementedError, match="item 14"):
        ROM.update_basis(tg, flame["X_test"])
    with pytest.raises(NotImplementedError, match="item 14"):
        tg.update_basis(flame["X_test"], flame["P_test"])
    P_bad = np.array(flame["P_train"])
    P_bad[:, 1] = 2.0
    tb = TGPR(flame["X_train"], NF, flame["xyz"], P_bad, device="cpu")
    with pytest.raises(ValueError, match="column"):
        tb.fit(select_modes="number", n_modes=R)
    with pytest.raises(Exception, match="number of parameters"):
        TGPR(flame["X_train"], NF, flame["xyz"], P_bad[:3], device="cpu")


def _state_of(jg):
    """A JAX model's state under the checkpoint format's key names."""
    state = {a: np.asarray(getattr(jg, a)) for a in GPR_ARRAY_KEYS
             if getattr(jg, a, None) is not None}
    JCK._flatten_tree(jg.params, "params", state)
    meta = {k: getattr(jg, k) for k in GPR_META_KEYS if hasattr(jg, k)}
    meta.update(mean_spec=JCK._spec_to_json(jg.mean),
                kernel_spec=JCK._spec_to_json(jg.kernel),
                likelihood_spec=JCK._spec_to_json(jg.likelihood))
    return state, meta


@pytest.mark.parametrize("gpr_type,engine", [("SingleTask", "device"),
                                             ("MultiTask", "device"),
                                             ("SingleTask", "host")])
def test_gpr_from_numpy_reproduces_jax_predict(flame, gpr_type, engine):
    jg = JGPR(flame["X_train"], NF, flame["xyz"], flame["P_train"], gpr_type)
    jg.fit(select_modes="number", n_modes=R)
    jg.train(max_iter=40, engine=engine)
    state, meta = _state_of(jg)
    tg = gpr_from_numpy(state, meta, device="cpu")
    assert tg.r == R and tg.gpr_type == gpr_type and tg.engine == engine
    at, aj = _compare_predictions(jg, tg, flame["P_test"], rtol=1e-10)
    np.testing.assert_allclose(tg.reconstruct(at).numpy(),
                               np.asarray(jg.reconstruct(aj)), rtol=1e-10)


def test_gpr_from_numpy_zero_mean_and_untrained(flame):
    """An empty parameter sub-dict (ZeroMean) survives the flattened keys;
    a state without parameters gives a fitted, untrained model."""
    jg = JGPR(flame["X_train"], NF, flame["xyz"], flame["P_train"])
    jg.fit(select_modes="number", n_modes=R)
    jg.train(mean=JK.ZeroMean(), kernel=JK.ScaleKernel(JK.RBFKernel()),
             max_iter=20)
    state, meta = _state_of(jg)
    assert "params/mean/__empty__" in state
    tg = gpr_from_numpy(state, meta, device="cpu")
    assert tg.params["mean"] == {}
    _compare_predictions(jg, tg, flame["P_test"], rtol=1e-10)
    bare = {k: v for k, v in state.items() if not k.startswith("params/")}
    tb = gpr_from_numpy(bare, {"n_features": NF}, device="cpu")
    with pytest.raises(AttributeError, match="fit"):
        tb.predict(flame["P_test"])
    tb.train(max_iter=20, mean=None)
    with pytest.raises(KeyError, match="P0"):
        gpr_from_numpy({k: v for k, v in bare.items() if k != "P0"},
                       {"n_features": NF}, device="cpu")
