"""Port parity for the GP engine (``openmeasure_torch/gp/kernels.py`` and
``gp/exact_gp.py``) against ``openmeasure_tpu`` on the same numpy inputs,
float64 on the CPU.

The port's functions take a leading batch (mode) axis where the JAX
package vmaps, so each JAX side here is ``jax.vmap`` of the JAX function.

Tolerances (float64):
* kernels, means, likelihoods: ``rtol=1e-12`` — the same elementwise
  formulas, a few ulps apart at most;
* log-prob, posterior, the closed-form oracle: ``rtol=1e-10`` — LAPACK
  Cholesky and solves of the same matrices (cond ≲ 1e4 here) in two
  libraries;
* the oracle against ``torch.autograd`` of the port's own loss:
  ``rtol=1e-9`` — analytic against reverse-mode gradients, round-off only
  (the JAX package pins the same bar, ``tests/test_gp_engine.py``);
* ``adam_early_stop``: EQUAL iteration counts, and parameters and losses to
  1e-10 — the same Adam arithmetic in the same order from the same
  gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openmeasure_tpu.gp.exact_gp as JE
from openmeasure_tpu.gp import kernels as JK
from openmeasure_torch.gp import exact_gp as TE
from openmeasure_torch.gp import kernels as TK
from openmeasure_torch.linalg import chol as TC


def _np_tree(rng, spec_j, d, r=None, scale=0.3):
    """Random raw parameters (numpy) in the JAX spec's layout, optionally
    stacked over r modes."""
    base = jax.tree_util.tree_map(np.asarray, spec_j.init_params(d))

    def draw(x):
        shape = x.shape if r is None else (r,) + x.shape
        return x + scale * rng.standard_normal(shape)
    return jax.tree_util.tree_map(draw, base)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(tree):
    return jax.tree_util.tree_map(torch.as_tensor, tree)


def _assert_trees(t_tree, j_tree, rtol, atol=0.0):
    jl, jdef = jax.tree_util.tree_flatten(j_tree)
    tl, tdef = jax.tree_util.tree_flatten(
        jax.tree_util.tree_map(lambda x: x.detach().numpy(), t_tree))
    assert jdef == tdef, (jdef, tdef)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol)


KERNELS = [
    ("rbf", lambda: (JK.RBFKernel(), TK.RBFKernel())),
    ("rbf-ard", lambda: (JK.RBFKernel(3), TK.RBFKernel(3))),
    ("matern05", lambda: (JK.MaternKernel(0.5), TK.MaternKernel(0.5))),
    ("matern15", lambda: (JK.MaternKernel(1.5), TK.MaternKernel(1.5))),
    ("matern25", lambda: (JK.MaternKernel(2.5), TK.MaternKernel(2.5))),
    ("matern25-ard", lambda: (JK.MaternKernel(2.5, 3),
                              TK.MaternKernel(2.5, 3))),
    ("scale-matern", lambda: (JK.ScaleKernel(JK.MaternKernel(2.5)),
                              TK.ScaleKernel(TK.MaternKernel(2.5)))),
    ("scale-rbf", lambda: (JK.ScaleKernel(JK.RBFKernel()),
                           TK.ScaleKernel(TK.RBFKernel()))),
    ("linear", lambda: (JK.LinearKernel(), TK.LinearKernel())),
]
MEANS = [
    ("zero", lambda: (JK.ZeroMean(), TK.ZeroMean())),
    ("constant", lambda: (JK.ConstantMean(), TK.ConstantMean())),
    ("linear", lambda: (JK.LinearMean(), TK.LinearMean())),
    ("linear-nobias", lambda: (JK.LinearMean(bias=False),
                               TK.LinearMean(bias=False))),
]


@pytest.mark.parametrize("name,make", KERNELS, ids=[k[0] for k in KERNELS])
def test_kernels_match_jax_plain_and_batched(name, make):
    sj, st = make()
    rng = np.random.default_rng(len(name))
    X1, X2 = rng.standard_normal((9, 3)), rng.standard_normal((6, 3))
    X1[2] = X2[4]                       # a coincident pair (Matérn guard)
    p = _np_tree(rng, sj, 3)
    got = st(_t(p), torch.as_tensor(X1), torch.as_tensor(X2))
    want = sj(_j(p), jnp.asarray(X1), jnp.asarray(X2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
    pb = _np_tree(rng, sj, 3, r=4)
    got = st(_t(pb), torch.as_tensor(X1), torch.as_tensor(X1))
    want = jax.vmap(lambda q: sj(q, jnp.asarray(X1), jnp.asarray(X1)))(
        _j(pb))
    assert got.shape == (4, 9, 9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
    # init layout and values match (raw zeros)
    _assert_trees(st.init_params(3, dtype=torch.float64), sj.init_params(3),
                  rtol=0)


def test_matern_rejects_other_nu():
    with pytest.raises(ValueError):
        TK.MaternKernel(2.0)


@pytest.mark.parametrize("name,make", MEANS, ids=[m[0] for m in MEANS])
def test_means_match_jax(name, make):
    sj, st = make()
    rng = np.random.default_rng(5)
    X = rng.standard_normal((7, 3))
    pb = _np_tree(rng, sj, 3, r=4)
    got = st(_t(pb), torch.as_tensor(X))
    if not pb:
        # no parameters, so no batch axis to carry: the zero mean of the
        # points, which broadcasts against any batch of targets
        want = sj(pb, jnp.asarray(X))
    else:
        want = jax.vmap(lambda q: sj(q, jnp.asarray(X)))(_j(pb))
        assert got.shape == (4, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


def test_likelihoods_match_jax():
    rng = np.random.default_rng(6)
    raw = rng.standard_normal(4)
    np.testing.assert_allclose(
        TK.GaussianLikelihood().noise({"raw_noise": torch.as_tensor(raw)})
        .numpy(),
        np.asarray(JK.GaussianLikelihood().noise(
            {"raw_noise": jnp.asarray(raw)})), rtol=1e-12)
    assert TK.NOISE_LOWER == JK.NOISE_LOWER == 1e-4
    mt = {"raw_noise": rng.standard_normal(()),
          "raw_task_noises": rng.standard_normal(5)}
    np.testing.assert_allclose(
        TK.MultitaskGaussianLikelihood(5).noise(_t(mt)).numpy(),
        np.asarray(JK.MultitaskGaussianLikelihood(5).noise(_j(mt))),
        rtol=1e-12)
    _assert_trees(TK.MultitaskGaussianLikelihood(5).init_params(
        dtype=torch.float64), JK.MultitaskGaussianLikelihood(5).init_params(),
        rtol=0)
    fixed = torch.as_tensor(rng.uniform(0.01, 0.1, 6)).requires_grad_(True)
    nz = TK.FixedNoiseGaussianLikelihood().noise({"fixed_noise": fixed})
    assert not nz.requires_grad and torch.equal(nz, fixed.detach())


def test_softplus_value_and_derivative():
    x = torch.linspace(-30.0, 30.0, 61, dtype=torch.float64,
                       requires_grad=True)
    y = TK.softplus(x)
    np.testing.assert_allclose(y.detach().numpy(),
                               np.asarray(jax.nn.softplus(
                                   jnp.asarray(x.detach().numpy()))),
                               rtol=1e-15)
    (g,) = torch.autograd.grad(y.sum(), x)
    np.testing.assert_allclose(g.numpy(), torch.sigmoid(x).detach().numpy(),
                               rtol=1e-12)


def _gp_problem(seed, p=13, d=3, r=4, s=5, fixed=False):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((p, d))
    Xs = rng.standard_normal((s, d))
    Y = rng.standard_normal((r, p))
    task = {"mean": _np_tree(rng, JK.ConstantMean(), d, r),
            "kernel": _np_tree(rng, JK.ScaleKernel(JK.MaternKernel(2.5)),
                               d, r)}
    noise = (rng.uniform(0.01, 0.1, (r, p)) if fixed
             else rng.uniform(0.05, 0.2, r))
    return X, Xs, Y, task, noise


@pytest.fixture(params=["cholesky", "explicit-inverse"])
def branch(request, monkeypatch):
    """Both formulations on the CPU: the explicit-inverse branch runs the
    JAX side with its gate forced on (its inverse then comes from the jnp
    formulation) and the port's with the plain version of the kernel."""
    if request.param == "explicit-inverse":
        monkeypatch.setattr(JE, "_use_kernel_path", lambda n, dt: True)
        monkeypatch.setattr(TE, "kernel_takes", lambda dt, dev, n: True)
        monkeypatch.setattr(TC, "chol_inv_logdet_auto",
                            TC.chol_inv_logdet_plain)
    return request.param


@pytest.mark.parametrize("fixed", [False, True])
def test_log_prob_and_posterior_match_jax(branch, fixed):
    X, Xs, Y, task, noise = _gp_problem(1, fixed=fixed)
    mean, kern = JK.ConstantMean(), JK.ScaleKernel(JK.MaternKernel(2.5))
    tmean, tkern = TK.ConstantMean(), TK.ScaleKernel(TK.MaternKernel(2.5))
    Xj, Xsj = jnp.asarray(X), jnp.asarray(Xs)
    lp_j = jax.vmap(lambda q, nz, y: JE.gp_log_prob(mean, kern, q, nz, Xj, y))(
        _j(task), jnp.asarray(noise), jnp.asarray(Y))
    lp_t = TE.gp_log_prob(tmean, tkern, _t(task), torch.as_tensor(noise),
                          torch.as_tensor(X), torch.as_tensor(Y))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=1e-10)

    m_j, v_j = jax.vmap(lambda q, nz, y: JE.gp_posterior(
        mean, kern, q, nz, Xj, y, Xsj))(_j(task), jnp.asarray(noise),
                                         jnp.asarray(Y))
    m_t, v_t = TE.gp_posterior(tmean, tkern, _t(task), torch.as_tensor(noise),
                               torch.as_tensor(X), torch.as_tensor(Y),
                               torch.as_tensor(Xs))
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=1e-10,
                               atol=1e-12)
    sd_j = jax.vmap(lambda q: JE.gp_prior_stddev(mean, kern, q, Xj))(_j(task))
    sd_t = TE.gp_prior_stddev(tmean, tkern, _t(task), torch.as_tensor(X))
    np.testing.assert_allclose(sd_t.numpy(), np.asarray(sd_j), rtol=1e-12)


def test_posterior_prior_variance_goes_through_the_kernel_spec():
    """``kss`` is k(x, x) from the spec, not 1.0: a LinearKernel's prior
    variance is v·|x|² (without noise the posterior at a far point
    approaches it)."""
    X, Xs, Y, _, noise = _gp_problem(2)
    r = Y.shape[0]
    task = {"mean": {}, "kernel": {"raw_variance": np.zeros(r)}}
    m_j, v_j = jax.vmap(lambda q, nz, y: JE.gp_posterior(
        JK.ZeroMean(), JK.LinearKernel(), q, nz, jnp.asarray(X), y,
        jnp.asarray(Xs), include_noise=False))(
        _j(task), jnp.asarray(noise), jnp.asarray(Y))
    m_t, v_t = TE.gp_posterior(TK.ZeroMean(), TK.LinearKernel(), _t(task),
                               torch.as_tensor(noise), torch.as_tensor(X),
                               torch.as_tensor(Y), torch.as_tensor(Xs),
                               include_noise=False)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=1e-10,
                               atol=1e-12)


ORACLE_SPECS = [
    ("zero-matern25", lambda: (JK.ZeroMean(), TK.ZeroMean()),
     lambda: (JK.MaternKernel(2.5), TK.MaternKernel(2.5))),
    ("const-matern05", lambda: (JK.ConstantMean(), TK.ConstantMean()),
     lambda: (JK.MaternKernel(0.5), TK.MaternKernel(0.5))),
    ("const-matern15-ard", lambda: (JK.ConstantMean(), TK.ConstantMean()),
     lambda: (JK.MaternKernel(1.5, 3), TK.MaternKernel(1.5, 3))),
    ("linear-rbf-ard", lambda: (JK.LinearMean(), TK.LinearMean()),
     lambda: (JK.RBFKernel(3), TK.RBFKernel(3))),
    ("const-scale-matern", lambda: (JK.ConstantMean(), TK.ConstantMean()),
     lambda: (JK.ScaleKernel(JK.MaternKernel(2.5)),
              TK.ScaleKernel(TK.MaternKernel(2.5)))),
    ("linearnb-scale-rbf", lambda: (JK.LinearMean(False),
                                    TK.LinearMean(False)),
     lambda: (JK.ScaleKernel(JK.RBFKernel()), TK.ScaleKernel(TK.RBFKernel()))),
]


@pytest.mark.parametrize("likname", ["gauss", "fixed"])
@pytest.mark.parametrize("name,mk_mean,mk_kern", ORACLE_SPECS,
                         ids=[o[0] for o in ORACLE_SPECS])
def test_single_task_oracle_matches_jax_and_autograd(branch, name, mk_mean,
                                                     mk_kern, likname):
    rng = np.random.default_rng(len(name) + len(likname))
    p, d, r = 15, 3, 4
    X, Y = rng.standard_normal((p, d)), rng.standard_normal((r, p))
    (mj, mt), (kj, kt) = mk_mean(), mk_kern()
    if likname == "gauss":
        lj, lt = JK.GaussianLikelihood(), TK.GaussianLikelihood()
        likp = {"raw_noise": 0.3 + 0.1 * rng.standard_normal(r)}
    else:
        lj, lt = (JK.FixedNoiseGaussianLikelihood(),
                  TK.FixedNoiseGaussianLikelihood())
        likp = {"fixed_noise": rng.uniform(0.01, 0.1, (r, p))}
    params = {"mean": _np_tree(rng, mj, d, r), "kernel": _np_tree(rng, kj, d, r),
              "likelihood": likp}
    Xj, Yj = jnp.asarray(X), jnp.asarray(Y)
    l_j, g_j = JE.make_single_task_value_and_grad(mj, kj, lj, Xj, Yj)(
        _j(params))
    Xt, Yt = torch.as_tensor(X), torch.as_tensor(Y)
    vag = TE.make_single_task_value_and_grad(mt, kt, lt, Xt, Yt)
    l_t, g_t = vag(_t(params))
    np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), rtol=1e-10)
    _assert_trees(g_t, g_j, rtol=1e-9, atol=1e-12)

    # against torch.autograd of the port's own loss
    loss_fn = TE.make_single_task_loss(mt, kt, lt, Xt, Yt)
    tp = jax.tree_util.tree_map(lambda x: x.clone().requires_grad_(True),
                                _t(params))
    leaves = jax.tree_util.tree_leaves(tp)
    losses = loss_fn(tp)
    np.testing.assert_allclose(losses.detach().numpy(), l_t.numpy(),
                               rtol=1e-12)
    grads = torch.autograd.grad(losses.sum(), leaves, allow_unused=True)
    for ga, gc in zip(grads, jax.tree_util.tree_leaves(g_t)):
        ga = torch.zeros_like(gc) if ga is None else ga
        np.testing.assert_allclose(gc.numpy(), ga.numpy(), rtol=1e-9,
                                   atol=1e-11)


def test_unsupported_specs_return_none():
    X, Y = torch.zeros((5, 2), dtype=torch.float64), torch.zeros((3, 5))
    assert TE.make_single_task_value_and_grad(
        TK.ConstantMean(), TK.LinearKernel(), TK.GaussianLikelihood(),
        X, Y) is None
    assert TE.make_single_task_value_and_grad(
        TK.ConstantMean(), TK.MaternKernel(2.5),
        TK.MultitaskGaussianLikelihood(3), X, Y) is None
    assert TE.make_multitask_value_and_grad(
        TK.ConstantMean(), TK.LinearKernel(),
        TK.MultitaskGaussianLikelihood(3), X, Y.T) is None


def _multitask_problem(seed, p=13, d=2, r=3):
    rng = np.random.default_rng(seed)
    X, Y = rng.standard_normal((p, d)), rng.standard_normal((p, r))
    params = {"tasks": {"mean": _np_tree(rng, JK.ConstantMean(), d, r),
                        "kernel": _np_tree(rng, JK.MaternKernel(2.5), d, r)},
              "likelihood": {"raw_noise": np.asarray(0.2),
                             "raw_task_noises": 0.2 + 0.1 *
                             rng.standard_normal(r)}}
    return X, Y, params


def test_multitask_oracle_matches_jax_and_autograd(branch):
    X, Y, params = _multitask_problem(11)
    r = Y.shape[1]
    jl = JK.MultitaskGaussianLikelihood(r)
    tl = TK.MultitaskGaussianLikelihood(r)
    Xj, Yj = jnp.asarray(X), jnp.asarray(Y)
    l_j, g_j = JE.make_multitask_value_and_grad(
        JK.ConstantMean(), JK.MaternKernel(2.5), jl, Xj, Yj)(_j(params))
    Xt, Yt = torch.as_tensor(X), torch.as_tensor(Y)
    l_t, g_t = TE.make_multitask_value_and_grad(
        TK.ConstantMean(), TK.MaternKernel(2.5), tl, Xt, Yt)(_t(params))
    np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), rtol=1e-10)
    _assert_trees(g_t, g_j, rtol=1e-9, atol=1e-12)
    loss_j = JE.make_multitask_loss(JK.ConstantMean(), JK.MaternKernel(2.5),
                                    jl, Xj, Yj)(_j(params))
    loss_fn = TE.make_multitask_loss(TK.ConstantMean(), TK.MaternKernel(2.5),
                                     tl, Xt, Yt)
    tp = jax.tree_util.tree_map(lambda x: x.clone().requires_grad_(True),
                                _t(params))
    loss = loss_fn(tp)
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(loss_j),
                               rtol=1e-10)
    grads = torch.autograd.grad(loss.sum(), jax.tree_util.tree_leaves(tp))
    for ga, gc in zip(grads, jax.tree_util.tree_leaves(g_t)):
        np.testing.assert_allclose(gc.numpy(), ga.numpy(), rtol=1e-9,
                                   atol=1e-11)


def _check_train(res_t, res_j):
    np.testing.assert_array_equal(res_t.iterations.numpy(),
                                  np.asarray(res_j.iterations))
    np.testing.assert_allclose(res_t.loss.numpy(), np.asarray(res_j.loss),
                               rtol=1e-10, atol=1e-12)
    _assert_trees(res_t.params, res_j.params, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("oracle", [True, False])
@pytest.mark.parametrize("rel_error,max_iter", [(1e-5, 60), (1e-3, 60),
                                                (1e-5, 7)])
def test_adam_early_stop_matches_jax(oracle, rel_error, max_iter):
    """Equal iteration counts (early stops and the max_iter cap, which
    falls inside a block of 4 substeps at 7) and parameters to 1e-10, with
    the closed-form oracle and with autograd."""
    rng = np.random.default_rng(7)
    p, d, r = 12, 2, 4
    X, Y = rng.standard_normal((p, d)), rng.standard_normal((r, p))
    mj, kj, lj = JK.ConstantMean(), JK.MaternKernel(2.5), \
        JK.GaussianLikelihood()
    mt, kt, lt = TK.ConstantMean(), TK.MaternKernel(2.5), \
        TK.GaussianLikelihood()
    task0 = {"mean": mj.init_params(d), "kernel": kj.init_params(d),
             "likelihood": lj.init_params()}
    p0 = jax.tree_util.tree_map(
        lambda x: np.broadcast_to(np.asarray(x), (r,) + x.shape).copy(), task0)
    Xj, Yj = jnp.asarray(X), jnp.asarray(Y)
    res_j = JE.adam_early_stop(
        JE.make_single_task_loss(mj, kj, lj, Xj, Yj), _j(p0), lr=0.1,
        max_iter=max_iter, rel_error=rel_error,
        value_and_grad=(JE.make_single_task_value_and_grad(mj, kj, lj, Xj, Yj)
                        if oracle else None))
    Xt, Yt = torch.as_tensor(X), torch.as_tensor(Y)
    res_t = TE.adam_early_stop(
        TE.make_single_task_loss(mt, kt, lt, Xt, Yt), _t(p0), lr=0.1,
        max_iter=max_iter, rel_error=rel_error,
        value_and_grad=(TE.make_single_task_value_and_grad(mt, kt, lt, Xt, Yt)
                        if oracle else None))
    assert res_t.iterations.dtype == torch.int32
    _check_train(res_t, res_j)
    if rel_error == 1e-3:
        assert int(res_t.iterations.min()) < max_iter      # some stopped


def test_adam_early_stop_unroll_does_not_change_results():
    X, Y, params = _multitask_problem(3)
    tl = TK.MultitaskGaussianLikelihood(Y.shape[1])
    Xt, Yt = torch.as_tensor(X), torch.as_tensor(Y)
    loss_raw = TE.make_multitask_loss(TK.ConstantMean(), TK.MaternKernel(2.5),
                                      tl, Xt, Yt)

    def loss_fn(pb):
        return loss_raw(TE.tree_map(lambda x: x[0], pb))

    pb = TE.tree_map(lambda x: x[None], _t(params))
    a = TE.adam_early_stop(loss_fn, pb, max_iter=30, rel_error=1e-4, unroll=1)
    b = TE.adam_early_stop(loss_fn, pb, max_iter=30, rel_error=1e-4, unroll=4)
    assert torch.equal(a.iterations, b.iterations)
    for x, y in zip(TE.tree_leaves(a.params), TE.tree_leaves(b.params)):
        assert torch.equal(x, y)


def test_tree_f64_moves_every_leaf_to_the_host():
    """The host engine's cast: floating leaves to float64, integer leaves
    kept, every leaf on the CPU (the JAX ``tree_f64`` leaves non-float
    leaves where they were)."""
    from openmeasure_torch.core.host64 import tree_f64
    out = tree_f64({"a": np.arange(3, dtype=np.int32),
                    "b": {"c": torch.ones(2, dtype=torch.float32)},
                    "d": np.float32(0.5)})
    assert out["a"].dtype == torch.int32 and out["a"].device.type == "cpu"
    assert out["b"]["c"].dtype == torch.float64
    assert out["d"].dtype == torch.float64 and float(out["d"]) == 0.5
