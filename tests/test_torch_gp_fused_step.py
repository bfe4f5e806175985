"""The plain version of the fused GP step (``openmeasure_torch/gp/
gp_step.py``) against the trainer's oracle step, float64 on the CPU.

On the card the single-task trainer runs its Adam iteration as two
launches, ``csrc/chol.cu`` and ``csrc/gp_step.cu``; the kernel's plain
version runs the same formulation in torch ops (build → (K⁻¹, logdet) →
loss, the sums over M = ααᵀ − K⁻¹, the gradient, Adam, the stop test →
the next build).  Here it is held, for every spec the route covers, to
the oracle of ``make_single_task_value_and_grad`` stepped by the loop's
``_adam_step``:

* one step, and 20 steps with some models frozen from the start, within
  ``TOL = 1e-12`` of each quantity's largest magnitude: the same
  arithmetic but for the order of the sums and α taken from K⁻¹ instead
  of the Cholesky factor (cond(K) ≲ 1e3 here);
* the bias corrections from the state's step count, equal to the host's
  Python floats rounded to fp32;
* ``adam_early_stop`` through a fused run equal, in iterations and to
  ``TOL`` in parameters and losses, to its oracle step, with
  ``gp.fused_iters`` counting its iterations;
* the route's choice: every covered spec takes it on a CUDA float32 batch
  with p ≤ 128, every other spec, type, device or size keeps the oracle.
"""

import functools
import itertools

import numpy as np
import pytest
import torch

from openmeasure_torch.gp import exact_gp as E
from openmeasure_torch.gp import gp_step as S
from openmeasure_torch.gp import kernels as K
from openmeasure_torch.utils import logging as L

TOL = 1e-12
P, D, R = 12, 3, 5


def _kernel(profile, scaled, ard):
    nls = dict(ard_num_dims=D) if ard else {}
    base = K.RBFKernel(**nls) if profile == "rbf" else \
        K.MaternKernel(profile, **nls)
    return K.ScaleKernel(base) if scaled else base


COVERED = [pytest.param(prof, scaled, ard, mean,
                        id=f"{prof}-{'scale' if scaled else 'bare'}-"
                           f"{'ard' if ard else 'iso'}-{mean.__name__}")
           for prof, scaled, ard, mean in itertools.product(
               ["rbf", 0.5, 1.5, 2.5], [False, True], [False, True],
               [K.ZeroMean, K.ConstantMean])]


def _problem(profile, scaled, ard, mean_cls, seed=0):
    """Specs, inputs, raw parameters near gpytorch's initial values, and
    the oracle, float64 on the CPU."""
    rng = np.random.default_rng(seed)
    X = torch.as_tensor(rng.uniform(-1.0, 1.0, (P, D)))
    Y = torch.as_tensor(rng.standard_normal((R, P)))
    mean, kern, lik = mean_cls(), _kernel(profile, scaled, ard), \
        K.GaussianLikelihood()
    like = dict(dtype=torch.float64)
    p0 = {"mean": mean.init_params(D, **like),
          "kernel": kern.init_params(D, **like),
          "likelihood": lik.init_params(**like)}
    params0 = E.tree_map(
        lambda x: x + 0.3 * torch.as_tensor(
            rng.standard_normal((R,) + tuple(x.shape))), p0)
    vag = E.make_single_task_value_and_grad(mean, kern, lik, X, Y)
    core = E._ClosedFormCore.build(mean, kern, X)
    fused = functools.partial(S.FusedRun, core, Y, E._jitter(X.dtype))
    return dict(X=X, Y=Y, mean=mean, kern=kern, lik=lik, params0=params0,
                vag=vag, fused=fused)


def _oracle_step(pb):
    return functools.partial(
        E._adam_step, functools.partial(E._grads_at, pb["params0"], None,
                                        pb["vag"]),
        lr=0.1, rel_error=1e-5)


def _start(pb, conv=None):
    """The oracle's state and a fused run from the same parameters, the
    models of ``conv`` frozen in both from the start."""
    leaves = E.tree_leaves(pb["params0"])
    run = pb["fused"]([t.clone() for t in leaves], 0.1, 1e-5)
    state = (leaves, [torch.zeros_like(t) for t in leaves],
             [torch.zeros_like(t) for t in leaves],
             torch.full((R,), 1e10, dtype=torch.float64),
             torch.zeros(R, dtype=torch.bool),
             torch.zeros(R, dtype=torch.int32))
    if conv is not None:
        conv = torch.as_tensor(conv)
        run.conv.copy_(conv)
        state = state[:4] + (conv.clone(),) + state[5:]
    return state, run


def _close(got, want, what):
    scale = max(float(torch.max(torch.abs(want))), 1e-300)
    err = float(torch.max(torch.abs(got - want)))
    assert err <= TOL * scale, (what, err, scale)


def _flat(leaves):
    return torch.cat([x.reshape(R, -1) for x in leaves], 1)


def _same(state, run, what=""):
    params, mu, nu, loss, conv, iters = state
    _close(run.theta, _flat(params), f"{what} θ")
    _close(run.mu, _flat(mu), f"{what} μ")
    _close(run.nu, _flat(nu), f"{what} ν")
    _close(run.loss, loss, f"{what} loss")
    assert torch.equal(run.conv, conv), what
    assert torch.equal(run.iters, iters), what


def _built_K(pb, leaves):
    """The oracle's jittered K and residual at ``leaves``."""
    tree = E._unflatten_like(pb["params0"], leaves)
    Kn = E._add_noise(pb["kern"](tree["kernel"], pb["X"], pb["X"]),
                      pb["lik"].noise(tree["likelihood"]))
    eye = torch.eye(P, dtype=torch.float64)
    return Kn + E._jitter(Kn.dtype) * eye, \
        pb["Y"] - pb["mean"](tree["mean"], pb["X"])


@pytest.mark.parametrize("profile,scaled,ard,mean", COVERED)
def test_one_plain_step_matches_the_oracle_step(profile, scaled, ard, mean):
    pb = _problem(profile, scaled, ard, mean)
    state, run = _start(pb)
    Kj, resid = _built_K(pb, state[0])
    _close(run.kj, Kj, "first build K")
    _close(run.resid, resid, "first build residual")
    state = _oracle_step(pb)(state, 1.0 - 0.9, 1.0 - 0.999)
    run.step()
    _same(state, run, "step 1")
    assert torch.equal(run.count, torch.ones(R, dtype=torch.int32))
    Kj, resid = _built_K(pb, state[0])
    _close(run.kj, Kj, "next K")
    _close(run.resid, resid, "next residual")


@pytest.mark.parametrize("profile,scaled,ard,mean", COVERED)
def test_twenty_plain_steps_with_frozen_models(profile, scaled, ard, mean):
    """Models 0 and 3 frozen from the start keep their parameters, loss
    and count while their moments step; the others follow the oracle."""
    pb = _problem(profile, scaled, ard, mean, seed=1)
    frozen = [True, False, False, True, False]
    state, run = _start(pb, conv=frozen)
    theta0 = run.theta.clone()
    step = _oracle_step(pb)
    for t in range(1, 21):
        state = step(state, 1.0 - 0.9 ** t, 1.0 - 0.999 ** t)
        run.step()
        _same(state, run, f"step {t}")
    assert torch.equal(run.theta[[0, 3]], theta0[[0, 3]])
    assert bool((run.mu[[0, 3]] != 0).all())
    assert run.iters[[0, 3]].tolist() == [0, 0]
    assert run.count.tolist() == [20] * R


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bias_corrections_from_the_step_count_equal_the_hosts(dtype):
    """In fp32, the kernel's type, equal to the host's Python floats
    rounded; in float64 within two units in the last place of the power
    (torch's vectorized ``pow`` on the CPU is not the C library's)."""
    t = torch.arange(1, 5001, dtype=torch.int32)
    c1, c2 = S.bias_corrections(t, dtype)
    assert c1.dtype == c2.dtype == dtype
    for c, b in ((c1, 0.9), (c2, 0.999)):
        host = torch.tensor([1.0 - b ** int(k) for k in t],
                            dtype=torch.float64)
        if dtype == torch.float32:
            assert torch.equal(c, host.to(dtype))
        else:
            assert float(torch.max(torch.abs(c - host))) <= 2.0 ** -52


@pytest.mark.parametrize("profile,scaled,ard,mean", [
    COVERED[0], COVERED[13], COVERED[-1]])
def test_trainer_through_a_fused_run_equals_its_oracle_step(
        profile, scaled, ard, mean):
    """``adam_early_stop`` with the oracle's ``fused`` attribute set runs
    the fused state (here its plain version), one ``gp.fused_iters`` an
    iteration; the oracle step gives the same iterations, parameters and
    losses, and counts none."""
    pb = _problem(profile, scaled, ard, mean, seed=2)
    loss_fn = E.make_single_task_loss(pb["mean"], pb["kern"], pb["lik"],
                                      pb["X"], pb["Y"])

    def train(vag):
        with L.recording() as rec:
            res = E.adam_early_stop(loss_fn, pb["params0"], max_iter=40,
                                    rel_error=1e-4, value_and_grad=vag)
        iters = sum(s.name == "gp.iter" for s in rec.spans)
        return res, rec.counters.get("gp.fused_iters", 0), iters

    assert pb["vag"].fused is None          # a CPU batch keeps the oracle
    ref, n_ref, it_ref = train(pb["vag"])
    vag = functools.partial(pb["vag"])
    vag.fused = pb["fused"]
    got, n_got, it_got = train(vag)
    assert n_ref == 0 and n_got == it_got == it_ref > 0
    assert torch.equal(got.iterations, ref.iterations)
    assert int(ref.iterations.min()) < 40   # some models stopped early
    _close(got.loss, ref.loss, "loss")
    for a, b in zip(E.tree_leaves(got.params), E.tree_leaves(ref.params)):
        assert a.shape == b.shape
        _close(a, b, "parameters")


@pytest.mark.parametrize("profile,scaled,ard,mean", COVERED)
def test_route_takes_every_covered_spec_on_cuda_fp32(profile, scaled, ard,
                                                     mean):
    kern = _kernel(profile, scaled, ard)
    assert S.takes(mean(), kern, K.GaussianLikelihood(), torch.float32,
                   "cuda", 41)
    assert S.takes(mean(), kern, K.GaussianLikelihood(), torch.float32,
                   "cuda:1", 128)


@pytest.mark.parametrize("mean,kern,lik,dtype,device,p", [
    pytest.param(K.LinearMean(), K.MaternKernel(2.5), K.GaussianLikelihood(),
                 torch.float32, "cuda", 41, id="LinearMean"),
    pytest.param(K.ConstantMean(), K.MaternKernel(2.5),
                 K.FixedNoiseGaussianLikelihood(), torch.float32, "cuda", 41,
                 id="FixedNoise"),
    pytest.param(K.ConstantMean(), K.MaternKernel(2.5),
                 K.MultitaskGaussianLikelihood(3), torch.float32, "cuda", 41,
                 id="MultitaskLikelihood"),
    pytest.param(K.ConstantMean(), K.LinearKernel(), K.GaussianLikelihood(),
                 torch.float32, "cuda", 41, id="LinearKernel"),
    pytest.param(K.ConstantMean(), K.ScaleKernel(K.ScaleKernel()),
                 K.GaussianLikelihood(), torch.float32, "cuda", 41,
                 id="nested-ScaleKernel"),
    pytest.param(K.ConstantMean(), K.MaternKernel(2.5, ard_num_dims=17),
                 K.GaussianLikelihood(), torch.float32, "cuda", 41,
                 id="ARD-beyond-LS_MAX"),
    pytest.param(K.ConstantMean(), K.MaternKernel(2.5),
                 K.GaussianLikelihood(), torch.float32, "cpu", 41, id="cpu"),
    pytest.param(K.ConstantMean(), K.MaternKernel(2.5),
                 K.GaussianLikelihood(), torch.float64, "cuda", 41,
                 id="float64"),
    pytest.param(K.ConstantMean(), K.MaternKernel(2.5),
                 K.GaussianLikelihood(), torch.float32, "cuda", 129,
                 id="p-beyond-128"),
])
def test_route_keeps_the_oracle_step_elsewhere(mean, kern, lik, dtype,
                                               device, p):
    assert not S.takes(mean, kern, lik, dtype, device, p)


def test_oracles_off_the_route_offer_no_fused_step():
    """The CPU oracles of covered and uncovered specs, and the multitask
    oracle, carry no fused step; the trainer then counts no
    ``gp.fused_iters``."""
    pb = _problem(2.5, False, False, K.ConstantMean)
    X, Y = pb["X"], pb["Y"]
    lin = E.make_single_task_value_and_grad(K.LinearMean(), pb["kern"],
                                            pb["lik"], X, Y)
    fixed = E.make_single_task_value_and_grad(
        K.ConstantMean(), pb["kern"], K.FixedNoiseGaussianLikelihood(), X, Y)
    multi = E.make_multitask_value_and_grad(
        K.ConstantMean(), pb["kern"], K.MultitaskGaussianLikelihood(R), X,
        Y.T)
    for vag in (pb["vag"], lin, fixed):
        assert vag.fused is None
    assert getattr(multi, "fused", None) is None
    with L.recording() as rec:
        E.adam_early_stop(E.make_single_task_loss(
            pb["mean"], pb["kern"], pb["lik"], X, Y), pb["params0"],
            max_iter=8, value_and_grad=pb["vag"])
    assert "gp.fused_iters" not in rec.counters


def test_fused_run_refuses_leaves_of_another_layout():
    pb = _problem(2.5, True, False, K.ConstantMean)
    leaves = E.tree_leaves(pb["params0"])
    with pytest.raises(ValueError, match="leaves of shapes"):
        pb["fused"](leaves[:-1], 0.1, 1e-5)
