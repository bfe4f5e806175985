"""The fused GP step's CUDA kernel (``openmeasure_torch/csrc/gp_step.cu``)
on the card: against its plain version, under a CUDA graph, and on the
trainer's main path.

Every test here needs a CUDA card and skips without one; this file imports
neither JAX nor the JAX package, so on a machine with a card it runs as::

    python -m pytest tests/test_torch_gp_step_cuda.py --noconftest -q

Tolerances (fp32): the kernel against the plain version from the same
state and the same K⁻¹ and logdet, one step, within ``REL = 1e-5`` of
each quantity's largest magnitude — the kernel's sums run in another
order and with fused multiply-adds, the plain version's in torch's
reductions, both in fp32 over at most p² = 1681 terms of M = ααᵀ − K⁻¹
(cond(K) ≲ 1e2 at these parameters).  The stop flags, counts and step
count are exact.  A CUDA graph's replays equal the same iterations run as
plain launches bit for bit (no float atomics, one order for every sum).
"""

import functools
import itertools

import numpy as np
import pytest
import torch

from openmeasure_torch.gp import exact_gp as E
from openmeasure_torch.gp import gp_step as S
from openmeasure_torch.gp import kernels as K
from openmeasure_torch.linalg import chol_cuda as TCC
from openmeasure_torch.utils import logging as L

REL = 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _kernel(profile, scaled, ard, d):
    nls = dict(ard_num_dims=d) if ard else {}
    base = K.RBFKernel(**nls) if profile == "rbf" else \
        K.MaternKernel(profile, **nls)
    return K.ScaleKernel(base) if scaled else base


COVERED = [pytest.param(prof, scaled, ard, mean,
                        id=f"{prof}-{'scale' if scaled else 'bare'}-"
                           f"{'ard' if ard else 'iso'}-{mean.__name__}")
           for prof, scaled, ard, mean in itertools.product(
               ["rbf", 0.5, 1.5, 2.5], [False, True], [False, True],
               [K.ZeroMean, K.ConstantMean])]


def _oracle(card, profile, scaled, ard, mean_cls, B=14, p=41, d=3, seed=0):
    """The fp32 single-task oracle on the card of B models on p points,
    and raw parameter leaves near gpytorch's initial values."""
    rng = np.random.default_rng(seed)
    X = torch.as_tensor(rng.uniform(-1.5, 1.5, (p, d)), dtype=torch.float32,
                        device=card)
    Y = torch.as_tensor(rng.standard_normal((B, p)), dtype=torch.float32,
                        device=card)
    mean, kern = mean_cls(), _kernel(profile, scaled, ard, d)
    lik = K.GaussianLikelihood()
    like = dict(dtype=torch.float32, device=card)
    p0 = {"mean": mean.init_params(d, **like),
          "kernel": kern.init_params(d, **like),
          "likelihood": lik.init_params(**like)}
    leaves = [x + 0.3 * torch.as_tensor(rng.standard_normal(
        (B,) + tuple(x.shape)), **like) for x in E.tree_leaves(p0)]
    vag = E.make_single_task_value_and_grad(mean, kern, lik, X, Y)
    return vag, leaves, p0


def _close(got, want, what):
    scale = float(torch.max(torch.abs(want)))
    err = float(torch.max(torch.abs(got - want)))
    assert err <= REL * max(scale, 1e-30), (what, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("profile,scaled,ard,mean", COVERED)
def test_kernel_matches_its_plain_version(card, profile, scaled, ard, mean):
    """One build and one step of the kernel against the plain version from
    the same state, the step from the same K⁻¹ and logdet; two models
    start frozen."""
    vag, leaves, _ = _oracle(card, profile, scaled, ard, mean)
    assert vag.fused is not None
    with L.recording() as rec:
        kern = vag.fused([t.clone() for t in leaves], 0.1, 1e-5)
        plain = vag.fused([t.clone() for t in leaves], 0.1, 1e-5)
        S._build_plain(plain)
    torch.cuda.synchronize()
    assert rec.counters == {"gp_step.kernel_launches": 2}
    _close(kern.kj, plain.kj, "first K")
    _close(kern.resid, plain.resid, "first residual")
    for run in (kern, plain):
        run.conv[[2, 9]] = True
    kinv, logdet = TCC.chol_inv_logdet_cuda(kern.kj)
    S.gp_step(kern, kinv, logdet)
    S._step_plain(plain, kinv, logdet)
    torch.cuda.synchronize()
    for name in ("theta", "mu", "nu", "loss", "kj", "resid"):
        _close(getattr(kern, name), getattr(plain, name), name)
    for name in ("conv", "iters", "count"):
        assert torch.equal(getattr(kern, name), getattr(plain, name)), name
    assert torch.equal(kern.theta[[2, 9]], plain.theta[[2, 9]])
    assert kern.iters.tolist() == [0 if b in (2, 9) else 1 for b in range(14)]


@pytest.mark.cuda
def test_kernel_at_p_128_and_many_lengthscales(card):
    """The largest p (64 KB of dynamic shared memory) and LS_MAX ARD
    lengthscales."""
    vag, leaves, _ = _oracle(card, 2.5, True, True, K.ConstantMean, B=3,
                             p=128, d=S.LS_MAX, seed=5)
    kern = vag.fused([t.clone() for t in leaves], 0.1, 1e-5)
    plain = vag.fused([t.clone() for t in leaves], 0.1, 1e-5)
    S._build_plain(plain)
    kinv, logdet = TCC.chol_inv_logdet_cuda(kern.kj)
    S.gp_step(kern, kinv, logdet)
    S._step_plain(plain, kinv, logdet)
    torch.cuda.synchronize()
    for name in ("theta", "mu", "nu", "loss", "kj", "resid"):
        _close(getattr(kern, name), getattr(plain, name), name)


@pytest.mark.cuda
def test_bias_corrections_on_the_card_equal_the_hosts(card):
    """The kernel takes c1, c2 from the card's double ``pow`` (the one
    torch's CUDA ``pow`` calls); rounded to fp32 they are the host's."""
    t = torch.arange(1, 20001, dtype=torch.int32, device=card)
    c1, c2 = S.bias_corrections(t, torch.float32)
    for c, b in ((c1, 0.9), (c2, 0.999)):
        host = torch.tensor([1.0 - b ** k for k in range(1, 20001)],
                            dtype=torch.float64).float()
        assert torch.equal(c.cpu(), host)


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    vag, leaves, _ = _oracle(card, 2.5, False, False, K.ConstantMean, B=2,
                             p=9)
    run = vag.fused([t.clone() for t in leaves], 0.1, 1e-5)
    kinv, logdet = TCC.chol_inv_logdet_cuda(run.kj)
    with pytest.raises(ValueError, match="K⁻¹ and logdet"):
        S.gp_step(run, kinv[:1], logdet[:1])
    with pytest.raises(ValueError, match="float32"):
        S.gp_step(run, kinv.double(), logdet.double())
    with pytest.raises(ValueError, match="float32"):
        S.gp_step(run, kinv.mT, logdet)


def _flame(n_cells=2000, m_train=20):
    from openmeasure_torch.datasets.synthetic import make_flame_dataset
    return make_flame_dataset(n_cells=n_cells, n_features=3 if n_cells < 18362
                              else 9, m_train=m_train, m_test=3,
                              dtype=np.float32)


def _gpr(d, mean=None, max_iter=203, n_features=3, r=6):
    from openmeasure_torch import GPR
    g = GPR(d["X_train"], n_features, d["xyz"], d["P_train"], "SingleTask")
    g.fit(select_modes="number", n_modes=r)
    g.train(mean=mean, max_iter=max_iter)
    torch.cuda.synchronize()
    return g


@pytest.mark.cuda
def test_fused_graph_replays_the_eager_iterations(card, monkeypatch):
    """The trainer's graph replays of the fused step equal, bit for bit,
    the same iterations run as plain launches (each replay's step run
    eagerly), and a second training gives the same bits."""
    d = _flame()
    g_graph = _gpr(d)
    g_again = _gpr(d)
    monkeypatch.setattr(E, "_Replay", lambda block: type("Eager", (), {
        "step": staticmethod(block)})())
    g_eager = _gpr(d)
    for other in (g_eager, g_again):
        for a, b in zip(E.tree_leaves(g_graph.params),
                        E.tree_leaves(other.params)):
            assert torch.equal(a, b)
        assert torch.equal(g_graph._final_loss, other._final_loss)
        assert torch.equal(g_graph._iterations, other._iterations)


@pytest.mark.cuda
def test_train_at_flame2d_gpr_widths_is_two_launches_an_iteration(card):
    """``GPR.train`` at the flame2d_gpr widths (14 modes on 41 points):
    one launch of each kernel an iteration enqueued, plus the first build;
    a traced replay of the trainer's captured block of 4 iterations holds
    2 × 4 kernels of exactly two names."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    d = _flame(n_cells=18362, m_train=41)
    with L.recording() as rec:
        g = _gpr(d, max_iter=1000, n_features=9, r=14)
    steps = sum(s.name == "gp.iter" for s in rec.spans)
    assert steps >= int(g._iterations.max()) > 0
    assert rec.counters["gp.fused_iters"] == steps
    assert rec.counters["chol.kernel_launches"] == steps
    assert rec.counters["gp_step.kernel_launches"] == steps + 1

    vag = E.make_single_task_value_and_grad(
        g.mean, g.kernel, g.likelihood, g.P0, g.Vr.T)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        run = vag.fused(E.tree_leaves(g.params), 0.1, 1e-5)
        run.step()
        graph = E._Replay(functools.partial(E._steps, run.step, 4))
        graph.step()
    torch.cuda.synchronize()
    assert graph.tally == {"chol.kernel_launches": 4,
                           "gp_step.kernel_launches": 4, "gp.fused_iters": 4}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            graph.step()
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and "memcpy" not in e.name.lower()
               and "memset" not in e.name.lower()]
    names = set(kernels)
    assert len(names) == 2 and any("chol" in n for n in names) \
        and any("gp_step" in n for n in names), names
    assert 0 < len(kernels) <= 20 * 2 * 4, len(kernels)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["ConstantMean", "LinearMean", "FixedNoise"])
def test_fused_iters_counts_the_fused_route_only(card, spec):
    """``gp.fused_iters`` is the trainer's iterations on the fused route,
    and 0 for a LinearMean or a FixedNoiseGaussianLikelihood, which keep
    the oracle's step."""
    rng = np.random.default_rng(3)
    X = torch.as_tensor(rng.uniform(-1, 1, (30, 3)), dtype=torch.float32,
                        device=card)
    Y = torch.as_tensor(rng.standard_normal((6, 30)), dtype=torch.float32,
                        device=card)
    mean = K.LinearMean() if spec == "LinearMean" else K.ConstantMean()
    kern = K.MaternKernel(2.5)
    like = dict(dtype=torch.float32, device=card)
    params = {"mean": mean.init_params(3, **like),
              "kernel": kern.init_params(3, **like)}
    if spec == "FixedNoise":
        lik = K.FixedNoiseGaussianLikelihood()
        params["likelihood"] = lik.init_params(torch.full((30,), 1e-2,
                                                          **like))
    else:
        lik = K.GaussianLikelihood()
        params["likelihood"] = lik.init_params(**like)
    params = E.tree_map(lambda x: x.expand((6,) + x.shape).clone(), params)
    vag = E.make_single_task_value_and_grad(mean, kern, lik, X, Y)
    assert (vag.fused is not None) == (spec == "ConstantMean")
    with L.recording() as rec:
        res = E.adam_early_stop(E.make_single_task_loss(mean, kern, lik, X, Y),
                                params, max_iter=60, value_and_grad=vag)
    steps = sum(s.name == "gp.iter" for s in rec.spans)
    assert steps >= int(res.iterations.max()) > 0
    want = steps if spec == "ConstantMean" else 0
    assert rec.counters.get("gp.fused_iters", 0) == want


def _blockwise(vag, leaves, p0, max_iter, rel_error, unroll=4):
    """The training stepped one iteration at a time, eagerly, with
    ``all(converged)`` read before every block of ``unroll``, on the
    trainer's side stream: ``((leaves, losses, iterations), iterations
    enqueued)``."""
    leaves = [t.clone() for t in leaves]
    with E._side_stream(leaves[0]):
        if vag.fused is not None:
            run = vag.fused(leaves, 0.1, rel_error)
        else:
            run = E._OracleRun(functools.partial(
                E._adam_step, functools.partial(E._grads_at, p0, None, vag),
                lr=0.1, rel_error=rel_error), leaves, max_iter)
        j = 0
        while j < max_iter and not bool(torch.all(run.conv)):
            for _ in range(min(unroll, max_iter - j)):
                run.step()
                j += 1
    torch.cuda.synchronize()
    return run.result(), j


@pytest.mark.cuda
@pytest.mark.parametrize("mean", [K.ConstantMean, K.LinearMean],
                         ids=["fused", "oracle"])
@pytest.mark.parametrize("max_iter,rel_error", [(10, 0.0), (60, 2e-3)],
                         ids=["no-stop", "stops"])
def test_pipelined_stop_matches_blockwise_training(card, mean, max_iter,
                                                   rel_error):
    """The trainer's schedule on the card (each block of 4 one replay,
    the next block enqueued before the host reads the last one's stop
    flags) trains the models bit for bit as the same training stepped
    eagerly with the flags read before every block.  It enqueues no
    iteration past ``max_iter`` and one block more than that training
    (or up to ``max_iter``; none more where the copy of the flags read a
    flag that the next block had already turned on), and every stop test
    it reads overlaps a block already enqueued."""
    vag, leaves, p0 = _oracle(card, 2.5, True, False, mean)
    assert (vag.fused is not None) == (mean is K.ConstantMean)
    params0 = E._unflatten_like(p0, leaves)
    with L.recording() as rec:
        res = E.adam_early_stop(None, params0, lr=0.1, max_iter=max_iter,
                                rel_error=rel_error, value_and_grad=vag)
    torch.cuda.synchronize()
    (want, loss, iters), enqueued = _blockwise(vag, leaves, params0,
                                               max_iter, rel_error)
    for a, b in zip(E.tree_leaves(res.params), want):
        assert torch.equal(a, b)
    assert torch.equal(res.loss, loss)
    assert torch.equal(res.iterations, iters)
    slowest = int(iters.max())
    if max_iter == 10:
        assert iters.tolist() == [10] * 14
    else:            # models stop on different iterations, before max_iter
        assert len(set(iters.tolist())) > 1 and slowest + 8 <= max_iter
    steps = sum(s.name == "gp.iter" for s in rec.spans)
    assert steps in (enqueued, min(enqueued + 4, max_iter))
    assert slowest <= enqueued <= steps <= max_iter
    if max_iter == 10:
        assert steps == 10
    blocks = -(-steps // 4)
    reads = blocks - 1 if steps < max_iter else max(blocks - 2, 0)
    assert rec.counters["gp.overlapped_reads"] == \
        rec.counters["host_reads"] == reads
    assert rec.counters["chol.kernel_launches"] == steps
    assert rec.counters.get("gp.fused_iters", 0) == \
        (steps if vag.fused is not None else 0)
