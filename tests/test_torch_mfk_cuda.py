"""The co-kriging θ search on the card: ``csrc/chol.cu`` on the correlation
matrices the search gives it, the fp32 ``mfk_end_to_end`` against float64
on the card, and one kernel launch per NLL evaluation.

Every test here needs a CUDA card and skips without one; this file imports
neither JAX nor the JAX package, so on a machine with a card it runs as::

    python -m pytest tests/test_torch_mfk_cuda.py --noconftest -q

Tolerances: the kernel against ``chol_inv_logdet_plain`` is EQUAL (the
yardstick of ``tests/test_torch_chol_cuda.py``), NaN in the same places —
squared-exponential correlation with the fp32 nugget 1e-5 is numerically
singular at small θ, so some of these matrices do not factor; fp32 means
within 1e-3 of the float64 means' range in NRMSE (the JAX package's fp32
run sits 2.9e-4 from float64 on the CPU and 3.0e-4 on its accelerator,
``BASELINE.md:36,42``; the port's fp32 run 2.9e-4 on the CPU).
"""

import numpy as np
import pytest
import torch

from openmeasure_torch.linalg import chol as chol_mod
from openmeasure_torch.linalg import chol_cuda
from openmeasure_torch.multifi import mfk as M
from openmeasure_torch.pipelines import mfk_end_to_end
from openmeasure_torch.utils import logging as L

FP32_NRMSE = 1e-3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the θ search runs csrc/chol.cu")
    return torch.device("cuda")


def mfk_problem(K=8, n_lf=40, n_hf=15, n_test=25, d=2, seed=3):
    """Configuration A (``bench.py:138-153``)."""
    rng = np.random.default_rng(seed)
    X_lf = rng.random((n_lf, d))
    X_hf = X_lf[::max(1, n_lf // n_hf)][:n_hf]
    X_test = rng.random((n_test, d))

    def hf(X, k):
        return np.sin(3 * X[:, 0] + 0.7 * k) + 0.5 * np.cos(2 * X[:, 1] + k)

    Y_hf = np.stack([hf(X_hf, k) for k in range(K)])
    Y_lf = np.stack([0.6 * hf(X_lf, k) - 0.3 + 0.2 * X_lf[:, 0]
                     for k in range(K)])
    return X_lf, Y_lf, X_hf, Y_hf, X_test


def _captured_batches(monkeypatch, fn):
    """Every (B, n, n) batch the dispatch hands the kernel while ``fn``
    runs, in order."""
    seen = []
    real = chol_mod.chol_inv_logdet_cuda

    def record(K):
        seen.append(K.detach().clone())
        return real(K)

    monkeypatch.setattr(chol_mod, "chol_inv_logdet_cuda", record)
    out = fn()
    monkeypatch.setattr(chol_mod, "chol_inv_logdet_cuda", real)
    return out, seen


@pytest.mark.cuda
def test_kernel_equals_plain_on_the_search_batches(card, monkeypatch):
    args = mfk_problem()
    _, seen = _captured_batches(monkeypatch, lambda: mfk_end_to_end(
        *[a.astype(np.float32) for a in args]))
    shapes = {tuple(K.shape) for K in seen}
    assert (8 * 32, 40, 40) in shapes and (8 * 5, 40, 40) in shapes
    assert (8 * 32, 15, 15) in shapes and (8 * 5, 15, 15) in shapes
    picked = [seen[0]] + [K for K in seen if K.shape[0] == 40][:3] + \
        [K for K in seen if K.shape[-1] == 15][:2]
    for K in picked:
        kk, lk = chol_cuda.chol_inv_logdet_cuda(K)
        kp, lp = chol_mod.chol_inv_logdet_plain(K)
        torch.cuda.synchronize()
        for a, b in ((kk, kp), (lk, lp)):
            assert torch.equal(torch.isnan(a), torch.isnan(b))
            fin = ~torch.isnan(a)
            assert torch.equal(a[fin], b[fin])


@pytest.mark.cuda
def test_fp32_against_float64_on_the_card(card):
    args = mfk_problem()
    r64 = mfk_end_to_end(*args)
    r32 = mfk_end_to_end(*[a.astype(np.float32) for a in args])
    assert r32.mean.dtype == torch.float32 and r32.mean.is_cuda
    m64, m32 = r64.mean, r32.mean.double()
    assert bool(torch.isfinite(r32.mean).all() and torch.isfinite(r32.mse).all())
    nrmse = float(torch.sqrt(torch.mean((m32 - m64) ** 2))
                  / (m64.max() - m64.min()))
    assert nrmse <= FP32_NRMSE, nrmse


@pytest.mark.cuda
def test_one_launch_per_nll_evaluation(card, monkeypatch):
    """Every NLL evaluation of the search (the screening, each Newton
    step's value-gradient-Hessian and its candidate) is one launch of
    ``csrc/chol.cu`` for all its lanes: the counter equals the number of
    explicit-inverse evaluations, and the trace of one evaluation with
    its gradient and Hessian holds one chol kernel."""
    calls = []
    real = M._level_nll_inv

    def counted(*a):
        calls.append(a[0].shape[0])
        return real(*a)

    monkeypatch.setattr(M, "_level_nll_inv", counted)
    with L.recording() as rec:
        res = mfk_end_to_end(*[a.astype(np.float32) for a in mfk_problem()])
    torch.cuda.synchronize()
    assert len(calls) > 2
    assert rec.counters["chol.kernel_launches"] == len(calls)
    assert len(calls) >= 2 * int(res.newton_steps.sum())
    monkeypatch.setattr(M, "_level_nll_inv", real)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    X_lf, Y_lf, *_ = mfk_problem()
    X = torch.as_tensor(X_lf, dtype=torch.float32, device=card)
    Y = torch.as_tensor(Y_lf, dtype=torch.float32, device=card)
    F = torch.ones((8, 40, 1), dtype=torch.float32, device=card)
    lt = torch.full((8, 2), -0.3, dtype=torch.float32, device=card)
    M._value_grad_hess(lt, X, F, Y)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        f, g, H = M._value_grad_hess(lt, X, F, Y)
        torch.cuda.synchronize()
    n_chol = sum(1 for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and "chol_inv_logdet" in e.name)
    assert n_chol == 1
    assert bool(torch.isfinite(f).all() and torch.isfinite(H).all())


@pytest.mark.cuda
def test_newton_step_reads_nothing_back(card):
    """A Newton step — value, gradient and Hessian of every lane, the
    damped solve, the candidate's NLL — makes no synchronizing call: the
    GLS solve inside the NLL differentiates through ``mfk._GLSSolve``,
    whose backward checks nothing on the host (autograd's rule for
    ``torch.linalg.solve_ex`` does when the graph is kept)."""
    import warnings
    X_lf, Y_lf, *_ = mfk_problem()
    X = torch.as_tensor(X_lf, dtype=torch.float32, device=card)
    Y = torch.as_tensor(Y_lf, dtype=torch.float32, device=card)
    F = torch.cat([torch.ones((8, 40, 1), device=card), X[None].expand(8, 40, 2)],
                  dim=2)
    lt = torch.full((8, 2), -0.3, dtype=torch.float32, device=card)
    lam = torch.full((8,), 1e-2, device=card)
    eye = torch.eye(2, device=card)

    def step():
        f, g, H = M._value_grad_hess(lt, X, F, Y)
        with torch.no_grad():
            cand = lt + M._solve(H + lam[:, None, None] * eye, -g)
            return M._level_nll(cand, X, F, Y)

    step()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            f_new = step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = [str(w.message) for w in caught
             if "synchronizing CUDA operation" in str(w.message)]
    assert not syncs, syncs
    assert bool(torch.isfinite(f_new).all())
