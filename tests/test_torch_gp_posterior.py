"""The GP posterior (``openmeasure_torch/gp/exact_gp.py::gp_posterior``)
in fp32 against float64, on near-singular problems of the GP ROM's shape:
14 modes, 41 training points, 4 test points in (D, H2, φ) scaled to unit
variance, a Matérn-5/2 ARD kernel with lengthscales of 1.3–3.1 and a
noise near its floor of 1e-4, so that cond₂(K) is 1e4–2e5.

The posterior's variance is kss − ‖L⁻¹ksᵀ‖², from a Cholesky factor and a
triangular solve, on every device.  Bound: the largest σ gap over the
largest float64 σ within ``SIGMA_REL`` = 5e-4.  The triangular solve's
round-off grows with √cond₂(K), about p·u·√cond₂(K) ≤ 1.1e-3 here at
worst, and the route reads 1.0e-5–2.2e-4 on 40 such problems on the CPU
(seeds 0–39); the explicit-inverse variance kss − Σ(Ks K⁻¹ ∘ Ks) (the JAX
package's TPU route, which the port took on the card before), planted
here, grows with cond₂(K) and reads 3.3e-4–3.1e-2 on the same problems,
6.9e-3 at worst on the 12 seeds tested.  The planted test shows that the
bound tells the two apart.

CPU, and on the card where there is one (the card's cases are marked
``cuda``); this file imports neither JAX nor the JAX package::

    python -m pytest tests/test_torch_gp_posterior.py --noconftest -q
"""

import pytest
import torch

from openmeasure_torch.gp import exact_gp as E
from openmeasure_torch.gp import kernels as K
from openmeasure_torch.linalg.chol import chol_inv_logdet
from openmeasure_torch.utils import logging as tlog

R, P, Q, D = 14, 41, 4, 3
SIGMA_REL = 5e-4
SEEDS = range(12)
MEAN, KERN, LIK = K.ConstantMean(), K.MaternKernel(2.5), K.GaussianLikelihood()
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


@pytest.fixture
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device(request.param)


def _problem(seed):
    """A seeded (R, P, P) problem in float64 on the CPU: parameters,
    training points, their targets, test points."""
    g = torch.Generator().manual_seed(seed)
    f64 = dict(generator=g, dtype=torch.float64)
    pts = torch.rand(P + Q, D, **f64)
    pts = (pts - pts[:P].mean(0)) / pts[:P].std(0, correction=0)
    X, Xs = pts[:P], pts[P:]
    params = {"mean": {"constant": 0.1 * torch.randn(R, **f64)},
              "kernel": {"raw_lengthscale": 1.0 + 2.0 * torch.rand(R, D,
                                                                    **f64)},
              "likelihood": {"raw_noise": -12.0 + 4.0 * torch.rand(R,
                                                                   **f64)}}
    Y = torch.sin(X @ torch.randn(R, D, **f64).T).T
    return params, X, Y, Xs


def _on(problem, dtype, device):
    params, X, Y, Xs = problem
    params = E.tree_map(lambda t: t.to(device, dtype), params)
    return (params, *(t.to(device, dtype) for t in (X, Y, Xs)))


def _sigma(problem, dtype, device):
    params, X, Y, Xs = _on(problem, dtype, device)
    noise = LIK.noise(params["likelihood"])
    _, var = E.gp_posterior(MEAN, KERN, params, noise, X, Y, Xs)
    return var.double().cpu().sqrt()


def _sigma_explicit_inverse(problem, device):
    """The planted fault: the fp32 variance from the explicit inverse
    (``csrc/chol.cu`` on the card), noise included."""
    params, X, Y, Xs = _on(problem, torch.float32, device)
    noise = LIK.noise(params["likelihood"])
    Kn = E._add_noise(KERN(params["kernel"], X, X), noise)
    Kinv, _ = chol_inv_logdet(Kn + 1e-6 * torch.eye(P, device=device))
    Ks = KERN(params["kernel"], Xs, X)
    kss = E._kernel_diag(KERN, params["kernel"], Xs, 1)
    var = torch.clamp(kss - torch.sum((Ks @ Kinv) * Ks, dim=-1), min=0.0)
    return (var + noise[:, None]).double().cpu().sqrt()


def _gap(s, s64):
    return float((s - s64).abs().max() / s64.abs().max())


@pytest.mark.parametrize("device", DEVICES, indirect=True)
@pytest.mark.parametrize("seed", SEEDS)
def test_sigma_fp32_against_float64(device, seed):
    """fp32 σ within ``SIGMA_REL`` of float64's, every mode and test
    point; on the card no launch of ``csrc/chol.cu``."""
    problem = _problem(seed)
    s64 = _sigma(problem, torch.float64, device)
    with tlog.recording() as rec:
        s32 = _sigma(problem, torch.float32, device)
    assert bool(torch.isfinite(s32).all())
    assert _gap(s32, s64) <= SIGMA_REL, _gap(s32, s64)
    assert rec.counters.get("chol.kernel_launches", 0) == 0
    assert [s.name for s in rec.spans] == ["gp.posterior"]


@pytest.mark.parametrize("device", DEVICES, indirect=True)
def test_planted_explicit_inverse_breaks_the_bound(device):
    """The explicit-inverse variance, on the same problems, exceeds the
    bound on some seed: the bound can fail."""
    gaps = [_gap(_sigma_explicit_inverse(_problem(seed), device),
                 _sigma(_problem(seed), torch.float64, device))
            for seed in SEEDS]
    assert max(gaps) > SIGMA_REL, gaps
