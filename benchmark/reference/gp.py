"""Plain GP ROM: POD of the scaled snapshots, one exact GP per POD
coefficient (a constant mean, a Matérn-5/2 kernel with one lengthscale, a
Gaussian likelihood whose noise is softplus(raw) + 1e-4: GPyTorch's
defaults as OpenMEASURE's ``GPR`` builds them), trained by Adam on the
marginal log-likelihood divided by the number of points, each model
stopping once its loss moves by at most ``rel_error``; the posterior mean
and standard deviation (observation noise included) at the test points;
the fields rebuilt from them.

Adam is ``b1 = 0.9, b2 = 0.999, eps = 1e-8`` with bias correction, every
model stepping together on one step count; a model that has stopped
keeps its parameters (the step on which it stops is applied and counted).
The jitter added to each kernel matrix is GPyTorch's for the precision the
configuration trains in (1e-6 for float32, 1e-8 for float64), whatever
the arithmetic: it is part of the model.  Gradients come from autograd;
the matrix products go through ``mm`` (see :mod:`.precision`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as Fn

from . import spr as S

NOISE_LOWER = 1e-4


def _softplus(x):
    return Fn.softplus(x)


def _matern52(P1, P2, ls):
    """(r, n1, n2) Matérn-5/2 correlations at lengthscales ``ls`` (r,)."""
    d = P1[None, :, None, :] / ls[:, None, None, None] \
        - P2[None, None, :, :] / ls[:, None, None, None]
    d2 = (d * d).sum(-1)
    safe = d2 > torch.finfo(d2.dtype).eps ** 2
    rr = torch.sqrt(torch.where(safe, d2, torch.ones_like(d2)))
    c = math.sqrt(5.0) * rr
    k = (1.0 + c + (5.0 / 3.0) * d2) * torch.exp(-c)
    return torch.where(safe, k, torch.ones_like(k))


def jitter(dtype: torch.dtype) -> float:
    """GPyTorch's Cholesky jitter for ``dtype``."""
    return 1e-8 if dtype == torch.float64 else 1e-6


def neg_mll(params, P0, Y, jit):
    """(r,) −log N(Y | c, K + σ²I) / p, one model per row of ``Y``."""
    const, raw_ls, raw_noise = params
    p = P0.shape[0]
    K = _matern52(P0, P0, _softplus(raw_ls))
    eye = torch.eye(p, dtype=P0.dtype, device=P0.device)
    noise = _softplus(raw_noise) + NOISE_LOWER
    Kn = K + (noise[:, None, None] + jit) * eye
    L = torch.linalg.cholesky(Kn)
    resid = Y - const[:, None]
    alpha = torch.cholesky_solve(resid[..., None], L)[..., 0]
    logdet = 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    lp = -0.5 * (resid * alpha).sum(-1) - 0.5 * logdet \
        - 0.5 * p * math.log(2.0 * math.pi)
    return -lp / p


def train(P0, Y, max_iter: int, rel_error: float, lr: float, jit: float):
    """Adam with per-model early stop.  Returns ``(params, losses,
    iterations)``."""
    r = Y.shape[0]
    like = dict(dtype=Y.dtype, device=Y.device)
    params = [torch.zeros(r, **like) for _ in range(3)]
    mu = [torch.zeros_like(t) for t in params]
    nu = [torch.zeros_like(t) for t in params]
    loss_old = torch.full((r,), 1e10, **like)
    conv = torch.zeros(r, dtype=torch.bool, device=Y.device)
    iters = torch.zeros(r, dtype=torch.int64, device=Y.device)
    b1, b2, eps = 0.9, 0.999, 1e-8
    for step in range(1, max_iter + 1):
        req = [t.detach().requires_grad_(True) for t in params]
        losses = neg_mll(req, P0, Y, jit)
        grads = torch.autograd.grad(losses.sum(), req)
        losses = losses.detach()
        frozen = conv
        new = []
        for i, (t, g) in enumerate(zip(params, grads)):
            mu[i] = (1.0 - b1) * g + b1 * mu[i]
            nu[i] = (1.0 - b2) * g * g + b2 * nu[i]
            upd = (mu[i] / (1.0 - b1 ** step)) / (
                torch.sqrt(nu[i] / (1.0 - b2 ** step)) + eps)
            new.append(torch.where(frozen, t, t - lr * upd))
        params = new
        conv = conv | (torch.abs(losses - loss_old) <= rel_error)
        loss_old = torch.where(frozen, loss_old, losses)
        iters = torch.where(frozen, iters, iters + 1)
        if bool(conv.all()):
            break
    return params, loss_old, iters


def posterior(params, P0, Y, Pt, jit: float, mm=torch.matmul):
    """Posterior mean and variance (noise included) at ``Pt``, (r, q)."""
    const, raw_ls, raw_noise = params
    p = P0.shape[0]
    ls = _softplus(raw_ls)
    noise = _softplus(raw_noise) + NOISE_LOWER
    eye = torch.eye(p, dtype=P0.dtype, device=P0.device)
    Kn = _matern52(P0, P0, ls) + (noise[:, None, None] + jit) * eye
    L = torch.linalg.cholesky(Kn)
    Ks = _matern52(Pt, P0, ls)                                # (r, q, p)
    alpha = torch.cholesky_solve((Y - const[:, None])[..., None], L)
    mean = const[:, None] + mm(Ks, alpha)[..., 0]
    v = torch.linalg.solve_triangular(L, Ks.mT, upper=False)
    var = torch.clamp(1.0 - (v * v).sum(-2), min=0.0) + noise[:, None]
    return mean, var


def gp_rom(X_train, P_train, P_test, n_features: int, r: int,
           max_iter: int, rel_error: float, lr: float, jit: float,
           mm=torch.matmul):
    """The whole flow with the jitter ``jit``: returns ``(X_rec (n, q),
    A_pred (q, r), A_sigma (q, r), losses (r,), iterations (r,))``."""
    cnt, scl = S.scale(X_train, n_features)
    X0 = (X_train - cnt[:, None]) / scl[:, None]
    U, Sv, V = S.pod(X0, r, mm)
    Sr = Sv[:r]
    P_cnt = P_train.mean(dim=0)
    P_scl = P_train.std(dim=0, correction=0)
    P0 = (P_train - P_cnt) / P_scl
    Pt = (P_test - P_cnt) / P_scl
    Y = V.T                                         # (r, p): Vr per mode
    params, losses, iters = train(P0, Y, max_iter, rel_error, lr, jit)
    with torch.no_grad():
        mean, var = posterior(params, P0, Y, Pt, jit, mm)
    A_pred = mean.T * Sr
    A_sigma = torch.sqrt(var).T * Sr
    X_rec = mm(U, A_pred.T) * scl[:, None] + cnt[:, None]
    return X_rec, A_pred, A_sigma, losses, iters
