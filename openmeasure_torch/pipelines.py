"""End-to-end functional pipelines (port of ``openmeasure_tpu/pipelines.py``,
the SPR and GP-ROM parts).

:func:`spr_end_to_end` is the soft-sensing flow in one call — scale →
Gram-SVD → truncate → QRCP placement → gappy-POD solve → reconstruct — the
flagship path of the package.  It runs eagerly on the tensors' device;
the host waits on the card only in the Gram-SVD's eigensolver, whose
error check reads each ``torch.linalg.eigh``'s ``info`` back (two reads
at the card's ``refine=1``, counted as ``host_reads``): the pivots the
CUDA kernel selects stay on the card and index the panel there.  While
the recorder of :mod:`.utils.logging` is on, a call is one
``fit.spr_end_to_end`` span over its stages.

:func:`gpr_end_to_end` is the GP-ROM flow in one call — scale → POD →
train r per-mode GPs (batched Adam with early stop, the batched SPD
inverse of ``csrc/chol.cu`` in every iteration) → posterior → reconstruct.
Its trainer reads the card once every 4 Adam iterations (the convergence
test).

:func:`mfk_end_to_end` is the latent co-kriging flow in one call — normalize
→ level-0 θ search + GLS fit → level-0 posterior at the HF sites → level-1
(ρ-coupled) θ search + GLS fit → recursive posterior at the test points.
Each NLL evaluation of its θ searches is one batched call of the SPD
inverse, on the card one launch of ``csrc/chol.cu``; each search reads the
card once every ``multifi.mfk.CHECK_EVERY`` Newton steps.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .core import scaling as _scaling
from .core.device import DeviceLike, as_tensor, resolve_device
from .gp import exact_gp as _E
from .gp import kernels as _K
from .linalg import svd as _svd
from .linalg.qrcp_cuda import qrcp_pivots_auto
from .multifi import mfk as _M
from .utils import logging as _log


class SPRResult(NamedTuple):
    X_rec: torch.Tensor        # (n, m_test) reconstructed fields
    pivots: torch.Tensor       # (r,) sensor row indices, int32
    Ar: torch.Tensor           # (m_test, r) gappy-POD coefficients
    nrmse: torch.Tensor        # scalar — reconstruction NRMSE vs X_test
    exp_variance: torch.Tensor  # (r,)


def spr_end_to_end(
    X_train,
    X_test,
    n_features: int,
    r: int,
    scale_type: str = "std",
    refine: Optional[int] = None,
    svd_width: Optional[int] = None,
    device: DeviceLike = None,
) -> SPRResult:
    """POD fit + QRCP sensor placement + gappy-POD OLS reconstruction of
    the test snapshots, sampled at the selected sensors.

    Equivalent class flow: ``SPR.fit(select_modes='number', n_modes=r)``;
    ``optimal_placement()``; ``train(C_qr)``; ``predict(y)``;
    ``reconstruct(ap)``.

    ``X_train`` (n, m) and ``X_test`` (n, m_test) may be numpy arrays or
    tensors; they are moved to ``device`` (``None`` means the card) keeping
    their dtype.  ``svd_width``: optional width (r ≤ w ≤ m) of the SVD
    refine subspace (see :func:`linalg.svd.svd_tall`).
    """
    with _log.span("fit.spr_end_to_end"):
        dev = resolve_device(device)
        X_train = as_tensor(X_train, dev)
        X_test = as_tensor(X_test, dev)
        with _log.span("fit.scale"):
            X0, cnt, scl = _scaling.scale_data(X_train, n_features,
                                               scale_type, 1)
        # normalize=False: the basis normalization U = B·diag(1/‖b_i‖)
        # never materializes — the QRCP kernel row-scales the panel
        # in-kernel and the (r,)-sized factor folds into Theta and the
        # reconstruction.  Porting trap 8: canonicalize=False leaves each
        # mode's sign to the eigensolver; pivots, the Theta solve and X_rec
        # do not depend on it (Ar does, per mode)
        B, S, _ = _svd.svd_tall(X0, refine=refine, canonicalize=False,
                                rank=r, width=svd_width, normalize=False)
        exp_var = _svd.explained_variance(S)[:r]
        dinv = 1.0 / _svd.floored_norms(S[:r], X0.shape[0], X0.dtype)

        # B.T is the (r, n) panel; the kernel reads it through its strides
        with _log.span("fit.place"):
            pivots = qrcp_pivots_auto(B.T, r, row_scale=dinv)
        p = pivots.long()

        with _log.span("fit.solve"):
            Theta = B[p, :] * dinv[None, :]     # (r, r) == Ur[pivots, :]
            y = X_test[p, :]                    # raw readings, (r, m_test)
            y0 = (y - cnt[p, 0][:, None]) / scl[p, 0][:, None]

            # solve_ex: a singular Theta gives NaN, as jnp.linalg.solve
            # does, where torch.linalg.solve raises after a host read
            Ar = torch.linalg.solve_ex(Theta, y0)[0].T     # (m_test, r)
            X_rec0 = B @ (Ar * dinv[None, :]).T
            X_rec = X_rec0 * scl + cnt

            err = X_rec - X_test
            nrmse = torch.sqrt(torch.mean(err * err)) / (
                torch.amax(X_test) - torch.amin(X_test))
        return SPRResult(X_rec, pivots, Ar, nrmse, exp_var)


def pod_fit(
    X_train, n_features: int, r: int, scale_type: str = "std",
    deflate: int = 0, device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor]:
    """Scale + truncated POD.  Returns ``(Ur, Ar, Sigma_r, cnt, scl)``.

    ``deflate=k`` recomputes modes k..r from the leading-block-deflated
    panel (:func:`linalg.svd.svd_tall_deflated`)."""
    dev = resolve_device(device)
    X_train = as_tensor(X_train, dev)
    X0, cnt, scl = _scaling.scale_data(X_train, n_features, scale_type, 1)
    U, S, Vt = _svd.svd_tall_deflated(X0, rank=r, deflate=deflate)
    Ar = (S[:r, None] * Vt[:r]).T
    return U, Ar, S[:r], cnt, scl


class GPRResult(NamedTuple):
    X_rec: torch.Tensor        # (n, n_test) reconstructed fields
    A_pred: torch.Tensor       # (n_test, r)
    A_sigma: torch.Tensor      # (n_test, r)
    nrmse: torch.Tensor        # scalar — reconstruction NRMSE vs X_test
    gp_loss: torch.Tensor      # (r,) final per-mode −MLL
    iterations: torch.Tensor   # (r,) Adam iterations per mode, int32


def gpr_end_to_end(
    X_train,
    P_train,
    P_test,
    X_test,
    n_features: int,
    r: int,
    scale_type: str = "std",
    max_iter: int = 1000,
    rel_error: float = 1e-5,
    lr: float = 0.1,
    device: DeviceLike = None,
) -> GPRResult:
    """Full GP-ROM flow: scale → POD → normalize → scale parameters → train
    r per-mode GPs (ConstantMean, Matérn-2.5, Gaussian likelihood; batched
    Adam with early stop and the closed-form gradient) → posterior at
    ``P_test`` → rescale → reconstruct → NRMSE.

    Equivalent class flow: ``GPR(...).fit(select_modes='number',
    n_modes=r); train(); predict(P_test); reconstruct(A_pred)``.  Inputs may
    be numpy arrays or tensors; they are moved to ``device`` (``None``
    means the card), the snapshots keeping their dtype and the parameters
    taking it.  The result also carries each mode's Adam iteration
    count."""
    dev = resolve_device(device)
    X_train, X_test = as_tensor(X_train, dev), as_tensor(X_test, dev)
    P_train, P_test = (as_tensor(a, dev, dtype=X_train.dtype)
                       for a in (P_train, P_test))
    # deflate=r//2: the GP regresses each coefficient series separately, so
    # the deep-tail modes should be accurate mode by mode (the JAX
    # package's choice, kept for parity)
    Ur, Ar, Sigma_r, cnt, scl = pod_fit(X_train, n_features, r, scale_type,
                                        deflate=r // 2, device=dev)
    Vr = Ar / Sigma_r[None, :]

    P0, P_cnt, P_scl = _scaling.scale_parameters(P_train, scale_type)
    P0_test = (P_test - P_cnt[0][None, :]) / P_scl[0][None, :]

    mean, kernel, lik = _K.ConstantMean(), _K.MaternKernel(2.5), \
        _K.GaussianLikelihood()
    d = P_train.shape[1]
    like = dict(dtype=P0.dtype, device=dev)
    task0 = {"mean": mean.init_params(d, **like),
             "kernel": kernel.init_params(d, **like),
             "likelihood": lik.init_params(**like)}
    params0 = _E.tree_map(lambda x: x.expand((r,) + x.shape), task0)
    loss_fn = _E.make_single_task_loss(mean, kernel, lik, P0, Vr.T)
    vag = _E.make_single_task_value_and_grad(mean, kernel, lik, P0, Vr.T)
    res = _E.adam_early_stop(loss_fn, params0, lr=lr, max_iter=max_iter,
                             rel_error=rel_error, value_and_grad=vag)

    noise = lik.noise(res.params["likelihood"])
    means, variances = _E.gp_posterior(mean, kernel, res.params, noise, P0,
                                       Vr.T, P0_test, include_noise=True)
    V_pred, V_sigma = means.T, torch.sqrt(variances).T

    A_pred = V_pred * Sigma_r[None, :]
    A_sigma = V_sigma * Sigma_r[None, :]
    X_rec = (Ur @ A_pred.T) * scl + cnt
    err = X_rec - X_test
    nrmse = torch.sqrt(torch.mean(err * err)) / (
        torch.amax(X_test) - torch.amin(X_test))
    return GPRResult(X_rec, A_pred, A_sigma, nrmse, res.loss, res.iterations)


class MFKResult(NamedTuple):
    mean: torch.Tensor     # (K, n_test) recursive co-kriging posterior mean
    mse: torch.Tensor      # (K, n_test) posterior MSE
    theta: torch.Tensor    # (2, K, d) fitted correlation parameters per level
    newton_steps: torch.Tensor  # (2,) int32 — the slowest lane's Newton
    #                             steps per level


def mfk_end_to_end(
    X_lf, Y_lf, X_hf, Y_hf, X_test,
    regr: str = "constant", rho_regr: str = "constant",
    device: DeviceLike = None,
) -> MFKResult:
    """Two-level recursive co-kriging for K outputs sharing the same sites:
    normalize → level-0 θ multistart + GLS fit → level-0 posterior at the
    HF sites → level-1 (ρ-coupled) θ multistart + GLS fit → recursive
    posterior at ``X_test`` → denormalize.  The latent-space workload of
    ``CoKriging.fit`` + ``predict``, with the default knobs (θ0 = 0.5,
    bounds [1e-6, 100], initial_range 0.3, tol 1e-6); the same math as
    :class:`..multifi.mfk.BatchedMFK`.

    ``X_lf`` (n_lf, d), ``Y_lf`` (K, n_lf), ``X_hf`` (n_hf, d), ``Y_hf``
    (K, n_hf), ``X_test`` (s, d): numpy arrays or tensors, moved to
    ``device`` (``None`` means the card) in ``X_lf``'s dtype.  The result
    also carries each level's Newton step count (a port extension, as
    ``GPRResult.iterations``)."""
    dev = resolve_device(device)
    X_lf = as_tensor(X_lf, dev)
    X_hf, X_test, Y_lf, Y_hf = (as_tensor(a, dev, dtype=X_lf.dtype)
                                for a in (X_hf, X_test, Y_lf, Y_hf))
    K_out, d = Y_lf.shape[0], X_lf.shape[1]

    # ---- normalization (BatchedMFK normalize=True semantics) ----
    X_all = torch.cat([X_lf, X_hf], dim=0)
    X_mean = torch.mean(X_all, dim=0)
    X_std0 = torch.std(X_all, dim=0, correction=0)
    X_std = torch.where(X_std0 == 0.0, torch.ones_like(X_std0), X_std0)
    Y_all = torch.cat([Y_lf, Y_hf], dim=1)
    y_mean = torch.mean(Y_all, dim=1)
    y_std0 = torch.std(Y_all, dim=1, correction=0)
    y_std = torch.where(y_std0 == 0.0, torch.ones_like(y_std0), y_std0)
    Xn_lf = (X_lf - X_mean) / X_std
    Xn_hf = (X_hf - X_mean) / X_std
    Xn_t = (X_test - X_mean) / X_std
    Yn_lf = (Y_lf - y_mean[:, None]) / y_std[:, None]
    Yn_hf = (Y_hf - y_mean[:, None]) / y_std[:, None]

    # ---- hyperparameter search grid (host constants) ----
    like = dict(dtype=X_lf.dtype, device=dev)
    theta0, thetaL, thetaU = (np.full((d,), v) for v in (0.5, 1e-6, 100.0))
    starts = torch.as_tensor(_M._make_starts(theta0, thetaL, thetaU, 0.3),
                             **like)
    lo = torch.as_tensor(np.log10(thetaL), **like)
    hi = torch.as_tensor(np.log10(thetaU), **like)

    def fit_level(Xl, F_batch, Yl):
        log_t, steps = _M._multistart_opt_batch(starts, Xl, F_batch, Yl, lo,
                                                hi, 1e-6)
        thetas = _M._pow10(log_t)
        beta, gamma, sigma2, L, Ggls = _M._level_fit_terms(thetas, Xl,
                                                           F_batch, Yl)
        return dict(X=Xl, Y=Yl, F=F_batch, theta=thetas, beta=beta,
                    gamma=gamma, sigma2=sigma2, L=L, G=Ggls), steps

    # ---- level 0 (LF) ----
    F0 = _M._regr(regr, Xn_lf)
    lev0, steps0 = fit_level(Xn_lf, F0.expand((K_out,) + F0.shape), Yn_lf)

    # ---- level 1 (HF, rho-coupled) ----
    G1 = _M._regr(rho_regr, Xn_hf)
    m_prev = _M.predict_levels_mean_batch([lev0], (0,), regr, rho_regr, 0,
                                          Xn_hf)
    Fr = _M._regr(regr, Xn_hf)
    F1 = torch.cat([G1[None] * m_prev[:, :, None],
                    Fr.expand((K_out,) + Fr.shape)], dim=2)
    lev1, steps1 = fit_level(Xn_hf, F1, Yn_hf)

    # ---- recursive posterior at X_test ----
    mean_n, var_n = _M.predict_levels_batch([lev0, lev1], (0, G1.shape[1]),
                                            regr, rho_regr, 1, Xn_t)
    mean = mean_n * y_std[:, None] + y_mean[:, None]
    mse = var_n * y_std[:, None] ** 2
    return MFKResult(mean, mse, torch.stack([lev0["theta"], lev1["theta"]]),
                     torch.stack([steps0, steps1]).to(torch.int32))
