"""Exact GP engine: marginal likelihood, posteriors, the closed-form MLL
gradient oracle and an Adam hyperparameter trainer with per-model early
stopping (port of ``openmeasure_tpu/gp/exact_gp.py``).

Every ``jax.vmap`` over modes of the JAX package is a leading batch axis
here: parameter dicts carry a leading mode axis, and one oracle call
factorizes all r kernel matrices in ONE call of the batched inverse —
on the card one launch of the CUDA kernel (``linalg/chol_cuda.py``), which
is what the JAX package's ``custom_vmap`` rule gives it.  Functions take
and return tensors whose batch dims lead: ``y`` is ``(..., n)``, a noise
is ``(...)`` (one value per model) or ``(..., n)`` (per point), and the
result of a log-prob is ``(...)``.

Which formulation runs is the JAX package's gate, keyed on the tensor: a
CUDA fp32 batch with p ≤ 128 takes the explicit inverse (α = K⁻¹·resid,
logdet from the kernel); a CPU tensor, float64 or p > 128 takes the
Cholesky branch (:func:`..linalg.chol.cholesky_nan` + ``cholesky_solve``),
as JAX does off the TPU; a failed factorization gives NaN there, as it
does in JAX.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional

import torch

from . import kernels as K
from ..linalg.chol import (chol_fits, chol_inv_logdet, cholesky_nan,
                           kernel_path_wanted)

LOG_2PI = math.log(2.0 * math.pi)


# --------------------------------------------------------------------- #
# Parameter dicts (the JAX package's pytrees)
# --------------------------------------------------------------------- #

def tree_map(fn: Callable, tree, *rest):
    """``fn`` on every leaf of a nested dict (and the matching leaves of
    ``rest``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of a nested dict, keys in sorted order at every level
    (as JAX flattens a dict), so two dicts of one structure list their
    leaves alike whatever order their keys were inserted in."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def _unflatten_like(tree, leaves):
    """A dict of ``tree``'s structure holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(tree)


# --------------------------------------------------------------------- #
# Log-prob core
# --------------------------------------------------------------------- #

def _jitter(dtype) -> float:
    # gpytorch cholesky jitter: 1e-8 double, 1e-6 float
    return 1e-8 if dtype == torch.float64 else 1e-6


def _use_kernel_path(n: int, dtype, device) -> bool:
    """The explicit-inverse formulation runs where the CUDA kernel takes
    the matrices; elsewhere the single-right-hand-side Cholesky branch is
    cheaper and better conditioned."""
    return kernel_path_wanted(dtype, device) and chol_fits(1, n)


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _add_noise(Kxx: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """``K + eye * noise``: ``noise`` is one value per matrix (``Kxx.ndim
    - 2`` dims) or one per point (``Kxx.ndim - 1`` dims, FixedNoise)."""
    eye = _eye(Kxx.shape[-1], Kxx)
    noise = torch.as_tensor(noise, dtype=Kxx.dtype, device=Kxx.device)
    if noise.ndim == Kxx.ndim - 1:
        return Kxx + eye * noise[..., None, :]
    return Kxx + eye * noise[..., None, None]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a[..., None, :] @ b[..., :, None])[..., 0, 0]


def _lp_alpha_kinv(Kn: torch.Tensor, resid: torch.Tensor, need_kinv: bool):
    """Jittered Gaussian log-prob core, the single source of the
    explicit-inverse/Cholesky branch pair.  ``Kn`` (..., n, n), ``resid``
    (..., n).  Returns ``(lp (...), alpha (..., n), Kinv)`` with ``Kinv``
    None when ``need_kinv`` is False on the Cholesky branch."""
    n = Kn.shape[-1]
    eye = _eye(n, Kn)
    Kj = Kn + _jitter(Kn.dtype) * eye
    if _use_kernel_path(n, Kn.dtype, Kn.device):
        Kinv, logdet = chol_inv_logdet(Kj)
        alpha = (Kinv @ resid[..., :, None])[..., 0]
        lp = -0.5 * _dot(resid, alpha) - 0.5 * logdet - 0.5 * n * LOG_2PI
        return lp, alpha, Kinv
    L = cholesky_nan(Kj)
    alpha = torch.cholesky_solve(resid[..., :, None], L)[..., 0]
    lp = (-0.5 * _dot(resid, alpha)
          - torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
          - 0.5 * n * LOG_2PI)
    Kinv = torch.cholesky_solve(eye.expand(Kj.shape), L) if need_kinv \
        else None
    return lp, alpha, Kinv


def gp_log_prob(mean_spec, kernel_spec, params: Dict, noise: torch.Tensor,
                X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """log N(y | μ(X), K(X,X) + diag(noise)) for every model of the batch:
    ``y`` (..., n), parameters with the same leading dims."""
    Kxx = kernel_spec(params["kernel"], X, X)
    Kn = _add_noise(Kxx, noise)
    resid = y - mean_spec(params["mean"], X)
    lp, _, _ = _lp_alpha_kinv(Kn, resid, need_kinv=False)
    return lp


def _kernel_diag(kernel_spec, kparams: Dict, X: torch.Tensor,
                 nbatch: int) -> torch.Tensor:
    """Prior variance k(x, x) at each row of X (s, d), through the kernel
    spec on (x, x) pairs — no (s, s) matrix.  Parameters with ``nbatch``
    leading dims; returns ``batch + (s,)``."""
    kp = tree_map(lambda t: t.unsqueeze(nbatch), kparams)
    Xp = X[:, None, :]
    return kernel_spec(kp, Xp, Xp)[..., 0, 0]


def gp_posterior(mean_spec, kernel_spec, params: Dict, noise: torch.Tensor,
                 X: torch.Tensor, y: torch.Tensor, Xs: torch.Tensor,
                 include_noise: bool = True,
                 pred_noise: Optional[torch.Tensor] = None):
    """Posterior predictive mean and variance at Xs, each ``(..., s)``.

    ``include_noise=True`` is the observation-noise-inclusive predictive
    (``likelihood(model(x))``).  ``pred_noise`` overrides the noise added at
    the test points (default: the training noise; a per-point noise vector
    contributes its mean)."""
    n = X.shape[0]
    nbatch = y.ndim - 1
    Kxx = kernel_spec(params["kernel"], X, X)
    Kn = _add_noise(Kxx, noise)
    Ks = kernel_spec(params["kernel"], Xs, X)                  # (..., s, n)
    kss = _kernel_diag(kernel_spec, params["kernel"], Xs, nbatch)
    mu = mean_spec(params["mean"], X)
    mus = mean_spec(params["mean"], Xs)
    if _use_kernel_path(n, Kn.dtype, Kn.device):
        # explicit inverse from the kernel; var via diag(Ks K⁻¹ Ksᵀ),
        # round-off only, guarded at 0
        Kinv, _ = chol_inv_logdet(Kn + _jitter(Kn.dtype) * _eye(n, Kn))
        alpha = (Kinv @ (y - mu)[..., :, None])[..., 0]
        mean_s = mus + (Ks @ alpha[..., :, None])[..., 0]
        W = Ks @ Kinv
        var_s = torch.clamp(kss - torch.sum(W * Ks, dim=-1), min=0.0)
    else:
        L = cholesky_nan(Kn + _jitter(Kn.dtype) * _eye(n, Kn))
        alpha = torch.cholesky_solve((y - mu)[..., :, None], L)[..., 0]
        mean_s = mus + (Ks @ alpha[..., :, None])[..., 0]
        v = torch.linalg.solve_triangular(L, Ks.mT, upper=False)
        var_s = torch.clamp(kss - torch.sum(v * v, dim=-2), min=0.0)
    if include_noise:
        if pred_noise is None:
            # a per-training-point noise vector has no alignment with the
            # test points: default to its mean
            noise = torch.as_tensor(noise, dtype=Kn.dtype, device=Kn.device)
            pred_noise = noise.mean(dim=-1) if noise.ndim == nbatch + 1 \
                else noise
        var_s = var_s + torch.as_tensor(pred_noise, dtype=var_s.dtype,
                                        device=var_s.device)[..., None]
    return mean_s, var_s


def gp_prior_stddev(mean_spec, kernel_spec, params: Dict, X: torch.Tensor,
                    nbatch: int = 1) -> torch.Tensor:
    """Prior stddev at X, ``batch + (p,)`` — what the reference records as
    Vr_sigma (the train-mode ``output.stddev``), evaluated at the trained
    hyperparameters (the JAX package's documented deviation: the reference
    reads it one Adam step earlier).  ``nbatch`` is the number of leading
    batch dims of ``params``."""
    del mean_spec
    kss = _kernel_diag(kernel_spec, params["kernel"], X, nbatch)
    return torch.sqrt(torch.clamp(kss, min=0.0))


# --------------------------------------------------------------------- #
# Trainer
# --------------------------------------------------------------------- #

class TrainResult(NamedTuple):
    params: Dict              # trained (stacked) parameter dict
    loss: torch.Tensor        # final per-model loss
    iterations: torch.Tensor  # per-model iteration count (int32)


def adam_early_stop(loss_fn: Callable, params0: Dict, lr: float = 0.1,
                    max_iter: int = 1000, rel_error: float = 1e-5,
                    verbose: bool = False, unroll: int = 4,
                    value_and_grad: Optional[Callable] = None,
                    stop_axis=None) -> TrainResult:
    """Minimize ``loss_fn(params) -> (B,) losses`` with Adam; per-model
    early stop when |Δloss_b| ≤ rel_error (the reference's stopping rule).
    Converged models are frozen in place while the rest keep stepping.  As
    in the reference's loop, the Adam step of the iteration on which
    convergence is detected IS applied and that iteration IS counted.

    Adam is written out in ``optax.adam(b1=0.9, b2=0.999, eps=1e-8)``'s
    order — μ and ν updates, one global step count, μ̂/(√ν̂ + eps) × −lr —
    so float64 trajectories and iteration counts follow the JAX package's.
    The moments update for every model each substep, frozen ones included,
    as optax's state does there.

    ``unroll`` substeps run between host reads of ``all(converged)``: the
    loop reads the device once every ``unroll`` iterations, as the JAX
    ``while_loop`` tests its condition.  Substeps past convergence are
    masked no-ops, and substeps past ``max_iter`` are skipped (they would
    be no-ops), so results do not depend on ``unroll``.

    ``value_and_grad(params) -> (losses (B,), grads dict)`` replaces
    autograd of ``sum(loss_fn)`` (the closed-form oracles below).
    ``verbose`` is accepted for signature parity.

    ``stop_axis`` (a :class:`..parallel._comm.Axis`) makes the stop test
    collective: each rank trains its own models, and the loop runs until
    the models of every rank have stopped, as one vmapped ``while_loop``
    over all of them does — per-model trajectories and iteration counts
    are those of the unsharded call."""
    del verbose
    b1, b2, eps = 0.9, 0.999, 1e-8
    leaves0 = tree_leaves(params0)
    params = [t.detach().clone() for t in leaves0]
    mu = [torch.zeros_like(t) for t in params]
    nu = [torch.zeros_like(t) for t in params]
    B = params[0].shape[0]
    like = params[0]
    loss_old = torch.full((B,), 1e10, dtype=like.dtype, device=like.device)
    conv = torch.zeros(B, dtype=torch.bool, device=like.device)
    iters = torch.zeros(B, dtype=torch.int32, device=like.device)

    def grads_at(leaves):
        tree = _unflatten_like(params0, leaves)
        if value_and_grad is not None:
            losses, g = value_and_grad(tree)
            return losses.detach(), [t.detach() for t in tree_leaves(g)]
        with torch.enable_grad():
            req = [t.detach().requires_grad_(True) for t in leaves]
            losses = loss_fn(_unflatten_like(params0, req))
            g = torch.autograd.grad(torch.sum(losses), req, allow_unused=True)
        g = [torch.zeros_like(t) if gi is None else gi
             for t, gi in zip(leaves, g)]
        return losses.detach(), g

    def all_stopped() -> bool:
        done = bool(torch.all(conv))
        return done if stop_axis is None else stop_axis.all(done)

    count, j = 0, 0
    while j < max_iter and not all_stopped():
        for _ in range(unroll):
            if j >= max_iter:
                break
            losses, grads = grads_at(params)
            e = torch.abs(losses - loss_old)
            count += 1
            c1 = 1.0 - b1 ** count
            c2 = 1.0 - b2 ** count
            frozen = conv
            new = []
            for i, (p_, g) in enumerate(zip(params, grads)):
                mu[i] = (1.0 - b1) * g + b1 * mu[i]
                nu[i] = (1.0 - b2) * (g * g) + b2 * nu[i]
                upd = (mu[i] / c1) / (torch.sqrt(nu[i] / c2) + eps)
                p_new = p_ + (-lr) * upd
                mask = frozen.reshape(frozen.shape + (1,) * (p_.ndim - 1))
                new.append(torch.where(mask, p_, p_new))
            params = new
            conv = conv | (e <= rel_error)
            loss_old = torch.where(frozen, loss_old, losses)
            iters = torch.where(frozen, iters, iters + 1)
            j += 1
    return TrainResult(_unflatten_like(params0, params), loss_old, iters)


# --------------------------------------------------------------------- #
# Loss builders and closed-form gradient oracles
# --------------------------------------------------------------------- #

def make_single_task_loss(mean_spec, kernel_spec, likelihood_spec,
                          X: torch.Tensor, Y: torch.Tensor) -> Callable:
    """Batched −MLL for r independent single-task GPs: ``Y`` (r, p), one row
    per mode; parameters stacked with leading axis r.  Each loss is divided
    by p (gpytorch ExactMarginalLogLikelihood normalization)."""
    p = X.shape[0]

    def batched(params):
        noise = likelihood_spec.noise(params["likelihood"])
        lp = gp_log_prob(mean_spec, kernel_spec, params, noise, X, Y)
        return -lp / p

    return batched


def make_single_task_value_and_grad(mean_spec, kernel_spec, likelihood_spec,
                                    X: torch.Tensor, Y: torch.Tensor
                                    ) -> Optional[Callable]:
    """Closed-form (loss, gradient) oracle for the batched single-task
    −MLL: ``params -> (losses (r,), grads dict)``, the contract of autograd
    of ``sum ∘ make_single_task_loss``, from the analytic gradient
    ``∂lp/∂θ = ½ tr((ααᵀ − K⁻¹) ∂K/∂θ)``.  About 30 tensor ops per call
    and one batched inverse; the pairwise squared-distance stack is
    parameter-independent and built once.

    Supported specs (anything else returns ``None`` and the caller uses
    autograd): ``ZeroMean``/``ConstantMean``/``LinearMean`` ×
    ``RBFKernel``/``MaternKernel``/``ScaleKernel(RBF|Matern)`` (ARD or
    scalar lengthscale) × ``GaussianLikelihood``/
    ``FixedNoiseGaussianLikelihood``."""
    core = _ClosedFormCore.build(mean_spec, kernel_spec, X)
    if core is None or not isinstance(
            likelihood_spec, (K.GaussianLikelihood,
                              K.FixedNoiseGaussianLikelihood)):
        return None
    fixed_noise = isinstance(likelihood_spec, K.FixedNoiseGaussianLikelihood)
    p = X.shape[0]

    def batched(params):
        noise = likelihood_spec.noise(params["likelihood"])
        lp, lp_grads, trM = core.lp_and_grads(params, Y, noise)
        coeff = -1.0 / p                                  # loss = −lp/p
        if fixed_noise:
            lgrad = {"fixed_noise": torch.zeros_like(
                params["likelihood"]["fixed_noise"])}
        else:
            # ∂lp/∂noise = ½ tr(M) for scalar noise
            lgrad = {"raw_noise": coeff * 0.5 * trM
                     * torch.sigmoid(params["likelihood"]["raw_noise"])}
        grads = tree_map(lambda g: coeff * g, lp_grads)
        grads["likelihood"] = lgrad
        return -lp / p, grads

    return batched


class _ClosedFormCore:
    """Batched closed-form lp + ∂lp/∂(mean, kernel params) — the engine
    behind the single-task and multitask oracles.

    ``lp_and_grads(params, y, noise)`` (parameters with one leading batch
    axis b, ``y`` (b, p), ``noise`` (b,) or (b, p)) returns ``(lp (b,),
    grads, trM (b,))`` with ``grads = {"mean": ..., "kernel": ...}`` the
    UNNORMALIZED ∂lp/∂θ (callers scale by −1/p or −1/(p·r) and derive the
    noise gradient from ``trM = tr(ααᵀ − K⁻¹)``)."""

    def __init__(self, mean_spec, scaled, nu, D2, X):
        self.mean_spec = mean_spec
        self.scaled = scaled
        self.nu = nu
        self.D2 = D2
        self.X = X
        self.mean_kind = type(mean_spec).__name__
        self.has_bias = getattr(mean_spec, "bias", False)

    @classmethod
    def build(cls, mean_spec, kernel_spec, X):
        if isinstance(kernel_spec, K.ScaleKernel):
            base, scaled = kernel_spec.base, True
        else:
            base, scaled = kernel_spec, False
        if not isinstance(base, (K.RBFKernel, K.MaternKernel)):
            return None
        if not isinstance(mean_spec,
                          (K.ZeroMean, K.ConstantMean, K.LinearMean)):
            return None
        nls = base.ard_num_dims or 1
        diff = X[:, None, :] - X[None, :, :]
        if nls == 1:
            D2 = torch.sum(diff * diff, dim=-1)[None]     # (1, p, p)
        else:
            D2 = torch.movedim(diff * diff, -1, 0)        # (d, p, p)
        nu = getattr(base, "nu", None)                    # None → RBF
        return cls(mean_spec, scaled, nu, D2, X)

    def _g_and_gprime(self, d2):
        """Kernel profile g(d²) and its derivative dg/dd², the ν = 0.5
        derivative guarded to 0 on the diagonal exactly as the autograd
        path's where-guard is."""
        nu = self.nu
        if nu is None:
            g = torch.exp(-0.5 * d2)
            return g, -0.5 * g
        eps = torch.finfo(d2.dtype).eps ** 2
        safe = d2 > eps
        one, zero = torch.ones_like(d2), torch.zeros_like(d2)
        r = torch.sqrt(torch.where(safe, d2, one))
        if nu == 0.5:
            e = torch.exp(-r)
            g = torch.where(safe, e, one)
            gp = torch.where(safe, -e / (2.0 * r), zero)
        elif nu == 1.5:
            c = math.sqrt(3.0) * r
            e = torch.exp(-c)
            g = torch.where(safe, (1.0 + c) * e, one)
            gp = torch.where(safe, -1.5 * e, zero)
        else:
            c = math.sqrt(5.0) * r
            e = torch.exp(-c)
            g = torch.where(safe, (1.0 + c + (5.0 / 3.0) * d2) * e, one)
            gp = torch.where(safe, -(5.0 / 6.0) * (1.0 + c) * e, zero)
        return g, gp

    def lp_and_grads(self, params, y, noise):
        X = self.X
        kp = params["kernel"]
        base_p = kp["base"] if self.scaled else kp
        raw_ls = base_p["raw_lengthscale"]               # (b, nls)
        ls = K.softplus(raw_ls)
        inv_ls2 = 1.0 / (ls * ls)
        d2 = torch.tensordot(inv_ls2, self.D2, dims=([1], [0]))  # (b, p, p)
        g, gp = self._g_and_gprime(d2)
        if self.scaled:
            s = K.softplus(kp["raw_outputscale"])[:, None, None]
            Km = s * g
        else:
            Km = g
        Kn = _add_noise(Km, noise)
        resid = y - self.mean_spec(params["mean"], X)
        # One batched inverse for the whole mode batch: on the card one
        # launch of csrc/chol.cu.  The oracle needs K⁻¹ on either branch
        # (the ∂lp/∂K trace terms below).
        lp, alpha, Kinv = _lp_alpha_kinv(Kn, resid, need_kinv=True)
        M = alpha[:, :, None] * alpha[:, None, :] - Kinv  # ∂lp/∂K = ½M

        sgp = (s * gp) if self.scaled else gp
        t = torch.tensordot(M * sgp, self.D2, dims=([1, 2], [1, 2]))  # (b, nls)
        grad_ls = 0.5 * t * (-2.0 * inv_ls2 / ls) * torch.sigmoid(raw_ls)
        kgrad = {"raw_lengthscale": grad_ls}
        if self.scaled:
            kgrad = {"raw_outputscale":
                     0.5 * torch.sum(M * g, dim=(1, 2))
                     * torch.sigmoid(kp["raw_outputscale"]),
                     "base": kgrad}

        if self.mean_kind == "ZeroMean":
            mgrad = {}
        elif self.mean_kind == "ConstantMean":
            mgrad = {"constant": torch.sum(alpha, dim=-1)}
        else:                                            # LinearMean
            mgrad = {"weights": alpha @ X}
            if self.has_bias:
                mgrad["bias"] = torch.sum(alpha, dim=-1)
        trM = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)
        return lp, {"mean": mgrad, "kernel": kgrad}, trM


def make_multitask_value_and_grad(mean_spec, kernel_spec, likelihood_spec,
                                  X: torch.Tensor, Y: torch.Tensor,
                                  added_loss_fn: Optional[Callable] = None
                                  ) -> Optional[Callable]:
    """Closed-form (loss, gradient) oracle for the multitask −MLL
    (:func:`make_multitask_loss`): per-task ``∂lp/∂θ`` from
    :class:`_ClosedFormCore` over the task axis, plus the shared global +
    per-task noise chain ``noise_t = softplus(raw) + 1e-4 +
    softplus(raw_task_t)``.  Returns ``None`` for unsupported specs or
    when ``added_loss_fn`` is given (the PIGPR path differentiates through
    an arbitrary user callback: autograd only).  ``Y`` is (p, r)."""
    if added_loss_fn is not None:
        return None
    if not isinstance(likelihood_spec, K.MultitaskGaussianLikelihood):
        return None
    core = _ClosedFormCore.build(mean_spec, kernel_spec, X)
    if core is None:
        return None
    p, r = X.shape[0], Y.shape[1]
    Yt = Y.T

    def joint(params):
        noises = likelihood_spec.noise(params["likelihood"])  # (r,)
        lps, lp_grads, trMs = core.lp_and_grads(params["tasks"], Yt, noises)
        coeff = -1.0 / (p * r)
        task_grads = tree_map(lambda g: coeff * g, lp_grads)
        lik = params["likelihood"]
        lgrad = {"raw_noise": coeff * 0.5 * torch.sum(trMs)
                 * torch.sigmoid(lik["raw_noise"]),
                 "raw_task_noises": coeff * 0.5 * trMs
                 * torch.sigmoid(lik["raw_task_noises"])}
        loss = -torch.sum(lps) / (p * r)
        return loss[None], {"tasks": task_grads, "likelihood": lgrad}

    return joint


def make_multitask_loss(mean_spec, kernel_spec,
                        likelihood_spec: K.MultitaskGaussianLikelihood,
                        X: torch.Tensor, Y: torch.Tensor,
                        added_loss_fn: Optional[Callable] = None
                        ) -> Callable:
    """−MLL of a batch-independent multitask GP: per-task mean/kernel
    parameters (stacked), one multitask likelihood (global + task noises);
    the joint log-prob divided by p·r.  Returns a (1,)-shaped loss for the
    shared trainer.

    ``added_loss_fn(params, lp) -> scalar`` is gpytorch's added-loss-term
    hook, added to the log-prob before the normalization — the PIGPR path.
    It also receives the joint log-prob ``lp`` this loss has just computed
    (PIGPR hands it, detached, to its callback as ``loss_ml``), where the
    JAX package's ``added_loss_fn(params)`` recomputes it and XLA merges
    the two evaluations; eagerly that would be one more inverse a step."""
    p, r = X.shape[0], Y.shape[1]
    Yt = Y.T

    def batched(params):
        noises = likelihood_spec.noise(params["likelihood"])   # (r,)
        lp = torch.sum(gp_log_prob(mean_spec, kernel_spec, params["tasks"],
                                   noises, X, Yt))
        if added_loss_fn is not None:
            lp = lp + added_loss_fn(params, lp)
        return (-lp / (p * r))[None]

    return batched
