"""Recursive multi-fidelity co-kriging (Kennedy–O'Hagan / Le Gratiet): port
of ``openmeasure_tpu/multifi/mfk.py``.

The model behind OpenMDAO's ``MultiFiCoKriging``, with its knob surface:
``regr`` and ``rho_regr`` ('constant'/'linear'), ``theta`` / ``theta0`` /
``thetaL`` / ``thetaU`` (fixed value, initial guess, bounds; a scalar or
per dimension), ``normalize``, and fit-time ``initial_range`` / ``tol``.
Levels l = 0 … L−1, lowest fidelity first:

    y_0(x) = f(x)ᵀ β_0 + Z_0(x)
    y_l(x) = ρ_{l-1}(x) · ŷ_{l-1}(x) + f(x)ᵀ β_l + Z_l(x),  ρ(x) = g(x)ᵀ β_ρ

with Z_l a Gaussian process of squared-exponential correlation
exp(−Σ_k θ_k d_k²).  Per level β solves by GLS, σ² is closed form, and θ
minimizes the concentrated negative log-likelihood n·log σ̂² + log det R by
a multistart damped-Newton search in log10(θ).

Where the JAX package nests ``vmap``s over (output, start) lanes, the lanes
here are one leading batch axis, and each NLL evaluation of the search is
one batched call: on a CUDA fp32 batch its (lanes, n, n) correlation
matrices go to the CUDA kernel ``csrc/chol.cu`` in one launch
(:func:`..linalg.chol.chol_inv_logdet`).  The JAX ``while_loop`` under
``vmap`` becomes one batched loop with a per-lane ``done`` mask applied by
``torch.where``: a lane that is done is frozen bit for bit, so a lane's
result does not depend on the other lanes.  The loop reads one "all done"
flag every :data:`CHECK_EVERY` steps; steps past a lane's stop are masked
no-ops, so the result does not depend on that interval either.

The Hessian of each Newton step is taken reverse over reverse (JAX takes it
forward over reverse, ``jax.jacfwd`` of the gradient): one
``torch.autograd.grad(create_graph=True)`` of the lanes' summed NLL, then
one backward pass per θ dimension of the lanes' summed gradient component.
The lanes are independent, so each pass gives one row of every lane's
Hessian, and the passes reuse the K⁻¹ the kernel saved.

Classes: :class:`MultiFiCoKriging` (one output), :class:`BatchedMFK` (K
outputs on the same sites, the CoKriging workload) and its per-output view
``_BatchedMFKView``.  ``engine='host'`` fits and predicts on the host CPU in
float64 (``core/host64.py``); ``'device'`` on the model's device in the
dtype of the fitted outputs (float32 stays float32, as the JAX package's
ambient dtype is on its accelerator).  Predictions are tensors on the
engine's device.

Documented deviation (the JAX package's): unset θ bounds default to
``thetaL=1e-6, thetaU=100``, a wider box than openmdao's defaults.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.device import DeviceLike, as_tensor, resolve_device, to_numpy
from ..core.host64 import HOST
from ..linalg.chol import chol_inv_logdet, cholesky_nan, kernel_takes

# Newton steps between host reads of "every lane is done"
CHECK_EVERY = 8
_PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)
N_CLOUD = 27


def _regr(kind: str, X: torch.Tensor) -> torch.Tensor:
    ones = torch.ones(X.shape[:-1] + (1,), dtype=X.dtype, device=X.device)
    if kind == "constant":
        return ones
    if kind == "linear":
        return torch.cat([ones, X], dim=-1)
    raise ValueError(f"unknown regression type {kind!r}")


def _fixed_order_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim by pairwise halving with elementwise adds, so
    the order of each output's sum is set by that dim's length alone.  A
    torch reduction on the card splits an output's sum over as many
    threads as the count of outputs leaves free, so its rounding depends on
    how many lanes share the batch."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        y = x[..., :h] + x[..., h:2 * h]
        x = y if x.shape[-1] % 2 == 0 else torch.cat([y, x[..., 2 * h:]],
                                                     dim=-1)
    return x[..., 0]


class _ThetaContraction(torch.autograd.Function):
    """``Σ_k θ_k d_k²`` for θ (..., dim) and the coordinate differences d
    (n1, n2, dim).  The backward, ``gθ_k = Σ_ij G_ij d_ijk²``, sums each
    lane's n1·n2 terms in :func:`_fixed_order_sum`'s order: autograd's own
    sum over the broadcast axes gave a lane's θ gradient, and with it the
    fp32 θ search of a co-kriging split over the ``mode`` axis, other
    rounding for another lane count on the card
    (``profile_torch.py lanes``).  The backward is differentiable torch
    ops, so the Hessian's second pass re-enters the same order."""

    @staticmethod
    def forward(ctx, theta, d):
        ctx.save_for_backward(d)
        return torch.sum(theta[..., None, None, :] * d * d, dim=-1)

    @staticmethod
    def backward(ctx, g):
        (d,) = ctx.saved_tensors
        n1, n2, dim = d.shape
        terms = (g[..., None] * d * d).reshape(g.shape[:-2] + (n1 * n2, dim))
        return _fixed_order_sum(torch.movedim(terms, -1, -2)), None


def _corr(theta: torch.Tensor, X1: torch.Tensor, X2: torch.Tensor
          ) -> torch.Tensor:
    """Squared-exponential correlation exp(−Σ θ_k d_k²): ``theta`` (..., d),
    X1 (n1, d), X2 (n2, d) → (..., n1, n2)."""
    d = X1[:, None, :] - X2[None, :, :]
    return torch.exp(-_ThetaContraction.apply(theta, d))


def _nugget_for(dtype) -> float:
    # fp32 kriging matrices need a larger diagonal nugget than fp64
    return 1e-10 if dtype == torch.float64 else 1e-5


# _pow10 pads its operand to a multiple of this many elements
_POW_BLOCK = 64


def _pow10(log10_theta: torch.Tensor) -> torch.Tensor:
    """``10 ** log10_theta`` in its dtype, computed in float64 on a flat
    copy padded to a multiple of :data:`_POW_BLOCK` elements and rounded
    once.  ``torch.pow`` on the CPU rounds differently in its vector body
    and in its scalar path (a tensor too short for a vector, and the tail
    of a longer one), in fp32 and float64 alike, so a lane's θ, and with it
    the whole search, depended on how many lanes shared the batch: a
    co-kriging split over the ``mode`` axis moved the θ search
    (``tests/test_torch_sharded_update.py``,
    ``tests/test_torch_parallel.py``).  With the padding every element
    takes the vector body."""
    flat = log10_theta.double().reshape(-1)
    pad = flat.new_zeros((-flat.numel()) % _POW_BLOCK)
    theta = (10.0 ** torch.cat([flat, pad]))[:flat.numel()]
    return theta.reshape(log10_theta.shape).to(log10_theta.dtype)


def _corr_matrix(log10_theta: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    n = X.shape[0]
    theta = _pow10(log10_theta)
    eye = torch.eye(n, dtype=X.dtype, device=X.device)
    return _corr(theta, X, X) + _nugget_for(X.dtype) * eye


def _mv(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (A @ v[..., None])[..., 0]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a[..., None, :] @ b[..., :, None])[..., 0, 0]


def _solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.solve``: NaN for a singular system, no host read."""
    return torch.linalg.solve_ex(A, B)[0]


class _GLSSolve(torch.autograd.Function):
    """x = G⁻¹ b by ``torch.linalg.solve_ex`` (``jnp.linalg.solve``'s LU;
    NaN for a singular G), differentiable to any order with a backward
    that reads nothing back: for a cotangent gx, ``gb = G⁻ᵀ gx`` (this
    Function again, so a second backward re-enters it) and ``gG = −gb xᵀ``.
    Autograd's own rule for ``solve_ex`` calls the error-checking
    ``torch.linalg.solve`` when the graph is kept (the Hessian's first
    pass), which on the card reads back to the host once an evaluation."""

    @staticmethod
    def forward(ctx, G, b):
        x = torch.linalg.solve_ex(G, b)[0]
        ctx.save_for_backward(G, x)
        return x

    @staticmethod
    def backward(ctx, gx):
        G, x = ctx.saved_tensors
        gb = _GLSSolve.apply(G.mT, gx)
        return -gb[..., :, None] * x[..., None, :], gb


def _gls_solve(G: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """β = G⁻¹ b for the GLS Gram G = FᵀR⁻¹F (…, p, p), b (…, p), inside
    the θ search (see :class:`_GLSSolve`)."""
    return _GLSSolve.apply(G, b)


def _concentrated(n: int, sigma2: torch.Tensor, logdet: torch.Tensor
                  ) -> torch.Tensor:
    tiny = torch.finfo(sigma2.dtype).tiny
    return n * torch.log(torch.clamp(sigma2, min=tiny)) + logdet


def _level_nll_inv(log10_theta, X, F, y):
    """Concentrated NLL by the explicit inverse (the branch taken on CUDA
    fp32): ``chol_inv_logdet`` gives R⁻¹ and log det R for the whole batch
    in one call.  ``log10_theta`` (B, d), ``F`` (B, n, p), ``y`` (B, n);
    returns (B,)."""
    n = X.shape[0]
    Ri, logdet = chol_inv_logdet(_corr_matrix(log10_theta, X))
    Fi = Ri @ F
    yi = _mv(Ri, y)
    G = F.mT @ Fi
    beta = _gls_solve(G, _mv(F.mT, yi))
    resid = y - _mv(F, beta)
    sigma2 = _dot(resid, _mv(Ri, resid)) / n
    return _concentrated(n, sigma2, logdet)


def _level_nll_chol(log10_theta, X, F, y):
    """Concentrated NLL by the Cholesky factor (the branch taken off the
    card and in float64): :func:`..linalg.chol.cholesky_nan` and
    ``cholesky_solve``, NaN where the factorization fails."""
    n = X.shape[0]
    L = cholesky_nan(_corr_matrix(log10_theta, X))
    Fi = torch.cholesky_solve(F, L)
    yi = torch.cholesky_solve(y[..., None], L)[..., 0]
    G = F.mT @ Fi
    beta = _gls_solve(G, _mv(F.mT, yi))
    resid = y - _mv(F, beta)
    ri = torch.cholesky_solve(resid[..., None], L)[..., 0]
    sigma2 = _dot(resid, ri) / n
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)),
                             dim=-1)
    return _concentrated(n, sigma2, logdet)


def _level_nll(log10_theta, X, F, y):
    """Concentrated negative log-likelihood of one kriging level for a batch
    of lanes — the JAX gate: the explicit-inverse branch where the CUDA
    kernel takes the matrices (CUDA fp32, n ≤ 128), the Cholesky branch
    otherwise."""
    if kernel_takes(X.dtype, X.device, X.shape[0]):
        return _level_nll_inv(log10_theta, X, F, y)
    return _level_nll_chol(log10_theta, X, F, y)


def _level_fit_terms(theta, X, F, y):
    """Quantities kept once θ is chosen, for K outputs: ``(beta (K, p),
    gamma (K, n), sigma2 (K,), L (K, n, n), FtRiF (K, p, p))``."""
    n = X.shape[0]
    eye = torch.eye(n, dtype=X.dtype, device=X.device)
    L = cholesky_nan(_corr(theta, X, X) + _nugget_for(X.dtype) * eye)
    Fi = torch.cholesky_solve(F, L)
    yi = torch.cholesky_solve(y[..., None], L)[..., 0]
    G = F.mT @ Fi
    beta = _solve(G, _mv(F.mT, yi))
    resid = y - _mv(F, beta)
    gamma = torch.cholesky_solve(resid[..., None], L)[..., 0]
    sigma2 = _dot(resid, gamma) / n
    return beta, gamma, sigma2, L, G


def _make_starts(theta0, thetaL, thetaU, initial_range) -> np.ndarray:
    """5 log10-θ starting points (S, d), float64: θ0, two local
    (±initial_range around θ0 — the openmdao knob), two global (uniform in
    the bounds).  The JAX package's numpy RNG draws, unchanged."""
    llo, lhi = np.log10(thetaL), np.log10(thetaU)
    rng = np.random.default_rng(0)
    s0 = np.clip(np.log10(theta0), llo, lhi)
    starts = [s0]
    for _ in range(2):
        starts.append(np.clip(
            s0 + initial_range * (2 * rng.random(len(theta0)) - 1),
            llo, lhi))
    for _ in range(2):
        starts.append(llo + (lhi - llo) * rng.random(len(theta0)))
    return np.stack(starts)


def _halton_unit(d_theta: int, n_cloud: int = N_CLOUD) -> Optional[np.ndarray]:
    """The deterministic Halton set (n_cloud, d) in [0, 1) the start
    screening scales to the bounds; None beyond the prepared bases."""
    if d_theta > len(_PRIMES):
        return None
    u = np.zeros((n_cloud, d_theta))
    for j in range(d_theta):
        b = _PRIMES[j]
        k_cur = np.arange(1, n_cloud + 1)
        x = np.zeros(n_cloud)
        denom = b
        while k_cur.max() > 0:
            x += (k_cur % b) / denom
            k_cur //= b
            denom *= b
        u[:, j] = x
    return u


def _value_grad_hess(lt, X, F, y):
    """NLL, gradient and Hessian of every lane at ``lt`` (B, d): one
    forward evaluation, its gradient with the graph kept, then one
    backward pass per θ dimension (reverse over reverse)."""
    d = lt.shape[-1]
    with torch.enable_grad():
        x = lt.detach().requires_grad_(True)
        f = _level_nll(x, X, F, y)
        (g,) = torch.autograd.grad(f.sum(), x, create_graph=True)
        rows = [torch.autograd.grad(g[:, i].sum(), x, retain_graph=i < d - 1)[0]
                for i in range(d)]
    return f.detach(), g.detach(), torch.stack(rows, dim=1)


def _newton_lanes(lt0, X, F, y, lo, hi, tol, n_steps, check_every):
    """The damped-Newton (Levenberg-style) search of every lane: ``lt0``
    (B, d) starts, ``F`` (B, n, p), ``y`` (B, n).  Returns ``(best_lt (B,
    d), best_f (B,), steps (B,))``, ``steps`` each lane's step count.

    A rejected step raises the damping λ ×4 and stays put, an accepted one
    halves it; a NaN candidate compares false and is rejected.  A lane is
    done when an accepted step changes its NLL by less than ``tol`` or λ
    exceeds 1e8; done lanes reject every candidate, so their whole state
    (``best_lt``/``best_f`` included) is frozen."""
    B, d = lt0.shape
    eye = torch.eye(d, dtype=lt0.dtype, device=lt0.device)
    with torch.no_grad():
        f0 = _level_nll(lt0, X, F, y)
    lt, best_lt, best_f = lt0, lt0, f0
    lam = torch.full((B,), 1e-2, dtype=lt0.dtype, device=lt0.device)
    done = torch.zeros(B, dtype=torch.bool, device=lt0.device)
    steps = torch.zeros(B, dtype=torch.int32, device=lt0.device)
    j = 0
    while j < n_steps:
        for _ in range(check_every):
            if j >= n_steps:
                break
            fv, g, H = _value_grad_hess(lt, X, F, y)
            with torch.no_grad():
                step = _solve(H + lam[:, None, None] * eye, -g)
                cand = torch.clamp(lt + step, lo, hi)
                f_new = _level_nll(cand, X, F, y)
            ok = (f_new < fv) & ~done
            lt = torch.where(ok[:, None], cand, lt)
            lam = torch.where(done, lam, torch.where(
                ok, torch.clamp(lam * 0.5, min=1e-8), lam * 4.0))
            improved = ok & (f_new < best_f)
            best_lt = torch.where(improved[:, None], cand, best_lt)
            best_f = torch.where(improved, f_new, best_f)
            steps = steps + (~done).to(torch.int32)
            done = done | (ok & (torch.abs(f_new - fv) < tol)) | (lam > 1e8)
            j += 1
        if bool(torch.all(done)):
            break
    return best_lt, best_f, steps


def _multistart_opt_batch(starts, X, F_batch, Y, lo, hi, tol: float = 1e-6,
                          n_steps: int = 100,
                          check_every: int = CHECK_EVERY):
    """θ optimization for K independent outputs sharing X: the damped-Newton
    search over all (output, start) lanes at once.  ``starts`` (S, d) log10
    θ, ``F_batch`` (K, n, p), ``Y`` (K, n), ``lo``/``hi`` (d,) log10
    bounds.  Returns the best log10 θ per output (K, d) and the Newton
    step count of the slowest lane (a 0-dim int32 tensor).

    Start screening first: ONE batched NLL evaluation over the S starts
    plus a Halton cloud of 27 points scaled to the bounds; NaN NLLs rank
    last, the caller's first start (θ0) is always kept, and Newton launches
    from the best S candidates per output (a stable sort, as
    ``jnp.argsort``).  The result is the start with the lowest converged
    NLL, NaN ranked last, the first on ties."""
    S, d = starts.shape
    K, n, p = F_batch.shape
    u = _halton_unit(d)
    if u is not None:
        cloud = lo[None, :] + (hi - lo)[None, :] * torch.as_tensor(
            u, dtype=starts.dtype, device=starts.device)
        cand = torch.cat([starts, cloud], dim=0)
    else:                       # no Halton bases prepared: screen as-is
        cand = starts
    C = cand.shape[0]
    with torch.no_grad():
        grid = _level_nll(
            cand.expand(K, C, d).reshape(K * C, d), X,
            F_batch[:, None].expand(K, C, n, p).reshape(K * C, n, p),
            Y[:, None].expand(K, C, n).reshape(K * C, n)).reshape(K, C)
    inf = torch.tensor(float("inf"), dtype=grid.dtype, device=grid.device)
    grid = torch.where(torch.isnan(grid), inf, grid)
    grid[:, 0] = -inf
    top = torch.argsort(grid, dim=1, stable=True)[:, :S]          # (K, S)
    starts_k = cand[top]                                         # (K, S, d)

    best_lt, best_f, steps = _newton_lanes(
        starts_k.reshape(K * S, d), X,
        F_batch[:, None].expand(K, S, n, p).reshape(K * S, n, p),
        Y[:, None].expand(K, S, n).reshape(K * S, n), lo, hi, tol, n_steps,
        check_every)
    best_lt, best_f = best_lt.reshape(K, S, d), best_f.reshape(K, S)
    best_f = torch.where(torch.isnan(best_f), inf, best_f)
    idx = torch.argmin(best_f, dim=1)
    return best_lt[torch.arange(K, device=idx.device), idx], torch.amax(steps)


def _multistart_opt(starts, X, F, y, lo, hi, tol: float = 1e-6,
                    n_steps: int = 100):
    """Single-output θ optimization — the K = 1 case of
    :func:`_multistart_opt_batch`."""
    return _multistart_opt_batch(starts, X, F[None], y[None], lo, hi, tol,
                                 n_steps)[0][0]


def predict_levels_batch(levels, rho_cols_seq, regr, rho_regr, l: int,
                         Xs: torch.Tensor):
    """(K, s) recursive co-kriging posterior mean and variance at normalized
    Xs over the stacked per-level state (a list of dicts of tensors, each
    with a leading output axis K).  Shared by :class:`BatchedMFK`,
    ``mfk_end_to_end`` and the CoKriging serving function."""
    lev = levels[l]
    K = lev["Y"].shape[0]
    if l == 0:
        m_prev = torch.zeros((K, Xs.shape[0]), dtype=Xs.dtype,
                             device=Xs.device)
        s2_prev = torch.zeros_like(m_prev)
    else:
        m_prev, s2_prev = predict_levels_batch(levels, rho_cols_seq, regr,
                                               rho_regr, l - 1, Xs)
    Fr = _regr(regr, Xs)
    if l == 0:
        f_tilde = Fr.expand((K,) + Fr.shape)
        rho = None
    else:
        G = _regr(rho_regr, Xs)
        beta_rho = lev["beta"][:, : rho_cols_seq[l]]           # (K, q)
        rho = beta_rho @ G.T                                   # (K, s)
        f_tilde = torch.cat([G[None] * m_prev[:, :, None],
                             Fr.expand((K,) + Fr.shape)], dim=2)

    r = _corr(lev["theta"], Xs, lev["X"])                      # (K, s, n)
    mean = _mv(f_tilde, lev["beta"]) + _mv(r, lev["gamma"])
    Ri_rT = torch.cholesky_solve(r.mT, lev["L"])               # (K, n, s)
    rRr = torch.sum(r.mT * Ri_rT, dim=1)
    u = lev["F"].mT @ Ri_rT - f_tilde.mT                       # (K, p, s)
    Gi_u = _solve(lev["G"], u)
    uGu = torch.sum(u * Gi_u, dim=1)
    var = lev["sigma2"][:, None] * torch.clamp(1.0 - rRr + uGu, min=0.0)
    if l > 0:
        var = var + rho ** 2 * s2_prev
    return mean, var


def predict_levels_mean_batch(levels, rho_cols_seq, regr, rho_regr, l: int,
                              Xs: torch.Tensor) -> torch.Tensor:
    """Mean-only twin of :func:`predict_levels_batch`: fitting level l + 1
    needs only the previous level's posterior mean for its F matrix."""
    lev = levels[l]
    K = lev["Y"].shape[0]
    Fr = _regr(regr, Xs)
    if l == 0:
        f_tilde = Fr.expand((K,) + Fr.shape)
    else:
        m_prev = predict_levels_mean_batch(levels, rho_cols_seq, regr,
                                           rho_regr, l - 1, Xs)
        G = _regr(rho_regr, Xs)
        f_tilde = torch.cat([G[None] * m_prev[:, :, None],
                             Fr.expand((K,) + Fr.shape)], dim=2)
    r = _corr(lev["theta"], Xs, lev["X"])
    return _mv(f_tilde, lev["beta"]) + _mv(r, lev["gamma"])


def _float_dtype(x) -> torch.dtype:
    """float32 for a float32 tensor or array, float64 otherwise."""
    dt = x.dtype if isinstance(x, (torch.Tensor, np.ndarray)) else None
    return torch.float32 if dt in (torch.float32, np.float32) else \
        torch.float64


def _host64(x) -> np.ndarray:
    return to_numpy(x).astype(np.float64)


class MultiFiCoKriging:
    """Recursive multi-fidelity kriging with the openmdao knob surface.
    ``device=None`` means the card."""

    def __init__(self, regr: str = "constant", rho_regr: str = "constant",
                 theta=None, theta0=None, thetaL=None, thetaU=None,
                 normalize: bool = True, engine: str = "device",
                 device: DeviceLike = None):
        self.regr = regr
        self.rho_regr = rho_regr
        self.theta = theta
        self.theta0 = theta0
        self.thetaL = thetaL
        self.thetaU = thetaU
        self.normalize = normalize
        # 'device' (the model's device, the fitted outputs' dtype) or
        # 'host' (the host CPU in float64 — the reference's OpenMDAO
        # numerics; the kriging systems are tiny)
        self.engine = engine
        self.device = resolve_device(device)

    def _engine_place(self, y0=None, record: bool = False):
        """(device, dtype) of the engine: for fit (``record=True``:
        validates and pins the engine the level state is built on, and
        takes the dtype of the first outputs ``y0``) and for predict (the
        fit's — changing ``engine`` between fit and predict must not mix
        devices)."""
        if record:
            if self.engine not in ("device", "host"):
                raise ValueError(
                    f"engine must be 'device' or 'host'; "
                    f"got {self.engine!r}")
            self._fit_engine = self.engine
            self._fit_place = ((HOST, torch.float64) if self.engine == "host"
                               else (self.device, _float_dtype(y0)))
        return self._fit_place

    # ------------------------------------------------------------------ #

    def _broadcast_theta_opt(self, val, default, d):
        if val is None:
            return np.full((d,), default, dtype=float)
        arr = np.asarray(val, dtype=float).reshape(-1)
        if arr.size == 1:
            return np.full((d,), arr[0])
        if arr.size != d:
            raise ValueError("theta option has wrong dimension")
        return arr

    def _optimize_theta(self, X, F, y, theta0, thetaL, thetaU,
                        initial_range, tol):
        """Multistart bounded optimization of the concentrated NLL in
        log10(θ); ``tol`` sets the per-start stop on |Δnll|."""
        like = dict(dtype=X.dtype, device=X.device)
        lo = torch.as_tensor(np.log10(thetaL), **like)
        hi = torch.as_tensor(np.log10(thetaU), **like)
        starts = torch.as_tensor(
            _make_starts(theta0, thetaL, thetaU, initial_range), **like)
        best = _multistart_opt(starts, X, F, y, lo, hi, float(tol))
        return _pow10(best)

    # ------------------------------------------------------------------ #

    def fit(self, X: Sequence, y: Sequence, initial_range: float = 0.3,
            tol: float = 1e-6):
        """X, y: lists ordered lowest fidelity first (the openmdao
        convention).  Runs under the model's ``engine``."""
        place = self._engine_place(y[0], record=True)
        return self._fit_impl(X, y, initial_range, tol, place)

    def _fit_impl(self, X, y, initial_range, tol, place):
        dev, dtype = place
        X = [np.atleast_2d(_host64(Xi)) for Xi in X]
        y = [_host64(yi).reshape(-1) for yi in y]
        self.n_levels = len(X)
        d = X[0].shape[1]

        if self.normalize:
            Xall = np.concatenate(X, axis=0)
            self._X_mean = Xall.mean(axis=0)
            self._X_std = Xall.std(axis=0)
            self._X_std[self._X_std == 0.0] = 1.0
            yall = np.concatenate(y)
            self._y_mean = yall.mean()
            self._y_std = yall.std() or 1.0
        else:
            self._X_mean, self._X_std = np.zeros(d), np.ones(d)
            self._y_mean, self._y_std = 0.0, 1.0
        Xn = [(Xi - self._X_mean) / self._X_std for Xi in X]
        yn = [(yi - self._y_mean) / self._y_std for yi in y]

        theta_fixed = (None if self.theta is None
                       else self._broadcast_theta_opt(self.theta, None, d))
        theta0 = self._broadcast_theta_opt(self.theta0, 0.5, d)
        thetaL = self._broadcast_theta_opt(self.thetaL, 1e-6, d)
        thetaU = self._broadcast_theta_opt(self.thetaU, 100.0, d)

        self.levels = []
        for l in range(self.n_levels):
            Xl = as_tensor(Xn[l], dev, dtype=dtype)
            yl = as_tensor(yn[l], dev, dtype=dtype)
            if l == 0:
                F = _regr(self.regr, Xl)
                rho_cols = 0
            else:
                m_prev, _ = self._predict_level(l - 1, Xl)
                G = _regr(self.rho_regr, Xl)          # (n_l, q)
                F = torch.cat([G * m_prev[:, None], _regr(self.regr, Xl)],
                              dim=1)
                rho_cols = G.shape[1]

            if theta_fixed is not None:
                theta = as_tensor(theta_fixed, dev, dtype=dtype)
            else:
                theta = self._optimize_theta(Xl, F, yl, theta0, thetaL,
                                             thetaU, initial_range, tol)

            beta, gamma, sigma2, L, G_gls = _level_fit_terms(
                theta[None], Xl, F[None], yl[None])
            self.levels.append(dict(
                X=Xl, y=yl, F=F, theta=theta, beta=beta[0], gamma=gamma[0],
                sigma2=sigma2[0], L=L[0], G=G_gls[0], rho_cols=rho_cols))
        return self

    # ------------------------------------------------------------------ #

    def _predict_level(self, l: int, Xs: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Recursive posterior (mean, variance) of level l at normalized Xs:
        the K = 1 case of :func:`predict_levels_batch`."""
        levels = [{k: (v if k in ("rho_cols", "X") else v[None])
                   for k, v in dict(lev, Y=lev["y"]).items()}
                  for lev in self.levels[: l + 1]]
        rho_seq = tuple(lev["rho_cols"] for lev in self.levels[: l + 1])
        mean, var = predict_levels_batch(levels, rho_seq, self.regr,
                                         self.rho_regr, l, Xs)
        return mean[0], var[0]

    def predict(self, X) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (mean, MSE) at X, each (n, 1) — openmdao's two-element
        convention.  Runs under the engine the model was fit with."""
        dev, dtype = self._engine_place()
        X = np.atleast_2d(_host64(X))
        Xn = as_tensor((X - self._X_mean) / self._X_std, dev, dtype=dtype)
        mean, var = self._predict_level(self.n_levels - 1, Xn)
        mean = mean * self._y_std + self._y_mean
        mse = var * self._y_std ** 2
        return mean.reshape(-1, 1), mse.reshape(-1, 1)


class BatchedMFK:
    """K independent recursive co-kriging models sharing the same input
    sites — the CoKriging workload (one model per latent POD dimension).
    Each level's θ search runs all K outputs × starts as one batch, and
    prediction is one batched pass.  Same math and knobs as
    :class:`MultiFiCoKriging`, whose instance holds them (one source)."""

    def __init__(self, regr: str = "constant", rho_regr: str = "constant",
                 theta=None, theta0=None, thetaL=None, thetaU=None,
                 normalize: bool = True, engine: str = "device",
                 device: DeviceLike = None):
        self._proto = MultiFiCoKriging(regr, rho_regr, theta, theta0,
                                       thetaL, thetaU, normalize,
                                       engine=engine, device=device)

    # the proto is the knobs' single source; these views keep the
    # reference's mutable-public-attribute surface
    @property
    def regr(self):
        return self._proto.regr

    @regr.setter
    def regr(self, v):
        self._proto.regr = v

    @property
    def rho_regr(self):
        return self._proto.rho_regr

    @rho_regr.setter
    def rho_regr(self, v):
        self._proto.rho_regr = v

    @property
    def normalize(self):
        return self._proto.normalize

    @normalize.setter
    def normalize(self, v):
        self._proto.normalize = v

    @property
    def engine(self):
        return self._proto.engine

    @engine.setter
    def engine(self, v):
        self._proto.engine = v

    def fit(self, X: Sequence, Y: Sequence, initial_range: float = 0.3,
            tol: float = 1e-6) -> "BatchedMFK":
        """X: level inputs (lowest fidelity first); Y: per-level (K, n_l)
        stacked outputs.  Runs under the model's ``engine``."""
        place = self._proto._engine_place(Y[0], record=True)
        return self._fit_impl(X, Y, initial_range, tol, place)

    def _fit_impl(self, X, Y, initial_range, tol, place):
        dev, dtype = place
        p = self._proto
        # refitting invalidates the views' memoized predictions
        self._predict_cache = None
        X = [np.atleast_2d(_host64(Xi)) for Xi in X]
        Y = [np.atleast_2d(_host64(Yi)) for Yi in Y]
        self.n_levels = len(X)
        K = Y[0].shape[0]
        self.K = K
        d = X[0].shape[1]

        if p.normalize:
            Xall = np.concatenate(X, axis=0)
            self._X_mean = Xall.mean(axis=0)
            self._X_std = Xall.std(axis=0)
            self._X_std[self._X_std == 0.0] = 1.0
            yall = np.concatenate(Y, axis=1)                # (K, n_tot)
            self._y_mean = yall.mean(axis=1)                # (K,)
            self._y_std = yall.std(axis=1)
            self._y_std[self._y_std == 0.0] = 1.0
        else:
            self._X_mean, self._X_std = np.zeros(d), np.ones(d)
            self._y_mean, self._y_std = np.zeros(K), np.ones(K)
        Xn = [as_tensor((Xi - self._X_mean) / self._X_std, dev, dtype=dtype)
              for Xi in X]
        Yn = [as_tensor((Yi - self._y_mean[:, None]) / self._y_std[:, None],
                        dev, dtype=dtype) for Yi in Y]

        theta_fixed = (None if p.theta is None
                       else p._broadcast_theta_opt(p.theta, None, d))
        theta0 = p._broadcast_theta_opt(p.theta0, 0.5, d)
        thetaL = p._broadcast_theta_opt(p.thetaL, 1e-6, d)
        thetaU = p._broadcast_theta_opt(p.thetaU, 100.0, d)
        like = dict(dtype=dtype, device=dev)
        starts = torch.as_tensor(
            _make_starts(theta0, thetaL, thetaU, initial_range), **like)
        lo = torch.as_tensor(np.log10(thetaL), **like)
        hi = torch.as_tensor(np.log10(thetaU), **like)

        self.levels = []
        for l in range(self.n_levels):
            Xl, Yl = Xn[l], Yn[l]
            Fr = _regr(p.regr, Xl)
            if l == 0:
                F_batch = Fr.expand((K,) + Fr.shape)          # shared
                rho_cols = 0
            else:
                rho_seq = tuple(lv["rho_cols"] for lv in self.levels)
                m_prev = predict_levels_mean_batch(
                    self.levels, rho_seq, p.regr, p.rho_regr, l - 1, Xl)
                G = _regr(p.rho_regr, Xl)                    # (n_l, q)
                F_batch = torch.cat([G[None] * m_prev[:, :, None],
                                     Fr.expand((K,) + Fr.shape)], dim=2)
                rho_cols = G.shape[1]

            if theta_fixed is not None:
                thetas = as_tensor(theta_fixed, dev, dtype=dtype).expand(K, d)
            else:
                thetas = _pow10(_multistart_opt_batch(
                    starts, Xl, F_batch, Yl, lo, hi, float(tol))[0])

            beta, gamma, sigma2, L, Ggls = _level_fit_terms(thetas, Xl,
                                                            F_batch, Yl)
            self.levels.append(dict(
                X=Xl, Y=Yl, F=F_batch, theta=thetas, beta=beta, gamma=gamma,
                sigma2=sigma2, L=L, G=Ggls, rho_cols=rho_cols))
        return self

    def _predict_level_batch(self, l: int, Xs: torch.Tensor):
        """(K, s) recursive posterior mean/variance at normalized Xs."""
        rho_cols_seq = tuple(lev["rho_cols"] for lev in self.levels)
        return predict_levels_batch(self.levels, rho_cols_seq,
                                    self._proto.regr, self._proto.rho_regr,
                                    l, Xs)

    def predict(self, X, n_outputs: Optional[int] = None):
        """``(means (K', n), mses (K', n))`` for the first K' = n_outputs
        (default all K) outputs at X: a truncated prediction slices the
        stacked level state first, so only the requested outputs are
        computed.  Runs under the engine the model was fit with."""
        dev, dtype = self._proto._engine_place()
        X = np.atleast_2d(_host64(X))
        view = self if n_outputs is None or n_outputs >= self.K \
            else self._sliced(n_outputs)
        Xn = as_tensor((X - self._X_mean) / self._X_std, dev, dtype=dtype)
        mean, var = view._predict_level_batch(view.n_levels - 1, Xn)
        kk = view.K
        y_std = as_tensor(self._y_std[:kk, None], dev, dtype=dtype)
        y_mean = as_tensor(self._y_mean[:kk, None], dev, dtype=dtype)
        return mean * y_std + y_mean, var * y_std ** 2

    def _sliced(self, k: int) -> "BatchedMFK":
        out = object.__new__(BatchedMFK)
        out.__dict__.update(self.__dict__)
        out.K = k
        out.levels = [
            {key: (v[:k] if key in ("Y", "F", "theta", "beta", "gamma",
                                    "sigma2", "L", "G") else v)
             for key, v in lev.items()}
            for lev in self.levels]
        return out


class _BatchedMFKView:
    """Per-output view with the ``MultiFiCoKriging.predict`` convention —
    keeps ``CoKriging.model_list`` API-compatible.  Iterating all K views
    over the same X runs the batched prediction once (memoized by X)."""

    def __init__(self, batch: BatchedMFK, k: int):
        self._batch = batch
        self._k = k

    def predict(self, X):
        X = np.atleast_2d(_host64(X))
        key = (X.shape, X.tobytes())
        cache = getattr(self._batch, "_predict_cache", None)
        if cache is None or cache[0] != key:
            means, mses = self._batch.predict(X)
            self._batch._predict_cache = (key, means, mses)
        else:
            _, means, mses = cache
        return (means[self._k].reshape(-1, 1),
                mses[self._k].reshape(-1, 1))
