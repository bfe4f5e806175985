"""Plain soft sensing: feature-block scaling, POD by the Gram matrix's
eigenvectors, greedy column-pivoted QR placement, the gappy-POD solve and
the fixed-budget ADMM of constrained serving.

Each function takes tensors in the arithmetic's dtype (see
:mod:`.precision`) and computes in it; its matrix products go through
``mm`` (the arithmetic's, plain ``@`` by default).  The formulas are
OpenMEASURE's (``SPR.fit``, ``optimal_placement('qr')``, ``train``, ``predict``,
``reconstruct``); the ADMM is the over-relaxed ADMM with residual
balancing of Boyd et al. (2011, §3.4.1) that OpenMEASURE's constrained
predict runs, written out here with the serving budget: no stop test, a
fixed number of iterations.
"""

from __future__ import annotations

import torch


def scale(X: torch.Tensor, n_features: int):
    """Row means and the population standard deviation of each feature
    block: ``(cnt (n,), scl (n,))``."""
    n, m = X.shape
    pts = n // n_features
    cnt = X.mean(dim=1)
    std = X.reshape(n_features, pts * m).std(dim=1, correction=0)
    return cnt, std.repeat_interleave(pts)


def pod(X0: torch.Tensor, r: int, mm=torch.matmul):
    """Leading ``r`` left singular vectors and all singular values of
    ``X0`` (n, m) from the eigenpairs of its Gram matrix:
    ``(U (n, r), S (m,), V (m, r))``."""
    lam, W = torch.linalg.eigh(mm(X0.T, X0))
    lam, W = lam.flip(0), W.flip(1)
    S = torch.sqrt(torch.clamp(lam, min=0.0))
    V = W[:, :r]
    return mm(X0, V) / S[:r], S, V


def explained_variance(S: torch.Tensor) -> torch.Tensor:
    """Cumulative explained variance in percent."""
    L = S * S
    return 100.0 * torch.cumsum(L, dim=0) / L.sum()


def qr_pivots(U: torch.Tensor, k: int, mm=torch.matmul) -> torch.Tensor:
    """The first ``k`` greedy column pivots of ``Uᵀ`` (the rows of U):
    at each step the row with the largest residual norm, whose direction
    (orthogonalized twice) is then removed from every other row."""
    A = U.T                                        # (r, n)
    norms = (A * A).sum(dim=0)
    Q = A.new_zeros((A.shape[0], 0))
    piv = []
    for _ in range(k):
        j = int(torch.argmax(norms))
        piv.append(j)
        v = A[:, j:j + 1]
        for _ in range(2):
            v = v - mm(Q, mm(Q.T, v))
        q = v / torch.linalg.vector_norm(v)
        norms = norms - mm(q.T, A)[0] ** 2
        norms[j] = -float("inf")
        Q = torch.cat([Q, q], dim=1)
    return torch.tensor(piv, dtype=torch.int64, device=U.device)


def pivot_slack(U: torch.Tensor, piv: torch.Tensor) -> float:
    """How far the given pivots fall short of greedy on ``U``'s rows: at
    each step, 1 − (the pivot's residual norm over the largest residual
    norm), the rows projected off the pivots before it; the worst step."""
    A = U.T
    norms = (A * A).sum(dim=0)
    Q = A.new_zeros((A.shape[0], 0))
    worst = 0.0
    for j in piv.tolist():
        worst = max(worst, 1.0 - float(torch.sqrt(norms[j]
                                                  / norms.max())))
        v = A[:, j:j + 1]
        for _ in range(2):
            v = v - Q @ (Q.T @ v)
        q = v / torch.linalg.vector_norm(v)
        norms = torch.clamp(norms - (q.T @ A)[0] ** 2, min=0.0)
        norms[j] = 0.0
        Q = torch.cat([Q, q], dim=1)
    return worst


def reconstruct_from_sensors(U, cnt, scl, piv, Y, mm=torch.matmul):
    """Gappy POD with as many sensors as modes: the coefficients that
    interpolate the scaled readings ``Y`` (s, m) at ``piv``, the fields
    rebuilt and unscaled, (n, m)."""
    y0 = (Y - cnt[piv, None]) / scl[piv, None]
    a = torch.linalg.solve(U[piv], y0)
    return mm(U, a) * scl[:, None] + cnt[:, None]


def nrmse(X_rec: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Root-mean-square error over the range of ``X``."""
    err = X_rec - X
    return torch.sqrt((err * err).mean()) / (X.max() - X.min())


def scale_limits(lo, hi, cnt, scl, n_features):
    """Per-feature physical limits (F,) as scaled bounds of every row."""
    pts = cnt.shape[0] // n_features
    lo_r = lo.repeat_interleave(pts)
    hi_r = hi.repeat_interleave(pts)
    return (lo_r - cnt) / scl, (hi_r - cnt) / scl


def admm(H, c, A, lo, hi, iters: int, over_relax: float, adapt: bool,
         eps: float, mm=torch.matmul):
    """``min ½ gᵀH g − cᵀg  s.t. lo ≤ A g ≤ hi`` for a batch: ``H`` (b, r,
    r), ``c`` (b, r), ``A`` (n, r) shared, ``lo``/``hi`` (n,); ``iters``
    iterations of over-relaxed ADMM on the split ``z = A g`` with the
    penalty ρ started at tr H / tr AᵀA and, where ``adapt``, balanced
    every iteration (doubled when the primal residual is ten times the
    dual, halved in the opposite case, kept within six decades of its
    start, the scaled dual rescaled with it).  The g-update's matrix gets
    a ridge of 64 ``eps`` tr/r: the solver's safeguard, whose ``eps`` is
    that of the precision the configuration serves in (float32's for an
    fp32 sensor), whatever the arithmetic."""
    b, r = c.shape
    n = A.shape[0]
    AtA = mm(A.T, A)
    eye = torch.eye(r, dtype=c.dtype, device=c.device)
    tr = lambda M: torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)  # noqa: E731
    rho = torch.clamp((tr(H) + 1e-12) / (tr(AtA) + 1e-12), min=1e-8)
    rho0 = rho

    def factor(rho):
        M = H + rho[:, None, None] * AtA
        return torch.linalg.cholesky(
            M + (64.0 * eps * tr(M) / r)[:, None, None] * eye)

    def solve(L, v):
        return torch.cholesky_solve(v[..., None], L)[..., 0]

    L = factor(rho)
    g = solve(L, c)
    z = torch.clamp(mm(g, A.T), lo, hi)
    w = torch.zeros_like(z)
    a = float(over_relax)
    for _ in range(iters):
        if adapt:
            L = factor(rho)
        g = solve(L, c + rho[:, None] * mm(z - w, A))
        Ag = mm(g, A.T)
        Ag_rel = a * Ag + (1.0 - a) * z
        z_new = torch.clamp(Ag_rel + w, lo, hi)
        w = w + Ag_rel - z_new
        if adapt:
            pri = torch.linalg.vector_norm(Ag - z_new, dim=-1) / n ** 0.5
            dua = rho * torch.linalg.vector_norm(mm(z_new - z, A),
                                                 dim=-1) / r ** 0.5
            f = torch.where(pri > 10.0 * dua, 2.0,
                            torch.where(dua > 10.0 * pri, 0.5, 1.0))
            rho_new = torch.minimum(torch.maximum(rho * f, rho0 * 1e-6),
                                    rho0 * 1e6)
            w = w * (rho / rho_new)[:, None]
            rho = rho_new
        z = z_new
    return g


def serve(Ur, piv, cnt, scl, Y, S, method: str, lo=None, hi=None,
          iters: int = 0, over_relax: float = 1.6, adapt: bool = True,
          eps: float = 0.0, mm=torch.matmul):
    """A batch of frames served: readings ``Y`` (b, s) with standard
    deviations ``S`` (b, s) > 0 at rows ``piv`` of the basis ``Ur`` (n, r).
    The weighted least squares ``min ‖W(y0 − Θa)‖``, ``W = diag(1/σ0)``,
    for ``"OLS"``, or that objective under ``lo ≤ Ur a ≤ hi`` by
    :func:`admm` for ``"COLS"`` (``eps`` its ridge's).  Returns the
    fields (b, n), the coefficients (b, r) and their propagated σ,
    ``|pinv(WΘ) σ0|`` (b, r); the pseudo-inverse from the SVD of WΘ."""
    Theta = Ur[piv]
    y0 = (Y - cnt[piv]) / scl[piv]
    s0 = S / scl[piv]
    w = 1.0 / s0
    WT = Theta * w[:, :, None]                                # (b, s, r)
    Us, Ss, Vh = torch.linalg.svd(WT, full_matrices=False)
    pinv = mm(Vh.mT / Ss[:, None, :], Us.mT)                  # (b, r, s)
    if method == "OLS":
        a = mm(pinv, (w * y0)[..., None])[..., 0]
    elif method == "COLS":
        H = mm(WT.mT, WT)
        c = mm(WT.mT, (w * y0)[..., None])[..., 0]
        a = admm(H, c, Ur, lo, hi, iters, over_relax, adapt, eps, mm)
    else:
        raise ValueError(f"unknown method {method!r}")
    sig = torch.abs(mm(pinv, s0[..., None])[..., 0])
    x = mm(a, Ur.T) * scl + cnt
    return x, a, sig
