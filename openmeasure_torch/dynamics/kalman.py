"""Reduced-order Kalman filtering of sparse-measurement time series (port
of ``openmeasure_tpu/dynamics/kalman.py``).

A reduced linear model ``a_{k+1} = A a_k + w`` is identified from the
training coefficients, and a discrete Kalman filter runs against the
gappy measurement model ``y0_k = Θ a_k + v`` (the ``Θ = C Ur`` of the
static solve).

The identification (tiny (r, r) least squares) and the stationary
covariance run on the host in float64, numpy and scipy only: the port
keeps its own copy of :func:`fit_reduced_operator`,
:func:`estimate_process_noise` and :func:`stationary_covariance`.  The
filter and the Rauch–Tung–Striebel smoother run on the device: the JAX
``lax.scan`` over frames is a Python loop over device tensors (a forward
loop, and a reverse one for the smoother), Joseph-form covariance updates,
and each SPD solve a :func:`..linalg.chol.cholesky_nan` factor with
``torch.cholesky_solve`` (NaN where the factorization fails, no host
read).  Nothing in either loop reads back to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..linalg.chol import cholesky_nan


def fit_reduced_operator(Ar, ridge: float = 0.0) -> np.ndarray:
    """One-step linear dynamics on the reduced coefficients.

    ``Ar`` (m, r) holds the time-ordered POD coefficients, one snapshot per
    row.  Returns the (r, r) operator A minimizing ``Σ_k ‖A a_k −
    a_{k+1}‖²`` (+ ridge ``λ·tr(G)/r`` on the Gram diagonal), host LAPACK
    float64."""
    Ar = np.asarray(Ar, dtype=np.float64)
    if Ar.ndim != 2 or Ar.shape[0] < 2:
        raise ValueError(
            f"Ar must be (m >= 2, r) time-ordered coefficients; got "
            f"{Ar.shape}.")
    Y1, Y2 = Ar[:-1], Ar[1:]
    if ridge == 0.0:
        At, *_ = np.linalg.lstsq(Y1, Y2, rcond=None)
        return np.ascontiguousarray(At.T)
    r = Ar.shape[1]
    G = Y1.T @ Y1
    G_reg = G + (ridge * np.trace(G) / max(r, 1)) * np.eye(r)
    At = np.linalg.solve(G_reg, Y1.T @ Y2)
    return np.ascontiguousarray(At.T)


def estimate_process_noise(A, Ar, floor_rel: float = 1e-8) -> np.ndarray:
    """Process-noise covariance from the one-step residuals of ``A``:
    ``Q = EᵀE / (k − 1)`` over the k = m−1 residuals ``e_k = a_{k+1} −
    A a_k``, symmetrized, with a relative diagonal floor so that a
    perfectly linear series still gives a positive-definite Q."""
    A = np.asarray(A, dtype=np.float64)
    Ar = np.asarray(Ar, dtype=np.float64)
    E = Ar[1:] - Ar[:-1] @ A.T
    k = E.shape[0]
    Q = (E.T @ E) / max(k - 1, 1)
    Q = 0.5 * (Q + Q.T)
    r = Q.shape[0]
    scale = max(np.trace(Q) / max(r, 1), np.mean(np.square(Ar)))
    return Q + (floor_rel * max(scale, np.finfo(np.float64).tiny)) \
        * np.eye(r)


def stationary_covariance(A, Q) -> np.ndarray:
    """Stationary state covariance ``P = A P Aᵀ + Q`` (discrete Lyapunov),
    by scipy when the dynamics are stable; an unstable A (spectral radius
    ≥ 1) has none, and the filter starts from ``10·Q``."""
    A = np.asarray(A, dtype=np.float64)
    Q = np.asarray(Q, dtype=np.float64)
    rho = np.max(np.abs(np.linalg.eigvals(A)))
    if rho >= 1.0 - 1e-9:
        return 10.0 * Q
    from scipy.linalg import solve_discrete_lyapunov
    P = solve_discrete_lyapunov(A, Q)
    return 0.5 * (P + P.T)


# effective variance of a GATED (outlier-rejected) measurement: the Kalman
# gain is numerically zero, and the SPD innovation solve stays
# well-conditioned in fp32
_GATED_R = 1e12

# relative floor on each measurement's effective variance against its own
# predicted innovation variance (see _kf_core), ~10x fp32 eps
_R_FLOOR_REL = 1e-6


def _spd_solve(S: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``S⁻¹ B`` for an SPD S by its Cholesky factor (NaN where S does not
    factor, as ``jax.scipy.linalg.solve(assume_a='pos')`` gives)."""
    return torch.cholesky_solve(B, cholesky_nan(S))


def _kf_core(A, Q, H, a, P, y0, r_diag, gate):
    """One predict + Joseph-form update.  Returns the posterior (a, P),
    the prediction (a, P) and the rejection mask (s,).

    ``gate`` (0-d tensor) is the innovation-gating threshold in predicted
    standard deviations: an entry whose innovation exceeds ``gate ·
    √S_ii`` is rejected, its variance replaced by :data:`_GATED_R` and its
    innovation zeroed, exactly like a missing reading.  ``gate = inf``
    disables gating: the masks then select every original value, so the
    results are bit-identical to the ungated filter."""
    a_pred = A @ a
    P_pred = (A @ P) @ A.T + Q
    PHt = P_pred @ H.T                                     # (r, s)
    innov = y0 - H @ a_pred
    hpht_diag = torch.sum(H * PHt.T, dim=1)                # (s,)
    S_diag = hpht_diag + r_diag
    rej = torch.square(innov) > torch.square(gate) * S_diag
    # relative variance floor: with more sensors than modes H P Hᵀ has
    # rank ≤ r < s, and an (near-)exact R would leave S singular
    r_eff = torch.maximum(r_diag, _R_FLOOR_REL * hpht_diag)
    r_eff = torch.where(rej, torch.full_like(r_diag, _GATED_R), r_eff)
    S = H @ PHt + torch.diag(r_eff)                        # (s, s) SPD
    K = _spd_solve(S, PHt.T).T                             # (r, s)
    # a rejected entry's innovation is zeroed outright, so a large finite
    # garbage reading cannot leak through the ~1e-12 gated gain
    innov_eff = torch.where(rej, torch.zeros_like(innov), innov)
    a_new = a_pred + K @ innov_eff
    IKH = torch.eye(a.shape[0], dtype=P.dtype, device=P.device) - K @ H
    P_new = (IKH @ P_pred) @ IKH.T + (K * r_eff[None, :]) @ K.T
    P_new = 0.5 * (P_new + P_new.T)
    return a_new, P_new, a_pred, P_pred, rej


def _gate_tensor(gate, like: torch.Tensor) -> torch.Tensor:
    g = float("inf") if gate is None else gate
    return torch.as_tensor(g, dtype=like.dtype, device=like.device)


def _forward_pass(A, Q, H, a0, P0, Y0, R_diag, gate, full: bool):
    """The filter's loop over the K frames.  Returns the per-frame lists
    (a, P or its diagonal, a_pred, P_pred, rej) and the final (a, P)."""
    a, P = a0, P0
    outs = {"a": [], "P": [], "a_pred": [], "P_pred": [], "rej": []}
    for k in range(Y0.shape[0]):
        a, P, a_pred, P_pred, rej = _kf_core(A, Q, H, a, P, Y0[k],
                                             R_diag[k], gate)
        outs["a"].append(a)
        outs["P"].append(P if full else torch.diagonal(P))
        outs["rej"].append(rej)
        if full:
            outs["a_pred"].append(a_pred)
            outs["P_pred"].append(P_pred)
    return outs, (a, P)


def kalman_filter(A, Q, H, a0, P0, Y0, R_diag, gate=None,
                  return_rejected: bool = False):
    """Filter a series of SCALED measurements through the reduced dynamics.

    A (r, r), Q (r, r): dynamics and process noise; H (s, r): measurement
    matrix (``Theta``); a0 (r,), P0 (r, r): prior at the step BEFORE
    ``Y0[0]``; Y0 (K, s): scaled measurements; R_diag (K, s): per-step
    measurement-noise variances (0 = exact).  ``gate``: optional
    innovation-gating threshold in predicted standard deviations (``None``
    disables it: results bit-identical to the ungated filter).  All
    tensors of one device and dtype.

    Returns ``(A_filt (K, r), var_diag (K, r), (a_K, P_K))``, with
    ``return_rejected=True`` a fourth (K, s) bool tensor of gated
    entries."""
    g = _gate_tensor(gate, P0)
    outs, carry = _forward_pass(A, Q, H, a0, P0, Y0, R_diag, g, full=False)
    r, s = A.shape[0], H.shape[0]
    empty = Y0.shape[0] == 0
    A_filt = (P0.new_zeros((0, r)) if empty else torch.stack(outs["a"]))
    var = (P0.new_zeros((0, r)) if empty else torch.stack(outs["P"]))
    if return_rejected:
        rej = (torch.zeros((0, s), dtype=torch.bool, device=P0.device)
               if empty else torch.stack(outs["rej"]))
        return A_filt, var, carry, rej
    return A_filt, var, carry


def kalman_smoother(A, Q, H, a0, P0, Y0, R_diag, gate=None,
                    return_rejected: bool = False):
    """Rauch–Tung–Striebel smoothing of the full measurement series.

    Inputs as :func:`kalman_filter` (the ``gate`` applies on the forward
    pass); every returned mean conditions on all K measurements.  Returns
    ``(A_smooth (K, r), var_diag (K, r), (a_K, P_K))``, where the carry is
    the FORWARD filter's final state.  The backward gain ``G_k = P_k Aᵀ
    P_{k+1|k}⁻¹`` comes from an SPD solve, never an explicit inverse."""
    if Y0.shape[0] == 0:
        raise ValueError(
            "kalman_smoother needs at least one frame (K >= 1); an empty "
            "series has no last filtered state to smooth from.")
    g = _gate_tensor(gate, P0)
    outs, carry = _forward_pass(A, Q, H, a0, P0, Y0, R_diag, g, full=True)
    A_f, P_f = outs["a"], outs["P"]
    K = len(A_f)
    a_s, P_s = A_f[-1], P_f[-1]
    means, vars_ = [a_s], [torch.diagonal(P_s)]
    for k in range(K - 2, -1, -1):
        a_p1, P_p1 = outs["a_pred"][k + 1], outs["P_pred"][k + 1]
        Gt = _spd_solve(P_p1, A @ P_f[k])              # Gᵀ = P⁻¹_{k+1|k} A P_k
        a_s = A_f[k] + Gt.T @ (a_s - a_p1)
        P_s = P_f[k] + (Gt.T @ (P_s - P_p1)) @ Gt
        P_s = 0.5 * (P_s + P_s.T)
        means.append(a_s)
        vars_.append(torch.diagonal(P_s))
    A_smooth = torch.stack(means[::-1])
    var = torch.stack(vars_[::-1])
    if return_rejected:
        return A_smooth, var, carry, torch.stack(outs["rej"])
    return A_smooth, var, carry
