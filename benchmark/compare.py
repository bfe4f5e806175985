"""Helpers the traffic drivers share to compare tested outputs with the
reference's."""

from __future__ import annotations

import torch


# a basis is judged over its leading k modes, k the last mode whose Gram
# eigengap σ_k² − σ_k+1² is at least this share of σ_1²
RESOLVED = 2e-3


def resolved_modes(S: torch.Tensor, r: int) -> int:
    """The largest k ≤ r with σ_k² − σ_k+1² ≥ RESOLVED·σ_1² (1-based), the
    reference's singular values ``S``; 1 where none is."""
    lam = S.double() ** 2
    ks = [k for k in range(1, r + 1)
          if lam[k - 1] - lam[k] >= RESOLVED * lam[0]]
    return ks[-1] if ks else 1


def pod_excess(U_test: torch.Tensor, U_ref: torch.Tensor, X0: torch.Tensor,
               S_ref: torch.Tensor, r: int) -> float:
    """How far a basis falls short of the optimal one (Eckart–Young): the
    norm of what its leading k modes leave of the scaled snapshots ``X0``
    over what the reference POD's leading k leave, less 1 (float64).  k
    ends where the reference's spectrum resolves the modes
    (:func:`resolved_modes`): a basis computed from the Gram matrix in a
    precision of unit round-off ε places the subspace of its leading k
    modes to about ε·σ_1² / (σ_k² − σ_k+1²), so past a small eigengap the
    excess measures the gap, not the arithmetic."""
    k = resolved_modes(S_ref, r)
    X0 = X0.double()

    def left(U):
        Q, _ = torch.linalg.qr(U[:, :k].double())
        return torch.linalg.matrix_norm(X0 - Q @ (Q.T @ X0))
    return float(left(U_test) / left(U_ref) - 1.0)
