"""Incremental thin-SVD update: append snapshot columns without a refit
(port of ``openmeasure_tpu/linalg/incremental.py``).

Brand's rank-additive SVD update (M. Brand, "Fast low-rank modifications of
the thin singular value decomposition", Linear Algebra Appl. 415, 2006).
Given a thin factorization ``X0 ≈ U diag(S) Vt`` (rank r, U: (n, r)) and q
new scaled columns ``Xn`` (n, q):

.. code-block:: text

    M   = Uᵀ Xn                      (r, q)   one narrow-panel pass
    Res = Xn − U M                   (n, q)   residual out of span(U)
    Q R = qr(Res)                    (n, q) thin QR
    K   = [[diag(S), M],
           [   0   , R ]]            ((r+q), (r+q)), tiny
    K   = Uk Sk Vkᵀ                  small dense SVD
    U'  = [U  Q] Uk                  one (n, r+q) matmul pass
    S'  = Sk
    V'  = [[V, 0], [0, I_q]] Vk      right factors for all m+q snapshots

This is exact (to round-off) for the matrix ``[U diag(S) Vt, Xn]``; keeping
all r+q triplets reproduces the direct SVD of the concatenation, and
truncating back to rank r is its optimal rank-r approximation.  All n-row
work is narrow panel passes, with no re-read of the original snapshots.

The products run on the inputs' device at full fp32 (the package pins
``torch.set_float32_matmul_precision("highest")``).  With ``reorth=True``
(the default) one classical Gram–Schmidt re-orthogonalization pass of the
residual against U keeps ``[U Q]`` orthonormal to ~eps even when the new
snapshots lie nearly in span(U).

:func:`svd_append_columns_eager` computes the tiny core SVD in float64 on
the host, by design: an fp32 device SVD of an ill-conditioned K loses its
small singular values.  It reads S, M and R back in one device-to-host
copy.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core.device import as_tensor, to_numpy_once
from ..parallel._comm import active, axis_of


def _project_residual(U: torch.Tensor, Xn: torch.Tensor, reorth: bool,
                      axis=None):
    """Projection coefficients and the out-of-span residual, the panel
    passes every update variant shares.  With ``axis`` the rows of U and
    Xn are sharded and the (r, q) products are all-reduced."""
    def proj(B):
        P = U.T @ B
        return P if axis is None else axis.sum(P)

    Xn = Xn.to(U.dtype)
    M = proj(Xn)
    Res = Xn - U @ M
    if reorth:
        # one CGS re-orthogonalization pass: removes the O(eps·κ) part of
        # Res still in span(U)
        M2 = proj(Res)
        Res = Res - U @ M2
        M = M + M2
    return M, Res


def _assemble_K(S, M, R, r, q, dt):
    K = torch.zeros((r + q, r + q), dtype=dt, device=M.device)
    K[:r, :r] = torch.diag(S.to(dt))
    K[:r, r:] = M
    K[r:, r:] = R
    return K


def _finish_V(Vt, Vk, r, dt):
    V_top = Vt.T.to(dt) @ Vk[:r, :]
    return torch.cat([V_top, Vk[r:, :]], dim=0).T


def _residual_qr(U: torch.Tensor, Xn: torch.Tensor, reorth: bool = True):
    """The device panel passes of the update: projection M, the residual's
    thin QR."""
    M, Res = _project_residual(U, Xn, reorth)
    Q, R = torch.linalg.qr(Res)
    return M, Q, R


def svd_append_columns(
    U: torch.Tensor, S: torch.Tensor, Vt: torch.Tensor, Xn: torch.Tensor,
    reorth: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Thin-SVD update appending columns ``Xn`` to ``U diag(S) Vt``, all on
    U's device.

    Returns ``(U', S', Vt')`` of the concatenated matrix with r+q triplets
    (the caller truncates).  ``Vt'`` has shape ``(r+q, m+q)``."""
    r = S.shape[0]
    q = Xn.shape[1]
    dt = U.dtype
    M, Q, R = _residual_qr(U, Xn, reorth=reorth)
    Uk, Sk, Vkt = torch.linalg.svd(_assemble_K(S, M, R, r, q, dt))
    U_new = torch.cat([U, Q], dim=1) @ Uk                     # (n, r+q)
    return U_new, Sk, _finish_V(Vt, Vkt.T, r, dt)


def svd_append_columns_eager(
    U: torch.Tensor, S, Vt, Xn: torch.Tensor, reorth: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`svd_append_columns` with the tiny core SVD in float64 on the
    host (LAPACK through numpy), the accurate form on the card.

    An fp32 device SVD loses the SMALL singular values of an ill-conditioned
    core (cond(K) ~1e5 at flame scale); the core is (r+q)² scalars, so its
    round trip to the host is cheap beside the (n, r+q) panel passes, which
    stay on U's device.  S, M and R come back in one device-to-host copy;
    the factors Uk and Vk go back up in U's dtype."""
    dt, dev = U.dtype, U.device
    M, Q, R = _residual_qr(U, Xn, reorth=reorth)
    S_t = as_tensor(S, dev)
    r = int(S_t.shape[0])
    q = int(Xn.shape[1])
    S64, M64, R64 = (a.astype(np.float64)
                     for a in to_numpy_once(S_t, M, R))
    K = np.zeros((r + q, r + q), dtype=np.float64)
    K[np.arange(r), np.arange(r)] = S64
    K[:r, r:] = M64
    K[r:, r:] = R64
    Uk, Sk, Vkt = np.linalg.svd(K)                 # LAPACK float64, tiny
    Vk = Vkt.T

    U_new = torch.cat([U, Q], dim=1) @ as_tensor(Uk, dev, dtype=dt)
    V_old = as_tensor(Vt, dev).T.to(dt)
    V_top = V_old @ as_tensor(Vk[:r, :], dev, dtype=dt)
    V_new = torch.cat([V_top, as_tensor(Vk[r:, :], dev, dtype=dt)], dim=0)
    return U_new, as_tensor(Sk, dev, dtype=dt), V_new.T


def svd_append_columns_cholqr(
    U: torch.Tensor, S: torch.Tensor, Vt: torch.Tensor, Xn: torch.Tensor,
    reorth: bool = True, mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`svd_append_columns` with the residual orthogonalized through
    its (q, q) Gram (the CholQR class), the form for row-sharded bases: only
    the Gram and the (r+q)-sized core are reduced across rows, and Q is
    never formed: ``U' = U·Uk_top + Res·(R⁻¹ Uk_bot)``.

    The (q, q) factor comes from the Gram's eigendecomposition, not a
    Cholesky: a length-n fp32 dot product carries ~√n·eps·scale of rounding,
    so the computed Gram of new snapshots nearly in span(U) can be
    indefinite by more than an eps·trace ridge.  Only its eigenvalues are
    floored, at √n·eps of the largest; ``R = diag(√e) Wᵀ`` is not
    triangular, which nothing needs (K only requires ``RᵀR = G_R``), and
    ``R⁻¹ = W diag(1/√e)``.  ``Q R ≡ Res`` holds by construction, so the
    factorization still reproduces the concatenation; only Q's
    orthonormality degrades in near-null directions, which truncation
    discards.

    With ``mesh`` the rows of U and Xn are sharded over its ``state``
    axis (each rank passes its rows): the (r, q) projections and the
    (q, q) Gram are all-reduced, the core and its SVD are replicated, and
    each rank gets its rows of U'."""
    axis = active(axis_of(mesh))
    r = S.shape[0]
    q = Xn.shape[1]
    n = U.shape[0]
    dt = U.dtype
    M, Res = _project_residual(U, Xn, reorth, axis)
    G_R = Res.T @ Res                                        # (q, q)
    if axis is not None:
        G_R = axis.sum(G_R)
        n = int(axis.sum(torch.tensor([n], device=U.device)))
    e, Wg = torch.linalg.eigh(G_R)                           # ascending
    finfo = torch.finfo(dt)
    floor = torch.clamp(finfo.eps * float(n) ** 0.5 * e[-1], min=finfo.tiny)
    sq = torch.sqrt(torch.maximum(e, floor))
    R = sq[:, None] * Wg.T                                   # RᵀR = G_R⁺

    Uk, Sk, Vkt = torch.linalg.svd(_assemble_K(S, M, R, r, q, dt))
    # R⁻¹ Uk_bot without forming Q: R⁻¹ = Wg diag(1/√e)
    T = Wg @ (Uk[r:, :] / sq[:, None])
    U_new = U @ Uk[:r, :] + Res @ T                          # (n, r+q)
    return U_new, Sk, _finish_V(Vt, Vkt.T, r, dt)
