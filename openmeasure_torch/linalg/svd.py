"""Tall-skinny SVD for snapshot matrices (port of
``openmeasure_tpu/linalg/svd.py``).

Gram route: ``G = X0ᵀ X0`` is a tiny ``(m, m)`` matrix computed in one pass
over the ``(n, m)`` panel; its eigendecomposition gives V, and the left
singular vectors come from a second panel pass ``U = X0 V Σ⁻¹``.  In fp32
the Gram squares the condition number, so orthogonal-iteration refine
passes re-diagonalize the Gram of ``B = X0 V``.

Every product here runs in full fp32 (the package pins
``allow_tf32=False`` / precision "highest" at import).  Porting trap 6: the
JAX package computes the FIRST Gram at ``Precision.HIGH`` (a TPU bf16×3
trick); on the card there is no such mode worth having — TF32 would cost
orders of magnitude of NRMSE — so every product is full fp32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..utils import logging as _log


def canonical_signs(U):
    """Per-column canonical sign flips: the largest-|.| entry of each
    column made positive (zero sign → +1).  ``U`` is a tensor, or a numpy
    array for host-side callers (the streaming fit's host engine); the
    signs come back in U's kind and dtype."""
    if isinstance(U, np.ndarray):
        idx = np.argmax(np.abs(U), axis=0)
        signs = np.sign(U[idx, np.arange(U.shape[1])])
        return np.where(signs == 0, 1.0, signs).astype(U.dtype)
    idx = torch.argmax(torch.abs(U), dim=0)
    signs = torch.sign(U[idx, torch.arange(U.shape[1], device=U.device)])
    return torch.where(signs == 0, torch.ones_like(signs), signs)


def _sign_canonicalize(U: torch.Tensor, Vt: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    signs = canonical_signs(U)
    return U * signs[None, :], Vt * signs[:, None]


def default_refine(device: torch.device) -> int:
    """Refine depth of :func:`svd_tall` for a panel on ``device``.

    Porting trap 5: the JAX package keys this on the TPU backend (1 on a
    TPU, 2 elsewhere); the port keys it on the tensor's device, 1 on a
    CUDA card and 2 on the CPU.  On an H100 one pass already reaches the
    reconstruction NRMSE of two at the flagship and 3D sizes, and two cost
    one more pair of panel passes; a second pass also leaves the per-mode
    consumers where they were: the trailing modes' errors against a
    float64 fit, the placements' objectives on the float64 basis and the GP
    NRMSE (``profile_torch.py refine``, PERF.md).  On the CPU, LAPACK's
    fp32 eigensolver needs the second pass (the JAX package's
    measurement)."""
    return 1 if device.type == "cuda" else 2


def _finfo(dtype):
    return torch.finfo(dtype) if isinstance(dtype, torch.dtype) \
        else np.finfo(dtype)


def floored_norms(colnorm, n: int, dtype, tiny_dtype=None):
    """The eps·max·√n rank-deficiency norm floor used by every
    normalization in this module (with an absolute ``tiny`` floor).

    ``eps`` is that of ``dtype``, the precision the norms were accumulated
    in; ``tiny`` that of ``tiny_dtype`` (default ``dtype``), the storage
    dtype they divide.  ``colnorm`` is a tensor, or a numpy array (the
    streaming fit's host-float64 norms of an fp32 panel)."""
    eps = float(_finfo(dtype).eps)
    tiny = float(_finfo(dtype if tiny_dtype is None else tiny_dtype).tiny)
    if isinstance(colnorm, np.ndarray):
        return np.maximum(np.maximum(
            colnorm, eps * float(n) ** 0.5 * np.max(colnorm)), tiny)
    return torch.clamp(
        torch.maximum(colnorm, eps * float(n) ** 0.5 * torch.amax(colnorm)),
        min=tiny)


def _eigh_desc(G: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigenpairs in DESCENDING order.  Porting trap 4: ``V[:, ::-1]`` and
    ``evals[::-1]`` are ``torch.flip`` (torch has no negative strides).
    On the card ``torch.linalg.eigh`` reads its ``info`` back to check
    it: one ``host_reads``."""
    with _log.span("svd.eigh"):
        if G.is_cuda:
            _log.count("host_reads")
        evals, V = torch.linalg.eigh(G)          # ascending
        return torch.flip(evals, dims=(0,)), torch.flip(V, dims=(1,))


def svd_tall(
    X0: torch.Tensor, refine: Optional[int] = None, canonicalize: bool = True,
    rank: Optional[int] = None, width: Optional[int] = None,
    normalize: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Thin SVD of a tall matrix via the Gram route.

    Returns ``(U, S, Vt)`` shaped like ``torch.linalg.svd(X0,
    full_matrices=False)`` for ``n >= m``.

    ``rank=r`` truncates only the final n-row products (U has r columns; S
    keeps all m values, its first r the exact column norms).  Requires
    ``canonicalize=False``.  ``normalize=False`` (requires ``rank``)
    returns the unnormalized panel ``B = X0 V_r`` in U's place.
    ``width=w`` (requires ``rank``; r ≤ w ≤ m) narrows the refine passes to
    the leading-w subspace.
    """
    if refine is None:
        refine = default_refine(X0.device)
    if rank is not None and canonicalize:
        raise ValueError("rank truncation requires canonicalize=False")
    if not normalize and rank is None:
        raise ValueError("normalize=False requires rank truncation")
    if width is not None:
        if rank is None:
            raise ValueError("width requires rank truncation")
        if not rank <= width <= X0.shape[1]:
            raise ValueError("need rank <= width <= m")
        if width == X0.shape[1]:
            width = None
    n, m = X0.shape
    with _log.span("svd.gram"):
        G = X0.T @ X0                          # (m, m) — one panel pass
    S2, V = _eigh_desc(G)

    with _log.span("svd.panel"):
        if refine == 0 and rank is not None:
            B = X0 @ V[:, :rank]
        elif width is not None and refine > 0:
            B = X0 @ V[:, :width]              # (n, w) panel
        else:
            B = X0 @ V                         # (n, m) — second panel pass
    for i in range(refine):
        # one orthogonal-iteration step: re-diagonalize B's Gram
        with _log.span("svd.gram"):
            G = B.T @ B
        e2, V2 = _eigh_desc(G)
        if width is not None:
            # refined eigenvalues cover the leading-w subspace only; the
            # tail keeps the first Gram's estimates.  Porting trap 4:
            # S2.at[:width].set(...) is an indexed assignment on a clone.
            S2 = S2.clone()
            S2[:width] = e2
            V = V.clone()
            V[:, :width] = V[:, :width] @ V2
        else:
            S2 = e2
            V = V @ V2
        if rank is not None and i == refine - 1:
            V2 = V2[:, :rank]                  # narrow only the final write
        with _log.span("svd.panel"):
            B = B @ V2

    fi = torch.finfo(X0.dtype)
    # rank-deficiency floor eps·max·√n, plus an absolute tiny floor so an
    # all-zero panel yields U = 0 (see the JAX module for the measured
    # rationale of √n rather than n)
    floor_scale = fi.eps * float(n) ** 0.5
    if rank is None:
        S = torch.linalg.vector_norm(B, dim=0)
        safe = torch.clamp(torch.maximum(S, floor_scale * torch.amax(S)),
                           min=fi.tiny)
        U = B / safe[None, :]
    else:
        # normalize with the TRUE column norms of the truncated panel, not
        # sqrt(eigenvalue): fp32 eigenvalues spread over cond² of X0
        colnorm = torch.linalg.vector_norm(B, dim=0)       # (rank,)
        S = torch.sqrt(torch.clamp(S2, min=0.0)).clone()
        S[:rank] = colnorm
        if not normalize:
            return B, S, V.T
        safe = torch.clamp(
            torch.maximum(colnorm, floor_scale * torch.amax(colnorm)),
            min=fi.tiny)
        U = B / safe[None, :]
    Vt = V.T
    if canonicalize:
        U, Vt = _sign_canonicalize(U, Vt)
    return U, S, Vt


def svd_tall_deflated(
    X0: torch.Tensor, rank: int, deflate: int, refine: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Two-block deflated Gram-route SVD: the leading ``deflate`` modes
    normally, then modes ``deflate..rank`` from the panel with the leading
    block's represented part subtracted (where they are leading, so their
    Gram eigenvalues and panel product are relatively accurate).

    Returns ``(U (n, rank), S (m,), Vt (m, m))`` like
    ``svd_tall(rank=...)``; ``deflate`` ∈ [1, rank), otherwise the plain
    path."""
    if not 0 < deflate < rank:
        return svd_tall(X0, refine=refine, canonicalize=False, rank=rank)
    k = deflate
    U1, S1, Vt1 = svd_tall(X0, refine=refine, canonicalize=False, rank=k)
    Xd = X0 - (U1 * S1[:k][None, :]) @ Vt1[:k]
    U2, S2, Vt2 = svd_tall(Xd, refine=refine, canonicalize=False,
                           rank=rank - k)
    U = torch.cat([U1, U2], dim=1)
    S = S1.clone()
    S[k:rank] = S2[: rank - k]
    Vt = Vt1.clone()
    Vt[k:rank] = Vt2[: rank - k]
    return U, S, Vt


def svd_tall_safe(
    X0: torch.Tensor, refine: Optional[int] = None, canonicalize: bool = True
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`svd_tall` with a rank-deficiency fixup.

    Porting trap 7: when X0 is numerically rank-deficient (a row-centered
    snapshot matrix has rank ≤ m−1, so the class API ALWAYS takes this
    branch with ``axis_cnt=1``), the Gram route's null-space columns of U
    are junk; one host readback of the tiny S detects it and a thin QR of
    the (n, m) U re-orthonormalizes them, keeping the leading columns.  On
    the card that QR is an expected ``torch.linalg.qr`` of the full panel,
    not a fault.
    """
    U, S, Vt = svd_tall(X0, refine=refine, canonicalize=canonicalize)
    n, m = X0.shape
    eps = torch.finfo(X0.dtype).eps
    if bool(torch.amin(S) <= eps * torch.amax(S) * float(n) ** 0.5):
        Q, R = torch.linalg.qr(U)
        d = torch.diagonal(R)
        sgn = torch.where(d < 0, -torch.ones_like(d), torch.ones_like(d))
        U = Q * sgn[None, :]
    return U, S, Vt


def explained_variance(S: torch.Tensor) -> torch.Tensor:
    """``100 * cumsum(S²) / sum(S²)``."""
    L = S * S
    return 100.0 * torch.cumsum(L, dim=0) / torch.sum(L)


def select_rank(exp_variance, select_modes: str, n_modes,
                max_rank: int) -> int:
    """Host-side truncation-rank selection (same rules and error strings as
    the JAX package's ``select_rank``)."""
    if select_modes == "variance":
        if not 0 <= n_modes <= 100:
            # the message keeps the reference's missing space verbatim
            raise ValueError(
                "The parameter n_modes is outside the[0-100] range.")
        if n_modes == 100:
            return max_rank
        if isinstance(exp_variance, torch.Tensor):
            exp_variance = exp_variance.detach().cpu().numpy()
        ev = np.asarray(exp_variance)
        # fp32 cumulative variance can round below a requested 99.999995:
        # clamp at max_rank instead of indexing past the array
        r = 1
        while r < max_rank and ev[r - 1] < n_modes:
            r += 1
        return r
    if select_modes == "number":
        # `type(...) is int`: bool must NOT pass as a mode count
        if type(n_modes) is not int:
            raise TypeError("The parameter n_modes is not an integer.")
        if not 1 <= n_modes <= max_rank:
            raise ValueError("The parameter n_modes is outside the [1-m] range.")
        return n_modes
    raise ValueError("The select_mode value is wrong.")


def randomized_svd(
    X0: torch.Tensor, k: int, generator: Optional[torch.Generator] = None,
    n_iter: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Randomized truncated SVD (Halko–Martinsson–Tropp) for wide snapshot
    sets where the exact (m, m) Gram is no longer cheap: oversampling 10,
    ``n_iter`` power iterations with QR re-orthogonalization between them.
    Returns ``(U (n, k), S (k,), Vt (k, m))`` with canonical signs.

    Ω (m, min(m, k + 10)) is standard normal, drawn by ``generator`` (a
    ``torch.Generator`` on X0's device), or by a new one seeded with 0 when
    none is given, as the JAX package defaults its key.  Documented
    deviation: the JAX package draws Ω from ``jax.random`` (threefry), so
    one seed gives another Ω; the factorization of X0 it approximates is
    the same."""
    n, m = X0.shape
    p = min(m, k + 10)
    if generator is None:
        generator = torch.Generator(device=X0.device).manual_seed(0)
    Omega = torch.randn((m, p), generator=generator, dtype=X0.dtype,
                        device=X0.device)
    Y = X0 @ Omega
    for _ in range(n_iter):
        Y, _ = torch.linalg.qr(Y)
        Y = X0 @ (X0.T @ Y)
    Q, _ = torch.linalg.qr(Y)
    B = Q.T @ X0                                  # (p, m)
    Ub, S, Vt = torch.linalg.svd(B, full_matrices=False)
    U = Q @ Ub
    U, Vt = _sign_canonicalize(U[:, :k], Vt[:k])
    return U, S[:k], Vt
