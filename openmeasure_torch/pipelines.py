"""End-to-end functional pipelines (port of ``openmeasure_tpu/pipelines.py``,
the SPR part).

:func:`spr_end_to_end` is the soft-sensing flow in one call — scale →
Gram-SVD → truncate → QRCP placement → gappy-POD solve → reconstruct — the
flagship path of the package.  It runs eagerly on the tensors' device;
nothing in it synchronizes with the host: the pivots the CUDA kernel
selects stay on the card and index the panel there.

``gpr_end_to_end`` and ``mfk_end_to_end`` come with the GP and
co-kriging slices (ROADMAP.md §A items 9 and 10).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .core import scaling as _scaling
from .core.device import DeviceLike, as_tensor, resolve_device
from .linalg import svd as _svd
from .linalg.qrcp_cuda import qrcp_pivots_auto


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
    dev = resolve_device(device)
    X_train = as_tensor(X_train, dev)
    X_test = as_tensor(X_test, dev)
    X0, cnt, scl = _scaling.scale_data(X_train, n_features, scale_type, 1)
    # normalize=False: the basis normalization U = B·diag(1/‖b_i‖) never
    # materializes — the QRCP kernel row-scales the panel in-kernel and the
    # (r,)-sized factor folds into Theta and the reconstruction.  Porting
    # trap 8: canonicalize=False leaves each mode's sign to the eigensolver;
    # pivots, the Theta solve and X_rec do not depend on it (Ar does, per
    # mode)
    B, S, _ = _svd.svd_tall(X0, refine=refine, canonicalize=False, rank=r,
                            width=svd_width, normalize=False)
    exp_var = _svd.explained_variance(S)[:r]
    dinv = 1.0 / _svd.floored_norms(S[:r], X0.shape[0], X0.dtype)

    # B.T is the (r, n) panel; the kernel reads it through its strides
    pivots = qrcp_pivots_auto(B.T, r, row_scale=dinv)
    p = pivots.long()

    Theta = B[p, :] * dinv[None, :]     # (r, r) == Ur[pivots, :]
    y = X_test[p, :]                    # raw sensor readings, (r, m_test)
    y0 = (y - cnt[p, 0][:, None]) / scl[p, 0][:, None]

    Ar = torch.linalg.solve(Theta, y0).T          # (m_test, r)
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
