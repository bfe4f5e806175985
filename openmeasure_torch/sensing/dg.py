"""Determinant-based greedy (D-optimal) sensor selection (port of
``openmeasure_tpu/sensing/dg.py``; Saito et al., arXiv:1911.08757).

* s ≤ r: greedily maximize det(Θ Θᵀ); the increment of a candidate row is
  its squared residual after projection onto the selected rows, which is
  greedy column-pivoted QR, so phase 1 is the QRCP pivots.
* s > r: greedily maximize det(Θᵀ Θ); the increment is 1 + uᵀ(ΘᵀΘ)⁻¹u,
  tracked with Sherman–Morrison rank-1 updates of W = (ΘᵀΘ + 1e-12 I)⁻¹,
  one (n, r) product per step, all on the device.

Phase 1 goes through :func:`..linalg.qrcp_cuda.qrcp_pivots_auto`, so a
CUDA fp32 basis takes the CUDA kernel (``csrc/qrcp.cu``) where the JAX
package calls its plain ``qrcp_pivots``.  The result does not change: on
the card the kernel's pivots are bit-equal to the port's plain sweep, and
on the CPU the dispatch is that sweep.  Phase 2's loop reads nothing back;
the indices come to the host in one read at the end.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import as_tensor, to_numpy
from ..linalg.qrcp_cuda import qrcp_pivots_auto


def _dg_phase2(Ur: torch.Tensor, selected0: torch.Tensor,
               alive0: torch.Tensor, n_extra: int) -> torch.Tensor:
    """Greedy det(ΘᵀΘ) maximization for the sensors beyond the mode count.

    ``selected0`` (r,) int32 phase-1 pivots, ``alive0`` (n,) candidate
    mask.  Returns (n_extra,) int32 additional row indices, on Ur's
    device."""
    n, r = Ur.shape
    Theta0 = Ur.index_select(0, selected0.long())          # (r, r)
    G = Theta0.T @ Theta0
    W = torch.linalg.inv_ex(
        G + 1e-12 * torch.eye(r, dtype=Ur.dtype, device=Ur.device))[0]
    alive = alive0.clone()
    extra = torch.zeros((n_extra,), dtype=torch.int32, device=Ur.device)
    for i in range(n_extra):
        UW = Ur @ W                                        # (n, r)
        scores = torch.sum(UW * Ur, dim=1)                 # uᵀ W u per row
        scores = torch.where(alive, scores, float("-inf"))
        j = torch.argmax(scores).reshape(1)
        u = Ur.index_select(0, j)[0]
        Wu = W @ u
        denom = 1.0 + torch.dot(u, Wu)
        W = W - torch.outer(Wu, Wu) / denom                # Sherman–Morrison
        alive = alive.index_fill(0, j, False)
        extra[i:i + 1] = j.to(torch.int32)
    return extra


def dg_select(Ur, n_sensors: int, mask=None) -> np.ndarray:
    """D-optimal greedy selection of ``n_sensors`` rows of the basis tensor
    Ur (n, r), on its device.

    Any budget: the first min(n_sensors, r) sensors are the QRCP pivots;
    further sensors maximize det(ΘᵀΘ) by Sherman–Morrison.  ``mask``
    restricts the searchable rows.  Returns int64 (n_sensors,) row indices
    on the host."""
    n, r = Ur.shape
    if mask is not None:
        keep = as_tensor(np.asarray(mask, dtype=bool), Ur.device)
        Ur_m = torch.where(keep[:, None], Ur,
                           torch.zeros((), dtype=Ur.dtype, device=Ur.device))
    else:
        keep = torch.ones((n,), dtype=torch.bool, device=Ur.device)
        Ur_m = Ur

    k1 = min(n_sensors, r)
    piv = qrcp_pivots_auto(Ur_m.T, k1)
    if n_sensors <= r:
        out = to_numpy(piv[:n_sensors]).astype(np.int64)
        if len(set(out.tolist())) != n_sensors:
            raise ValueError(
                f"dg placement ran out of candidates: {n_sensors} sensors "
                "requested but the masked basis has fewer independent rows.")
        return out

    alive = keep.index_fill(0, piv.long(), False)
    extra = _dg_phase2(Ur_m, piv, alive, n_sensors - r)
    out = to_numpy(torch.cat([piv, extra])).astype(np.int64)
    if len(set(out.tolist())) != n_sensors:
        n_avail = int(to_numpy(keep).sum()) + r
        raise ValueError(
            f"dg placement ran out of candidates: {n_sensors} sensors "
            f"requested but only {n_avail} rows are selectable (mask/size). "
            "Request fewer sensors or enlarge the mask.")
    return out
