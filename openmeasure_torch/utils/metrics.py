"""Error metrics (port of ``openmeasure_tpu/utils/metrics.py``).

NRMSE — RMSE over the range of the true field — is the reconstruction
quality metric of the soft-sensing flow; the others are its usual
companions.  Inputs may be tensors or array-likes; array-likes become
tensors on the true field's device (or the CPU).
"""

from __future__ import annotations

import numpy as np
import torch


def _pair(x_pred, x_true):
    t = x_true if isinstance(x_true, torch.Tensor) else torch.as_tensor(
        np.asarray(x_true))
    p = x_pred if isinstance(x_pred, torch.Tensor) else torch.as_tensor(
        np.asarray(x_pred))
    return p.to(t.device), t


def rmse(x_pred, x_true) -> torch.Tensor:
    p, t = _pair(x_pred, x_true)
    e = p - t
    return torch.sqrt(torch.mean(e * e))


def nrmse(x_pred, x_true) -> torch.Tensor:
    """RMSE normalized by the range of the true field."""
    p, t = _pair(x_pred, x_true)
    return rmse(p, t) / (torch.amax(t) - torch.amin(t))


def mae(x_pred, x_true) -> torch.Tensor:
    p, t = _pair(x_pred, x_true)
    return torch.mean(torch.abs(p - t))


def r2(x_pred, x_true) -> torch.Tensor:
    """Coefficient of determination."""
    p, t = _pair(x_pred, x_true)
    ss_res = torch.sum((t - p) ** 2)
    ss_tot = torch.sum((t - torch.mean(t)) ** 2)
    return 1.0 - ss_res / ss_tot


def nrmse_per_feature(x_pred, x_true, n_features: int) -> np.ndarray:
    """Per-feature-block NRMSE, shape (n_features,), computed on the host."""
    p, t = _pair(x_pred, x_true)
    x_pred = p.detach().cpu().numpy()
    x_true = t.detach().cpu().numpy()
    n_points = x_true.shape[0] // n_features
    out = np.zeros(n_features)
    for f in range(n_features):
        blk = slice(f * n_points, (f + 1) * n_points)
        rng = x_true[blk].max() - x_true[blk].min()
        out[f] = np.sqrt(np.mean((x_pred[blk] - x_true[blk]) ** 2)) / rng
    return out
