"""Greedy entropy maximization (GEM) sensor placement (port of
``openmeasure_tpu/sensing/gem.py``).

The JAX package runs the selection as one jitted fixed-shape program; here
the ``lax.fori_loop`` over sensors is a Python loop over device tensors
with the same padded buffers, so no step reads anything back to the host:
the argmax stays on the device (``torch.argmax`` ranks NaN first, as
``jnp.argmax`` does), and the selection, the step scores, the running
entropy (and, for the verbose table, σ²_y) come back in one read at the
end.

Covariance bookkeeping with fixed shapes: the selected-rows buffer ``Cs``
(n_sensors, r) is zero-padded; Σ_AA = Cs Csᵀ/(r−1) + diag(pad) + 1e-5·I,
where ``pad`` puts 1 on the not-yet-selected diagonal slots, so the padded
inverse is block-diagonal and the conditional-variance quadratic form is
exact.  The inverse is ``torch.linalg.inv_ex`` (no host check), with
``jnp.linalg.inv``'s behavior on a singular matrix: no exception.

Kept from the JAX package: the deterministic 1e-5 diagonal jitter (the
reference adds random noise) and the verbose table's fix of the
reference's global-vs-masked indexing.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.device import as_tensor, to_numpy_once


def _nanvar_max(Ur: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``nanmax(var(where(mask, Ur, nan), ddof=1, axis=1))``: the largest
    row variance over the rows the mask keeps, ignoring NaN variances
    (NaN when every kept variance is NaN, or no row is kept)."""
    var = torch.var(Ur, dim=1, correction=1)
    nan = torch.full((), float("nan"), dtype=var.dtype, device=var.device)
    var = torch.where(mask, var, nan)
    ok = ~torch.isnan(var)
    top = torch.amax(torch.where(ok, var, float("-inf")))
    return torch.where(torch.any(ok), top, nan)


def _gem_select(Ur, xyz, mask, d_min, n_sensors: int):
    """The selection on the device: (selected int32 (s,), step scores (s,),
    running entropy (s,), σ²_y per row (n,))."""
    n, r = Ur.shape
    dtype, dev = Ur.dtype, Ur.device

    coef = 2.0 / torch.sqrt(_nanvar_max(Ur, mask))
    Ur_scl = Ur * coef
    row_mean = torch.mean(Ur_scl, dim=1, keepdim=True)
    Uc = Ur_scl - row_mean                     # row-centered (np.cov style)
    sigma2y_all = torch.sum(Uc * Uc, dim=1) / (r - 1)
    sigma_coef = torch.var(Ur_scl, dim=1, correction=1)

    neg_inf = torch.full((), float("-inf"), dtype=dtype, device=dev)
    log2pi1 = 0.5 * (math.log(2 * math.pi) + 1.0)
    slot = torch.arange(n_sensors, device=dev)
    eye = torch.eye(n_sensors, dtype=dtype, device=dev)

    alive = mask.clone()
    Cs = torch.zeros((n_sensors, r), dtype=dtype, device=dev)
    selected = torch.zeros((n_sensors,), dtype=torch.int32, device=dev)
    H_tot = torch.zeros((), dtype=dtype, device=dev)
    step_scores = torch.zeros((n_sensors,), dtype=dtype, device=dev)
    step_H = torch.zeros((n_sensors,), dtype=dtype, device=dev)
    for s in range(n_sensors):
        if s == 0:
            scores = torch.where(alive, sigma_coef, neg_inf)
            is_later = 0.0
        else:
            pad = (slot >= s).to(dtype)
            Sigma_aa = Cs @ Cs.T / (r - 1) + torch.diag(pad) + 1e-5 * eye
            Sigma_aa_inv = torch.linalg.inv_ex(Sigma_aa)[0]
            Sigma_ya = Uc @ Cs.T / (r - 1)
            quad = torch.sum((Sigma_ya @ Sigma_aa_inv) * Sigma_ya, dim=1)
            scores = torch.where(alive, sigma2y_all - quad, neg_inf)
            is_later = 1.0
        i = torch.argmax(scores).reshape(1)    # stays on the device
        best = scores.index_select(0, i)[0]
        H_tot = H_tot + is_later * (0.5 * torch.log(best) + log2pi1)
        Cs[s] = Uc.index_select(0, i)[0]
        selected[s:s + 1] = i.to(torch.int32)
        step_scores[s] = best
        step_H[s] = H_tot
        d = torch.linalg.vector_norm(xyz - xyz.index_select(0, i), dim=1)
        alive = alive & (d >= d_min)
    return selected, step_scores, step_H, sigma_coef


def gem_select(Ur, xyz_tiled, n_sensors: int, mask=None, d_min: float = 0.0,
               verbose: bool = False) -> np.ndarray:
    """Select sensor rows of Ur by greedy conditional-entropy maximization.

    ``Ur`` (n, r) basis tensor; ``xyz_tiled`` (n, 3) positions, tiled by
    feature to match Ur's rows; ``mask`` optional (n,) bool search region;
    ``d_min`` the minimum inter-sensor distance.  The selection runs on
    Ur's device.  Returns the global row indices, int64 (n_sensors,), on
    the host (read once, with the exhaustion check's step scores)."""
    n = Ur.shape[0]
    dev, dtype = Ur.device, Ur.dtype
    mask_np = (np.ones((n,), dtype=bool) if mask is None
               else np.asarray(mask, dtype=bool))
    xyz = as_tensor(np.asarray(xyz_tiled), dev, dtype=dtype)
    d = torch.tensor(float(d_min), dtype=dtype, device=dev)
    selected, step_scores, step_H, sigma_coef = _gem_select(
        Ur, xyz, as_tensor(mask_np, dev), d, n_sensors)
    # one read: the verbose table needs σ²_y of every row as well
    wanted = (selected, step_scores, step_H) + ((sigma_coef,) if verbose
                                                 else ())
    got = to_numpy_once(*wanted)
    selected = got[0].astype(np.int64)
    scores = got[1]
    if not np.all(np.isfinite(scores)):
        bad = int(np.argmax(~np.isfinite(scores)))
        raise ValueError(
            f"GEM ran out of candidates at sensor {bad + 1}/{n_sensors}: "
            f"the d_min={float(d_min)} exclusion (and/or the region mask) "
            "eliminated every remaining location. Reduce d_min, enlarge the "
            "mask, or request fewer sensors.")
    if verbose:
        Hs, sc = got[2], got[3]
        header = ["# sensors", "sigma^2 y", "sigma^2 y|a", "Htot"]
        print(f"{'-'*70} \n {header[0]:^10} {header[1]:^10} "
              f"{header[2]:^10} {header[3]:^10} \n ")
        for s_i in range(n_sensors):
            if s_i == 0:
                print(f"{s_i+1:^10} {sc[selected[s_i]]:^10.2e} "
                      f"{'  -':^10} {'  -':^10}")
            else:
                print(f"{s_i+1:^10} {sc[selected[s_i]]:^10.2e} "
                      f"{scores[s_i]:^10.2e} {Hs[s_i]:^10.2e}")
    return selected
