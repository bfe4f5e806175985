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
import torch.distributed as dist

from ..core.device import as_tensor, to_numpy_once
from ..parallel._comm import active, axis_of, local_gidx, pick, take_rows


def _nanvar_max(Ur: torch.Tensor, mask: torch.Tensor,
                axis=None) -> torch.Tensor:
    """``nanmax(var(where(mask, Ur, nan), ddof=1, axis=1))``: the largest
    row variance over the rows the mask keeps, ignoring NaN variances
    (NaN when every kept variance is NaN, or no row is kept).  With
    ``axis`` the rows are sharded and the maximum and the "any kept"
    flag are all-reduced."""
    var = torch.var(Ur, dim=1, correction=1)
    nan = torch.full((), float("nan"), dtype=var.dtype, device=var.device)
    var = torch.where(mask, var, nan)
    ok = ~torch.isnan(var)
    top = torch.amax(torch.where(ok, var, float("-inf")))
    if axis is None:
        return torch.where(torch.any(ok), top, nan)
    top, any_ok = axis.max(torch.stack([top, torch.any(ok).to(top.dtype)]))
    return torch.where(any_ok > 0, top, nan)


def _gem_select(Ur, xyz, mask, d_min, n_sensors: int, axis=None,
                gidx=None):
    """The selection on the device: (selected int32 (s,), step scores (s,),
    running entropy (s,), σ²_y per row (n,)).

    With ``axis`` (several ranks) ``Ur``, ``xyz`` and ``mask`` are this
    rank's rows, ``gidx`` their global indices: the scores stay
    row-local, each step's argmax and selected row come from
    :func:`..parallel._comm.pick`, and the selection is global; σ²_y is
    this rank's rows'."""
    n, r = Ur.shape
    dtype, dev = Ur.dtype, Ur.device

    coef = 2.0 / torch.sqrt(_nanvar_max(Ur, mask, axis))
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
        # the argmax and the selected rows stay on the device
        i, best, (c_row, x_row) = pick(axis, scores, gidx, Uc, xyz)
        H_tot = H_tot + is_later * (0.5 * torch.log(best) + log2pi1)
        Cs[s] = c_row
        selected[s:s + 1] = i.to(torch.int32)
        step_scores[s] = best
        step_H[s] = H_tot
        d = torch.linalg.vector_norm(xyz - x_row, dim=1)
        alive = alive & (d >= d_min)
    return selected, step_scores, step_H, sigma_coef


def gem_select(Ur, xyz_tiled, n_sensors: int, mask=None, d_min: float = 0.0,
               verbose: bool = False, mesh=None, gidx=None) -> np.ndarray:
    """Select sensor rows of Ur by greedy conditional-entropy maximization.

    ``Ur`` (n, r) basis tensor; ``xyz_tiled`` (n, 3) positions, tiled by
    feature to match Ur's rows; ``mask`` optional (n,) bool search region;
    ``d_min`` the minimum inter-sensor distance.  The selection runs on
    Ur's device.  Returns the global row indices, int64 (n_sensors,), on
    the host (read once, with the exhaustion check's step scores).

    With ``mesh`` Ur's rows are sharded over its ``state`` axis: ``Ur``,
    ``xyz_tiled`` and ``mask`` are this rank's rows and ``gidx`` their
    global indices (default: the ranks' blocks in rank order); the indices
    returned are global, the same on every rank.  The verbose table takes
    σ²_y of the selected rows from their owners (one all-gather) in the
    same single read, and the world's rank 0 prints it."""
    axis = active(axis_of(mesh))
    if axis is not None and gidx is None:
        gidx = local_gidx(axis, Ur.shape[0], Ur.device)
    n = Ur.shape[0]
    dev, dtype = Ur.device, Ur.dtype
    mask_np = (np.ones((n,), dtype=bool) if mask is None
               else np.asarray(mask, dtype=bool))
    xyz = as_tensor(np.asarray(xyz_tiled), dev, dtype=dtype)
    d = torch.tensor(float(d_min), dtype=dtype, device=dev)
    selected, step_scores, step_H, sigma_coef = _gem_select(
        Ur, xyz, as_tensor(mask_np, dev), d, n_sensors, axis, gidx)
    # one read: the verbose table needs σ²_y of the selected rows as well
    # (every row's on one rank, the selected rows' from their owners on
    # several)
    if verbose and axis is not None:
        sigma_coef = take_rows(axis, sigma_coef, gidx, selected)
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
    if verbose and (axis is None or dist.get_rank() == 0):
        Hs = got[2]
        # σ²_y of the s-th selected row
        sc = got[3][selected] if axis is None else got[3]
        header = ["# sensors", "sigma^2 y", "sigma^2 y|a", "Htot"]
        print(f"{'-'*70} \n {header[0]:^10} {header[1]:^10} "
              f"{header[2]:^10} {header[3]:^10} \n ")
        for s_i in range(n_sensors):
            if s_i == 0:
                print(f"{s_i+1:^10} {sc[s_i]:^10.2e} "
                      f"{'  -':^10} {'  -':^10}")
            else:
                print(f"{s_i+1:^10} {sc[s_i]:^10.2e} "
                      f"{scores[s_i]:^10.2e} {Hs[s_i]:^10.2e}")
    return selected
