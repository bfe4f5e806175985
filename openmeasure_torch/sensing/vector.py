"""Vector-measurement sensor selection (port of
``openmeasure_tpu/sensing/vector.py``; Saito et al., arXiv:1906.00778).

A physical probe at spatial point j measures all ``n_features`` quantities
there at once: the p = n_features rows ``f * n_points + j`` of the
snapshot matrix.  The greedy selection picks LOCATIONS, each appending the
whole p-row block U_j ∈ R^{p×r} to Θ = C Ur, by the single-phase
regularized D-optimal score

    score_j = logdet(I_p + U_j (ΘᵀΘ + δI)⁻¹ U_jᵀ).

Numerical structure, as in the JAX package: the selected-block Gram G is
accumulated (PSD additions only); each step takes a fresh Cholesky
A = δI + G = LLᵀ, forms R_j = U_j L⁻ᵀ with one batched (n_points, p, r)
product and scores the batched p×p Cholesky logdet of I_p + R_j R_jᵀ.  δ
is floored at 64·p·eps·max_j‖U_j‖².

The JAX ``lax.fori_loop`` is a Python loop over device tensors with the
argmax on the device; each Cholesky is
:func:`..linalg.chol.cholesky_nan` (NaN where a factorization fails, as
``jnp.linalg.cholesky`` gives, with no host read).  The selection reads
two scalars before its loop (the block energies' mean and max, δ's
inputs, as in the JAX package) and the result once at the end.

The candidate ``mask`` restricts the searchable points without zeroing
the basis (the JAX package's deviation from the 'qr'/'dg' contract).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import DeviceLike, as_tensor, resolve_device, to_numpy_once
from ..linalg.chol import cholesky_nan


def _vdg_select(blocks: torch.Tensor, alive0: torch.Tensor,
                ridge: torch.Tensor, xyz: torch.Tensor, d_min: torch.Tensor,
                n_sensors: int):
    """Greedy regularized-D-optimal selection over per-point blocks
    (n_points, p, r).  Returns (points int32 (n_sensors,), step scores
    (n_sensors,)), on the blocks' device."""
    n_points, p, r = blocks.shape
    dtype, dev = blocks.dtype, blocks.device
    eye_p = torch.eye(p, dtype=dtype, device=dev)
    eye_r = torch.eye(r, dtype=dtype, device=dev)
    G = torch.zeros((r, r), dtype=dtype, device=dev)
    alive = alive0.clone()
    points = torch.zeros((n_sensors,), dtype=torch.int32, device=dev)
    scores = torch.zeros((n_sensors,), dtype=dtype, device=dev)
    for i in range(n_sensors):
        # fresh factorization of A = δI + G (G only accumulates PSD blocks)
        La = cholesky_nan(ridge * eye_r + G)
        Linv = torch.linalg.solve_triangular(La, eye_r, upper=False)
        # logdet(I_p + U_j A⁻¹ U_jᵀ) with R_j = U_j L⁻ᵀ, M_j = R_j R_jᵀ
        T = torch.einsum("npr,sr->nps", blocks, Linv)
        M = torch.einsum("nps,nqs->npq", T, T)
        M = 0.5 * (M + M.transpose(1, 2))          # exact symmetry for chol
        L = cholesky_nan(eye_p[None] + M)
        logdet = 2.0 * torch.sum(
            torch.log(torch.diagonal(L, dim1=1, dim2=2)), dim=1)
        logdet = torch.where(alive, logdet, float("-inf"))
        j = torch.argmax(logdet).reshape(1)
        Bj = blocks.index_select(0, j)[0]                  # (p, r)
        G = G + Bj.T @ Bj
        G = 0.5 * (G + G.T)
        alive = alive.index_fill(0, j, False)
        # minimum inter-probe distance: kill every point within d_min of
        # the new probe
        dist = torch.linalg.vector_norm(xyz - xyz.index_select(0, j), dim=1)
        alive = alive & (dist >= d_min)
        points[i:i + 1] = j.to(torch.int32)
        scores[i:i + 1] = logdet.index_select(0, j)
    return points, scores


def vector_dg_select(Ur, n_features: int, n_sensors: int, mask=None,
                     ridge: float = 1e-6, xyz=None,
                     d_min: float = 0.0) -> np.ndarray:
    """Select ``n_sensors`` spatial POINTS for vector sensors measuring all
    ``n_features`` features at once, on the device of the basis tensor Ur
    (n, r) with feature-blocked rows.

    ``mask``: boolean candidate restriction of length n_points (per point)
    or n (per row; a point stays selectable only if all its feature rows
    are).  ``ridge`` is the relative regularization δ (scaled by the mean
    block energy).  ``xyz`` (n_points, 3) with ``d_min`` enforces a minimum
    inter-probe distance.  Returns int64 (n_sensors,) point indices on the
    host; raises when the mask/d_min exhaust the candidates."""
    n, r = Ur.shape
    if n % n_features != 0:
        raise ValueError("Ur rows are not divisible by n_features.")
    n_points = n // n_features
    dev = Ur.device
    # (n_points, p, r): block j stacks the p feature rows of point j
    blocks = Ur.reshape(n_features, n_points, r).transpose(0, 1)

    if mask is not None:
        m = np.asarray(mask, dtype=bool)
        if m.shape[0] == n:
            m = m.reshape(n_features, n_points).all(axis=0)
        elif m.shape[0] != n_points:
            raise ValueError(
                f"mask must have length n_points={n_points} or n={n}.")
    else:
        m = np.ones((n_points,), dtype=bool)
    n_avail = int(m.sum())
    if n_sensors > n_avail:
        raise ValueError(
            f"vector placement ran out of candidates: {n_sensors} sensors "
            f"requested but only {n_avail} points are selectable "
            "(mask/size). Request fewer sensors or enlarge the mask.")
    if d_min > 0.0:
        if xyz is None:
            raise ValueError("d_min > 0 requires xyz (n_points, 3).")
        xyz_np = np.asarray(xyz, dtype=np.float32)
        if xyz_np.shape[0] != n_points:
            raise ValueError(
                f"xyz must have n_points={n_points} rows; got "
                f"{xyz_np.shape[0]}.")
    else:
        xyz_np = np.zeros((n_points, 3), np.float32)

    # δ relative to the data scale: mean per-block energy / p, floored so
    # that Gram rounding stays well below the identity shift
    block_e = torch.sum(blocks * blocks, dim=(1, 2))
    energy = float(torch.mean(block_e)) / n_features
    eps = float(torch.finfo(blocks.dtype).eps)
    floor = 64.0 * n_features * eps * float(torch.amax(block_e))
    delta = torch.tensor(max(ridge * energy, floor,
                             float(np.finfo(np.float32).tiny)),
                         dtype=blocks.dtype, device=dev)
    points, scores = _vdg_select(
        blocks, as_tensor(m, dev), delta, as_tensor(xyz_np, dev),
        torch.tensor(float(d_min), dtype=torch.float32, device=dev),
        n_sensors)
    out, scores = to_numpy_once(points, scores)
    out = out.astype(np.int64)
    # the step SCORE (-inf exactly on an exhausted step) is the signal;
    # the duplicate check is the backstop
    if not np.isfinite(scores).all() or len(set(out.tolist())) != n_sensors:
        raise ValueError(
            "vector placement ran out of candidates: the mask/d_min "
            "exclusions leave fewer selectable points than sensors "
            "requested.")
    return out


def vector_onehot(points, n_features: int, n_points: int,
                  dtype: torch.dtype = torch.float32,
                  device: DeviceLike = None) -> torch.Tensor:
    """The one-hot measurement matrix C (n_sensors·p, n) of vector sensors
    at ``points``, a tensor on ``device`` (``None`` means the card).

    Row order is sensor-major: row s·p + f measures feature f at points[s]
    (global row f·n_points + points[s]), matching
    :func:`vector_feature_ids`."""
    dev = resolve_device(device)
    points = np.asarray(points, dtype=np.int64)
    s = points.shape[0]
    rows = (np.arange(n_features)[None, :] * n_points
            + points[:, None]).reshape(-1)           # (s*p,)
    C = torch.zeros((s * n_features, n_features * n_points), dtype=dtype,
                    device=dev)
    C[torch.arange(s * n_features, device=dev), as_tensor(rows, dev)] = 1.0
    return C


def vector_feature_ids(n_sensors: int, n_features: int) -> np.ndarray:
    """Feature-id column (s·p,) matching :func:`vector_onehot`'s rows."""
    return np.tile(np.arange(n_features), n_sensors).astype(np.float64)
