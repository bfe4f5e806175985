"""Feature-block data scaling (port of ``openmeasure_tpu.core.scaling``).

The snapshot matrix ``X`` has shape ``(n, m)`` with ``n = n_features *
n_points`` rows laid out in contiguous feature blocks.  Every statistic is a
reduction over dims (1, 2) of the ``(n_features, n_points, m)`` view — the
JAX package's ``jax.vmap`` over feature blocks written out as a batch
dimension (porting trap 10).

Scale types (14): ``std``, ``none``, ``pareto``, ``vast``, ``range``,
``level``, ``max``, ``variance``, ``median``, ``poisson``, ``vast_2``,
``vast_3``, ``vast_4``, ``l2-norm``.

Porting traps handled here, each named where it is handled:

1. ``torch.std``/``torch.var`` default to Bessel's correction; ``jnp.std``
   and ``jnp.var`` do not — every call passes ``correction=0``.
2. ``torch.median`` returns the LOWER middle value; ``jnp.median`` the mean
   of the two middle values — :func:`_block_median` sorts and averages.
   (``torch.quantile`` refuses inputs above 2²⁴ elements, so it is not
   used.)
3. Kurtosis is Fisher (excess) and biased, over the flattened block, as in
   the JAX package (see its module docstring for why not ``axis=0``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

SCALE_TYPES = (
    "std", "none", "pareto", "vast", "range", "level", "max",
    "variance", "median", "poisson", "vast_2", "vast_3", "vast_4",
    "l2-norm",
)


def _flat(Xb: torch.Tensor) -> torch.Tensor:
    """(F, ...) blocks → (F, block_size)."""
    return Xb.reshape(Xb.shape[0], -1)


def _std(x: torch.Tensor) -> torch.Tensor:
    # porting trap 1: population std (jnp.std), not Bessel-corrected
    return torch.std(x, dim=1, correction=0)


def _block_median(x: torch.Tensor) -> torch.Tensor:
    # porting trap 2: jnp.median is the MEAN of the two middle values for
    # an even count (computed as (lo + hi) * 0.5, like jnp's 'midpoint');
    # torch.median would return the lower one
    s = torch.sort(x, dim=1).values
    c = x.shape[1]
    lo = s[:, (c - 1) // 2]
    hi = s[:, c // 2]
    return (lo + hi) * 0.5


def _excess_kurtosis(x: torch.Tensor) -> torch.Tensor:
    # porting trap 3: Fisher (excess), biased, over each flattened block
    # (scipy.stats.kurtosis(x, axis=None))
    d = x - torch.mean(x, dim=1, keepdim=True)
    m2 = torch.mean(d * d, dim=1)
    m4 = torch.mean((d * d) ** 2, dim=1)
    return m4 / (m2 * m2) - 3.0


def _block_scale_factor(Xb: torch.Tensor, scale_type: str) -> torch.Tensor:
    """Scale factor of each feature block: ``Xb`` is ``(F, n_points, m)``,
    the result ``(F,)``."""
    x = _flat(Xb)
    if scale_type == "std":
        return _std(x)
    if scale_type == "none":
        return torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
    if scale_type == "pareto":
        return torch.sqrt(_std(x))
    if scale_type == "vast":
        return _std(x) ** 2 / torch.mean(x, dim=1)
    if scale_type == "range":
        return torch.amax(x, dim=1) - torch.amin(x, dim=1)
    if scale_type == "level":
        return torch.mean(x, dim=1)
    if scale_type == "max":
        return torch.amax(x, dim=1)
    if scale_type == "variance":
        return torch.var(x, dim=1, correction=0)     # porting trap 1
    if scale_type == "median":
        return _block_median(x)
    if scale_type == "poisson":
        return torch.sqrt(torch.mean(x, dim=1))
    if scale_type == "vast_2":
        return _std(x) ** 2 * _excess_kurtosis(x) ** 2 / torch.mean(x, dim=1)
    if scale_type == "vast_3":
        return _std(x) ** 2 * _excess_kurtosis(x) ** 2 / torch.amax(x, dim=1)
    if scale_type == "vast_4":
        return (_std(x) ** 2 * _excess_kurtosis(x) ** 2
                / (torch.amax(x, dim=1) - torch.amin(x, dim=1)))
    if scale_type == "l2-norm":
        return torch.linalg.vector_norm(x, dim=1)
    raise NotImplementedError(
        "The scaling method selected has not been implemented yet")


def scale_data(
    X: torch.Tensor,
    n_features: int,
    scale_type: str = "std",
    axis_cnt: Optional[int] = 1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Center and scale the snapshot matrix.

    Returns ``(X0, X_cnt, X_scl)`` where ``X_cnt`` / ``X_scl`` have shape
    ``(n, 1)`` and ``X0 = (X - X_cnt) / X_scl``.  ``axis_cnt=1`` centers
    each row by its own mean; ``axis_cnt=None`` centers every row of a
    feature block by the block-wide scalar mean.
    """
    if scale_type not in SCALE_TYPES:
        raise NotImplementedError(
            "The scaling method selected has not been implemented yet")
    n, m = X.shape
    n_points = n // n_features
    Xb = X.reshape(n_features, n_points, m)

    if axis_cnt == 1:
        X_cnt = torch.mean(X, dim=1, keepdim=True)
    elif axis_cnt is None:
        blk_mean = torch.mean(Xb, dim=(1, 2))            # (n_features,)
        # porting trap 10: jnp.repeat(v, n_points) is repeat_interleave
        X_cnt = torch.repeat_interleave(blk_mean, n_points)[:, None]
    else:
        raise ValueError("axis_cnt must be 1 or None")

    scl = _block_scale_factor(Xb, scale_type)
    X_scl = torch.repeat_interleave(scl, n_points)[:, None]

    X0 = (X - X_cnt) / X_scl
    return X0, X_cnt, X_scl


def scale_limits(
    limits_min: torch.Tensor,
    limits_max: torch.Tensor,
    X_cnt: torch.Tensor,
    X_scl: torch.Tensor,
    n_features: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Map per-feature physical bounds to scaled n-vectors, with the JAX
    package's conditioning quirk: if a scaled block exceeds ±1000 anywhere,
    the whole block is replaced by the scalar ∓1000."""
    n = X_cnt.shape[0]
    n_points = n // n_features
    cnt_b = X_cnt[:, 0].reshape(n_features, n_points)
    scl_b = X_scl[:, 0].reshape(n_features, n_points)

    def one_limit(limit):
        limit = torch.as_tensor(limit, dtype=cnt_b.dtype,
                                device=cnt_b.device)
        temp = (limit[:, None] - cnt_b) / scl_b        # (n_features, n_points)
        lo_bad = torch.amin(temp, dim=1, keepdim=True) < -1000.0
        hi_bad = torch.amax(temp, dim=1, keepdim=True) > 1000.0
        temp = torch.where(lo_bad, torch.full_like(temp, -1000.0),
                           torch.where(hi_bad, torch.full_like(temp, 1000.0),
                                       temp))
        return temp.reshape(-1)

    return one_limit(limits_min), one_limit(limits_max)


def unscale_data(x0: torch.Tensor, X_cnt: torch.Tensor,
                 X_scl: torch.Tensor) -> torch.Tensor:
    """``x = X_scl ⊙ x0 + X_cnt``; ``x0`` may be ``(n,)`` or ``(n, k)``."""
    scl = X_scl[:, 0]
    cnt = X_cnt[:, 0]
    if x0.ndim == 1:
        return scl * x0 + cnt
    return scl[:, None] * x0 + cnt[:, None]


def scale_parameters(P: torch.Tensor, scale_type: str = "std"
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-column parameter scaling.  Returns ``(P0, P_cnt, P_scl)`` with
    full-shape ``(p, d)`` broadcast statistics."""
    if scale_type not in SCALE_TYPES:
        raise NotImplementedError(
            "The scaling method selected has not been implemented yet")
    cols = P.T[:, :, None]            # (d, p, 1): each column is a block
    cnt = torch.mean(cols, dim=(1, 2))
    scl = _block_scale_factor(cols, scale_type)
    P_cnt = cnt[None, :].expand(P.shape)
    P_scl = scl[None, :].expand(P.shape)
    P0 = (P - P_cnt) / P_scl
    return P0, P_cnt, P_scl
