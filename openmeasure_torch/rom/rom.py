"""Reduced-order-model core: the ``ROM`` class (port of
``openmeasure_tpu/rom/rom.py``, the slice the SPR soft-sensing flow uses).

Public attributes mirror the JAX package: ``X_cnt, X_scl, X0, Ur, Ar, Vr,
Sigma_r, r`` — torch tensors on the model's device.  ``X`` keeps whatever
the caller passed (numpy array or tensor).

``CPOD`` solves all m per-snapshot box-constrained projections as one
batched ADMM box-QP (:mod:`..linalg.boxls`).  ``adaptive_sampling`` keeps
the JAX package's deviation from the reference: the leave-one-out
influence uses the intended rank-1 projector, and the sampling call does
not overwrite the fitted scaling statistics.

``update_basis`` folds new snapshots into the basis by Brand's
rank-additive SVD update (:mod:`..linalg.incremental`): narrow panel
passes on the model's device around a float64 core SVD on the host, with
the scaling statistics frozen.

A measurement operator (``apply_sampling``, ``reconstruct(sampling=…)``,
``SPR.train``) may be dense (a numpy array or tensor), ``scipy.sparse``, or
a torch sparse COO or CSR tensor, the port's counterpart of the JAX
package's BCOO: its product runs on the model's device.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import scipy.sparse as sp
import torch

from ..core import scaling as _scaling
from ..core.device import DeviceLike, as_tensor, resolve_device, to_numpy
from ..linalg import boxls as _boxls
from ..linalg import svd as _svd
from ..parallel._comm import active, axis_of


def is_torch_sparse(x) -> bool:
    """True for a torch sparse COO or CSR tensor."""
    return isinstance(x, torch.Tensor) and x.layout in (torch.sparse_coo,
                                                        torch.sparse_csr)


def torch_sparse_to_scipy(C) -> sp.csr_matrix:
    """Host float64 ``scipy.sparse`` copy of a torch sparse COO or CSR
    tensor, duplicate entries summed and explicit zeros dropped."""
    if C.layout == torch.sparse_csr:
        out = sp.csr_matrix((to_numpy(C.values()).astype(np.float64),
                             to_numpy(C.col_indices()),
                             to_numpy(C.crow_indices())), shape=tuple(C.shape))
    else:
        C = C.coalesce()
        idx = to_numpy(C.indices())
        out = sp.csr_matrix((to_numpy(C.values()).astype(np.float64),
                             (idx[0], idx[1])), shape=tuple(C.shape))
    out.sum_duplicates()
    out.eliminate_zeros()
    return out


def apply_sampling(sampling, M: torch.Tensor) -> torch.Tensor:
    """Apply a measurement/sampling operator to an (n, ...) tensor.

    ``sampling`` may be dense (numpy array or tensor), a ``scipy.sparse``
    matrix (its product runs on the host, as in the JAX package, and the
    result lands on M's device), or a torch sparse COO or CSR tensor (its
    product runs on M's device, in M's dtype)."""
    if sp.issparse(sampling):
        return as_tensor(sampling.dot(to_numpy(M)), M.device)
    if is_torch_sparse(sampling):
        S = sampling.to(device=M.device, dtype=M.dtype)
        if M.ndim == 1:
            return (S @ M[:, None])[:, 0]
        return S @ M
    S = as_tensor(sampling, M.device)
    if S.dtype != M.dtype:
        S = S.to(M.dtype)
    return S @ M


def scale_measurement_values(y, cnt_vector, scl_full, n_points):
    """Value-column measurement scaling (host numpy): each measurement's
    scale is the feature-block scalar ``X_scl[feature_id * n_points]``, its
    centering the precomputed ``C @ X_cnt``.  Returns ``(scaled_values,
    scl_vector)``."""
    y = np.asarray(y)
    scl_vector = np.asarray(scl_full)[y[:, 2].astype(int) * n_points]
    return (y[:, 0] - cnt_vector) / scl_vector, scl_vector


def influence_candidate(S: torch.Tensor, V: torch.Tensor, P, seed=None):
    """The DoE step of ``adaptive_sampling`` from a spectrum: ``S`` (p,)
    singular values and ``V`` (p, p) right singular vectors (columns) of
    the scaled snapshots.  Leave-one-out influence of each snapshot ×
    distance of Latin-hypercube candidates to the nearest sampled point;
    returns the candidate (d,) of largest potential."""
    from scipy.stats import qmc

    p = V.shape[0]
    eye = torch.eye(p, dtype=S.dtype, device=S.device)

    def influence(ks):
        v = V[:, ks].T                                   # (k, p)
        M = S[:, None] * (eye - v[:, :, None] * v[:, None, :])
        Un = torch.linalg.svd(M, full_matrices=False)[0]
        inf_ui = 1.0 / torch.abs(torch.diagonal(Un, dim1=-2,
                                                dim2=-1)) - 1.0
        return torch.sum(S * inf_ui, dim=-1)

    # batched (p, p) workspaces are O(p³) memory: at most 64 snapshots
    # per batch
    ks = torch.arange(p, device=S.device)
    inf_basis = torch.cat([influence(ks[k:k + 64])
                           for k in range(0, p, 64)])
    inf_rel = to_numpy(inf_basis / torch.sum(inf_basis))

    P = np.asarray(P)
    n_dim = P.shape[1]
    sampler = qmc.LatinHypercube(d=n_dim, seed=seed)
    q = 100 * n_dim
    sample0 = sampler.random(n=q)
    span = P.max(axis=0) - P.min(axis=0)
    sample = span[None, :] * sample0 + P.min(axis=0)[None, :]

    dist = np.linalg.norm(sample[:, None, :] - P[None, :, :], axis=2)
    j = np.argmin(dist, axis=1)
    pot = dist[np.arange(q), j] * inf_rel[j]
    return sample[np.argmax(pot), :]


class ROM:
    """Reduced-order model over a feature-blocked snapshot matrix.

    X : numpy array or tensor (n, m), n = n_features * n_points
    n_features : int
    xyz : array (n_points, 3)
    device : where the model's tensors live (``None`` means the card)
    """

    def __init__(self, X, n_features, xyz, device: DeviceLike = None):
        if not isinstance(X, (np.ndarray, torch.Tensor)):
            raise TypeError("The matrix X is not a numpy array.")
        if type(n_features) is not int:
            # `type(...) is not int`: bool must NOT pass as a feature count
            raise TypeError("The parameter n_features is not an integer.")
        self.device = resolve_device(device)
        self.X = X
        self.n_features = n_features
        self.xyz = xyz
        n = X.shape[0]
        self.n_points = n // n_features
        if n % n_features != 0:
            raise Exception("The number of rows of X is not a multiple of n_features")

    def _t(self, x) -> torch.Tensor:
        return as_tensor(x, self.device)

    # ------------------------------------------------------------------ #
    # Scaling
    # ------------------------------------------------------------------ #

    def scale_data(self, scale_type: str = "std", axis_cnt: Optional[int] = 1):
        X = self._t(self.X)
        X0, X_cnt, X_scl = _scaling.scale_data(X, self.n_features,
                                               scale_type, axis_cnt)
        # Dead-block guard (the JAX package's documented deviation from the
        # reference): a constant feature block gives a zero or round-off
        # scale under the spread-based types, and value-based types can hit
        # exact zeros; dividing by it silently poisons the whole fit, so
        # raise with the offending feature ids.  Constancy is tested
        # directly (block max == min), since a constant block's statistic
        # can land at eps-level instead of exact zero.
        scl_blocks = to_numpy(X_scl[:: self.n_points, 0])
        bad = ~(np.isfinite(scl_blocks) & (scl_blocks != 0))
        if scale_type in ("std", "pareto", "range", "variance",
                          "vast", "vast_2", "vast_3", "vast_4"):
            Xb = X.reshape(self.n_features, self.n_points, -1)
            spread = to_numpy(torch.amax(Xb, dim=(1, 2))
                              - torch.amin(Xb, dim=(1, 2)))
            bad |= spread == 0
        bad_idx = np.flatnonzero(bad)
        if bad_idx.size:
            raise ValueError(
                f"scale_data(scale_type={scale_type!r}): feature block(s) "
                f"{bad_idx.tolist()} are constant (dead channel) or have "
                f"a zero/non-finite scale factor "
                f"(values {scl_blocks[bad_idx].tolist()}). Dividing by it "
                "would silently corrupt the whole fit; drop or repair "
                "those features, or use scale_type='none'.")
        self.X_cnt = X_cnt
        self.X_scl = X_scl
        # new statistics invalidate SPR's cached C @ X_cnt, host copy of
        # the scales and COLS constraint set
        self._cnt_vector_cache = None
        self._scl_vector_cache = None
        self._cols_cache = None
        return X0

    def scale_limits(self, limits: Sequence):
        """``limits = [mins, maxs]`` with per-feature ``(n_features,)``
        arrays; a scalar broadcasts to every feature."""
        def as_feature_vec(b, name):
            arr = torch.atleast_1d(as_tensor(b, self.device,
                                             dtype=self.X_cnt.dtype))
            if arr.numel() == 1:
                return arr.reshape(()).expand(self.n_features)
            if tuple(arr.shape) != (self.n_features,):
                raise ValueError(
                    f"limits {name} must be a scalar or an "
                    f"(n_features,) = ({self.n_features},) array; got "
                    f"shape {tuple(arr.shape)}.")
            return arr
        lo, hi = _scaling.scale_limits(
            as_feature_vec(limits[0], "min"),
            as_feature_vec(limits[1], "max"),
            self.X_cnt, self.X_scl, self.n_features)
        return [lo, hi]

    def _shard_axis(self):
        """This rank's view of the basis: ``(mesh, axis of several ranks or
        None, global indices of its rows, (first, stop))``; an unsharded
        fit is ``(None, None, None, (0, n))``, and a fit on a mesh whose
        axis has one rank keeps the mesh and holds every row."""
        mesh = getattr(self, "fit_mesh_", None)
        if mesh is None:
            return None, None, None, (0, self.Ur.shape[0])
        a, b = getattr(self, "_shard_rows", (0, self.Ur.shape[0]))
        axis = active(axis_of(mesh, self._mesh_axis))
        gidx = torch.arange(a, b, dtype=torch.int64, device=self.device)
        return mesh, axis, gidx, (a, b)

    _mesh_axis = "state"       # the mesh axis a sharded fit splits rows over

    def _scale_limit_rows(self, limits: Sequence, dtype: torch.dtype):
        """:meth:`scale_limits` for this rank's rows of a fit sharded over
        several ranks, in ``dtype``: the per-feature ±1000 test reduces
        its block extrema over the ranks."""
        from ..parallel.sharded import _scale_limits_rows
        _, axis, gidx, _ = self._shard_axis()

        def as_feature_vec(b):
            return np.broadcast_to(np.asarray(b, np.float64),
                                   (self.n_features,))
        return _scale_limits_rows(
            as_feature_vec(limits[0]), as_feature_vec(limits[1]),
            self.X_cnt[:, 0].to(dtype), self.X_scl[:, 0].to(dtype),
            gidx // self.n_points, self.n_features, axis)

    def unscale_data(self, x0, sampling=None):
        x0 = self._t(x0)
        if sampling is None:
            return _scaling.unscale_data(x0, self.X_cnt, self.X_scl)
        scl = apply_sampling(sampling, self.X_scl[:, 0])
        cnt = apply_sampling(sampling, self.X_cnt[:, 0])
        if x0.ndim == 1:
            return scl * x0 + cnt
        return scl[:, None] * x0 + cnt[:, None]

    # ------------------------------------------------------------------ #
    # Decomposition
    # ------------------------------------------------------------------ #

    def decomposition(self, X0, select_modes: str = "variance", n_modes=99):
        """Thin POD of the scaled snapshots.  Returns (Ur, Ar,
        exp_variance[:r]); ``A = (diag(S) Vt)ᵀ``."""
        X0 = self._t(X0)
        U, S, Vt = _svd.svd_tall_safe(X0)
        A = (S[:, None] * Vt).T
        exp_variance = _svd.explained_variance(S)
        Ur, Ar = self.reduction(U, A, exp_variance, select_modes, n_modes)
        r = Ar.shape[1]
        return Ur, Ar, exp_variance[:r]

    def reduction(self, U, A, exp_variance, select_modes, n_modes):
        r = _svd.select_rank(exp_variance, select_modes, n_modes, A.shape[1])
        self.r = r
        return self._t(U)[:, :r], self._t(A)[:, :r]

    # ------------------------------------------------------------------ #
    # Fit / reconstruct
    # ------------------------------------------------------------------ #

    def fit(self, scale_type: str = "std", axis_cnt: Optional[int] = 1,
            select_modes: str = "variance", n_modes=99, basis=None,
            config=None):
        """``config`` (:class:`openmeasure_torch.core.config.FitConfig`)
        overrides the individual kwargs when given; ``basis=(Ur, Ar)``
        skips the decomposition."""
        if config is not None:
            scale_type = config.scale_type
            axis_cnt = config.axis_cnt
            select_modes = config.select_modes
            n_modes = config.n_modes
        self.scale_type = scale_type
        self.X0 = self.scale_data(scale_type, axis_cnt)
        if basis is None:
            Ur, Ar, _ = self.decomposition(self.X0, select_modes, n_modes)
        else:
            Ur, Ar = self._t(basis[0]), self._t(basis[1])

        self.Ur = Ur
        self.Ar = Ar
        self.r = Ar.shape[1]

        Sigma_r = torch.linalg.vector_norm(Ar, dim=0)
        self.Vr = Ar / Sigma_r[None, :]
        self.Sigma_r = Sigma_r
        self._invalidate_trained_state()

    def _invalidate_trained_state(self):
        """Hook run at the end of every (re)fit: subclasses holding trained
        state derived from the basis drop it here."""

    def reconstruct(self, Ar, sampling=None):
        """``X_rec = Ur @ Arᵀ`` (optionally sampled), unscaled
        column-wise.  ``Ar`` takes the basis's dtype (a host-float64
        ``GPR`` prediction meets an fp32 basis here, as the JAX package
        rounds it with x64 off)."""
        Ar = as_tensor(Ar, self.device, dtype=self.Ur.dtype)
        if Ar.ndim < 2:
            Ar = Ar[None, :]
        if sampling is not None:
            SUr = apply_sampling(sampling, self.Ur)
            return self.unscale_data(SUr @ Ar.T, sampling)
        return _scaling.unscale_data(self.Ur @ Ar.T, self.X_cnt, self.X_scl)

    # ------------------------------------------------------------------ #
    # CPOD
    # ------------------------------------------------------------------ #

    def CPOD(self, limits=None, solver_fn=None, max_iter: int = 4000,
             tol: float = 1e-9, over_relax: float = 1.6, solver_config=None,
             constraints=None):
        """Constrained POD: per snapshot i solve
        ``min ‖Ur g − x0_i‖²  s.t. limits0[0] ≤ Ur g ≤ limits0[1]`` and
        replace ``Ar ← G``, ``Vr ← G / Σ_r``.  Call after :meth:`fit`.

        All m snapshots solve as one batched ADMM box-QP.  ``constraints``
        (a :class:`..linalg.boxls.LinearConstraints`, a raw (A, lo, hi)
        triple or a list of either, in scaled coefficient space; ``lo``/``hi``
        may carry a per-snapshot leading axis) composes with ``limits``.
        ``solver_config`` (:class:`..core.config.SolverConfig`) overrides
        max_iter/tol/over_relax.  ``solver_fn(Ur, x0_i, g_init) -> g`` is the
        escape hatch for nonlinear constraint sets, called per snapshot on
        the host; ``self.admm_info`` is then None."""
        if solver_config is not None:
            max_iter = solver_config.max_iter
            tol = solver_config.tol
            over_relax = solver_config.over_relax
        if solver_fn is not None:
            Gr = np.zeros_like(to_numpy(self.Ar))
            for i in range(Gr.shape[0]):
                Gr[i, :] = to_numpy(solver_fn(self.Ur, self.X0[:, i],
                                              self.Ar[i, :]))
            Gr = self._t(Gr)
            self.admm_info = None
        else:
            Ur = self.Ur
            # UrᵀUr is I only for an unmasked orthonormal basis
            H = Ur.T @ Ur
            box = None
            if limits is not None:
                lo_b, hi_b = self.scale_limits(limits)
                box = (Ur, lo_b, hi_b)
            cs, box_only = _boxls.build_constraint_set(constraints, box)
            if cs is None:
                raise ValueError(
                    "CPOD requires `limits`, `constraints`, or a solver_fn.")
            lo, hi = (as_tensor(x, self.device, dtype=Ur.dtype)
                      for x in (cs.lo, cs.hi))
            if box_only:
                A_c, AtA = Ur, H                 # reuse the Ur Gram
            else:
                A_c = as_tensor(cs.A, self.device, dtype=Ur.dtype)
                AtA = A_c.T @ A_c
            Gr, info = _boxls.admm_box_qp(
                H, self.X0.T @ Ur, A_c, lo, hi, AtA=AtA, max_iter=max_iter,
                tol=tol, over_relax=over_relax)
            # per-snapshot diagnostics: a primal residual far above tol after
            # the full budget flags an infeasible set
            self.admm_info = info
        self.Ar = Gr
        self.Vr = Gr / self.Sigma_r[None, :]

    # ------------------------------------------------------------------ #
    # Adaptive sampling
    # ------------------------------------------------------------------ #

    def adaptive_sampling(self, P, scale_type: str = "std", seed=None):
        """DoE enrichment: leave-one-snapshot-out SVD influence × Latin
        hypercube candidate distance; returns the candidate parameter point
        (d,) of largest potential.

        The influence of snapshot k uses the rank-1 projector ``I − v_k
        v_kᵀ`` (the JAX package's deviation: the reference's literal scalar
        product ``Vt[k,:] @ V[k,:]`` is a bug).  The snapshots are scaled
        with ``scale_type`` by the module-level function, leaving the fitted
        statistics alone.  ``svd_tall`` runs at its default refine depth for
        the model's device.  The candidates come from
        ``scipy.stats.qmc.LatinHypercube(seed=seed)`` on the host."""
        X0, _, _ = _scaling.scale_data(self._t(self.X), self.n_features,
                                       scale_type, 1)
        _, S, Vt = _svd.svd_tall(X0)
        return influence_candidate(S, Vt.T, P, seed)

    # ------------------------------------------------------------------ #
    # Incremental basis update
    # ------------------------------------------------------------------ #

    def update_basis(self, X_new, select_modes: str = "number",
                     n_modes=None, reorth: bool = True):
        """Append new snapshots ``X_new`` (n, q) or (n,) and update the POD
        basis incrementally by Brand's rank-additive SVD update
        (:func:`..linalg.incremental.svd_append_columns_eager`): narrow
        (n, r+q) panel passes on the model's device and a float64 core SVD
        on the host, with no re-read of the original snapshots.  It is
        exact (to round-off) for the rank-r matrix the current
        factorization represents.

        * The scaling statistics are frozen: ``X_new`` is scaled with the
          statistics of :meth:`fit`.
        * ``n_modes=None`` keeps the rank r; otherwise ``select_modes`` and
          ``n_modes`` choose as in :meth:`fit` (``'variance'`` over the
          retained energy only).
        * Call it after :meth:`fit`: after :meth:`CPOD` the coefficients are
          constrained projections, not ``V diag(S)``, and the update would
          discard that.

        Updates ``X, X0, Ur, Ar, Vr, Sigma_r, r`` in place."""
        if not hasattr(self, "Ur"):
            raise AttributeError(
                "The fit function has to be called before update_basis.")
        if not isinstance(X_new, torch.Tensor):
            X_new = np.asarray(X_new)
        if X_new.ndim == 1:
            X_new = X_new[:, None]
        if X_new.shape[0] != self.X.shape[0]:
            raise ValueError(
                f"X_new has {X_new.shape[0]} rows; expected "
                f"{self.X.shape[0]} (the fitted snapshot dimension).")

        Xn = self._t(X_new).to(self.Ur.dtype)
        X0n = (Xn - self.X_cnt) / self.X_scl
        self._update_basis_core(X0n, select_modes, n_modes, reorth)

        if isinstance(self.X, np.ndarray):
            self.X = np.concatenate([self.X, to_numpy(X_new)], axis=1)
        else:
            self.X = torch.cat([self.X, Xn.to(device=self.X.device,
                                              dtype=self.X.dtype)], dim=1)
        if hasattr(self, "X0"):
            self.X0 = torch.cat([self.X0, X0n], dim=1)

    def _update_basis_core(self, X0n, select_modes, n_modes, reorth):
        """Brand update of (Ur, Sigma_r, Vr) with the scaled columns X0n,
        rank selection, attribute writes.  On a fit sharded over several
        ranks (``fit(mesh=...)`` of the streaming classes) ``Ur`` and X0n
        are this rank's rows and the update is the CholQR form
        (:func:`..linalg.incremental.svd_append_columns_cholqr`), whose
        (r, q) projections and (q, q) Gram are all-reduced and whose core
        is replicated, so the rank rule below takes the same branch on
        every rank; otherwise the Householder form with the float64 host
        core (:func:`..linalg.incremental.svd_append_columns_eager`)."""
        from ..linalg import incremental as _inc
        mesh, axis, _, _ = self._shard_axis()
        if axis is None:
            U2, S2, Vt2 = _inc.svd_append_columns_eager(
                self.Ur, self.Sigma_r, self.Vr.T, X0n, reorth=reorth)
        else:
            U2, S2, Vt2 = _inc.svd_append_columns_cholqr(
                self.Ur, self.Sigma_r, self.Vr.T, X0n, reorth=reorth,
                mesh=mesh, mesh_axis=self._mesh_axis)
        if n_modes is None:
            r_new = min(self.r, S2.shape[0])
        else:
            exp_var = _svd.explained_variance(S2)
            r_new = _svd.select_rank(exp_var, select_modes, n_modes,
                                     S2.shape[0])
        self.r = r_new
        self.Ur = U2[:, :r_new]
        self.Sigma_r = S2[:r_new]
        self.Vr = Vt2.T[:, :r_new]
        self.Ar = self.Vr * self.Sigma_r[None, :]
