"""Sparse Placement for Reconstruction (port of
``openmeasure_tpu/sensing/spr.py``, the QR placement and OLS solve).

* ``optimal_placement('qr')`` → greedy column-pivoted QR of Urᵀ, on the card
  by the CUDA kernel (``linalg.qrcp_cuda``);
* ``predict`` OLS → the weighted gappy-POD least squares, a batched
  float64 pinv on the HOST.  Porting trap 9: that is the JAX package's
  design (the (s, r) systems are tiny but can be ill-conditioned, cond
  ~1e4-1e5 on flame-scale placements, where an fp32 device pinv costs ~5e-4
  field NRMSE), not a device fallback; it is kept exactly.
* ``predict`` COLS → the box-constrained least squares of every
  measurement vector as one batched ADMM on the model's device
  (:mod:`..linalg.boxls`), against the stacked ``limits``/``constraints``
  set, built once per train and cached with its exact operator Gram.

A σ=0 entry inside an otherwise-weighted measurement vector receives the
largest finite weight of that vector (the JAX package's documented
deviation from the reference's literal 1/0).

The other placements: ``'gem'`` (greedy entropy, :mod:`.gem`), ``'dg'``
(D-optimal greedy, :mod:`.dg`, whose phase 1 is the QRCP kernel on the
card) and ``'vdg'`` (vector probes, :mod:`.vector`).  Each returns C as a
tensor on the model's device; the selected indices come back to the host
in one read.

``update_basis`` folds new snapshots into the basis (:meth:`ROM.update_basis`)
and derives Theta again from the stored measurement operator.

The operator C may be dense (numpy or tensor), ``scipy.sparse`` or a torch
sparse COO or CSR tensor (the CTC projections); a torch sparse product runs
on the model's device.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..core.device import as_tensor, to_numpy
from ..linalg import boxls as _boxls
from ..linalg import qrcp as _qrcp
from ..linalg.qrcp_cuda import qrcp_pivots_sharded
from ..parallel._comm import active, axis_of, gather_rows
from ..rom.rom import (ROM, apply_sampling, is_torch_sparse,
                       scale_measurement_values, torch_sparse_to_scipy)
from .dg import dg_select
from .gem import gem_select
from .vector import vector_dg_select, vector_onehot


class SPR(ROM):
    """Sparse placement + gappy-POD reconstruction (constructor as
    :class:`ROM`: ``SPR(X, n_features, xyz, device=None)``)."""

    # ------------------------------------------------------------------ #
    # Measurement scaling
    # ------------------------------------------------------------------ #

    def scale_vector(self, y):
        """Scale a measurement vector y (s, 3) = [value, σ, feature-id] with
        the training statistics.  Returns y0 (s, 2), float64 on the host.

        ``C @ X_cnt`` is constant once trained; :meth:`train` caches it."""
        y = np.asarray(y)
        cnt_vector = getattr(self, "_cnt_vector_cache", None)
        if cnt_vector is None:
            cnt_vector = to_numpy(apply_sampling(self.C, self.X_cnt[:, 0]))
            self._cnt_vector_cache = cnt_vector
        scl_full = getattr(self, "_scl_vector_cache", None)
        if scl_full is None:
            scl_full = to_numpy(self.X_scl[:, 0])
            self._scl_vector_cache = scl_full
        vals, scl_vector = scale_measurement_values(
            y, cnt_vector, scl_full, self.n_points)

        # float64: the host-f64 solve downstream exists to avoid fp32 error
        y0 = np.zeros((y.shape[0], 2), dtype=np.float64)
        y0[:, 0] = vals
        y0[:, 1] = y[:, 1] / scl_vector

        self.cnt_vector = cnt_vector
        self.scl_vector = scl_vector
        return y0

    # ------------------------------------------------------------------ #
    # Placement
    # ------------------------------------------------------------------ #

    def _invalidate_trained_state(self):
        """Refit hook: a new basis orphans the trained ``Theta`` and any
        cached COLS constraint set."""
        if getattr(self, "Theta", None) is not None:
            del self.Theta
            self._needs_retrain = True
        self._cols_cache = None

    def gem(self, Ur, n_sensors, mask, d_min, verbose):
        mesh, _, gidx, (a, b) = self._shard_axis()
        xyz_tiled = np.tile(np.asarray(self.xyz), (self.n_features, 1))[a:b]
        return gem_select(Ur, xyz_tiled, n_sensors, mask, d_min, verbose,
                          mesh=mesh, gidx=gidx)

    def _onehot_rows(self, P, n):
        """One-hot C (len(P), n) in the basis's dtype on its device."""
        C = torch.zeros((P.size, n), dtype=self.Ur.dtype, device=self.device)
        C[torch.arange(P.size, device=self.device),
          as_tensor(P, self.device)] = 1.0
        return C

    def _zero_masked_rows(self, mask):
        keep = as_tensor(np.asarray(mask, dtype=bool), self.device)
        self.Ur = torch.where(keep[:, None], self.Ur,
                              torch.zeros((), dtype=self.Ur.dtype,
                                          device=self.device))

    def optimal_placement(self, calc_type: str = "qr", n_sensors: int = 10,
                          mask=None, d_min: float = 0.0,
                          verbose: bool = False, config=None):
        """The one-hot measurement matrix C (s, n), a tensor on the model's
        device.

        ``calc_type='qr'``: first-r column pivots of Urᵀ (s = r).  A region
        ``mask`` (n,) zeroes the excluded rows of Ur destructively, as in
        the reference.  ``'gem'``: greedy entropy maximization of
        ``n_sensors`` rows at least ``d_min`` apart.  ``'dg'``:
        determinant-based greedy, D-optimal for any ``n_sensors`` (more
        sensors than modes included); the mask zeroes Ur's rows as for
        ``'qr'``.  ``'vdg'``: ``n_sensors`` probes each measuring all
        ``n_features`` at one point (C gets n_sensors·n_features rows,
        sensor-major; ``self.sensor_points`` holds the points); the mask
        restricts the points without zeroing the basis.  ``config``
        (:class:`openmeasure_torch.core.config.PlacementConfig`) overrides
        calc_type/n_sensors/d_min/verbose when given."""
        if config is not None:
            calc_type = config.calc_type
            n_sensors = config.n_sensors
            d_min = config.d_min
            verbose = config.verbose
        n = self.X.shape[0]
        # on a sharded fit (``fit(mesh=...)``) Ur, the mask and the
        # selections' scores are this rank's rows; C is global (s, n)
        mesh, axis, gidx, (a, b) = self._shard_axis()
        if mask is not None:
            mask = np.asarray(mask, dtype=bool)
        mask_l = None if mask is None else mask[a:b]
        if calc_type in ("qr", "dg") and mask_l is not None:
            self._zero_masked_rows(mask_l)
        if calc_type == "qr":
            # Ur.T is an (r, n) view of the (n, r) basis: the kernel reads
            # it through its strides, no copy
            pivots = qrcp_pivots_sharded(self.Ur.T, self.r, mesh, gidx)
            return _qrcp.pivots_to_onehot(pivots, n).to(self.Ur.dtype)
        if calc_type == "gem":
            return self._onehot_rows(
                self.gem(self.Ur, n_sensors, mask_l, d_min, verbose), n)
        if calc_type == "dg":
            return self._onehot_rows(
                dg_select(self.Ur, n_sensors, mask_l, mesh=mesh, gidx=gidx),
                n)
        if calc_type == "vdg":
            # whole per-point blocks: the basis gathered from the ranks
            Ur = self.Ur if axis is None else gather_rows(self.Ur, mesh)
            P = vector_dg_select(Ur, self.n_features, n_sensors, mask,
                                 xyz=self.xyz, d_min=d_min)
            self.sensor_points = P
            return vector_onehot(P, self.n_features, self.n_points,
                                 dtype=self.Ur.dtype, device=self.device)
        raise NotImplementedError(
            "The sensor selection method has not been implemented yet")

    def _shard_axis(self):
        """This rank's view of the basis: ``(mesh, axis of several ranks or
        None, global indices of its rows, (first, stop))``; an unsharded
        fit is ``(None, None, None, (0, n))``."""
        mesh = getattr(self, "fit_mesh_", None)
        if mesh is None:
            return None, None, None, (0, self.Ur.shape[0])
        a, b = getattr(self, "_shard_rows", (0, self.Ur.shape[0]))
        axis = active(axis_of(mesh))
        gidx = torch.arange(a, b, dtype=torch.int64, device=self.device)
        return mesh, axis, gidx, (a, b)

    def _sample(self, C, M: torch.Tensor) -> torch.Tensor:
        """``C @ M`` for a global operator C (s, n) and M with the basis's
        rows: on a sharded fit, this rank's columns of C times its rows of
        M, all-reduced over the ranks."""
        if getattr(self, "fit_mesh_", None) is None:
            return apply_sampling(C, M)
        _, axis, _, (a, b) = self._shard_axis()
        if is_torch_sparse(C):
            C = torch_sparse_to_scipy(C)
        C_l = C.tocsc()[:, a:b] if sp.issparse(C) else C[:, a:b]
        part = apply_sampling(C_l, M)
        return part if axis is None else axis.sum(part)

    # ------------------------------------------------------------------ #
    # Train
    # ------------------------------------------------------------------ #

    def train(self, C, is_Theta: bool = False, limits=None,
              method: str = "OLS", solver: str = "ADMM", cond: bool = False,
              verbose: bool = False, admm_max_iter: int = 4000,
              admm_tol: float = 1e-9, admm_over_relax: float = 1.6,
              solver_config=None, constraints=None):
        """Store the measurement operator ``C`` (s, n) — dense (numpy or
        tensor), ``scipy.sparse`` or torch sparse — and ``Theta = C @ Ur``;
        with
        ``is_Theta=True``, ``C`` is Theta itself.  ``cond=True`` stores the
        condition number of Theta (host f64 SVD) as ``self.k``.

        ``method='COLS'`` makes :meth:`predict` solve under
        ``limits=[min_per_feature, max_per_feature]`` (the physical box)
        and/or ``constraints`` (a
        :class:`..linalg.boxls.LinearConstraints`, a raw (A, lo, hi) triple
        or a list of either, stacked; scaled coefficient space, bounds
        optionally batched per measurement vector).  ``admm_max_iter``,
        ``admm_tol`` and ``admm_over_relax`` are the ADMM knobs, overridden
        by ``solver_config`` (:class:`..core.config.SolverConfig`);
        ``solver`` is kept for signature parity (ADMM is the only one)."""
        if solver_config is not None:
            admm_max_iter = solver_config.max_iter
            admm_tol = solver_config.tol
            admm_over_relax = solver_config.over_relax
        if constraints is not None:
            constraints, _ = _boxls.build_constraint_set(constraints)
        self.constraints = constraints
        if (C.shape[1] != self.X.shape[0]) and not is_Theta:
            raise ValueError("The number of columns of C does not match the"
                             " number of rows of X.")
        if not is_Theta:
            self.C = C
            Theta = self._sample(C, self.Ur)
            # constant across predicts (see scale_vector)
            self._cnt_vector_cache = to_numpy(
                self._sample(C, self.X_cnt[:, 0]))
        else:
            Theta = self._t(C)
            # a previous train(C) must not survive: scale_vector would
            # center this Theta's measurements with the old C's sensors
            self.C = None
            self._cnt_vector_cache = None

        if Theta.shape[1] != self.Ur.shape[1]:
            raise ValueError("The number of columns of Theta does not match"
                             " the number of columns of Ur.")

        self.Theta = Theta
        self._needs_retrain = False
        self._cols_cache = None
        self.limits = limits
        self.method = method
        self.solver = solver
        self.verbose = verbose
        self.admm_max_iter = admm_max_iter
        self.admm_tol = admm_tol
        self.admm_over_relax = admm_over_relax

        if cond:
            # host f64 SVD of Theta directly: cond(pinv(Theta)) == cond(Theta)
            S_theta = np.linalg.svd(to_numpy(Theta).astype(np.float64),
                                    compute_uv=False)
            self.k = float(S_theta[0] / S_theta[-1])

    def update_basis(self, X_new, select_modes: str = "number",
                     n_modes=None, reorth: bool = True):
        """Incremental basis update (see :meth:`ROM.update_basis`) that keeps
        a trained sensor consistent: ``Theta = C @ Ur`` is derived again
        from the stored measurement operator (the cached ``C @ X_cnt``
        centering stays valid: the update freezes the scaling statistics).
        A sensor trained with ``is_Theta=True`` supplied a Theta of the OLD
        basis; it is dropped and :meth:`train` must be called again."""
        super().update_basis(X_new, select_modes=select_modes,
                             n_modes=n_modes, reorth=reorth)
        self._refresh_theta_after_update()

    def _refresh_theta_after_update(self):
        if getattr(self, "Theta", None) is not None:
            self._cols_cache = None      # its box part was built on old Ur
            if getattr(self, "C", None) is not None:
                self.Theta = apply_sampling(self.C, self.Ur)
            else:
                del self.Theta           # is_Theta path: must re-train
                self._needs_retrain = True

    def fit_predict(self, C, y, scale_type: str = "std",
                    select_modes: str = "variance", n_modes=99, **train_kw):
        """Convenience: fit + train + predict in one call."""
        self.fit(scale_type=scale_type, select_modes=select_modes,
                 n_modes=n_modes)
        self.train(C, **train_kw)
        return self.predict(y)

    # ------------------------------------------------------------------ #
    # Predict
    # ------------------------------------------------------------------ #

    def predict(self, y):
        """Gappy-POD solve for one measurement vector (s, 3) or a list.

        Returns (Ar, Ar_sigma), each (n_vectors, r), tensors on the model's
        device in Theta's dtype.  OLS: weighted pinv, host float64.  COLS:
        box-constrained least squares by ADMM on the model's device, one
        batch for all vectors; ``self.admm_info`` holds the per-vector
        iteration counts and residuals (a primal residual far above tol
        after the full budget flags an infeasible set)."""
        if not hasattr(self, "Theta"):
            if getattr(self, "_needs_retrain", False):
                raise AttributeError(
                    "the trained sensor was invalidated (the basis "
                    "changed after train(): a refit, or update_basis on "
                    "an is_Theta=True sensor) — call train() again; the "
                    "fitted basis is intact.")
            raise AttributeError("The function fit has to be called "
                                 "before calling predict.")
        if isinstance(y, (np.ndarray, torch.Tensor)):
            y = [y]
        y = [to_numpy(yi) for yi in y]
        for yi in y:
            if self.Theta.shape[0] != yi.shape[0]:
                raise ValueError("The number of rows of Theta does not match"
                                 " the number of rows of y.")
            if yi.shape[1] != 3:
                raise ValueError("The y array has the wrong number of columns."
                                 " y has to have dimensions (s,3).")

        n_vec = len(y)
        y0_np = np.stack([self.scale_vector(yi) for yi in y])
        has_sigma = np.array([bool(np.any(yi[:, 1])) for yi in y])
        s = y0_np.shape[1]
        # W = diag(1/σ); an exact measurement (σ=0) inside a weighted
        # vector gets the LARGEST finite weight of its vector
        sig_np = y0_np[:, :, 1].astype(np.float64)
        inv_sigma = np.where(sig_np > 0,
                             1.0 / np.where(sig_np > 0, sig_np, 1.0), 0.0)
        w_max = inv_sigma.max(axis=1, keepdims=True)
        w_weighted = np.where(sig_np > 0, inv_sigma, w_max)
        w_np = np.where(has_sigma[:, None], w_weighted, np.ones((n_vec, s)))

        # porting trap 9: the pinv runs on the HOST in float64, by design
        Th64 = to_numpy(self.Theta).astype(np.float64)
        WT = Th64[None, :, :] * w_np[:, :, None]        # (n_vec, s, r)
        pinvs = np.linalg.pinv(WT)                      # batched f64 pinv
        ar_np = np.einsum("vrs,vs->vr", pinvs, w_np * y0_np[:, :, 0])
        sig_prop = np.abs(np.einsum("vrs,vs->vr", pinvs, sig_np))
        ar_sigma_np = np.where(has_sigma[:, None], sig_prop, 0.0)
        dtype = self.Theta.dtype
        Ar_sigma = as_tensor(ar_sigma_np, self.device, dtype=dtype)

        if self.method == "OLS":
            self.admm_info = None            # no ADMM ran for this predict
            return as_tensor(ar_np, self.device, dtype=dtype), Ar_sigma
        if self.method != "COLS":
            raise NotImplementedError(
                "The prediction method selected has not been implemented yet")
        A_c, lo, hi, AtA = self._cols_set()
        sharded = getattr(self, "fit_mesh_", None) is not None
        axis = self._shard_axis()[1]
        Ar, self.admm_info = _boxls.box_constrained_lstsq(
            self.Theta, as_tensor(y0_np[:, :, 0], self.device, dtype=dtype),
            as_tensor(w_np, self.device, dtype=dtype), A_c, lo, hi, AtA=AtA,
            max_iter=self.admm_max_iter, tol=self.admm_tol,
            over_relax=self.admm_over_relax,
            n_rows=self.X.shape[0] if sharded else None, axis=axis)
        return Ar, Ar_sigma

    def _cols_set(self):
        """The stacked COLS constraint set ``(A_c, lo, hi, AᵀA)`` in
        Theta's dtype on the model's device, built once per train: the
        limits, the constraints and Ur are train-time constants, and the
        O(n r²) Gram is exact (``UrᵀUr`` is not I after a masked
        placement)."""
        if getattr(self, "_cols_cache", None) is None \
                and getattr(self, "fit_mesh_", None) is not None:
            self._cols_cache = self._sharded_cols_set()
        if getattr(self, "_cols_cache", None) is None:
            box = None
            if self.limits is not None:
                lo_b, hi_b = self.scale_limits(self.limits)
                box = (self.Ur, lo_b, hi_b)
            cs, _ = _boxls.build_constraint_set(
                getattr(self, "constraints", None), box)
            if cs is None:
                raise ValueError(
                    "method='COLS' requires physical `limits` (or a "
                    "`constraints` set) passed to train(C, ...).")
            A_c, lo, hi = (as_tensor(x, self.device, dtype=self.Theta.dtype)
                           for x in cs)
            self._cols_cache = (A_c, lo, hi, A_c.T @ A_c)
        return self._cols_cache

    def _sharded_cols_set(self):
        """The COLS box on a sharded fit: this rank's rows of Ur and of the
        scaled limits (the per-feature ±1000 test reduced over the ranks),
        the all-reduced UᵀU.  A general ``constraints`` set has global
        rows and is not taken here."""
        if getattr(self, "constraints", None) is not None:
            raise NotImplementedError(
                "a general constraints set on a sharded fit: shard its rows "
                "and call linalg.boxls with axis=, or use limits only.")
        if self.limits is None:
            raise ValueError(
                "method='COLS' requires physical `limits` passed to "
                "train(C, ...).")
        from ..parallel.sharded import _scale_limits_rows
        _, axis, gidx, _ = self._shard_axis()
        dt = self.Theta.dtype
        cnt = self.X_cnt[:, 0].to(dt)
        scl = self.X_scl[:, 0].to(dt)
        if axis is None:
            lo, hi = self.scale_limits(self.limits)
            lo, hi = (as_tensor(x, self.device, dtype=dt) for x in (lo, hi))
            return self.Ur.to(dt), lo, hi, self.Ur.T.to(dt) @ self.Ur.to(dt)
        lo, hi = _scale_limits_rows(
            np.asarray(self.limits[0], np.float64),
            np.asarray(self.limits[1], np.float64), cnt, scl,
            gidx // self.n_points, self.n_features, axis)
        A_c = self.Ur.to(dt)
        return A_c, lo, hi, axis.sum(A_c.T @ A_c)
