"""Multifidelity fusion: CoKriging with Procrustes manifold alignment (port
of ``openmeasure_tpu/multifi/cokriging.py``).

Two snapshot sets of different fidelity are reduced by POD, the
low-fidelity scores are aligned to the high-fidelity latent space by a
scaled Procrustes rotation, and a recursive two-fidelity kriging model
(:mod:`openmeasure_torch.multifi.mfk`) is fit per latent dimension — all K
of them as one :class:`..mfk.BatchedMFK`, whose θ searches launch
``csrc/chol.cu`` once per NLL evaluation on the card.

The JAX package's deviations from the reference carry over:

* ``predict`` evaluates each latent model once, and all per-column
  unscaling is one pass;
* ``fit`` pairs the LF kriging level's parameters with its scores in the
  same (linked, unlinked) order — the reference concatenates the
  parameters (unlinked, linked) against (linked, unlinked)-ordered scores,
  scrambling every (x, y) pair whenever the two sets differ;
* truncated ``predict(n_truncated=k)`` projects with the first k columns
  of ``Ur_hf`` (the reference's full-basis product shape-errors for any
  k < n_latent); a k above ``n_latent`` or below 1 raises;
* a re-run of ``manifold_alignment`` invalidates a previously fitted
  kriging model — ``predict`` demands ``fit`` again.

The model lives on ``device`` (``None`` means the card), the snapshots
keeping their dtype; ``engine='host'`` runs the latent kriging fits and
predictions on the host CPU in float64 (``core/host64.py``) on top of the
alignment.  ``predict`` returns tensors on the model's device in the
basis's dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.device import DeviceLike, as_tensor, resolve_device, to_numpy
from ..linalg import svd as _svd
from ..rom.rom import ROM
from .mfk import BatchedMFK, _BatchedMFKView


def _hcat(a, b):
    """Column concatenation of two snapshot blocks (numpy or tensors)."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        dev = a.device if isinstance(a, torch.Tensor) else b.device
        a = as_tensor(a, dev)
        return torch.cat((a, as_tensor(b, dev, dtype=a.dtype)), dim=1)
    return np.concatenate((a, b), axis=1)


class CoKriging:
    """The reference constructor signature; the regression/θ knobs are
    mutable public attributes, as in the reference, and ``config``
    (:class:`..core.config.CoKrigingConfig`) sets them all."""

    def __init__(self, X_train_l, X_train_u, Y_train_lf_l, Y_train_lf_u,
                 Y_train_hf_l, xyz_lf, xyz_hf, n_features, config=None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.X_train_l = X_train_l      # linked parameters
        self.X_train_u = X_train_u      # unlinked parameters
        self.Y_train_lf_l = Y_train_lf_l
        self.Y_train_lf_u = Y_train_lf_u
        self.Y_train_hf_l = Y_train_hf_l
        self.xyz_lf = xyz_lf
        self.xyz_hf = xyz_hf
        self.n_features = n_features
        self.n_linked = X_train_l.shape[0]
        self.n_unlinked = X_train_u.shape[0]
        self.n_latent = 0
        self.scale_type = "std"
        self.regr_type = "linear"
        self.rho_regr = "constant"
        self.normalize = True
        self.theta = None
        self.theta0 = None
        self.thetaL = None
        self.thetaU = None
        self.initial_range = 0.3
        self.tol = 1e-6
        # 'device' (the model's device, the basis's dtype) or 'host' (the
        # latent kriging fits and predictions on the host in float64)
        self.engine = "device"
        if config is not None:
            for f in dataclasses.fields(config):
                setattr(self, f.name, getattr(config, f.name))

        if (Y_train_lf_l.shape[1] != self.n_linked
                or Y_train_hf_l.shape[1] != self.n_linked):
            # the reference's message byte for byte, with the newline and
            # indentation its triple-quoted literal embeds
            raise Exception(
                "The number of linked conditions does not correspond to the"
                " number of columns of\n            Y_train_lf_l or"
                " Y_train_hf_l")
        if Y_train_lf_u.shape[1] != self.n_unlinked:
            raise Exception(
                "The number of unlinked conditions does not correspond to"
                " the number of columns of\n            Y_train_lf_u")

    # ------------------------------------------------------------------ #

    def manifold_alignment(self, select_modes: str = "variance",
                           n_modes_hf=99, n_modes_lf=99):
        """POD both fidelities, truncate, zero-pad, center, and align the LF
        scores onto the HF latent space with a scaled Procrustes rotation."""
        self.rom_hf = ROM(self.Y_train_hf_l, self.n_features, self.xyz_hf,
                          device=self.device)
        self.rom_lf = ROM(_hcat(self.Y_train_lf_l, self.Y_train_lf_u),
                          self.n_features, self.xyz_lf, device=self.device)

        X0_hf = self.rom_hf.scale_data(self.scale_type)
        X0_lf = self.rom_lf.scale_data(self.scale_type)

        U_hf, Sigma_hf, Vt_hf = _svd.svd_tall_safe(X0_hf)
        U_lf, Sigma_lf, Vt_lf = _svd.svd_tall_safe(X0_lf)
        self.Sigma_hf = Sigma_hf
        self.Sigma_lf = Sigma_lf

        Z_hf = Sigma_hf[:, None] * Vt_hf   # scores: (m_hf, m_hf)
        Z_lf = Sigma_lf[:, None] * Vt_lf

        ev_hf = _svd.explained_variance(Sigma_hf)
        ev_lf = _svd.explained_variance(Sigma_lf)

        Ur_hf, Zr_hf_t = self.rom_hf.reduction(U_hf, Z_hf.T, ev_hf,
                                               select_modes, n_modes_hf)
        Ur_lf, Zr_lf_t = self.rom_lf.reduction(U_lf, Z_lf.T, ev_lf,
                                               select_modes, n_modes_lf)
        Zr_hf = Zr_hf_t.T
        Zr_lf = Zr_lf_t.T
        self.r_hf = Ur_hf.shape[1]
        self.r_lf = Ur_lf.shape[1]

        if self.r_lf < self.r_hf:
            pad = torch.zeros((self.r_hf - self.r_lf, Zr_lf.shape[1]),
                              dtype=Zr_lf.dtype, device=Zr_lf.device)
            Zr_lf = torch.cat([Zr_lf, pad], dim=0)

        Zr_lf_l = Zr_lf[:, : self.n_linked]

        Z0r_hf = Zr_hf - torch.mean(Zr_hf, dim=1, keepdim=True)
        Z0r_lf_l = Zr_lf_l - torch.mean(Zr_lf_l, dim=1, keepdim=True)

        # scaled Procrustes: rotation + isotropic scale of LF onto HF
        # scores; tr(Z Zᵀ) as ‖Z‖_F², not a Gram built for its trace
        Ua, Sa, Vat = torch.linalg.svd(Z0r_lf_l @ Z0r_hf.T,
                                       full_matrices=False)
        sr = torch.sum(Sa) / torch.sum(Z0r_lf_l * Z0r_lf_l)
        Qr = Vat.T @ Ua.T
        Zr_aligned = sr * (Qr @ Zr_lf)

        self.n_latent = int(Zr_aligned.shape[0])
        self.Zr_aligned = Zr_aligned
        self.Ur_hf = Ur_hf
        self.Zr_hf = Zr_hf
        # new latent coordinates: drop a previously fitted kriging model
        for a in ("_batch", "model_list"):
            if hasattr(self, a):
                delattr(self, a)

    # ------------------------------------------------------------------ #

    def fit(self):
        """Fit the K latent kriging models as one :class:`BatchedMFK`, LF
        parameters in (linked, unlinked) order to match the scores (the
        JAX package's deviation from the reference)."""
        X_train = np.concatenate(
            (to_numpy(self.X_train_l), to_numpy(self.X_train_u)), axis=0)
        self._batch = BatchedMFK(
            regr=self.regr_type, rho_regr=self.rho_regr, theta=self.theta,
            theta0=self.theta0, thetaL=self.thetaL, thetaU=self.thetaU,
            normalize=self.normalize, engine=self.engine,
            device=self.device)
        self._batch.fit([X_train, to_numpy(self.X_train_l)],
                        [self.Zr_aligned, self.Zr_hf],
                        initial_range=self.initial_range, tol=self.tol)
        self.model_list = [_BatchedMFKView(self._batch, k)
                           for k in range(self.n_latent)]

    def predict(self, X_test, n_truncated: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """HF fields ``(Y_pred (n, q), Y_mse (n, q))`` at the parameters
        ``X_test`` (q, d), from the first ``n_truncated`` latent dimensions
        (default all).  The MSE is unscaled through the same affine map as
        the mean (the reference's quirk, kept)."""
        n_test = X_test.shape[0]
        if not hasattr(self, "_batch") and not hasattr(self, "model_list"):
            raise AttributeError(
                "The fit function has to be called before predict "
                "(re-running manifold_alignment invalidates a previous "
                "fit).")
        if n_truncated is None:
            n_truncated = self.n_latent
        if not 0 < int(n_truncated) <= self.n_latent:
            raise ValueError(
                f"n_truncated must be in [1, n_latent={self.n_latent}]; "
                f"got {n_truncated}.")

        Ur = self.Ur_hf[:, :n_truncated]
        if hasattr(self, "_batch"):
            Z_pred, Z_mse = self._batch.predict(X_test,
                                                n_outputs=n_truncated)
        else:  # model_list supplied externally
            Z_pred = torch.zeros((n_truncated, n_test), dtype=Ur.dtype,
                                 device=Ur.device)
            Z_mse = torch.zeros_like(Z_pred)
            for i in range(n_truncated):
                mean, mse = self.model_list[i].predict(X_test)
                Z_pred[i, :] = as_tensor(mean, Ur.device).reshape(-1)
                Z_mse[i, :] = as_tensor(mse, Ur.device).reshape(-1)

        Z_pred, Z_mse = (as_tensor(z, Ur.device, dtype=Ur.dtype)
                         for z in (Z_pred, Z_mse))
        Y_pred = self.rom_hf.unscale_data(Ur @ Z_pred)
        Y_mse = self.rom_hf.unscale_data(Ur @ Z_mse)
        return Y_pred, Y_mse
