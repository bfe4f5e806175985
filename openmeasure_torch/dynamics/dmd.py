"""Dynamic mode decomposition of the snapshot series (port of
``openmeasure_tpu/dynamics/dmd.py``; Schmid 2010, Tu et al. 2014 "exact
DMD").

When the snapshots are a time series with uniform spacing ``dt``, DMD
extracts the spectrum of the best-fit linear propagator: growth rates,
frequencies and spatial modes, plus a forecast.

The tall work runs on the model's device: the Gram-route SVD of the first
m−1 snapshots (``linalg.svd.svd_tall_safe``), ``B = X2 V_r S_r⁻¹``,
``A_tilde = Urᵀ B`` and the coefficients of every snapshot.  The (r, r)
spectral analysis stays on the host in numpy complex128, as in the JAX
package: ``eig`` and the two least-squares amplitude solves.  Complex
numbers never go to the device: a forecast is ``panel @ real(W diag(λ^k)
b)``, a real (r, K) host product followed by one real device matmul.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from ..core.device import as_tensor, to_numpy
from ..linalg import svd as _svd
from ..rom.rom import ROM


class DMD(ROM):
    """Exact/projected DMD over the house data model.

    Constructor as :class:`openmeasure_torch.ROM` (feature-blocked
    snapshot matrix, ``device=None`` meaning the card); :meth:`fit` takes
    the sampling interval ``dt``.  Modes and forecasts live in the same
    scaled space as every other model, and a forecast is unscaled like a
    reconstruction.

    After :meth:`fit` (host numpy): ``eigs`` (r,) discrete-time
    eigenvalues, ``omega`` (r,) continuous-time ``log(eigs)/dt``,
    ``amplitudes`` (r,) first-snapshot mode loadings, ``A_tilde`` (r, r)
    float64; on the device: ``Ur``, ``Sigma_r``, ``Vr``, ``Ar``.
    """

    def fit(self, dt: float = 1.0, scale_type: str = "std",
            axis_cnt: Optional[int] = 1, select_modes: str = "variance",
            n_modes=99):
        """Identify basis and propagator from the time-ordered snapshots.

        The basis is the thin SVD of the first m−1 snapshots, truncated by
        ``select_modes``/``n_modes`` and clamped to the numerical rank
        (with a warning); the reduced operator is ``A_tilde = Urᵀ X2 V_r
        S_r⁻¹``."""
        self.scale_type = scale_type
        if not float(dt) > 0.0:
            raise ValueError(
                f"dt must be a positive sampling interval; got {dt} "
                "(dt=0 makes every continuous-time rate infinite, a "
                "negative dt flips growth/decay).")
        self.dt = float(dt)
        self.X0 = self.scale_data(scale_type, axis_cnt)
        m = self.X0.shape[1]
        self._m = m
        if m < 2:
            raise ValueError("DMD needs at least 2 time-ordered snapshots.")
        X1 = self.X0[:, :-1]
        X2 = self.X0[:, 1:]

        U, S, Vt = _svd.svd_tall_safe(X1)
        exp_var = _svd.explained_variance(S)
        r = _svd.select_rank(exp_var, select_modes, n_modes, S.shape[0])
        # clamp to the NUMERICAL rank: B divides by Sr, and noise-floor
        # singular values would fabricate a spurious spectrum
        S_np = to_numpy(S).astype(np.float64)
        floor = torch.finfo(X1.dtype).eps * S_np.max() \
            * float(X1.shape[0]) ** 0.5
        r_num = int(np.sum(S_np > floor))
        if r > r_num:
            warnings.warn(
                f"DMD rank clamped {r} -> {r_num}: the requested mode "
                "count exceeds the series' numerical rank; the dropped "
                "directions are noise-floor singular values whose "
                "inversion would fabricate spurious spectrum.",
                stacklevel=2)
            r = max(r_num, 1)
        self.r = r
        Ur, Sr, Vrt = U[:, :r], S[:r], Vt[:r]

        # B = X2 V_r S_r⁻¹ (n, r): the exact-mode panel and the projected
        # operator's factor
        B = X2 @ (Vrt.T / Sr[None, :])
        A_tilde = Ur.T @ B                                      # (r, r)

        self.Ur = Ur
        self.Sigma_r = Sr
        self.Vr = Vrt.T
        self._B = B
        # coefficients of ALL m snapshots in the X1 basis, one per row
        self.Ar = self.X0.T @ Ur
        self.A_tilde = to_numpy(A_tilde).astype(np.float64)

        # host float64 spectral analysis of the tiny operator
        lam, W = np.linalg.eig(self.A_tilde)
        a0 = S_np[:r] * to_numpy(Vrt).astype(np.float64)[:, 0]
        # lstsq, not solve: a near-defective A_tilde makes W ill-conditioned
        b, *_ = np.linalg.lstsq(W, a0.astype(np.complex128), rcond=None)
        # exact-mode amplitudes: Urᵀ (B W) = W Λ, so x_0 = Φ_exact b_e
        # solves (W Λ) b_e = a0
        be, *_ = np.linalg.lstsq(W * lam[None, :],
                                 a0.astype(np.complex128), rcond=None)
        self.eigs = lam
        self.W = W
        self.amplitudes = b
        self._b_exact = be
        with np.errstate(divide="ignore", invalid="ignore"):
            self.omega = np.log(lam.astype(np.complex128)) / self.dt
        self._invalidate_trained_state()

    # ------------------------------------------------------------------ #

    @property
    def frequencies(self) -> np.ndarray:
        """Oscillation frequencies in cycles per time unit (Im(ω)/2π)."""
        return np.imag(self.omega) / (2.0 * np.pi)

    @property
    def growth_rates(self) -> np.ndarray:
        """Continuous-time growth/decay rates (Re(ω))."""
        return np.real(self.omega)

    def modes(self, exact: bool = True) -> np.ndarray:
        """Complex (n, r) spatial modes (host numpy): ``exact=True`` Tu et
        al.'s ``X2 V S⁻¹ W``, ``exact=False`` the projected ``Ur W``."""
        panel = self._B if exact else self.Ur
        return to_numpy(panel).astype(np.float64) @ self.W

    # ------------------------------------------------------------------ #

    def _dynamics(self, k: np.ndarray, exact: bool) -> np.ndarray:
        """Real (r, K) reduced trajectory ``real(W diag(λ^k) b)`` at
        snapshot indices k, host complex128."""
        lam = self.eigs.astype(np.complex128)
        b = self._b_exact if exact else self.amplitudes
        T = b[:, None] * np.power(lam[:, None],
                                  k[None, :].astype(np.float64))
        return np.real(self.W @ T)

    def forecast(self, indices, exact: bool = True) -> torch.Tensor:
        """Predicted snapshots at integer indices (0 = first training
        snapshot; beyond m−1 extrapolates).  Returns the unscaled (n, K)
        fields, a tensor on the model's device."""
        if not hasattr(self, "eigs"):
            raise AttributeError(
                "The fit function has to be called before forecast.")
        k = np.atleast_1d(np.asarray(indices))
        if k.ndim != 1:
            raise ValueError("indices must be a scalar or 1-D array.")
        if not np.all(np.equal(np.mod(k, 1), 0)):
            raise ValueError(
                "forecast indices must be integers (snapshot steps): a "
                "fractional power of a negative/complex eigenvalue takes "
                "the principal branch and real() silently zeroes it — "
                "not an interpolant.")
        A_dyn = self._dynamics(k, exact)
        panel = self._B if exact else self.Ur
        X0_hat = panel @ as_tensor(A_dyn, self.device, dtype=panel.dtype)
        return self.unscale_data(X0_hat)

    def forecast_horizon(self, q: int, exact: bool = True) -> torch.Tensor:
        """The q snapshots FOLLOWING the training series (m..m+q−1)."""
        m = self._m
        return self.forecast(np.arange(m, m + q), exact=exact)

    def reconstruct_dmd(self, exact: bool = True) -> torch.Tensor:
        """DMD reconstruction of the training series (indices 0..m−1)."""
        return self.forecast(np.arange(self._m), exact=exact)

    # ------------------------------------------------------------------ #

    def update_basis(self, *args, **kwargs):
        """Disabled: an incremental POD update would decouple the basis
        from the identified propagator; refit instead."""
        raise NotImplementedError(
            "DMD.update_basis is not supported (the propagator is tied to "
            "the fitted basis); call fit() on the extended series.")
