"""Low-latency soft-sensor serving (port of ``openmeasure_tpu/serving.py``:
``SoftSensor``, ``GPRSensor``, ``CoKrigingSensor``, ``DecoderSensor`` and
``DynamicSensor``).

A fitted model is packaged for streaming inference: its state lives on the
card, and one call runs a whole batch of measurements — scaling, the
gappy-POD solve (or the GP posterior), the optional constrained ADMM and
the reconstruction — with no read back to the host::

    sensor = SoftSensor.from_spr(spr)              # spr after fit + train
    x_hat = sensor(y_values)                       # (s,) -> (n,) field
    x_hat, a, sigma = sensor.predict_full(y_values, y_sigma)
    fields, A, sig = sensor.predict_batch(Y)       # (b, s) -> (b, n)

    gsensor = GPRSensor.from_gpr(gpr, limits=[lo, hi])
    fields, A, A_sigma = gsensor(P_star)           # (q, d) -> (q, n)

    csensor = CoKrigingSensor.from_cokriging(ck)   # ck after align + fit
    Y_pred, Y_mse = csensor(X_test)                # (q, d) -> (n, q)

    dsensor = DecoderSensor.from_decoder(dec)      # dec after fit(C)
    fields = dsensor.predict_batch(Y)              # (b, s) -> (b, n)

    ksensor = DynamicSensor.from_spr(spr)          # time-ordered spr
    fields, A, var = ksensor.filter_batch(Y, S)    # (K, s) series

As in the JAX package, the model state is a dict passed to module-level
functions (``_predict_math``, ``_gpr_predict_math``,
``_ck_predict_math``, ``_decoder_predict_kernel``, ``_kf_serve_series``,
``_kf_smooth_series``), not closed over, so
every sensor of one shape runs the same code on its own state.  Where the
JAX package ``vmap``s the single-request math over a batch, the math here
takes the batch as a leading axis.  The constrained solves run a fixed
iteration budget (``tol = 0``): every request does the same work, and the
budget is the accuracy knob.  The Kalman filter's scan over frames is a
Python loop over device tensors: a batch of K frames reads nothing back.
While the recorder of :mod:`.utils.logging` is on, a ``SoftSensor``
batch is one ``serve.predict_batch`` span over ``serve.solve``, the
ADMM's ``boxls.admm`` (COLS) and ``serve.reconstruct``.

``shard(mesh)`` row-shards a sensor's n-row state over a mesh axis
(:func:`shard_state_rows`): each rank keeps its rows of ``Ur``, the
unscaling vectors and the constraint set, the reconstruct and the ADMM's
constraint products run shard-local with (r,)-sized all-reduces, and a
field output is this rank's rows (documented deviation: the JAX package
returns one global array; :func:`..parallel.gather_rows` assembles it).
``load`` builds a sensor from an ``.npz`` checkpoint.  A measurement
operator may be dense, ``scipy.sparse`` or a torch sparse COO or CSR
tensor (the port's counterpart of the JAX package's BCOO).

Documented deviation: ``GPRSensor.from_gpr`` casts the GP parameters and
training set to the sensor's dtype (the basis's) on its device; the JAX
package leaves them in their own dtype, so a host-engine model's float64
parameters reach its device program.  A GPR sensor therefore always serves
in the basis's dtype.  ``CoKrigingSensor.from_cokriging`` does the same with
the co-kriging level state (a host-engine fit's float64 levels included),
where the JAX package casts to its ambient default float.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from .core.device import DeviceLike, as_tensor, resolve_device, to_numpy
from .dynamics.kalman import (estimate_process_noise, fit_reduced_operator,
                              kalman_filter, kalman_smoother,
                              stationary_covariance)
from .gp.exact_gp import tree_map
from .gp.gpr import posterior_all_modes
from .linalg import boxls as _boxls
from .multifi.mfk import predict_levels_batch
from .rom.rom import is_torch_sparse, torch_sparse_to_scipy
from .sensing.decoder import _forward as _decoder_forward
from .utils import logging as _log

_ROW_KEYS = ("Ur", "X_cnt", "X_scl", "A_c", "lo", "hi")


def shard_state_rows(state, mesh, axis_name: str = "state",
                     row_keys=_ROW_KEYS):
    """Row-shard a serving state over one mesh axis (multi-card serving).

    Every tensor named in ``row_keys`` keeps this rank's block of its
    leading dimension (the state dimension n: the tall axis of ``Ur`` and
    of the constraint set); every other entry stays whole, replicated.
    A leading dimension the axis size does not divide is padded to the
    next multiple with inert rows — zero basis and constraint rows, unit
    scale, [0, 0] bounds — so every rank holds the same count; the padded
    rows add exact zeros to the products and norms, and field outputs are
    cut back to the rank's real rows (``n_out``).  The ADMM's residual
    normalizations take the active constraint-row count ``n_c``, not the
    padded shape.  ``axis`` records the mesh axis for the solvers' (r,)-
    sized all-reduces (``None`` on one rank, where the state is the whole
    one and the sensor runs the unsharded code)."""
    from .parallel._comm import Axis, active, row_range
    ax = Axis.of(mesh, axis_name)
    pad_value = {"X_scl": 1.0}
    out = {}
    for k, v in state.items():
        if k in row_keys and isinstance(v, torch.Tensor) and v.ndim >= 1:
            a, b, per = row_range(v.shape[0], ax.size, ax.rank)
            blk = v[a:b].to(ax.device)
            if b - a < per:
                pad = torch.full((per - (b - a),) + tuple(v.shape[1:]),
                                 pad_value.get(k, 0.0), dtype=v.dtype,
                                 device=ax.device)
                blk = torch.cat([blk, pad], dim=0)
            out[k] = blk
        else:
            out[k] = v
    if "Ur" in row_keys and "Ur" in state:
        a, b, _ = row_range(state["Ur"].shape[0], ax.size, ax.rank)
        out["n_out"] = b - a
    out["axis"] = active(ax)
    return out


def _cut(state, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """A field output cut to this rank's real rows (sharded state)."""
    n_out = state.get("n_out")
    return x if n_out is None else x.narrow(dim, 0, n_out)


def _sharded_copy(sensor, mesh, axis_name: str, row_keys=_ROW_KEYS):
    """A shallow copy of ``sensor`` with its state row-sharded."""
    import copy
    from .parallel._comm import check_mesh
    check_mesh(mesh)
    new = copy.copy(sensor)
    new._state = shard_state_rows(sensor._state, mesh, axis_name, row_keys)
    return new


def _predict_math(state, Y_values, Y_sigma, method, admm_iters, over_relax,
                  adapt_rho=True):
    """The batched request math: scaling → weighted QR (+ one refinement)
    solve → optional COLS ADMM → reconstruct + unscale.  ``Y_values`` and
    ``Y_sigma`` are (b, s); returns fields (b, n), coefficients (b, r) and
    coefficient σ (b, r)."""
    with _log.span("serve.solve"):
        y0 = (Y_values - state["cnt_sensors"]) / state["scl_sensors"]
        sig0 = Y_sigma / state["scl_sensors"]
        # the weighted path triggers on any NONZERO σ (SPR.predict's
        # test), so both paths agree even on malformed, negative-σ input
        use_w = torch.any(Y_sigma != 0, dim=-1, keepdim=True)
        # a σ=0 entry inside an otherwise-weighted vector gets the
        # LARGEST finite weight of its vector, as in SPR.predict; a NaN σ
        # propagates
        pos = sig0 > 0
        inv_sigma = torch.where(pos, 1.0 / torch.where(pos, sig0, 1.0), 0.0)
        w_max = torch.amax(inv_sigma, dim=-1, keepdim=True)
        w = torch.where(use_w, torch.where(pos, inv_sigma, w_max), 1.0)
        w = torch.where(torch.isnan(sig0), float("nan"), w)
        # weighted LS by QR + one iterative-refinement step, not pinv:
        # the scaled per-feature σ make the weights span decades, cond(WΘ)
        # reaches ~1e5, and an fp32 pinv on the device loses ~1 % there
        Theta = state["Theta"]
        WT = Theta * w[..., :, None]                             # (b, s, r)
        Q, R = torch.linalg.qr(WT)
        # rank-deficiency guard: floor R's diagonal at eps-level relative
        # to max|diag(R)| (a masked placement can leave Θ singular); the
        # all-zero operator keeps a floor of eps · s
        d = torch.diagonal(R, dim1=-2, dim2=-1)
        dmax = torch.amax(torch.abs(d), dim=-1, keepdim=True)
        floor = (torch.where(dmax > 0, dmax, 1.0)
                 * (torch.finfo(d.dtype).eps * WT.shape[-2]))
        d_safe = torch.where(torch.abs(d) < floor,
                             torch.where(d < 0, -floor, floor), d)
        R = R + torch.diag_embed(d_safe - d)

        def wsolve(rhs):
            rhs = rhs[..., None]
            x = torch.linalg.solve_triangular(R, Q.mT @ rhs, upper=True)
            resid = rhs - WT @ x
            return (x + torch.linalg.solve_triangular(R, Q.mT @ resid,
                                                      upper=True))[..., 0]

        if method != "COLS":
            a = torch.where(use_w, wsolve(w * y0), y0 @ state["pinv"].T)
    if method == "COLS":
        a, _ = _boxls.box_constrained_lstsq(
            Theta, y0, w, state["A_c"], state["lo"], state["hi"],
            AtA=state["AtA"], max_iter=admm_iters, tol=0.0,
            over_relax=over_relax, n_rows=state.get("n_c"),
            adapt_rho=adapt_rho, axis=state.get("axis"))
    with _log.span("serve.reconstruct"):
        a_sigma = torch.where(use_w, torch.abs(wsolve(sig0)), 0.0)
        x = (a @ state["Ur"].T) * state["X_scl"] + state["X_cnt"]
    return _cut(state, x), a, a_sigma


def _predict_one(state, y_values, y_sigma, *, method, admm_iters,
                 over_relax, adapt_rho=True):
    x, a, s = _predict_math(state, y_values[None], y_sigma[None], method,
                            admm_iters, over_relax, adapt_rho)
    return x[0], a[0], s[0]


def _measurement_scaling(C, X_cnt, X_scl, n_points, feature_ids=None):
    """Per-measurement centering (``C @ X_cnt``) and scaling from a dense
    (numpy or tensor), ``scipy.sparse`` or torch sparse measurement
    operator, on the host in float64 where the inputs are (a torch sparse
    C is copied to the host first, its duplicates summed).

    A one-hot C (the QR placement) takes each measurement's scale from its
    selected row; a general C needs ``feature_ids`` (s,), the feature index
    of each measurement."""
    if is_torch_sparse(C):
        C = torch_sparse_to_scipy(C)
    if sp.issparse(C):
        cnt_sensors = np.asarray(C.dot(X_cnt)).ravel()
        # one-hot detection on the duplicate-summed form: two raw (i, j)
        # ones make a row value of 2
        Cc = C.tocsr().copy()
        Cc.sum_duplicates()
        row_nnz = np.diff(Cc.indptr)
        one_hot = bool(np.all(row_nnz == 1) and np.all(Cc.data == 1.0))
        argmax_rows = np.asarray(Cc.argmax(axis=1)).ravel()
    else:
        Cd = to_numpy(C)
        cnt_sensors = Cd @ X_cnt
        one_hot = bool(np.all((Cd != 0).sum(axis=1) == 1)
                       and np.all(Cd[Cd != 0] == 1.0))
        argmax_rows = np.argmax(Cd, axis=1)

    if feature_ids is not None:
        scl_sensors = X_scl[np.asarray(feature_ids, int) * n_points]
    elif one_hot:
        scl_sensors = X_scl[argmax_rows]
    else:
        raise ValueError(
            "C is not one-hot: pass feature_ids (the per-measurement "
            "feature indices) so measurement scaling is well-defined.")
    return cnt_sensors, scl_sensors


def _check_rho(admm_rho: str) -> str:
    if admm_rho not in ("adaptive", "fixed"):
        raise ValueError(
            f"admm_rho must be 'adaptive' or 'fixed'; got {admm_rho!r}")
    return admm_rho


class SoftSensor:
    """A packaged gappy-POD soft sensor: state on ``device`` (``None``
    means the card) in ``dtype``.

    ``method='COLS'`` serves the constrained model: the solve is the ADMM
    box-QP against the constraint set captured at train time, run for a
    fixed budget of ``admm_iters`` iterations.  ``admm_rho='fixed'`` keeps
    ρ at its scale-matched start, factorizes once and skips the residual
    norms; ``'adaptive'`` (the default) balances the residuals, which is
    more robust on ill-scaled problems."""

    def __init__(self, Ur, Theta, cnt_sensors, scl_sensors, X_cnt, X_scl,
                 dtype=torch.float32, method: str = "OLS",
                 constraint_A=None, constraint_lo=None, constraint_hi=None,
                 admm_iters: int = 300, admm_over_relax: float = 1.6,
                 admm_rho: str = "adaptive", device: DeviceLike = None):
        self.device = resolve_device(device)

        def t(x):
            return as_tensor(x, self.device, dtype=dtype)

        self.Ur = t(Ur)
        self.Theta = t(Theta)
        self.cnt_sensors = t(cnt_sensors)
        self.scl_sensors = t(scl_sensors)
        self.X_cnt = t(X_cnt).reshape(-1)
        self.X_scl = t(X_scl).reshape(-1)
        self.r = self.Theta.shape[1]
        self.s = self.Theta.shape[0]
        self.n = int(self.Ur.shape[0])
        self.method = method
        self.admm_iters = int(admm_iters)
        self.admm_over_relax = float(admm_over_relax)
        self.admm_rho = _check_rho(admm_rho)
        # the solve operator, once, on the host in float64: the stored
        # operator carries no device-SVD error
        pinv = t(np.linalg.pinv(to_numpy(Theta).astype(np.float64)))
        self._state = {"Ur": self.Ur, "Theta": self.Theta,
                       "cnt_sensors": self.cnt_sensors,
                       "scl_sensors": self.scl_sensors,
                       "X_cnt": self.X_cnt, "X_scl": self.X_scl,
                       "pinv": pinv}
        if method == "COLS":
            if constraint_A is None or constraint_lo is None \
                    or constraint_hi is None:
                raise ValueError(
                    "method='COLS' needs constraint_A/lo/hi (scaled "
                    "coefficient-space constraint set).")
            A_c = t(constraint_A)
            # n_c: the active constraint-row count, kept when shard()
            # pads the rows
            self._state.update(A_c=A_c, lo=t(constraint_lo),
                               hi=t(constraint_hi), AtA=A_c.T @ A_c,
                               n_c=int(A_c.shape[0]))
        elif method != "OLS":
            raise NotImplementedError(f"serving method {method!r}")
        self._kw = dict(method=method, admm_iters=self.admm_iters,
                        over_relax=self.admm_over_relax,
                        adapt_rho=self.admm_rho == "adaptive")

    @classmethod
    def from_spr(cls, spr, feature_ids=None, dtype=torch.float32,
                 admm_iters: int = 300,
                 admm_rho: str = "adaptive") -> "SoftSensor":
        """Package a trained :class:`openmeasure_torch.SPR` (after fit +
        train) on the model's device.  C may be dense, ``scipy.sparse`` or
        torch sparse.

        A one-hot C (QR placement) gives the per-measurement scaling
        directly; a general C needs ``feature_ids`` (s,).  A model trained
        with ``method='COLS'`` carries its stacked ``limits``/``constraints``
        set (unbatched bounds only) into the sensor."""
        X_cnt = to_numpy(spr.X_cnt)[:, 0]
        X_scl = to_numpy(spr.X_scl)[:, 0]
        cnt_sensors, scl_sensors = _measurement_scaling(
            spr.C, X_cnt, X_scl, spr.n_points, feature_ids)

        method = getattr(spr, "method", "OLS")
        kw = {}
        if method == "COLS":
            box = None
            if getattr(spr, "limits", None) is not None:
                lo, hi = spr.scale_limits(spr.limits)
                box = (spr.Ur, lo, hi)
            stacked, _ = _boxls.build_constraint_set(
                getattr(spr, "constraints", None), box)
            if stacked is None:
                raise ValueError(
                    "COLS model has neither limits nor constraints.")
            if stacked.batched:
                raise ValueError(
                    "per-request batched constraint bounds cannot be "
                    "baked into a serving model; use unbatched bounds.")
            kw = dict(constraint_A=stacked.A, constraint_lo=stacked.lo,
                      constraint_hi=stacked.hi)
        return cls(spr.Ur, spr.Theta, cnt_sensors, scl_sensors,
                   X_cnt, X_scl, dtype, method=method,
                   admm_iters=admm_iters, admm_rho=admm_rho,
                   admm_over_relax=getattr(spr, "admm_over_relax", 1.6),
                   device=spr.device, **kw)

    @classmethod
    def load(cls, path: str, feature_ids=None, dtype=torch.float32,
             admm_iters: int = 300, admm_rho: str = "adaptive",
             device: DeviceLike = None) -> "SoftSensor":
        """Build from a checkpoint written by
        :func:`openmeasure_torch.utils.checkpoint.save_model` (or the JAX
        package's), loaded on ``device`` (``None`` means the card).  Pass
        ``feature_ids`` for a model trained with a C that is not
        one-hot."""
        from .utils.checkpoint import load_model
        return cls.from_spr(load_model(path, device=device),
                            feature_ids=feature_ids, dtype=dtype,
                            admm_iters=admm_iters, admm_rho=admm_rho)

    def shard(self, mesh, axis_name: str = "state") -> "SoftSensor":
        """Multi-card serving: a copy whose n-row state (Ur, the unscaling
        vectors and the COLS constraint set) is row-sharded over
        ``mesh``'s ``axis_name`` axis (see :func:`shard_state_rows`); the
        reconstruct and the ADMM's constraint products run shard-local,
        and a field output is this rank's rows.  A fixed-budget batch
        still reads nothing back: its all-reduces stay on the device."""
        new = _sharded_copy(self, mesh, axis_name)
        new.Ur = new._state["Ur"]
        new.X_cnt, new.X_scl = new._state["X_cnt"], new._state["X_scl"]
        return new

    def predict_full(self, y_values, y_sigma=None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One request: (field (n,), coefficients (r,), coefficient σ
        (r,)); a scalar ``y_sigma`` broadcasts."""
        y_values = as_tensor(y_values, self.device, dtype=self.Ur.dtype)
        if tuple(y_values.shape) != (self.s,):
            raise ValueError(
                f"y_values must be (s={self.s},); got "
                f"{tuple(y_values.shape)}. Use predict_batch for (batch, s) "
                "frames.")
        if y_sigma is None:
            y_sigma = torch.zeros_like(y_values)
        else:
            y_sigma = torch.broadcast_to(
                as_tensor(y_sigma, self.device, dtype=self.Ur.dtype),
                y_values.shape)
        return _predict_one(self._state, y_values, y_sigma, **self._kw)

    def __call__(self, y_values, y_sigma=None) -> torch.Tensor:
        return self.predict_full(y_values, y_sigma)[0]

    def predict_batch(self, Y_values, Y_sigma=None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """A batch of requests ``Y_values`` (b, s) → (fields (b, n),
        coefficients (b, r), coefficient σ (b, r)) in one call, with no read
        back to the host: frame streams should batch.  The batch is one
        ``serve.predict_batch`` span while the recorder is on."""
        with _log.span("serve.predict_batch"):
            Y_values = as_tensor(Y_values, self.device, dtype=self.Ur.dtype)
            if Y_values.ndim != 2 or Y_values.shape[1] != self.s:
                raise ValueError(
                    f"Y_values must be (batch, s={self.s}); got "
                    f"{tuple(Y_values.shape)}.")
            if Y_sigma is None:
                Y_sigma = torch.zeros_like(Y_values)
            else:
                Y_sigma = as_tensor(Y_sigma, self.device,
                                    dtype=self.Ur.dtype)
            return _predict_math(self._state, Y_values, Y_sigma, **self._kw)

    def warmup(self) -> "SoftSensor":
        """Run one request, so the first real one finds the library
        handles and workspaces made."""
        self.predict_full(torch.zeros(self.s, dtype=self.Ur.dtype,
                                      device=self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self


# ---------------------------------------------------------------------- #
# GPR serving: parameters -> field
# ---------------------------------------------------------------------- #

def _gpr_predict_math(state, P_star, mean_spec, kernel_spec,
                      likelihood_spec, gpr_type, constrained, admm_iters,
                      over_relax, adapt_rho=True):
    """Posterior at the scaled design points, the optional constrained
    MAP, the Σ-rescale and the reconstruction: ``GPR.predict`` followed by
    ``reconstruct``.  With ``constrained``, each point's posterior mean is
    replaced by the whitened ADMM MAP under the set in ``state``, for a
    fixed budget (``tol = 0``)."""
    P0s = (P_star - state["P_cnt"][None, :]) / state["P_scl"][None, :]
    means, variances = posterior_all_modes(
        mean_spec, kernel_spec, likelihood_spec, gpr_type,
        state["params"], state["P0_train"], state["Y"], P0s)
    V_pred = means.T                                   # (q, r)
    V_sigma = torch.sqrt(variances).T
    if constrained:
        V_pred, _ = _boxls.box_constrained_map(
            V_pred, torch.diag_embed(variances.T), state["A_c"], state["lo"],
            state["hi"], AtA=state["AtA"], max_iter=admm_iters, tol=0.0,
            over_relax=over_relax, n_rows=state.get("n_c"),
            adapt_rho=adapt_rho, axis=state.get("axis"))
    A = V_pred * state["Sigma_r"][None, :]
    A_sigma = V_sigma * state["Sigma_r"][None, :]
    fields = (A @ state["Ur"].T) * state["X_scl"] + state["X_cnt"]
    return _cut(state, fields), A, A_sigma


class GPRSensor:
    """Packaged parameter→field sensor of a trained
    :class:`openmeasure_torch.GPR` — ``predict`` + ``reconstruct`` as one
    call on the model's device::

        sensor = GPRSensor.from_gpr(gpr)       # gpr after fit + train
        fields, A, A_sigma = sensor(P_star)    # (q, d) -> (q, n) fields

    A constraint set given to :meth:`from_gpr` (``limits`` box, ``bc`` pins,
    general ``constraints``) is baked in: every request's posterior mean is
    replaced by the whitened ADMM MAP of the constrained ``GPR.predict``,
    under a fixed iteration budget."""

    def __init__(self, mean_spec, kernel_spec, likelihood_spec,
                 gpr_type, state, admm_iters: int = 300,
                 admm_over_relax: float = 1.6,
                 admm_rho: str = "adaptive"):
        self.mean_spec = mean_spec
        self.kernel_spec = kernel_spec
        self.likelihood_spec = likelihood_spec
        self.gpr_type = gpr_type
        self._state = state
        self.constrained = "A_c" in state
        self.admm_iters = int(admm_iters)
        self.admm_over_relax = float(admm_over_relax)
        self.admm_rho = _check_rho(admm_rho)
        self.d = int(state["P_cnt"].shape[0])
        self.r = int(state["Sigma_r"].shape[0])
        self.n = int(state["Ur"].shape[0])

    @classmethod
    def from_gpr(cls, gpr, limits=None, bc=None, constraints=None,
                 admm_iters: int = 300,
                 admm_over_relax: float = 1.6,
                 admm_rho: str = "adaptive") -> "GPRSensor":
        """Package a trained GPR (after ``fit`` + ``train``) on the model's
        device, in the basis's dtype: the GP parameters and training set
        are cast to it (a host-engine model's float64 state included).

        ``limits``/``bc``/``constraints`` follow ``GPR.predict`` (they
        compose, MultiTask only), with two serving rules: ``bc=(rows,
        values)`` takes a fixed (n_bc,) vector enforced on every request,
        and ``constraints`` bounds must be unbatched."""
        if not hasattr(gpr, "Ur"):
            raise AttributeError(
                "GPRSensor.from_gpr needs a fitted and trained GPR: "
                "call gpr.fit() and gpr.train() first.")
        if not hasattr(gpr, "models"):
            raise AttributeError(
                "GPRSensor.from_gpr needs a trained GPR: call gpr.train() "
                "after fit().")
        dev, dtype = gpr.Ur.device, gpr.Ur.dtype

        def t(x):
            return as_tensor(x, dev, dtype=dtype)

        def t_float(x):
            x = as_tensor(x, dev)
            return x.to(dtype) if x.is_floating_point() else x

        state = {
            "P0_train": t(gpr._train_X),
            "Y": t(gpr._train_Y),
            "params": tree_map(t_float, gpr.params),
            "Sigma_r": t(gpr.Sigma_r),
            "Ur": gpr.Ur,
            "X_cnt": t(gpr.X_cnt)[:, 0],
            "X_scl": t(gpr.X_scl)[:, 0],
            "P_cnt": t(gpr.P_cnt)[0],
            "P_scl": t(gpr.P_scl)[0],
        }
        if limits is not None or bc is not None or constraints is not None:
            if gpr.gpr_type != "MultiTask":
                raise NotImplementedError(
                    "Constrained prediction only works for MultiTask "
                    "models.")
            if bc is not None and np.asarray(bc[1]).ndim != 1:
                raise ValueError(
                    "serving bc values must be a fixed (n_bc,) vector "
                    "(per-request batched pins cannot be baked into a "
                    "packaged model).")
            parts = gpr._state_constraint_parts(limits, bc)
            if constraints is not None:
                cs_user, _ = _boxls.build_constraint_set(constraints, None)
                parts.append(cs_user)
            cs = _boxls.concat_constraints(parts)
            if cs.batched:
                raise ValueError(
                    "per-request batched constraint bounds cannot be baked "
                    "into a serving model; use unbatched bounds.")
            A_c = t(cs.A)
            state.update(A_c=A_c, lo=t(cs.lo), hi=t(cs.hi), AtA=A_c.T @ A_c,
                         n_c=int(A_c.shape[0]))
        return cls(gpr.mean, gpr.kernel, gpr.likelihood, gpr.gpr_type,
                   state, admm_iters=admm_iters,
                   admm_over_relax=admm_over_relax, admm_rho=admm_rho)

    @classmethod
    def load(cls, path: str, limits=None, bc=None, constraints=None,
             admm_iters: int = 300, admm_over_relax: float = 1.6,
             admm_rho: str = "adaptive",
             device: DeviceLike = None) -> "GPRSensor":
        """Build from a checkpoint of a trained GPR, loaded on ``device``
        (``None`` means the card); the arguments as :meth:`from_gpr`."""
        from .utils.checkpoint import load_model
        return cls.from_gpr(load_model(path, device=device), limits=limits,
                            bc=bc, constraints=constraints,
                            admm_iters=admm_iters,
                            admm_over_relax=admm_over_relax,
                            admm_rho=admm_rho)

    def shard(self, mesh, axis_name: str = "state") -> "GPRSensor":
        """Multi-card serving: a copy with the n-row state (Ur, the
        unscaling vectors and the constrained MAP's constraint set)
        row-sharded over ``mesh`` (see :func:`shard_state_rows`); the GP
        posterior is replicated, and a field output is this rank's
        rows."""
        return _sharded_copy(self, mesh, axis_name)

    def __call__(self, P_star):
        Ur = self._state["Ur"]
        P_star = as_tensor(P_star, Ur.device, dtype=Ur.dtype)
        if P_star.ndim < 2:
            P_star = P_star[None, :]
        if P_star.shape[1] != self.d:
            raise ValueError(
                f"P_star must be (batch, d={self.d}); got "
                f"{tuple(P_star.shape)}.")
        return _gpr_predict_math(
            self._state, P_star, self.mean_spec, self.kernel_spec,
            self.likelihood_spec, self.gpr_type, self.constrained,
            self.admm_iters, self.admm_over_relax,
            self.admm_rho == "adaptive")

    def warmup(self, batch: int = 1) -> "GPRSensor":
        Ur = self._state["Ur"]
        self(torch.zeros((batch, self.d), dtype=Ur.dtype, device=Ur.device))
        if Ur.device.type == "cuda":
            torch.cuda.synchronize(Ur.device)
        return self


# ---------------------------------------------------------------------- #
# CoKriging serving: multifidelity parameters -> HF field
# ---------------------------------------------------------------------- #

def _ck_predict_math(state, X, regr, rho_regr, rho_cols_seq, n_levels):
    """Recursive co-kriging posterior of every latent dimension, the HF
    projection and the unscaling: ``CoKriging.predict`` as one function of
    the state.  Like ``CoKriging.predict`` it unscales the MSE through the
    same affine map as the mean (the reference's quirk, kept)."""
    Xn = (X - state["X_mean"][None, :]) / state["X_std"][None, :]
    mean, var = predict_levels_batch(state["levels"], rho_cols_seq, regr,
                                     rho_regr, n_levels - 1, Xn)
    means = mean * state["y_std"][:, None] + state["y_mean"][:, None]
    mses = var * state["y_std"][:, None] ** 2
    scl, cnt = state["X_scl"][:, None], state["X_cnt"][:, None]
    return (_cut(state, scl * (state["Ur"] @ means) + cnt, 0),
            _cut(state, scl * (state["Ur"] @ mses) + cnt, 0))


class CoKrigingSensor:
    """Packaged multifidelity parameter→field sensor of a fitted
    :class:`openmeasure_torch.CoKriging` (after ``manifold_alignment`` and
    ``fit``)::

        sensor = CoKrigingSensor.from_cokriging(ck)
        Y_pred, Y_mse = sensor(X_test)          # (q, d) -> (n, q), (n, q)

    The output orientation is ``CoKriging.predict``'s.  The state lives on
    the basis's device in its dtype."""

    def __init__(self, regr, rho_regr, rho_cols_seq, n_levels, state):
        self.regr = regr
        self.rho_regr = rho_regr
        self.rho_cols_seq = tuple(rho_cols_seq)
        self.n_levels = int(n_levels)
        self._state = state
        self.d = int(state["X_mean"].shape[0])
        self.n = int(state["Ur"].shape[0])

    @classmethod
    def from_cokriging(cls, ck) -> "CoKrigingSensor":
        """Package ``ck`` on its basis's device in the basis's dtype: the
        level state is cast to it, a host-engine fit's float64 levels
        included (the JAX package casts to its ambient default float)."""
        if not hasattr(ck, "_batch"):
            raise AttributeError(
                "CoKrigingSensor needs a CoKriging fitted with the batched "
                "engine (call manifold_alignment() then fit()).")
        b = ck._batch
        Ur = ck.Ur_hf[:, :ck.n_latent]
        dev, dtype = Ur.device, Ur.dtype

        def t(x):
            return as_tensor(x, dev, dtype=dtype)

        state = {
            "levels": [{k: t(v) for k, v in lev.items() if k != "rho_cols"}
                       for lev in b.levels],
            "X_mean": t(b._X_mean),
            "X_std": t(b._X_std),
            "y_mean": t(b._y_mean),
            "y_std": t(b._y_std),
            "Ur": Ur,
            "X_cnt": t(ck.rom_hf.X_cnt)[:, 0],
            "X_scl": t(ck.rom_hf.X_scl)[:, 0],
        }
        rho_cols_seq = tuple(lev["rho_cols"] for lev in b.levels)
        return cls(b._proto.regr, b._proto.rho_regr, rho_cols_seq,
                   b.n_levels, state)

    @classmethod
    def load(cls, path: str,
             device: DeviceLike = None) -> "CoKrigingSensor":
        """Build from a checkpoint of a fitted CoKriging, loaded on
        ``device`` (``None`` means the card)."""
        from .utils.checkpoint import load_model
        return cls.from_cokriging(load_model(path, device=device))

    def shard(self, mesh, axis_name: str = "state") -> "CoKrigingSensor":
        """Multi-card serving: a copy with the n-row HF state (Ur and the
        unscaling vectors) row-sharded over ``mesh`` (see
        :func:`shard_state_rows`): the (n, q) HF projection runs
        shard-local, the latent posterior (tiny) is replicated, and the
        outputs are this rank's rows."""
        return _sharded_copy(self, mesh, axis_name)

    def __call__(self, X_test):
        Ur = self._state["Ur"]
        X_test = as_tensor(X_test, Ur.device, dtype=Ur.dtype)
        if X_test.ndim < 2:
            X_test = X_test[None, :]
        if X_test.shape[1] != self.d:
            raise ValueError(
                f"X_test must be (q, d={self.d}); got "
                f"{tuple(X_test.shape)}.")
        return _ck_predict_math(self._state, X_test, self.regr,
                                self.rho_regr, self.rho_cols_seq,
                                self.n_levels)

    def warmup(self, batch: int = 1) -> "CoKrigingSensor":
        Ur = self._state["Ur"]
        self(torch.zeros((batch, self.d), dtype=Ur.dtype, device=Ur.device))
        if Ur.device.type == "cuda":
            torch.cuda.synchronize(Ur.device)
        return self


# ---------------------------------------------------------------------- #
# Shallow-decoder serving: sensors -> field through the trained MLP
# ---------------------------------------------------------------------- #

def _decoder_predict_kernel(state, Y_values):
    """Scaled-sensor MLP forward + unscale.  Y_values (b, s) -> (b, n)."""
    y0 = (Y_values - state["cnt_sensors"][None, :]) \
        / state["scl_sensors"][None, :]
    X0 = _decoder_forward(state["layers"], y0)
    return _cut(state, X0 * state["X_scl"][None, :] + state["X_cnt"][None, :])


class DecoderSensor:
    """A packaged shallow-decoder soft sensor
    (:class:`openmeasure_torch.sensing.decoder.ShallowDecoder`): sensors →
    full field, one MLP forward per batch, state on ``device`` (``None``
    means the card) in ``dtype``.

    No coefficient or σ outputs: the decoder reconstructs outside the POD
    span and has no closed-form error propagation (use
    :class:`SoftSensor` when σ is needed)."""

    def __init__(self, params, cnt_sensors, scl_sensors, X_cnt, X_scl,
                 dtype=torch.float32, device: DeviceLike = None):
        self.device = resolve_device(device)

        def t(x):
            return as_tensor(x, self.device, dtype=dtype)

        layers = tuple((t(W), t(b)) for W, b in params)
        self.s = int(layers[0][0].shape[0])
        self.n = int(layers[-1][0].shape[1])
        self._state = {
            "layers": layers,
            "cnt_sensors": t(cnt_sensors).reshape(-1),
            "scl_sensors": t(scl_sensors).reshape(-1),
            "X_cnt": t(X_cnt).reshape(-1),
            "X_scl": t(X_scl).reshape(-1),
        }

    @classmethod
    def from_decoder(cls, dec, feature_ids=None,
                     dtype=torch.float32) -> "DecoderSensor":
        """Package a fitted :class:`ShallowDecoder` on its device.
        ``feature_ids`` as in :meth:`SoftSensor.from_spr` (needed for a C
        that is not one-hot)."""
        if not hasattr(dec, "params"):
            raise ValueError("DecoderSensor.from_decoder needs a fitted "
                             "decoder: call dec.fit(C) first.")
        X_cnt = to_numpy(dec.X_cnt)[:, 0]
        X_scl = to_numpy(dec.X_scl)[:, 0]
        cnt_sensors, scl_sensors = _measurement_scaling(
            dec.C, X_cnt, X_scl, dec.n_points, feature_ids)
        return cls(dec.params, cnt_sensors, scl_sensors, X_cnt, X_scl,
                   dtype, device=dec.device)

    @classmethod
    def load(cls, path: str, feature_ids=None, dtype=torch.float32,
             device: DeviceLike = None) -> "DecoderSensor":
        """Build from a checkpoint of a fitted ShallowDecoder, loaded on
        ``device`` (``None`` means the card)."""
        from .utils.checkpoint import load_model
        return cls.from_decoder(load_model(path, device=device),
                                feature_ids=feature_ids, dtype=dtype)

    def shard(self, mesh, axis_name: str = "state") -> "DecoderSensor":
        """Multi-card serving: a copy whose n-sized state is sharded over
        ``mesh``: the output layer's columns, its bias and the unscaling
        vectors split across ranks, so the dominant (hidden × n) product
        runs shard-local with no collective (the hidden activations are
        replicated, tiny).  A non-divisible n is padded with inert columns
        (zero weights and centre, unit scale) and the field output is this
        rank's real columns."""
        import copy
        from .parallel._comm import Axis, active, check_mesh, row_range
        check_mesh(mesh)
        ax = Axis.of(mesh, axis_name)
        a, b, per = row_range(self.n, ax.size, ax.rank)

        def cols(x, v):                   # this rank's columns, padded
            blk = x[..., a:b].to(ax.device)
            if b - a < per:
                pad = torch.full(tuple(x.shape[:-1]) + (per - (b - a),), v,
                                 dtype=x.dtype, device=ax.device)
                blk = torch.cat([blk, pad], dim=-1)
            return blk

        *hidden, (W_out, b_out) = self._state["layers"]
        new = copy.copy(self)
        new._state = dict(self._state)
        new._state.update(
            layers=tuple(hidden) + ((cols(W_out, 0.0), cols(b_out, 0.0)),),
            X_cnt=cols(self._state["X_cnt"], 0.0),
            X_scl=cols(self._state["X_scl"], 1.0),
            n_out=b - a, axis=active(ax))
        return new

    def __call__(self, y_values) -> torch.Tensor:
        """One request: sensor values (s,) → field (n,)."""
        y = as_tensor(y_values, self.device,
                      dtype=self._state["X_cnt"].dtype)
        return _decoder_predict_kernel(self._state, y[None, :])[0]

    def predict_batch(self, Y_values) -> torch.Tensor:
        """A batch (b, s) → fields (b, n) in one call, with no read back
        to the host."""
        Y = as_tensor(Y_values, self.device, dtype=self._state["X_cnt"].dtype)
        if Y.ndim != 2 or Y.shape[1] != self.s:
            raise ValueError(
                f"Y_values must be (batch, s={self.s}); got "
                f"{tuple(Y.shape)}.")
        return _decoder_predict_kernel(self._state, Y)

    def warmup(self) -> "DecoderSensor":
        self(torch.zeros((self.s,), device=self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self


# ---------------------------------------------------------------------- #
# Kalman-filtering soft sensor (reduced-coefficient dynamics)
# ---------------------------------------------------------------------- #

# effective measurement variance of a MISSING reading: the Kalman gain is
# ~1e-12, a pure prediction step, and the SPD innovation solve stays
# well-conditioned in fp32
_KF_MISSING_R = 1e12


def _kf_scale_inputs(state, Y_values, Y_sigma):
    """Scale a measurement series and build the per-step noise variances.
    A non-finite value or σ (NaN, ±inf) marks a MISSING reading: its value
    becomes 0 and its variance :data:`_KF_MISSING_R`, so the filter
    ignores it instead of letting it poison the series."""
    miss = ~(torch.isfinite(Y_values) & torch.isfinite(Y_sigma))
    Yv = torch.where(miss, torch.zeros_like(Y_values), Y_values)
    Y0 = (Yv - state["cnt_sensors"][None, :]) / state["scl_sensors"][None, :]
    R = torch.square(torch.where(miss, torch.zeros_like(Y_sigma), Y_sigma)
                     / state["scl_sensors"][None, :])
    # variance floor: with more sensors than modes and σ = 0, Θ P Θᵀ is
    # rank-deficient; the floor keeps the SPD solve well-posed
    R = torch.maximum(R, state["r_floor"])
    R = torch.where(miss, torch.full_like(R, _KF_MISSING_R), R)
    return Y0, R


def _kf_reconstruct(state, A_coef):
    return _cut(state, (A_coef @ state["Ur"].T) * state["X_scl"][None, :]
                + state["X_cnt"][None, :])


def _kf_serve_series(state, Y_values, Y_sigma, a0, P0):
    """Kalman filtering of a measurement series in scaled space and the
    field reconstruction, with no read back to the host.  Returns (fields
    (K, n), means (K, r), variances (K, r), (a_K, P_K), rejected (K, s))."""
    Y0, R = _kf_scale_inputs(state, Y_values, Y_sigma)
    A_filt, var, carry, rej = kalman_filter(
        state["A"], state["Q"], state["Theta"], a0, P0, Y0, R,
        gate=state["gate"], return_rejected=True)
    return _kf_reconstruct(state, A_filt), A_filt, var, carry, rej


def _kf_smooth_series(state, Y_values, Y_sigma, a0, P0):
    """The RTS-smoothed variant of :func:`_kf_serve_series`: every frame
    conditions on the whole series.  The carry is the forward filter's
    final state."""
    Y0, R = _kf_scale_inputs(state, Y_values, Y_sigma)
    A_sm, var, carry, rej = kalman_smoother(
        state["A"], state["Q"], state["Theta"], a0, P0, Y0, R,
        gate=state["gate"], return_rejected=True)
    return _kf_reconstruct(state, A_sm), A_sm, var, carry, rej


class DynamicSensor:
    """Kalman-filtering soft sensor over a TIME SERIES of measurements.

    Packages a trained, time-ordered :class:`openmeasure_torch.SPR` with
    reduced-coefficient dynamics ``a_{k+1} = A a_k + w`` identified from
    the training coefficients, and filters incoming noisy measurements
    against the gappy model ``y0 = Θ a + v`` the static sensor solves per
    frame.  State on ``device`` (``None`` means the card) in ``dtype``::

        sensor = DynamicSensor.from_spr(spr)
        fields, A, var = sensor.filter_batch(Y, Y_sigma)   # series (K, s)
        x_t, a_t, var_t = sensor.step(y_t, sigma_t)        # streaming

    :meth:`step` advances the internal (a, P) carry; :meth:`filter_batch`
    starts from the stored prior unless ``persist=True`` (then it starts
    from and rolls forward the carry).  NaN (or infinite) readings mark
    dropped sensors; ``gate=g`` rejects entries whose innovation exceeds
    g predicted standard deviations.  ``last_rejected`` holds the most
    recent call's (K, s) rejection mask."""

    def __init__(self, Ur, Theta, cnt_sensors, scl_sensors, X_cnt, X_scl,
                 A, Q, a0, P0, dtype=torch.float32, r_floor: float = 1e-6,
                 gate: Optional[float] = None, device: DeviceLike = None):
        self.device = resolve_device(device)

        def t(x):
            return as_tensor(x, self.device, dtype=dtype)

        self.Ur = t(Ur)
        self.Theta = t(Theta)
        self.r = int(self.Theta.shape[1])
        self.s = int(self.Theta.shape[0])
        self.n = int(self.Ur.shape[0])
        if gate is not None and not float(gate) > 0:
            raise ValueError(f"gate must be a positive number of predicted "
                             f"standard deviations; got {gate}.")
        self._state = {
            "Ur": self.Ur, "Theta": self.Theta,
            "cnt_sensors": t(cnt_sensors), "scl_sensors": t(scl_sensors),
            "X_cnt": t(X_cnt).reshape(-1), "X_scl": t(X_scl).reshape(-1),
            "A": t(A), "Q": t(Q),
            # squared: compared against variances
            "r_floor": t(float(r_floor) ** 2),
            # innovation-gating threshold (inf = disabled)
            "gate": t(float("inf") if gate is None else float(gate)),
        }
        self._a0 = t(a0)
        self._P0 = t(P0)
        self.last_rejected = None
        self.reset()

    def _filter(self, Yv, Ys, a0, P0):
        return _kf_serve_series(self._state, Yv, Ys, a0, P0)

    def _smooth(self, Yv, Ys, a0, P0):
        return _kf_smooth_series(self._state, Yv, Ys, a0, P0)

    @classmethod
    def from_spr(cls, spr, ridge: float = 0.0, q_floor: float = 1e-8,
                 feature_ids=None, dtype=torch.float32,
                 r_floor: float = 1e-6,
                 gate: Optional[float] = None) -> "DynamicSensor":
        """Package a trained SPR whose snapshots were TIME-ORDERED with a
        uniform sampling interval, on the model's device.  A, Q and P0
        are identified on the host in float64 from the fitted ``Ar``; the
        filter starts at the last training coefficient with the identified
        model's stationary covariance (a scaled Q for unstable
        dynamics)."""
        if getattr(spr, "Theta", None) is None:
            raise ValueError(
                "DynamicSensor.from_spr needs a trained SPR: call "
                "spr.fit() and spr.train() first.")
        if not hasattr(spr, "Ar"):
            raise ValueError(
                "DynamicSensor.from_spr needs the fitted coefficients Ar "
                "(fit with the standard POD path).")
        Ar = to_numpy(spr.Ar).astype(np.float64)
        A = fit_reduced_operator(Ar, ridge=ridge)
        Q = estimate_process_noise(A, Ar, floor_rel=q_floor)
        P0 = stationary_covariance(A, Q)
        a0 = Ar[-1]
        X_cnt = to_numpy(spr.X_cnt)[:, 0]
        X_scl = to_numpy(spr.X_scl)[:, 0]
        cnt_sensors, scl_sensors = _measurement_scaling(
            spr.C, X_cnt, X_scl, spr.n_points, feature_ids)
        return cls(spr.Ur, spr.Theta, cnt_sensors, scl_sensors,
                   X_cnt, X_scl, A, Q, a0, P0, dtype=dtype,
                   r_floor=r_floor, gate=gate, device=spr.device)

    @classmethod
    def load(cls, path: str, ridge: float = 0.0, q_floor: float = 1e-8,
             feature_ids=None, dtype=torch.float32, r_floor: float = 1e-6,
             gate: Optional[float] = None,
             device: DeviceLike = None) -> "DynamicSensor":
        """Build from a checkpoint of a trained SPR (it carries ``Ar``, so
        the dynamics are identified again on load), loaded on ``device``
        (``None`` means the card)."""
        from .utils.checkpoint import load_model
        return cls.from_spr(load_model(path, device=device), ridge=ridge,
                            q_floor=q_floor, feature_ids=feature_ids,
                            dtype=dtype, r_floor=r_floor, gate=gate)

    def shard(self, mesh, axis_name: str = "state") -> "DynamicSensor":
        """Multi-card serving: a copy with the n-row state (Ur and the
        unscaling vectors) row-sharded over ``mesh`` (see
        :func:`shard_state_rows`): the (r, s)-sized filter is replicated,
        only the (K, n) reconstruct splits, and a field output is this
        rank's rows.  The copy's carry starts at the packaged prior."""
        new = _sharded_copy(self, mesh, axis_name,
                            row_keys=("Ur", "X_cnt", "X_scl"))
        new.Ur = new._state["Ur"]
        return new.reset()

    # ------------------------------------------------------------------ #

    def _coerce(self, Y_values, Y_sigma):
        Y_values = as_tensor(Y_values, self.device, dtype=self.Ur.dtype)
        if Y_values.ndim != 2 or Y_values.shape[1] != self.s:
            raise ValueError(
                f"measurement series must be (frames, s={self.s}); got "
                f"{tuple(Y_values.shape)}.")
        if Y_sigma is None:
            Y_sigma = torch.zeros_like(Y_values)
        else:
            Y_sigma = torch.broadcast_to(
                as_tensor(Y_sigma, self.device, dtype=self.Ur.dtype),
                Y_values.shape)
        return Y_values, Y_sigma

    def filter_batch(self, Y_values, Y_sigma=None, persist: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Filter a (K, s) measurement series: (fields (K, n), coefficient
        means (K, r), coefficient variances (K, r)), with no read back to
        the host.  ``persist=True`` continues from, and advances, the
        streaming carry instead of the stored prior."""
        Y_values, Y_sigma = self._coerce(Y_values, Y_sigma)
        a, P = (self._a, self._P) if persist else (self._a0, self._P0)
        X, A_filt, var, carry, rej = self._filter(Y_values, Y_sigma, a, P)
        self.last_rejected = rej
        if persist:
            self._a, self._P = carry
        return X, A_filt, var

    def smooth_batch(self, Y_values, Y_sigma=None, persist: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """RTS-smooth a recorded (K, s) series: every frame conditions on
        all K measurements.  Returns as :meth:`filter_batch`;
        ``persist=True`` advances the carry with the FORWARD filter's final
        state, so a later :meth:`step` continues as if the series had been
        filtered."""
        Y_values, Y_sigma = self._coerce(Y_values, Y_sigma)
        a, P = (self._a, self._P) if persist else (self._a0, self._P0)
        X, A_sm, var, carry, rej = self._smooth(Y_values, Y_sigma, a, P)
        self.last_rejected = rej
        if persist:
            self._a, self._P = carry
        return X, A_sm, var

    def forecast(self, horizon: int, persist: bool = False,
                 from_carry: Optional[bool] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Predict the next ``horizon`` frames with NO measurements: the
        rollout ``a_{k+1} = A a_k`` with variances growing by ``P → A P Aᵀ
        + Q``, as the filter over an all-missing series.

        ``from_carry=True`` starts from the live streaming carry,
        ``False`` from the packaged prior; the default follows
        ``persist``.  ``persist=True`` writes the rolled-forward state back
        to the carry."""
        q = int(horizon)
        if q < 1:
            raise ValueError(f"horizon must be >= 1; got {horizon}.")
        if from_carry is None:
            from_carry = persist
        Y, Ys = self._coerce(torch.full((q, self.s), float("nan"),
                                        dtype=self.Ur.dtype,
                                        device=self.device), None)
        a, P = (self._a, self._P) if from_carry else (self._a0, self._P0)
        X, A_f, var, carry, _rej = self._filter(Y, Ys, a, P)
        # not written to last_rejected: the synthetic all-missing series
        # never gates and would blank the last real call's health signal
        if persist:
            self._a, self._P = carry
        return X, A_f, var

    def step(self, y_values, y_sigma=None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One streaming frame: advances the carry and returns (field
        (n,), coefficients (r,), coefficient variances (r,))."""
        y_values = as_tensor(y_values, self.device, dtype=self.Ur.dtype)
        if tuple(y_values.shape) != (self.s,):
            raise ValueError(
                f"y_values must be (s={self.s},); got "
                f"{tuple(y_values.shape)}.")
        sig = (torch.zeros((1, self.s), dtype=self.Ur.dtype,
                           device=self.device) if y_sigma is None
               else torch.broadcast_to(
                   as_tensor(y_sigma, self.device, dtype=self.Ur.dtype),
                   (1, self.s)))
        X, A_filt, var, carry, rej = self._filter(y_values[None, :], sig,
                                                  self._a, self._P)
        self.last_rejected = rej
        self._a, self._P = carry
        return X[0], A_filt[0], var[0]

    def reset(self) -> "DynamicSensor":
        """Reset the streaming carry to the packaged prior."""
        self._a, self._P = self._a0, self._P0
        return self

    def warmup(self, batch: int = 1) -> "DynamicSensor":
        """Run the filter and the smoother once on a series of ``batch``
        frames, so the first real call finds the library handles and
        workspaces made."""
        Y = torch.zeros((batch, self.s), dtype=self.Ur.dtype,
                        device=self.device)
        self._filter(Y, Y, self._a0, self._P0)
        self._smooth(Y, Y, self._a0, self._P0)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def rejected_fraction(self) -> float:
        """Fraction of measurement entries gated as outliers in the most
        recent filter/smooth/step call (0.0 when gating is disabled); one
        host read."""
        if getattr(self, "last_rejected", None) is None:
            return 0.0
        return float(torch.mean(self.last_rejected.to(torch.float32)))
