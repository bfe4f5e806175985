"""GPR: the Gaussian-process reduced-order model (port of
``openmeasure_tpu/gp/gpr.py``, the fit/train/predict flow).

* ``gpr_type='SingleTask'``: r independent exact GPs over the normalized
  POD coefficients Vr, trained as ONE batched Adam run with per-mode early
  stopping (a leading mode axis on every parameter);
* ``gpr_type='MultiTask'``: a batch-independent multitask GP with a shared
  multitask likelihood (global + per-task noise).

Defaults match the reference: ConstantMean, Matérn-2.5 kernel, Gaussian /
multitask-Gaussian likelihood, Adam(lr=0.1), max_iter=1000,
rel_error=1e-5.

``engine='host'`` runs the GP stage (training, posteriors) with the same
torch functions on the host CPU in float64 (:mod:`..core.host64`), on top
of the basis fitted on the model's device; its results stay on the host.
It also scales the test points in float64 (the JAX package scales them in
the ambient dtype first), so the whole GP stage runs in double.

Constrained prediction (MultiTask only): each test point's posterior mean
is replaced by the MAP of its posterior Gaussian under the stacked
``limits``/``bc``/``constraints`` set, one batched whitened ADMM over the
points (:func:`..linalg.boxls.box_constrained_map`).  With
``engine='host'`` the posterior is the host float64 one, the ADMM runs on
the model's device in the basis's dtype (as the JAX package's runs on its
device whatever the engine), and the result comes back to the host in
float64 like every host-engine prediction.

``update`` assimilates new (P, A) pairs into the training set (extending
``Vr_sigma`` and an installed fixed-noise likelihood) and optionally
retrains: MultiTask reruns Adam from the current hyperparameters,
SingleTask swaps in a ``FixedNoiseGaussianLikelihood`` of the data
variances.  :class:`PIGPR` trains with a physics-informed added loss,
differentiated by autograd through the posterior at constraint points
(on the card, through ``csrc/chol.cu``).  ``update_basis`` folds new
(parameter, snapshot) pairs into both the POD basis (Brand's incremental
update, :meth:`ROM.update_basis`) and the GP training set, and optionally
retrains.  The JAX package's documented deviations from the
reference (``Vr_sigma`` at the trained hyperparameters, SingleTask
constrained predict raising, ``update`` extending the MultiTask training
set and ``Vr_sigma`` with the prior stddev) carry over.

Documented deviations: ``PIGPR.train`` raises ``ValueError`` on a model
whose ``engine`` is ``'host'``, where the JAX package's silently switches
it to ``'device'``; ``update_basis(retrain=True)`` across a change of rank
trains afresh under the model's own engine, where the JAX package's
``train`` call falls back to its default ``'device'``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..core import scaling as _scaling
from ..core.device import DeviceLike, as_tensor, to_numpy
from ..core.host64 import tree_f64
from ..linalg import boxls as _boxls
from ..linalg import svd as _svd
from ..rom.rom import ROM
from ..utils import logging as _log
from . import exact_gp as E
from . import kernels as K


class MultitaskPosterior(NamedTuple):
    """Posterior predictive of all modes at the evaluation points."""
    mean: torch.Tensor     # (n_points, r)
    stddev: torch.Tensor   # (n_points, r)


def posterior_all_modes(mean, kernel, likelihood, gpr_type, params, X, Y,
                        Xs):
    """Noise-inclusive posterior over all modes — the one implementation of
    the SingleTask/MultiTask/FixedNoise branching.  ``Y`` is (p, r).
    Returns ``(means (r, q), variances (r, q))``."""
    if gpr_type == "MultiTask":
        noises = likelihood.noise(params["likelihood"])
        return E.gp_posterior(mean, kernel, params["tasks"], noises, X, Y.T,
                              Xs, include_noise=True)
    if isinstance(likelihood, K.FixedNoiseGaussianLikelihood):
        nz = likelihood.noise(params["likelihood"])          # (r, p)
        return E.gp_posterior(mean, kernel, params, nz, X, Y.T, Xs,
                              include_noise=True,
                              pred_noise=torch.mean(nz, dim=-1))
    nz = likelihood.noise(params["likelihood"])
    return E.gp_posterior(mean, kernel, params, nz, X, Y.T, Xs,
                          include_noise=True)


def _stack_params(params, r):
    return E.tree_map(lambda x: x.expand((r,) + x.shape).clone(), params)


class GPR(ROM):
    """GPR-based ROM: ``GPR(X, n_features, xyz, P, gpr_type='SingleTask',
    device=None)`` with P (m, d) the parameters of the m snapshots."""

    def __init__(self, X, n_features, xyz, P, gpr_type: str = "SingleTask",
                 device: DeviceLike = None):
        super().__init__(X, n_features, xyz, device=device)
        self.P = P
        self.gpr_type = gpr_type
        if P.shape[0] != X.shape[1]:
            raise Exception(
                f"The number of parameters ({P.shape[0]}) is different"
                f" from the number of columns of X ({X.shape[1]})")

    # ------------------------------------------------------------------ #
    # Scaling + fit
    # ------------------------------------------------------------------ #

    def scale_GPR_data(self, P, scale_type: str):
        """Scale the parameters column by column; returns P0 and keeps
        ``P_cnt``/``P_scl``.  P takes the dtype of the fitted snapshots
        (the JAX package's ambient dtype)."""
        P = self._t(P)
        if hasattr(self, "X_cnt"):
            P = P.to(self.X_cnt.dtype)
        P0, P_cnt, P_scl = _scaling.scale_parameters(P, scale_type)
        # same degenerate-scale guard as ROM.scale_data (the JAX package's
        # documented deviation): a constant parameter column zeroes its
        # scale under most scale types, and the NaN would silently poison
        # every GP fit on that input.  Constancy is tested directly.
        scl = to_numpy(P_scl)[0]
        bad = ~(np.isfinite(scl) & (scl != 0))
        if scale_type in ("std", "pareto", "range", "variance",
                          "vast", "vast_2", "vast_3", "vast_4"):
            bad |= np.ptp(to_numpy(P), axis=0) == 0
        bad = np.flatnonzero(bad)
        if bad.size:
            raise ValueError(
                f"scale_GPR_data(scale_type={scale_type!r}): parameter "
                f"column(s) {bad.tolist()} have a zero or non-finite "
                f"scale factor (values {scl[bad].tolist()}) — typically "
                "a constant design parameter. Drop the column or use "
                "scale_type='none'.")
        self.P_cnt = P_cnt
        self.P_scl = P_scl
        return P0

    @_log.spanned("gpr.fit")
    def fit(self, scaleX_type: str = "std", scaleP_type: str = "std",
            axis_cnt: Optional[int] = 1, select_modes: str = "variance",
            n_modes=99, verbose: bool = False, basis=None, config=None,
            deflate=False):
        """``config`` (:class:`openmeasure_torch.core.config.FitConfig`)
        overrides the individual kwargs (its ``scale_type`` applies to both
        X and P).  ``basis=(Ur, Ar)`` skips the decomposition.

        ``deflate=True`` (or an explicit split index k) recomputes the
        selected basis with the two-block deflated Gram route
        (:func:`openmeasure_torch.linalg.svd.svd_tall_deflated`) after rank
        selection, for per-mode accuracy of the deep-tail modes."""
        if config is not None:
            scaleX_type = config.scale_type
            scaleP_type = config.scale_type
            axis_cnt = config.axis_cnt
            select_modes = config.select_modes
            n_modes = config.n_modes
        self.scaleX_type = scaleX_type
        self.scaleP_type = scaleP_type
        self.select_modes = select_modes
        self.n_modes = n_modes
        self.verbose = verbose

        if deflate and basis is not None:
            raise ValueError(
                "deflate= has no effect with basis= (there is no "
                "decomposition to deflate); drop one of them.")
        self.X0 = self.scale_data(scaleX_type, axis_cnt)
        if basis is None:
            Ur, Ar, _ = self.decomposition(self.X0, select_modes, n_modes)
            if deflate:
                k = self.r // 2 if deflate is True else int(deflate)
                if not 0 < k < self.r:
                    raise ValueError(
                        f"deflate split must satisfy 0 < k < r={self.r} "
                        f"(got k={k}; deflate=True needs r >= 2) — the "
                        "requested tail-accuracy knob cannot silently "
                        "no-op.")
                U2, S2, Vt2 = _svd.svd_tall_deflated(self.X0, rank=self.r,
                                                     deflate=k)
                Ur, Vt2r = _svd._sign_canonicalize(U2, Vt2[:self.r])
                Ar = (S2[:self.r, None] * Vt2r).T
        else:
            Ur, Ar = self._t(basis[0]), self._t(basis[1])

        self.Ur = Ur
        self.Ar = Ar
        self.r = Ar.shape[1]
        self.d = self.P.shape[1]

        self.Sigma_r = torch.linalg.vector_norm(Ar, dim=0)
        self.Vr = Ar / self.Sigma_r[None, :]
        self.P0 = self.scale_GPR_data(self.P, scaleP_type)
        self._invalidate_trained_state()

    def _invalidate_trained_state(self):
        """Refit hook: the trained hyperparameters and training set were
        built on the OLD basis's coefficients — drop them so predict
        demands train() again."""
        for a in ("params", "models", "likelihoods", "Vr_sigma",
                  "_final_loss", "_iterations", "_train_X", "_train_Y"):
            if hasattr(self, a):
                delattr(self, a)

    # ------------------------------------------------------------------ #
    # Train
    # ------------------------------------------------------------------ #

    def _default_specs(self, mean, kernel, likelihood):
        if mean is None:
            mean = K.ConstantMean()
        if kernel is None:
            kernel = K.MaternKernel(2.5)
        if likelihood is None:
            if self.gpr_type == "MultiTask":
                likelihood = K.MultitaskGaussianLikelihood(num_tasks=self.r)
            else:
                likelihood = K.GaussianLikelihood()
        return mean, kernel, likelihood

    def _init_task_params(self, mean, kernel, likelihood, like):
        p = {"mean": mean.init_params(self.d, **like),
             "kernel": kernel.init_params(self.d, **like)}
        if isinstance(likelihood, K.GaussianLikelihood):
            p["likelihood"] = likelihood.init_params(**like)
        return p

    @_log.spanned("gpr.train")
    def train(self, mean=None, kernel=None, likelihood=None,
              max_iter: int = 1000, rel_error: float = 1e-5, lr: float = 0.1,
              verbose: bool = False, config=None, engine: str = "device"):
        """Train the GP hyperparameters.  ``config``
        (:class:`openmeasure_torch.core.config.GPTrainConfig`) overrides
        max_iter/rel_error/lr/verbose/engine when given.

        ``engine='host'`` runs the GP stage — this training and every later
        posterior — on the host CPU in float64 (the reference trains in
        double); the default ``'device'`` runs it on the model's device in
        the basis's dtype.  Returns ``(models, likelihoods)``, the
        reference's API views."""
        if config is not None:
            max_iter = config.max_iter
            rel_error = config.rel_error
            lr = config.lr
            verbose = config.verbose
            engine = getattr(config, "engine", engine)
        if engine not in ("device", "host"):
            raise ValueError(
                f"engine must be 'device' or 'host'; got {engine!r}")
        self.engine = engine
        self.max_iter = max_iter
        self.rel_error = rel_error
        self.lr = lr
        self.verbose = verbose

        mean, kernel, likelihood = self._default_specs(mean, kernel,
                                                       likelihood)
        # fail at the API boundary: each gpr_type supports exactly one
        # likelihood family
        if self.gpr_type == "MultiTask":
            if not isinstance(likelihood, K.MultitaskGaussianLikelihood):
                raise TypeError(
                    "MultiTask training needs a MultitaskGaussian"
                    f"Likelihood; got {type(likelihood).__name__}.")
        elif not isinstance(likelihood, K.GaussianLikelihood):
            raise TypeError(
                "SingleTask training needs a GaussianLikelihood; got "
                f"{type(likelihood).__name__}.")
        self.mean = mean
        self.kernel = kernel
        self.likelihood = likelihood

        P0, Vr = self.P0, self.Vr
        self._train_X = P0
        self._train_Y = Vr
        like = dict(dtype=P0.dtype, device=P0.device)

        if self.gpr_type == "MultiTask":
            params0 = {
                "tasks": _stack_params(
                    self._init_task_params(mean, kernel, likelihood, like),
                    self.r),
                "likelihood": likelihood.init_params(**like),
            }
            self.params, res = self._multitask_adam(params0, P0, Vr)
            Vr_sigma = self._prior_stddev_all(self.params["tasks"], P0)
        else:
            params0 = _stack_params(
                self._init_task_params(mean, kernel, likelihood, like),
                self.r)
            res = self._single_task_adam(params0, likelihood, P0, Vr)
            self.params = res.params
            Vr_sigma = self._prior_stddev_all(self.params, P0)
        self._final_loss = res.loss
        self._iterations = res.iterations
        self.Vr_sigma = Vr_sigma
        if verbose:
            print(f"GP training done - final loss per model: "
                  f"{to_numpy(res.loss)}; iterations: "
                  f"{to_numpy(res.iterations)}")
        self._refresh_api_compat()
        return self.models, self.likelihoods

    def _run_gp_stage(self, fn, *args):
        """Run one GP compute stage under the model's engine: ``'device'``
        calls through on the arguments as they are; ``'host'`` calls the
        same function on host float64 copies of every argument and keeps
        the results on the host."""
        if getattr(self, "engine", "device") == "host":
            return fn(*[tree_f64(a) for a in args])
        return fn(*args)

    def _prior_stddev_all(self, task_params, P0):
        """(p, r) prior stddev at P0 under the engine — what the reference
        records as ``Vr_sigma``."""
        def run(tp, X):
            return E.gp_prior_stddev(self.mean, self.kernel, tp, X).T
        return self._run_gp_stage(run, task_params, P0)

    def _single_task_adam(self, params0, likelihood, P0, Vr):
        """One batched single-task Adam/early-stop run under the engine
        (loss builder + closed-form oracle; autograd where the oracle does
        not cover the specs)."""
        def run(params0, P0, Vr):
            loss_fn = E.make_single_task_loss(self.mean, self.kernel,
                                              likelihood, P0, Vr.T)
            vag = E.make_single_task_value_and_grad(
                self.mean, self.kernel, likelihood, P0, Vr.T)
            return E.adam_early_stop(loss_fn, params0, lr=self.lr,
                                     max_iter=self.max_iter,
                                     rel_error=self.rel_error,
                                     value_and_grad=vag)
        return self._run_gp_stage(run, params0, P0, Vr)

    def _multitask_adam(self, params, P0, Vr):
        """One MultiTask Adam/early-stop run from ``params`` on (P0, Vr),
        under the engine: the parameters get a leading axis of 1 for the
        shared trainer.  Returns (unbatched params, TrainResult)."""
        def run(params, P0, Vr):
            loss_raw = E.make_multitask_loss(self.mean, self.kernel,
                                             self.likelihood, P0, Vr)
            params_b = E.tree_map(lambda x: x[None], params)

            def loss_fn(pb):
                return loss_raw(E.tree_map(lambda x: x[0], pb))

            vag_raw = E.make_multitask_value_and_grad(
                self.mean, self.kernel, self.likelihood, P0, Vr)
            vag = None
            if vag_raw is not None:
                def vag(pb):
                    losses, grads = vag_raw(E.tree_map(lambda x: x[0], pb))
                    return losses, E.tree_map(lambda g: g[None], grads)
                vag.capturable = vag_raw.capturable
            res = E.adam_early_stop(loss_fn, params_b, lr=self.lr,
                                    max_iter=self.max_iter,
                                    rel_error=self.rel_error,
                                    value_and_grad=vag)
            return E.tree_map(lambda x: x[0], res.params), res
        return self._run_gp_stage(run, params, P0, Vr)

    def _refresh_api_compat(self):
        """Rebuild the reference-parity ``models``/``likelihoods`` views
        from the current params/likelihood."""
        if self.gpr_type == "MultiTask":
            self.models = [self.params]
            self.likelihoods = [self.likelihood]
        else:
            self.models = [E.tree_map(lambda x, i=i: x[i], self.params)
                           for i in range(self.r)]
            self.likelihoods = [self.likelihood] * self.r

    # ------------------------------------------------------------------ #
    # Predict
    # ------------------------------------------------------------------ #

    def _posterior_all(self, P0_star) -> MultitaskPosterior:
        """Noise-inclusive posterior at scaled test points, all modes,
        under the engine."""
        def run(params, X, Y, Xs):
            means, variances = posterior_all_modes(
                self.mean, self.kernel, self.likelihood, self.gpr_type,
                params, X, Y, Xs)
            return means.T, torch.sqrt(variances).T
        m, s = self._run_gp_stage(run, self.params, self._train_X,
                                  self._train_Y, P0_star)
        return MultitaskPosterior(mean=m, stddev=s)

    def _state_constraint_parts(self, limits, bc):
        """State-space constraint parts of the constrained MAP: the
        physical ``limits`` box on ``S = Ur·diag(Σ_r)`` and the ``bc``
        equality pins, scaled with the model's own statistics — shared by
        :meth:`predict` and ``serving.GPRSensor.from_gpr``.  ``bc`` values
        are (n_bc,) fixed or (n_bc, n_p) per point; callers validate the
        shape policy.  ``S`` is built only when a part needs it."""
        parts = []
        if limits is None and bc is None:
            return parts
        S = self.Ur * self.Sigma_r[None, :]
        if limits is not None:
            lo_b, hi_b = self.scale_limits(limits)
            parts.append(_boxls.LinearConstraints(S, lo_b, hi_b))
        if bc is not None:
            rows = np.asarray(bc[0], dtype=int)
            values = np.asarray(bc[1], dtype=float)
            cnt = to_numpy(self.X_cnt)[rows, 0]
            scl = to_numpy(self.X_scl)[rows, 0]
            if values.ndim == 1:
                v0 = (values - cnt) / scl
            else:
                v0 = ((values - cnt[:, None]) / scl[:, None]).T
            v0 = as_tensor(v0, self.device)
            rows_t = torch.as_tensor(rows, device=self.device)
            parts.append(_boxls.LinearConstraints(S[rows_t, :], v0, v0))
        return parts

    @_log.spanned("gpr.predict")
    def predict(self, P_star, problem_dict=None, limits=None, bc=None,
                constraints=None, **kwargs):
        """Posterior POD coefficients at new parameters ``P_star`` (n_p, d)
        or (d,).  Returns ``(A_pred, A_sigma)``, each (n_p, r): on the
        model's device, or on the host in float64 for ``engine='host'``.

        Constrained prediction (MultiTask only): each point's posterior
        mean is replaced by the MAP of its posterior Gaussian under the
        constraint set, one batched whitened ADMM over the points.  The set
        composes from ``limits=[min, max]`` (per-feature box on the
        reconstructed field), ``bc=(rows, values)`` (state-row equality
        pins, ``values`` (n_bc, n_p) per point or (n_bc,)) and
        ``constraints`` (a :class:`..linalg.boxls.LinearConstraints` on the
        normalized coefficients v, bounds optionally batched over points);
        ``problem_dict={'limits':…, 'bc':…, 'constraints':…}`` is accepted
        for signature parity with the reference.  ``max_iter`` (4000) and
        ``tol`` (1e-9) of the ADMM come from ``kwargs``."""
        if not hasattr(self, "models"):
            raise AttributeError("The function fit has to be called "
                                 "before calling predict.")
        host = getattr(self, "engine", "device") == "host"
        P_star = as_tensor(P_star, self.device, dtype=self.P_cnt.dtype)
        if P_star.ndim < 2:
            P_star = P_star[None, :]
        n_p = P_star.shape[0]
        cnt, scl = self.P_cnt[0], self.P_scl[0]
        if host:
            # the host engine scales the test points in float64 too: the
            # whole GP stage, inputs included, runs in double
            P_star, cnt, scl = (tree_f64(t) for t in (P_star, cnt, scl))
        P0_star = (P_star - cnt[None, :]) / scl[None, :]

        post = self._posterior_all(P0_star)
        V_pred, V_sigma = post.mean, post.stddev

        if problem_dict is not None:
            limits = limits if limits is not None else problem_dict.get(
                "limits")
            bc = bc if bc is not None else problem_dict.get("bc")
            constraints = constraints if constraints is not None else \
                problem_dict.get("constraints")
        if bc is not None:
            values = np.asarray(bc[1], dtype=float)
            if values.ndim == 1:
                values = values[:, None]
            if values.shape[1] != n_p:
                raise ValueError(
                    f"bc values must be (n_bc, n_p={n_p}); got "
                    f"{values.shape}")
            bc = (bc[0], values)
        parts = self._state_constraint_parts(limits, bc)
        if constraints is not None:
            cs_user, _ = _boxls.build_constraint_set(constraints, None)
            parts.append(cs_user)

        if parts:
            if self.gpr_type != "MultiTask":
                raise NotImplementedError(
                    "Constrained prediction only works for MultiTask models.")
            cs = _boxls.concat_constraints(parts)
            A, lo, hi = (as_tensor(x, self.device, dtype=self.Ur.dtype)
                         for x in cs)
            mu, sig = (as_tensor(x, self.device, dtype=self.Ur.dtype)
                       for x in (V_pred, V_sigma))
            V_pred, _ = _boxls.box_constrained_map(
                mu, torch.diag_embed(sig ** 2), A, lo, hi, AtA=A.T @ A,
                max_iter=kwargs.get("max_iter", 4000),
                tol=kwargs.get("tol", 1e-9))
            if host:
                V_pred = tree_f64(V_pred)

        sig = tree_f64(self.Sigma_r) if host else self.Sigma_r
        return V_pred * sig[None, :], V_sigma * sig[None, :]

    @_log.spanned("gpr.reconstruct")
    def reconstruct(self, Ar, sampling=None):
        """:meth:`ROM.reconstruct`, in one ``gpr.reconstruct`` span."""
        return super().reconstruct(Ar, sampling)

    # ------------------------------------------------------------------ #
    # Update
    # ------------------------------------------------------------------ #

    def _guard_pigpr_retrain(self, retrain):
        """The standard retrain loop would silently drop PIGPR's added-loss
        term: reject before any state changes."""
        if retrain and isinstance(self, PIGPR):
            raise ValueError(
                "PIGPR cannot retrain with the standard loop (it would "
                "drop the added-loss term); update with retrain=False "
                "and call train() again.")

    def update(self, P_new, A_new, A_sigma_new=None, retrain: bool = False,
               verbose: bool = False):
        """Assimilate new parameter points ``P_new`` (q, d) with their POD
        coefficients ``A_new`` (q, r): the training set grows by them (in
        both GP types — the JAX package's documented deviation), and
        ``Vr_sigma`` by ``A_sigma_new`` / Σ_r, or by the prior stddev at
        the new points when no uncertainties are given.  An installed
        ``FixedNoiseGaussianLikelihood`` grows with it.

        ``retrain=True``: MultiTask reruns Adam from the current
        hyperparameters; SingleTask needs ``A_sigma_new`` and retrains with
        a ``FixedNoiseGaussianLikelihood`` of the variances ``Vr_sigma²``
        (the reference's recipe).  Under ``engine='host'`` the
        bookkeeping and the retrain stay on the host in float64."""
        self._guard_pigpr_retrain(retrain)
        self.verbose = verbose
        host = getattr(self, "engine", "device") == "host"
        cnt, scl = self.P_cnt[0], self.P_scl[0]
        P0_new = (as_tensor(P_new, self.device, dtype=cnt.dtype)
                  - cnt[None, :]) / scl[None, :]
        P0_tot = torch.cat([self._train_X, P0_new], dim=0)
        Vr_new = as_tensor(A_new, self.device,
                           dtype=self.Sigma_r.dtype) / self.Sigma_r[None, :]
        Vr_tot = torch.cat([self._train_Y, Vr_new], dim=0)
        # set_train_data(strict=False)
        self._train_X = P0_tot
        self._train_Y = Vr_tot

        if A_sigma_new is not None:
            Vr_sigma_new = as_tensor(A_sigma_new, self.device,
                                     dtype=self.Sigma_r.dtype) \
                / self.Sigma_r[None, :]
        else:
            # the prior stddev at the new points (what Vr_sigma holds for
            # the original set), so a later fixed-noise retrain stays
            # well-formed
            task_params = (self.params["tasks"]
                           if self.gpr_type == "MultiTask" else self.params)
            Vr_sigma_new = self._prior_stddev_all(task_params, P0_new)
        if host:
            # host-float64 bookkeeping: no round trip through the device
            Vr_sigma_tot = torch.cat([tree_f64(self.Vr_sigma),
                                      tree_f64(Vr_sigma_new)], dim=0)
        else:
            Vr_sigma_tot = torch.cat([self.Vr_sigma, Vr_sigma_new], dim=0)
        self.Vr_sigma = Vr_sigma_tot

        # an installed fixed-noise likelihood must stay as long as the
        # training set, or the next posterior solve fails to broadcast
        if self.gpr_type != "MultiTask" and \
                isinstance(self.likelihood, K.FixedNoiseGaussianLikelihood):
            params = dict(self.params)
            params["likelihood"] = {"fixed_noise": (Vr_sigma_tot ** 2).T}
            self.params = params

        if not retrain:
            return

        if self.gpr_type == "MultiTask":
            self.params, res = self._multitask_adam(self.params, P0_tot,
                                                    Vr_tot)
            self.Vr_sigma = self._prior_stddev_all(self.params["tasks"],
                                                   P0_tot)
        else:
            if A_sigma_new is None:
                raise ValueError(
                    "retrain=True for SingleTask requires A_sigma_new "
                    "(fixed-noise retraining uses the data uncertainties).")
            fixed = K.FixedNoiseGaussianLikelihood()
            params0 = dict(self.params)
            params0["likelihood"] = {
                "fixed_noise": (Vr_sigma_tot ** 2).T}   # (r, p_tot)
            res = self._single_task_adam(params0, fixed, P0_tot, Vr_tot)
            self.params = res.params
            self.likelihood = fixed
            self.Vr_sigma = self._prior_stddev_all(self.params, P0_tot)
        self._final_loss = res.loss
        self._iterations = res.iterations
        self._refresh_api_compat()

    def _guard_no_orphaned_updates(self):
        """update_basis derives the GP training set again from the fitted
        coefficients only; (P, A) pairs assimilated before by update() have
        no raw snapshots to rotate and would vanish: reject instead."""
        if hasattr(self, "_train_X") and \
                int(self._train_X.shape[0]) > int(self.P0.shape[0]):
            raise ValueError(
                "update_basis would silently discard the extra (P, A) "
                "pairs previously assimilated via update() (their raw "
                "snapshots are not retained, so the basis rotation "
                "cannot re-derive their targets). Run update_basis "
                "first and update() after, or refit from the extended "
                "snapshot set.")

    def update_basis(self, X_new, P_new, select_modes: str = "number",
                     n_modes=None, reorth: bool = True,
                     retrain: bool = False, verbose: bool = False):
        """Assimilate new (parameter, snapshot) pairs into BOTH the POD
        basis and the GP regression.

        The basis absorbs the new snapshots by Brand's incremental update
        (:meth:`ROM.update_basis`, frozen scaling statistics), and because
        that update rotates every right factor, the GP targets of the
        ORIGINAL parameter points change too: unlike :meth:`update`, the
        whole training set is set anew (``P0`` extended, the updated
        ``Vr``).  ``P_new`` is scaled with the frozen parameter statistics.

        On a trained model a change of rank orphans the per-mode parameter
        stacks: the trained state is dropped, and ``retrain=True`` trains
        afresh with the saved mean/kernel/likelihood specs (a multitask
        likelihood is rebuilt at the new rank) under the model's engine;
        ``retrain=False`` leaves the model fitted but untrained.  With the
        rank unchanged, ``retrain=True`` reruns the Adam/early-stop loop
        from the CURRENT hyperparameters."""
        self._guard_pigpr_retrain(retrain)
        self._guard_no_orphaned_updates()
        if not isinstance(X_new, torch.Tensor):
            X_new = np.asarray(X_new)
        q = 1 if X_new.ndim == 1 else X_new.shape[1]
        P_new = self._validate_update_params(P_new, q)
        trained = hasattr(self, "params")
        r_old = self.r
        super().update_basis(X_new, select_modes=select_modes,
                             n_modes=n_modes, reorth=reorth)
        self._assimilate_params_after_update(P_new, trained, r_old,
                                             retrain, verbose)

    def _validate_update_params(self, P_new, q):
        """The arriving parameter rows against the arriving snapshot
        count ``q``."""
        P_new = np.atleast_2d(to_numpy(P_new))
        if P_new.shape[0] != q:
            raise Exception(
                f"The number of parameters ({P_new.shape[0]}) is different"
                f" from the number of columns of X ({q})")
        if P_new.shape[1] != self.P.shape[1]:
            raise ValueError(
                f"P_new has {P_new.shape[1]} columns; expected "
                f"{self.P.shape[1]}.")
        return P_new

    def _assimilate_params_after_update(self, P_new, trained, r_old,
                                        retrain, verbose):
        """The GP side after the basis absorbed the new snapshots: extend
        P/P0 with the frozen parameter statistics, set the training set
        anew (the update rotated every right factor), optionally retrain
        from the current hyperparameters."""
        rank_changed = trained and self.r != r_old
        if rank_changed:
            # the (r_old, ...) parameter stacks are orphaned: drop the
            # trained state, the model is fitted but untrained again
            for a in ("params", "models", "likelihoods", "Vr_sigma",
                      "_final_loss", "_iterations", "_train_X", "_train_Y"):
                if hasattr(self, a):
                    delattr(self, a)
            trained = False

        self.P = np.concatenate([to_numpy(self.P), P_new], axis=0)
        cnt, scl = self.P_cnt[0], self.P_scl[0]
        P0_new = (as_tensor(P_new, self.device, dtype=self.P0.dtype)
                  - cnt[None, :]) / scl[None, :]
        self.P0 = torch.cat([self.P0, P0_new], dim=0)

        if not trained:
            if rank_changed and retrain:
                # no (r_old, ...) stacks to start from: train afresh with
                # the saved specs, a multitask likelihood at the new rank
                likelihood = self.likelihood
                if hasattr(likelihood, "num_tasks"):
                    likelihood = type(likelihood)(num_tasks=self.r)
                self.train(mean=self.mean, kernel=self.kernel,
                           likelihood=likelihood, max_iter=self.max_iter,
                           rel_error=self.rel_error, lr=self.lr,
                           verbose=verbose,
                           engine=getattr(self, "engine", "device"))
            elif retrain:
                # a never-trained model has no hyperparameters (or
                # max_iter/lr) to start from
                raise ValueError(
                    "update_basis(retrain=True) needs a trained model — "
                    "call train() first, or retrain=False and train() "
                    "after the update.")
            return

        P0_tot, Vr_tot = self.P0, self.Vr
        self._train_X = P0_tot
        self._train_Y = Vr_tot
        if retrain:
            if self.gpr_type == "MultiTask":
                self.params, res = self._multitask_adam(self.params, P0_tot,
                                                        Vr_tot)
            else:
                res = self._single_task_adam(self.params, self.likelihood,
                                             P0_tot, Vr_tot)
                self.params = res.params
            self._final_loss = res.loss
            self._iterations = res.iterations

        # the prior stddev over the whole set at the (possibly retrained)
        # hyperparameters, as update() keeps it
        task_params = (self.params["tasks"] if self.gpr_type == "MultiTask"
                       else self.params)
        self.Vr_sigma = self._prior_stddev_all(task_params, P0_tot)
        self._refresh_api_compat()


class PIGPR(GPR):
    """Physics-informed GPR (MultiTask only): ``PIGPR(X, n_features, xyz,
    P, P_cstr, AddedLoss, device=None)``.

    ``AddedLoss(ctx) -> scalar`` receives ``ctx = {'output':
    MultitaskPosterior at [train + constraint points], 'loss_ml': detached
    joint log-prob of the training data, 'verbose': ..., 'loss_dict':
    ...}`` and returns a term added to the log-likelihood (so a penalty
    comes back negative), differentiable in torch with respect to the
    posterior — the gpytorch AddedLossTerm contract.  Training runs on the
    model's device by autograd through the posterior; there is no
    host-float64 engine."""

    def __init__(self, X, n_features, xyz, P, P_cstr, AddedLoss: Callable,
                 device: DeviceLike = None):
        super().__init__(X, n_features, xyz, P, "MultiTask", device=device)
        self.P_cstr = P_cstr
        self.AddedLoss = AddedLoss

    def _scaled_constraint_points(self):
        cnt, scl = self.P_cnt[0], self.P_scl[0]
        P0_cstr = (as_tensor(self.P_cstr, self.device, dtype=cnt.dtype)
                   - cnt[None, :]) / scl[None, :]
        return torch.cat([self.P0, P0_cstr], dim=0)

    def _posterior_with(self, params, P0_eval) -> MultitaskPosterior:
        """Noise-inclusive posterior at ``P0_eval`` under ``params`` —
        differentiable (the added loss backpropagates through it)."""
        noises = self.likelihood.noise(params["likelihood"])
        means, variances = E.gp_posterior(
            self.mean, self.kernel, params["tasks"], noises, self.P0,
            self.Vr.T, P0_eval, include_noise=True)
        return MultitaskPosterior(mean=means.T,
                                  stddev=torch.sqrt(variances).T)

    @_log.spanned("gpr.train")
    def train(self, mean=None, kernel=None, likelihood=None,
              max_iter: int = 1000, rel_error: float = 1e-5, lr: float = 0.1,
              verbose: bool = False, loss_dict=None):
        """Adam on the multitask −MLL plus the added loss, by autograd.
        Raises ``ValueError`` if the model's ``engine`` is ``'host'``:
        the added loss is user code differentiated on the device, and the
        JAX package's silent switch to ``'device'`` is not copied."""
        if getattr(self, "engine", "device") == "host":
            raise ValueError(
                "PIGPR trains on the model's device only; its engine is "
                "'host'. Set engine='device' to train (the added loss is "
                "differentiated on the device).")
        self.engine = "device"
        self.max_iter = max_iter
        self.rel_error = rel_error
        self.lr = lr
        self.verbose = verbose

        mean, kernel, likelihood = self._default_specs(mean, kernel,
                                                       likelihood)
        self.mean, self.kernel, self.likelihood = mean, kernel, likelihood
        P0, Vr = self.P0, self.Vr
        self._train_X, self._train_Y = P0, Vr
        P0_tot = self._scaled_constraint_points()
        self.P0_tot = P0_tot

        def added_loss_fn(params, lp):
            return self.AddedLoss({
                "output": self._posterior_with(params, P0_tot),
                "loss_ml": lp.detach(), "verbose": verbose,
                "loss_dict": loss_dict})

        like = dict(dtype=P0.dtype, device=P0.device)
        params0 = {
            "tasks": _stack_params(
                self._init_task_params(mean, kernel, likelihood, like),
                self.r),
            "likelihood": likelihood.init_params(**like),
        }
        loss_raw = E.make_multitask_loss(mean, kernel, likelihood, P0, Vr,
                                         added_loss_fn=added_loss_fn)

        def loss_fn(pb):
            return loss_raw(E.tree_map(lambda x: x[0], pb))

        res = E.adam_early_stop(loss_fn, E.tree_map(lambda x: x[None],
                                                    params0),
                                lr=lr, max_iter=max_iter,
                                rel_error=rel_error)
        self.params = E.tree_map(lambda x: x[0], res.params)
        self._final_loss = res.loss
        self._iterations = res.iterations
        self.Vr_sigma = E.gp_prior_stddev(mean, kernel, self.params["tasks"],
                                          P0).T
        self._refresh_api_compat()
        return self.models, self.likelihoods

    def update_basis(self, X_new, P_new, select_modes: str = "number",
                     n_modes=None, reorth: bool = True,
                     retrain: bool = False, verbose: bool = False):
        """Basis and training-set assimilation (see
        :meth:`GPR.update_basis`).  ``retrain=True`` is rejected: the
        standard loop would drop the physics-informed added loss — call
        :meth:`train` after the update instead."""
        if retrain:
            raise ValueError(
                "PIGPR.update_basis cannot retrain with the standard loop "
                "(it would drop the added-loss term); update with "
                "retrain=False and call train() again.")
        super().update_basis(X_new, P_new, select_modes=select_modes,
                             n_modes=n_modes, reorth=reorth,
                             retrain=False, verbose=verbose)

    def compute_mll(self, mean=None, kernel=None, likelihood=None):
        """The training data's MLL and the posterior mean at [train +
        constraint] points under the initial (untrained) hyperparameters —
        to calibrate added-loss coefficients.  Returns ``(loss_mll (numpy
        scalar), Vr_pred (p + n_cstr, r) tensor)``."""
        mean, kernel, likelihood = self._default_specs(mean, kernel,
                                                       likelihood)
        P0, Vr = self.P0, self.Vr
        like = dict(dtype=P0.dtype, device=P0.device)
        params = {
            "tasks": _stack_params(
                self._init_task_params(mean, kernel, likelihood, like),
                self.r),
            "likelihood": likelihood.init_params(**like),
        }
        noises = likelihood.noise(params["likelihood"])
        loss_mll = torch.sum(E.gp_log_prob(mean, kernel, params["tasks"],
                                           noises, P0, Vr.T))
        saved = tuple(getattr(self, a, None)
                      for a in ("mean", "kernel", "likelihood"))
        self.mean, self.kernel, self.likelihood = mean, kernel, likelihood
        post = self._posterior_with(params, self._scaled_constraint_points())
        if saved[0] is not None:
            self.mean, self.kernel, self.likelihood = saved
        return to_numpy(loss_mll), post.mean
