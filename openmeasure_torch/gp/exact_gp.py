"""Exact GP engine: marginal likelihood, posteriors, the closed-form MLL
gradient oracle and an Adam hyperparameter trainer with per-model early
stopping (port of ``openmeasure_tpu/gp/exact_gp.py``).

Every ``jax.vmap`` over modes of the JAX package is a leading batch axis
here: parameter dicts carry a leading mode axis, and one oracle call
factorizes all r kernel matrices in ONE call of the batched inverse —
on the card one launch of the CUDA kernel (``linalg/chol_cuda.py``), which
is what the JAX package's ``custom_vmap`` rule gives it.  Functions take
and return tensors whose batch dims lead: ``y`` is ``(..., n)``, a noise
is ``(...)`` (one value per model) or ``(..., n)`` (per point), and the
result of a log-prob is ``(...)``.

Which formulation the log-prob core (training) runs is the JAX package's
gate, keyed on the tensor: a CUDA fp32 batch with p ≤ 128 takes the
explicit inverse (α = K⁻¹·resid, logdet from the kernel); a CPU tensor,
float64 or p > 128 takes the Cholesky branch
(:func:`..linalg.chol.cholesky_nan` + ``cholesky_solve``), as JAX does off
the TPU; a failed factorization gives NaN there, as it does in JAX.  The
posterior (:func:`gp_posterior`) takes the Cholesky route on every device:
its variance kss − ‖L⁻¹ksᵀ‖² comes from a triangular solve, where the JAX
package's TPU route takes kss − Σ(Ks K⁻¹ ∘ Ks) from the explicit inverse,
whose cancellation loses the small variances in fp32.

On the card the single-task trainer's iteration, for the specs of
:func:`.gp_step.takes`, is two launches: ``csrc/chol.cu``, then
``csrc/gp_step.cu``, which takes the oracle's gradient, steps Adam and
builds the next K (:mod:`.gp_step`); every other training steps through
its oracle or autograd.

While the recorder of :mod:`..utils.logging` is on, the trainer records a
``gp.adam`` span holding one ``gp.iter`` an Adam iteration enqueued,
counts each read of its stop test on the card in ``host_reads`` (and in
``gp.overlapped_reads`` where a later block was already enqueued) and
each two-launch iteration in ``gp.fused_iters``; a posterior is one
``gp.posterior`` span.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Callable, Dict, NamedTuple, Optional

import torch

from . import gp_step as _gp_step
from . import kernels as K
from ..linalg.chol import chol_inv_logdet, cholesky_nan, kernel_takes
from ..utils import logging as _log
from .kernels import ADAM_B1, ADAM_B2, ADAM_EPS, LOG_2PI


# --------------------------------------------------------------------- #
# Parameter dicts (the JAX package's pytrees)
# --------------------------------------------------------------------- #

def tree_map(fn: Callable, tree, *rest):
    """``fn`` on every leaf of a nested dict (and the matching leaves of
    ``rest``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of a nested dict, keys in sorted order at every level
    (as JAX flattens a dict), so two dicts of one structure list their
    leaves alike whatever order their keys were inserted in."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def _unflatten_like(tree, leaves):
    """A dict of ``tree``'s structure holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(tree)


# --------------------------------------------------------------------- #
# Log-prob core
# --------------------------------------------------------------------- #

def _jitter(dtype) -> float:
    # gpytorch cholesky jitter: 1e-8 double, 1e-6 float
    return 1e-8 if dtype == torch.float64 else 1e-6


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _add_noise(Kxx: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """``K + eye * noise``: ``noise`` is one value per matrix (``Kxx.ndim
    - 2`` dims) or one per point (``Kxx.ndim - 1`` dims, FixedNoise)."""
    eye = _eye(Kxx.shape[-1], Kxx)
    noise = torch.as_tensor(noise, dtype=Kxx.dtype, device=Kxx.device)
    if noise.ndim == Kxx.ndim - 1:
        return Kxx + eye * noise[..., None, :]
    return Kxx + eye * noise[..., None, None]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a[..., None, :] @ b[..., :, None])[..., 0, 0]


def _lp_alpha_kinv(Kn: torch.Tensor, resid: torch.Tensor, need_kinv: bool):
    """Jittered Gaussian log-prob core, the single source of the
    explicit-inverse/Cholesky branch pair.  ``Kn`` (..., n, n), ``resid``
    (..., n).  Returns ``(lp (...), alpha (..., n), Kinv)`` with ``Kinv``
    None when ``need_kinv`` is False on the Cholesky branch."""
    n = Kn.shape[-1]
    eye = _eye(n, Kn)
    Kj = Kn + _jitter(Kn.dtype) * eye
    if kernel_takes(Kn.dtype, Kn.device, n):
        Kinv, logdet = chol_inv_logdet(Kj)
        alpha = (Kinv @ resid[..., :, None])[..., 0]
        lp = -0.5 * _dot(resid, alpha) - 0.5 * logdet - 0.5 * n * LOG_2PI
        return lp, alpha, Kinv
    L = cholesky_nan(Kj)
    alpha = torch.cholesky_solve(resid[..., :, None], L)[..., 0]
    lp = (-0.5 * _dot(resid, alpha)
          - torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
          - 0.5 * n * LOG_2PI)
    Kinv = torch.cholesky_solve(eye.expand(Kj.shape), L) if need_kinv \
        else None
    return lp, alpha, Kinv


def gp_log_prob(mean_spec, kernel_spec, params: Dict, noise: torch.Tensor,
                X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """log N(y | μ(X), K(X,X) + diag(noise)) for every model of the batch:
    ``y`` (..., n), parameters with the same leading dims."""
    Kxx = kernel_spec(params["kernel"], X, X)
    Kn = _add_noise(Kxx, noise)
    resid = y - mean_spec(params["mean"], X)
    lp, _, _ = _lp_alpha_kinv(Kn, resid, need_kinv=False)
    return lp


def _kernel_diag(kernel_spec, kparams: Dict, X: torch.Tensor,
                 nbatch: int) -> torch.Tensor:
    """Prior variance k(x, x) at each row of X (s, d), through the kernel
    spec on (x, x) pairs — no (s, s) matrix.  Parameters with ``nbatch``
    leading dims; returns ``batch + (s,)``."""
    kp = tree_map(lambda t: t.unsqueeze(nbatch), kparams)
    Xp = X[:, None, :]
    return kernel_spec(kp, Xp, Xp)[..., 0, 0]


@_log.spanned("gp.posterior")
def gp_posterior(mean_spec, kernel_spec, params: Dict, noise: torch.Tensor,
                 X: torch.Tensor, y: torch.Tensor, Xs: torch.Tensor,
                 include_noise: bool = True,
                 pred_noise: Optional[torch.Tensor] = None):
    """Posterior predictive mean and variance at Xs, each ``(..., s)``.

    ``include_noise=True`` is the observation-noise-inclusive predictive
    (``likelihood(model(x))``).  ``pred_noise`` overrides the noise added at
    the test points (default: the training noise; a per-point noise vector
    contributes its mean)."""
    n = X.shape[0]
    nbatch = y.ndim - 1
    Kxx = kernel_spec(params["kernel"], X, X)
    Kn = _add_noise(Kxx, noise)
    Ks = kernel_spec(params["kernel"], Xs, X)                  # (..., s, n)
    kss = _kernel_diag(kernel_spec, params["kernel"], Xs, nbatch)
    mu = mean_spec(params["mean"], X)
    mus = mean_spec(params["mean"], Xs)
    # var = kss − ‖L⁻¹ksᵀ‖²: the subtracted sum of squares carries
    # round-off of order u·kss, where Σ(Ks K⁻¹ ∘ Ks) from an explicit
    # inverse carries cond(K)·u·kss; guarded at 0
    L = cholesky_nan(Kn + _jitter(Kn.dtype) * _eye(n, Kn))
    alpha = torch.cholesky_solve((y - mu)[..., :, None], L)[..., 0]
    mean_s = mus + (Ks @ alpha[..., :, None])[..., 0]
    v = torch.linalg.solve_triangular(L, Ks.mT, upper=False)
    var_s = torch.clamp(kss - torch.sum(v * v, dim=-2), min=0.0)
    if include_noise:
        if pred_noise is None:
            # a per-training-point noise vector has no alignment with the
            # test points: default to its mean
            noise = torch.as_tensor(noise, dtype=Kn.dtype, device=Kn.device)
            pred_noise = noise.mean(dim=-1) if noise.ndim == nbatch + 1 \
                else noise
        var_s = var_s + torch.as_tensor(pred_noise, dtype=var_s.dtype,
                                        device=var_s.device)[..., None]
    return mean_s, var_s


def gp_prior_stddev(mean_spec, kernel_spec, params: Dict, X: torch.Tensor,
                    nbatch: int = 1) -> torch.Tensor:
    """Prior stddev at X, ``batch + (p,)`` — what the reference records as
    Vr_sigma (the train-mode ``output.stddev``), evaluated at the trained
    hyperparameters (the JAX package's documented deviation: the reference
    reads it one Adam step earlier).  ``nbatch`` is the number of leading
    batch dims of ``params``."""
    del mean_spec
    kss = _kernel_diag(kernel_spec, params["kernel"], X, nbatch)
    return torch.sqrt(torch.clamp(kss, min=0.0))


# --------------------------------------------------------------------- #
# Trainer
# --------------------------------------------------------------------- #

class TrainResult(NamedTuple):
    params: Dict              # trained (stacked) parameter dict
    loss: torch.Tensor        # final per-model loss
    iterations: torch.Tensor  # per-model iteration count (int32)


def _grads_at(params0: Dict, loss_fn: Callable,
              value_and_grad: Optional[Callable], leaves: list):
    """``(losses (B,), gradient leaves)`` at parameter ``leaves`` of
    ``params0``'s structure: ``value_and_grad``'s, or autograd of
    ``sum(loss_fn)`` where it is None."""
    tree = _unflatten_like(params0, leaves)
    if value_and_grad is not None:
        losses, g = value_and_grad(tree)
        return losses.detach(), [t.detach() for t in tree_leaves(g)]
    with torch.enable_grad():
        req = [t.detach().requires_grad_(True) for t in leaves]
        losses = loss_fn(_unflatten_like(params0, req))
        g = torch.autograd.grad(torch.sum(losses), req, allow_unused=True)
    g = [torch.zeros_like(t) if gi is None else gi
         for t, gi in zip(leaves, g)]
    return losses.detach(), g


def _adam_step(grads_at: Callable, state, c1, c2, lr: float,
               rel_error: float):
    """One Adam iteration of :func:`adam_early_stop`: ``state`` (params, μ,
    ν, last losses, converged, iterations) to the next, from the gradient
    leaves ``grads_at(params)``; ``c1``, ``c2`` the bias corrections."""
    params, mu, nu, loss_old, conv, iters = state
    losses, grads = grads_at(params)
    e = torch.abs(losses - loss_old)
    frozen = conv
    new, mu_n, nu_n = [], [], []
    for p_, g, m, v in zip(params, grads, mu, nu):
        m = (1.0 - ADAM_B1) * g + ADAM_B1 * m
        v = (1.0 - ADAM_B2) * (g * g) + ADAM_B2 * v
        upd = (m / c1) / (torch.sqrt(v / c2) + ADAM_EPS)
        p_new = p_ + (-lr) * upd
        mask = frozen.reshape(frozen.shape + (1,) * (p_.ndim - 1))
        new.append(torch.where(mask, p_, p_new))
        mu_n.append(m)
        nu_n.append(v)
    return (new, mu_n, nu_n, torch.where(frozen, loss_old, losses),
            conv | (e <= rel_error), torch.where(frozen, iters, iters + 1))


@_log.spanned("gp.adam")
def adam_early_stop(loss_fn: Callable, params0: Dict, lr: float = 0.1,
                    max_iter: int = 1000, rel_error: float = 1e-5,
                    verbose: bool = False, unroll: int = 4,
                    value_and_grad: Optional[Callable] = None,
                    stop_axis=None) -> TrainResult:
    """Minimize ``loss_fn(params) -> (B,) losses`` with Adam; per-model
    early stop when |Δloss_b| ≤ rel_error (the reference's stopping rule).
    Converged models are frozen in place while the rest keep stepping.  As
    in the reference's loop, the Adam step of the iteration on which
    convergence is detected IS applied and that iteration IS counted.

    Adam is written out in ``optax.adam(b1=0.9, b2=0.999, eps=1e-8)``'s
    order — μ and ν updates, one global step count, μ̂/(√ν̂ + eps) × −lr —
    so float64 trajectories and iteration counts follow the JAX package's.
    The moments update for every model each substep, frozen ones included,
    as optax's state does there.

    ``unroll`` substeps make a block, and the host reads ``all(converged)``
    once a block, as the JAX ``while_loop`` tests its condition.  Substeps
    past convergence are masked no-ops, and substeps past ``max_iter`` are
    skipped (they would be no-ops), so results do not depend on ``unroll``
    nor on which block's flags the host reads (:class:`_StopTest`).

    ``value_and_grad(params) -> (losses (B,), grads dict)`` replaces
    autograd of ``sum(loss_fn)`` (the closed-form oracles below), and
    picks the run that steps the training: where it offers the fused
    iteration (``value_and_grad.fused``, the single-task oracle on the
    specs of :func:`.gp_step.takes`), two launches, ``csrc/chol.cu`` and
    ``csrc/gp_step.cu``, over a state kept on the card
    (:class:`.gp_step.FusedRun`, each iteration counted in
    ``gp.fused_iters``); else its oracle's step (:class:`_OracleRun`).
    Where it says that its iteration can be captured (``value_and_grad
    .capturable``: the oracles below on the kernel path, a CUDA fp32 batch
    with p ≤ 128, whose every operation launches without a host read or
    an allocation of a library's own), each whole block after the first
    is one replay of a block captured as a CUDA graph, on a side stream
    (:class:`_Replay`), and the host reads each block's stop flags only
    once the next block is enqueued, so the card never waits for the host
    to decide.  ``verbose`` is accepted for signature parity.

    ``stop_axis`` (a :class:`..parallel._comm.Axis`) makes the stop test
    collective: each rank trains its own models, and the loop runs until
    the models of every rank have stopped, as one vmapped ``while_loop``
    over all of them does — per-model trajectories and iteration counts
    are those of the unsharded call."""
    del verbose
    params = [t.detach().clone() for t in tree_leaves(params0)]

    # on the card the closed-form oracle's iterations are replayed as a
    # CUDA graph, a block at a time, after a first block run eagerly: the
    # ~120 launches an eager iteration enqueues take the host ~10× the
    # card's time for them
    capture = getattr(value_and_grad, "capturable", False)
    fused = getattr(value_and_grad, "fused", None)
    rec = _log.recorder()        # taken once: each iteration's span inline
    j, replay = 0, None
    with _side_stream(params[0]) if capture else contextlib.nullcontext():
        run = fused(params, lr, rel_error) if fused is not None else \
            _OracleRun(functools.partial(
                _adam_step,
                functools.partial(_grads_at, params0, loss_fn, value_and_grad),
                lr=lr, rel_error=rel_error), params,
                max_iter if capture else None)
        stop = _StopTest(run.conv, stop_axis, behind=capture)
        while j < max_iter and not stop.stopped():
            n = min(unroll, max_iter - j)
            # one gp.iter span an iteration enqueued; a replay enqueues its
            # whole block, so its first span holds it and the rest are empty
            steps = [replay.step] + [_enqueued] * (n - 1) \
                if replay is not None and n == unroll else [run.step] * n
            for step in steps:
                if rec is not None:
                    at = rec.begin("gp.iter")
                step()
                if rec is not None:
                    rec.end(at)
            j += n
            stop.block_done()
            if capture and replay is None and max_iter - j >= unroll:
                replay = _Replay(functools.partial(_steps, run.step, unroll))
    leaves, losses, iters = run.result()
    return TrainResult(_unflatten_like(params0, leaves), losses, iters)


def _steps(step: Callable, n: int) -> None:
    """``n`` calls of ``step``: a block of iterations, as one callable."""
    for _ in range(n):
        step()


def _enqueued() -> None:
    """An iteration that its block's replay has already enqueued."""


class _StopTest:
    """The stop test of :func:`adam_early_stop`'s loop: whether every model
    (of every rank of ``axis``) has stopped, read once a block.

    ``behind`` (a loop that captures, on the card): after each block the
    host records an event, behind which a stream of the test's own copies
    the stop flags ``conv`` into a pinned host slot, and the test reads the
    block before the newest one.  So the host enqueues block k + 1 before
    it waits for block k, and the card has a block queued while the host
    decides; the block enqueued after the stop is a masked no-op
    (``_adam_step``'s and ``csrc/gp_step.cu``'s frozen models), which
    leaves parameters, last losses and iteration counts as they are.  The
    copy runs beside block k + 1, not between the blocks, so the loop's
    stream goes from block to block without a copy's turnaround; it may
    therefore read a flag that block k + 1 has already turned on, but a
    flag only turns on, so the host then stops one block sooner, after
    iterations already enqueued, and the results are the same.  Two
    slots, block k's in slot k mod 2, each read only once its copy's event
    has passed: block k + 1's copy, which may be in flight while the host
    reads, lands in the other one.  Each read is counted in ``host_reads``
    and ``gp.overlapped_reads``.

    Otherwise the test reads ``all(conv)`` before each block, which waits
    for the queue on the card (a read counted in ``host_reads``) and costs
    nothing on the CPU."""

    def __init__(self, conv: torch.Tensor, axis, behind: bool):
        self.conv, self.axis, self.blocks = conv, axis, 0
        self.slots = None
        if behind:
            self.slots = [torch.empty(conv.shape, dtype=torch.bool,
                                      pin_memory=conv.is_cuda)
                          for _ in range(2)]
            self.ends = [torch.cuda.Event() for _ in range(2)]
            self.copied = [torch.cuda.Event() for _ in range(2)]
            # high priority: never the loop's stream, which is a
            # low-priority one of torch's pool
            self.stream = torch.cuda.Stream(conv.device, priority=-1)
            conv.record_stream(self.stream)

    def block_done(self) -> None:
        """After each block is enqueued: behind, its event, and the copy of
        its flags into its slot on the test's stream."""
        if self.slots is not None:
            slot = self.blocks % 2
            self.ends[slot].record()
            with torch.cuda.stream(self.stream):
                self.stream.wait_event(self.ends[slot])
                self.slots[slot].copy_(self.conv, non_blocking=True)
                self.copied[slot].record()
        self.blocks += 1

    def stopped(self) -> bool:
        if self.slots is None:
            if self.conv.is_cuda:
                _log.count("host_reads")
            done = bool(torch.all(self.conv))
        elif self.blocks < 2:
            return False      # no block before the newest one to read
        else:
            slot = self.blocks % 2          # the block before the newest
            self.copied[slot].synchronize()
            _log.count("host_reads")
            _log.count("gp.overlapped_reads")
            done = bool(torch.all(self.slots[slot]))
        return done if self.axis is None else self.axis.all(done)


class _OracleRun:
    """A training's state under its oracle's (or autograd's) Adam step,
    which :meth:`step` advances in place, as :class:`.gp_step.FusedRun`'s:
    ``state`` is (params, μ, ν, last losses, converged, iterations),
    ``step`` is :func:`_adam_step` bound to its gradient.  The step count
    behind the bias corrections is a Python int; for a run that a graph
    replays (``max_iter`` given) it is a tensor on the card, and each step
    reads its corrections from a table of the ``max_iter`` steps' made
    there once (:func:`.gp_step.bias_corrections`)."""

    def __init__(self, step: Callable, params: list,
                 max_iter: Optional[int] = None):
        B, like = params[0].shape[0], params[0]
        self._step, self._count, self._table = step, 0, None
        if max_iter is not None:
            self._count = torch.zeros(1, dtype=torch.int64,
                                      device=like.device)
            self._table = torch.stack(_gp_step.bias_corrections(
                torch.arange(max_iter + 1, device=like.device), like.dtype),
                dim=1)
        self.state = (params, [torch.zeros_like(t) for t in params],
                      [torch.zeros_like(t) for t in params],
                      torch.full((B,), 1e10, dtype=like.dtype,
                                 device=like.device),
                      torch.zeros(B, dtype=torch.bool, device=like.device),
                      torch.zeros(B, dtype=torch.int32, device=like.device))

    @property
    def conv(self) -> torch.Tensor:
        return self.state[4]

    def _corrections(self):
        if self._table is not None:
            self._count.add_(1)
            c = self._table.index_select(0, self._count)
            return c[:, 0], c[:, 1]
        self._count += 1
        return 1.0 - ADAM_B1 ** self._count, 1.0 - ADAM_B2 ** self._count

    def step(self) -> None:
        """One Adam iteration, its launches enqueued one by one."""
        out = self._step(self.state, *self._corrections())
        for s, o in zip(_flat_state(self.state), _flat_state(out)):
            s.copy_(o)

    def result(self):
        """``(parameter leaves, last losses, iterations)``."""
        params, _, _, losses, _, iters = self.state
        return params, losses, iters


class _Replay:
    """``block()`` (a run's iterations, ``run.step`` or a block of them)
    captured once as a CUDA graph on the current stream: each :meth:`step`
    replays it, advancing the run in place, and adds the counts that the
    capture tallied (the kernels' launches, ``gp.fused_iters``;
    :func:`..utils.logging.capture_tally`)."""

    def __init__(self, block: Callable[[], None]):
        self.graph = torch.cuda.CUDAGraph()
        with _log.capture_tally() as self.tally:
            self.graph.capture_begin()
            try:
                block()
            finally:
                self.graph.capture_end()

    def step(self) -> None:
        self.graph.replay()
        _log.count_all(self.tally)


# one side stream a card, made once: torch keeps a cuBLAS workspace (32 MB
# on an H100) for every stream that runs a product, so a fresh stream a
# training would hold one for each of the 32 streams of torch's pool
_SIDE: Dict[torch.device, torch.cuda.Stream] = {}


@contextlib.contextmanager
def _side_stream(like: torch.Tensor):
    """The side stream of ``like``'s card for a loop that captures (a
    graph is not captured on the default stream), ordered after the work
    enqueued before the block and before the work enqueued after it."""
    main = torch.cuda.current_stream(like.device)
    side = _SIDE.get(like.device)
    if side is None:
        side = _SIDE[like.device] = torch.cuda.Stream(like.device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        yield
    main.wait_stream(side)


def _flat_state(state) -> list:
    params, mu, nu, *rest = state
    return [*params, *mu, *nu, *rest]


# --------------------------------------------------------------------- #
# Loss builders and closed-form gradient oracles
# --------------------------------------------------------------------- #

def make_single_task_loss(mean_spec, kernel_spec, likelihood_spec,
                          X: torch.Tensor, Y: torch.Tensor) -> Callable:
    """Batched −MLL for r independent single-task GPs: ``Y`` (r, p), one row
    per mode; parameters stacked with leading axis r.  Each loss is divided
    by p (gpytorch ExactMarginalLogLikelihood normalization)."""
    p = X.shape[0]

    def batched(params):
        noise = likelihood_spec.noise(params["likelihood"])
        lp = gp_log_prob(mean_spec, kernel_spec, params, noise, X, Y)
        return -lp / p

    return batched


def make_single_task_value_and_grad(mean_spec, kernel_spec, likelihood_spec,
                                    X: torch.Tensor, Y: torch.Tensor
                                    ) -> Optional[Callable]:
    """Closed-form (loss, gradient) oracle for the batched single-task
    −MLL: ``params -> (losses (r,), grads dict)``, the contract of autograd
    of ``sum ∘ make_single_task_loss``, from the analytic gradient
    ``∂lp/∂θ = ½ tr((ααᵀ − K⁻¹) ∂K/∂θ)``.  About 30 tensor ops per call
    and one batched inverse; the pairwise squared-distance stack is
    parameter-independent and built once.

    Supported specs (anything else returns ``None`` and the caller uses
    autograd): ``ZeroMean``/``ConstantMean``/``LinearMean`` ×
    ``RBFKernel``/``MaternKernel``/``ScaleKernel(RBF|Matern)`` (ARD or
    scalar lengthscale) × ``GaussianLikelihood``/
    ``FixedNoiseGaussianLikelihood``."""
    core = _ClosedFormCore.build(mean_spec, kernel_spec, X)
    if core is None or not isinstance(
            likelihood_spec, (K.GaussianLikelihood,
                              K.FixedNoiseGaussianLikelihood)):
        return None
    fixed_noise = isinstance(likelihood_spec, K.FixedNoiseGaussianLikelihood)
    p = X.shape[0]

    def batched(params):
        noise = likelihood_spec.noise(params["likelihood"])
        lp, lp_grads, trM = core.lp_and_grads(params, Y, noise)
        coeff = -1.0 / p                                  # loss = −lp/p
        if fixed_noise:
            lgrad = {"fixed_noise": torch.zeros_like(
                params["likelihood"]["fixed_noise"])}
        else:
            # ∂lp/∂noise = ½ tr(M) for scalar noise
            lgrad = {"raw_noise": coeff * 0.5 * trM
                     * torch.sigmoid(params["likelihood"]["raw_noise"])}
        grads = tree_map(lambda g: coeff * g, lp_grads)
        grads["likelihood"] = lgrad
        return -lp / p, grads

    batched.capturable = kernel_takes(X.dtype, X.device, p)
    batched.fused = functools.partial(
        _gp_step.FusedRun, core, Y, _jitter(X.dtype)) if _gp_step.takes(
            mean_spec, kernel_spec, likelihood_spec, X.dtype, X.device, p) \
        else None
    return batched


class _ClosedFormCore:
    """Batched closed-form lp + ∂lp/∂(mean, kernel params) — the engine
    behind the single-task and multitask oracles.

    ``lp_and_grads(params, y, noise)`` (parameters with one leading batch
    axis b, ``y`` (b, p), ``noise`` (b,) or (b, p)) returns ``(lp (b,),
    grads, trM (b,))`` with ``grads = {"mean": ..., "kernel": ...}`` the
    UNNORMALIZED ∂lp/∂θ (callers scale by −1/p or −1/(p·r) and derive the
    noise gradient from ``trM = tr(ααᵀ − K⁻¹)``)."""

    def __init__(self, mean_spec, scaled, nu, D2, X):
        self.mean_spec = mean_spec
        self.scaled = scaled
        self.nu = nu
        self.D2 = D2
        self.X = X
        self.mean_kind = type(mean_spec).__name__
        self.has_bias = getattr(mean_spec, "bias", False)

    @classmethod
    def build(cls, mean_spec, kernel_spec, X):
        if isinstance(kernel_spec, K.ScaleKernel):
            base, scaled = kernel_spec.base, True
        else:
            base, scaled = kernel_spec, False
        if not isinstance(base, (K.RBFKernel, K.MaternKernel)):
            return None
        if not isinstance(mean_spec,
                          (K.ZeroMean, K.ConstantMean, K.LinearMean)):
            return None
        nls = base.ard_num_dims or 1
        diff = X[:, None, :] - X[None, :, :]
        if nls == 1:
            D2 = torch.sum(diff * diff, dim=-1)[None]     # (1, p, p)
        else:
            D2 = torch.movedim(diff * diff, -1, 0)        # (d, p, p)
        nu = getattr(base, "nu", None)                    # None → RBF
        return cls(mean_spec, scaled, nu, D2, X)

    def g_and_gprime(self, d2):
        """Kernel profile g(d²) and its derivative dg/dd², the ν = 0.5
        derivative guarded to 0 on the diagonal exactly as the autograd
        path's where-guard is."""
        nu = self.nu
        if nu is None:
            g = torch.exp(-0.5 * d2)
            return g, -0.5 * g
        eps = torch.finfo(d2.dtype).eps ** 2
        safe = d2 > eps
        one, zero = torch.ones_like(d2), torch.zeros_like(d2)
        r = torch.sqrt(torch.where(safe, d2, one))
        if nu == 0.5:
            e = torch.exp(-r)
            g = torch.where(safe, e, one)
            gp = torch.where(safe, -e / (2.0 * r), zero)
        elif nu == 1.5:
            c = math.sqrt(3.0) * r
            e = torch.exp(-c)
            g = torch.where(safe, (1.0 + c) * e, one)
            gp = torch.where(safe, -1.5 * e, zero)
        else:
            c = math.sqrt(5.0) * r
            e = torch.exp(-c)
            g = torch.where(safe, (1.0 + c + (5.0 / 3.0) * d2) * e, one)
            gp = torch.where(safe, -(5.0 / 6.0) * (1.0 + c) * e, zero)
        return g, gp

    def lp_and_grads(self, params, y, noise):
        X = self.X
        kp = params["kernel"]
        base_p = kp["base"] if self.scaled else kp
        raw_ls = base_p["raw_lengthscale"]               # (b, nls)
        ls = K.softplus(raw_ls)
        inv_ls2 = 1.0 / (ls * ls)
        d2 = torch.tensordot(inv_ls2, self.D2, dims=([1], [0]))  # (b, p, p)
        g, gp = self.g_and_gprime(d2)
        if self.scaled:
            s = K.softplus(kp["raw_outputscale"])[:, None, None]
            Km = s * g
        else:
            Km = g
        Kn = _add_noise(Km, noise)
        resid = y - self.mean_spec(params["mean"], X)
        # One batched inverse for the whole mode batch: on the card one
        # launch of csrc/chol.cu.  The oracle needs K⁻¹ on either branch
        # (the ∂lp/∂K trace terms below).
        lp, alpha, Kinv = _lp_alpha_kinv(Kn, resid, need_kinv=True)
        M = alpha[:, :, None] * alpha[:, None, :] - Kinv  # ∂lp/∂K = ½M

        sgp = (s * gp) if self.scaled else gp
        t = torch.tensordot(M * sgp, self.D2, dims=([1, 2], [1, 2]))  # (b, nls)
        grad_ls = 0.5 * t * (-2.0 * inv_ls2 / ls) * torch.sigmoid(raw_ls)
        kgrad = {"raw_lengthscale": grad_ls}
        if self.scaled:
            kgrad = {"raw_outputscale":
                     0.5 * torch.sum(M * g, dim=(1, 2))
                     * torch.sigmoid(kp["raw_outputscale"]),
                     "base": kgrad}

        if self.mean_kind == "ZeroMean":
            mgrad = {}
        elif self.mean_kind == "ConstantMean":
            mgrad = {"constant": torch.sum(alpha, dim=-1)}
        else:                                            # LinearMean
            mgrad = {"weights": alpha @ X}
            if self.has_bias:
                mgrad["bias"] = torch.sum(alpha, dim=-1)
        trM = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)
        return lp, {"mean": mgrad, "kernel": kgrad}, trM


def make_multitask_value_and_grad(mean_spec, kernel_spec, likelihood_spec,
                                  X: torch.Tensor, Y: torch.Tensor,
                                  added_loss_fn: Optional[Callable] = None
                                  ) -> Optional[Callable]:
    """Closed-form (loss, gradient) oracle for the multitask −MLL
    (:func:`make_multitask_loss`): per-task ``∂lp/∂θ`` from
    :class:`_ClosedFormCore` over the task axis, plus the shared global +
    per-task noise chain ``noise_t = softplus(raw) + 1e-4 +
    softplus(raw_task_t)``.  Returns ``None`` for unsupported specs or
    when ``added_loss_fn`` is given (the PIGPR path differentiates through
    an arbitrary user callback: autograd only).  ``Y`` is (p, r)."""
    if added_loss_fn is not None:
        return None
    if not isinstance(likelihood_spec, K.MultitaskGaussianLikelihood):
        return None
    core = _ClosedFormCore.build(mean_spec, kernel_spec, X)
    if core is None:
        return None
    p, r = X.shape[0], Y.shape[1]
    Yt = Y.T

    def joint(params):
        noises = likelihood_spec.noise(params["likelihood"])  # (r,)
        lps, lp_grads, trMs = core.lp_and_grads(params["tasks"], Yt, noises)
        coeff = -1.0 / (p * r)
        task_grads = tree_map(lambda g: coeff * g, lp_grads)
        lik = params["likelihood"]
        lgrad = {"raw_noise": coeff * 0.5 * torch.sum(trMs)
                 * torch.sigmoid(lik["raw_noise"]),
                 "raw_task_noises": coeff * 0.5 * trMs
                 * torch.sigmoid(lik["raw_task_noises"])}
        loss = -torch.sum(lps) / (p * r)
        return loss[None], {"tasks": task_grads, "likelihood": lgrad}

    joint.capturable = kernel_takes(X.dtype, X.device, p)
    return joint


def make_multitask_loss(mean_spec, kernel_spec,
                        likelihood_spec: K.MultitaskGaussianLikelihood,
                        X: torch.Tensor, Y: torch.Tensor,
                        added_loss_fn: Optional[Callable] = None
                        ) -> Callable:
    """−MLL of a batch-independent multitask GP: per-task mean/kernel
    parameters (stacked), one multitask likelihood (global + task noises);
    the joint log-prob divided by p·r.  Returns a (1,)-shaped loss for the
    shared trainer.

    ``added_loss_fn(params, lp) -> scalar`` is gpytorch's added-loss-term
    hook, added to the log-prob before the normalization — the PIGPR path.
    It also receives the joint log-prob ``lp`` this loss has just computed
    (PIGPR hands it, detached, to its callback as ``loss_ml``), where the
    JAX package's ``added_loss_fn(params)`` recomputes it and XLA merges
    the two evaluations; eagerly that would be one more inverse a step."""
    p, r = X.shape[0], Y.shape[1]
    Yt = Y.T

    def batched(params):
        noises = likelihood_spec.noise(params["likelihood"])   # (r,)
        lp = torch.sum(gp_log_prob(mean_spec, kernel_spec, params["tasks"],
                                   noises, X, Yt))
        if added_loss_fn is not None:
            lp = lp + added_loss_fn(params, lp)
        return (-lp / (p * r))[None]

    return batched
