"""The single-task GP trainer's Adam iteration as two launches on the card:
``csrc/chol.cu`` for K⁻¹ and log|K| of the whole mode batch, then the
kernel of ``csrc/gp_step.cu``, which takes the closed-form gradient, steps
Adam, tests the stop and builds the next iteration's K.  Here are the
route's predicate, a training's state (:class:`FusedRun`), the kernel's
wrapper and its plain version.

The JAX package has no Pallas kernel here: its trainer is a
``lax.while_loop`` that XLA compiles into one program around the Pallas
Cholesky.  Eager PyTorch runs the oracle of
:func:`.exact_gp.make_single_task_value_and_grad` and the Adam step of
:func:`.exact_gp.adam_early_stop` as about 115 small kernels, 12 state
copies and 2 fills an iteration, each paying a launch's latency for a few
hundred floats of work; the kernel runs them as one launch.

:func:`takes` picks the trainings that take the route, from what the code
can observe: a ``GaussianLikelihood``; a ``ZeroMean`` or ``ConstantMean``;
an RBF or Matérn (ν ∈ {0.5, 1.5, 2.5}) profile, bare or under a
``ScaleKernel``, with a scalar lengthscale or at most :data:`LS_MAX` ARD
ones; CUDA float32 with p ≤ 128 (:func:`..linalg.chol.kernel_takes`).
Every other training keeps the oracle's step.

A training's raw parameters are one row a model of ``theta``, in the order
of the trainer's leaves (lengthscales, outputscale, noise, constant).  The
step count lives on the card, so the bias corrections 1 − 0.9ᵗ and
1 − 0.999ᵗ are taken there, in double and rounded to the working type, as
the host's Python floats are in the oracle's step.  The plain version
(:func:`_step_plain`, :func:`_build_plain`) runs the kernel's formulation in
torch ops, in any dtype: build → (K⁻¹, logdet) → loss, gradient, Adam →
the next build; :func:`gp_step` takes it for a CPU state.  For a CUDA state
it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

from . import kernels as K
from ..linalg import chol_cuda as _chol_cuda
from ..linalg.chol import chol_inv_logdet_auto, kernel_takes
from ..utils import logging as _log
from .kernels import ADAM_B1 as B1, ADAM_B2 as B2, ADAM_EPS as EPS, LOG_2PI

LS_MAX = 16     # lengthscales a model the kernel takes (kMaxLs)
PROFILES = {None: 0, 0.5: 1, 1.5: 2, 2.5: 3}   # RBF, then Matérn by ν


def takes(mean_spec, kernel_spec, likelihood_spec, dtype, device,
          p: int) -> bool:
    """Whether a single-task training of these specs on ``p`` points in
    ``dtype`` on ``device`` takes the two-launch iteration."""
    base = kernel_spec.base if isinstance(kernel_spec, K.ScaleKernel) \
        else kernel_spec
    return (isinstance(likelihood_spec, K.GaussianLikelihood)
            and isinstance(mean_spec, (K.ZeroMean, K.ConstantMean))
            and isinstance(base, (K.RBFKernel, K.MaternKernel))
            and (base.ard_num_dims or 1) <= LS_MAX
            and p >= 1 and kernel_takes(dtype, device, p))


def bias_corrections(count: torch.Tensor, dtype):
    """Adam's ``(1 − 0.9ᵗ, 1 − 0.999ᵗ)`` at step counts ``count``, taken in
    double and rounded to ``dtype``."""
    t = count.to(torch.float64)
    return ((1.0 - torch.pow(B1, t)).to(dtype),
            (1.0 - torch.pow(B2, t)).to(dtype))


class FusedRun:
    """One training's state, advanced in place by :meth:`step`.

    ``core`` is the oracle's :class:`.exact_gp._ClosedFormCore` (its
    profile, squared distances ``D2`` (nls, p, p), ScaleKernel and mean
    kind), ``Y`` (B, p) the targets, ``jitter`` the working type's;
    ``leaves`` the trainer's parameter leaves, stacked over the B models;
    ``lr`` and ``rel_error`` Adam's step and the stop test's bound.  The
    first build runs here."""

    def __init__(self, core, Y: torch.Tensor, jitter: float, leaves: list,
                 lr: float, rel_error: float):
        B, p = Y.shape
        self.core, self.Y, self.D2 = core, Y.contiguous(), \
            core.D2.contiguous()
        self.nls = self.D2.shape[0]
        self.scaled = bool(core.scaled)
        self.has_c = core.mean_kind == "ConstantMean"
        self.profile = PROFILES[core.nu]
        want = [(B, self.nls)] + [(B,)] * (self.scaled + 1 + self.has_c)
        if [tuple(t.shape) for t in leaves] != want:
            raise ValueError(f"the fused GP step takes leaves of shapes "
                             f"{want}, got {[tuple(t.shape) for t in leaves]}")
        self.shapes = want
        self.theta = torch.cat([t.reshape(B, -1) for t in leaves],
                               dim=1).contiguous()
        like = dict(dtype=self.theta.dtype, device=self.theta.device)
        self.mu = torch.zeros_like(self.theta)
        self.nu = torch.zeros_like(self.theta)
        self.loss = torch.full((B,), 1e10, **like)
        self.conv = torch.zeros(B, dtype=torch.bool, device=like["device"])
        self.iters = torch.zeros(B, dtype=torch.int32, device=like["device"])
        self.count = torch.zeros(B, dtype=torch.int32, device=like["device"])
        self.kj = torch.empty((B, p, p), **like)
        self.resid = torch.empty((B, p), **like)
        self.lr, self.rel_error, self.jitter = float(lr), float(rel_error), \
            float(jitter)
        gp_step(self)

    def step(self) -> None:
        """One Adam iteration: (K⁻¹, logdet) of the built K, then the step
        and the next build; counted in ``gp.fused_iters``."""
        kinv, logdet = chol_inv_logdet_auto(self.kj)
        gp_step(self, kinv, logdet)
        _log.count("gp.fused_iters")

    def result(self) -> Tuple[List[torch.Tensor], torch.Tensor,
                              torch.Tensor]:
        """``(parameter leaves in the shapes they came in, last losses,
        iterations)``."""
        out, at = [], 0
        for shape in self.shapes:
            w = shape[1] if len(shape) == 2 else 1
            out.append(self.theta[:, at:at + w].reshape(shape).clone(
                memory_format=torch.contiguous_format))
            at += w
        return out, self.loss, self.iters


# ---- the plain version ----------------------------------------------------

def _hyper(run: FusedRun):
    """``(ls (B, nls), 1/ls², outputscale or None, noise, constant or
    None)`` at the run's parameters."""
    th, nls = run.theta, run.nls
    ls = K.softplus(th[:, :nls])
    s = K.softplus(th[:, nls]) if run.scaled else None
    noise = K.softplus(th[:, nls + run.scaled]) + K.NOISE_LOWER
    c = th[:, nls + run.scaled + 1] if run.has_c else None
    return ls, 1.0 / (ls * ls), s, noise, c


def _profile(run: FusedRun, inv_ls2: torch.Tensor):
    d2 = torch.tensordot(inv_ls2, run.D2, dims=([1], [0]))     # (B, p, p)
    return run.core.g_and_gprime(d2)


def _build_plain(run: FusedRun) -> None:
    """The next iteration's jittered K and residual from the parameters."""
    _, inv_ls2, s, noise, c = _hyper(run)
    g, _ = _profile(run, inv_ls2)
    Km = s[:, None, None] * g if run.scaled else g
    eye = torch.eye(Km.shape[-1], dtype=Km.dtype, device=Km.device)
    run.kj.copy_((Km + eye * noise[:, None, None]) + run.jitter * eye)
    run.resid.copy_(run.Y - c[:, None] if run.has_c else run.Y)


def _step_plain(run: FusedRun, kinv: torch.Tensor,
                logdet: torch.Tensor) -> None:
    """The kernel's iteration in torch ops, in the kernel's order: loss,
    the sums over M = ααᵀ − K⁻¹, the gradient, Adam, the stop test and
    the counts, then the next build."""
    th, p, nls = run.theta, run.Y.shape[1], run.nls
    ls, inv_ls2, s, _, _ = _hyper(run)
    alpha = (kinv @ run.resid[:, :, None])[:, :, 0]
    lp = (-0.5 * torch.sum(run.resid * alpha, dim=-1) - 0.5 * logdet
          - 0.5 * p * LOG_2PI)
    loss = -lp / p
    M = alpha[:, :, None] * alpha[:, None, :] - kinv
    g, gp = _profile(run, inv_ls2)
    w = M * (s[:, None, None] * gp if run.scaled else gp)
    t = torch.tensordot(w, run.D2, dims=([1, 2], [1, 2]))      # (B, nls)
    coeff = -1.0 / p
    grads = [coeff * (0.5 * t * (-2.0 * inv_ls2 / ls)
                      * torch.sigmoid(th[:, :nls]))]
    if run.scaled:
        grads.append(coeff * (0.5 * torch.sum(M * g, dim=(1, 2))
                              * torch.sigmoid(th[:, nls])))
    trM = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)
    grads.append(coeff * 0.5 * trM * torch.sigmoid(th[:, nls + run.scaled]))
    if run.has_c:
        grads.append(coeff * torch.sum(alpha, dim=-1))
    grad = torch.cat([x.reshape(th.shape[0], -1) for x in grads], dim=1)

    count = run.count + 1
    c1, c2 = bias_corrections(count, th.dtype)
    m = (1.0 - B1) * grad + B1 * run.mu
    v = (1.0 - B2) * (grad * grad) + B2 * run.nu
    upd = (m / c1[:, None]) / (torch.sqrt(v / c2[:, None]) + EPS)
    frozen = run.conv.clone()
    e = torch.abs(loss - run.loss)
    run.theta.copy_(torch.where(frozen[:, None], th, th + (-run.lr) * upd))
    run.mu.copy_(m)
    run.nu.copy_(v)
    run.loss.copy_(torch.where(frozen, run.loss, loss))
    run.conv.copy_(frozen | (e <= run.rel_error))
    run.iters.copy_(torch.where(frozen, run.iters, run.iters + 1))
    run.count.copy_(count)
    _build_plain(run)


# ---- the kernel -----------------------------------------------------------

class _Args(ctypes.Structure):
    """``GpStepArgs`` of ``csrc/gp_step.cu``, field for field."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "kinv", "logdet", "y", "d2s", "kj", "resid", "theta", "mu", "nu",
        "loss", "conv", "iters", "count", "stream")] + [
        (name, ctypes.c_int) for name in (
            "batch", "p", "nls", "scaled", "has_c", "profile",
            "build_only")] + [
        (name, ctypes.c_float) for name in ("lr", "rel_error", "jitter")]


_lib = None


def _library() -> ctypes.CDLL:
    """The built kernel library, its C signatures declared (first call
    builds ``csrc/gp_step.cu``)."""
    global _lib
    if _lib is None:
        from .._build import load_library
        lib = load_library("gp_step")
        lib.gp_step_launch.argtypes = [ctypes.POINTER(_Args)]
        lib.gp_step_launch.restype = ctypes.c_int
        lib.gp_step_ls_max.argtypes = []
        lib.gp_step_ls_max.restype = ctypes.c_int
        if lib.gp_step_ls_max() != LS_MAX:
            raise RuntimeError("csrc/gp_step.cu and its wrapper disagree on "
                               "LS_MAX")
        _lib = lib
    return _lib


def _check(run: FusedRun, kinv, logdet) -> None:
    """Raise on what the kernel does not take."""
    B, p = run.Y.shape
    f32 = {"Y": run.Y, "D2": run.D2, "kj": run.kj, "resid": run.resid,
           "theta": run.theta, "mu": run.mu, "nu": run.nu, "loss": run.loss}
    if kinv is not None:
        f32.update(kinv=kinv, logdet=logdet)
    dev = run.theta.device
    for name, x in f32.items():
        if x.device != dev or x.dtype != torch.float32 \
                or not x.is_contiguous():
            raise ValueError(f"the GP step kernel needs contiguous CUDA "
                             f"float32 tensors on one card; {name} is "
                             f"{x.dtype} on {x.device}")
    if not (run.conv.device == run.iters.device == run.count.device == dev
            and run.conv.dtype == torch.bool
            and run.iters.dtype == run.count.dtype == torch.int32):
        raise ValueError("the GP step kernel needs bool stop flags and int32 "
                         "counts on the state's card")
    if not (1 <= B < 2 ** 31 and 1 <= p <= _chol_cuda.P_MAX
            and 1 <= run.nls <= LS_MAX):
        raise ValueError(f"the GP step kernel takes 1 <= B < 2**31, 1 <= p "
                         f"<= {_chol_cuda.P_MAX} and 1 <= nls <= {LS_MAX}, "
                         f"got B={B}, p={p}, nls={run.nls}")
    if kinv is not None and (tuple(kinv.shape) != (B, p, p)
                             or tuple(logdet.shape) != (B,)):
        raise ValueError(f"K⁻¹ and logdet must be ({B}, {p}, {p}) and "
                         f"({B},), got {tuple(kinv.shape)}, "
                         f"{tuple(logdet.shape)}")


def gp_step(run: FusedRun, kinv: Optional[torch.Tensor] = None,
            logdet: Optional[torch.Tensor] = None) -> None:
    """One launch of ``csrc/gp_step.cu`` on the run's state: the Adam
    iteration from the built K's ``kinv`` and ``logdet`` and the next
    build, or the build alone where they are None.  A CPU state takes the
    plain version.  The launch is counted in the recorder's
    ``gp_step.kernel_launches``."""
    if not run.theta.is_cuda:
        if kinv is None:
            _build_plain(run)
        else:
            _step_plain(run, kinv, logdet)
        return
    _check(run, kinv, logdet)
    B, p = run.Y.shape
    dev = run.theta.device
    with torch.cuda.device(dev):
        args = _Args(
            kinv=None if kinv is None else kinv.data_ptr(),
            logdet=None if kinv is None else logdet.data_ptr(),
            y=run.Y.data_ptr(), d2s=run.D2.data_ptr(), kj=run.kj.data_ptr(),
            resid=run.resid.data_ptr(), theta=run.theta.data_ptr(),
            mu=run.mu.data_ptr(), nu=run.nu.data_ptr(),
            loss=run.loss.data_ptr(), conv=run.conv.data_ptr(),
            iters=run.iters.data_ptr(), count=run.count.data_ptr(),
            stream=torch.cuda.current_stream(dev).cuda_stream,
            batch=B, p=p, nls=run.nls, scaled=int(run.scaled),
            has_c=int(run.has_c), profile=run.profile,
            build_only=int(kinv is None), lr=run.lr,
            rel_error=run.rel_error, jitter=run.jitter)
        err = _library().gp_step_launch(ctypes.byref(args))
    if err != 0:
        raise RuntimeError(f"csrc/gp_step.cu launch failed: cudaError {err}")
    _log.launched("gp_step")
