"""GP kernels, means and likelihoods (port of
``openmeasure_tpu/gp/kernels.py``), gpytorch-compatible semantics.

Each kernel/mean/likelihood is a frozen-dataclass *spec* plus a parameter
dict of tensors.  Parameters may carry leading batch dimensions (a mode
axis r, where the JAX package vmaps over modes): a scalar parameter is
``batch``-shaped, a lengthscale ``batch + (nls,)``.  Inputs ``X`` are
``(..., n, d)``; the batch dims of the parameters and of ``X`` broadcast,
and a kernel returns ``broadcast + (n1, n2)``, a mean ``broadcast + (n,)``.

Positivity constraints follow gpytorch: ``value = softplus(raw) + lower``
with raw parameters initialized to 0 (lengthscale ≈ 0.6931, noise ≈ 0.6932
at init).  ``softplus`` is ``logaddexp(x, 0)``, ``jax.nn.softplus``'s own
formula, with the derivative sigmoid(x) (0.5 at the raw init 0).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

Params = Dict[str, torch.Tensor]


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def _zeros(shape, dtype, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


# --------------------------------------------------------------------- #
# Means
# --------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class ZeroMean:
    def init_params(self, d: int, dtype=torch.float32, device=None) -> Params:
        return {}

    def __call__(self, params: Params, X: torch.Tensor) -> torch.Tensor:
        return torch.zeros(X.shape[:-1], dtype=X.dtype, device=X.device)


@dataclasses.dataclass(frozen=True)
class ConstantMean:
    """gpytorch.means.ConstantMean — one learned constant, init 0."""

    def init_params(self, d: int, dtype=torch.float32, device=None) -> Params:
        return {"constant": _zeros((), dtype, device)}

    def __call__(self, params: Params, X: torch.Tensor) -> torch.Tensor:
        c = params["constant"][..., None]
        return c.expand(torch.broadcast_shapes(c.shape, X.shape[:-1]))


@dataclasses.dataclass(frozen=True)
class LinearMean:
    """gpytorch.means.LinearMean — w·x + b."""
    bias: bool = True

    def init_params(self, d: int, dtype=torch.float32, device=None) -> Params:
        p = {"weights": _zeros((d,), dtype, device)}
        if self.bias:
            p["bias"] = _zeros((), dtype, device)
        return p

    def __call__(self, params: Params, X: torch.Tensor) -> torch.Tensor:
        out = (X @ params["weights"][..., :, None])[..., 0]
        if self.bias:
            out = out + params["bias"][..., None]
        return out


# --------------------------------------------------------------------- #
# Kernels
# --------------------------------------------------------------------- #

def _scaled_sqdist(X1, X2, lengthscale):
    # Explicit pairwise differences rather than the norm+matmul identity:
    # the identity cancels catastrophically for nearby points, which makes
    # them coincide and the kernel matrix singular.  GP point counts are
    # small, so O(n² d) elementwise work is free.
    ls = lengthscale[..., None, :]
    x1 = X1 / ls
    x2 = X2 / ls
    diff = x1[..., :, None, :] - x2[..., None, :, :]
    return torch.sum(diff * diff, dim=-1)


@dataclasses.dataclass(frozen=True)
class RBFKernel:
    """k(r) = exp(-r²/2) with r the lengthscale-scaled distance."""
    ard_num_dims: Optional[int] = None

    def init_params(self, d: int, dtype=torch.float32, device=None) -> Params:
        nls = self.ard_num_dims or 1
        return {"raw_lengthscale": _zeros((nls,), dtype, device)}

    def lengthscale(self, params):
        return softplus(params["raw_lengthscale"])

    def __call__(self, params: Params, X1, X2) -> torch.Tensor:
        d2 = _scaled_sqdist(X1, X2, self.lengthscale(params))
        return torch.exp(-0.5 * d2)


@dataclasses.dataclass(frozen=True)
class MaternKernel:
    """Matérn kernel, nu ∈ {0.5, 1.5, 2.5} (gpytorch.kernels.MaternKernel;
    the reference's default is nu = 2.5)."""
    nu: float = 2.5
    ard_num_dims: Optional[int] = None

    def __post_init__(self):
        if self.nu not in (0.5, 1.5, 2.5):
            raise ValueError("nu must be one of 0.5, 1.5, 2.5")

    def init_params(self, d: int, dtype=torch.float32, device=None) -> Params:
        nls = self.ard_num_dims or 1
        return {"raw_lengthscale": _zeros((nls,), dtype, device)}

    def lengthscale(self, params):
        return softplus(params["raw_lengthscale"])

    def __call__(self, params: Params, X1, X2) -> torch.Tensor:
        d2 = _scaled_sqdist(X1, X2, self.lengthscale(params))
        # sqrt has an unbounded derivative at 0: on the diagonal (d2 == 0)
        # autograd gives inf·0 → NaN gradients.  Guard with a where-branch
        # — k(0) = 1 with zero local gradient, the correct limit since d2
        # is identically 0 there.
        eps = torch.finfo(d2.dtype).eps ** 2
        safe = d2 > eps
        r = torch.sqrt(torch.where(safe, d2, torch.ones_like(d2)))
        if self.nu == 0.5:
            k = torch.exp(-r)
        elif self.nu == 1.5:
            c = math.sqrt(3.0) * r
            k = (1.0 + c) * torch.exp(-c)
        else:
            c = math.sqrt(5.0) * r
            k = (1.0 + c + (5.0 / 3.0) * d2) * torch.exp(-c)
        return torch.where(safe, k, torch.ones_like(k))


@dataclasses.dataclass(frozen=True)
class ScaleKernel:
    """gpytorch.kernels.ScaleKernel — outputscale * base(·,·)."""
    base: object = dataclasses.field(default_factory=MaternKernel)

    def init_params(self, d: int, dtype=torch.float32, device=None) -> Params:
        return {"raw_outputscale": _zeros((), dtype, device),
                "base": self.base.init_params(d, dtype, device)}

    def __call__(self, params: Params, X1, X2) -> torch.Tensor:
        s = softplus(params["raw_outputscale"])[..., None, None]
        return s * self.base(params["base"], X1, X2)


@dataclasses.dataclass(frozen=True)
class LinearKernel:
    """gpytorch.kernels.LinearKernel — v * (x1 · x2)."""

    def init_params(self, d: int, dtype=torch.float32, device=None) -> Params:
        return {"raw_variance": _zeros((), dtype, device)}

    def __call__(self, params: Params, X1, X2) -> torch.Tensor:
        v = softplus(params["raw_variance"])[..., None, None]
        return v * (X1 @ X2.mT)


# --------------------------------------------------------------------- #
# Likelihoods
# --------------------------------------------------------------------- #

NOISE_LOWER = 1e-4  # gpytorch GreaterThan(1e-4) default constraint
LOG_2PI = math.log(2.0 * math.pi)
# the GP trainer's Adam (gp/exact_gp.py, gp/gp_step.py): optax.adam's defaults
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class GaussianLikelihood:
    """Homoskedastic noise; value = softplus(raw) + 1e-4."""

    def init_params(self, dtype=torch.float32, device=None) -> Params:
        return {"raw_noise": _zeros((), dtype, device)}

    def noise(self, params) -> torch.Tensor:
        return softplus(params["raw_noise"]) + NOISE_LOWER


@dataclasses.dataclass(frozen=True)
class FixedNoiseGaussianLikelihood:
    """gpytorch FixedNoiseGaussianLikelihood — per-point observed noise
    variances, not learned.  The noise vector travels in the params dict
    but is detached (the JAX package's stop_gradient)."""

    def init_params(self, noise_var: torch.Tensor) -> Params:
        return {"fixed_noise": torch.as_tensor(noise_var)}

    def noise(self, params) -> torch.Tensor:
        return params["fixed_noise"].detach()


@dataclasses.dataclass(frozen=True)
class MultitaskGaussianLikelihood:
    """gpytorch MultitaskGaussianLikelihood(num_tasks=r), rank 0: global
    noise + per-task noises, both softplus (+1e-4 for the global)."""
    num_tasks: int = 1

    def init_params(self, dtype=torch.float32, device=None) -> Params:
        return {"raw_noise": _zeros((), dtype, device),
                "raw_task_noises": _zeros((self.num_tasks,), dtype, device)}

    def noise(self, params) -> torch.Tensor:
        """Per-task total noise, shape ``batch + (num_tasks,)``."""
        return (softplus(params["raw_noise"])[..., None] + NOISE_LOWER
                + softplus(params["raw_task_noises"]))
