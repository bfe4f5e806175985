"""Shallow-decoder reconstruction (port of
``openmeasure_tpu/sensing/decoder.py``; Williams, Zahn & Kutz,
arXiv:2202.05330): a small MLP maps the s sensor readings straight to the
full n-dimensional state, trained on the snapshot columns.

The MLP is :class:`DecoderMLP`, an ``nn.Module`` whose weights keep the
JAX layout: W is (fan_in, fan_out), applied as ``h @ W + b``, ReLU between
the layers and a linear output.  Training is full-batch Adam with optax's
update order and constants, on the gradient autograd gives of
``mean((pred − X0)²) + l2 · Σ‖W‖²`` (biases are not regularized).  The JAX
``lax.scan`` over epochs is a Python loop over device tensors: no epoch
reads anything back, and the loss history is a device tensor of length
``epochs``.

Documented deviation: the initial weights are He-initialized (``N(0, 1) ·
√(2/fan_in)``, zero biases) from a ``torch.Generator`` seeded by ``seed``,
where the JAX package draws from threefry keys, so one seed gives other
weights in the two packages.  :meth:`ShallowDecoder.fit` takes the initial
parameters as ``params0``, so a run can start from the JAX package's.

Measurement convention as the reference's: y is (s, 3) = [value, σ,
feature-id]; σ is ignored (a neural decoder has no closed-form error
propagation; use SPR for σ).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..core.device import DeviceLike, as_tensor, to_numpy
from ..rom.rom import ROM, apply_sampling, scale_measurement_values

Layers = Sequence[Tuple[torch.Tensor, torch.Tensor]]

# optax.adam's defaults, which the JAX package trains with
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def _forward(layers: Layers, y: torch.Tensor) -> torch.Tensor:
    """MLP forward: ReLU hidden layers, linear output.  y (..., s)."""
    *hidden, (W_out, b_out) = layers
    h = y
    for W, b in hidden:
        h = torch.relu(h @ W + b)
    return h @ W_out + b_out


class DecoderMLP(nn.Module):
    """The decoder network: one (W, b) pair a layer, W (fan_in, fan_out)."""

    def __init__(self, layers: Layers):
        super().__init__()
        self.W = nn.ParameterList([nn.Parameter(W) for W, _ in layers])
        self.b = nn.ParameterList([nn.Parameter(b) for _, b in layers])

    def layers(self) -> list:
        return list(zip(self.W, self.b))

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        return _forward(self.layers(), y)


def init_params(sizes: Sequence[int], seed: int, dtype: torch.dtype,
                device: torch.device) -> list:
    """He-initialized layers for the widths ``sizes`` (s, hidden..., n):
    W ~ N(0, 1) · √(2/fan_in), drawn on the host from a generator seeded
    by ``seed`` (the same weights on every device), b = 0."""
    gen = torch.Generator().manual_seed(int(seed))
    layers = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        W = torch.randn((fan_in, fan_out), generator=gen, dtype=dtype) \
            * math.sqrt(2.0 / fan_in)
        layers.append((W.to(device), torch.zeros((fan_out,), dtype=dtype,
                                                 device=device)))
    return layers


def _train(Y0t: torch.Tensor, X0t: torch.Tensor, params0: Layers,
           epochs: int, lr: float, l2: float):
    """Full-batch Adam on the regularized MSE.  Y0t (m, s), X0t (m, n);
    ``params0`` the initial layers (copied).  Returns (trained layers,
    loss history (epochs,)), both on X0t's device, with no host read.

    Adam follows optax's ``scale_by_adam`` with its defaults
    (:data:`ADAM_B1`, :data:`ADAM_B2`, :data:`ADAM_EPS`, ``eps_root = 0``):
    mu and nu as ``(1 − b)·g + b·m``, bias-corrected by ``1 − b^t``, the
    update ``−lr · mu_hat / (√nu_hat + eps)`` added to the parameters."""
    b1, b2, eps = ADAM_B1, ADAM_B2, ADAM_EPS
    net = DecoderMLP([(W.detach().clone(), b.detach().clone())
                      for W, b in params0])
    params = list(net.parameters())
    Ws = list(net.W)
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    losses = torch.zeros((epochs,), dtype=X0t.dtype, device=X0t.device)
    for t in range(1, epochs + 1):
        pred = net(Y0t)
        mse = torch.mean((pred - X0t) ** 2)
        reg = sum(torch.sum(W * W) for W in Ws)
        loss = mse + l2 * reg
        grads = torch.autograd.grad(loss, params)
        c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        with torch.no_grad():
            for p, g, m, v in zip(params, grads, mu, nu):
                m.copy_((1.0 - b1) * g + b1 * m)
                v.copy_((1.0 - b2) * (g ** 2) + b2 * v)
                p.add_(-lr * ((m / c1) / (torch.sqrt(v / c2) + eps)))
            losses[t - 1] = loss
    return [(W.detach(), b.detach()) for W, b in net.layers()], losses


class ShallowDecoder(ROM):
    """Shallow decoder network: sensors → full state.

    Same data model as :class:`ROM` (feature-blocked X); ``hidden`` are the
    widths of the ReLU layers between the s inputs and the n outputs (the
    paper's flame example uses two layers of ~40 units).  ``device``:
    where the model trains and predicts (``None`` means the card)."""

    def __init__(self, X, n_features, xyz, hidden: Sequence[int] = (40, 45),
                 device: DeviceLike = None):
        super().__init__(X, n_features, xyz, device=device)
        self.hidden = tuple(int(h) for h in hidden)

    def fit(self, C, scale_type: str = "std", axis_cnt=1,
            epochs: int = 2000, lr: float = 1e-3, l2: float = 1e-6,
            seed: int = 0, params0: Optional[Layers] = None):
        """Train the decoder on the snapshot columns.

        C is the measurement operator of any placement (dense or
        ``scipy.sparse``).  The training pairs are the scaled readings
        ``C @ X0`` → the scaled snapshots ``X0`` (the statistics the
        gappy-POD path uses).  ``params0`` (layers of (W (fan_in, fan_out),
        b)) replaces the seeded He initialization."""
        X0 = self.scale_data(scale_type, axis_cnt)        # (n, m)
        Y0 = apply_sampling(C, X0)                        # (s, m)
        self.C = C
        sizes = (int(Y0.shape[0]),) + self.hidden + (int(X0.shape[0]),)
        if params0 is None:
            params0 = init_params(sizes, seed, X0.dtype, self.device)
        else:
            params0 = [(self._t(W).to(X0.dtype), self._t(b).to(X0.dtype))
                       for W, b in params0]
            got = tuple(int(W.shape[0]) for W, _ in params0) + (
                int(params0[-1][0].shape[1]),)
            if got != sizes:
                raise ValueError(f"params0 has layer widths {got}; the "
                                 f"decoder needs {sizes}.")
        self.params, self.loss_history = _train(
            Y0.T, X0.T, params0, int(epochs), float(lr), float(l2))
        self._cnt_vector_cache = to_numpy(apply_sampling(C, self.X_cnt[:, 0]))
        return self

    def _scale_y(self, y):
        """Value-column measurement scaling, the helper ``SPR.scale_vector``
        uses; the host copies of the statistics are cached, and re-derived
        after a post-fit ``scale_data`` reset them."""
        cnt_vector = self._cnt_vector_cache
        if cnt_vector is None:
            cnt_vector = to_numpy(apply_sampling(self.C, self.X_cnt[:, 0]))
            self._cnt_vector_cache = cnt_vector
        scl_full = getattr(self, "_scl_vector_cache", None)
        if scl_full is None:
            scl_full = to_numpy(self.X_scl[:, 0])
            self._scl_vector_cache = scl_full
        vals, _ = scale_measurement_values(
            y, cnt_vector, scl_full, self.n_points)
        return vals

    def predict(self, y):
        """Reconstruct full fields from measurement vectors.

        y: (s, 3) = [value, σ, feature-id] or a list of them (σ ignored).
        Returns the unscaled field(s) (n, n_vec), a tensor on the model's
        device."""
        if not hasattr(self, "params"):
            raise AttributeError("The function fit has to be called "
                                 "before calling predict.")
        if isinstance(y, (np.ndarray, torch.Tensor)):
            y = [y]
        y = [to_numpy(yi) for yi in y]
        s_sensors = int(self.params[0][0].shape[0])   # first layer W rows
        for yi in y:
            if yi.shape[1] != 3:
                raise ValueError("The y array has the wrong number of "
                                 "columns. y has to have dimensions (s,3).")
            if yi.shape[0] != s_sensors:
                raise ValueError(
                    f"The number of rows of y ({yi.shape[0]}) does not "
                    f"match the number of trained sensors ({s_sensors}).")
        dtype = self.params[0][0].dtype
        y0 = as_tensor(np.stack([self._scale_y(yi) for yi in y]),
                       self.device, dtype=dtype)
        with torch.no_grad():
            X0_pred = _forward(self.params, y0)           # (n_vec, n)
        return self.unscale_data(X0_pred.T)               # (n, n_vec)
