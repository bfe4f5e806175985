"""Seeded flame-shaped snapshot sets, made on the device.

The published flame sets (OpenMEASURE's ``X_2D_train.npy`` and the 3D set
on zenodo) are not in the repository, so the benchmark makes sets of the
published shapes from ``--seed``: ``X[:, j] = Σ_k u_k(cell) · f_k(P_j)``,
with smooth spatial modes ``u_k`` (a Gaussian bump times a harmonic along
the flame's axis, an amplitude per feature block), responses ``f_k`` of
the three operating parameters (D, H2, φ) that decay with ``k``, and a
per-feature offset and scale (a temperature-like block and species-like
blocks).  The construction follows the port's own
``datasets/synthetic.py``, with two changes: each mode's response has
frequencies (2 to 8 per unit of a scaled parameter) and phases of its
own, and decays as exp(-0.2 k), so that the singular values fall
smoothly past the 14 modes kept, σ₁₄/σ₁ near 1e-2 (the port's responses
repeat with k mod 3, 4 and 5, and its spectrum falls to the noise floor
after about 12 modes, which leaves the 13th and 14th modes, and the last
sensors, to the noise); and the noise is relative to each feature's
scale.  This copy
is the benchmark's, so that a change to the program cannot change the
inputs it is measured on.

Everything is drawn from one ``torch.Generator`` on ``device`` in a few
large calls and computed in float64; the snapshots are handed out in the
configuration's dtype.  The same seed on the same device gives the same
sets.  :meth:`FlameSet.fields_at` evaluates fresh snapshots at a few rows
only (the sensors' readings of a served frame).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

F64 = torch.float64


@dataclass
class FlameSet:
    modes: torch.Tensor      # (n, K) float64: the spatial modes, per row
    offsets: torch.Tensor    # (F,) float64
    scales: torch.Tensor     # (F,) float64
    n_cells: int
    n_features: int
    n_modes: int
    xyz: torch.Tensor        # (n_cells, 3) float64
    freq: torch.Tensor       # (3, K) float64: each response's frequencies
    phase: torch.Tensor      # (3, K) float64: and phases
    gen: torch.Generator

    def params(self, m: int) -> torch.Tensor:
        """``m`` operating points (D [mm], H2 [%], φ), (m, 3) float64."""
        u = torch.rand((m, 3), generator=self.gen, dtype=F64,
                       device=self.modes.device)
        lo = torch.tensor([1.0, 0.0, 0.6], dtype=F64, device=u.device)
        width = torch.tensor([2.0, 100.0, 0.6], dtype=F64, device=u.device)
        return lo + width * u

    def responses(self, P: torch.Tensor) -> torch.Tensor:
        """(m, K) nonlinear responses of the modes to the scaled
        parameters, each mode with its own frequencies and phases, their
        size decaying as exp(-0.2 k)."""
        k = torch.arange(self.n_modes, dtype=F64, device=P.device)
        p = (P - torch.tensor([2.0, 50.0, 0.9], dtype=F64, device=P.device)
             ) / torch.tensor([1.0, 50.0, 0.3], dtype=F64, device=P.device)
        f, ph = self.freq, self.phase                       # (3, K) each
        return torch.exp(-0.2 * k) * (
            torch.sin(f[0] * p[:, 0:1] + ph[0])
            + 0.7 * torch.tanh(f[1] * p[:, 1:2] + ph[1])
            + 0.4 * torch.cos(f[2] * p[:, 2:3] + ph[2]))

    def fields_at(self, rows: torch.Tensor, P: torch.Tensor,
                  noise: float) -> torch.Tensor:
        """Snapshots at ``P`` (m, 3) evaluated at ``rows`` only: (len(rows),
        m) float64, with ``noise`` times a standard normal added before
        each feature's offset and scale."""
        X = self.modes[rows] @ self.responses(P).T
        X = X + noise * torch.randn(X.shape, generator=self.gen, dtype=F64,
                                    device=X.device)
        f = rows // self.n_cells
        return self.offsets[f][:, None] + self.scales[f][:, None] * X

    def snapshots(self, P: torch.Tensor, noise: float) -> torch.Tensor:
        """Whole snapshots at ``P``: (n, m) float64."""
        rows = torch.arange(self.modes.shape[0], device=self.modes.device)
        return self.fields_at(rows, P, noise)


def make(n_cells: int, n_features: int, n_modes: int, seed: int,
         device) -> FlameSet:
    """The modes, offsets and scales of one flame set, drawn from ``seed``
    on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    dev = torch.device(device)

    def rand(*shape):
        return torch.rand(shape, generator=gen, dtype=F64, device=dev)

    # the domain: x in [0, 0.35), y in [-0.175, 0.175), z in [-0.15, 0.7)
    xyz = rand(n_cells, 3) * torch.tensor([0.35, 0.35, 0.85], dtype=F64,
                                          device=dev)
    xyz = xyz - torch.tensor([0.0, 0.175, 0.15], dtype=F64, device=dev)
    # per mode: a bump centre, its width and the harmonic's phase
    centre = rand(n_modes, 3) * torch.tensor([0.35, 0.35, 0.7], dtype=F64,
                                             device=dev)
    centre[:, 1] -= 0.175
    width = 0.05 + 0.15 * rand(n_modes)
    phase = rand(n_modes)
    k = torch.arange(n_modes, dtype=F64, device=dev)
    d2 = torch.cdist(xyz, centre) ** 2                      # (n_cells, K)
    bump = torch.exp(-d2 / (2.0 * width ** 2))
    wave = torch.cos(2.0 * math.pi * (k + 1.0) * xyz[:, 2:3] / 0.85 + phase)
    base = bump * (0.5 + wave)                               # (n_cells, K)
    amp = torch.randn((n_features, 1, n_modes), generator=gen, dtype=F64,
                      device=dev)
    modes = (amp * base[None]).reshape(n_features * n_cells, n_modes)
    offsets = torch.cat([torch.tensor([1200.0], dtype=F64, device=dev),
                         0.05 + 0.2 * rand(n_features - 1)])
    scales = torch.cat([torch.tensor([800.0], dtype=F64, device=dev),
                        0.02 + 0.1 * rand(n_features - 1)])
    freq = 2.0 + 6.0 * rand(3, n_modes)
    phase = 2.0 * math.pi * rand(3, n_modes)
    return FlameSet(modes, offsets, scales, n_cells, n_features, n_modes,
                    xyz, freq, phase, gen)
