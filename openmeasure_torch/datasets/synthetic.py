"""Synthetic flame-like dataset generator (numpy only).

A copy of ``openmeasure_tpu.datasets.synthetic`` kept inside the port so the
port never imports the JAX package; its output must stay bit-identical to
the original for the same arguments (pinned by the port's tests).

The reference ships a 2D hydrogen-flame snapshot matrix (165,258 rows =
9 species × 18,362 cells, 41 training + 4 test simulations over parameters
(D, H2, phi)) as Git-LFS files unavailable in this environment
(``data/ROM/X_2D_train.npy``, see SURVEY §4).  This generator produces a
dataset of identical shape/dtype and qualitatively similar structure — smooth
fields with a decaying POD spectrum driven by nonlinear functions of the
parameters — for integration tests and benchmarks.

Construction: X[:, j] = Σ_k u_k(space) · f_k(P_j) + noise, with u_k smooth
spatial modes (Gaussian bumps × harmonics on a flame-shaped domain) and f_k
nonlinear parameter responses.  Feature blocks get distinct offsets/scales so
the per-feature scaling paths are exercised.
"""

from __future__ import annotations

import numpy as np


def make_flame_dataset(
    n_cells: int = 18362,
    n_features: int = 9,
    m_train: int = 41,
    m_test: int = 4,
    n_modes: int = 20,
    seed: int = 0,
    dtype=np.float64,
) -> dict:
    """Returns dict with X_train (n, m_train), X_test (n, m_test),
    P_train (m_train, 3), P_test (m_test, 3), xyz (n_cells, 3)."""
    rng = np.random.default_rng(seed)

    # Flame-like 2D domain (x, z), stored in a 3D xyz array like the README.
    x = rng.random(n_cells) * 0.35
    z = rng.random(n_cells) * 0.85 - 0.15
    xyz = np.zeros((n_cells, 3))
    xyz[:, 0] = x
    xyz[:, 2] = z

    # Parameters (D, H2, phi) — ranges loosely matching the flame study.
    def sample_params(m):
        P = np.zeros((m, 3))
        P[:, 0] = 1.0 + 2.0 * rng.random(m)      # D [mm]
        P[:, 1] = 100.0 * rng.random(m)          # H2 [%]
        P[:, 2] = 0.6 + 0.6 * rng.random(m)      # phi
        return P

    P_train = sample_params(m_train)
    P_test = sample_params(m_test)

    # Smooth spatial modes: Gaussian bumps modulated by harmonics, one
    # independent set per feature block.
    n = n_cells * n_features
    U = np.zeros((n, n_modes))
    for k in range(n_modes):
        cx, cz = rng.random() * 0.35, rng.random() * 0.7
        sx = 0.05 + 0.15 * rng.random()
        bump = np.exp(-((x - cx) ** 2 + (z - cz) ** 2) / (2 * sx ** 2))
        wave = np.cos(2 * np.pi * (k + 1) * z / 0.85 + rng.random())
        base = bump * (0.5 + wave)
        for f in range(n_features):
            amp = rng.standard_normal()
            U[f * n_cells:(f + 1) * n_cells, k] = amp * base

    # Nonlinear parameter responses with decaying magnitude.
    def responses(P):
        p0 = (P[:, 0] - 2.0) / 1.0
        p1 = (P[:, 1] - 50.0) / 50.0
        p2 = (P[:, 2] - 0.9) / 0.3
        F = np.zeros((P.shape[0], n_modes))
        for k in range(n_modes):
            decay = np.exp(-0.35 * k)
            F[:, k] = decay * (
                np.sin((k % 3 + 1) * p0 + 0.5 * k)
                + 0.7 * np.tanh((k % 4 + 1) * p1)
                + 0.4 * np.cos((k % 5 + 1) * p2)
            )
        return F

    # Feature-block offsets/scales (temperature-like block 0, species-like).
    offsets = np.concatenate([[1200.0], 0.05 + 0.2 * rng.random(n_features - 1)])
    scales = np.concatenate([[800.0], 0.02 + 0.1 * rng.random(n_features - 1)])

    def build(P):
        X = U @ responses(P).T  # (n, m)
        for f in range(n_features):
            blk = slice(f * n_cells, (f + 1) * n_cells)
            X[blk] = offsets[f] + scales[f] * X[blk]
        X += 1e-6 * rng.standard_normal(X.shape)
        return X.astype(dtype)

    return {
        "X_train": build(P_train),
        "X_test": build(P_test),
        "P_train": P_train.astype(dtype),
        "P_test": P_test.astype(dtype),
        "xyz": xyz.astype(dtype),
        "n_features": n_features,
    }
