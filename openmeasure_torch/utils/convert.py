"""Fitted state carried across from the JAX package's SPR.

:func:`spr_from_numpy` is the port's counterpart of loading weights: it
builds a fitted (and, with ``C``, trained) port :class:`SPR` from the JAX
SPR's attributes read out as numpy arrays, under the key names of the JAX
checkpoint format (``openmeasure_tpu/utils/checkpoint.py:100-107``).
Reading the ``.npz`` checkpoint files themselves is ROADMAP.md §A item 14.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

from ..core.device import DeviceLike, as_tensor
from ..sensing.spr import SPR

ARRAY_KEYS = ("X_cnt", "X_scl", "Ur", "Ar", "Vr", "Sigma_r", "xyz", "Theta",
              "C")
META_KEYS = ("r", "n_features", "n_points", "scale_type", "method")


def spr_from_numpy(state: Mapping[str, np.ndarray], meta: Dict,
                   device: DeviceLike = None) -> SPR:
    """A port SPR holding ``state`` on ``device`` (``None`` means the card).

    ``state`` needs ``X_cnt``, ``X_scl``, ``Ur`` and ``Ar``; ``Vr`` and
    ``Sigma_r`` are derived from ``Ar`` when absent, as ``fit`` does.  With
    ``C`` the model is trained on it (``Theta = C @ Ur``), and a given
    ``Theta`` then replaces the recomputed one.  ``meta`` carries
    ``n_features`` and optionally ``r``, ``n_points``, ``scale_type`` and
    ``method``.  The snapshot matrix is not carried: the model's ``X`` is a
    zero-memory placeholder with the right row count."""
    missing = [k for k in ("X_cnt", "X_scl", "Ur", "Ar") if k not in state]
    if missing:
        raise KeyError(f"spr_from_numpy: state lacks {missing}")
    n_features = int(meta["n_features"])
    n = np.asarray(state["X_cnt"]).shape[0]
    m = np.asarray(state["Ar"]).shape[0]
    placeholder = np.broadcast_to(np.zeros(()), (n, m))
    spr = SPR(placeholder, n_features, state.get("xyz"), device=device)
    if "n_points" in meta and int(meta["n_points"]) != spr.n_points:
        raise ValueError(f"meta n_points={meta['n_points']} does not match "
                         f"{n} rows / {n_features} features")
    for key in ("X_cnt", "X_scl", "Ur", "Ar", "Vr", "Sigma_r"):
        if key in state:
            setattr(spr, key, as_tensor(state[key], spr.device))
    if "Sigma_r" not in state:
        spr.Sigma_r = spr.Ar.norm(dim=0)
    if "Vr" not in state:
        spr.Vr = spr.Ar / spr.Sigma_r[None, :]
    spr.r = int(meta.get("r", spr.Ar.shape[1]))
    spr.scale_type = meta.get("scale_type", "std")
    if state.get("C") is not None:
        spr.train(state["C"], method=meta.get("method", "OLS"))
        if state.get("Theta") is not None:
            spr.Theta = as_tensor(state["Theta"], spr.device)
    return spr
