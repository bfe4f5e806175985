"""The host-float64 compute stage behind ``engine='host'`` (port of
``openmeasure_tpu/core/host64.py``).

The reference trains its GP hyperparameters in double precision (gpytorch
``.double()``).  The GP matrices are tiny ((p, p) ≈ (41, 41)), so a float64
pass on the host is nearly free and removes the fp32 round-off of the GP
stage.  In the JAX package ``host_f64`` re-enters the same JAX programs on
the CPU backend under x64.  Here there is nothing to re-enter: the SAME
torch functions run on tensors placed on ``device='cpu'`` in float64, and
their results stay there — no second implementation to drift from the
card's path.  The kernel gates (``linalg/chol.py``) see a CPU float64
tensor and take the Cholesky formulation.

Documented deviation: the JAX ``tree_f64`` leaves non-float leaves where
they were (on the accelerator); :func:`tree_f64` moves every leaf to the
host, so a host stage never mixes devices.
"""

from __future__ import annotations

import torch

from .device import as_tensor

HOST = torch.device("cpu")


def tree_f64(tree):
    """Every leaf of a nested dict (or a single tensor) on the host;
    floating leaves cast to float64, others keep their dtype."""
    if isinstance(tree, dict):
        return {k: tree_f64(v) for k, v in tree.items()}
    t = as_tensor(tree, HOST)
    return t.to(torch.float64) if t.is_floating_point() else t
