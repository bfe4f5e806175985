"""The other placements on the card (``openmeasure_torch/sensing/gem.py``,
``dg.py``, ``vector.py``): D-optimal phase 1 through the QRCP kernel
(``csrc/qrcp.cu``), the fp32 selections' objectives against float64, and
the host reads each selection makes.

Every test here needs a CUDA card and skips without one; this file imports
neither JAX nor the JAX package, so on a machine with a card it runs as::

    python -m pytest tests/test_torch_placement_cuda.py --noconftest -q

Bars: the kernel's pivots bit-equal to the plain sweep (the same
arithmetic in the same order); fp32 and float64 selections may differ
where greedy steps are near ties, so their objectives are compared, each
evaluated in float64: the fp32 selection's within 1e-3 relative of float64
arithmetic's on the same basis (the fp32 model's; for VDG at the fp32
run's δ, whose floor is far above float64's), or better.  On the float64
model's basis the fp32 basis's trailing modes would decide the gap, not
the placement.  GEM reads back once, VDG three times (two scalars for
its regularization, then the result), as the JAX code does.
"""

import numpy as np
import pytest
import torch

from openmeasure_torch import SPR
from openmeasure_torch.datasets.synthetic import make_flame_dataset
from openmeasure_torch.linalg import qrcp as plain
from openmeasure_torch.sensing import dg, gem, vector
from openmeasure_torch.utils import logging as L

OBJ_REL = 1e-3
NF, R = 9, 10


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the placements run the card's "
                    "kernels")
    return torch.device("cuda")


@pytest.fixture
def basis(card):
    """The fp32 POD basis (9 features × 3000 cells, r = 10) of a flame
    set, fitted on the card, and the cell coordinates."""
    d = make_flame_dataset(n_cells=3000, m_train=20, m_test=2,
                           dtype=np.float32, seed=2)
    spr = SPR(d["X_train"], NF, d["xyz"], device=card)
    spr.fit(select_modes="number", n_modes=R)
    return spr.Ur, d["xyz"]


def gem_entropy(Ur, sel):
    """GEM's H_tot of the ordered selection ``sel`` on ``Ur`` (host
    float64): Σ over steps after the first of ½ log σ²_{y|a} + ½ (log 2π
    + 1), with the selection's scaling and 1e-5 jitter."""
    U = Ur.double().cpu().numpy()
    r = U.shape[1]
    Us = U * (2.0 / np.sqrt(np.nanmax(np.var(U, axis=1, ddof=1))))
    Uc = Us - Us.mean(axis=1, keepdims=True)
    H = 0.0
    for s in range(1, len(sel)):
        Cs, u = Uc[sel[:s]], Uc[sel[s]]
        Saa = Cs @ Cs.T / (r - 1) + 1e-5 * np.eye(s)
        Sya = Cs @ u / (r - 1)
        cv = u @ u / (r - 1) - Sya @ np.linalg.solve(Saa, Sya)
        H += 0.5 * np.log(cv) + 0.5 * (np.log(2 * np.pi) + 1.0)
    return H


def dg_logdet(Ur, sel):
    """log det(ΘᵀΘ) of Θ = Ur[sel], host float64."""
    T = Ur.double().cpu().numpy()[sel]
    return np.linalg.slogdet(T.T @ T)[1]


def vdg_delta(Ur, n_features, eps, ridge=1e-6):
    """(δ, mean block energy / p) as :func:`vector.vector_dg_select` sets
    them in a dtype of unit round-off ``eps``."""
    U = Ur.double().cpu().numpy()
    n, r = U.shape
    blocks = np.swapaxes(U.reshape(n_features, n // n_features, r), 0, 1)
    e = np.sum(blocks ** 2, axis=(1, 2))
    energy = e.mean() / n_features
    return max(ridge * energy, 64.0 * n_features * eps * e.max()), energy


def vdg_logdet(Ur, points, n_features, delta):
    """log det(δI + ΘᵀΘ) of the probes' stacked feature blocks, host
    float64."""
    U = Ur.double().cpu().numpy()
    n, r = U.shape
    blocks = np.swapaxes(U.reshape(n_features, n // n_features, r), 0, 1)
    T = blocks[points].reshape(-1, r)
    return np.linalg.slogdet(delta * np.eye(r) + T.T @ T)[1]


def _within(obj32, obj64):
    return obj32 >= obj64 or abs(obj32 - obj64) <= OBJ_REL * abs(obj64)


def dtoh_copies(fn):
    """Device-to-host copies in torch.profiler's trace of one call.  A
    trace can miss its first few device events, so a few small launches
    go first, and only the copies that start after the call began count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    lead = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(8):
            lead.add_(1.0)
        torch.cuda.synchronize()
        with record_function("test::call"):
            out = fn()
            torch.cuda.synchronize()
    events = list(prof.events())
    t0 = min(e.time_range.start for e in events if e.name == "test::call")
    n = sum(1 for e in events if e.device_type == DeviceType.CUDA
            and "DtoH" in e.name and e.time_range.start >= t0)
    return out, n


@pytest.mark.cuda
def test_dg_phase1_is_one_kernel_launch_equal_to_the_plain_sweep(basis):
    U32, _ = basis
    with L.recording() as rec:
        sel = dg.dg_select(U32, 2 * R)
    assert rec.counters["qrcp.kernel_launches"] == 1
    want = plain.qrcp_pivots(U32.T, R).cpu().numpy()
    np.testing.assert_array_equal(sel[:R], want)
    assert len(set(sel.tolist())) == 2 * R


@pytest.mark.cuda
def test_fp32_objectives_against_float64(basis):
    U32, xyz = basis
    U = U32.double()
    tiled = np.tile(xyz, (NF, 1))
    g32 = gem.gem_select(U32, tiled, 10, d_min=0.05)
    g64 = gem.gem_select(U, tiled, 10, d_min=0.05)
    objs = (gem_entropy(U, g32), gem_entropy(U, g64))
    assert _within(*objs), ("gem", objs, g32, g64)
    d32, d64 = dg.dg_select(U32, 2 * R), dg.dg_select(U, 2 * R)
    objs = (dg_logdet(U, d32), dg_logdet(U, d64))
    assert _within(*objs), ("dg", objs, d32, d64)
    # the fp32 run's δ (its floor is far above float64's) for both
    delta, energy = vdg_delta(U32, NF, float(np.finfo(np.float32).eps))
    v32 = vector.vector_dg_select(U32, NF, 4)
    v64 = vector.vector_dg_select(U, NF, 4, ridge=delta / energy)
    objs = (vdg_logdet(U, v32, NF, delta), vdg_logdet(U, v64, NF, delta))
    assert _within(*objs), ("vdg", objs, v32, v64)


@pytest.mark.cuda
def test_selections_read_back_as_the_jax_code_does(basis):
    U32, xyz = basis
    tiled = np.tile(xyz, (NF, 1))
    gem.gem_select(U32, tiled, 4)                     # warm-up
    _, n_gem = dtoh_copies(lambda: gem.gem_select(U32, tiled, 10,
                                                  d_min=0.05))
    assert n_gem == 1
    vector.vector_dg_select(U32, NF, 2)
    _, n_vdg = dtoh_copies(lambda: vector.vector_dg_select(U32, NF, 4))
    assert n_vdg == 3
    _, n_dg = dtoh_copies(lambda: dg.dg_select(U32, 2 * R))
    assert n_dg == 1
