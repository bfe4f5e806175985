"""The QRCP CUDA kernel (``openmeasure_torch/csrc/qrcp.cu``) against its
plain version on the card.

Every test here needs a CUDA card and skips without one; this file imports
neither JAX nor the JAX package, so on a machine with a card it runs as::

    python -m pytest tests/test_torch_qrcp_cuda.py --noconftest -q

Tolerance: pivots EQUAL, and the final deflated norms² equal too — the
kernel and the plain sweep sum in the same order from separately rounded
products (see the note at the top of the CUDA source), so they agree bit
for bit in fp32, whether the kernel holds a column in shared memory or
reads it from global memory at each step.  A panel with a NaN entry gives
NaN norms in the same places (``assert_array_equal`` counts NaN equal to
NaN), and the same pivots: NaN ranks first, as in ``torch.argmax``.
"""

import numpy as np
import pytest
import torch

from openmeasure_torch.linalg import qrcp as TQ
from openmeasure_torch.linalg import qrcp_cuda as TQC
from openmeasure_torch.utils import logging as L


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _kernel_vs_plain(A, k, s=None):
    pk, nk = TQC._launch(A, k, s)
    pp, npl = TQ._sweep(A * s[:, None] if s is not None else A, k)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(pk.cpu().numpy(), pp.cpu().numpy())
    np.testing.assert_array_equal(nk.cpu().numpy(), npl.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("shape", [(14, 5000), (8, 20000), (1, 300),
                                   (5, 1001)])
def test_kernel_matches_plain(card, shape, scaled):
    """Random fp32 panels, ragged widths included, with and without
    decades-spread row scales (like 1/σ of an ill-conditioned basis)."""
    rng = np.random.default_rng(8)
    A = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                        device=card)
    r = shape[0]
    s = (torch.as_tensor(np.geomspace(1.0, 1e4, r), dtype=torch.float32,
                         device=card) if scaled else None)
    _kernel_vs_plain(A, min(r, 14), s)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [4097, 8192])
def test_kernel_takes_tall_panels(card, r):
    """Panels with more rows than q and the row scale would fit in a
    launch's default 48 KB of shared memory: the dispatch sends them to
    the kernel, which holds nothing of size r in shared memory."""
    rng = np.random.default_rng(r)
    A = torch.as_tensor(rng.standard_normal((r, 1500)), dtype=torch.float32,
                        device=card)
    s = torch.as_tensor(np.geomspace(1.0, 1e4, r), dtype=torch.float32,
                        device=card)
    _kernel_vs_plain(A, 4, s)
    with L.recording() as rec:
        TQC.qrcp_pivots_auto(A, 4, row_scale=s)
    assert rec.counters["qrcp.kernel_launches"] == 1


@pytest.mark.cuda
def test_kernel_reads_strided_views(card):
    """B.T of a row-major (n, r) panel (the main path), a column slice of
    it (the class API's Ur.T), and a column window of an (r, n) panel are
    read through their strides, with no copy."""
    rng = np.random.default_rng(9)
    B = torch.as_tensor(rng.standard_normal((30000, 14)),
                        dtype=torch.float32, device=card)
    _kernel_vs_plain(B.T, 14)
    _kernel_vs_plain(B[:, :9].T, 9)
    P = torch.as_tensor(rng.standard_normal((6, 9000)), dtype=torch.float32,
                        device=card)
    _kernel_vs_plain(P[:, 1000:8000], 6)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k,scaled,regime,layout", [
    ((14, 50000), 14, False, "all", "rows"),
    ((14, 50000), 14, True, "all", "B.T"),
    ((14, 2000000), 14, False, "part", "rows"),
    ((14, 2000000), 14, True, "part", "B.T"),
    ((60000, 300), 4, True, "none", "rows"),
])
def test_kernel_residency_regimes(card, shape, k, scaled, regime, layout):
    """Every column held in shared memory, part of them (more columns a
    block than its shared memory holds), and none (a panel taller than one
    block's shared memory); the panel row-major (r, n) or ``B.T`` of a
    row-major (n, r) panel, the main path's layout."""
    r, n = shape
    plan = TQC.device_plan(r, n, k, card)
    if regime == "all":
        assert plan.resident_cols == n
    elif regime == "part":
        assert 0 < plan.resident_cols < n
    else:
        assert plan.resident_cols == 0
    rng = np.random.default_rng(11)
    if layout == "B.T":
        A = torch.as_tensor(rng.standard_normal((n, r)), dtype=torch.float32,
                            device=card).T
    else:
        A = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device=card)
    s = (torch.as_tensor(np.geomspace(1.0, 1e4, r), dtype=torch.float32,
                         device=card) if scaled else None)
    _kernel_vs_plain(A, k, s)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 1), (14, 14), (6, 40)])
def test_kernel_takes_every_column(card, shape):
    """k = n: one column, a square panel and a wide-enough panel with every
    column picked (the last steps choose among −inf norms but one)."""
    rng = np.random.default_rng(12)
    A = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                        device=card)
    _kernel_vs_plain(A, shape[1])


@pytest.mark.cuda
@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("shape,k", [((14, 10), 12), ((3, 1), 4),
                                     ((8, 5), 7), ((200, 30), 40)])
def test_kernel_takes_more_pivots_than_columns(card, shape, k, scaled):
    """k > n (and k > r): once every column is a pivot all norms are −inf,
    and each later step picks column 0, as the plain sweep's argmax does;
    (200, 30) with k = 40 keeps Q in global memory (k r > 4096)."""
    rng = np.random.default_rng(18)
    A = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                        device=card)
    r, n = shape
    s = (torch.as_tensor(np.geomspace(1.0, 1e4, r), dtype=torch.float32,
                         device=card) if scaled else None)
    assert (TQC.device_plan(r, n, k, card).q_floats == 0) == (k * r > 4096)
    _kernel_vs_plain(A, k, s)
    pk = TQC.qrcp_pivots_cuda(A, k, row_scale=s).cpu()
    assert sorted(pk[:n].tolist()) == list(range(n))
    assert pk[n:].tolist() == [0] * (k - n)


@pytest.mark.cuda
def test_one_call_is_one_kernel(card):
    """One qrcp_pivots_cuda call runs exactly one kernel on the card.
    The trace can miss the first device events it records, so a few
    fills of a marker run first, and fills are left out of the count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(13)
    A = torch.as_tensor(rng.standard_normal((14, 50000)),
                        dtype=torch.float32, device=card)
    s = torch.as_tensor(np.geomspace(1.0, 1e4, 14), dtype=torch.float32,
                        device=card)
    TQC.qrcp_pivots_cuda(A, 14, row_scale=s)
    marker = torch.empty(1, device=card)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(8):
            marker.fill_(1.0)
        torch.cuda.synchronize()
        TQC.qrcp_pivots_cuda(A, 14, row_scale=s)
        torch.cuda.synchronize()
        marker.fill_(2.0)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and "memcpy" not in e.name.lower()
               and "memset" not in e.name.lower()
               and "Fill" not in e.name]
    assert len(kernels) == 1 and "qrcp" in kernels[0], kernels


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    A = torch.zeros((4, 100), dtype=torch.float32, device=card)
    with pytest.raises(ValueError, match="float32"):
        TQC.qrcp_pivots_cuda(A.double(), 4)
    with pytest.raises(ValueError, match="k <="):
        TQC.qrcp_pivots_cuda(A, 129)
    with pytest.raises(ValueError, match="k <="):
        TQC.qrcp_pivots_cuda(A, 0)
    with pytest.raises(ValueError, match="non-overlapping"):
        TQC.qrcp_pivots_cuda(A[:, :1].expand(4, 100), 4)
    for s in (torch.ones(3, device=card), torch.ones((4, 1), device=card)):
        with pytest.raises(ValueError, match="row_scale"):
            TQC.qrcp_pivots_cuda(A, 4, row_scale=s)
        with pytest.raises(ValueError, match="row_scale"):
            TQC.qrcp_pivots_auto(A, 4, row_scale=s)


@pytest.mark.cuda
def test_auto_dispatch_on_card(card):
    """fp32 with k ≤ 128 launches the kernel; float64, or k > 128, takes
    the plain sweep on the card, as the JAX package sends such panels to
    its jnp sweep."""
    rng = np.random.default_rng(10)
    A = torch.as_tensor(rng.standard_normal((130, 400)), device=card)
    with L.recording() as rec:
        p64 = TQC.qrcp_pivots_auto(A, 12)
        p130 = TQC.qrcp_pivots_auto(A.float(), 130)
    assert "qrcp.kernel_launches" not in rec.counters
    assert p64.device.type == "cuda" and len(set(p130.tolist())) == 130
    with L.recording() as rec:
        p32 = TQC.qrcp_pivots_auto(A.float(), 12)
    assert rec.counters["qrcp.kernel_launches"] == 1
    np.testing.assert_array_equal(p32.cpu().numpy(),
                                  TQ.qrcp_pivots(A.float(), 12).cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("shape,regime", [((14, 50000), "all"),
                                          ((14, 2000000), "part")])
def test_nan_column_matches_plain(card, shape, regime, scaled):
    """A NaN entry: the kernel ranks a NaN norm above every number and the
    lowest-index NaN first, as torch.argmax does, so pivots and final
    norms equal the plain sweep's, NaNs in the same places, whether the
    columns are read from shared or global memory."""
    r, n = shape
    plan = TQC.device_plan(r, n, 14, card)
    assert (plan.resident_cols == n) == (regime == "all")
    rng = np.random.default_rng(14)
    A = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                        device=card)
    A[5, n // 3] = float("nan")
    s = (torch.as_tensor(np.geomspace(1.0, 1e4, r), dtype=torch.float32,
                         device=card) if scaled else None)
    _kernel_vs_plain(A, 14, s)
    pk = TQC.qrcp_pivots_cuda(A, 14, row_scale=s).cpu()
    assert pk[0] == n // 3 and pk[1:].tolist() == [0, 1] * 6 + [0]


@pytest.mark.cuda
def test_auto_returns_where_the_cpu_path_returns(card):
    """k > n launches the kernel; an expanded or overlapping view is
    copied and launches the kernel, while qrcp_pivots_cuda itself refuses
    the view; both return the plain sweep's pivots."""
    rng = np.random.default_rng(15)
    A = torch.as_tensor(rng.standard_normal((14, 10)), dtype=torch.float32,
                        device=card)
    with L.recording() as rec:
        got = TQC.qrcp_pivots_auto(A, 12)
    assert rec.counters["qrcp.kernel_launches"] == 1
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  TQ.qrcp_pivots(A, 12).cpu().numpy())
    base = torch.as_tensor(rng.standard_normal(3000), dtype=torch.float32,
                           device=card)
    s = torch.as_tensor(np.geomspace(1.0, 1e3, 6), dtype=torch.float32,
                        device=card)
    for v in (base[:500].expand(6, 500), base[:6, None].expand(6, 500),
              torch.as_strided(base, (6, 500), (7, 1))):
        with pytest.raises(ValueError, match="non-overlapping"):
            TQC.qrcp_pivots_cuda(v, 6)
        with L.recording() as rec:
            got = TQC.qrcp_pivots_auto(v, 6, row_scale=s)
        assert rec.counters["qrcp.kernel_launches"] == 1
        np.testing.assert_array_equal(
            got.cpu().numpy(), TQ.qrcp_pivots(v * s[:, None], 6).cpu().numpy())


@pytest.mark.cuda
def test_spr_end_to_end_on_card_goes_through_the_kernel(card):
    from openmeasure_torch.datasets.synthetic import make_flame_dataset
    from openmeasure_torch.pipelines import spr_end_to_end
    d = make_flame_dataset(n_cells=2000, n_features=3, m_train=20, m_test=3,
                           dtype=np.float32)
    with L.recording() as rec:
        res = spr_end_to_end(d["X_train"], d["X_test"], n_features=3, r=10)
    torch.cuda.synchronize()
    assert rec.counters["qrcp.kernel_launches"] == 1
    assert res.X_rec.device.type == "cuda"
    assert float(res.nrmse) < 1e-3
