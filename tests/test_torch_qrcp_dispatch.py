"""The QRCP dispatch of ``openmeasure_torch.linalg.qrcp_cuda`` (CPU).

``qrcp_pivots_auto`` sends a CUDA fp32 panel with k ≤ 128 to the kernel,
copying a view the kernel cannot read through its strides: its routing
(:func:`qrcp_cuda._route`, a pure function of the device type, dtype, k,
shape and strides) is tested here without a card.  The port's plain sweep,
which the CPU takes and to which the card holds the kernel, is checked
against the JAX package's sweep — pivots EQUAL, in float64, for k > n and
for a panel with a NaN column (a NaN norm ranks above every number, the
lowest index first, in ``torch.argmax`` and ``jnp.argmax`` alike).  The
same calls on the card are in ``test_torch_qrcp_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmeasure_tpu.linalg import qrcp as JQ
from openmeasure_tpu.linalg import qrcp_pallas as JQP
from openmeasure_torch.linalg import qrcp as TQ
from openmeasure_torch.linalg import qrcp_cuda as TQC
from openmeasure_torch.utils import logging as L

F32, F64 = torch.float32, torch.float64


@pytest.mark.parametrize("device,dtype,k,shape,strides,want", [
    ("cuda", F32, 14, (14, 5000), (5000, 1), "kernel"),
    ("cuda", F32, 14, (14, 5000), (1, 14), "kernel"),         # B.T
    ("cuda", F32, 9, (9, 5000), (1, 14), "kernel"),           # Ur.T slice
    ("cuda", F32, 10, (14, 10), (10, 1), "kernel"),           # k == n
    ("cuda", F32, 12, (14, 10), (10, 1), "kernel"),           # k > n
    ("cuda", F32, 12, (14, 10), (1, 14), "kernel"),           # k > n, B.T
    ("cuda", F32, 129, (200, 5000), (5000, 1), "plain"),      # k > 128
    ("cuda", F32, 0, (14, 5000), (5000, 1), "kernel"),        # k < 1: raises
    ("cuda", F64, 14, (14, 5000), (5000, 1), "plain"),
    ("cpu", F32, 14, (14, 5000), (5000, 1), "plain"),
    ("cuda", F32, 4, (4, 100), (0, 1), "copy"),               # expand
    ("cuda", F32, 4, (4, 100), (1, 0), "copy"),               # expand
    ("cuda", F32, 4, (4, 100), (7, 1), "copy"),               # overlap
    ("cuda", F32, 4, (4, 100), (1, 3), "copy"),               # overlap
    ("cuda", F32, 20, (4, 100), (0, 1), "copy"),              # k > r
    ("cuda", F32, 4, (2 ** 31, 4), (4, 1), "kernel"),         # r: raises
    ("cuda", F32, 4, (4, 100, 2), (200, 2, 1), "kernel"),     # 3-D: raises
])
def test_route(device, dtype, k, shape, strides, want):
    """A CUDA fp32 panel with k ≤ 128 never takes the plain sweep, as in
    the JAX package's gate: the kernel takes it, or a contiguous copy of a
    view it cannot read, or raises on what it does not take."""
    assert TQC._route(device, dtype, k, shape, strides) == want


def test_route_of_real_views_and_their_copies():
    """The strides torch gives an expanded and an overlapping view route to
    a copy, and the contiguous copy the dispatch makes routes to the
    kernel; the kernel's own check refuses the view and takes the copy."""
    base = torch.arange(400, dtype=F32)
    views = [base[:100].expand(4, 100),
             base[:4, None].expand(4, 100),
             torch.as_strided(base, (4, 100), (7, 1))]
    for v in views:
        assert TQC._route("cuda", F32, 4, tuple(v.shape), v.stride()) == "copy"
        assert not TQC._strides_ok(tuple(v.shape), v.stride())
        c = v.clone(memory_format=torch.contiguous_format)
        assert TQC._route("cuda", F32, 4, tuple(c.shape), c.stride()) == "kernel"
        assert torch.equal(c, v)


@pytest.mark.parametrize("shape,k", [((8, 5), 7), ((14, 10), 12), ((3, 3), 5)])
def test_k_above_n_plain_sweep_matches_jax(shape, k):
    """k > n: once every column is a pivot the norms are all −inf, and both
    sweeps re-pick column 0 (argmax of equal values → the lowest index)."""
    A = np.random.default_rng(20 + k).standard_normal(shape)
    pj = np.asarray(JQ.qrcp_pivots(jnp.asarray(A), k))
    pa = TQC.qrcp_pivots_auto(torch.as_tensor(A), k).numpy()
    pt = TQ.qrcp_pivots(torch.as_tensor(A), k).numpy()
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(pa, pj)
    np.testing.assert_array_equal(
        pa, np.asarray(JQP.qrcp_pivots_auto(jnp.asarray(A), k)))
    assert sorted(pt[:shape[1]].tolist()) == list(range(shape[1]))
    assert np.all(pt[shape[1]:] == 0)


@pytest.mark.parametrize("k", [6, 10, 45])
def test_nan_column_plain_sweep_matches_jax(k):
    """A NaN entry makes its column's norm NaN: both sweeps pick it first,
    and from then on every norm is NaN but the last pivot's −inf (which
    turns back into NaN a step later: −inf − NaN² is NaN), so the later
    steps take the lowest-index NaN: columns 0, 1, 0, 1, …"""
    A = np.random.default_rng(21).standard_normal((6, 40))
    A[2, 7] = np.nan
    pj = np.asarray(JQ.qrcp_pivots(jnp.asarray(A), k))
    pt, norms = TQ._sweep(torch.as_tensor(A), k)
    np.testing.assert_array_equal(pt.numpy(), pj)
    assert pt.tolist() == [7] + [(i - 1) % 2 for i in range(1, k)]
    assert torch.isnan(norms).sum() == 39      # all but the last pivot
    row_scale = np.geomspace(1.0, 1e4, 6)
    pa = TQC.qrcp_pivots_auto(torch.as_tensor(A), k,
                              row_scale=torch.as_tensor(row_scale)).numpy()
    pja = np.asarray(JQP.qrcp_pivots_auto(jnp.asarray(A), k,
                                          row_scale=jnp.asarray(row_scale)))
    np.testing.assert_array_equal(pa, pja)


def test_auto_on_cpu_takes_views_and_numpy_row_scales():
    """On the CPU an expanded or overlapping view and a numpy row scale go
    through the plain sweep; the result equals the sweep of the dense copy
    scaled beforehand."""
    rng = np.random.default_rng(22)
    base = torch.as_tensor(rng.standard_normal(700))
    v = torch.as_strided(base, (6, 100), (7, 1))
    s = np.geomspace(1.0, 1e3, 6)
    with L.recording() as rec:
        got = TQC.qrcp_pivots_auto(v, 6, row_scale=s)
    want = TQ.qrcp_pivots(v.contiguous() * torch.as_tensor(s)[:, None], 6)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert "qrcp.kernel_launches" not in rec.counters
