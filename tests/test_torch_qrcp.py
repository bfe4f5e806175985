"""Port parity: the plain QRCP sweep and the dispatch of
``openmeasure_torch.linalg.qrcp`` / ``qrcp_cuda`` against
``openmeasure_tpu.linalg.qrcp`` (CPU).  The kernel-vs-plain checks that
need the card are in ``test_torch_qrcp_cuda.py``.

On the CPU, JAX's ``qrcp_pivots_auto`` takes its jnp read-only sweep — the
Pallas kernels' own oracle — and the port's takes its plain torch sweep.
Pivots must be EQUAL: the same greedy algorithm on the same numbers, with
random Gaussian panels whose deflated-norm gaps are far above round-off.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from openmeasure_tpu.linalg import qrcp as JQ
from openmeasure_tpu.linalg import qrcp_pallas as JQP
from openmeasure_torch.linalg import qrcp as TQ
from openmeasure_torch.linalg import qrcp_cuda as TQC
from openmeasure_torch.utils import logging as L


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("shape", [(14, 5000), (8, 2000)])
def test_plain_sweep_matches_jax(shape, dtype):
    A = np.random.default_rng(0).standard_normal(shape).astype(dtype)
    r = shape[0]
    pj = np.asarray(JQ.qrcp_pivots(jnp.asarray(A), r))
    pt = TQ.qrcp_pivots(torch.as_tensor(A), r)
    assert pt.dtype == torch.int32 and pt.shape == (r,)
    np.testing.assert_array_equal(pt.numpy(), pj)


def test_matches_scipy_geqp3():
    import scipy.linalg
    A = np.random.default_rng(3).standard_normal((10, 700))
    ref = scipy.linalg.qr(A, pivoting=True, mode="economic")[2][:10]
    np.testing.assert_array_equal(TQ.qrcp_pivots(torch.as_tensor(A), 10).numpy(),
                                  ref)


def test_row_scale_equals_prescaled_panel():
    """Decades-spread row scales, like 1/σ of an ill-conditioned basis (the
    pattern of the TPU kernels' own test)."""
    rng = np.random.default_rng(2)
    A = rng.standard_normal((14, 5000))
    dinv = np.geomspace(1.0, 1e4, 14)
    pa = TQC.qrcp_pivots_auto(torch.as_tensor(A), 14,
                              row_scale=torch.as_tensor(dinv))
    pp = TQ.qrcp_pivots(torch.as_tensor(A * dinv[:, None]), 14)
    pj = np.asarray(JQP.qrcp_pivots_auto(jnp.asarray(A), 14,
                                         row_scale=jnp.asarray(dinv)))
    np.testing.assert_array_equal(pa.numpy(), pp.numpy())
    np.testing.assert_array_equal(pa.numpy(), pj)


def test_duplicated_columns_tie_to_lowest_index():
    rng = np.random.default_rng(4)
    base = rng.standard_normal((6, 40))
    A = np.concatenate([base, base], axis=1)           # column j == j + 40
    big = np.argmax((A * A).sum(0))
    pt = TQ.qrcp_pivots(torch.as_tensor(A), 6).numpy()
    pj = np.asarray(JQ.qrcp_pivots(jnp.asarray(A), 6))
    assert pt[0] == big < 40
    assert np.all(pt < 40)                  # a duplicate is never preferred
    np.testing.assert_array_equal(pt, pj)


def test_k_above_128_takes_the_plain_path():
    A = np.random.default_rng(5).standard_normal((130, 400))
    pa = TQC.qrcp_pivots_auto(torch.as_tensor(A), 130).numpy()
    pj = np.asarray(JQP.qrcp_pivots_auto(jnp.asarray(A), 130))
    np.testing.assert_array_equal(pa, pj)
    assert len(set(pa.tolist())) == 130


def test_pivots_to_onehot():
    piv = torch.tensor([3, 0, 5], dtype=torch.int32)
    Ct = TQ.pivots_to_onehot(piv, 7)
    Cj = np.asarray(JQ.pivots_to_onehot(jnp.asarray(piv.numpy()), 7))
    assert Ct.dtype == torch.float32
    np.testing.assert_array_equal(Ct.numpy(), Cj)


def test_auto_dispatch_on_cpu_uses_plain_sweep():
    """A CPU tensor never reaches the kernel: the recorder counts no launch
    and the result equals the plain sweep (fp32 and f64)."""
    with L.recording() as rec:
        for dtype in (torch.float32, torch.float64):
            A = torch.as_tensor(
                np.random.default_rng(6).standard_normal((8, 900)),
                dtype=dtype)
            np.testing.assert_array_equal(TQC.qrcp_pivots_auto(A, 8).numpy(),
                                          TQ.qrcp_pivots(A, 8).numpy())
    assert "qrcp.kernel_launches" not in rec.counters


def test_strided_transposed_view_on_cpu():
    """The main path pivots B.T of a row-major (n, r) panel, and the class
    API Ur.T of a column slice: views, not copies, give the same pivots."""
    B = torch.as_tensor(np.random.default_rng(7).standard_normal((900, 10)))
    np.testing.assert_array_equal(
        TQC.qrcp_pivots_auto(B[:, :6].T, 6).numpy(),
        TQ.qrcp_pivots(B[:, :6].T.contiguous(), 6).numpy())


def test_wrapper_raises_on_cpu_tensor():
    A = torch.zeros((4, 100), dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        TQC.qrcp_pivots_cuda(A, 4)

