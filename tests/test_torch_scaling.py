"""Port parity: ``openmeasure_torch.core.scaling`` against
``openmeasure_tpu.core.scaling`` on the same float64 inputs (CPU).

Tolerance: ``rtol=1e-12`` — both sides compute the same float64 statistics;
only the summation order of the reductions differs (round-off ~1e-15
relative, amplified at most ~100x by the kurtosis and ratio formulas).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from openmeasure_tpu.core import scaling as J
from openmeasure_torch.core import scaling as T
from openmeasure_torch.datasets.synthetic import make_flame_dataset

RTOL = 1e-12


def _flame(n_cells=400):
    return make_flame_dataset(n_cells=n_cells, n_features=3, m_train=12,
                              m_test=3, seed=0)


@pytest.mark.parametrize("axis_cnt", [1, None])
@pytest.mark.parametrize("scale_type", T.SCALE_TYPES)
def test_scale_data_matches_jax(scale_type, axis_cnt):
    X = _flame()["X_train"]
    X0j, cj, sj = J.scale_data(jnp.asarray(X), 3, scale_type, axis_cnt)
    X0t, ct, st = T.scale_data(torch.as_tensor(X), 3, scale_type, axis_cnt)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=RTOL)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=RTOL)
    np.testing.assert_allclose(X0t.numpy(), np.asarray(X0j), rtol=RTOL,
                               atol=RTOL * np.abs(np.asarray(X0j)).max())


@pytest.mark.parametrize("n_cells", [400, 401])
def test_median_even_and_odd_block_counts(n_cells):
    """Porting trap 2: jnp.median averages the two middle values of an
    even-count block; torch.median would return the lower one.  400 cells ×
    12 snapshots is even, 401 × 11 odd."""
    X = make_flame_dataset(n_cells=n_cells, n_features=3,
                           m_train=12 if n_cells == 400 else 11, seed=1)["X_train"]
    _, _, sj = J.scale_data(jnp.asarray(X), 3, "median", 1)
    _, _, st = T.scale_data(torch.as_tensor(X), 3, "median", 1)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=RTOL)
    blk = X[:n_cells].ravel()
    assert st[0, 0].item() == pytest.approx(np.median(blk), rel=RTOL)
    if blk.size % 2 == 0:
        assert st[0, 0].item() != pytest.approx(torch.median(
            torch.as_tensor(blk)).item(), rel=1e-9)


def test_scale_limits_including_clamp():
    """Per-feature limits → scaled n-vectors; feature 0's bounds are far
    outside the data, so its whole block hits the ±1000 clamp."""
    X = _flame()["X_train"]
    _, cnt, scl = T.scale_data(torch.as_tensor(X), 3, "std", 1)
    _, cj, sj = J.scale_data(jnp.asarray(X), 3, "std", 1)
    lo = np.array([-1e9, -1.0, 0.0])
    hi = np.array([1e9, 2.0, 1.0])
    lj, hj = J.scale_limits(jnp.asarray(lo), jnp.asarray(hi), cj, sj, 3)
    lt, ht = T.scale_limits(torch.as_tensor(lo), torch.as_tensor(hi),
                            cnt, scl, 3)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=RTOL)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=RTOL)
    assert np.all(lt.numpy()[:400] == -1000.0)
    assert np.all(ht.numpy()[:400] == 1000.0)
    assert np.all(np.abs(lt.numpy()[400:]) < 1000.0)


@pytest.mark.parametrize("ndim", [1, 2])
def test_unscale_data(ndim):
    X = _flame()["X_train"]
    X0, cnt, scl = T.scale_data(torch.as_tensor(X), 3, "range", None)
    x0 = X0[:, 0] if ndim == 1 else X0
    back = T.unscale_data(x0, cnt, scl)
    ref = J.unscale_data(jnp.asarray(x0.numpy()), jnp.asarray(cnt.numpy()),
                         jnp.asarray(scl.numpy()))
    np.testing.assert_allclose(back.numpy(), np.asarray(ref), rtol=RTOL)
    np.testing.assert_allclose(back.numpy(), X[:, 0] if ndim == 1 else X,
                               rtol=1e-12)


@pytest.mark.parametrize("scale_type", ["std", "range", "median", "vast_3"])
def test_scale_parameters_matches_jax(scale_type):
    P = _flame()["P_train"]
    outj = J.scale_parameters(jnp.asarray(P), scale_type)
    outt = T.scale_parameters(torch.as_tensor(P), scale_type)
    for a, b in zip(outt, outj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=1e-14)


def test_unknown_scale_type_raises():
    X = torch.as_tensor(_flame()["X_train"])
    with pytest.raises(NotImplementedError):
        T.scale_data(X, 3, "bogus")
    with pytest.raises(ValueError, match="axis_cnt"):
        T.scale_data(X, 3, "std", 0)


def test_dead_block_raises_like_jax():
    """A constant feature block is refused by ROM.scale_data in both
    packages, naming the block."""
    from openmeasure_tpu.rom.rom import ROM as JROM
    from openmeasure_torch.rom.rom import ROM as TROM
    d = _flame()
    X = d["X_train"].copy()
    X[400:800] = 3.0                                   # feature 1 is dead
    with pytest.raises(ValueError, match=r"feature block\(s\) \[1\]"):
        JROM(X, 3, d["xyz"]).scale_data("std")
    with pytest.raises(ValueError, match=r"feature block\(s\) \[1\]"):
        TROM(X, 3, d["xyz"], device="cpu").scale_data("std")
