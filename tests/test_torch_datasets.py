"""The port's numpy-only copy of the synthetic flame generator must stay
bit-identical to the JAX package's (exact equality, every array)."""

import numpy as np
import pytest

from openmeasure_tpu.datasets.synthetic import make_flame_dataset as jax_make
from openmeasure_torch.datasets.synthetic import make_flame_dataset as port_make


@pytest.mark.parametrize("seed,dtype", [(0, np.float64), (1, np.float32)])
def test_make_flame_dataset_bit_identical(seed, dtype):
    kw = dict(n_cells=300, n_features=4, m_train=9, m_test=2, seed=seed,
              dtype=dtype)
    a, b = port_make(**kw), jax_make(**kw)
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k]
