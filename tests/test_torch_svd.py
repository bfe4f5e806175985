"""Port parity: ``openmeasure_torch.linalg.svd`` against
``openmeasure_tpu.linalg.svd`` on the same float64 panel (CPU).

U and Vt are compared under ``canonical_signs`` (porting trap 8: mode signs
from two eigensolvers are arbitrary).  Tolerance ``rtol=1e-9`` on the
leading well-separated modes: both sides run the same float64 Gram route
through LAPACK ``syevd``; an eigenvector's error is ~eps·‖G‖/gap, and the
first modes' relative gaps keep it far below 1e-9.  Singular values are
compared at the same tolerance.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from openmeasure_tpu.core import scaling as JS
from openmeasure_tpu.linalg import svd as J
from openmeasure_torch.linalg import svd as T
from openmeasure_torch.datasets.synthetic import make_flame_dataset

RTOL = 1e-9
LEAD = 5        # leading, well-separated modes compared elementwise


@pytest.fixture(scope="module")
def X0():
    d = make_flame_dataset(n_cells=400, n_features=3, m_train=12, m_test=3)
    return np.array(JS.scale_data(jnp.asarray(d["X_train"]), 3, "std", 1)[0])


def _canon(U, Vt):
    s = np.asarray(J.canonical_signs(jnp.asarray(U), xp=np))
    return U * s[None, :], Vt * s[:, None]


def _compare(Ut, St, Vtt, Uj, Sj, Vtj, k=LEAD):
    Ut, Vtt = _canon(np.asarray(Ut)[:, :k], np.asarray(Vtt)[:k])
    Uj, Vtj = _canon(np.asarray(Uj)[:, :k], np.asarray(Vtj)[:k])
    np.testing.assert_allclose(St[:k], Sj[:k], rtol=RTOL)
    np.testing.assert_allclose(Ut, Uj, rtol=RTOL, atol=RTOL * np.abs(Uj).max())
    np.testing.assert_allclose(Vtt, Vtj, rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("refine", [0, 1, 2])
def test_svd_tall_full(X0, refine):
    Ut, St, Vtt = T.svd_tall(torch.as_tensor(X0), refine=refine)
    Uj, Sj, Vtj = J.svd_tall(jnp.asarray(X0), refine=refine)
    _compare(Ut.numpy(), St.numpy(), Vtt.numpy(), np.asarray(Uj),
             np.asarray(Sj), np.asarray(Vtj))
    # canonicalize=True: the port applies the same sign rule itself
    np.testing.assert_array_equal(
        T.canonical_signs(Ut[:, :LEAD]).numpy(), np.ones(LEAD))


@pytest.mark.parametrize("refine,width,normalize", [
    (0, None, True), (1, None, True), (2, None, True), (2, 9, True),
    (1, 9, False), (2, None, False)])
def test_svd_tall_rank_width_normalize(X0, refine, width, normalize):
    r = 6
    kw = dict(refine=refine, canonicalize=False, rank=r, width=width,
              normalize=normalize)
    Ut, St, Vtt = T.svd_tall(torch.as_tensor(X0), **kw)
    Uj, Sj, Vtj = J.svd_tall(jnp.asarray(X0), **kw)
    assert Ut.shape == (X0.shape[0], r) and St.shape == (X0.shape[1],)
    _compare(Ut.numpy(), St.numpy(), Vtt.numpy(), np.asarray(Uj),
             np.asarray(Sj), np.asarray(Vtj))
    if not normalize:
        # the unnormalized panel carries the true column norms in S[:r]
        np.testing.assert_allclose(np.linalg.norm(Ut.numpy(), axis=0),
                                   St[:r].numpy(), rtol=1e-12)


def test_svd_tall_option_errors(X0):
    X = torch.as_tensor(X0)
    with pytest.raises(ValueError, match="canonicalize=False"):
        T.svd_tall(X, rank=3)
    with pytest.raises(ValueError, match="normalize=False requires"):
        T.svd_tall(X, normalize=False)
    with pytest.raises(ValueError, match="width requires"):
        T.svd_tall(X, width=4, canonicalize=False)
    with pytest.raises(ValueError, match="rank <= width <= m"):
        T.svd_tall(X, rank=5, width=4, canonicalize=False)


def test_svd_tall_deflated(X0):
    Ut, St, Vtt = T.svd_tall_deflated(torch.as_tensor(X0), rank=6, deflate=3)
    Uj, Sj, Vtj = J.svd_tall_deflated(jnp.asarray(X0), rank=6, deflate=3)
    _compare(Ut.numpy(), St.numpy(), Vtt.numpy(), np.asarray(Uj),
             np.asarray(Sj), np.asarray(Vtj), k=6)


def test_svd_tall_safe_rank_deficient(X0):
    """Row-centered X0 has rank ≤ m−1 (porting trap 7): both packages take
    the QR fixup and return an orthonormal U."""
    Ut, St, Vtt = T.svd_tall_safe(torch.as_tensor(X0))
    Uj, Sj, Vtj = J.svd_tall_safe(jnp.asarray(X0))
    _compare(Ut.numpy(), St.numpy(), Vtt.numpy(), np.asarray(Uj),
             np.asarray(Sj), np.asarray(Vtj))
    U = Ut.numpy()
    np.testing.assert_allclose(U.T @ U, np.eye(U.shape[1]), atol=1e-10)


def test_floored_norms_and_explained_variance(X0):
    S = np.array([3.0, 1.0, 1e-20, 0.0])
    ft = T.floored_norms(torch.as_tensor(S), 1000, torch.float64).numpy()
    fj = np.asarray(J.floored_norms(jnp.asarray(S), 1000, jnp.float64))
    np.testing.assert_array_equal(ft, fj)
    assert ft[2] == ft[3] == np.finfo(np.float64).eps * 1000 ** 0.5 * 3.0
    z = T.floored_norms(torch.zeros(3, dtype=torch.float64), 10,
                        torch.float64).numpy()
    np.testing.assert_array_equal(z, np.finfo(np.float64).tiny)
    Sv = np.linalg.svd(X0, compute_uv=False)
    np.testing.assert_allclose(
        T.explained_variance(torch.as_tensor(Sv)).numpy(),
        np.asarray(J.explained_variance(jnp.asarray(Sv))), rtol=1e-13)


@pytest.mark.parametrize("args,expect", [
    (("variance", 99.0, 12), None), (("variance", 100, 12), None),
    (("variance", 0, 12), None), (("number", 4, 12), None),
    (("variance", 101, 12), (ValueError, r"outside the\[0-100\] range")),
    (("number", 4.0, 12), (TypeError, "not an integer")),
    (("number", True, 12), (TypeError, "not an integer")),
    (("number", 13, 12), (ValueError, r"outside the \[1-m\] range")),
    (("bogus", 3, 12), (ValueError, "select_mode value is wrong")),
])
def test_select_rank(X0, args, expect):
    ev = np.array(J.explained_variance(
        jnp.asarray(np.linalg.svd(X0, compute_uv=False))))
    mode, n_modes, m = args
    if expect is None:
        assert T.select_rank(torch.as_tensor(ev), mode, n_modes, m) == \
            J.select_rank(ev, mode, n_modes, m)
        return
    exc, msg = expect
    with pytest.raises(exc, match=msg):
        J.select_rank(ev, mode, n_modes, m)
    with pytest.raises(exc, match=msg):
        T.select_rank(ev, mode, n_modes, m)


def test_default_refine_by_device(X0):
    """Porting trap 5: the JAX package keys refine on the TPU backend; the
    port keys it on the tensor's device — 2 on the CPU (the JAX package's
    non-TPU value, so the CPU parity tests compare like with like), 1 on a
    CUDA card (measured there)."""
    assert T.default_refine(torch.device("cpu")) == 2
    assert T.default_refine(torch.device("cuda")) == 1
    X = torch.as_tensor(X0)
    for a, b in zip(T.svd_tall(X), T.svd_tall(X, refine=2)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
