"""Port parity for the batched SPD inverse + log-determinant
(``openmeasure_torch/linalg/chol.py``) against ``openmeasure_tpu`` (CPU).

Tolerances:
* ``chol_inv_logdet_torch`` against ``chol_inv_logdet_jnp`` in float64 at
  ``rtol=1e-12`` (K⁻¹ relative to its largest entry) and ``1e-12``
  absolute on logdet: two LAPACK Cholesky factorizations of the same
  well-conditioned (cond ≲ 1e2) matrices differ by a few ulps.
* ``chol_inv_logdet_plain``'s fixed-order Gram against ``YᵀY`` in float64
  to p · 1e-15 of its largest entry, and against the kernel's own order
  (the sum from j = max(i, k)) bit for bit in fp32.
* ``chol_inv_logdet_plain`` against the Pallas kernel body itself, run in
  interpret mode, in fp32: 2e-6 of max|K⁻¹| and 5e-5 absolute on logdet —
  the same arithmetic step for step, but the Gram and rsqrt are rounded by
  two libraries (fp32 eps 1.2e-7, p ≤ 64 sequential terms).
* the autograd rule: ``gradcheck``/``gradgradcheck`` at their float64
  defaults, and against ``jax.jvp`` (first and second order) at 1e-10
  relative — the same analytic rule on the same float64 inverse.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from openmeasure_tpu.linalg import chol_pallas as CP
from openmeasure_torch.linalg import chol as TC
from openmeasure_torch.linalg import chol_cuda as TCC
from openmeasure_torch.utils import logging as L


def _spd(B, p, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((B, p, p))
    K = np.einsum("bij,bkj->bik", Q, Q) / p + 0.5 * np.eye(p)[None]
    return ((K + np.swapaxes(K, 1, 2)) / 2).astype(dtype)


@pytest.mark.parametrize("B,p", [(14, 41), (3, 17), (2, 1), (1, 70)])
def test_torch_formulation_matches_jnp_f64(B, p):
    K = _spd(B, p, seed=p)
    kj, lj = CP.chol_inv_logdet_jnp(jnp.asarray(K))
    kt, lt = TC.chol_inv_logdet_torch(torch.as_tensor(K))
    scale = np.abs(np.asarray(kj)).max()
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), rtol=0,
                               atol=1e-12 * scale)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=1e-12)


def _pallas_body_interpret(K32):
    """The TPU kernel's own body (``_chol_kernel``) on the identity-padded
    input, run by Pallas in interpret mode on the CPU — the JAX package is
    called, not changed."""
    B, p, _ = K32.shape
    pp = CP._round_up(max(p, 8), 8)
    Kp = np.zeros((B, pp, pp), np.float32)
    Kp[:, :p, :p] = K32
    Kp[:, np.arange(p, pp), np.arange(p, pp)] = 1.0
    kinv, ld = pl.pallas_call(
        functools.partial(CP._chol_kernel, p=p, pp=pp),
        out_shape=(jax.ShapeDtypeStruct((B, pp, pp), jnp.float32),
                   jax.ShapeDtypeStruct((B, 128), jnp.float32)),
        interpret=True)(jnp.asarray(Kp))
    return np.asarray(kinv)[:, :p, :p], np.asarray(ld)[:, 0]


@pytest.mark.parametrize("B,p", [(14, 41), (3, 17), (5, 64), (2, 1)])
def test_plain_matches_the_pallas_kernel_body_fp32(B, p):
    K = _spd(B, p, seed=100 + p, dtype=np.float32)
    kp, lp = _pallas_body_interpret(K)
    kt, lt = TC.chol_inv_logdet_plain(torch.as_tensor(K))
    assert kt.dtype == torch.float32
    scale = np.abs(kp).max()
    np.testing.assert_allclose(kt.numpy(), kp, rtol=0, atol=2e-6 * scale)
    np.testing.assert_allclose(lt.numpy(), lp, rtol=0, atol=5e-5)


def test_plain_matches_torch_formulation_f64():
    """The kernel's arithmetic is a Cholesky in another order: in float64
    it agrees with the LAPACK formulation to round-off."""
    K = torch.as_tensor(_spd(6, 41, seed=5))
    ka, la = TC.chol_inv_logdet_plain(K)
    kb, lb = TC.chol_inv_logdet_torch(K)
    assert float(torch.max(torch.abs(ka - kb))) <= 1e-11 * float(
        torch.max(torch.abs(kb)))
    assert float(torch.max(torch.abs(la - lb))) <= 1e-11


@pytest.mark.parametrize("B,p", [(3, 17), (2, 41), (1, 128)])
def test_sequential_gram_equals_matmul_f64(B, p):
    """The plain version's Gram, a fixed-order sequential sum, is YᵀY: in
    float64 it agrees with the matmul to round-off (p terms of eps)."""
    rng = np.random.default_rng(p)
    Y = torch.as_tensor(np.tril(rng.standard_normal((B, p, p))))
    got = TC._gram_sequential(Y)
    want = Y.mT @ Y
    assert float(torch.max(torch.abs(got - want))) <= \
        p * 1e-15 * float(torch.max(torch.abs(want)))


def test_sequential_gram_is_the_kernels_sum_bit_for_bit():
    """For a lower-triangular fp32 Y the terms below j = max(i, k) are exact
    zeros, so the sum from j = 0 equals the kernel's sum, which starts at
    max(i, k), bit for bit (here summed in numpy float32, one rounding a
    step)."""
    rng = np.random.default_rng(31)
    p = 9
    Y = np.tril(rng.standard_normal((2, p, p))).astype(np.float32)
    Y[0, 4, 2] = -0.0                       # a signed zero in the triangle
    got = TC._gram_sequential(torch.as_tensor(Y)).numpy()
    want = np.zeros_like(Y)
    for b in range(2):
        for i in range(p):
            for k in range(p):
                acc = np.float32(0.0)
                for j in range(max(i, k), p):
                    acc = np.float32(acc + np.float32(Y[b, j, i] * Y[b, j, k]))
                want[b, i, k] = acc
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_plain_reads_only_the_lower_triangle():
    """As the kernel does: garbage above the diagonal changes nothing."""
    K = torch.as_tensor(_spd(3, 12, seed=6, dtype=np.float32))
    G = K.clone()
    iu = torch.triu_indices(12, 12, offset=1)
    G[:, iu[0], iu[1]] = torch.as_tensor(
        np.random.default_rng(7).standard_normal((3, iu.shape[1])),
        dtype=torch.float32)
    ka, la = TC.chol_inv_logdet_plain(K)
    kb, lb = TC.chol_inv_logdet_plain(G)
    assert torch.equal(ka, kb) and torch.equal(la, lb)


def test_auto_on_cpu_takes_the_cholesky_formulation():
    """CPU tensors never reach the kernel wrapper (which raises on them):
    the dispatch sends them, float32 or float64, to the Cholesky branch,
    and keeps leading batch dims; the recorder counts no launch."""
    K = torch.as_tensor(_spd(6, 9, seed=1)).reshape(2, 3, 9, 9)
    with L.recording() as rec:
        for Kx in (K, K.float()):
            ka, la = TC.chol_inv_logdet_auto(Kx)
            kb, lb = TC.chol_inv_logdet_torch(Kx)
            assert ka.shape == (2, 3, 9, 9) and la.shape == (2, 3)
            assert torch.equal(ka, kb) and torch.equal(la, lb)
    assert "chol.kernel_launches" not in rec.counters
    with pytest.raises(ValueError, match="CUDA tensor"):
        TCC.chol_inv_logdet_cuda(K[0])


def test_gate():
    assert TC.kernel_takes(torch.float32, "cuda", 41)
    assert TC.kernel_takes(torch.float32, torch.device("cuda", 1), 128)
    assert not TC.kernel_takes(torch.float64, "cuda", 41)
    assert not TC.kernel_takes(torch.float32, "cpu", 41)
    assert not TC.kernel_takes(torch.float32, "cuda", 129)


def test_non_spd_gives_nan_not_an_exception():
    """Like ``jnp.linalg.cholesky``, a non-PD input yields NaN (the
    hyperparameter search can meet one in fp32)."""
    K = torch.as_tensor(-np.eye(4)[None])
    kinv, ld = TC.chol_inv_logdet(K)
    assert bool(torch.isnan(ld).all())


def _sym(A):
    return (A + A.mT) / 2


def test_autograd_gradcheck_and_gradgradcheck():
    """The backward is the analytic rule; through a symmetrizing map (the
    Cholesky reads one triangle, the rule is the derivative of the true
    inverse) it matches finite differences to first and second order."""
    K = torch.as_tensor(_spd(2, 5, seed=3)).requires_grad_(True)
    W = torch.as_tensor(np.random.default_rng(4).standard_normal((2, 5, 5)))

    def f(A):
        kinv, ld = TC.chol_inv_logdet(_sym(A))
        return kinv, ld

    def s(A):
        kinv, ld = TC.chol_inv_logdet(_sym(A))
        return torch.sum(W * kinv) + torch.sum(ld ** 2)

    assert torch.autograd.gradcheck(f, (K,))
    assert torch.autograd.gradgradcheck(f, (K,))
    assert torch.autograd.gradgradcheck(s, (K,))


def test_autograd_matches_jax_jvp_first_and_second_order():
    K = _spd(3, 7, seed=8)
    rng = np.random.default_rng(9)
    dK = rng.standard_normal((3, 7, 7))
    dK = (dK + np.swapaxes(dK, 1, 2)) / 2
    W = rng.standard_normal((3, 7, 7))

    (kj, lj), (dkj, dlj) = jax.jvp(
        jax.vmap(CP.chol_inv_logdet), (jnp.asarray(K),), (jnp.asarray(dK),))
    Kt, dKt = torch.as_tensor(K), torch.as_tensor(dK)
    (kt, lt), (dkt, dlt) = torch.autograd.functional.jvp(
        TC.chol_inv_logdet, Kt, dKt)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), rtol=1e-10)
    np.testing.assert_allclose(dkt.numpy(), np.asarray(dkj), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(dlt.numpy(), np.asarray(dlj), rtol=1e-10)

    # second order: Hessian-vector product of s(K) = <W, K⁻¹> + Σ logdet²
    def s_jax(A):
        kinv, ld = jax.vmap(CP.chol_inv_logdet)(A)
        return jnp.sum(jnp.asarray(W) * kinv) + jnp.sum(ld ** 2)

    _, hv_j = jax.jvp(jax.grad(s_jax), (jnp.asarray(K),), (jnp.asarray(dK),))

    def s_t(A):
        kinv, ld = TC.chol_inv_logdet(A)
        return torch.sum(torch.as_tensor(W) * kinv) + torch.sum(ld ** 2)

    _, hv_t = torch.autograd.functional.hvp(s_t, Kt, dKt)
    np.testing.assert_allclose(hv_t.numpy(), np.asarray(hv_j), rtol=1e-10,
                               atol=1e-12 * np.abs(np.asarray(hv_j)).max())
