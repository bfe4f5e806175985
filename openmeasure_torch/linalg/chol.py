"""Batched small-SPD inverse + log-determinant (port of
``openmeasure_tpu/linalg/chol_pallas.py``).

The GP training loop factorizes a batch of tiny kernel matrices — (r ≈ 14
modes, p ≈ 41 training points) — every Adam iteration, and needs both K⁻¹
(the closed-form gradient's trace terms) and log|K|.  On the card one CUDA
kernel computes both for the whole batch in one launch
(:mod:`openmeasure_torch.linalg.chol_cuda`, ``csrc/chol.cu``).

* :func:`chol_inv_logdet_plain` — the kernel's own arithmetic in torch ops
  (p Schur-complement steps, p forward-substitution steps for L⁻¹, the Gram
  L⁻ᵀL⁻¹ as a fixed-order sequential sum, logdet as the sum of the pivots'
  logs); the kernel's oracle on the card, where the two agree bit for bit.
* :func:`cholesky_nan` — ``jnp.linalg.cholesky``'s failure semantics in
  torch: the factor of a matrix whose factorization fails is NaN (lower
  triangle), where ``torch.linalg.cholesky`` raises and synchronizes with
  the host to check, and ``cholesky_ex`` leaves a partial factor.  Every
  port call site with a ``jnp.linalg.cholesky`` counterpart uses it.
* :func:`chol_inv_logdet_torch` — the Cholesky formulation, counterpart of
  ``chol_inv_logdet_jnp``: :func:`cholesky_nan` + ``cholesky_solve`` +
  2·Σ log diag.
* :func:`chol_inv_logdet_auto` — the dispatch: a CUDA fp32 batch with
  p ≤ 128 goes to the kernel; everything else (a CPU tensor, float64,
  p > 128) takes the Cholesky formulation, as the JAX package does off the
  TPU.  There is no fallback: a kernel that fails to build or launch
  raises.
* :func:`chol_inv_logdet` — differentiable to any order through the
  analytic rules dK⁻¹ = −K⁻¹ dK K⁻¹ and d logdet = tr(K⁻¹ dK) (the JAX
  ``custom_jvp``), as a ``torch.autograd.Function`` whose backward is
  written in differentiable torch ops on the saved K⁻¹.  A batch goes to
  the dispatch as one call, so a leading mode axis is one launch: what the
  JAX package's ``custom_vmap`` rule does.

The JAX package's ``OMTPU_NO_CHOL_KERNEL`` switch is not ported: on the card
it would be a route around the kernel.  An A/B comparison calls the plain
versions directly.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .chol_cuda import P_MAX, chol_inv_logdet_cuda


def kernel_takes(dtype: torch.dtype, device, p: int) -> bool:
    """Whether the kernel takes (..., p, p) stacks of ``dtype`` on
    ``device``: CUDA float32 with p ≤ 128, the gate of the GP hot paths.
    The JAX package's gate is the TPU backend and float32, with
    ``chol_fits_vmem`` bounding the batch by a VMEM budget; Hopper has no
    such budget (each matrix is its own thread block, with at most 132 KB
    of shared memory), so the batch has no bound here."""
    return (dtype == torch.float32 and torch.device(device).type == "cuda"
            and p <= P_MAX)


def _gram_sequential(Y: torch.Tensor) -> torch.Tensor:
    """``Yᵀ Y`` of a (B, p, p) batch as the kernel sums it: element (i, k)
    is ``0 + t₀ + t₁ + …`` with ``t_j = Y[j, i] · Y[j, k]`` added one
    separately rounded term at a time, j ascending.  For a lower-triangular
    Y the terms below j = max(i, k) are exact zeros, so the sum equals the
    kernel's, which starts there, bit for bit."""
    acc = torch.zeros_like(Y)
    for j in range(Y.shape[-1]):
        acc = acc + Y[:, j, :, None] * Y[:, j, None, :]
    return acc


def chol_inv_logdet_plain(K: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic on a (B, p, p) batch, in torch ops:
    ``(K⁻¹, logdet)``.  Each Schur step scales the pivot column by
    rsqrt(d_j) and subtracts its outer product from the trailing block;
    Y = L⁻¹ by forward substitution, one row per step; K⁻¹ = YᵀY summed
    in a fixed order (:func:`_gram_sequential`); logdet sums log d_j
    sequentially.  Only the lower triangle of K is read, as by the kernel.

    Every operation is a separately rounded elementwise op (no matmul, no
    fused multiply-add), in the kernel's order, so on the card the kernel
    and this version agree bit for bit on an SPD batch."""
    B, p, _ = K.shape
    A = K.clone()
    idx = torch.arange(p, device=K.device)
    ld = torch.zeros(B, dtype=K.dtype, device=K.device)
    rstds, scols = [], []
    for j in range(p):
        d = A[:, j, j]
        ld = ld + torch.log(d)
        rstd = torch.rsqrt(d)
        below = (idx > j).to(K.dtype)
        scol = A[:, :, j] * rstd[:, None] * below         # L[:, j] below j
        A = A - scol[:, :, None] * scol[:, None, :]        # Schur complement
        rstds.append(rstd)
        scols.append(scol)
    Y = torch.eye(p, dtype=K.dtype, device=K.device).expand(B, p, p).clone()
    for j in range(p):                                     # solve L Y = I
        yrow = Y[:, j, :] * rstds[j][:, None]
        Y = Y - scols[j][:, :, None] * yrow[:, None, :]
        Y[:, j, :] = yrow
    return _gram_sequential(Y), ld


def cholesky_nan(K: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of each matrix of a (..., p, p) stack, NaN in
    the lower triangle of each matrix whose factorization fails (not
    positive definite to working precision), as ``jnp.linalg.cholesky``
    returns it.  ``cholesky_ex`` checks nothing on the host, so neither
    does this; the upper triangle stays 0."""
    L, info = torch.linalg.cholesky_ex(K)
    p = K.shape[-1]
    low = torch.ones((p, p), dtype=torch.bool, device=K.device).tril()
    return torch.where((info > 0)[..., None, None] & low,
                       torch.full((), float("nan"), dtype=L.dtype,
                                  device=L.device), L)


def chol_inv_logdet_torch(K: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cholesky formulation on a (..., p, p) batch: :func:`cholesky_nan` +
    ``cholesky_solve`` against the identity + 2·Σ log diag.  A matrix whose
    factorization fails gives NaN in its K⁻¹ and logdet, as the JAX
    formulation does, never an exception or a host read."""
    L = cholesky_nan(K)
    p = K.shape[-1]
    eye = torch.eye(p, dtype=K.dtype, device=K.device).expand(K.shape)
    kinv = torch.cholesky_solve(eye, L)
    ld = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)),
                         dim=-1)
    return kinv, ld


def chol_inv_logdet_auto(K: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched ``(K⁻¹, logdet)`` of a (..., p, p) stack by the best route
    for the tensor: the CUDA kernel for a CUDA fp32 stack with p ≤ 128 (one
    launch for all leading dims), the Cholesky formulation otherwise."""
    lead = K.shape[:-2]
    p = K.shape[-1]
    K3 = K.reshape((-1, p, p))
    if kernel_takes(K.dtype, K.device, p):
        kinv, ld = chol_inv_logdet_cuda(K3)
    else:
        kinv, ld = chol_inv_logdet_torch(K3)
    return kinv.reshape(K.shape), ld.reshape(lead)


class _CholInvLogdet(torch.autograd.Function):
    """``K ↦ (K⁻¹, logdet)`` with the analytic backward of the JAX
    ``custom_jvp`` rule, transposed: for cotangents (G, g),
    ``gK = −K⁻ᵀ G K⁻ᵀ + g K⁻¹``.  The backward is plain differentiable
    torch ops on the saved output K⁻¹ (itself an output of this Function),
    so a second backward re-enters the same rule: Hessians work, as the
    JAX rule supports them."""

    @staticmethod
    def forward(ctx, K):
        kinv, ld = chol_inv_logdet_auto(K)
        ctx.save_for_backward(kinv)
        ctx.set_materialize_grads(False)
        return kinv, ld

    @staticmethod
    def backward(ctx, g_kinv, g_ld):
        (kinv,) = ctx.saved_tensors
        gK = None
        if g_kinv is not None:
            kt = kinv.mT
            gK = -(kt @ g_kinv @ kt)
        if g_ld is not None:
            t = g_ld[..., None, None] * kinv
            gK = t if gK is None else gK + t
        return gK


def chol_inv_logdet(K: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(K⁻¹, logdet)`` of a (..., p, p) SPD stack, differentiable to any
    order (see :class:`_CholInvLogdet`).  The whole stack is one call of
    :func:`chol_inv_logdet_auto`, so on the card a leading mode axis is
    one kernel launch."""
    return _CholInvLogdet.apply(K)
