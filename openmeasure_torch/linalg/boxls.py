"""Box-constrained quadratic programming by ADMM (port of
``openmeasure_tpu/linalg/boxls.py``).

Every constrained solve of the package reduces to

    min ½ gᵀH g − cᵀg   s.t.   lo ≤ A g ≤ hi

with a tiny (r × r) Hessian and a tall constraint operator A (n × r):
COLS gappy-POD (``min ‖W(y − Θg)‖²``, box on ``Ur g``), CPOD
(``min ‖Ur g − x0‖²``) and the constrained GP MAP (whitened, identity
Hessian).  The splitting ``z = A g`` costs two (n, r) products per
iteration; the (r, r) g-update factorization ``chol(H + ρ AᵀA)`` is
recomputed each step so the penalty ρ can adapt (residual balancing).

Where the JAX package ``vmap``s a solve over snapshots, measurement
vectors or test points, here the batch is a leading axis: ``c`` (b, r),
``lo``/``hi`` (b, q) and, for COLS, ``H`` (b, r, r) may carry it, the
operator A stays shared, and each iteration's (n, r) products take all b
right-hand sides in one GEMM.  The vmapped ``lax.while_loop`` runs until
every element has stopped and freezes an element once it has; the batched
loop below does the same with a per-element ``active`` mask applied
through ``torch.where``, so each element's iterate and iteration count are
those of its own solve.

Host reads: with ``tol == 0`` (the serving budget) the loop runs exactly
``max_iter`` iterations and reads nothing back.  With ``tol > 0`` it reads
one flag — "has every element stopped?" — every :data:`CHECK_EVERY`
iterations; iterations past an element's stop are masked no-ops, so the
result does not depend on that interval.

The batched (r, r) factorizations use ``torch.linalg.cholesky_ex`` (no
error check, hence no host read) and ``torch.cholesky_solve``: the JAX
package computes them with XLA's ``cho_factor``/``cho_solve`` outside any
Pallas kernel.  The MAP's covariance factor goes through
:func:`..linalg.chol.cholesky_nan`, so a covariance that is not positive
definite gives NaN as ``jnp.linalg.cholesky`` does; the ADMM's own factor
``H + ρAᵀA`` is shifted positive definite by construction and keeps the
plain ``cholesky_ex``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.device import as_tensor
from ..parallel import _comm
from .chol import cholesky_nan

# iterations between host reads of "every element stopped" when tol > 0
CHECK_EVERY = 16


class ADMMInfo(NamedTuple):
    iterations: torch.Tensor        # int32, () or (b,)
    primal_residual: torch.Tensor
    dual_residual: torch.Tensor


def _ndim(x) -> int:
    return x.ndim if hasattr(x, "ndim") else np.ndim(x)


class LinearConstraints(NamedTuple):
    """Stacked linear constraint set ``lo ≤ A g ≤ hi``.

    A general set is expressed by stacking rows: a box (finite
    ``lo < hi``), equality pins (``lo == hi``) and one-sided rows (``lo =
    -inf`` or ``hi = +inf``).  ``lo``/``hi`` may carry a leading batch axis
    (per-snapshot, per-vector or per-test-point values) while ``A`` is
    shared.  Fields may be numpy arrays, scalars or tensors; the solvers
    convert them."""
    A: object       # (q, r)
    lo: object      # (q,) or (batch, q)
    hi: object      # (q,) or (batch, q)

    @property
    def batched(self) -> bool:
        return _ndim(self.lo) == 2 or _ndim(self.hi) == 2


def _tensors(values):
    """``values`` as tensors on one device: that of the first tensor among
    them, else the host.  numpy arrays keep their dtype; ``torch.cat``
    promotes mixed float dtypes."""
    dev = next((v.device for v in values if isinstance(v, torch.Tensor)),
               torch.device("cpu"))
    return [as_tensor(v, dev) for v in values]


def concat_constraints(parts) -> LinearConstraints:
    """Stack several :class:`LinearConstraints` into one set.  Unbatched
    parts broadcast against batched ones (the shared-operator,
    per-item-values pattern); two different batch sizes raise."""
    parts = [LinearConstraints(*p) for p in parts]
    flat = _tensors([x for p in parts for x in p])
    parts = [LinearConstraints(*flat[3 * i:3 * i + 3])
             for i in range(len(parts))]
    As = [torch.atleast_2d(p.A) for p in parts]
    A = torch.cat(As, dim=0)
    batch_sizes = {p.lo.shape[0] for p in parts if p.lo.ndim == 2}
    batch_sizes |= {p.hi.shape[0] for p in parts if p.hi.ndim == 2}
    if len(batch_sizes) > 1:
        raise ValueError(
            f"inconsistent constraint batch sizes: {sorted(batch_sizes)}")
    if batch_sizes:
        b = batch_sizes.pop()
        shape = lambda Ai: (b, Ai.shape[0])             # noqa: E731
    else:
        shape = lambda Ai: (Ai.shape[0],)               # noqa: E731
    lo = torch.cat([torch.broadcast_to(torch.atleast_1d(p.lo), shape(Ai))
                    for p, Ai in zip(parts, As)], dim=-1)
    hi = torch.cat([torch.broadcast_to(torch.atleast_1d(p.hi), shape(Ai))
                    for p, Ai in zip(parts, As)], dim=-1)
    return LinearConstraints(A=A, lo=lo, hi=hi)


def build_constraint_set(constraints=None, box=None):
    """Compose a user ``constraints`` argument (a :class:`LinearConstraints`,
    a raw (A, lo, hi) triple, or a list of either) with an optional scaled
    physical ``box`` part into ONE stacked set — the one implementation of
    "``limits`` and ``constraints`` compose", shared by ``ROM.CPOD``,
    ``SPR.predict`` (COLS) and ``SoftSensor.from_spr``.

    Returns ``(cs, box_only)``: ``box_only`` is True when the set is
    exactly the box part (callers may then reuse an operator Gram they
    already have), and ``(None, False)`` when neither argument was given."""
    def as_part(c):
        return c if isinstance(c, LinearConstraints) else \
            LinearConstraints(*c)

    parts = []
    if constraints is not None:
        if isinstance(constraints, LinearConstraints):
            parts.append(constraints)
        elif isinstance(constraints, (list, tuple)):
            # a raw triple's first element is the 2-D operator itself, a
            # list's elements are sets or tuples
            if (len(constraints) == 3
                    and not isinstance(constraints[0],
                                       (LinearConstraints, list, tuple))
                    and _ndim(constraints[0]) == 2):
                parts.append(LinearConstraints(*constraints))
            else:
                parts.extend(as_part(c) for c in constraints)
        else:
            parts.append(LinearConstraints(*constraints))
    n_user = len(parts)
    if box is not None:
        parts.append(LinearConstraints(*box))
    if not parts:
        return None, False
    cs = parts[0] if len(parts) == 1 else concat_constraints(parts)
    # exactly the box also when `constraints` was an empty list
    return cs, n_user == 0


def _trace(M: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)


class _Operator:
    """The constraint operator ``A`` (n, r), shared by the batch, times an
    optional per-element right factor ``R`` (b, r, r): the whitened MAP's
    ``A L`` is applied as ``A (L u)`` so that the (n, r) products stay one
    GEMM over the batch instead of b separate (n, r) operators.

    With ``axis`` (a :class:`..parallel._comm.Axis` of several ranks) ``A``
    is this rank's block of constraint rows: ``fwd`` stays local, ``adj``
    and the row norms all-reduce their (b, r)- and (b,)-sized partials."""

    def __init__(self, A: torch.Tensor, R: Optional[torch.Tensor] = None,
                 axis=None):
        self.A, self.R, self.axis = A, R, axis

    def fwd(self, g: torch.Tensor) -> torch.Tensor:       # (b, r) -> (b, n)
        if self.R is not None:
            g = (self.R @ g[..., None])[..., 0]
        return g @ self.A.T

    def adj(self, v: torch.Tensor) -> torch.Tensor:       # (b, n) -> (b, r)
        u = v @ self.A
        if self.axis is not None:
            u = self.axis.sum(u)          # the rows' partial products
        if self.R is not None:
            u = (u[..., None, :] @ self.R)[..., 0, :]
        return u

    def norms(self, *vs: torch.Tensor):
        """Norms over the (sharded) constraint rows, one all-reduce."""
        return _comm.norms(self.axis, *vs)


def _admm(H, c, op: _Operator, lo, hi, AtA, rho, max_iter, tol, over_relax,
          adapt_rho, batched, n_rows=None):
    """The ADMM iteration on a batch (see :func:`admm_box_qp`).  ``H``
    (r, r) or (b, r, r), ``c`` (b, r), ``lo``/``hi`` (q,) or (b, q),
    ``AtA`` (r, r) or (b, r, r); ``n_rows`` the active constraint-row
    count of the residual normalizations (default ``A.shape[0]``)."""
    b, r = c.shape
    dtype, dev = c.dtype, c.device
    if rho is None:
        rho = (_trace(H) + 1e-12) / (_trace(AtA) + 1e-12)
        rho = torch.clamp(rho, min=1e-8)
    rho = torch.broadcast_to(torch.as_tensor(rho, dtype=dtype, device=dev),
                             (b,)).clone()
    rho0 = rho
    eye_r = torch.eye(r, dtype=dtype, device=dev)
    # eps-level ridge on the g-update factor: with BOTH H and AtA rank-
    # deficient (fewer sensors than modes AND a thin constraint set)
    # H + ρAᵀA is singular; the 64·eps·tr/r shift keeps the factor finite
    # far below the solver tolerance and is invisible when either has
    # full rank
    eps = torch.finfo(dtype).eps
    # relative convergence floor: residuals of an O(scale) problem stall
    # at ~eps·scale, which a purely absolute tol never reaches in fp32;
    # tol == 0 keeps the exact fixed budget
    eps_rel = 10.0 * eps
    normA = torch.sqrt(_trace(AtA))
    sqrt_n = float(op.A.shape[0] if n_rows is None else n_rows) ** 0.5
    sqrt_r = float(r) ** 0.5

    def factor(rho):
        M = H + rho[:, None, None] * AtA
        L, _ = torch.linalg.cholesky_ex(
            M + (64.0 * eps * (_trace(M) / r))[:, None, None] * eye_r)
        return L

    def solve(L, rhs):
        return torch.cholesky_solve(rhs[..., None], L)[..., 0]

    g = solve(factor(rho), c)                     # ρ-regularized warm start
    z = torch.clamp(op.fwd(g), lo, hi)
    w = torch.zeros_like(z)
    alpha = float(over_relax)
    # fixed ρ: the factor is loop-invariant; with tol == 0 the residual
    # norms are dead too (they feed only the stop test and the ρ schedule)
    fixed_fac = None if adapt_rho else factor(rho)
    need_norms = adapt_rho or float(tol) > 0.0
    has_tol = float(tol) > 0.0
    big = torch.full((b,), float("inf"), dtype=dtype, device=dev)
    pri, dua = big, big
    k = torch.zeros(b, dtype=torch.int32, device=dev)
    conv = torch.zeros(b, dtype=torch.bool, device=dev)

    for it in range(max_iter):
        if has_tol and it and it % CHECK_EVERY == 0 and \
                not bool(torch.any(~conv)):
            break
        fac = factor(rho) if adapt_rho else fixed_fac
        g_n = solve(fac, c + rho[:, None] * op.adj(z - w))
        Ag = op.fwd(g_n)
        Ag_rel = alpha * Ag + (1.0 - alpha) * z
        z_n = torch.clamp(Ag_rel + w, lo, hi)
        w_n = w + Ag_rel - z_n
        if not need_norms:
            g, z, w = g_n, z_n, w_n
            continue
        nrm = op.norms(Ag - z_n, z_n, *((Ag,) if has_tol else ()))
        pri_n = nrm[0] / sqrt_n
        dua_n = rho * torch.linalg.vector_norm(op.adj(z_n - z),
                                               dim=-1) / sqrt_r
        z_scale = nrm[1] / sqrt_n
        if has_tol:
            pri_thr = tol + eps_rel * torch.maximum(nrm[2] / sqrt_n, z_scale)
            dua_thr = tol + eps_rel * rho * normA * z_scale / sqrt_r
        else:
            pri_thr = dua_thr = 0.0
        conv_n = (pri_n <= pri_thr) & (dua_n <= dua_thr)
        rho_n = rho
        if adapt_rho:
            # residual balancing (Boyd et al. §3.4.1): grow ρ when the
            # primal residual dominates, shrink when the dual does, and
            # rescale the scaled dual variable; the clamp keeps ρ (and the
            # factor's conditioning) within six decades of ρ₀
            f = torch.where(pri_n > 10.0 * dua_n, 2.0,
                            torch.where(dua_n > 10.0 * pri_n, 0.5, 1.0))
            rho_n = torch.minimum(torch.maximum(rho * f, rho0 * 1e-6),
                                  rho0 * 1e6)
            w_n = w_n * (rho / rho_n)[:, None]
        # an element that has stopped stays frozen (the vmapped
        # while_loop's semantics)
        act = ~conv
        a1 = act[:, None]
        g = torch.where(a1, g_n, g)
        z = torch.where(a1, z_n, z)
        w = torch.where(a1, w_n, w)
        rho = torch.where(act, rho_n, rho)
        pri = torch.where(act, pri_n, pri)
        dua = torch.where(act, dua_n, dua)
        k = k + act.to(torch.int32)
        conv = conv | conv_n

    if not need_norms:
        k = torch.full((b,), max_iter, dtype=torch.int32, device=dev)
        # one pass fills the diagnostics the skipped norms would have given
        # (the last iterate's primal residual); no z_{k-1} is kept, so the
        # dual residual is NaN by contract
        Ag = op.fwd(g)
        pri = op.norms(Ag - torch.clamp(Ag, lo, hi))[0] / sqrt_n
        dua = torch.full((b,), float("nan"), dtype=dtype, device=dev)
    info = ADMMInfo(iterations=k, primal_residual=pri, dual_residual=dua)
    if not batched:
        return g[0], ADMMInfo(*(t[0] for t in info))
    return g, info


def _prepare(H, c, A, lo, hi, AtA):
    """Tensors on the device and in the dtype of the first tensor among
    ``c``, ``H``, ``A`` (float32 for all-float32 numpy input, else float64),
    and whether any argument carries the batch axis."""
    ref = next((x for x in (c, H, A) if isinstance(x, torch.Tensor)), None)
    if ref is not None:
        dev, dtype = ref.device, ref.dtype
    else:
        dev = torch.device("cpu")
        dtype = (torch.float32 if np.result_type(np.asarray(c), np.asarray(A))
                 == np.float32 else torch.float64)

    def t(x):
        return None if x is None else as_tensor(x, dev, dtype=dtype)
    H, c, A, lo, hi, AtA = (t(x) for x in (H, c, A, lo, hi, AtA))
    batched = (c.ndim == 2 or H.ndim == 3 or lo.ndim == 2 or hi.ndim == 2
               or (AtA is not None and AtA.ndim == 3))
    return H, c, A, lo, hi, AtA, batched


def _batch_size(*xs) -> int:
    sizes = {x.shape[0] for x, nd in xs if x is not None and x.ndim == nd}
    if len(sizes) > 1:
        raise ValueError(f"inconsistent batch sizes: {sorted(sizes)}")
    return sizes.pop() if sizes else 1


def admm_box_qp(H, c, A, lo, hi, AtA=None, rho=None, max_iter: int = 2000,
                tol: float = 1e-8, over_relax: float = 1.6,
                n_rows: Optional[int] = None, adapt_rho: bool = True,
                axis=None) -> Tuple[torch.Tensor, ADMMInfo]:
    """Solve ``min ½ gᵀH g − cᵀg  s.t. lo ≤ A g ≤ hi``.

    H : (r, r) PSD Hessian, or (b, r, r) one per batch element.
    c : (r,) linear term, or (b, r).
    A : (n, r) constraint operator, shared by the batch.
    lo, hi : (n,) bounds, or (b, n).
    AtA : optional (r, r) Gram ``AᵀA`` when known (e.g. the identity for an
        orthonormal basis), skipping the n-row product.
    rho : optional ADMM penalty; defaults to ``tr(H)/tr(AᵀA)``.
    n_rows : the ACTIVE constraint-row count of the residual
        normalizations, default ``A.shape[0]``.  Sharded serving pads the
        constraint set with inert rows (zero operator rows, [0, 0] bounds)
        to a multiple of the shard count; those rows add exact zeros to
        every product and norm, so with the unpadded count here the
        iteration, ρ schedule included, is that of the unpadded solve.
    adapt_rho : True keeps the residual-balancing ρ schedule; False is the
        fixed-ρ path for fixed-budget serving: the factorization is
        computed once and, with ``tol == 0``, the per-iteration residual
        norms are skipped (one final pass fills :class:`ADMMInfo`, whose
        dual residual is then NaN).
    axis : a :class:`..parallel._comm.Axis` over which ``A``'s rows (and
        ``lo``, ``hi``) are sharded: ``A`` is this rank's block, and the
        (b, r) adjoint products and (b,) norms are all-reduced.

    Returns ``(g, info)``: g (r,) or (b, r) when any argument is batched,
    ``info`` with per-element fields."""
    H, c, A, lo, hi, AtA, batched = _prepare(H, c, A, lo, hi, AtA)
    axis = _comm.active(axis)
    if AtA is None:
        AtA = A.T @ A if axis is None else axis.sum(A.T @ A)
    b = _batch_size((c, 2), (H, 3), (lo, 2), (hi, 2), (AtA, 3))
    c = torch.broadcast_to(c, (b, c.shape[-1]))
    return _admm(H, c, _Operator(A, axis=axis), lo, hi, AtA, rho, max_iter,
                 tol, over_relax, adapt_rho, batched, n_rows)


def box_constrained_lstsq(Theta, y, w_diag, A, lo, hi, AtA=None,
                          max_iter: int = 2000, tol: float = 1e-8,
                          over_relax: float = 1.6,
                          n_rows: Optional[int] = None,
                          adapt_rho: bool = True, axis=None
                          ) -> Tuple[torch.Tensor, ADMMInfo]:
    """``min ‖diag(w)(y − Θ g)‖²  s.t. lo ≤ A g ≤ hi`` (COLS, CPOD).
    ``y`` and ``w_diag`` are (s,) or (b, s), one weighted problem per
    row.  The half-factor convention cancels: the stationary points are
    those of the unhalved objective.  ``n_rows`` and ``axis`` as in
    :func:`admm_box_qp`."""
    if not isinstance(Theta, torch.Tensor):
        Theta = np.asarray(Theta)
        Theta = torch.as_tensor(Theta if Theta.dtype == np.float32
                                else Theta.astype(np.float64))
    y, w_diag = (as_tensor(x, Theta.device, dtype=Theta.dtype)
                 for x in (y, w_diag))
    Wt = Theta * w_diag[..., :, None]
    Wy = y * w_diag
    H = Wt.mT @ Wt
    c = (Wt.mT @ Wy[..., None])[..., 0]
    return admm_box_qp(H, c, A, lo, hi, AtA=AtA, max_iter=max_iter, tol=tol,
                       over_relax=over_relax, n_rows=n_rows,
                       adapt_rho=adapt_rho, axis=axis)


def box_constrained_map(mean, cov, A, lo, hi, AtA=None,
                        max_iter: int = 2000, tol: float = 1e-8,
                        over_relax: float = 1.6,
                        n_rows: Optional[int] = None,
                        adapt_rho: bool = True, axis=None
                        ) -> Tuple[torch.Tensor, ADMMInfo]:
    """Gaussian MAP under linear constraints, ``max −(v−μ)ᵀ cov⁻¹ (v−μ)
    s.t. lo ≤ A v ≤ hi`` — the constrained GP prediction.  ``mean`` (r,)
    or (b, r), ``cov`` (r, r) or (b, r, r).

    ``cov⁻¹`` is never formed: with ``L = chol(cov)`` and ``u = L⁻¹(v −
    μ)`` the problem is ``min ½‖u‖²  s.t.  lo − Aμ ≤ (A L) u ≤ hi − Aμ``,
    identity Hessian, one triangular transform each way.  ``A L`` is
    applied as ``A (L u)``, so a batch of points shares the (n, r)
    products.  ``n_rows`` and ``axis`` as in :func:`admm_box_qp`."""
    cov, mean, A, lo, hi, AtA, batched = _prepare(cov, mean, A, lo, hi, AtA)
    axis = _comm.active(axis)
    b = _batch_size((mean, 2), (cov, 3), (lo, 2), (hi, 2))
    r = mean.shape[-1]
    L = torch.broadcast_to(cholesky_nan(cov), (b, r, r))
    mean = torch.broadcast_to(mean, (b, r))
    H = torch.eye(r, dtype=mean.dtype, device=mean.device)
    c = torch.zeros((b, r), dtype=mean.dtype, device=mean.device)
    A_mu = mean @ A.T
    if AtA is None:
        AtA = A.T @ A if axis is None else axis.sum(A.T @ A)
    ALtAL = L.mT @ (AtA @ L)
    u, info = _admm(H, c, _Operator(A, L, axis), lo - A_mu, hi - A_mu, ALtAL,
                    None, max_iter, tol, over_relax, adapt_rho, True, n_rows)
    v = mean + (L @ u[..., None])[..., 0]
    if not batched:
        return v[0], ADMMInfo(*(t[0] for t in info))
    return v, info
