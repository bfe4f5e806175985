"""Sharded pipelines over ``torch.distributed`` (port of
``openmeasure_tpu/parallel/sharded.py``).

The scaling axis is the state dimension n (165k–1.7M rows): the tall
snapshot matrix is sharded row-wise, feature-block aligned, over the
``state`` axis of a 2-D ``(state, mode)`` mesh, and the ``mode`` axis
splits the POD modes (the r single-task GPs) or the co-kriging outputs.

Design change from the JAX package.  There, GSPMD partitions one program
over global arrays and XLA inserts the collectives.  Here every rank runs
the program on its own rows, and each collective is written out on local
tensors (:mod:`._comm`):

* the POD Gram ``X0ᵀX0`` is a local (m, m) product plus one all-reduce,
  the fit's only (m, m)-sized communication;
* each greedy step (QRCP, GEM, DG, VDG) takes a local argmax and one
  all-gather of the ranks' candidates, with the unsharded tie rule;
* scaling moments are all-reduced sums in two passes (sums, then centred
  powers), extrema MAX/MIN, and ``median`` gathers the block;
* reconstruction is shard-local.

What a sharded output is (documented deviation): a rank holds only its
rows, so a field, a reconstruction or ``Ur`` comes back as this rank's
rows; small factors (Ar, pivots, Theta, GP posteriors and parameters) are
replicated on every rank.  :func:`gather_rows` assembles a whole array
for tests and small cases, where the JAX package returns one global
array.

A mesh comes from :func:`make_mesh`; ``device=None`` means the card, an
NCCL mesh, and ``device="cpu"`` a gloo mesh.  On an axis of one rank
every collective is the identity and the sharded functions run the
unsharded code (the QR placement keeps the CUDA kernel).  Nothing falls
back: a failed collective, kernel build or missing card raises.
"""

from __future__ import annotations

import datetime
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from ..core import scaling as _scaling
from ..core.device import DeviceLike, as_tensor, resolve_device
from ..gp import exact_gp as _E
from ..gp import kernels as _K
from ..linalg import boxls as _boxls
from ..linalg.incremental import svd_append_columns_cholqr
from ..linalg.qrcp_cuda import qrcp_pivots_sharded
from ..sensing.dg import dg_select
from ..sensing.gem import gem_select
from ..sensing.vector import vector_dg_select
from ._comm import (Axis, active, axis_of, check_mesh, gather_rows,
                    row_range, take_rows)

__all__ = [
    "make_mesh", "shard_snapshots", "sharded_spr_step",
    "sharded_spr_cols_step", "sharded_gem_select", "sharded_dg_select",
    "sharded_vdg_select", "sharded_update_basis", "sharded_gpr_train",
    "sharded_gp_train_step", "init_mode_stacked_params",
    "sharded_mfk_end_to_end", "sharded_mode_lstsq", "gather_rows",
]

# process-group timeout of the world make_mesh starts itself
TIMEOUT_S = 60.0


def make_mesh(n_state: int, n_mode: int = 1, device: DeviceLike = None):
    """The 2-D ``(state, mode)`` ``DeviceMesh`` over the current world.

    ``device=None`` means the card (as :func:`..core.device.resolve_device`,
    it raises without one); ``device="cpu"`` a host mesh.  When no process
    group is initialized and the mesh has one rank, a world of one is
    started here (NCCL on the card, gloo on the host, with a
    :data:`TIMEOUT_S` timeout); a larger mesh needs the world started by
    its launcher first (:func:`.harness.run_world`, or
    ``torch.distributed.init_process_group``)."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    world = int(n_state) * int(n_mode)
    if not dist.is_initialized():
        if world != 1:
            raise RuntimeError(
                f"a ({n_state}, {n_mode}) mesh needs a started world of "
                f"{world} ranks: start it with parallel.harness.run_world "
                "or torch.distributed.init_process_group first.")
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    if dist.get_world_size() != world:
        raise ValueError(
            f"mesh ({n_state}, {n_mode}) needs {world} ranks; the world "
            f"has {dist.get_world_size()}.")
    if dev.type == "cuda":
        # the mesh (and NCCL) take the process's current card
        torch.cuda.set_device(torch.cuda.current_device()
                              if dev.index is None else dev.index)
    return init_device_mesh(dev.type, (int(n_state), int(n_mode)),
                            mesh_dim_names=("state", "mode"))


def _mesh_device(mesh) -> torch.device:
    check_mesh(mesh)
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_snapshots(X, n_features: int, mesh) -> torch.Tensor:
    """This rank's block of the snapshot matrix X (n, m): the feature
    blocks ``(n_features, n_points, m)`` with the points axis split over
    the mesh's ``state`` axis, as a tensor (n_features, n_points/k, m) on
    the mesh's device, in X's dtype.  ``n_points`` must be divisible by
    the axis size k (pad upstream)."""
    ax = Axis.of(mesh, "state")
    X = as_tensor(X, _mesh_device(mesh))
    n, m = X.shape
    n_points = n // n_features
    if n_points * n_features != n or n_points % ax.size:
        raise ValueError(
            f"shard_snapshots needs n = n_features·n_points with n_points "
            f"divisible by the 'state' axis ({ax.size}); got n={n}, "
            f"n_features={n_features}.")
    a, b, _ = row_range(n_points, ax.size, ax.rank)
    return X.reshape(n_features, n_points, m)[:, a:b].contiguous()


def _block_gidx(n_features: int, npl: int, axis: Axis, device
                ) -> torch.Tensor:
    """Global row indices of this rank's rows of a blocked layout
    (n_features, npl, ·) whose points are split evenly over ``axis``."""
    n_points = npl * axis.size
    f = torch.arange(n_features, device=device)[:, None] * n_points
    p = axis.rank * npl + torch.arange(npl, device=device)[None, :]
    return (f + p).reshape(-1)


# --------------------------------------------------------------------- #
# Scaling
# --------------------------------------------------------------------- #

def _sharded_scale_factor(Xb: torch.Tensor, scale_type: str,
                          axis: Axis) -> torch.Tensor:
    """:func:`..core.scaling._block_scale_factor` of blocks whose points
    are sharded: means by two passes (an all-reduce of the sums, then of
    the centred powers, so the moments follow the unsharded formulas),
    extrema by MAX/MIN, ``median`` over the gathered block."""
    x = _scaling._flat(Xb)
    F = x.shape[0]
    if scale_type not in _scaling.SCALE_TYPES:
        raise NotImplementedError(
            "The scaling method selected has not been implemented yet")
    if scale_type == "none":
        return torch.ones(F, dtype=x.dtype, device=x.device)
    if scale_type == "median":
        return _scaling._block_median(axis.gather_cat(x, dim=1))
    if scale_type == "l2-norm":
        return torch.sqrt(axis.sum(torch.sum(x * x, dim=1)))
    if scale_type in ("range", "max"):
        mx = axis.max(torch.amax(x, dim=1))
        return mx if scale_type == "max" else mx - axis.min(
            torch.amin(x, dim=1))
    cnt = torch.full((F,), float(x.shape[1]), dtype=x.dtype, device=x.device)
    s1, N = axis.sum(torch.stack([torch.sum(x, dim=1), cnt]))
    mean = s1 / N
    if scale_type == "level":
        return mean
    if scale_type == "poisson":
        return torch.sqrt(mean)
    d = x - mean[:, None]
    d2 = d * d
    var, m4 = axis.sum(torch.stack([torch.sum(d2, dim=1),
                                    torch.sum(d2 * d2, dim=1)])) / N
    std = torch.sqrt(var)
    if scale_type == "std":
        return std
    if scale_type == "pareto":
        return torch.sqrt(std)
    if scale_type == "variance":
        return var
    if scale_type == "vast":
        return std ** 2 / mean
    kurt2 = (m4 / (var * var) - 3.0) ** 2
    if scale_type == "vast_2":
        return std ** 2 * kurt2 / mean
    mx = axis.max(torch.amax(x, dim=1))
    if scale_type == "vast_3":
        return std ** 2 * kurt2 / mx
    return std ** 2 * kurt2 / (mx - axis.min(torch.amin(x, dim=1)))


def _scale_blocks(Xb: torch.Tensor, scale_type: str = "std", axis_cnt=1,
                  mesh=None):
    """Per-feature-block scaling of the blocked layout, all 14 scale
    types: ``(X0 (F, npl, m), cnt (F, npl, 1), scl (F, 1, 1))``.  Row
    centring (``axis_cnt=1``) is shard-local; ``axis_cnt=None`` centres by
    the block mean, an (F,)-sized all-reduce.  Without a mesh (or on one
    rank) the unsharded statistics of :mod:`..core.scaling`."""
    axis = active(axis_of(mesh))
    if axis_cnt == 1:
        cnt = torch.mean(Xb, dim=2, keepdim=True)         # row means
    elif axis_cnt is None:
        if axis is None:
            blk = torch.mean(Xb, dim=(1, 2), keepdim=True)
        else:
            s1 = axis.sum(torch.sum(Xb, dim=(1, 2)))
            blk = (s1 / (Xb.shape[1] * Xb.shape[2] * axis.size))[:, None,
                                                                 None]
        cnt = torch.broadcast_to(blk, Xb.shape[:2] + (1,))
    else:
        raise ValueError("axis_cnt must be 1 or None")
    if axis is None:
        scl = _scaling._block_scale_factor(Xb, scale_type)
    else:
        scl = _sharded_scale_factor(Xb, scale_type, axis)
    scl = scl[:, None, None]
    return (Xb - cnt) / scl, cnt, scl


def _scale_limits_rows(lo_feat, hi_feat, cnt: torch.Tensor,
                       scl: torch.Tensor, feat: torch.Tensor,
                       n_features: int, axis: Axis):
    """:func:`..core.scaling.scale_limits` for sharded rows: ``cnt``,
    ``scl`` (n_local,) and each row's feature ``feat``; the per-feature
    ±1000 test reduces its block extrema over the ranks."""
    def one(limit):
        limit = torch.as_tensor(limit, dtype=cnt.dtype, device=cnt.device)
        temp = (limit[feat] - cnt) / scl
        inf = torch.full((n_features,), float("inf"), dtype=cnt.dtype,
                         device=cnt.device)
        mn = axis.min(inf.scatter_reduce(0, feat, temp, "amin"))
        mx = axis.max((-inf).scatter_reduce(0, feat, temp, "amax"))
        lo_bad, hi_bad = (mn < -1000.0)[feat], (mx > 1000.0)[feat]
        return torch.where(lo_bad, torch.full_like(temp, -1000.0),
                           torch.where(hi_bad, torch.full_like(temp, 1000.0),
                                       temp))
    return one(lo_feat), one(hi_feat)


# --------------------------------------------------------------------- #
# SPR steps
# --------------------------------------------------------------------- #

class _Fit(NamedTuple):
    Ur: torch.Tensor       # (F·npl, r) this rank's rows
    pivots: torch.Tensor   # (r,) int32, global
    cnt: torch.Tensor      # (F·npl, 1)
    scl: torch.Tensor      # (F·npl, 1)
    gidx: Optional[torch.Tensor]


def _fit_and_place(Xb_train, r, scale_type, mesh, axis) -> _Fit:
    """scale → Gram (all-reduced) → replicated eigh → shard-local Ur →
    QRCP pivots (:func:`..linalg.qrcp_cuda.qrcp_pivots_sharded`)."""
    F, npl, m = Xb_train.shape
    X0, cnt, scl = _scale_blocks(Xb_train, scale_type, 1, mesh)
    Xf = X0.reshape(F * npl, m)
    G = Xf.T @ Xf
    if axis is not None:
        G = axis.sum(G)                           # the (m, m) all-reduce
    _, V = torch.linalg.eigh(G)                   # replicated (m, m)
    V = torch.flip(V, dims=[1])
    B = Xf @ V                                    # shard-local panel pass
    if axis is None:
        S = torch.linalg.vector_norm(B, dim=0)
    else:
        S = torch.sqrt(axis.sum(torch.sum(B * B, dim=0)))
    Ur = (B / torch.clamp(S, min=1e-30)[None, :])[:, :r]
    gidx = None if axis is None else _block_gidx(F, npl, axis, B.device)
    pivots = qrcp_pivots_sharded(Ur.T, r, mesh, gidx)
    scl_f = torch.broadcast_to(scl, cnt.shape).reshape(F * npl, 1)
    return _Fit(Ur, pivots, cnt.reshape(F * npl, 1), scl_f, gidx)


def _sensor_rows(fit: _Fit, Xt: torch.Tensor, axis):
    """Theta and the scaled test readings at the pivots, from their
    owners: ``(Theta (r, r), y0 (r, m_test))``."""
    r, mt = fit.Ur.shape[1], Xt.shape[1]
    rows = take_rows(axis, torch.cat([fit.Ur, Xt, fit.cnt, fit.scl], dim=1),
                     fit.gidx, fit.pivots)
    Theta = rows[:, :r]
    y0 = (rows[:, r:r + mt] - rows[:, r + mt:r + mt + 1]) \
        / rows[:, r + mt + 1:]
    return Theta, y0


def _nrmse(X_rec: torch.Tensor, Xt: torch.Tensor, axis) -> torch.Tensor:
    err = X_rec - Xt
    if axis is None:
        return torch.sqrt(torch.mean(err * err)) / (
            torch.amax(Xt) - torch.amin(Xt))
    ss = axis.sum(torch.stack([torch.sum(err * err),
                               torch.tensor(float(err.numel()),
                                            dtype=err.dtype,
                                            device=err.device)]))
    span = axis.max(torch.amax(Xt)) - axis.min(torch.amin(Xt))
    return torch.sqrt(ss[0] / ss[1]) / span


def sharded_spr_step(Xb_train: torch.Tensor, Xb_test: torch.Tensor, r: int,
                     scale_type: str = "std", mesh=None):
    """The SPR training step on the blocked, sharded layout of
    :func:`shard_snapshots`: scale → Gram (one (m, m) all-reduce) → eigh
    (replicated) → Ur (shard-local) → QRCP pivots (all-gathered argmax per
    step; on one rank the CUDA kernel) → square gappy solve → NRMSE.
    ``Xb_train``/``Xb_test`` are this rank's blocks.  Returns ``(nrmse,
    pivots)``, replicated; ``mesh=None`` runs the same program unsharded."""
    axis = active(axis_of(mesh))
    fit = _fit_and_place(Xb_train, r, scale_type, mesh, axis)
    F, npl, _ = Xb_test.shape
    Xt = Xb_test.reshape(F * npl, -1)
    Theta, y0 = _sensor_rows(fit, Xt, axis)
    # solve_ex: a singular Theta gives NaN (as jnp.linalg.solve) with no
    # host read
    Ar = torch.linalg.solve_ex(Theta, y0)[0].T
    X_rec = (fit.Ur @ Ar.T) * fit.scl + fit.cnt
    return _nrmse(X_rec, Xt, axis), fit.pivots


def sharded_spr_cols_step(Xb_train: torch.Tensor, Xb_test: torch.Tensor,
                          r: int, lo_feat, hi_feat, scale_type: str = "std",
                          max_iter: int = 500, tol: float = 1e-8, mesh=None):
    """SPR with the constrained (COLS) reconstruction, sharded end to end:
    the fit and placement of :func:`sharded_spr_step`, then the batched
    ADMM box-QP against per-feature limits (one problem per test
    snapshot, the JAX package's vmap) through
    :func:`..linalg.boxls.box_constrained_lstsq` with the constraint rows
    sharded — shard-local (n, r) products, an (r,)-sized all-reduce per
    adjoint, all-reduced residual norms normalized by the active n.
    Returns ``(nrmse, pivots, Ar, (Ur, lo, hi))``; Ur, lo and hi are this
    rank's rows."""
    axis = active(axis_of(mesh))
    fit = _fit_and_place(Xb_train, r, scale_type, mesh, axis)
    F, npl, _ = Xb_test.shape
    Xt = Xb_test.reshape(F * npl, -1)
    Ur = fit.Ur
    if axis is None:
        lo, hi = _scaling.scale_limits(lo_feat, hi_feat, fit.cnt, fit.scl, F)
        AtA = Ur.T @ Ur
    else:
        feat = torch.arange(F, device=Ur.device).repeat_interleave(npl)
        lo, hi = _scale_limits_rows(lo_feat, hi_feat, fit.cnt[:, 0],
                                    fit.scl[:, 0], feat, F, axis)
        AtA = axis.sum(Ur.T @ Ur)
    Theta, y0 = _sensor_rows(fit, Xt, axis)
    Ar, _ = _boxls.box_constrained_lstsq(
        Theta, y0.T, torch.ones_like(y0.T), Ur, lo, hi, AtA=AtA,
        max_iter=max_iter, tol=tol, n_rows=F * npl * (1 if axis is None
                                                      else axis.size),
        axis=axis)
    X_rec = (Ur @ Ar.T) * fit.scl + fit.cnt
    return _nrmse(X_rec, Xt, axis), fit.pivots, Ar, (Ur, lo, hi)


# --------------------------------------------------------------------- #
# Placements and the incremental update
# --------------------------------------------------------------------- #

def sharded_gem_select(Ur: torch.Tensor, xyz_tiled, n_sensors: int,
                       d_min: float = 0.0, mesh=None, gidx=None):
    """GEM placement on a row-sharded basis: ``Ur`` and ``xyz_tiled`` are
    this rank's rows (``gidx`` their global indices, default the ranks'
    blocks in rank order).  The same loop as the eager path
    (:func:`..sensing.gem.gem_select`): the conditional-variance scores
    are shard-local, the argmax and the selected row are all-gathered.
    Returns the global row indices, int64 on the host, on every rank."""
    return gem_select(Ur, xyz_tiled, n_sensors, d_min=d_min, mesh=mesh,
                      gidx=gidx)


def sharded_dg_select(Ur: torch.Tensor, n_sensors: int, mesh=None,
                      gidx=None):
    """Determinant-greedy placement on a row-sharded basis (the loop of
    :func:`..sensing.dg.dg_select`; phase 1 the sharded QRCP, phase 2's
    argmax all-gathered)."""
    return dg_select(Ur, n_sensors, mesh=mesh, gidx=gidx)


def sharded_vdg_select(Ur: torch.Tensor, n_features: int, n_sensors: int,
                       xyz=None, d_min: float = 0.0, mesh=None,
                       point_gidx=None):
    """Vector-probe greedy placement on a points-sharded blocked basis (the
    loop of :func:`..sensing.vector.vector_dg_select`): ``Ur`` is this
    rank's rows in the layout of :func:`shard_snapshots` and ``xyz`` its
    points; the per-point block scores and Cholesky logdets are
    shard-local, the argmax and the selected block all-gathered."""
    return vector_dg_select(Ur, n_features, n_sensors, xyz=xyz, d_min=d_min,
                            mesh=mesh, point_gidx=point_gidx)


def sharded_update_basis(U: torch.Tensor, S: torch.Tensor, Vt: torch.Tensor,
                         Xn: torch.Tensor, reorth: bool = True, mesh=None):
    """Incremental thin-SVD basis update on a row-sharded basis:
    :func:`..linalg.incremental.svd_append_columns_cholqr` with ``U`` and
    ``Xn`` this rank's rows — shard-local panel passes, all-reduced (r, q)
    projections and (q, q) Gram, a replicated core.  Returns this rank's
    rows of U' and the replicated S', Vt'."""
    return svd_append_columns_cholqr(U, S, Vt, Xn, reorth=reorth, mesh=mesh)


# --------------------------------------------------------------------- #
# The mode axis
# --------------------------------------------------------------------- #

def _specs():
    return _K.ConstantMean(), _K.MaternKernel(2.5), _K.GaussianLikelihood()


def init_mode_stacked_params(r: int, d: int, dtype=torch.float32,
                             device: DeviceLike = None):
    """Initial stacked single-task GP parameters (leading axis = mode) of
    the Matérn-2.5 / constant-mean / Gaussian-likelihood model, on
    ``device`` (``None`` means the card)."""
    dev = resolve_device(device)
    mean, kernel, lik = _specs()
    like = dict(dtype=dtype, device=dev)
    p = {"mean": mean.init_params(d, **like),
         "kernel": kernel.init_params(d, **like),
         "likelihood": lik.init_params(**like)}
    return _E.tree_map(lambda x: x.expand((r,) + tuple(x.shape)).clone(), p)


def _mode_slice(mesh, r: int):
    ax = Axis.of(mesh, "mode")
    if r % ax.size:
        raise ValueError(f"the mode axis ({ax.size} ranks) must divide the "
                         f"mode count r={r}.")
    a, b, _ = row_range(r, ax.size, ax.rank)
    return ax, a, b


def _gather_modes(ax: Axis, tree):
    return _E.tree_map(lambda t: ax.gather_cat(t, dim=0), tree)


def sharded_gpr_train(mesh, P0, Vr, max_iter: int = 1000,
                      rel_error: float = 1e-5, lr: float = 0.1
                      ) -> _E.TrainResult:
    """Mode-parallel GP hyperparameter training with the semantics of the
    unsharded trainer: each rank of the ``mode`` axis runs
    :func:`..gp.exact_gp.adam_early_stop` (per-mode early stop and freeze,
    the closed-form gradient, on the card ``csrc/chol.cu`` at
    (r/n_mode, p, p)) on its modes, and the stop test is all-reduced so
    every rank steps until the slowest mode has stopped, as the JAX
    package's vmapped ``while_loop`` does.  ``P0`` (p, d) and ``Vr``
    (p, r) are replicated; the result (parameters, losses, iteration
    counts of all r modes) is gathered on every rank."""
    dev = _mesh_device(mesh)
    P0 = as_tensor(P0, dev)
    Vr = as_tensor(Vr, dev, dtype=P0.dtype)
    ax, a, b = _mode_slice(mesh, Vr.shape[1])
    mean, kernel, lik = _specs()
    Y = Vr[:, a:b].T.contiguous()
    params0 = init_mode_stacked_params(b - a, P0.shape[1], P0.dtype, dev)
    loss_fn = _E.make_single_task_loss(mean, kernel, lik, P0, Y)
    vag = _E.make_single_task_value_and_grad(mean, kernel, lik, P0, Y)
    res = _E.adam_early_stop(loss_fn, params0, lr=lr, max_iter=max_iter,
                             rel_error=rel_error, value_and_grad=vag,
                             stop_axis=active(ax))
    return _E.TrainResult(_gather_modes(ax, res.params),
                          ax.gather_cat(res.loss),
                          ax.gather_cat(res.iterations))


class AdamState(NamedTuple):
    count: int        # Adam steps taken
    mu: dict          # first moments, the parameters' tree
    nu: dict          # second moments


def sharded_gp_train_step(mesh, params, P0, Vr, opt_state=None,
                          lr: float = 0.1):
    """One Adam step of the stacked per-mode GP training with the modes
    split over the ``mode`` axis: each rank takes the gradient of its
    modes' −MLL and steps them with Adam written out in
    ``optax.adam(b1=0.9, b2=0.999, eps=1e-8)``'s order (as
    :func:`..gp.exact_gp.adam_early_stop`; no optax).  ``params`` and
    ``opt_state`` (an :class:`AdamState`, ``None`` to start) hold all r
    modes, replicated.  Returns ``(params, opt_state, losses (r,))``,
    gathered."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    dev = _mesh_device(mesh)
    P0 = as_tensor(P0, dev)
    Vr = as_tensor(Vr, dev, dtype=P0.dtype)
    ax, a, b = _mode_slice(mesh, Vr.shape[1])
    mean, kernel, lik = _specs()
    Y = Vr[:, a:b].T.contiguous()
    if opt_state is None:
        zeros = _E.tree_map(torch.zeros_like, params)
        opt_state = AdamState(0, zeros, zeros)
    mine = lambda t: t[a:b]                               # noqa: E731
    p_l, mu_l, nu_l = (_E.tree_map(mine, t) for t in
                       (params, opt_state.mu, opt_state.nu))
    # the closed-form gradient of the fixed Matérn-2.5 specs
    losses, grads = _E.make_single_task_value_and_grad(mean, kernel, lik,
                                                       P0, Y)(p_l)
    count = opt_state.count + 1
    c1, c2 = 1.0 - b1 ** count, 1.0 - b2 ** count
    mu_l = _E.tree_map(lambda g, m: (1.0 - b1) * g + b1 * m, grads, mu_l)
    nu_l = _E.tree_map(lambda g, v: (1.0 - b2) * (g * g) + b2 * v, grads,
                       nu_l)
    p_l = _E.tree_map(
        lambda p, m, v: p + (-lr) * ((m / c1) / (torch.sqrt(v / c2) + eps)),
        p_l, mu_l, nu_l)
    return (_gather_modes(ax, p_l),
            AdamState(count, _gather_modes(ax, mu_l), _gather_modes(ax, nu_l)),
            ax.gather_cat(losses.detach()))


def sharded_mode_lstsq(mesh, P0, Vr) -> torch.Tensor:
    """One ridge least-squares fit per POD mode, the modes split over the
    ``mode`` axis with no communication but the final gather: coefficients
    (r, d) of ``(P0ᵀP0 + 1e-6 I) c = P0ᵀ v``, replicated."""
    dev = _mesh_device(mesh)
    P0 = as_tensor(P0, dev)
    Vr = as_tensor(Vr, dev, dtype=P0.dtype)
    ax, a, b = _mode_slice(mesh, Vr.shape[1])
    G = P0.T @ P0 + 1e-6 * torch.eye(P0.shape[1], dtype=P0.dtype, device=dev)
    coefs = torch.linalg.solve(G, P0.T @ Vr[:, a:b]).T     # (r_local, d)
    return ax.gather_cat(coefs)


def sharded_mfk_end_to_end(mesh, X_lf, Y_lf, X_hf, Y_hf, X_test):
    """Two-level recursive co-kriging of K outputs with the outputs split
    over the ``mode`` axis: each rank runs
    :func:`..pipelines.mfk_end_to_end` on its outputs (no cross-output
    communication: the outputs are independent given the shared sites).
    ``mean``, ``mse`` and ``theta`` are gathered on the output axis and
    ``newton_steps`` is the maximum over the ranks (the slowest lane's, as
    in the unsharded call)."""
    from ..pipelines import MFKResult, mfk_end_to_end
    dev = _mesh_device(mesh)
    ax = Axis.of(mesh, "mode")
    Y_lf, Y_hf = (as_tensor(y, dev) for y in (Y_lf, Y_hf))
    K = Y_lf.shape[0]
    a, b, _ = row_range(K, ax.size, ax.rank)
    if b <= a:
        raise ValueError(f"{K} outputs leave a rank of the {ax.size}-rank "
                         "mode axis without one.")
    res = mfk_end_to_end(X_lf, Y_lf[a:b], X_hf, Y_hf[a:b], X_test,
                         device=dev)
    return MFKResult(ax.gather_cat(res.mean), ax.gather_cat(res.mse),
                     ax.gather_cat(res.theta, dim=1),
                     ax.max(res.newton_steps))
