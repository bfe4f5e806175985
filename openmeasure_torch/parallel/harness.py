"""Spawned worlds for the sharded paths: the torch counterpart of the JAX
package's ``dryrun_multichip`` (``__graft_entry__.py``).

:func:`run_world` starts ``n_state · n_mode`` ranks as fresh processes
(the ``spawn`` start method), each with its own process group rank, a
``file://`` rendezvous under a working directory, one intra-op thread and
a process-group timeout; each rank builds the mesh of
:func:`.sharded.make_mesh`, calls ``fn(mesh, *args)`` and sends its result
(tensors as numpy arrays) back to the parent.  A rank that raises or does
not finish within ``timeout_s`` fails the call: the survivors are killed
and the error carries each rank's output.  ``fn`` must be importable from
a module of this package (a spawned rank imports the module its target
lives in), as the rank functions below are.

:func:`local_world` starts a world of one in the calling process, for a
mesh of one rank.

The rank functions hold the sharded paths against the unsharded port on
the same inputs.  :func:`dryrun_rank` (spawned by :func:`dryrun_sharded`)
runs the checks of ``dryrun_multichip`` on fp32 flame data at the size it
is given, on the host or the card.  :func:`state_checks` and
:func:`mode_checks` are the float64 unit checks beside the JAX package's
``tests/test_parallel.py``: ties and a NaN across ranks, the 14 scale
types, padded row counts and each sensor, the Adam step and the per-mode
least squares, on a mesh whose ``state`` axis has several ranks and on a
``(2, 2)`` mesh (which also runs the dryrun at 400 cells).
"""

from __future__ import annotations

import contextlib
import datetime
import os
import queue as _queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


def _to_host(obj):
    """Tensors (also inside dicts, lists, tuples) as numpy arrays."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to_host(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _rank_main(rank, world, init_file, shape, device, backend, timeout_s,
               fn, args, log_path, results):
    fd = os.open(log_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    try:
        torch.set_num_threads(1)
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method="file://" + init_file, rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
        from .sharded import make_mesh
        mesh = make_mesh(shape[0], shape[1], device=device)
        out = _to_host(fn(mesh, *args))
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        results.put((rank, "ok", out))
        dist.destroy_process_group()
    except BaseException:                       # sent to the parent
        results.put((rank, "error", traceback.format_exc()))
        raise


def run_world(fn: Callable, n_state: int = 1, n_mode: int = 1,
              device: str = "cpu", timeout_s: float = 120.0,
              args: Sequence[Any] = (), backend: Optional[str] = None,
              workdir: Optional[str] = None) -> List[Any]:
    """Run ``fn(mesh, *args)`` on a spawned world of ``n_state · n_mode``
    ranks and return each rank's result, in rank order.

    ``device`` is the mesh's device type (``"cpu"``, or ``"cuda"``: rank i
    takes card ``i % device_count``); ``backend`` defaults to gloo on the
    host and NCCL on the card — several ranks on one card need
    ``backend="gloo"`` (NCCL refuses two ranks on one GPU).  Raises
    ``RuntimeError`` when a rank raises or the world does not finish
    within ``timeout_s`` seconds (also the process-group timeout), after
    killing every rank still running."""
    import multiprocessing as mp
    world = int(n_state) * int(n_mode)
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    own_dir = workdir is None
    workdir = tempfile.mkdtemp(prefix="omt_world_") if own_dir else workdir
    init_file = os.path.join(workdir, f"rendezvous_{os.getpid()}_"
                                      f"{time.monotonic_ns()}")
    logs = [os.path.join(workdir, f"rank{i}.log") for i in range(world)]
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(
        target=_rank_main, daemon=True,
        args=(i, world, init_file, (int(n_state), int(n_mode)), device,
              backend, float(timeout_s), fn, tuple(args), logs[i], results))
        for i in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + float(timeout_s)
    got, failure = {}, None
    try:
        while len(got) < world and failure is None:
            left = deadline - time.monotonic()
            if left <= 0:
                failure = (f"timed out after {timeout_s:g} s: ranks "
                           f"{sorted(set(range(world)) - set(got))} did not "
                           "finish")
                break
            try:
                rank, status, payload = results.get(timeout=min(left, 1.0))
            except _queue.Empty:
                dead = [i for i, p in enumerate(procs)
                        if i not in got and p.exitcode not in (None, 0)]
                if dead:
                    failure = f"ranks {dead} exited without a result"
                continue
            if status == "ok":
                got[rank] = payload
            else:
                failure = f"rank {rank} raised:\n{payload}"
        if failure is None:
            for p in procs:
                p.join(timeout=5.0)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
        results.close()
        out = []
        for i, path in enumerate(logs):
            try:
                with open(path) as f:
                    text = f.read()[-4000:]
            except OSError:
                text = ""
            out.append(f"--- rank {i} output ---\n{text}")
        if own_dir:
            shutil.rmtree(workdir, ignore_errors=True)
    if failure is not None:
        raise RuntimeError(f"sharded world ({n_state}, {n_mode}) on "
                           f"{device}: {failure}\n" + "\n".join(out))
    return [got[i] for i in range(world)]


@contextlib.contextmanager
def local_world(device: str = "cpu"):
    """A world of one in this process and its ``(1, 1)`` mesh; the process
    group is destroyed on exit."""
    from .sharded import make_mesh
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    try:
        yield make_mesh(1, 1, device=device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# --------------------------------------------------------------------- #
# Inputs shared by the rank functions and their callers
# --------------------------------------------------------------------- #

def spr_data(seed: int = 5, n_features: int = 3, n_points: int = 64,
             m: int = 12, m_test: int = 2):
    rng = np.random.default_rng(seed)
    n = n_features * n_points
    return (rng.standard_normal((n, m)), rng.standard_normal((n, m_test)))


def scaling_data(seed: int = 11):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((3 * 32, 6)) + 2.0


def cols_data(seed: int = 12):
    rng = np.random.default_rng(seed)
    X_train = rng.random((2 * 64, 10))
    X_test = rng.random((2 * 64, 2)) * 2.0            # outside the limits
    return X_train, X_test, np.array([0.1, 0.1]), np.array([0.9, 0.9])


def placement_data(seed: int = 13):
    """A basis with ties across ranks (its second half repeats the first)
    and a copy with a NaN row, for the sweep; GEM/DG/VDG inputs."""
    rng = np.random.default_rng(seed)
    n, r = 256, 5
    Ur = rng.standard_normal((n, r))
    xyz = np.tile(rng.random((n // 2, 3)), (2, 1))
    Ur_tie = Ur.copy()
    Ur_tie[n // 2:] = Ur_tie[:n // 2]
    Ur_nan = Ur.copy()
    Ur_nan[200, 2] = np.nan
    rng2 = np.random.default_rng(14)
    p, n_pts, rv = 3, 128, 6
    Uv = rng2.standard_normal((p * n_pts, rv))
    xyz_v = rng2.random((n_pts, 3))
    return dict(Ur=Ur, xyz=xyz, Ur_tie=Ur_tie, Ur_nan=Ur_nan, Uv=Uv,
                xyz_v=xyz_v, p=p)


def update_data(seed: int = 21, n: int = 200, r: int = 4, q: int = 3):
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.standard_normal((n, r)))
    S = np.geomspace(10.0, 1.0, r)
    Vt, _ = np.linalg.qr(rng.standard_normal((9, r)))
    Xn = rng.standard_normal((n, q)) + 0.5 * U @ rng.standard_normal((r, q))
    return U, S, Vt.T, Xn


def streaming_data(n_features: int = 3, n_points: int = 40, m: int = 12,
                   rank: int = 6, seed: int = 31):
    rng = np.random.default_rng(seed)
    n = n_features * n_points
    U = rng.standard_normal((n, rank))
    V = rng.standard_normal((m, rank))
    X = (U * np.geomspace(50.0, 0.5, rank)) @ V.T
    return X + 10.0 + np.abs(X).max()


def gp_data(seed: int = 14, p: int = 16, d: int = 3, r: int = 4):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((p, d)), np.sin(rng.standard_normal((p, r)))


def mfk_data(seed: int = 4, K: int = 8, d: int = 2):
    rng = np.random.default_rng(seed)
    X_lf = rng.random((20, d))
    X_hf = X_lf[::3]

    def f(X, k):
        return np.sin(3 * X[:, 0] + k) + 0.4 * np.cos(2 * X[:, 1])
    Y_hf = np.stack([f(X_hf, k) for k in range(K)])
    Y_lf = np.stack([0.7 * f(X_lf, k) - 0.2 for k in range(K)])
    return X_lf, Y_lf, X_hf, Y_hf, rng.random((9, d))


# --------------------------------------------------------------------- #
# Rank functions
# --------------------------------------------------------------------- #

def _axes(mesh):
    from ._comm import Axis
    return Axis.of(mesh, "state")


def _rows(x, ax):
    from ._comm import row_range
    a, b, _ = row_range(x.shape[0], ax.size, ax.rank)
    return x[a:b]


def _spr_checks(mesh, dev):
    from . import sharded as S
    X, Xt = spr_data()
    Xb, Xtb = (S.shard_snapshots(a, 3, mesh) for a in (X, Xt))
    out = {"spr": S.sharded_spr_step(Xb, Xtb, 4, mesh=mesh)}
    Xw, Xtw = (torch.as_tensor(a, device=dev).reshape(3, 64, -1)
               for a in (X, Xt))
    out["spr_plain"] = S.sharded_spr_step(Xw, Xtw, 4)
    return out


def _scaling_checks(mesh):
    from . import sharded as S
    from ._comm import Axis
    from ..core.scaling import SCALE_TYPES
    ax = Axis.of(mesh, "state")
    X = scaling_data()
    Xb = S.shard_snapshots(X, 3, mesh)
    out = {}
    for st in SCALE_TYPES:
        for axis_cnt in (1, None):
            X0, cnt, scl = S._scale_blocks(Xb, st, axis_cnt, mesh)
            out[(st, axis_cnt)] = (ax.gather_cat(X0, dim=1).reshape(96, 6),
                                   ax.gather_cat(cnt, dim=1).reshape(96),
                                   scl.reshape(3))
    return out


def _placement_checks(mesh, dev):
    from . import sharded as S
    from ._comm import Axis, local_gidx
    from ..linalg.qrcp import _sweep
    ax = Axis.of(mesh, "state")
    d = placement_data()
    out = {}
    for key in ("Ur", "Ur_tie", "Ur_nan"):
        U = torch.as_tensor(_rows(d[key], ax), device=dev)
        gidx = local_gidx(ax, U.shape[0], dev)
        piv, nrm = _sweep(U.T, 5, ax if ax.size > 1 else None,
                          gidx if ax.size > 1 else None)
        out["sweep_" + key] = (piv, ax.gather_cat(nrm))
        out["sweep_auto_" + key] = S.qrcp_pivots_sharded(U.T, 5, mesh)
    U = torch.as_tensor(_rows(d["Ur"], ax), device=dev)
    out["gem"] = S.sharded_gem_select(U, _rows(d["xyz"], ax), 6, d_min=0.05,
                                      mesh=mesh)
    out["dg"] = S.sharded_dg_select(U, 8, mesh=mesh)
    out["dg_r"] = S.sharded_dg_select(U, 4, mesh=mesh)
    p, Uv = d["p"], d["Uv"]
    npts = Uv.shape[0] // p
    from ._comm import row_range
    a, b, _ = row_range(npts, ax.size, ax.rank)
    Uv_l = torch.as_tensor(Uv.reshape(p, npts, -1)[:, a:b].reshape(
        p * (b - a), -1), device=dev)
    out["vdg"] = S.sharded_vdg_select(Uv_l, p, 5, xyz=d["xyz_v"][a:b],
                                      d_min=0.1, mesh=mesh)
    return out


def _cols_checks(mesh, dev):
    from . import sharded as S
    X, Xt, lo, hi = cols_data()
    Xb, Xtb = (S.shard_snapshots(a, 2, mesh) for a in (X, Xt))
    res = S.sharded_spr_cols_step(Xb, Xtb, 3, lo, hi, max_iter=8000,
                                  tol=1e-11, mesh=mesh)
    Xw, Xtw = (torch.as_tensor(a, device=dev).reshape(2, 64, -1)
               for a in (X, Xt))
    res0 = S.sharded_spr_cols_step(Xw, Xtw, 3, lo, hi, max_iter=8000,
                                   tol=1e-11)
    ax = _axes(mesh)
    nrm, piv, Ar, (Ur, _, _) = res
    Ur = ax.gather_cat(Ur.reshape(2, -1, Ur.shape[1]), dim=1)
    return {"cols": (nrm, piv, Ar, Ur.reshape(128, -1)),
            "cols_plain": res0[:3] + (res0[3][0],)}


def _update_checks(mesh, dev):
    from . import sharded as S
    ax = _axes(mesh)
    U, Sv, Vt, Xn = update_data()
    t = lambda x: torch.as_tensor(x, device=dev)          # noqa: E731
    U1, S1, V1 = S.sharded_update_basis(t(_rows(U, ax)), t(Sv), t(Vt),
                                        t(_rows(Xn, ax)), mesh=mesh)
    U0, S0, V0 = S.sharded_update_basis(t(U), t(Sv), t(Vt), t(Xn))
    return {"update": (ax.gather_cat(U1), S1, V1), "update_plain":
            (U0, S0, V0)}


def _sensor_models(dev):
    """The unsharded models the sensors package (float64, on ``dev``)."""
    from .. import SPR
    from ..datasets.synthetic import make_flame_dataset
    models = {}
    for n_cells, method in ((40, "OLS"), (41, "COLS")):
        data = make_flame_dataset(n_cells=n_cells)
        spr = SPR(data["X_train"], data["n_features"], data["xyz"],
                  device=dev)
        spr.fit(select_modes="number", n_modes=6)
        C = spr.optimal_placement()
        if method == "COLS":
            npts = data["xyz"].shape[0]
            Xb = data["X_train"].reshape(data["n_features"], npts, -1)
            spr.train(C, method="COLS", limits=[Xb.min(axis=(1, 2)) - 0.1,
                                                Xb.max(axis=(1, 2)) + 0.1])
        else:
            spr.train(C)
        rows = np.argmax(C.cpu().numpy(), axis=1)
        models[method] = (spr, data, rows)
    return models


def _sensor_checks(mesh, dev):
    from .. import (GPR, SPR, CoKriging, ShallowDecoder, CoKrigingSensor,
                    DecoderSensor, DynamicSensor, GPRSensor, SoftSensor)
    from ._comm import gather_rows
    f64 = torch.float64
    out = {}
    models = _sensor_models(dev)
    for method, (spr, data, rows) in models.items():
        sensor = SoftSensor.from_spr(spr, dtype=f64)
        ss = sensor.shard(mesh)
        Y = data["X_test"][rows].T
        Sg = 0.05 * np.abs(Y) + 0.01
        for tag, sig in (("plain", None), ("weighted", Sg)):
            f1, a1, s1 = sensor.predict_batch(Y, sig)
            f2, a2, s2 = ss.predict_batch(Y, sig)
            out[f"soft_{method}_{tag}"] = ((f1, a1, s1),
                                           (gather_rows(f2.T, mesh).T, a2,
                                            s2))
        out[f"soft_{method}_one"] = (sensor(Y[0]),
                                     gather_rows(ss(Y[0]), mesh))
        out[f"soft_{method}_shape"] = (tuple(ss.Ur.shape),
                                       int(ss._state.get("n_c", -1)))
        if method == "OLS":
            dyn = DynamicSensor.from_spr(spr, dtype=f64)
            dsh = dyn.shard(mesh)
            Ys = np.tile(Y, (2, 1))
            for fn in ("filter_batch", "smooth_batch"):
                k1, ka1, _ = getattr(dyn, fn)(Ys, 0.05)
                k2, ka2, _ = getattr(dsh, fn)(Ys, 0.05)
                out[f"dyn_{fn}"] = ((k1, ka1),
                                    (gather_rows(k2.T, mesh).T, ka2))

    # GPR sensor with bc pins: 363 constraint rows, not divisible
    spr, data, rows = models["OLS"]
    gpr = GPR(data["X_train"], data["n_features"], data["xyz"],
              data["P_train"], gpr_type="MultiTask", device=dev)
    gpr.fit(select_modes="number", n_modes=4)
    gpr.train(max_iter=100)
    npts = data["xyz"].shape[0]
    Xb = data["X_train"].reshape(data["n_features"], npts, -1)
    lo, hi = Xb.min(axis=(1, 2)) - 0.5, Xb.max(axis=(1, 2)) + 0.5
    bc_rows = np.array([0, 1, 2])
    gsen = GPRSensor.from_gpr(gpr, limits=[lo, hi],
                              bc=(bc_rows, data["X_train"][bc_rows, 0]))
    gsh = gsen.shard(mesh)
    f1, a1, s1 = gsen(data["P_test"])
    f2, a2, s2 = gsh(data["P_test"])
    out["gpr_bc"] = ((f1, a1, s1), (gather_rows(f2.T, mesh).T, a2, s2))
    out["gpr_bc_shape"] = (tuple(gsh._state["A_c"].shape),
                           int(gsh._state["n_c"]))

    # co-kriging sensor
    rng = np.random.default_rng(3)
    nf, nc_hf, nc_lf = 2, 32, 24
    X_l, X_u = rng.random((6, 2)), rng.random((8, 2))
    xyz_hf, xyz_lf = rng.random((nc_hf, 3)), rng.random((nc_lf, 3))

    def field(xyz, Pm):
        return np.stack([np.sin(3 * xyz[:, 0] * (1 + p[0]))
                         + p[1] * xyz[:, 1] for p in Pm], axis=1)

    Y_hf_l = np.concatenate([field(xyz_hf, X_l), 0.5 * field(xyz_hf, X_l)])
    Y_lf_l = np.concatenate([field(xyz_lf, X_l) + 0.1,
                             0.5 * field(xyz_lf, X_l)])
    Y_lf_u = np.concatenate([field(xyz_lf, X_u) + 0.1,
                             0.5 * field(xyz_lf, X_u)])
    ck = CoKriging(X_l, X_u, Y_lf_l, Y_lf_u, Y_hf_l, xyz_lf, xyz_hf, nf,
                   device=dev)
    ck.manifold_alignment(select_modes="number", n_modes_hf=3, n_modes_lf=3)
    ck.fit()
    csen = CoKrigingSensor.from_cokriging(ck)
    X_test = rng.random((4, 2))
    Yp1, Ym1 = csen(X_test)
    Yp2, Ym2 = csen.shard(mesh)(X_test)
    out["cokriging"] = ((Yp1, Ym1), (gather_rows(Yp2, mesh),
                                     gather_rows(Ym2, mesh)))

    # decoder sensor: n = 90, not divisible by 4
    rng = np.random.default_rng(23)
    X = rng.random((45 * 2, 10))
    spr_d = SPR(X, 2, rng.random((45, 3)), device=dev)
    spr_d.fit(select_modes="number", n_modes=4)
    C = spr_d.optimal_placement()
    dec = ShallowDecoder(X, 2, spr_d.xyz, hidden=(8,), device=dev)
    dec.fit(C, epochs=100)
    dsen = DecoderSensor.from_decoder(dec, dtype=f64)
    Yd = X[np.argmax(C.cpu().numpy(), axis=1), :3].T
    dd = dsen.shard(mesh)
    out["decoder"] = ((dsen.predict_batch(Yd), dsen(Yd[0])),
                      (gather_rows(dd.predict_batch(Yd).T, mesh).T,
                       gather_rows(dd(Yd[0]), mesh)))
    return out


def _streaming_checks(mesh, dev):
    from ..streaming import ArrayStore, StreamingGPR, StreamingROM, \
        StreamingSPR
    from ._comm import gather_rows
    X = streaming_data()
    out = {}
    fits = []
    for m_ in (None, mesh):
        s = StreamingSPR(ArrayStore(X), 3, chunk_rows=17, dtype=np.float64,
                         device=dev)
        s.fit(select_modes="number", n_modes=5, mesh=m_)
        C = s.optimal_placement()
        s.train(C)
        y = np.column_stack([X[C.cpu().numpy().argmax(1), 2],
                             np.zeros(5), np.zeros(5)])
        Ya, _ = s.predict(y)
        rec = s.reconstruct(Ya)
        fits.append((gather_rows(s.Ur, mesh) if m_ is not None else s.Ur,
                     s.Sigma_r, s.Ar, C, s.Theta, Ya,
                     gather_rows(rec, mesh) if m_ is not None else rec,
                     s.fit_mesh_ is m_, s.gram_fused_, s.disk_passes_))
        # COLS on the same fit, limits around the data
        Xb = X.reshape(3, 40, -1)
        s.train(C, method="COLS", limits=[Xb.min(axis=(1, 2)) + 1.0,
                                          Xb.max(axis=(1, 2)) - 1.0])
        fits[-1] += (s.predict(y)[0],)
    out["stream_spr"] = fits
    g = []
    rng = np.random.default_rng(2)
    P = rng.random((12, 2))
    for m_ in (None, mesh):
        s = StreamingGPR(ArrayStore(X), 3, np.zeros((40, 3)), P,
                         chunk_rows=17, dtype=np.float64, device=dev)
        s.fit(select_modes="number", n_modes=4, mesh=m_)
        s.train(max_iter=30)
        Vp, _ = s.predict(P[:3])
        rec = s.reconstruct(Vp)
        g.append((gather_rows(s.Ur, mesh) if m_ is not None else s.Ur,
                  s.Sigma_r, s.Ar, Vp,
                  gather_rows(rec, mesh) if m_ is not None else rec))
    out["stream_gpr"] = g
    errs = []
    srom = StreamingROM(ArrayStore(X[:111]), 3, dtype=np.float64,
                        device=dev)
    for kw in (dict(), dict(engine="device"),
               dict(basis=(np.zeros((111, 2)), np.zeros((12, 2))))):
        try:
            srom.fit(mesh=mesh, **kw)
            errs.append(None)
        except ValueError as e:
            errs.append(str(e))
    out["errors"] = errs
    srom = StreamingROM(ArrayStore(X), 3, dtype=np.float64, device=dev)
    srom.fit(mesh=mesh)
    flags = [srom.fit_mesh_ is mesh]
    srom.fit()
    flags.append(srom.fit_mesh_ is None)
    out["fit_mesh_"] = flags
    return out


def state_checks(mesh):
    """The state-axis checks (float64, host-sized inputs): each entry of
    the result holds the sharded output and, where the rank computes it,
    the unsharded port's on the same inputs."""
    torch.set_default_dtype(torch.float64)
    from .sharded import _mesh_device
    dev = _mesh_device(mesh)
    out = _spr_checks(mesh, dev)
    out["scaling"] = _scaling_checks(mesh)
    for part in (_placement_checks, _cols_checks, _update_checks,
                 _sensor_checks, _streaming_checks):
        out.update(part(mesh, dev))
    return out


def mode_checks(mesh):
    """The mode-axis checks on a ``(2, 2)`` mesh, each beside the unsharded
    port on the same inputs: the GP trainer, five Adam steps, the per-mode
    least squares, co-kriging, and the SPR step over the state axis."""
    from . import sharded as S
    from ..gp import exact_gp as E
    from ..pipelines import mfk_end_to_end
    dev = S._mesh_device(mesh)
    P0, Vr = gp_data()
    out = {}
    res = S.sharded_gpr_train(mesh, P0, Vr, max_iter=120, rel_error=1e-5)
    mean, kern, lik = S._specs()
    P0t, Yt = (torch.as_tensor(a, device=dev) for a in (P0, Vr.T))
    res0 = E.adam_early_stop(
        E.make_single_task_loss(mean, kern, lik, P0t, Yt),
        S.init_mode_stacked_params(4, 3, torch.float64, dev), lr=0.1,
        max_iter=120, rel_error=1e-5,
        value_and_grad=E.make_single_task_value_and_grad(mean, kern, lik,
                                                         P0t, Yt))
    out["gpr"] = ((res.loss, res.iterations), (res0.loss, res0.iterations))
    params = S.init_mode_stacked_params(4, 3, torch.float64, dev)
    state, hist = None, []
    for _ in range(5):
        params, state, losses = S.sharded_gp_train_step(mesh, params, P0, Vr,
                                                        state)
        hist.append(losses)
    out["step"] = (torch.stack(hist), params)
    out["lstsq"] = S.sharded_mode_lstsq(mesh, P0, Vr)
    X_lf, Y_lf, X_hf, Y_hf, X_t = mfk_data()
    r1 = S.sharded_mfk_end_to_end(mesh, X_lf, Y_lf, X_hf, Y_hf, X_t)
    r0 = mfk_end_to_end(X_lf, Y_lf, X_hf, Y_hf, X_t, device=dev)
    out["mfk"] = (tuple(r1), tuple(r0))
    out.update(_spr_checks(mesh, dev))
    out["dryrun"] = dryrun_rank(mesh, n_cells=400)
    return out


def failing_rank(mesh, how: str):
    """Rank 1 of the world raises (``how="raise"``) or hangs
    (``how="hang"``); the others return."""
    if dist.get_rank() == 1:
        if how == "raise":
            raise ValueError("rank 1 fails on purpose")
        time.sleep(3600)
    return dist.get_rank()


# --------------------------------------------------------------------- #
# The counterpart of dryrun_multichip
# --------------------------------------------------------------------- #

def dryrun_data(n_cells: int = 12000, n_features: int = 9, m: int = 41):
    """The dryrun's flame snapshots, fp32: ``(X_train (n, m), X_test (n,
    2), xyz (n_cells, 3), P_train (m, 3))`` with n = n_features·n_cells."""
    from ..datasets.synthetic import make_flame_dataset
    data = make_flame_dataset(n_cells=n_cells, n_features=n_features,
                              m_train=m, m_test=2, seed=0)
    return tuple(np.asarray(data[k], np.float32)
                 for k in ("X_train", "X_test", "xyz", "P_train"))


def dryrun_rank(mesh, n_cells: int = 12000, r: int = 8, gp_iters: int = 60,
                store: Optional[str] = None):
    """The checks of the JAX package's ``dryrun_multichip`` on this rank,
    at ``n_cells`` flame cells × 9 features × 41 snapshots (fp32,
    :func:`dryrun_data`), each sharded call beside the same call with no
    mesh on the same inputs: the SPR and COLS steps; the QR sweep, GEM,
    DG and VDG on the unsharded basis split over the ranks; the GP
    trainer (``gp_iters`` Adam iterations at most) over the mode axis, or
    over every rank when the mesh has no mode axis; co-kriging over the
    mode axis; the OLS
    and COLS ``SoftSensor`` and the ``DynamicSensor`` at batch 50; the
    streamed fit, from ``store`` (a ``.npy`` of :func:`dryrun_data`'s
    ``X_train``) or from memory.  ``out["cost"]`` holds each sharded
    call's collectives and wall (ms, host clock between device syncs).
    The parent's :func:`check_dryrun` holds the results."""
    from .. import DynamicSensor, SoftSensor
    from ..dynamics.kalman import (estimate_process_noise,
                                   fit_reduced_operator,
                                   stationary_covariance)
    from ..gp import exact_gp as E
    from ..linalg.qrcp import qrcp_pivots
    from ..pipelines import mfk_end_to_end
    from ..streaming import ArrayStore, StreamingROM
    from . import sharded as S
    from ._comm import Axis, gather_rows, row_range
    dev = S._mesh_device(mesh)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    ax = Axis.of(mesh, "state")
    world = dist.get_world_size()
    gmesh = mesh
    if Axis.of(mesh, "mode").size == 1 and world > 1:
        gmesh = S.make_mesh(1, world, device=dev.type)
    nf = 9
    X, Xt, xyz, P_train = dryrun_data(n_cells, nf)
    n, m = X.shape
    out = {"n": n, "cost": {}}

    def sharded(key, fn):
        sync()
        c0, t0 = Axis.collectives, time.perf_counter()
        res = fn()
        sync()
        out["cost"][key] = (Axis.collectives - c0,
                            (time.perf_counter() - t0) * 1e3)
        return res

    Xb, Xtb = (S.shard_snapshots(A, nf, mesh) for A in (X, Xt))
    Xw, Xtw = (torch.as_tensor(A, device=dev).reshape(nf, n_cells, -1)
               for A in (X, Xt))
    out["spr"] = (sharded("spr", lambda: S.sharded_spr_step(Xb, Xtb, r,
                                                            mesh=mesh)),
                  S.sharded_spr_step(Xw, Xtw, r))
    lo, hi = np.full(nf, -1e4, np.float32), np.full(nf, 1e4, np.float32)
    c1 = sharded("cols", lambda: S.sharded_spr_cols_step(
        Xb, Xtb, r, lo, hi, max_iter=200, mesh=mesh))
    c0 = S.sharded_spr_cols_step(Xw, Xtw, r, lo, hi, max_iter=200)
    out["cols"] = (c1[:3], c0[:3])

    # placements and the GP on the unsharded basis, split over the ranks
    fit = S._fit_and_place(Xw, r, "std", None, None)
    Ur = fit.Ur.contiguous()
    a, b, _ = row_range(n, ax.size, ax.rank)
    U_l = Ur[a:b]
    out["qr"] = (sharded("qr", lambda: S.qrcp_pivots_sharded(U_l.T, r,
                                                             mesh)),
                 fit.pivots, qrcp_pivots(Ur.T, r))
    xyz_t = np.tile(xyz, (nf, 1))
    out["gem"] = (sharded("gem", lambda: S.sharded_gem_select(
        U_l, xyz_t[a:b], 6, mesh=mesh)), S.sharded_gem_select(Ur, xyz_t, 6))
    out["dg"] = (sharded("dg", lambda: S.sharded_dg_select(U_l, r + 4,
                                                           mesh=mesh)),
                 S.sharded_dg_select(Ur, r + 4))
    pa, pb, _ = row_range(n_cells, ax.size, ax.rank)
    Uv = Ur.reshape(nf, n_cells, r)[:, pa:pb].reshape(-1, r)
    out["vdg"] = (sharded("vdg", lambda: S.sharded_vdg_select(Uv, nf, 5,
                                                              mesh=mesh)),
                  S.sharded_vdg_select(Ur, nf, 5))
    P0 = torch.as_tensor(P_train, device=dev)
    P0 = (P0 - P0.mean(0)) / (P0.std(0, correction=0) + 1e-8)
    X0 = S._scale_blocks(Xw)[0].reshape(n, m)
    Ar = X0.T @ Ur
    Vr = Ar / (torch.linalg.vector_norm(Ar, dim=0)[None, :] + 1e-30)
    g1 = sharded("gpr", lambda: S.sharded_gpr_train(gmesh, P0, Vr,
                                                    max_iter=gp_iters))
    mean, kern, lik = S._specs()
    Y = Vr.T.contiguous()
    g0 = E.adam_early_stop(
        E.make_single_task_loss(mean, kern, lik, P0, Y),
        S.init_mode_stacked_params(r, 3, torch.float32, dev), lr=0.1,
        max_iter=gp_iters, rel_error=1e-5,
        value_and_grad=E.make_single_task_value_and_grad(mean, kern, lik,
                                                         P0, Y))
    out["gpr"] = ((g1.loss, g1.iterations), (g0.loss, g0.iterations))

    # serving on the same basis: OLS, COLS (limits ± 5 % of each feature's
    # span) and the Kalman filter, batch 50
    piv = fit.pivots.long()
    cnt, scl = fit.cnt[:, 0], fit.scl[:, 0]
    Yq = torch.as_tensor(Xt, device=dev)[piv].T.repeat(25, 1)
    f_lo, f_hi = Xw.amin(dim=(1, 2)), Xw.amax(dim=(1, 2))
    feat = torch.arange(n, device=dev) // n_cells
    pad = 0.05 * (f_hi - f_lo)
    box = dict(method="COLS", constraint_A=Ur,
               constraint_lo=((f_lo - pad)[feat] - cnt) / scl,
               constraint_hi=((f_hi + pad)[feat] - cnt) / scl)
    for key, kw in (("soft", {}), ("soft_cols", box)):
        sensor = SoftSensor(Ur, Ur[piv], cnt[piv], scl[piv], cnt, scl,
                            device=dev, **kw)
        f1, a1, _ = sensor.predict_batch(Yq)
        sh = sensor.shard(mesh)
        f2, a2, _ = sharded(key, lambda: sh.predict_batch(Yq))
        out[key] = ((f1, a1), (gather_rows(f2.T, mesh).T, a2))
    Ar_t = Ar.double().cpu().numpy()
    A_dyn = fit_reduced_operator(Ar_t, ridge=1e-6)
    Q_dyn = estimate_process_noise(A_dyn, Ar_t)
    ks = DynamicSensor(Ur, Ur[piv], cnt[piv], scl[piv], cnt, scl, A_dyn,
                       Q_dyn, Ar_t[-1], stationary_covariance(A_dyn, Q_dyn),
                       device=dev)
    k1, ka1, _ = ks.filter_batch(Yq, 0.05)
    ksh = ks.shard(mesh)
    k2, ka2, _ = sharded("kf", lambda: ksh.filter_batch(Yq, 0.05))
    out["kf"] = ((k1, ka1), (gather_rows(k2.T, mesh).T, ka2))

    # co-kriging over the mode axis
    rng = np.random.default_rng(5)
    X_lf = rng.random((16, 2)).astype(np.float32)
    X_hf = X_lf[::3]

    def fm(Z, k):
        return np.sin(3 * Z[:, 0] + k) + 0.4 * Z[:, 1]
    Y_hf = np.stack([fm(X_hf, k) for k in range(8)]).astype(np.float32)
    Y_lf = np.stack([0.7 * fm(X_lf, k) - 0.2
                     for k in range(8)]).astype(np.float32)
    X_t = rng.random((7, 2)).astype(np.float32)
    out["mfk"] = (sharded("mfk", lambda: S.sharded_mfk_end_to_end(
        mesh, X_lf, Y_lf, X_hf, Y_hf, X_t)).mean,
                  mfk_end_to_end(X_lf, Y_lf, X_hf, Y_hf, X_t,
                                 device=dev).mean)

    # the streamed fit on the mesh against the unsharded one
    src = ArrayStore(X) if store is None else store
    fits = []
    for m_ in (None, mesh):
        s = StreamingROM(src, nf, chunk_rows=n // 7 + 3, device=dev)
        if m_ is None:
            s.fit(select_modes="number", n_modes=r)
        else:
            sharded("stream", lambda: s.fit(select_modes="number",
                                            n_modes=r, mesh=m_))
        fits.append((gather_rows(s.Ur, mesh) if m_ is not None else s.Ur,
                     s.Sigma_r, s.Ar, s.gram_fused_))
    out["stream"] = tuple(fits)
    return out


def check_dryrun(out: dict) -> dict:
    """The bars of ``dryrun_multichip`` on one rank's :func:`dryrun_rank`
    result, and the serving bar (2e-3 of max|a|) for the COLS sensor;
    raises ``AssertionError`` naming every miss, else returns the deltas.
    End-to-end pivots are reported, not held: a sharded Gram sums in
    another order, and the synthetic flame placement is degenerate under
    round-off (ROADMAP §C); the QR sweep and the selections are held
    equal on the same basis."""
    def rel(a, b):
        return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-30))

    (n1, p1), (n0, _) = out["spr"]
    c1, c0 = out["cols"]
    (l1, i1), (l0, i0) = out["gpr"]
    (f1, a1), (f2, a2) = out["soft"]
    (_, ac1), (_, ac2) = out["soft_cols"]
    (k1, ka1), (k2, ka2) = out["kf"]
    m1, m0 = out["mfk"]
    (u0, s0, A0, fused0), (u1, s1, A1, fused1) = out["stream"]
    d = dict(n=out["n"], nrmse=float(n1),
             d_nrmse=abs(float(n1) - float(n0)),
             d_cols=abs(float(c1[0]) - float(c0[0])),
             d_gpr_loss=float(np.max(np.abs(l1 - l0))),
             d_gpr_rel=float(np.max(np.abs(l1 - l0) / np.abs(l0))),
             gpr_iters=(int(np.min(i1)), int(np.max(i1))),
             d_serving_rel=rel(f2, f1), d_cols_serving_rel=rel(ac2, ac1),
             d_kf_rel=rel(k2, k1), d_mfk_mean=float(np.max(np.abs(m1 - m0))),
             d_stream=float(np.max(np.abs(u1 - u0))),
             pivots=np.asarray(p1).tolist(), cost=out["cost"])
    held = {
        "spr": np.isfinite(float(n1)) and len(set(d["pivots"])) == len(p1)
        and d["d_nrmse"] <= 1e-6,
        "cols": bool(np.all(np.isfinite(c1[2]))) and d["d_cols"] <= 1e-6,
        "qr": all(np.array_equal(out["qr"][0], q) for q in out["qr"][1:]),
        "gpr": np.array_equal(i1, i0)
        and d["d_gpr_loss"] <= 1e-5 * max(1.0, float(np.max(np.abs(l0)))),
        "soft": float(np.max(np.abs(a2 - a1))) == 0.0
        and d["d_serving_rel"] <= 1e-6,
        "soft_cols": d["d_cols_serving_rel"] <= 2e-3,
        "kf": float(np.max(np.abs(ka2 - ka1))) == 0.0
        and d["d_kf_rel"] <= 1e-6,
        "mfk": d["d_mfk_mean"] <= 1e-3 * (float(np.max(np.abs(m0)))
                                          + 1e-30),
        "stream": d["d_stream"] == 0.0 and np.array_equal(s1, s0)
        and np.array_equal(A1, A0) and fused1 == fused0}
    for k in ("gem", "dg", "vdg"):
        held[k] = np.array_equal(out[k][0], out[k][1])
    missed = [k for k, ok in held.items() if not ok]
    assert not missed, (missed, {k: v for k, v in d.items()
                                 if k not in ("pivots", "cost")})
    return d


def dryrun_sharded(n_state: int = 4, n_mode: int = 2, device: str = "cpu",
                   n_cells: int = 12000, r: int = 8, gp_iters: int = 60,
                   store: Optional[str] = None, timeout_s: float = 900.0,
                   backend: Optional[str] = None,
                   workdir: Optional[str] = None) -> List[dict]:
    """The torch counterpart of ``dryrun_multichip``: spawn a world of
    ``n_state · n_mode`` ranks, run :func:`dryrun_rank` on each, hold every
    rank's result to the dryrun's bars and return each rank's deltas."""
    res = run_world(dryrun_rank, n_state, n_mode, device, timeout_s,
                    args=(n_cells, r, gp_iters, store), backend=backend,
                    workdir=workdir)
    return [check_dryrun(r_) for r_ in res]
