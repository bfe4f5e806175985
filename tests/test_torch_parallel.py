"""The port's sharding over ``torch.distributed`` against the unsharded port
and against the JAX package's ``parallel/sharded.py`` (float64).

Two spawned gloo worlds run the sharded paths (``parallel/harness.py``):
a (4, 1) mesh for the state axis (the SPR steps, the 14 scale types, the
QRCP sweep, GEM, DG and VDG, the COLS step, the incremental update, the
five sensors' ``shard`` and the sharded streaming fits) and a (2, 2) mesh
for the mode axis (the GP trainer and Adam step, the per-mode least
squares, co-kriging).  Each world is spawned once per module and each
check is its own test.  The JAX side runs on the conftest's 8-device CPU
mesh, ``make_mesh(4, 2)``, at the sizes of ``tests/test_parallel.py``.

Every world runs under a timeout: a rank that raises or hangs fails its
test, not the suite.  The file takes about 60 s alone on an 8-core host
(each world ~14 s, the hung world its 8 s timeout, JAX compiling the
rest).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from openmeasure_torch.core import scaling as TS
from openmeasure_torch.linalg.qrcp import _sweep
from openmeasure_torch.parallel import harness as H
from openmeasure_torch.sensing.dg import dg_select as t_dg
from openmeasure_torch.sensing.gem import gem_select as t_gem
from openmeasure_torch.sensing.vector import vector_dg_select as t_vdg
from openmeasure_tpu.parallel import sharded as JS

TIMEOUT = 300.0


@pytest.fixture(scope="module")
def jmesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs the conftest's 8 virtual devices")
    return JS.make_mesh(4, 2)


@pytest.fixture(scope="module")
def state_world(tmp_path_factory):
    return H.run_world(H.state_checks, 4, 1, "cpu", TIMEOUT,
                       workdir=str(tmp_path_factory.mktemp("state")))


@pytest.fixture(scope="module")
def mode_world(tmp_path_factory):
    return H.run_world(H.mode_checks, 2, 2, "cpu", TIMEOUT,
                       workdir=str(tmp_path_factory.mktemp("mode")))


def _rel(a, b, scale=None):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    s = np.abs(b).max() if scale is None else scale
    return float(np.abs(a - b).max() / max(s, 1e-300))


def _same_on_every_rank(world, key, idx=None):
    vals = [w[key] if idx is None else w[key][idx] for w in world]
    for v in vals[1:]:
        if isinstance(v, tuple):
            for a, b in zip(v, vals[0]):
                np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(v, vals[0])


# --------------------------------------------------------------------- #
# SPR steps and scaling
# --------------------------------------------------------------------- #

def _jax_spr(jmesh, X, Xt, n_features, r):
    with jmesh:
        Xb = JS.shard_snapshots(jnp.asarray(X), n_features, jmesh)
        Xtb = JS.shard_snapshots(jnp.asarray(Xt), n_features, jmesh)
        nrmse, piv = JS.sharded_spr_step(Xb, Xtb, r)
    return float(nrmse), np.asarray(piv)


@pytest.mark.parametrize("world", ["state_world", "mode_world"])
def test_sharded_spr_step_matches_unsharded_and_jax(world, request, jmesh):
    w = request.getfixturevalue(world)
    nrmse, piv = w[0]["spr"]
    nrmse0, piv0 = w[0]["spr_plain"]
    _same_on_every_rank(w, "spr", 1)
    np.testing.assert_array_equal(np.sort(piv), np.sort(piv0))
    np.testing.assert_allclose(nrmse, nrmse0, rtol=1e-8)
    X, Xt = H.spr_data()
    nj, pj = _jax_spr(jmesh, X, Xt, 3, 4)
    np.testing.assert_array_equal(np.sort(piv), np.sort(pj))
    np.testing.assert_allclose(nrmse, nj, rtol=1e-8)


@pytest.mark.parametrize("axis_cnt", [1, None])
@pytest.mark.parametrize("stype", TS.SCALE_TYPES)
def test_sharded_scaling_all_types(state_world, jmesh, stype, axis_cnt):
    X0, cnt, scl = state_world[0]["scaling"][(stype, axis_cnt)]
    X = H.scaling_data()
    X0t, cntt, sclt = TS.scale_data(torch.as_tensor(X), 3, stype, axis_cnt)
    np.testing.assert_allclose(X0, X0t.numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(cnt, cntt.numpy()[:, 0], rtol=1e-12)
    np.testing.assert_allclose(scl, sclt.numpy()[::32, 0], rtol=1e-12)
    if axis_cnt == 1:
        with jmesh:
            Xb = JS.shard_snapshots(jnp.asarray(X), 3, jmesh)
            X0j, _, sclj = JS._scale_blocks(Xb, stype)
        np.testing.assert_allclose(X0, np.asarray(X0j).reshape(96, 6),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(scl, np.asarray(sclj).reshape(3),
                                   rtol=1e-12)


# --------------------------------------------------------------------- #
# Placements on identical inputs
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("key", ["Ur", "Ur_tie", "Ur_nan"])
def test_sharded_sweep_is_bit_equal(state_world, key):
    """The sharded QR sweep on the same basis split over 4 ranks: pivots
    and the gathered final norms equal the unsharded plain sweep's bit for
    bit — with ties across ranks (lowest index) and a NaN row (first)."""
    piv, nrm = state_world[0]["sweep_" + key]
    _same_on_every_rank(state_world, "sweep_" + key, 0)
    p0, n0 = _sweep(torch.as_tensor(H.placement_data()[key]).T, 5)
    np.testing.assert_array_equal(piv, p0.numpy())
    np.testing.assert_array_equal(nrm, n0.numpy())
    np.testing.assert_array_equal(state_world[0]["sweep_auto_" + key],
                                  p0.numpy())


def test_sharded_gem_dg_vdg_equal_unsharded_and_jax(state_world):
    from openmeasure_tpu.sensing.dg import dg_select as j_dg
    from openmeasure_tpu.sensing.gem import gem_select as j_gem
    from openmeasure_tpu.sensing.vector import vector_dg_select as j_vdg
    d = H.placement_data()
    w = state_world[0]
    for k in ("gem", "dg", "dg_r", "vdg"):
        _same_on_every_rank(state_world, k)
    U = torch.as_tensor(d["Ur"])
    np.testing.assert_array_equal(w["gem"],
                                  t_gem(U, d["xyz"], 6, d_min=0.05))
    np.testing.assert_array_equal(w["dg"], t_dg(U, 8))
    np.testing.assert_array_equal(w["dg_r"], t_dg(U, 4))
    np.testing.assert_array_equal(
        w["vdg"], t_vdg(torch.as_tensor(d["Uv"]), 3, 5, xyz=d["xyz_v"],
                        d_min=0.1))
    np.testing.assert_array_equal(
        w["gem"], np.asarray(j_gem(d["Ur"], d["xyz"], 6, d_min=0.05)))
    np.testing.assert_array_equal(w["dg"], np.asarray(j_dg(d["Ur"], 8)))
    np.testing.assert_array_equal(
        w["vdg"], np.asarray(j_vdg(d["Uv"], 3, 5, xyz=d["xyz_v"],
                                   d_min=0.1)))


# --------------------------------------------------------------------- #
# COLS, the update
# --------------------------------------------------------------------- #

def test_sharded_cols_step(state_world, jmesh):
    nrm, piv, Ar, Ur = state_world[0]["cols"]
    nrm0, piv0, Ar0, Ur0 = state_world[0]["cols_plain"]
    _same_on_every_rank(state_world, "cols", 2)
    np.testing.assert_array_equal(piv, piv0)
    assert _rel(Ar, Ar0) <= 1e-9
    np.testing.assert_allclose(nrm, nrm0, rtol=1e-9)
    X, Xt, lo, hi = H.cols_data()
    with jmesh:
        Xb, Xtb = (JS.shard_snapshots(jnp.asarray(a), 2, jmesh)
                   for a in (X, Xt))
        nj, pj, Aj, (Uj, _, _) = JS.sharded_spr_cols_step(
            Xb, Xtb, 3, jnp.asarray(lo), jnp.asarray(hi), max_iter=8000,
            tol=1e-11)
    np.testing.assert_array_equal(np.sort(piv), np.sort(np.asarray(pj)))
    # the eigensolvers may pick opposite mode signs: compare Ur Arᵀ
    rec, recj = Ur @ Ar.T, np.asarray(Uj) @ np.asarray(Aj).T
    assert _rel(rec, recj) <= 1e-9
    np.testing.assert_allclose(nrm, float(nj), rtol=1e-9)


def test_sharded_update_basis(state_world):
    from openmeasure_tpu.linalg.incremental import \
        svd_append_columns_cholqr as j_cholqr
    U1, S1, V1 = state_world[0]["update"]
    U0, S0, V0 = state_world[0]["update_plain"]
    assert _rel(U1, U0) <= 1e-10 and _rel(S1, S0) <= 1e-10
    assert _rel(V1, V0) <= 1e-10
    U, S, Vt, Xn = H.update_data()
    Uj, Sj, Vj = (np.asarray(a) for a in j_cholqr(*(jnp.asarray(a) for a in
                                                    (U, S, Vt, Xn))))
    assert _rel(S1, Sj) <= 1e-10
    assert _rel(U1 @ np.diag(S1) @ V1, Uj @ np.diag(Sj) @ Vj) <= 1e-10


# --------------------------------------------------------------------- #
# The mode axis
# --------------------------------------------------------------------- #

def test_sharded_gpr_train(mode_world, jmesh):
    (loss, iters), (loss0, iters0) = mode_world[0]["gpr"]
    _same_on_every_rank(mode_world, "gpr", 0)
    np.testing.assert_allclose(loss, loss0, rtol=1e-9)
    np.testing.assert_array_equal(iters, iters0)
    assert np.any(iters < 120)                   # a mode stopped early
    P0, Vr = H.gp_data()
    with jmesh:
        res = JS.sharded_gpr_train(jmesh, jnp.asarray(P0), jnp.asarray(Vr),
                                   max_iter=120, rel_error=1e-5)
    np.testing.assert_allclose(loss, np.asarray(res.loss), rtol=1e-9)
    np.testing.assert_array_equal(iters, np.asarray(res.iterations))


def test_sharded_gp_train_step(mode_world, jmesh):
    hist, params = mode_world[0]["step"]
    assert np.all(hist[-1] < hist[0])
    P0, Vr = H.gp_data()
    with jmesh:
        p = JS.init_mode_stacked_params(4, 3)
        state, jh = None, []
        for _ in range(5):
            p, state, losses = JS.sharded_gp_train_step(
                jmesh, p, jnp.asarray(P0), jnp.asarray(Vr), state)
            jh.append(np.asarray(losses))
    np.testing.assert_allclose(hist, np.stack(jh), rtol=1e-9)
    np.testing.assert_allclose(params["kernel"]["raw_lengthscale"],
                               np.asarray(p["kernel"]["raw_lengthscale"]),
                               rtol=1e-9, atol=1e-12)


def test_sharded_mode_lstsq(mode_world, jmesh):
    coefs = mode_world[0]["lstsq"]
    P0, Vr = H.gp_data()
    G = P0.T @ P0 + 1e-6 * np.eye(3)
    np.testing.assert_allclose(coefs, np.linalg.solve(G, P0.T @ Vr).T,
                               rtol=1e-9)
    with jmesh:
        cj = JS.sharded_mode_lstsq(jmesh, jnp.asarray(P0), jnp.asarray(Vr))
    np.testing.assert_allclose(coefs, np.asarray(cj), rtol=1e-9)


def test_sharded_mfk_end_to_end(mode_world, jmesh):
    r1, r0 = mode_world[0]["mfk"]
    _same_on_every_rank(mode_world, "mfk", 0)
    # the posterior MSE at these points is ~1e-8 of the output scale²: it
    # is held in that unit, where its rounding lives
    var_unit = float(np.abs(r0[0]).max()) ** 2
    assert _rel(r1[0], r0[0]) <= 1e-9
    assert _rel(r1[1], r0[1], var_unit) <= 1e-9
    np.testing.assert_array_equal(r1[3], r0[3])
    rj = JS.sharded_mfk_end_to_end(jmesh, *H.mfk_data())
    # JAX's θ search and the port's agree to the bars of test_torch_mfk.py
    assert _rel(r1[0], np.asarray(rj.mean)) <= 1e-7
    assert _rel(r1[1], np.asarray(rj.mse), var_unit) <= 5e-4


# --------------------------------------------------------------------- #
# Serving
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("case", ["OLS_plain", "OLS_weighted", "COLS_plain",
                                  "COLS_weighted"])
def test_sharded_softsensor(state_world, case):
    """OLS (n = 360) and COLS on n = 369, which 4 ranks do not divide:
    the padded state serves what the unsharded sensor serves (OLS to
    1e-10, the fixed-budget float64 COLS to 1e-9)."""
    (f1, a1, s1), (f2, a2, s2) = state_world[0]["soft_" + case]
    bar = 1e-10 if case.startswith("OLS") else 1e-9
    assert f2.shape == f1.shape
    assert _rel(a2, a1) <= bar and _rel(f2, f1) <= bar
    assert _rel(s2, s1, max(np.abs(s1).max(), 1.0)) <= bar
    method = case.split("_")[0]
    x1, x2 = state_world[0][f"soft_{method}_one"]
    assert x2.shape == x1.shape and _rel(x2, x1) <= bar
    shape, n_c = state_world[0][f"soft_{method}_shape"]
    if method == "COLS":
        assert shape == (93, 6) and n_c == 369       # 369 padded to 4·93


@pytest.mark.parametrize("fn", ["filter_batch", "smooth_batch"])
def test_sharded_dynamic_sensor(state_world, fn):
    (k1, ka1), (k2, ka2) = state_world[0]["dyn_" + fn]
    np.testing.assert_array_equal(ka2, ka1)           # replicated filter
    assert _rel(k2, k1) <= 1e-10


def test_sharded_gpr_sensor_pads_bc_rows(state_world):
    """bc pins make 363 constraint rows: padded to 4·91, the MAP keeps
    the active count, and the fixed-budget solve matches to 1e-9."""
    (f1, a1, s1), (f2, a2, s2) = state_world[0]["gpr_bc"]
    assert state_world[0]["gpr_bc_shape"] == ((91, 4), 363)
    assert _rel(a2, a1) <= 1e-9 and _rel(f2, f1) <= 1e-9
    assert _rel(s2, s1) <= 1e-10


def test_sharded_cokriging_sensor(state_world):
    (p1, m1), (p2, m2) = state_world[0]["cokriging"]
    assert _rel(p2, p1) <= 1e-10 and _rel(m2, m1) <= 1e-10


def test_sharded_decoder_sensor(state_world):
    """n = 90 over 4 ranks: padded output columns slice away."""
    (b1, o1), (b2, o2) = state_world[0]["decoder"]
    assert b2.shape == b1.shape == (3, 90)
    assert _rel(b2, b1) <= 1e-10 and _rel(o2, o1) <= 1e-10


# --------------------------------------------------------------------- #
# The sharded streaming fit
# --------------------------------------------------------------------- #

def test_sharded_streaming_spr_equals_unsharded(state_world):
    plain, sh = state_world[0]["stream_spr"]
    for a, b in zip(plain[:6], sh[:6]):           # Ur, Sigma_r, Ar, C, Θ, a
        np.testing.assert_array_equal(b, a)
    assert _rel(sh[6], plain[6]) <= 1e-12         # the reconstruction
    assert sh[7] and plain[7]                     # fit_mesh_
    assert sh[8] == plain[8] and sh[9] == plain[9]  # fused Gram, passes
    # COLS with tol > 0: an all-reduced residual norm may move a stop test
    # by one check interval; the bar of the JAX package's own padded-COLS
    # test (tests/test_parallel.py, atol 1e-4·scale)
    assert _rel(sh[10], plain[10]) <= 1e-4


def test_sharded_streaming_gpr_equals_unsharded(state_world):
    plain, sh = state_world[0]["stream_gpr"]
    for a, b in zip(plain[:4], sh[:4]):           # Ur, Sigma_r, Ar, Vpred
        np.testing.assert_array_equal(b, a)
    assert _rel(sh[4], plain[4]) <= 1e-12


def test_sharded_streaming_validation(state_world):
    errs = state_world[0]["errors"]
    assert "divisible" in errs[0]
    assert "engine='host'" in errs[1]
    assert "basis=" in errs[2]
    assert state_world[0]["fit_mesh_"] == [True, True]


# --------------------------------------------------------------------- #
# The harness
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("how, timeout", [("raise", 60.0), ("hang", 8.0)])
def test_a_failing_rank_fails_the_world(tmp_path, how, timeout):
    import time
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 raised|timed out") as e:
        H.run_world(H.failing_rank, 2, 1, "cpu", timeout, args=(how,),
                    workdir=str(tmp_path))
    assert time.monotonic() - t0 < timeout + 15.0
    if how == "raise":
        assert "fails on purpose" in str(e.value)
    else:
        assert "timed out" in str(e.value)


def test_make_mesh_rejects_a_larger_mesh_without_a_world():
    from openmeasure_torch.parallel import make_mesh
    with pytest.raises(RuntimeError, match="started world"):
        make_mesh(2, 1, device="cpu")


def test_dryrun_checks_on_the_mode_world(mode_world):
    """``harness.dryrun_rank`` (the checks of the JAX package's
    ``dryrun_multichip``) at 400 flame cells on the (2, 2) world, held to
    that dryrun's bars by ``harness.check_dryrun`` on every rank."""
    for w in mode_world:
        got = H.check_dryrun(w["dryrun"])
    assert got["n"] == 3600 and got["d_stream"] == 0.0
