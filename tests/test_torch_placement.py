"""Port parity for the other placements (``openmeasure_torch/sensing/gem.py``,
``dg.py``, ``vector.py`` and ``SPR.optimal_placement``): the same basis, made
by the JAX package's float64 fit of a small synthetic flame set, goes
through the JAX selection and the port's on the CPU.

Tolerances, float64: selected indices equal; one-hot matrices and masked
bases equal; VDG step scores and σ²_y to ``rtol=1e-10`` (the same
arithmetic in another summation order).  A GEM step score is a conditional
variance σ²_y − Σ_ya Σ_aa⁻¹ Σ_ay, a difference of numbers as large as the
first score: it is held to ``1e-10 ·`` the largest score, and the running
entropy, a sum of half logs of the scores, to ``1e-10`` relative plus that
bar propagated through the logs.  Beyond r sensors the scores fall to the
1e-5 diagonal jitter, where this is what fixes the bar.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from openmeasure_tpu import SPR as JSPR
from openmeasure_tpu.datasets.synthetic import make_flame_dataset
from openmeasure_tpu.sensing import dg as jdg
from openmeasure_tpu.sensing import gem as jgem
from openmeasure_tpu.sensing import vector as jvec
from openmeasure_torch.sensing import dg as tdg
from openmeasure_torch.sensing import gem as tgem
from openmeasure_torch.sensing import vector as tvec
from openmeasure_torch.utils.convert import (ARRAY_KEYS, META_KEYS,
                                             spr_from_numpy)

N_CELLS, NF = 240, 3


@pytest.fixture(scope="module")
def flame():
    return make_flame_dataset(n_cells=N_CELLS, n_features=NF, m_train=16,
                              m_test=3, seed=4)


def _basis(flame, r):
    js = JSPR(flame["X_train"], NF, flame["xyz"])
    js.fit(select_modes="number", n_modes=r)
    return js, np.array(js.Ur)


def _port_spr(js):
    state = {a: np.asarray(getattr(js, a)) for a in ARRAY_KEYS
             if a != "C" and getattr(js, a, None) is not None}
    meta = {k: getattr(js, k) for k in META_KEYS if hasattr(js, k)}
    return spr_from_numpy(state, meta, device="cpu")


def _region(flame):
    """A mask of the cells with x below the median, tiled by feature."""
    x = flame["xyz"][:, 0]
    return np.tile(x < np.median(x), NF)


def _tiled(flame):
    return np.tile(flame["xyz"], (NF, 1))


@pytest.mark.parametrize("r,n_sensors,masked,d_min", [
    (8, 8, False, 0.0), (10, 12, False, 0.03), (6, 9, True, 0.0),
    (12, 10, True, 0.02)])
def test_gem_matches_jax(flame, r, n_sensors, masked, d_min):
    _, Ur = _basis(flame, r)
    mask = _region(flame) if masked else None
    want = jgem._gem_select_jit(
        Ur, _tiled(flame), np.ones(Ur.shape[0], bool) if mask is None
        else mask, np.float64(d_min), n_sensors)
    got = tgem._gem_select(
        torch.as_tensor(Ur), torch.as_tensor(_tiled(flame)),
        torch.as_tensor(np.ones(Ur.shape[0], bool) if mask is None else mask),
        torch.tensor(d_min, dtype=torch.float64), n_sensors)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    sc_w, H_w = np.asarray(want[1]), np.asarray(want[2])
    bar = 1e-10 * np.abs(sc_w).max()
    np.testing.assert_allclose(got[1].numpy(), sc_w, rtol=0, atol=bar)
    h_bar = 1e-10 * np.abs(H_w) + np.cumsum(
        np.r_[0.0, 0.5 * bar / sc_w[1:]])
    assert np.all(np.abs(got[2].numpy() - H_w) <= h_bar)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                               rtol=1e-10)
    sel = tgem.gem_select(torch.as_tensor(Ur), _tiled(flame), n_sensors,
                          mask, d_min)
    np.testing.assert_array_equal(
        sel, jgem.gem_select(Ur, _tiled(flame), n_sensors, mask, d_min))
    assert sel.dtype == np.int64
    if mask is not None:
        assert mask[sel].all()


def test_gem_verbose_table_matches_jax(flame, capsys):
    _, Ur = _basis(flame, 8)
    jgem.gem_select(Ur, _tiled(flame), 6, None, 0.02, verbose=True)
    want = capsys.readouterr().out
    tgem.gem_select(torch.as_tensor(Ur), _tiled(flame), 6, None, 0.02,
                    verbose=True)
    assert capsys.readouterr().out == want


def test_gem_exhaustion_raises_the_jax_message(flame):
    _, Ur = _basis(flame, 6)
    msgs = []
    for fn, U in ((jgem.gem_select, Ur),
                  (tgem.gem_select, torch.as_tensor(Ur))):
        with pytest.raises(ValueError) as e:
            fn(U, _tiled(flame), 20, None, 0.5)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "ran out of candidates" in msgs[0]


@pytest.mark.parametrize("r,n_sensors,masked", [
    (8, 5, False), (8, 8, False), (8, 16, False), (10, 24, True),
    (6, 6, True)])
def test_dg_matches_jax(flame, r, n_sensors, masked):
    _, Ur = _basis(flame, r)
    mask = _region(flame) if masked else None
    want = jdg.dg_select(Ur, n_sensors, mask)
    got = tdg.dg_select(torch.as_tensor(Ur), n_sensors, mask)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64
    if mask is not None:
        assert mask[got[r:]].all()


def test_dg_phase2_matches_jax(flame):
    _, Ur = _basis(flame, 8)
    piv = np.array(jdg.qrcp_pivots(Ur.T, 8))
    alive = np.ones(Ur.shape[0], bool)
    alive[piv] = False
    want = jdg._dg_phase2(Ur, piv, alive, 11)
    got = tdg._dg_phase2(torch.as_tensor(Ur), torch.as_tensor(piv),
                         torch.as_tensor(alive), 11)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dg_exhaustion_raises_the_jax_message():
    # three rows, four sensors: the fourth pivot repeats the first
    Ur = np.random.default_rng(0).standard_normal((3, 4))
    msgs = []
    for fn, U in ((jdg.dg_select, Ur), (tdg.dg_select, torch.as_tensor(Ur))):
        with pytest.raises(ValueError) as e:
            fn(U, 4)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    mask = np.zeros(12, bool)
    mask[:3] = True
    Ur = np.random.default_rng(1).standard_normal((12, 2))
    msgs = []
    for fn, U in ((jdg.dg_select, Ur), (tdg.dg_select, torch.as_tensor(Ur))):
        with pytest.raises(ValueError) as e:
            fn(U, 6, mask)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "rows are selectable" in msgs[0]


@pytest.mark.parametrize("r,n_sensors,mask_kind,d_min", [
    (8, 3, None, 0.0), (14, 6, None, 0.05), (10, 4, "point", 0.0),
    (12, 5, "row", 0.03)])
def test_vdg_matches_jax(flame, r, n_sensors, mask_kind, d_min):
    _, Ur = _basis(flame, r)
    mask = None
    if mask_kind == "point":
        mask = flame["xyz"][:, 0] < np.median(flame["xyz"][:, 0])
    elif mask_kind == "row":
        mask = _region(flame)
        mask[N_CELLS + 3] = False            # one feature row of a point
    xyz = flame["xyz"] if d_min > 0 else None
    want = jvec.vector_dg_select(Ur, NF, n_sensors, mask, xyz=xyz,
                                 d_min=d_min)
    got = tvec.vector_dg_select(torch.as_tensor(Ur), NF, n_sensors, mask,
                                xyz=xyz, d_min=d_min)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64
    # the step scores, from the selection functions themselves
    blocks = np.swapaxes(Ur.reshape(NF, N_CELLS, r), 0, 1)
    alive = np.ones(N_CELLS, bool)
    xyz32 = np.zeros((N_CELLS, 3), np.float32)
    pts_j, sc_j = jvec._vdg_select_jit(blocks, alive, np.float64(1e-3),
                                       xyz32, np.float32(0.0), n_sensors)
    pts_t, sc_t = tvec._vdg_select(
        torch.as_tensor(blocks), torch.as_tensor(alive),
        torch.tensor(1e-3, dtype=torch.float64), torch.as_tensor(xyz32),
        torch.tensor(0.0), n_sensors)
    np.testing.assert_array_equal(pts_t.numpy(), np.asarray(pts_j))
    np.testing.assert_allclose(sc_t.numpy(), np.asarray(sc_j), rtol=1e-10)


def test_vdg_exhaustion_and_validation_match_jax(flame):
    _, Ur = _basis(flame, 6)
    cases = [
        dict(n_sensors=5, mask=np.arange(N_CELLS) < 3),        # too few
        dict(n_sensors=8, mask=None, d_min=10.0, xyz=flame["xyz"]),
        dict(n_sensors=2, mask=np.ones(7, bool)),              # bad length
        dict(n_sensors=2, mask=None, d_min=0.1),               # no xyz
        dict(n_sensors=2, mask=None, d_min=0.1, xyz=np.zeros((5, 3))),
    ]
    for kw in cases:
        msgs = []
        for fn, U in ((jvec.vector_dg_select, Ur),
                      (tvec.vector_dg_select, torch.as_tensor(Ur))):
            with pytest.raises(ValueError) as e:
                fn(U, NF, **kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1], kw
    with pytest.raises(ValueError, match="not divisible"):
        tvec.vector_dg_select(torch.zeros((10, 2), dtype=torch.float64), 3, 1)


def test_vector_onehot_and_feature_ids_match_jax():
    pts = np.array([4, 0, 7])
    want = np.asarray(jvec.vector_onehot(pts, 3, 9, dtype=np.float64))
    got = tvec.vector_onehot(pts, 3, 9, dtype=torch.float64, device="cpu")
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tvec.vector_feature_ids(3, 4),
                                  jvec.vector_feature_ids(3, 4))
    assert tvec.vector_onehot(pts, 3, 9, device="cpu").dtype == torch.float32


@pytest.mark.parametrize("calc_type,n_sensors,masked,d_min", [
    ("qr", 0, False, 0.0), ("qr", 0, True, 0.0),
    ("gem", 9, False, 0.02), ("gem", 7, True, 0.0),
    ("dg", 6, False, 0.0), ("dg", 20, True, 0.0),
    ("vdg", 4, False, 0.0), ("vdg", 3, True, 0.04)])
def test_optimal_placement_matches_jax(flame, calc_type, n_sensors, masked,
                                       d_min):
    js, _ = _basis(flame, 10)
    ts = _port_spr(js)
    if calc_type == "vdg":
        mask = (flame["xyz"][:, 2] < 0.4) if masked else None
    else:
        mask = _region(flame) if masked else None
    Cj = js.optimal_placement(calc_type, n_sensors=n_sensors, mask=mask,
                              d_min=d_min)
    Ct = ts.optimal_placement(calc_type, n_sensors=n_sensors, mask=mask,
                              d_min=d_min)
    assert isinstance(Ct, torch.Tensor) and Ct.dtype == torch.float64
    Cj = Cj.toarray() if sp.issparse(Cj) else np.asarray(Cj)
    np.testing.assert_array_equal(Ct.numpy(), Cj)
    np.testing.assert_array_equal(ts.Ur.numpy(), np.asarray(js.Ur))
    if calc_type == "vdg":
        np.testing.assert_array_equal(ts.sensor_points, js.sensor_points)
    # the placement trains and predicts as the JAX model does
    ys = []
    rows = np.argmax(Cj, axis=1)
    fid = rows // N_CELLS
    for j in range(flame["X_test"].shape[1]):
        y = np.zeros((rows.size, 3))
        y[:, 0] = flame["X_test"][rows, j]
        y[:, 2] = fid
        ys.append(y)
    js.train(Cj)
    ts.train(Ct)
    aj, _ = js.predict(ys)
    at, _ = ts.predict(ys)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=1e-9,
                               atol=1e-9 * np.abs(np.asarray(aj)).max())


def test_placement_config_and_unknown_type(flame):
    from openmeasure_torch.core.config import PlacementConfig
    js, _ = _basis(flame, 8)
    ts = _port_spr(js)
    cfg = PlacementConfig(calc_type="gem", n_sensors=5, d_min=0.01)
    np.testing.assert_array_equal(
        ts.optimal_placement(config=cfg).numpy(),
        np.asarray(js.optimal_placement("gem", n_sensors=5, d_min=0.01)))
    with pytest.raises(NotImplementedError, match="not been implemented"):
        ts.optimal_placement("nope")
