"""Port parity for CTC tomography (``openmeasure_torch/ctc``): the voxel
DDA, the device-side operator assembly, cameras, rigs, resampling and the
sparse-operator flow through SPR and ``SoftSensor``, against the JAX package
on the same numpy inputs, on the CPU.

Bars:
* the DDA's cells and counts EQUAL to JAX's (``torch.equal`` on the cell
  arrays) in float64 and in float32: the port keeps JAX's operations in
  JAX's order, one elementwise operation at a time, and on these rays
  XLA's CPU code rounds alike (no ray differs; were one to, it would sit
  on a tie of two crossings or of a crossing and the segment's end);
* the CSR skeleton (counts, columns, nnz) and every operator EQUAL;
* resampling to 1e-12 (host scipy on both sides);
* SPR OLS and COLS and ``SoftSensor`` with a CTC operator to 1e-9 in
  float64 (``tests/test_torch_constrained.py``'s bar for the ADMM).
"""

import importlib.util
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from openmeasure_tpu import SPR as JSPR
from openmeasure_tpu import ctc as jctc
from openmeasure_tpu.ctc import raytrace as jrt
from openmeasure_tpu.serving import SoftSensor as JSoftSensor
from openmeasure_torch import SPR as TSPR
from openmeasure_torch import SoftSensor as TSoftSensor
from openmeasure_torch import ctc as tctc
from openmeasure_torch.ctc import raytrace as trt
from openmeasure_torch.utils.metrics import nrmse

ROOT = Path(__file__).resolve().parent.parent
CPU = "cpu"
GRID8 = ((-1.0, -1.0, -1.0), (0.25, 0.25, 0.25), (8, 8, 8))
BOX = (-0.1, 0.1, -0.1, 0.1, -0.1, 0.1)
RTOL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch intra-op thread: the DDA and the ADMM are many small ops,
    and beside the other test workers torch's threads spin between them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _traces(p1, p2, dtype, grid=GRID8):
    origin, spacing, dims = (np.asarray(grid[0], float),
                             np.asarray(grid[1], float), grid[2])
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    cj, nj = jrt.trace_rays(jnp.asarray(p1, jdt), jnp.asarray(p2, jdt),
                            origin, spacing, dims)
    ct, nt = trt.trace_rays(torch.as_tensor(p1, dtype=dtype),
                            torch.as_tensor(p2, dtype=dtype),
                            origin, spacing, dims)
    return torch.tensor(np.array(cj)), torch.tensor(np.array(nj)), ct, nt


def _brute_force_cells(p1, p2, n_samples=20000):
    """Dense sampling along the segment (``tests/test_ctc.py``'s oracle)."""
    origin, spacing, dims = (np.asarray(g, float) for g in GRID8)
    t = np.linspace(0, 1, n_samples)
    pts = p1[None, :] + t[:, None] * (p2 - p1)[None, :]
    idx = np.floor((pts - origin[None, :]) / spacing[None, :]).astype(int)
    inside = np.all((idx >= 0) & (idx < dims.astype(int)), axis=1)
    idx = idx[inside]
    d = dims.astype(int)
    return np.unique(idx[:, 0] + d[0] * (idx[:, 1] + d[1] * idx[:, 2]))


# --------------------------------------------------------------------- #
# The DDA
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("seed", range(8))
def test_dda_equals_jax_on_random_rays(seed, dtype):
    rng = np.random.default_rng(seed)
    p1 = rng.uniform(-2, 2, (2000, 3))
    p2 = rng.uniform(-2, 2, (2000, 3))
    cj, nj, ct, nt = _traces(p1, p2, dtype)
    assert ct.dtype == nt.dtype == torch.int32
    assert tuple(ct.shape) == (2000, 8 + 8 + 8 + 3)
    # rays that differ from JAX's: none (a tie would be the only cause)
    differ = (ct != cj).any(dim=1) | (nt != nj)
    assert int(differ.sum()) == 0
    assert torch.equal(ct, cj) and torch.equal(nt, nj)
    # the padding is -1 past each ray's count
    steps = torch.arange(ct.shape[1])[None, :]
    assert torch.equal(ct < 0, steps >= nt[:, None])


@pytest.mark.parametrize("seed", range(4))
def test_dda_matches_brute_force(seed):
    rng = np.random.default_rng(seed)
    p1, p2 = rng.uniform(-2, 2, 3), rng.uniform(-2, 2, 3)
    grid = tctc.VoxelGrid(*GRID8, device=CPU)
    got = np.sort(grid.find_cells_intersecting_line(p1, p2))
    np.testing.assert_array_equal(got, _brute_force_cells(p1, p2))


@pytest.mark.parametrize("case", [
    ("axis", [-2.0, -0.9, -0.9], [2.0, -0.9, -0.9]),
    ("miss", [-2.0, 5.0, 0.0], [2.0, 5.0, 0.0]),
    ("inside", [-0.05, -0.05, -0.05], [0.05, 0.05, 0.05]),
    ("degenerate axis", [0.3, -2.0, 0.1], [0.3, 2.0, 0.1]),
    ("corner diagonal", [-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]),
], ids=lambda c: c[0])
def test_dda_special_rays_equal_jax(case):
    name, p1, p2 = case
    p1, p2 = np.asarray([p1]), np.asarray([p2])
    for dtype in (torch.float64, torch.float32):
        cj, nj, ct, nt = _traces(p1, p2, dtype)
        assert torch.equal(ct, cj) and torch.equal(nt, nj), dtype
    grid = tctc.VoxelGrid(*GRID8, device=CPU)
    got = grid.find_cells_intersecting_line(p1[0], p2[0])
    if name == "axis":
        np.testing.assert_array_equal(np.sort(got), np.arange(8))
    elif name == "miss":
        assert got.size == 0
    elif name == "inside":
        assert got.size >= 2
    np.testing.assert_array_equal(
        got, jctc.VoxelGrid(*GRID8).find_cells_intersecting_line(p1[0],
                                                                 p2[0]))


def test_grid_geometry_equals_jax():
    tg = tctc.VoxelGrid.from_bounds(BOX, (7, 6, 5), device=CPU)
    jg = jctc.VoxelGrid.from_bounds(BOX, (7, 6, 5))
    np.testing.assert_array_equal(tg.bounds, jg.bounds)
    np.testing.assert_array_equal(tg.cell_centers(), jg.cell_centers())
    assert tg.n_cells == jg.n_cells == 210 and tg.dims == jg.dims
    cc = tctc.VoxelGrid((0, 0, 0), (1, 1, 1), (2, 2, 2),
                        device=CPU).cell_centers()
    np.testing.assert_allclose(cc[[0, 1, 2, 4]], [[0.5, 0.5, 0.5],
                                                  [1.5, 0.5, 0.5],
                                                  [0.5, 1.5, 0.5],
                                                  [0.5, 0.5, 1.5]])
    with pytest.raises(ValueError, match="positive"):
        tctc.VoxelGrid((0, 0, 0), (1, 1, 1), (2, 0, 2), device=CPU)
    rng = np.random.default_rng(3)
    p1, p2 = rng.uniform(-0.2, 0.2, (64, 3)), rng.uniform(-0.2, 0.2, (64, 3))
    for a, b in zip(tg.trace_batch(p1, p2), jg.trace_batch(p1, p2)):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------- #
# The device-side assembly
# --------------------------------------------------------------------- #

def _cam_args(px=(5, 4), p_cam=(0.05, -0.02, 1.0, 1.0),
              theta=(0.05, -0.03, 0.2), f=0.05, d_sensor=0.06, size=2e-3):
    return (np.array(p_cam), np.array(theta), f, 2.8, d_sensor,
            np.array(px), size)


@pytest.mark.parametrize("cap", [None, 3, 10 ** 6],
                         ids=["default", "overflow", "large"])
def test_trace_csr_device_equals_jax(cap):
    grid = ((-0.1, -0.1, -0.1), (0.2 / 7, 0.2 / 6, 0.2 / 5), (7, 6, 5))
    p1, p2, pix = jctc.camera(*_cam_args())._make_rays(
        "thin_lens", 6, np.random.default_rng(3))
    n_pixels, n_cells = 20, 210
    total = p1.shape[0] * (7 + 6 + 5 + 3)
    out_cap = min(total, cap if cap is not None else n_pixels * 7)
    cj, colj, nnzj = jrt.trace_csr_device(
        jnp.asarray(p1, jnp.float32), jnp.asarray(p2, jnp.float32),
        np.asarray(grid[0]), np.asarray(grid[1]), grid[2],
        jnp.asarray(pix, jnp.int32), n_cells, n_pixels, out_cap=out_cap)
    ct, colt, nnzt = trt.trace_csr_device(
        torch.as_tensor(p1, dtype=torch.float32),
        torch.as_tensor(p2, dtype=torch.float32),
        np.asarray(grid[0]), np.asarray(grid[1]), grid[2],
        torch.as_tensor(pix, dtype=torch.int32), n_cells, n_pixels,
        out_cap=out_cap)
    assert ct.dtype == colt.dtype == nnzt.dtype == torch.int32
    # the same skeleton from the traced cells directly
    cells = trt.trace_rays(torch.as_tensor(p1, dtype=torch.float32),
                           torch.as_tensor(p2, dtype=torch.float32),
                           np.asarray(grid[0]), np.asarray(grid[1]),
                           grid[2])[0]
    for a, b in zip(trt.csr_from_cells(cells, torch.as_tensor(pix), n_cells,
                                       n_pixels, out_cap),
                    (ct, colt, nnzt)):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(colt.numpy(), np.asarray(colj))
    assert int(nnzt) == int(nnzj)
    if cap == 3:
        assert int(nnzt) > out_cap        # the overflow the caller refetches


@pytest.mark.parametrize("model,nrand", [("parallel", 1), ("pinhole", 3)])
def test_trace_csr_narrow_columns_above_int16_equal_jax(model, nrand):
    """A 40³ grid (64,000 cells): the columns travel as int16 and are read
    back as uint16, so every cell index from 32,768 up crosses the wrap.
    The skeleton equals JAX's and the one built from the traced cells
    directly, which skips the narrow route."""
    dims = (40, 40, 40)
    cam_args = _cam_args((12, 12), (0.0, 0.0, 1.0, 1.0), (0.0, 0.0, 0.0),
                         size=0.25 / 12)
    p1, p2, pix = tctc.camera(*cam_args)._make_rays(
        model, nrand, np.random.default_rng(4))
    tg = tctc.VoxelGrid.from_bounds(BOX, dims, device=CPU)
    jg = jctc.VoxelGrid.from_bounds(BOX, dims)
    assert 2 ** 15 < tg.n_cells <= 65535
    indptr, cols = tg.trace_csr(p1, p2, pix, 144)
    jptr, jcols = jg.trace_csr(p1, p2, pix, 144)
    np.testing.assert_array_equal(indptr, jptr)
    np.testing.assert_array_equal(cols, jcols)
    assert cols.dtype == np.int64
    upper = cols >= 2 ** 15
    assert cols.size and upper.sum() >= cols.size // 4
    assert cols.max() < tg.n_cells
    cells, _ = tg.trace_batch(p1, p2)
    want = np.zeros((144, tg.n_cells), bool)
    for ray, row in enumerate(np.asarray(cells)):
        want[pix[ray], row[row >= 0]] = True
    got = sp.csr_matrix((np.ones(cols.size), cols, indptr),
                        shape=want.shape).toarray() > 0
    np.testing.assert_array_equal(got, want)


def test_trace_csr_refetch_and_overflow_guard(monkeypatch):
    """A budget below nnz makes the port fetch again at full size (the
    operator is never cut), as JAX's; a key space of 2³¹ or more returns
    None and project() takes the padded-cells path."""
    cam_t, cam_j = tctc.camera(*_cam_args((6, 6), (0, 0, 1.0, 1.0), (0, 0, 0))), \
        jctc.camera(*_cam_args((6, 6), (0, 0, 1.0, 1.0), (0, 0, 0)))
    tg = tctc.VoxelGrid.from_bounds(BOX, (6, 6, 6), device=CPU)
    jg = jctc.VoxelGrid.from_bounds(BOX, (6, 6, 6))
    C_full = cam_j.project(jg, "parallel")
    p1, p2, pix = cam_t._make_rays("parallel", 1, np.random.default_rng(0))
    calls = []
    orig = trt.trace_csr_device

    def spy(*a, **k):
        calls.append(k["out_cap"])
        return orig(*a, **k)
    import openmeasure_torch.ctc.grid as grid_mod
    monkeypatch.setattr(grid_mod, "trace_csr_device", spy)
    indptr, cols = tg.trace_csr(p1, p2, pix, 36, readback_cap=3)
    assert calls == [3, p1.shape[0] * 21]
    np.testing.assert_array_equal(indptr, C_full.indptr)
    np.testing.assert_array_equal(cols, C_full.indices)
    calls.clear()
    tg.trace_csr(p1, p2, pix, 36)
    assert calls == [36 * 6]
    # the int32 key-space guard: the same rays, claimed over 2^31 pairs
    assert tg.trace_csr(p1, p2, pix, 2 ** 31 // tg.n_cells + 1) is None
    monkeypatch.setattr(tctc.VoxelGrid, "trace_csr",
                        lambda *a, **k: None)
    C_pad = cam_t.project(tg, "parallel")
    assert (C_pad != C_full).nnz == 0 and C_pad.has_canonical_format


# --------------------------------------------------------------------- #
# Cameras, projections and rigs
# --------------------------------------------------------------------- #

def test_camera_geometry_equals_jax():
    for kw in ({}, dict(p_cam=(0.3, -0.2, 1.5, 1.0), theta=(0.2, -0.1, 0.4)),
               dict(f=0.05, d_sensor=0.05)):
        jc, tc = jctc.camera(*_cam_args(**kw)), tctc.camera(*_cam_args(**kw))
        np.testing.assert_array_equal(tc._extr_matrix(), jc._extr_matrix())
        np.testing.assert_array_equal(tc._sensor_coordinates(),
                                      jc._sensor_coordinates())
        assert (tc.m, tc.d_object, tc.d, tc.n_pixels) == \
            (jc.m, jc.d_object, jc.d, jc.n_pixels)
        for axis in range(3):
            np.testing.assert_array_equal(tc._axis_rotation(axis, 0.3),
                                          jc._axis_rotation(axis, 0.3))
    jc, tc = jctc.camera(*_cam_args()), tctc.camera(*_cam_args())
    for model, nrand in (("parallel", 1), ("pinhole", 6), ("thin_lens", 6)):
        for a, b in zip(tc._make_rays(model, nrand, np.random.default_rng(9)),
                        jc._make_rays(model, nrand, np.random.default_rng(9))):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(NotImplementedError):
        tc._make_rays("bogus", 1, np.random.default_rng(0))
    with pytest.raises(ValueError, match="infinity"):
        tctc.camera(*_cam_args(f=0.05, d_sensor=0.05))._make_rays(
            "thin_lens", 2, np.random.default_rng(0))


def test_generate_camera_needs_pyvista():
    try:
        import pyvista  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="pyvista"):
            tctc.camera(*_cam_args()).generate_camera()
    else:
        assert tctc.camera(*_cam_args()).generate_camera() is not None


@pytest.mark.parametrize("model,nrand", [("parallel", 1), ("pinhole", 6),
                                         ("thin_lens", 6)])
def test_project_equals_jax_on_three_routes(model, nrand):
    """The voxel route (device assembly), a mesh with trace_batch (the
    grid's cells as boxes of the host caster) and a mesh queried ray by
    ray all give JAX's operator."""
    tg = tctc.VoxelGrid.from_bounds(BOX, (7, 6, 5), device=CPU)
    jg = jctc.VoxelGrid.from_bounds(BOX, (7, 6, 5))
    tc, jc = tctc.camera(*_cam_args()), jctc.camera(*_cam_args())
    C_j = jc.project(jg, model, nrand, seed=3)
    C_t = tc.project(tg, model, nrand, seed=3)
    assert C_t.has_canonical_format and C_t.shape == (20, 210)
    np.testing.assert_array_equal(C_t.indptr, C_j.indptr)
    np.testing.assert_array_equal(C_t.indices, C_j.indices)
    assert C_t.nnz == C_j.nnz > 0 and set(np.unique(C_t.data)) == {1}

    class PerRay:                 # a mesh with only the per-ray query
        n_cells = tg.n_cells

        def find_cells_intersecting_line(self, p1, p2):
            return tg.find_cells_intersecting_line(p1, p2)
    C_ray = tc.project(PerRay(), model, nrand, seed=3)
    assert (C_ray != C_j).nnz == 0


def test_project_determinism_and_seed_forms():
    tg = tctc.VoxelGrid.from_bounds(BOX, (6, 6, 6), device=CPU)
    tc = tctc.camera(*_cam_args((6, 6), (0, 0, 1.0, 1.0), (0, 0, 0)))
    C1 = tc.project(tg, "pinhole", 4, seed=42)
    C2 = tc.project(tg, "pinhole", 4, seed=np.random.default_rng(42))
    assert (C1 != C2).nnz == 0


@pytest.mark.parametrize("model,nrand", [("parallel", 1), ("thin_lens", 4)])
def test_stack_cameras_equals_jax_and_per_view(model, nrand):
    tg = tctc.VoxelGrid.from_bounds(BOX, (6, 5, 7), device=CPU)
    jg = jctc.VoxelGrid.from_bounds(BOX, (6, 5, 7))
    args = [_cam_args((5, 4), (0, 0, 1.0, 1.0), (0, 0, 0)),
            _cam_args((4, 4), (0.3, -0.2, 0.8, 1.0), (0.3, -0.5, 1.1))]
    C_t = tctc.stack_cameras([tctc.camera(*a) for a in args], tg, model,
                             N_rand=nrand, seed=11)
    C_j = jctc.stack_cameras([jctc.camera(*a) for a in args], jg, model,
                             N_rand=nrand, seed=11)
    assert C_t.shape == C_j.shape == (36, tg.n_cells)
    assert (C_t != C_j).nnz == 0
    rngs = np.random.default_rng(11).spawn(2)
    C_views = sp.vstack([tctc.camera(*a).project(tg, model, nrand, seed=g)
                         for a, g in zip(args, rngs)]).tocsr()
    assert (C_t != C_views).nnz == 0
    # embedded: the emitting feature's block, zeros elsewhere
    E_t = tctc.stack_cameras([tctc.camera(*a) for a in args], tg, model,
                             N_rand=nrand, seed=11, n_features=3,
                             feature_index=1)
    E_j = jctc.stack_cameras([jctc.camera(*a) for a in args], jg, model,
                             N_rand=nrand, seed=11, n_features=3,
                             feature_index=1)
    assert E_t.shape == (36, 3 * tg.n_cells) and (E_t != E_j).nnz == 0


def test_stack_cameras_key_overflow_goes_view_by_view(monkeypatch):
    tg = tctc.VoxelGrid.from_bounds(BOX, (5, 5, 5), device=CPU)
    args = [_cam_args((4, 4), (0, 0, 1.0, 1.0), (0, 0, 0)),
            _cam_args((3, 4), (0.3, -0.2, 0.8, 1.0), (0.3, -0.5, 1.1))]
    C_rig = tctc.stack_cameras([tctc.camera(*a) for a in args], tg,
                               "pinhole", N_rand=3, seed=5)
    orig = tctc.VoxelGrid.trace_csr
    calls = []

    def once_none(self, *a, **k):
        calls.append(a[3])
        return None if len(calls) == 1 else orig(self, *a, **k)
    monkeypatch.setattr(tctc.VoxelGrid, "trace_csr", once_none)
    C_views = tctc.stack_cameras([tctc.camera(*a) for a in args], tg,
                                 "pinhole", N_rand=3, seed=5)
    assert calls == [28, 16, 12]
    assert (C_rig != C_views).nnz == 0


def test_embed_projection_equals_jax():
    C = sp.csr_matrix(np.array([[1.0, 0, 1], [0, 1, 0]]))
    E_t = tctc.embed_projection(C, n_features=3, feature_index=1)
    E_j = jctc.embed_projection(C, n_features=3, feature_index=1)
    assert E_t.shape == (2, 9) and (E_t != E_j).nnz == 0
    np.testing.assert_array_equal(E_t.toarray()[:, 3:6], C.toarray())


# --------------------------------------------------------------------- #
# Resampling
# --------------------------------------------------------------------- #

def _cloud(seed=0, n=3000):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (n, 3))
    f1 = np.sin(np.pi * pts[:, 0]) * np.cos(np.pi * pts[:, 1])
    X = np.concatenate([np.stack([f1, 2 * f1], 1),
                        np.stack([pts[:, 2] ** 2, -pts[:, 2]], 1)], axis=0)
    return pts, X


@pytest.mark.parametrize("method", ["linear", "idw"])
@pytest.mark.parametrize("dims", ["ints", "arrays"])
def test_resample_equals_jax(method, dims):
    pts, X = _cloud()
    if dims == "ints":
        dimensions = [9, 8, 7]
    else:
        dimensions = list(np.meshgrid(np.linspace(-0.8, 0.8, 6),
                                      np.linspace(-0.5, 0.9, 5),
                                      np.linspace(-1.2, 0.7, 7),
                                      indexing="ij"))
    gj, Xj, xyzj = jctc.resample_to_grid(pts, X, dimensions, method=method)
    gt, Xt, xyzt = tctc.resample_to_grid(pts, X, dimensions, method=method,
                                         device=CPU)
    assert isinstance(Xt, np.ndarray) and isinstance(gt, tctc.VoxelGrid)
    assert gt.dims == gj.dims and gt.device.type == "cpu"
    np.testing.assert_allclose(gt.origin, gj.origin, rtol=1e-12)
    np.testing.assert_allclose(xyzt, xyzj, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(Xt, Xj, rtol=1e-12, atol=1e-12)
    assert np.all(np.isfinite(Xt))


def test_resample_degenerate_cloud_warns_and_falls_back():
    rng = np.random.default_rng(5)
    pts = rng.uniform(-1, 1, (400, 3))
    pts[:, 2] = 0.25
    X = (pts[:, 0] + 2.0 * pts[:, 1])[:, None]
    with pytest.warns(RuntimeWarning, match="degenerate"):
        _, Xt, _ = tctc.resample_to_grid(pts, X, [6, 6, 2], method="linear",
                                         device=CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        _, Xj, _ = jctc.resample_to_grid(pts, X, [6, 6, 2], method="linear")
    np.testing.assert_allclose(Xt, Xj, rtol=1e-12, atol=1e-12)
    _, Xi, _ = tctc.resample_to_grid(pts, X, [6, 6, 2], method="idw",
                                     device=CPU)
    np.testing.assert_allclose(Xt, Xi, rtol=1e-12, atol=1e-12)
    with pytest.raises(TypeError):
        tctc.resample_to_grid(pts, X, ["a", "b", "c"], device=CPU)
    with pytest.raises(ValueError, match="multiple"):
        tctc.resample_to_grid(pts, X[:-1], [4, 4, 4], device=CPU)
    with pytest.raises(ValueError, match="method"):
        tctc.resample_to_grid(pts, X, [4, 4, 4], method="cubic", device=CPU)


# --------------------------------------------------------------------- #
# The sparse-operator flow: SPR and SoftSensor with a CTC operator
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def ctc_flow():
    """An 8³ grid, Gaussian-blob fields, and a 2-view thin-lens rig
    (``tests/test_ctc.py``'s tomography flow), as JAX builds it."""
    jg = jctc.VoxelGrid.from_bounds(BOX, (8, 8, 8))
    xyz = jg.cell_centers()
    X = np.stack([np.exp(-np.sum(xyz ** 2, 1) / (2 * (0.05 * a) ** 2))
                  for a in np.linspace(0.3, 1.0, 12)], axis=1)
    d_sensor, d_obj = 0.06, 0.94
    f = 1.0 / (1.0 / d_sensor + 1.0 / d_obj)
    px = 2 * 0.1 * (d_sensor / f - 1.0) / 8
    args = [(np.array([0, 0, 1.0, 1.0]), np.zeros(3), f, 2.8, d_sensor,
             np.array([8, 8]), px),
            (np.array([1.0, 0, 0.0, 1.0]), np.array([0.0, -np.pi / 2, 0.0]),
             f, 2.8, d_sensor, np.array([8, 8]), px)]
    C = jctc.stack_cameras([jctc.camera(*a) for a in args], jg, "thin_lens",
                           N_rand=6, seed=7)
    C_t = tctc.stack_cameras([tctc.camera(*a) for a in args],
                             tctc.VoxelGrid.from_bounds(BOX, (8, 8, 8),
                                                        device=CPU),
                             "thin_lens", N_rand=6, seed=7)
    assert (C != C_t).nnz == 0
    return X, xyz, C


def _as_operator(C, form):
    if form == "scipy":
        return C
    coo = C.tocoo()
    T = torch.sparse_coo_tensor(np.vstack([coo.row, coo.col]), coo.data,
                                size=C.shape, check_invariants=True)
    return T if form == "torch_coo" else T.to_sparse_csr()


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize("method", ["OLS", "COLS"])
@pytest.mark.parametrize("form", ["scipy", "torch_coo", "torch_csr"])
def test_spr_with_ctc_operator_equals_jax(ctc_flow, method, form):
    X, xyz, C = ctc_flow
    kw = dict(method=method)
    if method == "COLS":
        kw.update(limits=[np.array([0.0]), np.array([1.0])],
                  admm_max_iter=500)
    js = JSPR(X[:, :10], 1, xyz)
    js.fit(select_modes="number", n_modes=5)
    js.train(C, **kw)
    ts = TSPR(X[:, :10], 1, xyz, device=CPU)
    ts.fit(select_modes="number", n_modes=5)
    ts.train(_as_operator(C, form), **kw)
    _close(ts.Theta, js.Theta)
    ys = []
    for j in (10, 11):
        y = np.zeros((C.shape[0], 3))
        y[:, 0] = C @ X[:, j]
        ys.append(y)
    aj, _ = js.predict(ys)
    at, _ = ts.predict(ys)
    _close(at, aj)
    xj = np.asarray(js.reconstruct(aj))
    xt = ts.reconstruct(at)
    _close(xt, xj)
    # the sampled reconstruction and unscaling take the operator too
    _close(ts.reconstruct(at, sampling=_as_operator(C, form)),
           js.reconstruct(aj, sampling=C))
    assert float(nrmse(xt[:, 1], torch.as_tensor(X[:, 11]))) < 0.05


@pytest.mark.parametrize("form", ["scipy", "torch_coo", "torch_csr"])
def test_soft_sensor_with_ctc_operator_equals_jax(ctc_flow, form):
    X, xyz, C = ctc_flow
    kw = dict(method="COLS", limits=[np.array([0.0]), np.array([1.0])])
    js = JSPR(X[:, :10], 1, xyz)
    js.fit(select_modes="number", n_modes=5)
    js.train(C, **kw)
    ts = TSPR(X[:, :10], 1, xyz, device=CPU)
    ts.fit(select_modes="number", n_modes=5)
    ts.train(_as_operator(C, form), **kw)
    fid = np.zeros(C.shape[0], int)
    jsen = JSoftSensor.from_spr(js, feature_ids=fid, dtype=jnp.float64,
                                admm_iters=400)
    tsen = TSoftSensor.from_spr(ts, feature_ids=fid, dtype=torch.float64,
                                admm_iters=400)
    _close(tsen.cnt_sensors, jsen.cnt_sensors)
    _close(tsen.scl_sensors, jsen.scl_sensors)
    frames = np.stack([C @ X[:, j] for j in (10, 11, 3)])
    fj = np.asarray(jsen.predict_batch(frames)[0])
    ft = tsen.predict_batch(frames)[0]
    _close(ft, fj)
    assert float(ft.min()) >= -1e-4 and float(ft.max()) <= 1.0 + 1e-4
    with pytest.raises(ValueError, match="feature_ids"):
        TSoftSensor.from_spr(ts)


def test_torch_sparse_one_hot_detection():
    """A torch sparse one-hot operator scales by its selected rows; a
    duplicated entry (a row value of 2) is not one-hot."""
    from openmeasure_torch.serving import _measurement_scaling
    X_cnt, X_scl = np.arange(6.0), np.arange(1.0, 7.0)
    idx = np.array([[0, 1, 2], [4, 1, 5]])
    C = torch.sparse_coo_tensor(idx, np.ones(3), size=(3, 6),
                                check_invariants=True)
    cnt, scl = _measurement_scaling(C, X_cnt, X_scl, 3)
    np.testing.assert_array_equal(cnt, [4.0, 1.0, 5.0])
    np.testing.assert_array_equal(scl, [5.0, 2.0, 6.0])
    cnt, scl = _measurement_scaling(C.to_sparse_csr(), X_cnt, X_scl, 3)
    np.testing.assert_array_equal(scl, [5.0, 2.0, 6.0])
    dup = torch.sparse_coo_tensor(np.array([[0, 0, 1, 2], [4, 4, 1, 5]]),
                                  np.ones(4), size=(3, 6),
                                  check_invariants=True)
    with pytest.raises(ValueError, match="one-hot"):
        _measurement_scaling(dup, X_cnt, X_scl, 3)


# --------------------------------------------------------------------- #
# Phase 19's reference value
# --------------------------------------------------------------------- #

def test_phase19_reference_nrmse_is_jax_float64():
    """``chip_smoke.py`` phase 19 holds the card's held-out NRMSE within
    1.10× of the JAX package's float64 value for the same flow (a 32³ grid,
    the 4-view rig of 64×64 parallel cameras, 10 training fields, n_modes
    5, OLS and COLS in [0, 1]).  The value it carries is JAX's, computed
    here, and the port's float64 CPU run of the flow equals it."""
    cs = _chip_smoke()
    jg = jctc.VoxelGrid.from_bounds(cs.CTC_BOUNDS, cs.CTC_DIMS)
    xyz = jg.cell_centers()
    X = cs.ctc_fields(xyz)
    C = jctc.stack_cameras(cs.ctc_rig(jctc.camera), jg, "parallel", seed=0)
    tg = tctc.VoxelGrid.from_bounds(cs.CTC_BOUNDS, cs.CTC_DIMS, device=CPU)
    C_t = tctc.stack_cameras(cs.ctc_rig(tctc.camera), tg, "parallel", seed=0)
    assert C.shape == (16384, 32768) and (C != C_t).nnz == 0
    y = np.zeros((C.shape[0], 3))
    y[:, 0] = C @ X[:, cs.CTC_HELD_OUT]
    for method, kw in cs.CTC_METHODS.items():
        js = JSPR(X[:, :cs.CTC_TRAIN], 1, xyz)
        js.fit(select_modes="number", n_modes=cs.CTC_MODES)
        js.train(C, method=method, **kw)
        x_j = np.asarray(js.reconstruct(js.predict(y)[0]))[:, 0]
        ref = float(np.sqrt(np.mean((x_j - X[:, cs.CTC_HELD_OUT]) ** 2))
                    / np.ptp(X[:, cs.CTC_HELD_OUT]))
        np.testing.assert_allclose(cs.CTC_F64_NRMSE[method], ref, rtol=1e-6)
        ts = TSPR(X[:, :cs.CTC_TRAIN], 1, xyz, device=CPU)
        ts.fit(select_modes="number", n_modes=cs.CTC_MODES)
        ts.train(C_t, method=method, **kw)
        x_t = ts.reconstruct(ts.predict(y)[0])[:, 0]
        got = float(nrmse(x_t, torch.as_tensor(X[:, cs.CTC_HELD_OUT])))
        np.testing.assert_allclose(got, ref, rtol=RTOL)
