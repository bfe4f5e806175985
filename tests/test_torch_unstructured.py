"""Port parity for unstructured meshes (``openmeasure_torch/ctc/
unstructured.py``) and the port's host C++ caster
(``openmeasure_torch/native``), against the JAX package's on the same
meshes and segments, on the CPU.

The caster runs its rays in parallel (OpenMP), so hit pairs come back in
the threads' order: they are compared as sets.  Bars: the exact and the
bounding-box queries EQUAL to JAX's, the plain numpy version of the exact
test EQUAL to the native one, and the operators EQUAL.
"""

import numpy as np
import pytest
import torch

from openmeasure_tpu import ctc as jctc
from openmeasure_torch import _build, native
from openmeasure_torch import ctc as tctc
from openmeasure_torch.ctc.unstructured import (_cell_face_triangles,
                                                _segment_hits_cells_numpy)

CPU = "cpu"


def _sheared_hex_mesh(nx=4, ny=3, nz=3, shear=((1.0, 0.55, 0.3),
                                               (0.0, 1.0, 0.45),
                                               (0.0, 0.0, 1.0))):
    """A unit-cube grid pushed through a linear shear: every cell is a
    parallelepiped (``tests/test_native.py``'s mesh)."""
    S = np.asarray(shear, dtype=float)
    xs, ys, zs = np.arange(nx + 1), np.arange(ny + 1), np.arange(nz + 1)
    P = np.array([[x, y, z] for z in zs for y in ys for x in xs],
                 dtype=float)

    def vid(x, y, z):
        return x + (nx + 1) * (y + (ny + 1) * z)
    cells = [[vid(x, y, z), vid(x + 1, y, z), vid(x + 1, y + 1, z),
              vid(x, y + 1, z), vid(x, y, z + 1), vid(x + 1, y, z + 1),
              vid(x + 1, y + 1, z + 1), vid(x, y + 1, z + 1)]
             for z in range(nz) for y in range(ny) for x in range(nx)]
    return P @ S.T, np.asarray(cells), S


def _split(pts, hexes, k):
    """The hexahedra split into tets (k=4), wedges (6) or pyramids around
    each cell's centroid (5; new points appended)."""
    if k == 8:
        return pts, hexes
    if k == 6:     # two wedges a hex, split along the (0, 2) diagonal
        return pts, np.concatenate([hexes[:, [0, 1, 2, 4, 5, 6]],
                                    hexes[:, [0, 2, 3, 4, 6, 7]]])
    if k == 4:     # five tets a hex
        return pts, np.concatenate([hexes[:, t] for t in
                                    ([0, 1, 3, 4], [1, 2, 3, 6],
                                     [1, 4, 5, 6], [3, 4, 6, 7],
                                     [1, 3, 4, 6])])
    centers = pts[hexes].mean(axis=1)
    c = np.arange(len(pts), len(pts) + len(hexes))[:, None]
    faces = ([0, 3, 2, 1], [4, 5, 6, 7], [0, 1, 5, 4], [1, 2, 6, 5],
             [2, 3, 7, 6], [3, 0, 4, 7])
    pyr = np.concatenate([np.hstack([hexes[:, f], c]) for f in faces])
    return np.vstack([pts, centers]), pyr


def _segments(S, n_rays, seed):
    rng = np.random.default_rng(seed)
    p1s = rng.uniform([-2, -2, -2], [0, 4, 4], size=(n_rays, 3)) @ S.T
    p2s = rng.uniform([4, -1, -1], [7, 4, 4], size=(n_rays, 3)) @ S.T
    return p1s, p2s


def _pairs(ray_ids, cell_ids):
    assert ray_ids.dtype == cell_ids.dtype == np.int64
    pairs = set(zip(ray_ids.tolist(), cell_ids.tolist()))
    assert len(pairs) == len(ray_ids)          # deduplicated per ray
    return pairs


@pytest.mark.parametrize("k", [8, 6, 5, 4],
                         ids=["hex", "wedge", "pyramid", "tet"])
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "aabb"])
def test_caster_equals_jax(k, exact):
    pts, hexes, S = _sheared_hex_mesh()
    pts, cells = _split(pts, hexes, k)
    p1s, p2s = _segments(S, 120, seed=k)
    tm = tctc.UnstructuredMesh.from_cells(pts, cells, exact=exact)
    jm = jctc.UnstructuredMesh.from_cells(pts, cells, exact=exact)
    assert tm.n_cells == jm.n_cells == len(cells) and tm.exact == exact
    np.testing.assert_array_equal(tm.cell_bounds, jm.cell_bounds)
    np.testing.assert_array_equal(tm.cell_centers(), jm.cell_centers())
    got = _pairs(*tm.trace_batch(p1s, p2s))
    assert got == _pairs(*jm.trace_batch(p1s, p2s)) and len(got) > 0


@pytest.mark.parametrize("k", [8, 6, 5, 4],
                         ids=["hex", "wedge", "pyramid", "tet"])
def test_numpy_plain_version_equals_native(k):
    pts, hexes, S = _sheared_hex_mesh(nx=2, ny=2, nz=2)
    pts, cells = _split(pts, hexes, k)
    p1s, p2s = _segments(S, 30, seed=10 + k)
    tris = _cell_face_triangles(k)
    plain = {(r, int(c)) for r in range(len(p1s)) for c in np.flatnonzero(
        _segment_hits_cells_numpy(pts, cells, tris, p1s[r], p2s[r]))}
    got = _pairs(*tctc.UnstructuredMesh.from_cells(pts, cells)
                 .trace_batch(p1s, p2s))
    assert got == plain and len(got) > 0
    # the JAX package's numpy test gives the same masks
    from openmeasure_tpu.ctc.unstructured import (
        _segment_hits_cells_numpy as j_hits)
    for r in range(3):
        np.testing.assert_array_equal(
            _segment_hits_cells_numpy(pts, cells, tris, p1s[r], p2s[r]),
            j_hits(pts, cells, tris, p1s[r], p2s[r]))


def test_face_triangulations_equal_jax():
    from openmeasure_tpu.ctc.unstructured import _cell_face_triangles as jt
    for k in (4, 5, 6, 8):
        np.testing.assert_array_equal(_cell_face_triangles(k), jt(k))
    # the pyramid's base quad (0, 1, 2, 3) is split along (1, 3)
    base = _cell_face_triangles(5)[4:]
    assert all({1, 3} <= set(t.tolist()) for t in base)


def test_pyramid_closed_surface():
    """A segment inside the bounding box but outside the pyramid misses;
    a contained segment and a crossing one hit; the numpy version
    agrees."""
    pts = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                    [0.5, 0.5, 1.0]], dtype=float)
    cells = np.array([[0, 1, 2, 3, 4]])
    mesh = tctc.UnstructuredMesh.from_cells(pts, cells)
    tris = _cell_face_triangles(5)
    for p1, p2, expect in (([0.05, 0.2, 0.8], [0.05, 0.8, 0.8], False),
                           ([0.45, 0.5, 0.2], [0.55, 0.5, 0.2], True),
                           ([-1.0, 0.5, 0.3], [2.0, 0.5, 0.3], True)):
        p1, p2 = np.asarray(p1), np.asarray(p2)
        hit = mesh.find_cells_intersecting_line(p1, p2)
        np.testing.assert_array_equal(hit, [0] if expect else [])
        assert bool(_segment_hits_cells_numpy(pts, cells, tris, p1,
                                              p2)[0]) is expect


def test_contained_segment_axis_aligned_hex_and_miss():
    pts, cells, _ = _sheared_hex_mesh(nx=1, ny=1, nz=1, shear=np.eye(3))
    mesh = tctc.UnstructuredMesh.from_cells(pts, cells)
    np.testing.assert_array_equal(mesh.find_cells_intersecting_line(
        np.array([0.45, 0.5, 0.5]), np.array([0.55, 0.5, 0.5])), [0])
    assert mesh.find_cells_intersecting_line(
        np.array([-5.0, 9.0, 0.0]), np.array([5.0, 9.0, 0.0])).size == 0


def _voxel_hex_mesh(grid):
    """The voxel grid's cells as an explicit hexahedral mesh (VTK vertex
    order, the grid's cell order)."""
    nx, ny, nz = grid.dims
    xs, ys, zs = (grid.origin[a] + grid.spacing[a] * np.arange(n + 1)
                  for a, n in enumerate(grid.dims))
    P = np.array([[x, y, z] for z in zs for y in ys for x in xs])

    def vid(i, j, k):
        return i + (nx + 1) * (j + (ny + 1) * k)
    cells = [[vid(i, j, k), vid(i + 1, j, k), vid(i + 1, j + 1, k),
              vid(i, j + 1, k), vid(i, j, k + 1), vid(i + 1, j, k + 1),
              vid(i + 1, j + 1, k + 1), vid(i, j + 1, k + 1)]
             for k in range(nz) for j in range(ny) for i in range(nx)]
    return P, np.asarray(cells)


def _chip_smoke_voxel_hex_mesh(grid):
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.voxel_hex_mesh(grid)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "aabb"])
def test_hex_copy_of_a_voxel_grid_gives_its_operator(exact):
    grid = tctc.VoxelGrid.from_bounds((-0.5, 0.5, -0.5, 0.5, -0.5, 0.5),
                                      (6, 5, 4), device=CPU)
    P, cells = _voxel_hex_mesh(grid)
    # chip_smoke.py's vectorized form, which phase 19 runs, builds the same
    P_cs, cells_cs = _chip_smoke_voxel_hex_mesh(grid)
    np.testing.assert_array_equal(P_cs, P)
    np.testing.assert_array_equal(cells_cs, cells)
    np.testing.assert_allclose(tctc.UnstructuredMesh.from_cells(
        P, cells).cell_centers(), grid.cell_centers(), atol=1e-12)
    cam = tctc.camera(np.array([0, 0, 2.0, 1.0]), np.zeros(3), 0.05, 2.8,
                      0.06, np.array([8, 8]), 0.5 / 8)
    mesh = tctc.UnstructuredMesh.from_cells(P, cells, exact=exact)
    C_vox = cam.project(grid, "parallel")
    C_mesh = cam.project(mesh, "parallel")
    assert C_mesh.has_canonical_format and (C_vox != C_mesh).nnz == 0
    C_jax = jctc.camera(np.array([0, 0, 2.0, 1.0]), np.zeros(3), 0.05, 2.8,
                        0.06, np.array([8, 8]), 0.5 / 8).project(
        jctc.UnstructuredMesh.from_cells(P, cells, exact=exact), "parallel")
    assert (C_mesh != C_jax).nnz == 0


def test_bounds_only_mesh_and_errors():
    pts, cells, S = _sheared_hex_mesh()
    bounds = tctc.UnstructuredMesh.from_cells(pts, cells).cell_bounds
    tm = tctc.UnstructuredMesh(bounds)
    jm = jctc.UnstructuredMesh(bounds)
    np.testing.assert_allclose(tm.cell_centers(), jm.cell_centers())
    p1s, p2s = _segments(S, 40, seed=3)
    assert _pairs(*tm.trace_batch(p1s, p2s)) == \
        _pairs(*jm.trace_batch(p1s, p2s))
    with pytest.raises(ValueError, match="vertex count"):
        tctc.UnstructuredMesh.from_cells(np.random.rand(10, 3),
                                         np.arange(7)[None, :])
    with pytest.raises(ValueError, match="vertex count"):
        native.trace_segments_cells(pts, cells[:, :7], p1s, p2s)
    with pytest.raises(ValueError, match="outside"):
        native.trace_segments_cells(pts, cells + len(pts), p1s, p2s)
    with pytest.raises(ValueError, match="n_rays, 3"):
        native.trace_segments_aabb(bounds, p1s, p2s[:-1])
    with pytest.raises(ValueError, match="n_cells, 6"):
        native.trace_segments_aabb(bounds[:, :4], p1s, p2s)
    empty = native.trace_segments_aabb(bounds, p1s[:0], p2s[:0])
    assert empty[0].size == empty[1].size == 0


def test_many_hits_grow_the_buffers():
    """More hit pairs than the first buffer (64 a ray) holds: the library
    asks for more and the second call returns them all."""
    grid = tctc.VoxelGrid.from_bounds((0, 1, 0, 1, 0, 1), (40, 40, 40),
                                      device=CPU)
    P, cells = _voxel_hex_mesh(grid)
    mesh = tctc.UnstructuredMesh.from_cells(P, cells, exact=False)
    p1s = np.array([[-0.1, 0.013, 0.017], [0.011, -0.1, 0.019]] * 10)
    p2s = np.array([[1.1, 0.98, 0.97], [0.99, 1.1, 0.985]] * 10)
    rays, hits = mesh.trace_batch(p1s, p2s)
    assert len(rays) > max(1024, 64 * len(p1s))
    for r in range(2):
        np.testing.assert_array_equal(
            np.sort(hits[rays == r]),
            np.sort(grid.find_cells_intersecting_line(p1s[r], p2s[r])))


def test_host_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    (tmp_path / "broken.cpp").write_text("int f( {\n")
    monkeypatch.setattr(_build, "NATIVE", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on "
                                           "native/broken.cpp"):
        _build.load_library("broken")
    assert not list((tmp_path / "build").glob("*.so"))


def test_host_library_is_cached_under_a_source_hash():
    path = _build._lib_path("raycast")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libraycast-") and path.suffix == ".so"
    assert _build.host_sources() == ["raycast"]
    assert _build.load_library("raycast") is _build.load_library("raycast")
    assert path.exists()
    # torch stays out of the caster: it takes and returns numpy
    r, c = native.trace_segments_aabb(np.array([[0, 1, 0, 1, 0, 1.0]]),
                                      np.array([[-1, 0.5, 0.5]]),
                                      np.array([[2, 0.5, 0.5]]))
    assert not isinstance(r, torch.Tensor)
    np.testing.assert_array_equal(c, [0])
