"""Field resampling onto a structured voxel grid (port of
``openmeasure_tpu/ctc/resample.py``; host scipy, as there).

The source is any unstructured point cloud (cell centers + values); all
features and snapshots interpolate in one vectorized pass.  Two
interpolants:

* ``method='linear'`` (default): barycentric interpolation on a Delaunay
  triangulation of the source points (``scipy.interpolate
  .LinearNDInterpolator``), exact for affine fields inside the convex hull,
  nearest-neighbour fill outside it.  A degenerate (coplanar, collinear)
  cloud has no 3-D triangulation: it falls back to IDW with a
  ``RuntimeWarning``.
* ``method='idw'``: k-nearest-neighbour inverse-distance weighting by a
  cKDTree, with no triangulation; not exact for affine fields.

Accepts either a pyvista-like mesh (``.cell_centers().points``) or a plain
``(n_cells, 3)`` coordinate array as the source mesh, and returns host
numpy arrays beside a :class:`.grid.VoxelGrid` on ``device``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from ..core.device import DeviceLike
from .grid import VoxelGrid


def _source_points(mesh) -> np.ndarray:
    if isinstance(mesh, np.ndarray):
        return mesh
    if hasattr(mesh, "cell_centers"):
        cc = mesh.cell_centers()
        pts = getattr(cc, "points", cc)
        return np.asarray(pts)
    raise TypeError("mesh must be an (n,3) array or expose cell_centers()")


def resample_to_grid(
    mesh, X: np.ndarray, dimensions: Sequence, verbose: bool = False,
    k: int = 8, method: str = "linear", device: DeviceLike = None,
) -> Tuple[VoxelGrid, np.ndarray, np.ndarray]:
    """Interpolate feature-blocked snapshot data onto a voxel grid.

    ``dimensions`` is either three ints (points a side of a grid spanning
    the source bounding box) or three coordinate arrays of shape (n_x, n_y,
    n_z) describing a rectilinear subset (uniformized by their extents).
    ``method`` is 'linear' or 'idw' (see the module docstring); ``device``
    is the returned grid's (``None`` means the card).

    Returns (mesh_int: VoxelGrid, X_int (n_features·n_cells_grid, m),
    xyz_int (n_cells_grid, 3)), the arrays host numpy.
    """
    from scipy.spatial import cKDTree

    pts = _source_points(mesh)
    n_cells = pts.shape[0]
    n_features = X.shape[0] // n_cells
    if X.shape[0] % n_cells != 0:
        raise ValueError("X rows must be a multiple of the mesh cell count")

    if isinstance(dimensions[0], np.ndarray):
        xs, ys, zs = dimensions
        # point dims -> cell dims
        dims = tuple(max(s - 1, 1) for s in xs.shape)
        bounds = (xs.min(), xs.max(), ys.min(), ys.max(), zs.min(), zs.max())
        grid = VoxelGrid.from_bounds(bounds, dims, device=device)
    elif isinstance(dimensions[0], (int, np.integer)):
        lo = pts.min(axis=0)
        hi = pts.max(axis=0)
        span = np.where(hi - lo <= 0, 1.0, hi - lo)
        dims = tuple(max(int(d) - 1, 1) for d in dimensions)  # pts -> cells
        grid = VoxelGrid(lo, span / np.asarray(dims), dims, device=device)
    else:
        raise TypeError(
            "The objects in the list must be either integers or numpy arrays")

    xyz_int = grid.cell_centers()
    n_grid = xyz_int.shape[0]
    X_b = X.reshape(n_features, n_cells, X.shape[1])

    did_linear = False
    if method == "linear" and n_cells >= 5:
        from scipy.interpolate import LinearNDInterpolator
        from scipy.spatial import QhullError
        # one triangulation, all (feature, snapshot) fields as value columns
        vals = np.moveaxis(X_b, 1, 0).reshape(n_cells, -1)   # (n_cells, f·m)
        try:
            interp = LinearNDInterpolator(pts, vals)
            out = interp(xyz_int)                            # (n_grid, f·m)
            did_linear = True
        except QhullError:
            # a degenerate (coplanar/collinear) source cloud has no 3-D
            # Delaunay triangulation: fall back to IDW
            import warnings
            warnings.warn(
                "resample_to_grid: source points are degenerate (no 3-D "
                "triangulation exists); falling back to method='idw'.",
                RuntimeWarning, stacklevel=2)
    if did_linear:
        outside = np.isnan(out[:, 0])
        if np.any(outside):
            # nearest-neighbor fill outside the convex hull (downstream
            # needs finite values)
            tree = cKDTree(pts)
            _, nn = tree.query(xyz_int[outside], k=1)
            out[outside] = vals[nn]
        X_int = np.moveaxis(out.reshape(n_grid, n_features, X.shape[1]),
                            0, 1).reshape(n_features * n_grid, X.shape[1])
    elif method in ("idw", "linear"):  # 'linear' fallback: degenerate/tiny
        tree = cKDTree(pts)
        kk = min(k, n_cells)
        dist, idx = tree.query(xyz_int, k=kk)
        if kk == 1:
            dist, idx = dist[:, None], idx[:, None]
        w = 1.0 / np.maximum(dist, 1e-12) ** 2
        w /= w.sum(axis=1, keepdims=True)
        # one gather + weighted sum for every feature and snapshot
        X_int = np.einsum("gk,fgkm->fgm", w, X_b[:, idx, :]).reshape(
            n_features * n_grid, X.shape[1])
    else:
        raise ValueError(f"unknown resampling method {method!r}")
    if verbose:
        print(f"Resampled {n_features} features × {X.shape[1]} snapshots "
              f"onto {n_grid} cells")
    return grid, X_int, xyz_int
