"""Unstructured mesh support for CTC projection (port of
``openmeasure_tpu/ctc/unstructured.py``).

:class:`UnstructuredMesh` answers the ray query of a voxel grid for any
cell soup, through the host C++ caster (:mod:`openmeasure_torch.native`,
OpenMP over the whole ray bundle):

* built :meth:`~UnstructuredMesh.from_cells` (points + tet/pyramid/wedge/
  hex connectivity), queries are EXACT: the cell's bounding box is only a
  prefilter, and a candidate counts as a hit iff the segment crosses one of
  the cell's triangulated faces or lies inside the cell
  (``native.trace_segments_cells``);
* built from raw ``cell_bounds`` (no connectivity), or ``from_cells(...,
  exact=False)``, cells are their axis-aligned bounding boxes: exact for
  hexahedral/voxel cells, a superset for skewed elements.

The caster runs on the host, as the JAX package's does; a failed build
raises.  :func:`_segment_hits_cells_numpy` is its plain version, a brute
force in numpy that the tests compare it with.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .. import native


def _cell_face_triangles(k: int) -> np.ndarray:
    """Triangulated faces for VTK cell orderings, the native caster's
    (``native/raycast.cpp``): each quad face of the wedge and the
    hexahedron is split along the diagonal from the first vertex of its
    first triangle, and the pyramid's base quad (0, 1, 2, 3) along its
    (1, 3) diagonal."""
    if k == 4:       # VTK_TETRA
        return np.array([[0, 1, 3], [1, 2, 3], [2, 0, 3], [0, 2, 1]])
    if k == 5:       # VTK_PYRAMID: all four side triangles + split base
        # (a closed surface, or the containment parity breaks)
        return np.array([[0, 1, 4], [1, 2, 4], [2, 3, 4], [3, 0, 4],
                         [3, 2, 1], [3, 1, 0]])
    if k == 6:       # VTK_WEDGE
        return np.array([[0, 1, 2], [3, 5, 4],
                         [0, 3, 4], [0, 4, 1],
                         [1, 4, 5], [1, 5, 2],
                         [2, 5, 3], [2, 3, 0]])
    if k == 8:       # VTK_HEXAHEDRON
        return np.array([[0, 1, 5], [0, 5, 4],
                         [1, 2, 6], [1, 6, 5],
                         [2, 3, 7], [2, 7, 6],
                         [3, 0, 4], [3, 4, 7],
                         [0, 3, 2], [0, 2, 1],
                         [4, 5, 6], [4, 6, 7]])
    raise ValueError(
        f"unsupported cell vertex count {k} (supported: 4=tet, "
        "5=pyramid, 6=wedge, 8=hex)")


def _seg_tri_hits(o, d, tlo, thi, v0, v1, v2):
    """Vectorized Möller–Trumbore over a triangle batch, with the native
    ``seg_tri``'s epsilon conventions."""
    EPS = 1e-12
    e1 = v1 - v0
    e2 = v2 - v0
    pv = np.cross(np.broadcast_to(d, e2.shape), e2)
    det = np.einsum("ij,ij->i", e1, pv)
    ok = np.abs(det) >= 1e-300
    inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
    tv = o[None, :] - v0
    u = np.einsum("ij,ij->i", tv, pv) * inv
    qv = np.cross(tv, e1)
    v = np.einsum("j,ij->i", d, qv) * inv
    t = np.einsum("ij,ij->i", e2, qv) * inv
    return (ok & (u >= -EPS) & (u <= 1.0 + EPS)
            & (v >= -EPS) & (u + v <= 1.0 + EPS)
            & (t >= tlo - EPS) & (t <= thi + EPS))


def _segment_hits_cells_numpy(points, cells, tris, p1, p2):
    """The plain version of the exact caster: a numpy test of ONE segment
    against every cell, by brute force.  Returns a hit mask (n_cells,).
    The tests hold :func:`..native.trace_segments_cells` to it."""
    d = p2 - p1
    V = points[cells]                                # (n_cells, k, 3)
    n_cells = V.shape[0]
    f = tris.shape[0]
    v0 = V[:, tris[:, 0]].reshape(-1, 3)
    v1 = V[:, tris[:, 1]].reshape(-1, 3)
    v2 = V[:, tris[:, 2]].reshape(-1, 3)
    face_hit = _seg_tri_hits(p1, d, 0.0, 1.0, v0, v1, v2)
    hit = face_hit.reshape(n_cells, f).any(axis=1)
    # contained-segment case: parity of a GENERIC-direction half-ray from
    # the midpoint for cells with no face crossing (an axis-aligned ray
    # from a symmetric midpoint can pass exactly through a quad-face
    # diagonal and double-count; direction must match the native caster)
    rest = ~hit
    if np.any(rest):
        mid = p1 + 0.5 * d
        dx = np.array([1.0, 0.0577350269189626, 0.0339887498948482])
        cross = _seg_tri_hits(mid, dx, 0.0, 1e300,
                              v0, v1, v2).reshape(n_cells, f)
        hit = hit | (rest & ((cross.sum(axis=1) % 2) == 1))
    return hit


class UnstructuredMesh:
    """Cell soup: per-cell AABBs, optionally with exact connectivity."""

    def __init__(self, cell_bounds: np.ndarray,
                 cell_centers_xyz: Optional[np.ndarray] = None):
        """cell_bounds: (n_cells, 6) [xmin, xmax, ymin, ymax, zmin, zmax].
        AABB-only queries (use :meth:`from_cells` for exact ones)."""
        self.cell_bounds = np.ascontiguousarray(cell_bounds, dtype=float)
        self.n_cells = self.cell_bounds.shape[0]
        self._centers = cell_centers_xyz
        self._points = None
        self._cells = None
        self.exact = False

    @classmethod
    def from_cells(cls, points: np.ndarray, cells: np.ndarray,
                   exact: bool = True) -> "UnstructuredMesh":
        """points (n_pts, 3); cells (n_cells, k) vertex-index connectivity
        (VTK orderings; k ∈ {4, 5, 6, 8}).

        ``exact=True`` (default): exact ray/cell queries.
        ``exact=False``: the bounding-box fast path (a superset of the hits
        on skewed cells)."""
        pts = np.asarray(points, dtype=float)
        cells = np.asarray(cells, dtype=np.int64)
        if exact:
            _cell_face_triangles(cells.shape[1])   # validate k loudly
        cell_pts = pts[cells]                    # (n_cells, k, 3)
        lo = cell_pts.min(axis=1)
        hi = cell_pts.max(axis=1)
        bounds = np.empty((cell_pts.shape[0], 6))
        bounds[:, 0::2] = lo
        bounds[:, 1::2] = hi
        centers = cell_pts.mean(axis=1)
        out = cls(bounds, centers)
        out._points = np.ascontiguousarray(pts)
        out._cells = np.ascontiguousarray(cells)
        out.exact = bool(exact)
        return out

    def cell_centers(self) -> np.ndarray:
        if self._centers is None:
            lo = self.cell_bounds[:, 0::2]
            hi = self.cell_bounds[:, 1::2]
            self._centers = 0.5 * (lo + hi)
        return self._centers

    def find_cells_intersecting_line(self, p1, p2) -> np.ndarray:
        _, cells = self.trace_batch(np.asarray(p1, dtype=float)[None, :],
                                    np.asarray(p2, dtype=float)[None, :])
        return cells

    def trace_batch(self, p1s: np.ndarray, p2s: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """All rays in one call to the host caster: returns (ray_ids,
        cell_ids) hit pairs.  Exact when the mesh carries connectivity and
        ``exact=True``; the bounding-box superset otherwise."""
        if self.exact and self._cells is not None:
            return native.trace_segments_cells(self._points, self._cells,
                                               p1s, p2s)
        return native.trace_segments_aabb(self.cell_bounds, p1s, p2s)
