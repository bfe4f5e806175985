"""The port's host C++ tier, loaded with ctypes.

``raycast.cpp`` intersects segments with the cells of an unstructured mesh
(a uniform-grid prefilter and a 3-D DDA over its bins, OpenMP over rays):
by cell bounding boxes (:func:`trace_segments_aabb`) or exactly, by
triangulated faces and containment (:func:`trace_segments_cells`).  It is
built with ``g++`` into ``build/openmeasure_torch/`` at first use
(:func:`openmeasure_torch._build.load_library`); a failed build raises
with the compiler's output.  Both functions return the hit pairs in an order
that depends on the threads' schedule.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from .. import _build

_LIB = None

_P_DOUBLE = ctypes.POINTER(ctypes.c_double)
_P_INT64 = ctypes.POINTER(ctypes.c_int64)


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load_library("raycast")
        lib.trace_segments_aabb.restype = ctypes.c_long
        lib.trace_segments_aabb.argtypes = [
            _P_DOUBLE, ctypes.c_long, _P_DOUBLE, _P_DOUBLE, ctypes.c_long,
            _P_INT64, _P_INT64, ctypes.c_long]
        lib.trace_segments_cells.restype = ctypes.c_long
        lib.trace_segments_cells.argtypes = [
            _P_DOUBLE, ctypes.c_long, _P_INT64, ctypes.c_long, ctypes.c_long,
            _P_DOUBLE, _P_DOUBLE, ctypes.c_long, _P_INT64, _P_INT64,
            ctypes.c_long]
        _LIB = lib
    return _LIB


def _segments(p1s, p2s):
    p1s = np.ascontiguousarray(p1s, dtype=np.float64)
    p2s = np.ascontiguousarray(p2s, dtype=np.float64)
    if p1s.ndim != 2 or p1s.shape[1] != 3 or p1s.shape != p2s.shape:
        raise ValueError(f"segments must be two (n_rays, 3) arrays; got "
                         f"{p1s.shape} and {p2s.shape}")
    return p1s, p2s


def _negotiate(call, n_rays: int, what: str) -> Tuple[np.ndarray, np.ndarray]:
    """Run ``call(out_r, out_c, max_hits)``, growing the buffers to the
    size the library asks for (it returns −needed when they are short)."""
    max_hits = max(1024, n_rays * 64)
    for _ in range(4):
        out_r = np.empty(max_hits, dtype=np.int64)
        out_c = np.empty(max_hits, dtype=np.int64)
        got = call(out_r.ctypes.data_as(_P_INT64),
                   out_c.ctypes.data_as(_P_INT64), max_hits)
        if got >= 0:
            return out_r[:got], out_c[:got]
        max_hits = -got
    raise RuntimeError(f"{what}: buffer negotiation failed")


def trace_segments_aabb(boxes: np.ndarray, p1s: np.ndarray, p2s: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Intersect segments with cell AABBs.

    boxes: (n_cells, 6) [xmin, xmax, ymin, ymax, zmin, zmax]
    p1s, p2s: (n_rays, 3)

    Returns (ray_ids, cell_ids) int64 hit pairs, deduplicated per ray."""
    boxes = np.ascontiguousarray(boxes, dtype=np.float64)
    if boxes.ndim != 2 or boxes.shape[1] != 6:
        raise ValueError(f"boxes must be (n_cells, 6); got {boxes.shape}")
    p1s, p2s = _segments(p1s, p2s)
    lib = _lib()
    return _negotiate(
        lambda out_r, out_c, cap: lib.trace_segments_aabb(
            boxes.ctypes.data_as(_P_DOUBLE), boxes.shape[0],
            p1s.ctypes.data_as(_P_DOUBLE), p2s.ctypes.data_as(_P_DOUBLE),
            p1s.shape[0], out_r, out_c, cap),
        p1s.shape[0], "trace_segments_aabb")


def trace_segments_cells(points: np.ndarray, cells: np.ndarray,
                         p1s: np.ndarray, p2s: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """EXACT segment/cell intersection for tet (k=4), pyramid (5), wedge
    (6) and hex (8) cells given by ``points (n_pts, 3)`` and ``cells
    (n_cells, k)`` connectivity (VTK vertex orderings): the cell's bounding
    box is only a prefilter; a hit needs the segment to cross a
    triangulated face or to lie inside the cell.  Returns (ray_ids,
    cell_ids) int64 hit pairs, deduplicated per ray."""
    points = np.ascontiguousarray(points, dtype=np.float64)
    cells = np.ascontiguousarray(cells, dtype=np.int64)
    p1s, p2s = _segments(p1s, p2s)
    if points.ndim != 2 or points.shape[1] != 3:
        raise ValueError(f"points must be (n_pts, 3); got {points.shape}")
    n_cells, k = cells.shape
    # checked here, not by the library's sentinel, so that every negative
    # return below is a buffer request
    if k not in (4, 5, 6, 8):
        raise ValueError(
            f"trace_segments_cells: unsupported cell vertex count {k} "
            "(supported: 4=tet, 5=pyramid, 6=wedge, 8=hex)")
    if cells.size and (cells.min() < 0 or cells.max() >= points.shape[0]):
        raise ValueError("cells index points outside [0, n_pts)")
    lib = _lib()
    return _negotiate(
        lambda out_r, out_c, cap: lib.trace_segments_cells(
            points.ctypes.data_as(_P_DOUBLE), points.shape[0],
            cells.ctypes.data_as(_P_INT64), n_cells, k,
            p1s.ctypes.data_as(_P_DOUBLE), p2s.ctypes.data_as(_P_DOUBLE),
            p1s.shape[0], out_r, out_c, cap),
        p1s.shape[0], "trace_segments_cells")
