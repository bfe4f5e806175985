"""Axis-aligned voxel grid, the CTC reconstruction mesh (port of
``openmeasure_tpu/ctc/grid.py``).

The grid is three numbers (origin, spacing, dims) and a device.  Ray–cell
intersection is the DDA of :mod:`.raytrace`, run over whole ray bundles on
the grid's device; :meth:`VoxelGrid.trace_csr` assembles the binary
projection operator there and reads back only its CSR skeleton.

Cell ordering is VTK structured order: x fastest, then y, then z (linear
index ``i + nx·(j + ny·k)``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.device import DeviceLike, as_tensor, resolve_device, to_numpy_once
from .raytrace import trace_csr_device, trace_rays


class VoxelGrid:
    """Uniform axis-aligned voxel grid with ``n_cells = nx·ny·nz``, traced on
    ``device`` (``None`` means the card)."""

    def __init__(self, origin: Sequence[float], spacing: Sequence[float],
                 dims: Sequence[int], device: DeviceLike = None):
        self.origin = np.asarray(origin, dtype=float)
        self.spacing = np.asarray(spacing, dtype=float)
        self.dims = tuple(int(d) for d in dims)  # cells per axis
        if any(d <= 0 for d in self.dims):
            raise ValueError("dims must be positive")
        self.n_cells = int(np.prod(self.dims))
        self.device = resolve_device(device)

    @classmethod
    def from_bounds(cls, bounds: Sequence[float], dims: Sequence[int],
                    device: DeviceLike = None) -> "VoxelGrid":
        """bounds = (xmin, xmax, ymin, ymax, zmin, zmax); dims = cells."""
        b = np.asarray(bounds, dtype=float).reshape(3, 2)
        dims = tuple(int(d) for d in dims)
        spacing = (b[:, 1] - b[:, 0]) / np.asarray(dims)
        return cls(b[:, 0], spacing, dims, device=device)

    @property
    def bounds(self) -> np.ndarray:
        hi = self.origin + self.spacing * np.asarray(self.dims)
        return np.stack([self.origin, hi], axis=1)  # (3, 2)

    def cell_centers(self) -> np.ndarray:
        """(n_cells, 3) cell centers in VTK structured (x-fastest) order."""
        nx, ny, nz = self.dims
        xs = self.origin[0] + (np.arange(nx) + 0.5) * self.spacing[0]
        ys = self.origin[1] + (np.arange(ny) + 0.5) * self.spacing[1]
        zs = self.origin[2] + (np.arange(nz) + 0.5) * self.spacing[2]
        Z, Y, X = np.meshgrid(zs, ys, xs, indexing="ij")
        return np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    def _rays(self, p, dtype) -> torch.Tensor:
        return as_tensor(np.asarray(p), self.device, dtype=dtype)

    def find_cells_intersecting_line(self, p1, p2) -> np.ndarray:
        """Linear indices of the cells the segment p1→p2 passes through, in
        entry order (the VTK ``find_cells_intersecting_line`` query), traced
        in float64 on the grid's device."""
        cells, counts = to_numpy_once(*trace_rays(
            self._rays(np.asarray(p1, dtype=float)[None, :], torch.float64),
            self._rays(np.asarray(p2, dtype=float)[None, :], torch.float64),
            self.origin, self.spacing, self.dims))
        return cells[0][: int(counts[0])]

    def trace_batch(self, p1s: np.ndarray, p2s: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Traverse a bundle in float32: ``(cells (n_rays, max_steps)
        padded with −1, counts (n_rays,))`` as host arrays, read back in
        one copy."""
        cells, counts = to_numpy_once(*trace_rays(
            self._rays(p1s, torch.float32), self._rays(p2s, torch.float32),
            self.origin, self.spacing, self.dims))
        return cells, counts

    def trace_csr(self, p1s: np.ndarray, p2s: np.ndarray,
                  pix: np.ndarray, n_pixels: int,
                  readback_cap: Optional[int] = None
                  ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """The binary operator's CSR skeleton, assembled on the grid's
        device (:func:`.raytrace.trace_csr_device`) from float32 rays and
        read back in ONE device-to-host copy: the per-pixel counts, the
        exact nnz and the compacted columns, 2 bytes a column when the grid
        has at most 65,535 cells.

        The column budget defaults to ``n_pixels·max(dims)`` (one full axis
        crossing a pixel after deduplication); a denser operator shows in
        the exact nnz and is fetched again at full size, never cut.
        Returns ``(indptr (n_pixels+1,), cols (nnz,))`` host int64 in
        canonical CSR order, or None when the composite key space would
        overflow int32 (``n_pixels·n_cells ≥ 2³¹``)."""
        if n_pixels * self.n_cells >= 2 ** 31:
            return None
        narrow = self.n_cells <= 65535
        n_rays = np.asarray(p1s).shape[0]
        H = int(sum(self.dims) + 3)
        geom = (self._rays(p1s, torch.float32), self._rays(p2s, torch.float32),
                self.origin, self.spacing, self.dims)
        pix_t = as_tensor(np.asarray(pix), self.device, dtype=torch.int32)

        def fetch(cap):
            counts, cols, nnz = trace_csr_device(
                *geom, pix_t, self.n_cells, n_pixels, out_cap=cap)
            if narrow:
                # int32 → int16 keeps the low 16 bits; read as uint16
                cols = cols.to(torch.int16)
            counts, cols, nnz = to_numpy_once(counts, cols, nnz)
            return counts, cols.view(np.uint16) if narrow else cols, int(nnz)

        total = n_rays * H
        cap = min(total, readback_cap if readback_cap is not None
                  else n_pixels * max(self.dims))
        counts, cols, nnz = fetch(cap)
        if nnz > cap:           # denser than the budget: fetch it all
            counts, cols, _ = fetch(total)
        indptr = np.concatenate([[0], np.cumsum(counts.astype(np.int64))])
        return indptr, cols[:nnz].astype(np.int64)
