"""Camera model and CTC projection operators (port of
``openmeasure_tpu/ctc/camera.py``).

Pinhole and thin-lens geometry on homogeneous 4-vectors, extrinsics
E = R_x R_y R_z with translation, the sensor's pixel grid, random samples
on the lens disc, magnification m = d_sensor/f − 1, and ``project()``
producing the sparse binary measurement matrix C (n_pixels, n_cells) for
three projection models ('parallel', 'pinhole', 'thin_lens').  The ray
geometry is host numpy in float64 and draws from one ``numpy`` Generator
in the JAX package's order, so one seed gives the same rays in both
packages.

``project()`` takes one of three routes: a :class:`.grid.VoxelGrid`
traces every ray at once on the grid's device and assembles the operator
there (:meth:`.grid.VoxelGrid.trace_csr`); a mesh with ``trace_batch``
(:class:`.unstructured.UnstructuredMesh`, the host C++ caster) takes the
whole bundle in one call; any other mesh exposing
``find_cells_intersecting_line`` (a pyvista mesh, say) is queried ray by
ray.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
from scipy.sparse import csr_matrix

from .grid import VoxelGrid


class camera:
    """A camera at ``p_cam`` (homogeneous 4-vector) with angles ``theta``,
    focal length ``f_length``, f-number ``n_aper``, lens-to-sensor
    distance ``d_sensor``, ``sensor_size_px`` pixels of ``px_size``."""

    def __init__(self, p_cam, theta, f_length, n_aper, d_sensor,
                 sensor_size_px, px_size):
        self.p_cam = np.asarray(p_cam, dtype=float)
        self.theta = np.asarray(theta, dtype=float)
        self.f_length = f_length
        self.n_aper = n_aper
        self.d_sensor = d_sensor
        self.sensor_size_px = np.asarray(sensor_size_px)
        self.px_size = px_size

        self.n_pixels = int(sensor_size_px[0] * sensor_size_px[1])
        self.sensor_size_m = px_size * self.sensor_size_px
        self.d = np.linalg.norm(self.p_cam - np.array([0, 0, 0, 1.0]))

        m = d_sensor / f_length - 1
        if m > 1e-2:
            self.m = m
            self.d_object = f_length / (1 - f_length / d_sensor)
        else:
            self.m = 0
            self.d_object = -1

    # ------------------------------------------------------------------ #
    # Geometry
    # ------------------------------------------------------------------ #

    @staticmethod
    def _axis_rotation(axis: int, angle: float) -> np.ndarray:
        """Homogeneous 4×4 rotation about a coordinate axis (0=x, 1=y, 2=z)."""
        c, s = np.cos(angle), np.sin(angle)
        R = np.eye(4)
        i, j = [(1, 2), (2, 0), (0, 1)][axis]  # plane rotated by this axis
        R[i, i] = c
        R[j, j] = c
        R[i, j] = -s
        R[j, i] = s
        return R

    def _extr_matrix(self) -> np.ndarray:
        """World→camera extrinsics: E = Rx Ry Rz with translation
        −E p_cam."""
        E = np.eye(4)
        for axis, angle in enumerate(self.theta):
            E = E @ self._axis_rotation(axis, angle)
        E[:3, 3] = -(E @ self.p_cam)[:3]
        return E

    def _sensor_coordinates(self) -> np.ndarray:
        """Homogeneous pixel-center coordinates on the sensor plane,
        row-major from the top-left pixel (x ascending, y descending)."""
        half_w, half_h = self.sensor_size_m / 2
        margin = self.px_size / 2
        cols = np.linspace(-half_w + margin, half_w - margin,
                           self.sensor_size_px[0])
        rows = np.linspace(half_h - margin, -half_h + margin,
                           self.sensor_size_px[1])
        grid_x, grid_y = np.meshgrid(cols, rows)
        pix = np.column_stack([grid_x.ravel(), grid_y.ravel(),
                               np.zeros(grid_x.size), np.ones(grid_x.size)])
        return pix

    def _random_lens(self, N_rand: int, rng) -> np.ndarray:
        """Uniform samples on the lens disc (aperture radius f/(2N)),
        homogeneous, at the lens plane z = −d_sensor (area-uniform by a
        square-root radius)."""
        aperture_r = self.f_length / (2 * self.n_aper)
        radius = aperture_r * np.sqrt(rng.random(size=N_rand))
        phase = 2 * np.pi * rng.random(size=N_rand)
        pts = np.column_stack([radius * np.cos(phase),
                               radius * np.sin(phase),
                               np.full(N_rand, -self.d_sensor),
                               np.ones(N_rand)])
        return pts

    def generate_camera(self):
        """Pyvista visualization object; needs the optional pyvista
        package and raises without it."""
        try:
            import pyvista as pv
        except ImportError as e:
            raise ImportError(
                "generate_camera() needs the optional pyvista package for "
                "visualization") from e
        body_len = 2 * self.f_length
        body = pv.Box([-body_len / 2, body_len / 2] * 3)
        lens_cone = pv.Cone(center=(0, 0, -3 * body_len / 4),
                            direction=(0, 0, 1), height=body_len / 2,
                            radius=body_len / 4, resolution=20)
        sight_line = pv.Line((0, 0, 0), (0, 0, -2 * self.d), resolution=2)
        glyph = body.merge([lens_cone, sight_line])
        return glyph.transform(np.linalg.inv(self._extr_matrix()))

    # ------------------------------------------------------------------ #
    # Ray generation
    # ------------------------------------------------------------------ #

    def _make_rays(self, type_rec: str, N_rand: int, rng):
        """Global-frame segment endpoints for every ray, plus the pixel id
        each ray belongs to.  Returns (p1 (R,3), p2 (R,3), pixel_ids (R,))."""
        E_inv = np.linalg.inv(self._extr_matrix())
        xyz_sl = self._sensor_coordinates()

        if type_rec == "parallel":
            p1l = xyz_sl
            p2l = xyz_sl.copy()
            p2l[:, 2] = -2 * self.d
            pix = np.arange(self.n_pixels)

        elif type_rec == "pinhole":
            pll = np.array([0, 0, -self.d_sensor, 1.0])
            dx = self.px_size * (rng.random((self.n_pixels, N_rand)) - 0.5)
            dy = self.px_size * (rng.random((self.n_pixels, N_rand)) - 0.5)
            psl = np.zeros((self.n_pixels, N_rand, 4))
            psl[:, :, 0] = xyz_sl[:, [0]] + dx
            psl[:, :, 1] = xyz_sl[:, [1]] + dy
            psl[:, :, 3] = 1.0
            v = pll[None, None, :] - psl
            v = v / np.linalg.norm(v[:, :, :3], axis=2, keepdims=True)
            pfl = psl + 2 * self.d * v
            p1l = psl.reshape(-1, 4)
            p2l = pfl.reshape(-1, 4)
            pix = np.repeat(np.arange(self.n_pixels), N_rand)

        elif type_rec == "thin_lens":
            if self.m == 0:
                raise ValueError("For focus at infinity use a different model")
            xyz_ll = self._random_lens(self.n_pixels * N_rand, rng)
            dx = self.px_size * (rng.random((self.n_pixels, N_rand)) - 0.5)
            dy = self.px_size * (rng.random((self.n_pixels, N_rand)) - 0.5)
            psl = np.zeros((self.n_pixels, N_rand, 4))
            psl[:, :, 0] = xyz_sl[:, [0]] + dx
            psl[:, :, 1] = xyz_sl[:, [1]] + dy
            psl[:, :, 3] = 1.0
            # one lens point per pixel, shared by its N_rand rays
            pll = xyz_ll[: self.n_pixels][:, None, :] * np.ones(
                (1, N_rand, 1))
            pol = np.zeros_like(pll)
            pol[:, :, 0] = -psl[:, :, 0] / self.m
            pol[:, :, 1] = -psl[:, :, 1] / self.m
            pol[:, :, 2] = -(self.d_object + self.d_sensor)
            pol[:, :, 3] = 1.0
            v = pol - pll
            v = v / np.linalg.norm(v[:, :, :3], axis=2, keepdims=True)
            pfl = pll + 2 * self.d * v
            p1l = pll.reshape(-1, 4)
            p2l = pfl.reshape(-1, 4)
            pix = np.repeat(np.arange(self.n_pixels), N_rand)
        else:
            raise NotImplementedError(
                f"projection type {type_rec!r} not implemented")

        p1g = (E_inv @ p1l.T).T[:, :3]
        p2g = (E_inv @ p2l.T).T[:, :3]
        return p1g, p2g, pix

    # ------------------------------------------------------------------ #
    # Projection
    # ------------------------------------------------------------------ #

    def project(self, obj_mesh, type_rec: str = "parallel",
                N_rand: int = 10, verbose: bool = False,
                seed: Optional[int] = None) -> csr_matrix:
        """Binary sparse measurement matrix C (n_pixels, n_cells): C[i, j]=1
        iff any ray of pixel i intersects cell j.  ``seed`` is anything
        ``np.random.default_rng`` takes."""
        rng = np.random.default_rng(seed)
        p1, p2, pix = self._make_rays(type_rec, N_rand, rng)
        n_cells = obj_mesh.n_cells

        if isinstance(obj_mesh, VoxelGrid):
            # the operator's CSR skeleton, deduplicated on the grid's
            # device and read back in one copy
            skel = obj_mesh.trace_csr(p1, p2, pix, self.n_pixels)
            if skel is not None:
                indptr, cols_u = skel
                return csr_matrix(
                    (np.ones(len(cols_u), dtype=np.int64), cols_u, indptr),
                    shape=(self.n_pixels, n_cells))
            # more than 2^31 composite keys: the padded cells, read back
            cells, counts = obj_mesh.trace_batch(p1, p2)
            ray_ids = np.repeat(np.arange(cells.shape[0]), cells.shape[1])
            flat = cells.ravel()
            valid = flat >= 0
            rows = pix[ray_ids[valid]]
            cols = flat[valid]
        elif hasattr(obj_mesh, "trace_batch"):
            # a batched mesh (UnstructuredMesh): all rays in one call
            ray_ids, cols = obj_mesh.trace_batch(p1, p2)
            rows = pix[ray_ids]
        else:
            rows_l, cols_l = [], []
            for i in range(p1.shape[0]):
                hit = obj_mesh.find_cells_intersecting_line(p1[i], p2[i])
                rows_l.extend([pix[i]] * len(hit))
                cols_l.extend(list(hit))
                if verbose:
                    print(f"Ray {i+1}/{p1.shape[0]}", end="\r", flush=True)
            rows = np.asarray(rows_l, dtype=np.int64)
            cols = np.asarray(cols_l, dtype=np.int64)

        data = np.ones(len(rows), dtype=np.int64)
        C = csr_matrix((data, (rows, cols)),
                       shape=(self.n_pixels, n_cells))
        # binary: a pixel sees a cell once however many of its rays hit it
        C.sum_duplicates()
        C.data[:] = 1
        return C
