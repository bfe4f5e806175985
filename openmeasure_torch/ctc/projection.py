"""Sparse projection utilities (port of
``openmeasure_tpu/ctc/projection.py``)."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def embed_projection(C, n_features: int, feature_index: int):
    """Embed a camera projection C (n_pixels, n_cells) into the
    feature-blocked state layout (n_pixels, n_features·n_cells), placing C
    at the emitting feature's block."""
    C = sp.csr_matrix(C)
    n_pixels, n_cells = C.shape
    blocks = [C if f == feature_index else sp.csr_matrix((n_pixels, n_cells))
              for f in range(n_features)]
    return sp.hstack(blocks).tocsr()


def stack_cameras(cams, obj_mesh, type_rec: str = "parallel",
                  N_rand: int = 10, seed=None, n_features: int = 1,
                  feature_index: int = 0):
    """Project with every camera and stack into one measurement operator,
    optionally embedded into the feature-blocked layout.

    Each camera gets an independent child generator spawned from ``seed``
    (anything ``np.random.default_rng`` takes), so the views' pixel jitter
    and lens samples are independent.

    On a :class:`.grid.VoxelGrid` the whole rig goes through ONE trace:
    every view's ray bundle is concatenated, its pixel ids offset by the
    views before it, and a single :meth:`~.grid.VoxelGrid.trace_csr`
    traces, deduplicates and reads back the operator of all cameras.  The
    operator equals the per-view path's (the same generators, the same
    rays).  When the rig's composite keys would overflow int32 it goes view
    by view."""
    from .grid import VoxelGrid

    rngs = np.random.default_rng(seed).spawn(len(cams))
    if isinstance(obj_mesh, VoxelGrid):
        p1s, p2s, pixs = [], [], []
        offset = 0
        for cam, rng in zip(cams, rngs):
            p1, p2, pix = cam._make_rays(type_rec, N_rand, rng)
            p1s.append(p1)
            p2s.append(p2)
            pixs.append(pix + offset)
            offset += cam.n_pixels
        skel = obj_mesh.trace_csr(np.concatenate(p1s), np.concatenate(p2s),
                                  np.concatenate(pixs), offset)
        if skel is not None:
            indptr, cols = skel
            C = sp.csr_matrix(
                (np.ones(len(cols)), cols, indptr),
                shape=(offset, obj_mesh.n_cells))
            if n_features > 1:
                C = embed_projection(C, n_features, feature_index)
            return C
        # composite-key overflow: view by view, with fresh children (the
        # batched attempt consumed the generators)
        rngs = np.random.default_rng(seed).spawn(len(cams))
    Cs = [c.project(obj_mesh, type_rec, N_rand, seed=rng)
          for c, rng in zip(cams, rngs)]
    C = sp.vstack(Cs).tocsr().astype(float)
    if n_features > 1:
        C = embed_projection(C, n_features, feature_index)
    return C
