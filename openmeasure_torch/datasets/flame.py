"""Loader for the reference 2D flame dataset layout (a numpy-only copy of
``openmeasure_tpu/datasets/flame.py``, kept inside the port so that the
port never imports the JAX package).

The reference distributes its data as ``data/ROM/`` with
``X_2D_train.npy`` (165258×41 float64), ``X_2D_test.npy`` (165258×4),
``xz.npy`` (18362×2), ``parameters_train.csv`` / ``parameters_test.csv``
(D, H2, phi) and ``mesh_outline.csv``.  The real data is zenodo
10.5281/zenodo.7786311; a checkout may hold Git-LFS pointers in their
place.

``load_flame_dataset(path)`` reads that layout, and falls back to the
synthetic generator when the files are missing or LFS stubs.
"""

from __future__ import annotations

import os

import numpy as np


def _is_lfs_pointer(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            head = f.read(60)
        return head.startswith(b"version https://git-lfs")
    except OSError:
        return True


def load_flame_dataset(path: str, allow_synthetic_fallback: bool = True,
                       dtype=np.float64) -> dict:
    """Load the reference flame dataset directory.

    Returns the schema of
    :func:`openmeasure_torch.datasets.synthetic.make_flame_dataset`:
    ``X_train, X_test, P_train, P_test, xyz, n_features`` (with
    ``mesh_outline`` when present, and the ``synthetic`` flag), host numpy
    arrays."""
    x_train_p = os.path.join(path, "X_2D_train.npy")
    if not os.path.exists(x_train_p) or _is_lfs_pointer(x_train_p):
        if not allow_synthetic_fallback:
            raise FileNotFoundError(
                f"{x_train_p} missing or a Git-LFS pointer; download the "
                "dataset from zenodo 10.5281/zenodo.7786311")
        from .synthetic import make_flame_dataset
        out = make_flame_dataset(dtype=dtype)
        out["synthetic"] = True
        return out

    X_train = np.load(x_train_p).astype(dtype)
    X_test = np.load(os.path.join(path, "X_2D_test.npy")).astype(dtype)
    xz = np.load(os.path.join(path, "xz.npy"))
    n_cells = xz.shape[0]
    xyz = np.zeros((n_cells, 3), dtype=dtype)
    xyz[:, 0] = xz[:, 0]
    xyz[:, 2] = xz[:, 1]

    P_train = np.genfromtxt(os.path.join(path, "parameters_train.csv"),
                            delimiter=",", skip_header=1).astype(dtype)
    P_test = np.genfromtxt(os.path.join(path, "parameters_test.csv"),
                           delimiter=",", skip_header=1).astype(dtype)

    out = {
        "X_train": X_train, "X_test": X_test,
        "P_train": P_train, "P_test": P_test,
        "xyz": xyz, "n_features": X_train.shape[0] // n_cells,
        "synthetic": False,
    }
    outline_p = os.path.join(path, "mesh_outline.csv")
    if os.path.exists(outline_p):
        out["mesh_outline"] = np.genfromtxt(outline_p, delimiter=",",
                                            skip_header=1)
    return out
