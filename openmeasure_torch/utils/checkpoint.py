"""Checkpoints of fitted models (port of
``openmeasure_tpu/utils/checkpoint.py``).

Every fitted model (ROM, SPR, GPR, PIGPR, CoKriging, ShallowDecoder, DMD
and the streaming fits) saves to one compressed ``.npz`` in the JAX
package's format, so a checkpoint crosses between the two packages both
ways: array attributes under ``attr/<name>``, the GP parameters under
``params/<path>``, the mean/kernel/likelihood specs as ``{"cls": name,
"fields": {...}}`` in a JSON header stored as uint8 under ``__meta__``.
The measurement operator C is saved as scipy CSR triplets (``C_sparse/``),
as COO triplets (``C_bcoo/``, indices (nnz, 2) as in a JAX BCOO) for a
torch sparse tensor, or dense (``attr/C``).  :func:`load_model` rebuilds a
ready-to-predict model through the converters of
:mod:`openmeasure_torch.utils.convert`, on ``device`` (``None`` means the
card); a streaming fit restores as its in-core class.

Documented deviation: ``backend='orbax'`` raises.  Orbax is a JAX library,
and the port runs where JAX is not installed.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

import numpy as np
import scipy.sparse as sp
import torch

from ..core.device import DeviceLike, as_tensor, resolve_device, to_numpy
from ..rom.rom import is_torch_sparse
from . import convert as _convert

_ORBAX = ("backend='orbax' is not available in openmeasure_torch: orbax "
          "checkpoints are written and read by a JAX library, and the port "
          "runs without JAX; use backend='npz' (the JAX package reads those "
          "too)")

_ARRAY_ATTRS = [
    "X_cnt", "X_scl", "Ur", "Ar", "Vr", "Sigma_r", "xyz", "Theta",
    "P", "P_cnt", "P_scl", "P0", "Vr_sigma", "_train_X", "_train_Y",
]
_META_ATTRS = ["r", "n_features", "n_points", "scale_type", "method",
               "solver", "gpr_type", "d", "max_iter", "rel_error", "lr",
               "scaleX_type", "scaleP_type", "admm_max_iter", "admm_tol",
               "admm_over_relax", "verbose", "engine"]


def _plain(v):
    """A JSON-serializable copy of a meta value (numpy and 0-d tensor
    scalars become Python numbers)."""
    if isinstance(v, torch.Tensor):
        return v.item()
    if isinstance(v, np.generic):
        return v.item()
    return v


def _spec_to_json(spec) -> Optional[Dict]:
    if spec is None:
        return None
    name = type(spec).__name__
    if name not in _convert._SPEC_CLASSES:
        raise ValueError(
            f"cannot checkpoint unregistered spec class {name!r}: "
            "load_model could not rebuild it (register it in "
            "openmeasure_torch.utils.convert._SPEC_CLASSES).")
    fields = {}
    for f in dataclasses.fields(spec):
        v = getattr(spec, f.name)
        if dataclasses.is_dataclass(v):
            fields[f.name] = {"__spec__": _spec_to_json(v)}
        else:
            fields[f.name] = _plain(v)
    return {"cls": name, "fields": fields}


def _flatten_tree(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        if not tree:
            # an EMPTY params subtree (ZeroMean's) must survive the round
            # trip, or predict misses its 'mean' key after a reload
            out[f"{prefix}/__empty__"] = np.zeros(0, dtype=np.uint8)
            return
        for k, v in tree.items():
            _flatten_tree(v, f"{prefix}/{k}", out)
    else:
        out[prefix] = to_numpy(tree)


def _save_operator(C, arrays: Dict[str, np.ndarray],
                   meta: Dict[str, Any]) -> None:
    if sp.issparse(C):
        Cc = C.tocsr()
        arrays["C_sparse/data"] = Cc.data
        arrays["C_sparse/indices"] = Cc.indices
        arrays["C_sparse/indptr"] = Cc.indptr
        meta["C_sparse_shape"] = list(Cc.shape)
    elif is_torch_sparse(C):
        # torch COO keeps indices as (ndim, nnz), BCOO as (nnz, ndim)
        Cc = C.to_sparse_coo().coalesce()
        arrays["C_bcoo/data"] = to_numpy(Cc.values())
        arrays["C_bcoo/indices"] = np.ascontiguousarray(
            to_numpy(Cc.indices()).T)
        meta["C_bcoo_shape"] = list(Cc.shape)
    else:
        arrays["attr/C"] = to_numpy(C)


def _load_operator(arrays: Dict[str, np.ndarray], meta: Dict[str, Any],
                   device: torch.device):
    """C from its checkpoint form: scipy CSR, a torch sparse COO tensor on
    ``device`` (from BCOO triplets), a dense array, or None."""
    if "C_sparse_shape" in meta:
        return sp.csr_matrix(
            (arrays["C_sparse/data"], arrays["C_sparse/indices"],
             arrays["C_sparse/indptr"]),
            shape=tuple(meta["C_sparse_shape"]))
    if "C_bcoo_shape" in meta:
        idx = as_tensor(arrays["C_bcoo/indices"].T.astype(np.int64), device)
        return torch.sparse_coo_tensor(
            idx, as_tensor(arrays["C_bcoo/data"], device),
            size=tuple(meta["C_bcoo_shape"])).coalesce()
    return arrays.get("attr/C")


def save_model(obj, path: str, include_data: bool = False,
               backend: str = "npz") -> None:
    """Save a fitted ROM/SPR/GPR/PIGPR/CoKriging/ShallowDecoder/DMD (or a
    streaming fit) as one compressed ``.npz`` at ``path`` (no suffix is
    appended).  ``include_data=True`` also saves an in-core ``X``."""
    if backend == "orbax":
        raise NotImplementedError(_ORBAX)
    if backend != "npz":
        raise ValueError(f"unknown checkpoint backend {backend!r}")
    arrays: Dict[str, np.ndarray] = {}
    meta: Dict[str, Any] = {"class": type(obj).__name__}

    if type(obj).__name__ == "CoKriging":
        _save_cokriging(obj, arrays, meta)
        _write_arrays(arrays, meta, path)
        return

    for a in _ARRAY_ATTRS:
        if getattr(obj, a, None) is not None:
            arrays[f"attr/{a}"] = to_numpy(getattr(obj, a))
    if "attr/X_cnt" not in arrays:
        raise ValueError(
            f"{type(obj).__name__} must be fit() before saving "
            "(no fitted state to serialize).")
    for a in _META_ATTRS:
        if hasattr(obj, a):
            meta[a] = _plain(getattr(obj, a))
    if include_data and hasattr(obj, "X"):
        if not isinstance(obj.X, (np.ndarray, torch.Tensor)):
            raise ValueError(
                "include_data=True needs an in-core X; streaming models "
                "keep snapshots on disk — save with include_data=False.")
        arrays["attr/X"] = to_numpy(obj.X)

    if getattr(obj, "limits", None) is not None:
        arrays["limits/lo"] = to_numpy(obj.limits[0])
        arrays["limits/hi"] = to_numpy(obj.limits[1])
    if getattr(obj, "constraints", None) is not None:
        for k in ("A", "lo", "hi"):
            arrays[f"constraints/{k}"] = to_numpy(getattr(obj.constraints,
                                                          k))
    if getattr(obj, "C", None) is not None:
        _save_operator(obj.C, arrays, meta)

    if type(obj).__name__ in ("DMD", "StreamingDMD"):
        # complex spectral state (npz keeps complex128); a streaming fit
        # restores as the in-core DMD
        for a in ("eigs", "W", "amplitudes", "_b_exact"):
            arrays[f"dmd/{a}"] = np.asarray(getattr(obj, a))
        arrays["dmd/A_tilde"] = np.asarray(obj.A_tilde, dtype=np.float64)
        arrays["dmd/B"] = to_numpy(obj._B)
        meta["dt"] = float(obj.dt)
        meta["m"] = int(obj._m)

    if type(obj).__name__ == "ShallowDecoder":
        # the MLP's layers are a LIST of (W, b) pairs
        if not hasattr(obj, "params"):
            raise ValueError("ShallowDecoder must be fit() before saving")
        for i, (W, b) in enumerate(obj.params):
            arrays[f"decoder/layer{i}/W"] = to_numpy(W)
            arrays[f"decoder/layer{i}/b"] = to_numpy(b)
        meta["hidden"] = [int(h) for h in obj.hidden]
    elif hasattr(obj, "params"):
        _flatten_tree(obj.params, "params", arrays)
        for key, attr in zip(_convert.SPEC_KEYS,
                             ("mean", "kernel", "likelihood")):
            meta[key] = _spec_to_json(getattr(obj, attr, None))

    _write_arrays(arrays, meta, path)


def _write_arrays(arrays: Dict[str, np.ndarray], meta: Dict[str, Any],
                  path: str) -> None:
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                       dtype=np.uint8)
    # through a file OBJECT so numpy does not append '.npz' to a
    # suffixless path (save and load with the same string must work)
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)


def _save_cokriging(obj, arrays: Dict[str, np.ndarray],
                    meta: Dict[str, Any]) -> None:
    """CoKriging's fitted state: the HF scaling statistics, the aligned
    basis and every level of the batched kriging model — enough to predict
    without the training snapshot sets."""
    if not hasattr(obj, "_batch"):
        raise ValueError("CoKriging must be fit() before saving")
    arrays["attr/Ur_hf"] = to_numpy(obj.Ur_hf)
    arrays["attr/Zr_hf"] = to_numpy(obj.Zr_hf)
    arrays["attr/Zr_aligned"] = to_numpy(obj.Zr_aligned)
    arrays["romhf/X_cnt"] = to_numpy(obj.rom_hf.X_cnt)
    arrays["romhf/X_scl"] = to_numpy(obj.rom_hf.X_scl)
    arrays["romhf/xyz"] = np.asarray(obj.xyz_hf)
    meta.update(n_features=int(obj.n_features), n_latent=int(obj.n_latent),
                regr_type=obj.regr_type, rho_regr=obj.rho_regr,
                normalize=bool(obj.normalize),
                engine=getattr(obj, "engine", "device"))
    b = obj._batch
    meta["batch"] = {"n_levels": int(b.n_levels), "K": int(b.K),
                     "rho_cols": [int(lev["rho_cols"]) for lev in b.levels]}
    for name in _convert.COK_BATCH_SCALARS:
        arrays[f"batch/{name}"] = np.asarray(getattr(b, name))
    for l, lev in enumerate(b.levels):
        for key in _convert.COK_LEVEL_KEYS:
            arrays[f"batch/level{l}/{key}"] = to_numpy(lev[key])


_GPR_CLASSES = ("GPR", "PIGPR", "StreamingGPR", "StreamingPIGPR")


def load_model(path: str, device: DeviceLike = None):
    """Rebuild a model saved by :func:`save_model` (or by the JAX
    package's ``save_model``) on ``device`` (``None`` means the card),
    ready to predict and reconstruct without refitting or retraining.

    A streaming fit restores as its in-core class, a PIGPR as a GPR (its
    added loss is a function, not state), as in the JAX package.  Arrays
    keep their saved dtype; a host-engine GP keeps its trained state in
    host float64.  An orbax checkpoint directory raises."""
    if os.path.isdir(path):
        raise NotImplementedError(_ORBAX)
    dev = resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(bytes(arrays.pop("__meta__")).decode())
    cls_name = meta["class"]
    if cls_name == "CoKriging":
        return _convert.cokriging_from_numpy(arrays, meta, dev)

    state = {(k[len("attr/"):] if k.startswith("attr/") else k): v
             for k, v in arrays.items()}
    state.pop("C", None)
    C = _load_operator(arrays, meta, dev)
    if C is not None:
        state["C"] = C
    if cls_name in ("ROM", "StreamingROM"):
        obj = _convert.rom_from_numpy(state, meta, dev)
    elif cls_name in ("SPR", "StreamingSPR"):
        obj = _convert.spr_from_numpy(state, meta, dev)
    elif cls_name in _GPR_CLASSES:
        obj = _convert.gpr_from_numpy(state, meta, dev)
    elif cls_name in ("DMD", "StreamingDMD"):
        obj = _convert.dmd_from_numpy(state, meta, dev)
    elif cls_name == "ShallowDecoder":
        obj = _convert.decoder_from_numpy(state, meta, dev)
    else:
        raise ValueError(f"unknown checkpointed class {cls_name!r}")
    if "X" in state:
        obj.X = state["X"]
    return obj
