"""Fitted state carried across from the JAX package's SPR, GPR and
CoKriging.

:func:`spr_from_numpy`, :func:`gpr_from_numpy`,
:func:`cokriging_from_numpy` and :func:`decoder_from_numpy` are the port's
counterpart of loading weights: each builds a fitted (and trained) port
model from the JAX model's attributes read out as numpy arrays, under the
key names of the JAX checkpoint format
(``openmeasure_tpu/utils/checkpoint.py:69-107``: attribute names, the GP
parameters flattened as ``params/<path>``, the specs as ``{"cls": name,
"fields": {...}}``; ``:235-319`` for CoKriging; ``:193-200`` and
``:445-456`` for the decoder's ``decoder/layer{i}/W`` and ``/b``).  A
``DMD`` needs no converter (its fit is deterministic: both packages fit
the same data, and :func:`dmd_from_numpy` rebuilds a saved one), and a
``DynamicSensor`` packages an SPR that :func:`spr_from_numpy` carries
across.  :mod:`openmeasure_torch.utils.checkpoint` reads the ``.npz``
checkpoint files into these converters.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..core.device import DeviceLike, as_tensor, to_numpy
from ..core.host64 import HOST, tree_f64
from ..dynamics.dmd import DMD
from ..gp import kernels as K
from ..gp.exact_gp import tree_map
from ..gp.gpr import GPR
from ..linalg.boxls import LinearConstraints
from ..multifi.cokriging import CoKriging
from ..multifi.mfk import BatchedMFK, MultiFiCoKriging, _BatchedMFKView
from ..rom.rom import ROM, apply_sampling
from ..sensing.decoder import ShallowDecoder
from ..sensing.spr import SPR

ARRAY_KEYS = ("X_cnt", "X_scl", "Ur", "Ar", "Vr", "Sigma_r", "xyz", "Theta",
              "C")
META_KEYS = ("r", "n_features", "n_points", "scale_type", "method", "solver",
             "admm_max_iter", "admm_tol", "admm_over_relax")


def _reduced_from_numpy(cls, state: Mapping[str, np.ndarray], meta: Dict,
                        device: DeviceLike):
    """A ``cls`` (ROM or a subclass built like it) holding the reduced
    state ``X_cnt``, ``X_scl``, ``Ur``, ``Ar`` (``Vr`` and ``Sigma_r``
    derived from ``Ar`` when absent) on ``device``, with a zero-memory
    placeholder for the snapshot matrix."""
    missing = [k for k in ("X_cnt", "X_scl", "Ur", "Ar") if k not in state]
    if missing:
        raise KeyError(f"{cls.__name__.lower()}_from_numpy: state lacks "
                       f"{missing}")
    n_features = int(meta["n_features"])
    n = np.asarray(state["X_cnt"]).shape[0]
    m = np.asarray(state["Ar"]).shape[0]
    placeholder = np.broadcast_to(np.zeros(()), (n, m))
    obj = cls(placeholder, n_features, state.get("xyz"), device=device)
    if "n_points" in meta and int(meta["n_points"]) != obj.n_points:
        raise ValueError(f"meta n_points={meta['n_points']} does not match "
                         f"{n} rows / {n_features} features")
    for key in ("X_cnt", "X_scl", "Ur", "Ar", "Vr", "Sigma_r"):
        if key in state:
            setattr(obj, key, as_tensor(state[key], obj.device))
    if "Sigma_r" not in state:
        obj.Sigma_r = obj.Ar.norm(dim=0)
    if "Vr" not in state:
        obj.Vr = obj.Ar / obj.Sigma_r[None, :]
    obj.r = int(meta.get("r", obj.Ar.shape[1]))
    obj.scale_type = meta.get("scale_type", "std")
    return obj


def rom_from_numpy(state: Mapping[str, np.ndarray], meta: Dict,
                   device: DeviceLike = None) -> ROM:
    """A fitted port ROM holding ``state`` (``X_cnt``, ``X_scl``, ``Ur``,
    ``Ar``, optionally ``Vr``, ``Sigma_r``, ``xyz``) on ``device``
    (``None`` means the card); ``meta`` carries ``n_features`` and
    optionally ``r``, ``n_points`` and ``scale_type``."""
    return _reduced_from_numpy(ROM, state, meta, device)


def spr_from_numpy(state: Mapping[str, np.ndarray], meta: Dict,
                   device: DeviceLike = None) -> SPR:
    """A port SPR holding ``state`` on ``device`` (``None`` means the card).

    ``state`` needs ``X_cnt``, ``X_scl``, ``Ur`` and ``Ar``; ``Vr`` and
    ``Sigma_r`` are derived from ``Ar`` when absent, as ``fit`` does.  With
    ``C`` the model is trained on it (``Theta = C @ Ur``), and a given
    ``Theta`` then replaces the recomputed one; without ``C`` a given
    ``Theta`` is kept as it is (a model trained on Theta itself).
    ``meta`` carries ``n_features`` and optionally the other
    :data:`META_KEYS`; a COLS model (``method='COLS'``) trains with its
    ``limits/lo``/``limits/hi`` and ``constraints/A``/``lo``/``hi`` arrays
    (the checkpoint's keys) and its ADMM knobs.  The snapshot matrix is
    not carried: the model's ``X`` is a zero-memory placeholder with the
    right row count."""
    spr = _reduced_from_numpy(SPR, state, meta, device)
    if state.get("C") is not None:
        limits = constraints = None
        if "limits/lo" in state:
            limits = [state["limits/lo"], state["limits/hi"]]
        if "constraints/A" in state:
            constraints = LinearConstraints(
                *(state[f"constraints/{k}"] for k in ("A", "lo", "hi")))
        spr.train(state["C"], method=meta.get("method", "OLS"),
                  limits=limits, constraints=constraints,
                  solver=meta.get("solver", "ADMM"),
                  admm_max_iter=meta.get("admm_max_iter", 4000),
                  admm_tol=meta.get("admm_tol", 1e-9),
                  admm_over_relax=meta.get("admm_over_relax", 1.6))
        if state.get("Theta") is not None:
            spr.Theta = as_tensor(state["Theta"], spr.device)
    elif state.get("Theta") is not None:
        spr.Theta = as_tensor(state["Theta"], spr.device)
        spr.C = None
    return spr


def dmd_from_numpy(state: Mapping[str, np.ndarray], meta: Dict,
                   device: DeviceLike = None) -> DMD:
    """A fitted port DMD holding ``state`` on ``device`` (``None`` means
    the card), ready to ``forecast``: the reduced state of
    :func:`rom_from_numpy` and the spectral state under the checkpoint's
    keys, ``dmd/eigs``, ``dmd/W``, ``dmd/amplitudes``, ``dmd/_b_exact``
    (host complex128), ``dmd/A_tilde`` (host float64) and ``dmd/B`` (the
    exact-mode panel, on the device); ``meta`` adds ``dt`` and ``m``."""
    dmd = _reduced_from_numpy(DMD, state, meta, device)
    for a in ("eigs", "W", "amplitudes", "_b_exact"):
        setattr(dmd, a, np.asarray(state[f"dmd/{a}"]))
    dmd.A_tilde = np.asarray(state["dmd/A_tilde"], dtype=np.float64)
    dmd._B = as_tensor(state["dmd/B"], dmd.device)
    dmd.dt = float(meta["dt"])
    dmd._m = int(meta["m"])
    with np.errstate(divide="ignore", invalid="ignore"):
        dmd.omega = np.log(dmd.eigs.astype(np.complex128)) / dmd.dt
    return dmd


GPR_ARRAY_KEYS = ("X_cnt", "X_scl", "Ur", "Ar", "Vr", "Sigma_r", "xyz", "P",
                  "P_cnt", "P_scl", "P0", "Vr_sigma", "_train_X", "_train_Y")
GPR_META_KEYS = ("r", "n_features", "gpr_type", "d", "max_iter", "rel_error",
                 "lr", "scaleX_type", "scaleP_type", "engine")
SPEC_KEYS = ("mean_spec", "kernel_spec", "likelihood_spec")

_SPEC_CLASSES = {cls.__name__: cls for cls in (
    K.ZeroMean, K.ConstantMean, K.LinearMean,
    K.RBFKernel, K.MaternKernel, K.ScaleKernel, K.LinearKernel,
    K.GaussianLikelihood, K.FixedNoiseGaussianLikelihood,
    K.MultitaskGaussianLikelihood)}


def spec_from_json(d: Optional[Dict]):
    """A port spec from the checkpoint's ``{"cls": name, "fields":
    {...}}`` form (a nested spec is ``{"__spec__": {...}}``)."""
    if d is None:
        return None
    cls = _SPEC_CLASSES[d["cls"]]
    kw = {}
    for k, v in d["fields"].items():
        if isinstance(v, dict) and "__spec__" in v:
            v = spec_from_json(v["__spec__"])
        kw[k] = v
    return cls(**kw)


def _unflatten_params(arrays: Mapping[str, Any]) -> Dict:
    """The nested parameter dict from ``params/a/b`` keys; an
    ``.../__empty__`` key stands for an empty sub-dict (ZeroMean)."""
    tree: Dict[str, Any] = {}
    for key, v in arrays.items():
        if not key.startswith("params/"):
            continue
        parts = key[len("params/"):].split("/")
        d = tree
        for part in parts[:-1]:
            d = d.setdefault(part, {})
        if parts[-1] != "__empty__":
            d[parts[-1]] = v
    return tree


def gpr_from_numpy(state: Mapping[str, np.ndarray], meta: Dict,
                   device: DeviceLike = None) -> GPR:
    """A fitted and trained port GPR holding ``state`` on ``device``
    (``None`` means the card).

    ``state`` holds the attributes of :data:`GPR_ARRAY_KEYS` that the JAX
    model has (``X_cnt``, ``X_scl``, ``Ur``, ``Ar``, ``P_cnt``, ``P_scl``
    and ``P0`` are needed; ``Sigma_r`` and ``Vr`` are derived from ``Ar``
    when absent, the training set defaults to ``(P0, Vr)``) and the GP
    parameters as ``params/...`` keys.  ``meta`` carries ``n_features``,
    ``gpr_type``, the three specs in checkpoint form (``mean_spec``,
    ``kernel_spec``, ``likelihood_spec``) and optionally the other
    :data:`GPR_META_KEYS`.  With ``engine='host'`` the trained state (the
    parameters and ``Vr_sigma``) is kept on the host in float64, where that
    engine computes.  Without ``params/`` keys the model is fitted but
    untrained.  The snapshot matrix is not carried: ``X`` is a zero-memory
    placeholder with the right shape."""
    missing = [k for k in ("X_cnt", "X_scl", "Ur", "Ar", "P_cnt", "P_scl",
                           "P0") if k not in state]
    if missing:
        raise KeyError(f"gpr_from_numpy: state lacks {missing}")
    n = np.asarray(state["X_cnt"]).shape[0]
    m = np.asarray(state["Ar"]).shape[0]
    P = np.asarray(state["P"]) if "P" in state else np.zeros((m, 1))
    placeholder = np.broadcast_to(np.zeros(()), (n, m))
    gpr = GPR(placeholder, int(meta["n_features"]), state.get("xyz"), P,
              gpr_type=meta.get("gpr_type", "SingleTask"), device=device)
    for key in GPR_META_KEYS:
        if key in meta and key not in ("n_features", "gpr_type"):
            setattr(gpr, key, meta[key])
    host = getattr(gpr, "engine", "device") == "host"
    for key in GPR_ARRAY_KEYS:
        if key in state and key not in ("xyz", "P"):
            if host and key == "Vr_sigma":
                value = tree_f64(state[key])
            else:
                value = as_tensor(state[key], gpr.device)
            setattr(gpr, key, value)
    if "Sigma_r" not in state:
        gpr.Sigma_r = gpr.Ar.norm(dim=0)
    if "Vr" not in state:
        gpr.Vr = gpr.Ar / gpr.Sigma_r[None, :]
    gpr.r = int(meta.get("r", gpr.Ar.shape[1]))
    gpr.d = int(meta.get("d", P.shape[1]))
    if not any(k.startswith("params/") for k in state):
        return gpr
    gpr.mean, gpr.kernel, gpr.likelihood = (spec_from_json(meta[k])
                                            for k in SPEC_KEYS)
    params = _unflatten_params(state)
    gpr.params = (tree_f64(params) if host else
                  tree_map(lambda a: as_tensor(a, gpr.device), params))
    if not hasattr(gpr, "_train_X"):
        gpr._train_X = gpr.P0
    if not hasattr(gpr, "_train_Y"):
        gpr._train_Y = gpr.Vr
    gpr._refresh_api_compat()
    return gpr



COK_BATCH_SCALARS = ("_X_mean", "_X_std", "_y_mean", "_y_std")
COK_LEVEL_KEYS = ("X", "Y", "F", "theta", "beta", "gamma", "sigma2", "L",
                  "G")


def cokriging_from_numpy(state: Mapping[str, np.ndarray], meta: Dict,
                         device: DeviceLike = None) -> CoKriging:
    """A fitted port CoKriging holding ``state`` on ``device`` (``None``
    means the card), ready to ``predict`` without its training snapshots.

    ``state`` has the JAX checkpoint's keys: ``attr/Ur_hf`` (and optionally
    ``attr/Zr_hf``, ``attr/Zr_aligned``), ``romhf/X_cnt``, ``romhf/X_scl``,
    ``romhf/xyz``, ``batch/{_X_mean,_X_std,_y_mean,_y_std}`` and
    ``batch/level{l}/{X,Y,F,theta,beta,gamma,sigma2,L,G}``; ``meta`` has
    ``n_features``, ``n_latent``, ``regr_type``, ``rho_regr``,
    ``normalize``, ``engine`` and ``batch = {"n_levels", "K",
    "rho_cols"}``.  With ``engine='host'`` the level state is kept on the
    host in float64, where that engine predicts; otherwise on ``device``
    in the dtype of ``attr/Ur_hf``."""
    missing = [k for k in ("attr/Ur_hf", "romhf/X_cnt", "romhf/X_scl")
               if k not in state]
    if missing:
        raise KeyError(f"cokriging_from_numpy: state lacks {missing}")
    obj = object.__new__(CoKriging)
    obj.n_features = int(meta["n_features"])
    obj.n_latent = int(meta["n_latent"])
    obj.regr_type = meta["regr_type"]
    obj.rho_regr = meta["rho_regr"]
    obj.normalize = meta["normalize"]
    obj.engine = meta.get("engine", "device")
    # the prediction-time rom_hf needs only the scaling statistics
    n = np.asarray(state["romhf/X_cnt"]).shape[0]
    rom = ROM(np.broadcast_to(np.zeros(()), (n, 1)), obj.n_features,
              state.get("romhf/xyz"), device=device)
    obj.device = rom.device
    obj.xyz_hf = state.get("romhf/xyz")
    for key in ("Ur_hf", "Zr_hf", "Zr_aligned"):
        if f"attr/{key}" in state:
            setattr(obj, key, as_tensor(state[f"attr/{key}"], rom.device))
    rom.X_cnt = as_tensor(state["romhf/X_cnt"], rom.device)
    rom.X_scl = as_tensor(state["romhf/X_scl"], rom.device)
    obj.rom_hf = rom

    bm = meta["batch"]
    host = obj.engine == "host"
    place = (HOST, torch.float64) if host else (rom.device, obj.Ur_hf.dtype)
    batch = object.__new__(BatchedMFK)
    batch._proto = MultiFiCoKriging(obj.regr_type, obj.rho_regr,
                                    normalize=obj.normalize,
                                    engine=obj.engine, device=rom.device)
    # predict re-enters the engine the level state is placed on
    batch._proto._fit_engine = obj.engine
    batch._proto._fit_place = place
    batch.n_levels = int(bm["n_levels"])
    batch.K = int(bm["K"])
    for name in COK_BATCH_SCALARS:
        setattr(batch, name, np.asarray(state[f"batch/{name}"], np.float64))
    batch.levels = []
    for l in range(batch.n_levels):
        lev = {key: as_tensor(state[f"batch/level{l}/{key}"], place[0],
                              dtype=place[1]) for key in COK_LEVEL_KEYS}
        lev["rho_cols"] = int(bm["rho_cols"][l])
        batch.levels.append(lev)
    obj._batch = batch
    obj.model_list = [_BatchedMFKView(batch, k) for k in range(obj.n_latent)]
    return obj


def decoder_from_numpy(state: Mapping[str, np.ndarray], meta: Dict,
                       device: DeviceLike = None) -> ShallowDecoder:
    """A fitted port ShallowDecoder holding ``state`` on ``device``
    (``None`` means the card), ready to ``predict``.

    ``state`` has ``X_cnt``, ``X_scl``, ``C`` and the layers as
    ``decoder/layer{i}/W`` (fan_in, fan_out) and ``decoder/layer{i}/b``
    (optionally ``xyz``); ``meta`` has ``n_features`` and ``hidden``.  The
    snapshot matrix is not carried: ``X`` is a zero-memory placeholder with
    the right row count."""
    missing = [k for k in ("X_cnt", "X_scl", "C", "decoder/layer0/W")
               if k not in state]
    if missing:
        raise KeyError(f"decoder_from_numpy: state lacks {missing}")
    n = np.asarray(state["X_cnt"]).shape[0]
    placeholder = np.broadcast_to(np.zeros(()), (n, 1))
    dec = ShallowDecoder(placeholder, int(meta["n_features"]),
                         state.get("xyz"), hidden=tuple(meta["hidden"]),
                         device=device)
    dec.X_cnt = as_tensor(state["X_cnt"], dec.device)
    dec.X_scl = as_tensor(state["X_scl"], dec.device)
    dec.C = state["C"]
    layers = []
    while f"decoder/layer{len(layers)}/W" in state:
        i = len(layers)
        layers.append((as_tensor(state[f"decoder/layer{i}/W"], dec.device),
                       as_tensor(state[f"decoder/layer{i}/b"], dec.device)))
    widths = tuple(int(W.shape[1]) for W, _ in layers[:-1])
    if widths != dec.hidden:
        raise ValueError(f"decoder_from_numpy: the layers have hidden "
                         f"widths {widths}, meta says {dec.hidden}")
    dec.params = layers
    dec._cnt_vector_cache = to_numpy(apply_sampling(dec.C, dec.X_cnt[:, 0]))
    return dec
