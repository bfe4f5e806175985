"""Fit traffic: the whole soft-sensing fit, called back to back.

Set-up: the configuration's training and held-out snapshots are made on
the card from the seed and kept there.  The window calls
``pipelines.spr_end_to_end(X_train, X_test, F, r, svd_width=...)``
(scaling → Gram-SVD → QRCP placement → gappy-POD solve → reconstruction
of the held-out snapshots and their NRMSE) and waits for each call on the
card before the next.

The comparison follows the program's fit: an fp32 Gram-route basis
leaves its trailing modes a few 1e-4 off in some seeds, as much as TF32
arithmetic moves the reconstruction, so the reconstruction is judged
from the program's own basis and sensors, which the benchmark takes from
the timed call itself (it keeps the panel and row scale that
``spr_end_to_end`` hands to the QR placement).  The stages that this
skips are judged by themselves: the basis by its POD excess over the
reference's float64 POD, and the placement by how far each pivot falls
short of the greedy choice on that basis.
"""

from __future__ import annotations

import torch

from benchmark.compare import pod_excess
from benchmark.data import flame
from benchmark.reference import precision
from benchmark.reference import spr as R

SPANS = ["openmeasure_torch.core.scaling:scale_data",
         "openmeasure_torch.linalg.svd:svd_tall",
         "openmeasure_torch.pipelines:qrcp_pivots_auto"]
CONFIG_KEYS = {"n_cells", "n_features", "m_train", "m_test", "r", "svd_width",
               "scale_type"}
MIX_KEYS = set()


def _keep_placement_inputs(state):
    """Wrap the placement ``spr_end_to_end`` calls so that each call's
    basis panel (Bᵀ, a view) and row scale are kept with its pivots."""
    from openmeasure_torch import pipelines
    inner = pipelines.qrcp_pivots_auto

    def kept(Bt, k, row_scale=None, **kw):
        piv = inner(Bt, k, row_scale=row_scale, **kw)
        state["placement"] = (Bt, row_scale, piv)
        return piv
    pipelines.qrcp_pivots_auto = kept
    state["restore"] = lambda: setattr(pipelines, "qrcp_pivots_auto", inner)


def setup(ctx):
    cfg, dev = ctx.config, ctx.device
    fs = flame.make(cfg["n_cells"], cfg["n_features"],
                    cfg["assumed"]["n_modes"], ctx.seed, dev)
    noise = cfg["assumed"]["noise"]
    Xtr = fs.snapshots(fs.params(cfg["m_train"]), noise).to(ctx.dtype)
    Xte = fs.snapshots(fs.params(cfg["m_test"]), noise).to(ctx.dtype)
    state = {"X": Xtr, "Xt": Xte}
    _keep_placement_inputs(state)
    for i in range(2):
        call(ctx, state, i)
    return state


def call(ctx, state, i):
    from openmeasure_torch.pipelines import spr_end_to_end
    cfg = ctx.config
    out = spr_end_to_end(state["X"], state["Xt"], cfg["n_features"],
                         cfg["r"], scale_type=cfg["scale_type"],
                         svd_width=cfg.get("svd_width"), device=ctx.device)
    return out, state["placement"]


def end_to_end(ctx, w):
    return {"fit_ms": w.seconds / w.calls * 1e3}


def counters(ctx, state, w):
    cfg = ctx.config
    n = cfg["n_cells"] * cfg["n_features"]
    return {"fits": w.calls, "qrcp_shape": (cfg["r"], n, cfg["r"])}


def evidence(ctx, state, kept):
    state["restore"]()
    out, (Bt, dinv, piv) = kept[0][1]
    X = state["X"]
    span = X.double().reshape(ctx.config["n_features"], -1)
    span = span.amax(dim=1) - span.amin(dim=1)
    return {"X": X, "Xt": state["Xt"], "span": span,
            "out": {"X_rec": out.X_rec, "piv": out.pivots.long(),
                    "ev": out.exp_variance,
                    "U": (Bt * dinv[:, None]).T, "placed": piv.long()}}


def outputs(ctx, ev):
    return ev["out"]


def reference(ctx, ev, arithmetic, follow=None):
    """In ``arithmetic``: the reference's scaling and POD, its own greedy
    pivots and its reconstruction at them (what the control hands out in
    the program's place); with ``follow``, also the reconstruction from
    the followed basis at the followed pivots."""
    cfg = ctx.config
    F, r = cfg["n_features"], cfg["r"]
    with precision.arithmetic(arithmetic) as A:
        X, Xt = ev["X"].to(A.dtype), ev["Xt"].to(A.dtype)
        cnt, scl = R.scale(X, F)
        X0 = (X - cnt[:, None]) / scl[:, None]
        U, S, _ = R.pod(X0, r, A.mm)
        piv = R.qr_pivots(U, r, A.mm)
        out = {"X_rec": R.reconstruct_from_sensors(U, cnt, scl, piv,
                                                   Xt[piv], A.mm),
               "piv": piv, "placed": piv, "U": U, "X0": X0, "S": S,
               "ev": R.explained_variance(S)[:r]}
        if follow is not None:
            Uf = follow["U"].to(A.dtype)
            pf = follow["piv"].clamp(0, Uf.shape[0] - 1)
            out["X_follow"] = R.reconstruct_from_sensors(Uf, cnt, scl, pf,
                                                         Xt[pf], A.mm)
    return out


def _shares(cum: torch.Tensor) -> torch.Tensor:
    cum = cum.double()
    return torch.diff(cum, prepend=cum.new_zeros(1))


def compare(ctx, ev, test, ref):
    """``rec_gap``: the largest gap of a reconstructed held-out entry from
    the reference's reconstruction with the tested basis and pivots, over
    its feature's span; ``pod_excess``: the tested basis against the
    reference's POD (``benchmark/compare.py``); ``pivot_slack``: how far a
    tested pivot's residual norm falls short of the largest at its step,
    on the tested basis in float64, the worst step; ``pivot_faults``: the
    pivots repeated or out of range, and ``rec_nonfinite``: the
    reconstructed entries that are not finite (both compared exactly);
    ``ev_gap``: the largest gap of a mode's share of the variance over the
    first mode's share (a reading, with the NRMSE ratio to the reference's
    own placement, never compared)."""
    cfg = ctx.config
    Xt = ev["Xt"].double()
    piv = test["piv"]
    n = Xt.shape[0]
    span_row = ev["span"].repeat_interleave(cfg["n_cells"])[:, None]
    X_t = test["X_rec"].double()
    e_t, e_r = _shares(test["ev"]), _shares(ref["ev"])
    bad = int(piv.numel() - torch.unique(piv).numel()
              + ((piv < 0) | (piv >= n)).sum()
              + (piv != test["placed"]).sum())
    return {"rec_gap": float(((X_t - ref["X_follow"].double()).abs()
                              / span_row).max()),
            "pod_excess": pod_excess(test["U"], ref["U"], ref["X0"],
                                     ref["S"], cfg["r"]),
            "pivot_slack": R.pivot_slack(test["U"].double(), test["placed"]),
            "pivot_faults": bad,
            "rec_nonfinite": int((~torch.isfinite(X_t)).sum()),
            "ev_gap": float((e_t - e_r).abs().max() / e_r[0]),
            "nrmse_ratio": float(R.nrmse(X_t, Xt)
                                 / R.nrmse(ref["X_rec"].double(), Xt))}
