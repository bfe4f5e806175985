"""GP-ROM training traffic: the GP reduced-order model fitted, trained and
evaluated, back to back, through the class flow of OpenMEASURE's README
(``GPR(X, F, xyz, P).fit(select_modes='number', n_modes=r)`` →
``train(max_iter, rel_error, lr)`` → ``predict(P_test)`` →
``reconstruct(A_pred)``; ``pipelines.gpr_end_to_end`` is its one-call
form, which returns no trained state).

Set-up: the configuration's training snapshots at ``m_train`` operating
points and the held-out ones at ``m_test`` are made on the card from the
seed; one flow cut to 8 Adam iterations warms every shape and kernel.
The window runs the flow (scaling → POD → r GPs, Matérn-5/2, Adam with
early stop, ``csrc/chol.cu`` every iteration → posterior at the held-out
points → reconstruction) and waits for each on the card.

The comparison: an fp32 training stops on other iterations than a
float64 one (its loss moves by round-off near the stop test), and the
hyperparameters it reaches differ by far more than round-off, so the
posterior and the fields follow the program's trained model (its basis,
coefficients and hyperparameters) and the reference recomputes them in
float64.  The stages this skips are checked by themselves: the basis by
its POD excess over the reference's float64 POD, the training by the
loss it reached against the loss of the reference's own float64
training.
"""

from __future__ import annotations

import torch

from benchmark.compare import pod_excess
from benchmark.data import flame
from benchmark.reference import gp as G
from benchmark.reference import precision
from benchmark.reference import spr as R

SPANS = ["openmeasure_torch.rom.rom:ROM.decomposition",
         "openmeasure_torch.gp.exact_gp:adam_early_stop",
         "openmeasure_torch.gp.exact_gp:gp_posterior"]
CONFIG_KEYS = {"n_cells", "n_features", "m_train", "m_test", "r", "scale_type"}
MIX_KEYS = {"max_iter", "rel_error", "lr"}


def setup(ctx):
    cfg, dev = ctx.config, ctx.device
    fs = flame.make(cfg["n_cells"], cfg["n_features"],
                    cfg["assumed"]["n_modes"], ctx.seed, dev)
    noise = cfg["assumed"]["noise"]
    P, Pt = fs.params(cfg["m_train"]), fs.params(cfg["m_test"])
    state = {"X": fs.snapshots(P, noise).to(ctx.dtype),
             "Xt": fs.snapshots(Pt, noise).to(ctx.dtype),
             "P": P.to(ctx.dtype), "Pt": Pt.to(ctx.dtype),
             "xyz": fs.xyz.cpu().numpy()}
    # a flow cut to two of the trainer's 4-iteration blocks runs every
    # shape and kernel of a whole one
    _flow(ctx, state, 8)
    return state


def _flow(ctx, state, max_iter):
    from openmeasure_torch import GPR
    cfg, mix = ctx.config, ctx.mix
    gpr = GPR(state["X"], cfg["n_features"], state["xyz"], state["P"],
              device=ctx.device)
    gpr.fit(scaleX_type=cfg["scale_type"], scaleP_type=cfg["scale_type"],
            select_modes="number", n_modes=cfg["r"])
    gpr.train(max_iter=max_iter, rel_error=mix["rel_error"], lr=mix["lr"])
    A_pred, A_sigma = gpr.predict(state["Pt"])
    return gpr, A_pred, A_sigma, gpr.reconstruct(A_pred)


def call(ctx, state, i):
    return _flow(ctx, state, ctx.mix["max_iter"])


def end_to_end(ctx, w):
    return {"gp_train_s": w.seconds / w.calls}


def counters(ctx, state, w):
    gpr = w.kept[0][1][0]
    return {"trainings": w.calls,
            "iterations": int(gpr._iterations.max()),
            "chol_shape": (ctx.config["r"], ctx.config["m_train"])}


def evidence(ctx, state, kept):
    """The kept flow's outputs and the trained model they came from (its
    basis, coefficient series, singular values and hyperparameters)."""
    gpr, A_pred, A_sigma, X_rec = kept[0][1]
    p = gpr.params
    X = state["X"]
    span = X.double().reshape(ctx.config["n_features"], -1)
    span = span.amax(dim=1) - span.amin(dim=1)
    return {"X": X, "Xt": state["Xt"], "P": state["P"], "Pt": state["Pt"],
            "span": span,
            "model": {"Ur": gpr.Ur.detach(), "Vr": gpr.Vr.detach(),
                      "Sigma": gpr.Sigma_r.detach(),
                      "iters": gpr._iterations.detach(),
                      "theta": [p["mean"]["constant"].detach(),
                                p["kernel"]["raw_lengthscale"][:, 0].detach(),
                                p["likelihood"]["raw_noise"].detach()]},
            "out": {"A_pred": A_pred, "A_sigma": A_sigma, "X_rec": X_rec}}


def outputs(ctx, ev):
    return {"model": ev["model"], **ev["out"]}


def _model_outputs(A, model, P0, Pt0, cnt, scl, jit):
    """The posterior at ``Pt0`` and the rebuilt fields of ``model``, in
    the arithmetic ``A``."""
    dt = A.dtype
    Ur, Vr, Sig = (model[k].to(dt) for k in ("Ur", "Vr", "Sigma"))
    th = [t.to(dt) for t in model["theta"]]
    with torch.no_grad():
        mean, var = G.posterior(th, P0, Vr.T, Pt0, jit, A.mm)
    A_pred = mean.T * Sig
    return {"A_pred": A_pred, "A_sigma": torch.sqrt(var).T * Sig,
            "X_rec": A.mm(Ur, A_pred.T) * scl[:, None] + cnt[:, None]}


def reference(ctx, ev, arithmetic, follow=None):
    """The reference in ``arithmetic``: its POD of the snapshots and its
    own GP training; then the posterior and the rebuilt fields of the
    model it ``follow``s (the tested side's), or of its own model where
    it follows none (as the control, in the program's place)."""
    cfg, mix = ctx.config, ctx.mix
    F, r = cfg["n_features"], cfg["r"]
    jit = G.jitter(ctx.dtype)
    with precision.arithmetic(arithmetic) as A:
        dt = A.dtype
        X = ev["X"].to(dt)
        cnt, scl = R.scale(X, F)
        X0 = (X - cnt[:, None]) / scl[:, None]
        U, S, V = R.pod(X0, r, A.mm)
        P, Pt = ev["P"].to(dt), ev["Pt"].to(dt)
        P_cnt, P_scl = P.mean(dim=0), P.std(dim=0, correction=0)
        P0, Pt0 = (P - P_cnt) / P_scl, (Pt - P_cnt) / P_scl
        theta, _, iters = G.train(P0, V.T, mix["max_iter"],
                                  mix["rel_error"], mix["lr"], jit)
        own = {"Ur": U, "Vr": V, "Sigma": S[:r], "theta": theta,
               "iters": iters}
        out = _model_outputs(A, own if follow is None else follow["model"],
                             P0, Pt0, cnt, scl, jit)
    return {"model": own, "X0": X0, "S": S, "P0": P0, "jit": jit, **out}


def compare(ctx, ev, test, ref):
    """``pred_gap`` and ``sigma_gap``: the largest gap of a predicted
    coefficient and of its σ over the largest of the reference's;
    ``field_gap``: the largest gap of a rebuilt entry over its feature's
    span; ``pod_excess``: the tested basis against the reference's POD;
    ``loss_shortfall``: per mode, the share of the reference's training
    gain (its start's loss less its trained loss, on its own series) that
    the tested training falls short of (its trained loss on its own
    series less the reference's trained loss), the worst mode: 0 where it
    trains as far, 1 where it never moved (all losses in float64)."""
    span_row = ev["span"].repeat_interleave(ctx.config["n_cells"])[:, None]
    A_t, A_r = test["A_pred"].double(), ref["A_pred"].double()
    S_t, S_r = test["A_sigma"].double(), ref["A_sigma"].double()
    X_t, X_r = test["X_rec"].double(), ref["X_rec"].double()
    m_t, m_r = test["model"], ref["model"]
    with torch.no_grad():
        L_t = G.neg_mll([t.double() for t in m_t["theta"]], ref["P0"],
                        m_t["Vr"].double().T, ref["jit"])
        Y_r = m_r["Vr"].double().T
        L_r = G.neg_mll([t.double() for t in m_r["theta"]], ref["P0"], Y_r,
                        ref["jit"])
        L_0 = G.neg_mll([torch.zeros_like(L_r)] * 3, ref["P0"], Y_r,
                        ref["jit"])
    return {"pred_gap": float((A_t - A_r).abs().max() / A_r.abs().max()),
            "sigma_gap": float((S_t - S_r).abs().max() / S_r.abs().max()),
            "field_gap": float(((X_t - X_r).abs() / span_row).max()),
            "pod_excess": pod_excess(m_t["Ur"], m_r["Ur"], ref["X0"],
                                     ref["S"], ctx.config["r"]),
            "loss_shortfall": float(((L_t - L_r) / (L_0 - L_r)).max())}
