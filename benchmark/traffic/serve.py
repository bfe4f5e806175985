"""Serving traffic: a fitted soft sensor answers batches of frames.

Set-up (not timed): the configuration's training snapshots are made on
the card from the seed; ``SPR.fit`` (r modes) → ``optimal_placement('qr')``
→ ``train(C, method=...)`` (COLS under per-feature limits: the training
set's minimum and maximum of each feature, padded outward by
``limit_pad`` of its span) → ``SoftSensor.from_spr``.  A pool of
``pool`` fresh snapshots, at operating points drawn from the seed, is read
at the sensors: each reading gets a standard deviation of a share, drawn
from ``sigma_rel``, of its feature's scale, and noise of that size.

The window: one client in a closed loop submits ``batch`` frames at a
time, cycling through the pool, to ``SoftSensor.predict_batch`` and waits
for its outputs on the card.

The comparison follows the program's fitted model: the fp32 basis and
its sensor rows are the program's (an fp32 fit's last pivots and modes
may round to other choices than float64's, and the fixed-budget ADMM's
answer depends on the basis), so the reference serves the same frames
from that basis and those rows in float64, from its own scaling of the
same snapshots.  The fit that this skips is checked by itself: the
program's basis against the reference's own float64 POD of the snapshots.
"""

from __future__ import annotations

import torch

from benchmark.compare import pod_excess
from benchmark.data import flame
from benchmark.reference import precision
from benchmark.reference import spr as R

SPANS = ["openmeasure_torch.serving:_predict_math",
         "openmeasure_torch.linalg.boxls:box_constrained_lstsq"]
CONFIG_KEYS = {"n_cells", "n_features", "m_train", "r", "scale_type"}
MIX_KEYS = {"method", "batch", "pool", "admm_iters", "admm_rho", "limit_pad",
            "sigma_rel"}


def _feature_limits(X64: torch.Tensor, n_features: int, pad: float):
    Xb = X64.reshape(n_features, -1)
    lo, hi = Xb.amin(dim=1), Xb.amax(dim=1)
    span = hi - lo
    return lo - pad * span, hi + pad * span, span


def setup(ctx):
    from openmeasure_torch import SPR, SoftSensor
    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    F, r = cfg["n_features"], cfg["r"]
    fs = flame.make(cfg["n_cells"], F, cfg["assumed"]["n_modes"], ctx.seed,
                    dev)
    noise = cfg["assumed"]["noise"]
    X = fs.snapshots(fs.params(cfg["m_train"]), noise).to(ctx.dtype)
    lo, hi, span = _feature_limits(X.double(), F, mix.get("limit_pad", 0.0))

    spr = SPR(X, F, fs.xyz.cpu().numpy(), device=dev)
    spr.fit(scale_type=cfg["scale_type"], select_modes="number", n_modes=r)
    C = spr.optimal_placement("qr")
    if mix["method"] == "COLS":
        spr.train(C, method="COLS",
                  limits=[lo.cpu().numpy(), hi.cpu().numpy()])
        sensor = SoftSensor.from_spr(spr, dtype=ctx.dtype,
                                     admm_iters=mix["admm_iters"],
                                     admm_rho=mix["admm_rho"])
    else:
        spr.train(C)
        sensor = SoftSensor.from_spr(spr, dtype=ctx.dtype)
    piv = C.argmax(dim=1)

    # the pool of frames: fresh snapshots read at the sensors
    P = fs.params(mix["pool"])
    truth = fs.fields_at(piv, P, noise).T                   # (pool, s)
    a, b = mix["sigma_rel"]
    share = a + (b - a) * torch.rand(truth.shape, generator=fs.gen,
                                     dtype=torch.float64, device=dev)
    sig = share * fs.scales[piv // cfg["n_cells"]]
    Y = truth + sig * torch.randn(truth.shape, generator=fs.gen,
                                  dtype=torch.float64, device=dev)
    state = {"spr": spr, "sensor": sensor, "X": X, "piv": piv,
             "lo": lo, "hi": hi, "span": span,
             "Y": Y.to(ctx.dtype), "S": sig.to(ctx.dtype)}
    for i in range(2):                       # the cell's one batch shape
        call(ctx, state, i)
    return state


def _frames(ctx, state, i):
    B = ctx.mix["batch"]
    k = (i * B) % ctx.mix["pool"]
    return state["Y"][k:k + B], state["S"][k:k + B]


def call(ctx, state, i):
    Y, S = _frames(ctx, state, i)
    return state["sensor"].predict_batch(Y, S)


def end_to_end(ctx, w):
    import statistics
    lat = sorted(w.latencies)
    p90 = (statistics.quantiles(lat, n=10, method="inclusive")[8]
           if len(lat) > 1 else lat[0])
    return {"frames_per_s": w.calls * ctx.mix["batch"] / w.seconds,
            "batch_ms_p90": p90 * 1e3}


def counters(ctx, state, w):
    return {"batches": w.calls, "batch": ctx.mix["batch"],
            "admm_iters": (ctx.mix["admm_iters"]
                           if ctx.mix["method"] == "COLS" else 0)}


def evidence(ctx, state, kept):
    """What the comparison needs, the program's objects dropped: the
    snapshots, the program's basis and sensor rows, the kept batches'
    frames and outputs."""
    frames = [_frames(ctx, state, i) for i, _ in kept]
    return {"X": state["X"], "Ur": state["spr"].Ur.detach().clone(),
            "piv": state["piv"], "lo": state["lo"], "hi": state["hi"],
            "span": state["span"], "frames": frames,
            "out": [o for _, o in kept]}


def outputs(ctx, ev):
    return {"U": ev["Ur"], "served": ev["out"]}


def reference(ctx, ev, arithmetic, follow=None):
    """The reference's POD of the snapshots and its serving of the kept
    frames from the program's basis and rows, in ``arithmetic`` (the
    served stage alone is timed, so the control, too, serves from the
    program's fit)."""
    cfg, mix = ctx.config, ctx.mix
    F, r = cfg["n_features"], cfg["r"]
    with precision.arithmetic(arithmetic) as A:
        dt = A.dtype
        X = ev["X"].to(dt)
        cnt, scl = R.scale(X, F)
        X0 = (X - cnt[:, None]) / scl[:, None]
        U, S_all, _ = R.pod(X0, r, A.mm)
        Ur = ev["Ur"].to(dt)
        kw = {}
        if mix["method"] == "COLS":
            lo, hi = R.scale_limits(ev["lo"].to(dt), ev["hi"].to(dt), cnt,
                                    scl, F)
            kw = dict(lo=lo, hi=hi, iters=mix["admm_iters"],
                      adapt=mix["admm_rho"] == "adaptive",
                      eps=torch.finfo(ctx.dtype).eps)
        served = [R.serve(Ur, ev["piv"], cnt, scl, Y.to(dt), S.to(dt),
                          mix["method"], mm=A.mm, **kw)
                  for Y, S in ev["frames"]]
    return {"U": U, "S": S_all, "X0": X0, "served": served}


def compare(ctx, ev, test, ref):
    """Per served frame: its field gap (the largest gap of an entry over
    its feature's span in the snapshots), its coefficient gap and its σ
    gap (the largest gap over the largest of the reference's in the
    batch).  The numbers are the 95th percentile (``_p95``) and the
    largest (``_max``) of those over the kept frames, and ``pod_excess``,
    the fit's basis against the reference's POD
    (:func:`benchmark.compare.pod_excess`).

    The adaptive ADMM doubles or halves ρ where one residual passes ten
    times the other; on a few frames that test falls within round-off of
    10 at some iteration, fp32 and float64 take the other branch, and the
    frame's 300th iterate differs by the budget's distance from
    convergence, not by round-off.  So the field and coefficient gaps are
    judged at their 95th percentile, beyond which those few frames lie
    and which a fault in a tenth of a batch's frames reaches; the σ, which
    never touches the ADMM, by its largest."""
    span_row = ev["span"].repeat_interleave(ctx.config["n_cells"])
    fg, cg, sg = [], [], []
    for (x, a, s), (xr, ar, sr) in zip(test["served"], ref["served"]):
        fg.append(((x.double() - xr).abs() / span_row).amax(dim=1))
        cg.append((a.double() - ar).abs().amax(dim=1) / ar.abs().max())
        sg.append((s.double() - sr).abs().amax(dim=1) / sr.abs().max())
    out = {}
    for name, v in (("field_gap", fg), ("coef_gap", cg), ("sigma_gap", sg)):
        v = torch.cat(v)
        out[f"{name}_p95"] = float(torch.quantile(v, 0.95))
        out[f"{name}_max"] = float(v.max())
    out["pod_excess"] = pod_excess(test["U"], ref["U"], ref["X0"], ref["S"],
                                   ctx.config["r"])
    return out
