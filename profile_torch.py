#!/usr/bin/env python3
"""Where the time of the port's SPR and GP-ROM paths goes on one CUDA card.

Run from the root of a checkout::

    python3 profile_torch.py [qrcp] [chol] [spr] [gp] [serving] [mfk]
                             [placement] [dynamics] [ctc] [update]

With no arguments it runs every section.  ``qrcp``: the QRCP kernel's time
per call against k on random panels of the main path's shapes and layout
(``B.T`` of a row-major (n, 14) panel; n = 4,224, 165,258 and 1,723,599),
device time from the profiler's trace, with the launch plan (grid,
resident share) beside it: the slope is the cost of one pivot step, and
the small panel's slope, where every block holds 32 columns, is what the
two grid barriers and the select cost alone.  ``chol``: the batched SPD
inverse kernel's device time per launch (median of 200 launches in the
trace) on random SPD (14, p, p) batches, p = 41 (the GP trainer's shape),
17, 64 and 128, beside the wrapper's time per call with the host's part
(CUDA events over 200 back-to-back calls), and the kernel's cycles by
phase (prologue, Schur, substitution, logdet, Gram) from a build of
``csrc/chol.cu`` with ``-DCHOL_STAMPS``, whose six stamps each follow a
block barrier the shipped kernel does not have.  ``spr`` and ``gp``: for the
synthetic flame sets of ``chip_smoke.py`` — flagship (165,258 × 41, r = 14)
and 3D (1,723,599 × 45, r = 14, svd_width = 28) — it prints:

* ``spr_end_to_end`` in float64 on the card, the port's own reference:
  its NRMSE and pivots;
* the same call in fp32 at refine 1 and 2: NRMSE and how many pivots it
  shares with the float64 call (``chip_smoke.py`` times both refines);
* a ``torch.profiler`` trace of one warmed fp32 call at the default refine:
  device time by kernel, and the share of the call's window in which the
  device ran a kernel or a copy;
* the class API at the flagship size, step by step (``fit``,
  ``optimal_placement``, ``train``, ``predict``, ``reconstruct``): host wall
  time of each, synchronized, second of two runs;
* ``gpr_end_to_end`` at the flagship size (r = 14, up to 1000 Adam
  iterations): its NRMSE in float64 and fp32 on the card, and a
  ``torch.profiler`` trace of one warmed fp32 call — device busy share,
  device time by kernel, the share of ``csrc/chol.cu``, and the
  device-to-host reads per call and per Adam iteration;
* ``serving``: the flagship SPR trained with ``method='COLS'`` under the
  per-feature limits of ``chip_smoke.py`` phase 9, packaged by
  ``SoftSensor.from_spr`` (300 ADMM iterations), and one traced
  ``predict_batch`` of 50 frames for each ρ mode: device busy share, device
  time by kernel name and by kind (GEMM, factorizations and triangular
  solves, reductions, elementwise passes), launches per batch and per ADMM
  iteration, device-to-host copies, and the median device time of one GEMM
  launch (``utils/timing.device_ms``);
* ``mfk``: one traced fp32 ``mfk_end_to_end`` at configuration A of
  ``chip_smoke.py`` (K = 8 outputs, 40 LF and 15 HF sites, d = 2): device
  busy share, device time by kernel name and by kind (the chol kernel
  apart), launches per Newton step (per evaluation of the value, gradient
  and Hessian), ``csrc/chol.cu`` launches per NLL evaluation, and
  device-to-host copies;
* ``placement``: on the flagship fp32 SPR (r = 14), one traced
  ``optimal_placement`` call each for GEM (10 sensors, d_min = 0.05), DG (28
  sensors) and VDG (4 probes): device busy share, device time by kernel name
  and by kind, launches per greedy step, device-to-host copies;
* ``dynamics``: on the same model, one traced run of the decoder's trainer
  (hidden (40, 45), 20 epochs, on the QR placement's 14 sensors), one
  traced ``DecoderSensor.predict_batch`` and one traced
  ``DynamicSensor.filter_batch`` and ``smooth_batch`` of 50 frames: device
  time by kind, launches per epoch or per frame, device-to-host copies;
* ``ctc``: at ``chip_smoke.py`` phase 19's scale (a 32³ grid, a 64×64
  thin-lens camera with N_rand 8: 32,768 rays), one traced ``trace_rays``
  (launches per DDA step), ``csr_from_cells`` on its cells (the two sorts
  and the scatter), ``camera.project`` and the 4-view ``stack_cameras``, and a
  served COLS batch of 50 frames on the rig's operator: device busy share,
  device time by kind (elementwise, sorts, scatters, …), device-to-host
  copies per call;
* ``update``: on the fp32 model of ``chip_smoke.py`` phase 20 (165,258
  rows, 38 snapshots, r = 14), one traced ``svd_append_columns_eager`` with
  the 3 new scaled snapshots and one traced ``SPR.update_basis`` (rank
  kept, so repeated calls do the same work): device time by kind, launches,
  device-to-host copies.

It needs a card and stops without one.  Every number it prints was
measured on the card named on its first line.
"""

from __future__ import annotations

import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent
R = 14
N_FEATURES = 9
CUBE = dict(n_cells=191511, n_features=N_FEATURES, m_train=45, m_test=4,
            seed=1)
# device kernels by kind, matched on the lower-cased kernel name; the first
# kind that matches wins
KINDS = (("csrc/chol.cu", ("chol_inv_logdet",)),
         ("GEMM", ("gemm", "gemv", "cutlass", "xmma")),
         ("sorts", ("sort",)),
         ("scatters", ("scatter", "index_put")),
         ("factorizations and triangular solves",
          ("potrf", "potrs", "trsm", "trsv", "geqr", "orgqr", "ormqr",
           "larf", "chol", "magma", "getrf", "getrs", "lu_")),
         ("copies", ("memcpy", "memset")),
         ("concatenations", ("catarray",)),
         ("reductions", ("reduce",)),
         ("elementwise", ("elementwise", "vectorized", "unrolled", "where",
                          "clamp")))


def by_kind(by_name):
    """``{kind: [us, launches]}`` of a ``{kernel name: [us, count]}`` sum."""
    sums = defaultdict(lambda: [0.0, 0])
    for name, (us, cnt) in by_name.items():
        low = name.lower()
        kind = next((kd for kd, keys in KINDS if any(k in low for k in keys)),
                    "other")
        sums[kind][0] += us
        sums[kind][1] += cnt
    return sums


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_torch: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import numpy as np
    from openmeasure_torch import SPR
    from openmeasure_torch.datasets.synthetic import make_flame_dataset
    from openmeasure_torch.pipelines import gpr_end_to_end, spr_end_to_end
    from openmeasure_torch.utils.metrics import nrmse
    from openmeasure_torch.utils.timing import device_ms

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    known = {"qrcp", "chol", "spr", "gp", "serving", "mfk", "placement",
             "dynamics", "ctc", "update"}
    sections = set(sys.argv[1:]) or known
    unknown = sections - known
    if unknown:
        print(f"profile_torch: unknown section(s) {sorted(unknown)}",
              file=sys.stderr)
        return 2

    if "qrcp" in sections:
        from openmeasure_torch.linalg import qrcp_cuda

        print("QRCP kernel (csrc/qrcp.cu): device ms per call against k "
              "(median of 5 calls in the trace), r = 14, row-scaled B.T "
              "panels (the main path's layout)", flush=True)
        g = torch.Generator(device=dev).manual_seed(0)
        s = torch.logspace(0, 4, R, device=dev)
        for n in (4224, 165258, 1723599):
            A = torch.randn(n, R, generator=g, device=dev).T
            plan = qrcp_cuda.device_plan(R, n, R, dev)
            ts = {k: device_ms(lambda k=k: qrcp_cuda.qrcp_pivots_cuda(
                A, k, row_scale=s), "qrcp_kernel", 5)[0] for k in (1, 2, 7, 14)}
            step = (ts[14] - ts[1]) / 13
            print(f"  (14, {n}): grid {plan.grid}, "
                  f"{plan.cols_per_block} columns a block, resident "
                  f"{plan.resident_cols}/{n} "
                  f"({100.0 * plan.resident_cols / n:.1f} %), "
                  f"{plan.smem_bytes} B shared memory a block; "
                  + ", ".join(f"k={k} {t:.4f} ms" for k, t in ts.items())
                  + f"; per pivot step {1e3 * step:.2f} us, k=1 less one "
                  f"step {ts[1] - step:.4f} ms", flush=True)
            del A

    if "chol" in sections:
        from openmeasure_torch.linalg import chol_cuda

        print("chol kernel (csrc/chol.cu): device ms per launch, median of "
              "200 launches in the trace; wrapper ms per call with the "
              "host's part; cycles by phase from the -DCHOL_STAMPS build "
              "(chol_cuda.chol_phase_stamps: a stamp after a barrier at the "
              "end of each phase, six barriers more than the shipped kernel, "
              "median over the blocks of one launch after 20)", flush=True)
        phases = ("prologue", "Schur", "substitution", "logdet", "Gram")
        for p in (41, 17, 64, 128):
            rng = np.random.default_rng(p)
            Q = rng.standard_normal((R, p, p))
            K = torch.as_tensor(np.einsum("bij,bkj->bik", Q, Q) / p
                                + 0.5 * np.eye(p), dtype=torch.float32,
                                device=dev)
            call = lambda: chol_cuda.chol_inv_logdet_cuda(K)  # noqa: E731
            dev_ms, seen = device_ms(call, "chol_inv_logdet", 200)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(200):
                call()
            b.record()
            sync()
            print(f"  ({R}, {p}, {p}): device {dev_ms:.5f} ms per launch "
                  f"(median of {seen}), wrapper "
                  f"{a.elapsed_time(b) / 200:.5f} ms per call", flush=True)
            for _ in range(20):
                st = chol_cuda.chol_phase_stamps(K)[2]
            st = st.cpu().numpy()
            cyc = np.median(np.diff(st[:, :, 0], axis=1), axis=0)
            total = float(np.median(st[:, 5, 0] - st[:, 0, 0]))
            ns = float(np.median(st[:, 5, 1] - st[:, 0, 1]))
            print(f"    stamped: {total:.0f} cycles a block, "
                  f"{ns / 1e3:.3f} us ({total / ns:.3f} GHz); "
                  + ", ".join(f"{name} {c:.0f} ({100 * c / total:.1f} %)"
                              for name, c in zip(phases, cyc))
                  + f"; a Schur step {cyc[1] / p:.0f} cycles, a substitution "
                  f"step on the longest column {cyc[2] / p:.0f}", flush=True)

    def breakdown(fn, top=12):
        """Trace one warmed call of ``fn``; print the window, the device
        busy share and device time by kernel name.  Returns the per-name
        ``{name: [us, count]}`` sums and the call's window in us."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile, record_function
        fn()
        lead = torch.zeros(1, device=dev)
        sync()
        # a trace can miss its first few device events: a few small
        # launches go first, and only what starts after the call counts
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(8):
                lead.add_(1.0)
            sync()
            with record_function("profile_torch::call"):
                fn()
                sync()
        events = list(prof.events())
        t_call = min(e.time_range.start for e in events
                     if e.name == "profile_torch::call")
        # the marker itself shows on the device's timeline as a range
        events = [e for e in events if e.time_range.start >= t_call
                  and e.name != "profile_torch::call"]
        dev_ev = [e for e in events if e.device_type == DeviceType.CUDA]
        if not dev_ev:
            print("    profiler: no device events recorded", flush=True)
            return {}, 0.0
        t0 = min(e.time_range.start for e in events)
        t1 = max(e.time_range.end for e in events)
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in dev_ev)
        busy, cur_s, cur_e = 0.0, *spans[0]
        for s, e in spans[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        by_name = defaultdict(lambda: [0.0, 0])
        for e in dev_ev:
            by_name[e.name][0] += e.time_range.end - e.time_range.start
            by_name[e.name][1] += 1
        total = sum(v[0] for v in by_name.values())
        print(f"    window {(t1 - t0) / 1e3:.4f} ms, device busy "
              f"{busy / 1e3:.4f} ms ({100 * busy / (t1 - t0):.1f} %), "
              f"{len(dev_ev)} device events, summed device time "
              f"{total / 1e3:.4f} ms", flush=True)
        for name, (us, cnt) in sorted(by_name.items(),
                                      key=lambda kv: -kv[1][0])[:top]:
            print(f"      {us / 1e3:9.4f} ms {100 * us / total:5.1f} % "
                  f"x{cnt:<4d} {name[:90]}", flush=True)
        return by_name, t1 - t0


    sets = {"flagship": ({}, None),
            "3D": (CUBE, 28)}
    for tag, (kw, width) in (sets.items() if "spr" in sections else ()):
        d32 = make_flame_dataset(dtype=np.float32, **kw)
        d64 = make_flame_dataset(dtype=np.float64, **kw)
        X, T = (torch.as_tensor(d32[k], device=dev)
                for k in ("X_train", "X_test"))
        X64, T64 = (torch.as_tensor(d64[k], device=dev)
                    for k in ("X_train", "X_test"))
        print(f"{tag}: X_train {tuple(X.shape)}, r={R}, svd_width={width}",
              flush=True)
        ref = spr_end_to_end(X64, T64, N_FEATURES, R, svd_width=width)
        piv64 = ref.pivots.cpu().numpy()
        print(f"  float64 on the card: NRMSE {float(ref.nrmse):.6e}, "
              f"pivots {piv64.tolist()}", flush=True)
        for refine in (1, 2):
            res = spr_end_to_end(X, T, N_FEATURES, R, refine=refine,
                                 svd_width=width)
            same = int(np.isin(res.pivots.cpu().numpy(), piv64).sum())
            print(f"  fp32 refine={refine}: NRMSE {float(res.nrmse):.6e}, "
                  f"{same}/{R} pivots shared with float64", flush=True)
        print("  profile of one fp32 call at the default refine:",
              flush=True)
        breakdown(lambda: spr_end_to_end(X, T, N_FEATURES, R,
                                         svd_width=width))

    if "spr" in sections:
        d = make_flame_dataset(dtype=np.float32)
        T = torch.as_tensor(d["X_test"], device=dev)
        print("class API, flagship, fp32 (host wall per step, synchronized):",
              flush=True)
        for run in range(2):
            times = {}

            def step(name, fn):
                sync()
                t = time.perf_counter()
                out = fn()
                sync()
                times[name] = (time.perf_counter() - t) * 1e3
                return out

            spr = SPR(d["X_train"], N_FEATURES, d["xyz"])
            step("fit", lambda: spr.fit(select_modes="number", n_modes=R))
            C = step("optimal_placement", spr.optimal_placement)
            step("train", lambda: spr.train(C))
            rows = C.argmax(dim=1).cpu().numpy()
            ys = []
            for j in range(T.shape[1]):
                y = np.zeros((R, 3))
                y[:, 0] = d["X_test"][rows, j]
                y[:, 2] = rows // d["xyz"].shape[0]
                ys.append(y)
            ap, _ = step("predict", lambda: spr.predict(ys))
            xr = step("reconstruct", lambda: spr.reconstruct(ap))
            if run == 1:
                print("  " + ", ".join(f"{k} {v:.3f} ms" for k, v in
                                       times.items())
                      + f"; NRMSE {float(nrmse(xr, T)):.6e}", flush=True)
        print("  profile of fit:", flush=True)
        breakdown(lambda: SPR(d["X_train"], N_FEATURES, d["xyz"]).fit(
            select_modes="number", n_modes=R))

    if "gp" in sections:
        d = make_flame_dataset(dtype=np.float32)
        print("GP ROM, flagship: gpr_end_to_end (r = 14, Matérn-2.5, up to 1000 "
              "Adam iterations)", flush=True)
        d64 = make_flame_dataset(dtype=np.float64)
        keys = ("X_train", "P_train", "P_test", "X_test")
        g32 = [torch.as_tensor(d[k], device=dev) for k in keys]
        g64 = [torch.as_tensor(d64[k], device=dev) for k in keys]
        for tag, args in (("float64", g64), ("fp32", g32)):
            res = gpr_end_to_end(*args, N_FEATURES, R)
            print(f"  {tag} on the card: NRMSE {float(res.nrmse):.6e}, Adam "
                  f"iterations {res.iterations.tolist()}", flush=True)
        print("  profile of one fp32 call:", flush=True)
        by_name, window = breakdown(
            lambda: gpr_end_to_end(*g32, N_FEATURES, R), top=15)
        iters = int(res.iterations.max())
        total = sum(v[0] for v in by_name.values())
        chol = [v for k, v in by_name.items() if "chol_inv_logdet" in k]
        chol_us = sum(v[0] for v in chol)
        chol_n = sum(v[1] for v in chol)
        dtoh = sum(v[1] for k, v in by_name.items() if "DtoH" in k)
        launches = sum(v[1] for v in by_name.values())
        print(f"    csrc/chol.cu: {chol_us / 1e3:.4f} ms in {chol_n} "
              f"launches, {100 * chol_us / max(total, 1e-9):.1f} % of device "
              f"time; device-to-host copies {dtoh} per call "
              f"({dtoh / iters:.3f} per Adam iteration, {iters} iterations); "
              f"{launches} device events, {launches / iters:.1f} per "
              f"iteration; window per iteration {window / 1e3 / iters:.4f} "
              f"ms", flush=True)
    if "serving" in sections:
        from openmeasure_torch import SoftSensor
        d = make_flame_dataset(dtype=np.float32)
        npts = d["xyz"].shape[0]
        Xb = d["X_train"].astype(np.float64).reshape(N_FEATURES, npts, -1)
        f_lo, f_hi = Xb.min(axis=(1, 2)), Xb.max(axis=(1, 2))
        pad = 0.05 * (f_hi - f_lo)
        spr = SPR(d["X_train"], N_FEATURES, d["xyz"])
        spr.fit(select_modes="number", n_modes=R)
        C = spr.optimal_placement()
        spr.train(C, method="COLS", limits=[f_lo - pad, f_hi + pad])
        rows = C.argmax(dim=1).cpu().numpy()
        Y = torch.as_tensor(np.tile(d["X_test"][rows].T, (13, 1))[:50],
                            device=dev)
        print("serving, flagship COLS SoftSensor: one traced predict_batch "
              "of 50 frames, 300 ADMM iterations", flush=True)
        for mode in ("adaptive", "fixed"):
            sensor = SoftSensor.from_spr(spr, admm_rho=mode).warmup()
            print(f"  admm_rho={mode!r}:", flush=True)
            by_name, window = breakdown(lambda: sensor.predict_batch(Y),
                                        top=15)
            total = sum(v[0] for v in by_name.values())
            launches = sum(v[1] for k, v in by_name.items()
                           if "memcpy" not in k.lower()
                           and "memset" not in k.lower())
            dtoh = sum(v[1] for k, v in by_name.items() if "DtoH" in k)
            sums = by_kind(by_name)
            print("    by kind: " + "; ".join(
                f"{kd} {us / 1e3:.4f} ms ({100 * us / max(total, 1e-9):.1f} "
                f"%, {cnt} launches)" for kd, (us, cnt) in
                sorted(sums.items(), key=lambda kv: -kv[1][0])), flush=True)
            gemm_ms, gemm_n = device_ms(lambda: sensor.predict_batch(Y),
                                        "gemm", 2)
            print(f"    {launches} kernel launches per batch "
                  f"({launches / 300:.1f} per ADMM iteration); "
                  f"device-to-host copies {dtoh}; window per frame "
                  f"{window / 1e3 / 50:.5f} ms; one GEMM launch "
                  f"{gemm_ms:.5f} ms device time (median of {gemm_n})",
                  flush=True)
    if "mfk" in sections:
        from openmeasure_torch.linalg import chol_cuda
        from openmeasure_torch.multifi import mfk as mfk_mod
        from openmeasure_torch.pipelines import mfk_end_to_end
        sys.path.insert(0, str(ROOT))
        from chip_smoke import mfk_problem
        args = [torch.as_tensor(a, dtype=torch.float32, device=dev)
                for a in mfk_problem()]
        print("co-kriging, configuration A: one traced fp32 mfk_end_to_end "
              "(K = 8, 40 LF and 15 HF sites, d = 2)", flush=True)
        counts = defaultdict(int)
        real = {name: getattr(mfk_mod, name)
                for name in ("_value_grad_hess", "_level_nll_inv")}

        def counted(name):
            def call(*a):
                counts[name] += 1
                return real[name](*a)
            return call

        for name in real:
            setattr(mfk_mod, name, counted(name))
        try:
            mfk_end_to_end(*args)          # warm-up, outside the counts
            sync()
            counts.clear()
            chol_cuda.chol_inv_logdet_cuda.launches = 0
            by_name, window = breakdown(lambda: mfk_end_to_end(*args), top=15)
        finally:
            for name, fn in real.items():
                setattr(mfk_mod, name, fn)
        # breakdown runs the call twice (a warm-up, then the trace)
        steps = counts["_value_grad_hess"] // 2
        evals = counts["_level_nll_inv"] // 2
        chol_n = chol_cuda.chol_inv_logdet_cuda.launches // 2
        total = sum(v[0] for v in by_name.values())
        launches = sum(v[1] for k, v in by_name.items()
                       if "memcpy" not in k.lower()
                       and "memset" not in k.lower())
        dtoh = sum(v[1] for k, v in by_name.items() if "DtoH" in k)
        print("    by kind: " + "; ".join(
            f"{kd} {us / 1e3:.4f} ms ({100 * us / max(total, 1e-9):.1f} %, "
            f"{cnt} launches)" for kd, (us, cnt) in
            sorted(by_kind(by_name).items(), key=lambda kv: -kv[1][0])),
            flush=True)
        print(f"    {steps} Newton steps (value-gradient-Hessian "
              f"evaluations, both levels), {evals} NLL evaluations, "
              f"csrc/chol.cu launches {chol_n}; {launches} kernel launches "
              f"in the call, {launches / max(steps, 1):.1f} per Newton step; "
              f"window per Newton step {window / 1e3 / max(steps, 1):.4f} ms; "
              f"device-to-host copies {dtoh}", flush=True)
    def traced(label, fn, per, unit):
        """One traced call of ``fn``: the breakdown, device time by kind,
        launches in the call and per ``unit`` (``per`` of them), and the
        device-to-host copies."""
        print(f"  {label}:", flush=True)
        by_name, window = breakdown(fn, top=10)
        total = sum(v[0] for v in by_name.values())
        launches = sum(v[1] for k, v in by_name.items()
                       if "memcpy" not in k.lower()
                       and "memset" not in k.lower())
        dtoh = sum(v[1] for k, v in by_name.items() if "DtoH" in k)
        print("    by kind: " + "; ".join(
            f"{kd} {us / 1e3:.4f} ms ({100 * us / max(total, 1e-9):.1f} %, "
            f"{cnt} launches)" for kd, (us, cnt) in
            sorted(by_kind(by_name).items(), key=lambda kv: -kv[1][0])),
            flush=True)
        print(f"    {launches} kernel launches in the call, "
              f"{launches / per:.1f} per {unit}; window per {unit} "
              f"{window / 1e3 / per:.5f} ms; device-to-host copies {dtoh}",
              flush=True)

    if "placement" in sections or "dynamics" in sections:
        d = make_flame_dataset(dtype=np.float32)
        spr = SPR(d["X_train"], N_FEATURES, d["xyz"])
        spr.fit(select_modes="number", n_modes=R)
        C = spr.optimal_placement()
        spr.train(C)
        rows = C.argmax(dim=1).cpu().numpy()
    if "placement" in sections:
        print("placements, flagship fp32 SPR (r = 14): one traced "
              "optimal_placement call each", flush=True)
        for kind, kw, steps in (("gem", dict(n_sensors=10, d_min=0.05), 10),
                                ("dg", dict(n_sensors=28), 14),
                                ("vdg", dict(n_sensors=4), 4)):
            traced(f"{kind} {kw}",
                   lambda kind=kind, kw=kw: spr.optimal_placement(kind, **kw),
                   steps, "greedy step" + (" of phase 2" if kind == "dg"
                                           else ""))
    if "dynamics" in sections:
        from openmeasure_torch import DecoderSensor, DynamicSensor
        from openmeasure_torch import ShallowDecoder
        from openmeasure_torch.sensing import decoder as dec_mod
        print("decoder and Kalman serving, flagship fp32 SPR (r = 14, the "
              "QR placement's 14 sensors)", flush=True)
        dec = ShallowDecoder(d["X_train"], N_FEATURES, d["xyz"],
                             hidden=(40, 45))
        dec.fit(C, epochs=20, lr=3e-3)
        X0 = (torch.as_tensor(d["X_train"], device=dev) - dec.X_cnt) \
            / dec.X_scl
        Y0 = C @ X0
        p0 = [(W.clone(), b.clone()) for W, b in dec.params]
        traced("decoder trainer, 20 epochs",
               lambda: dec_mod._train(Y0.T, X0.T, p0, 20, 3e-3, 1e-6), 20,
               "epoch")
        Y = torch.as_tensor(np.tile(d["X_test"][rows].T, (13, 1))[:50],
                            device=dev)
        sensor = DecoderSensor.from_decoder(dec).warmup()
        traced("DecoderSensor.predict_batch, 50 frames",
               lambda: sensor.predict_batch(Y), 50, "frame")
        ksensor = DynamicSensor.from_spr(spr).warmup(batch=50)
        S = torch.full_like(Y, 0.05)
        for method in ("filter_batch", "smooth_batch"):
            traced(f"DynamicSensor.{method}, 50 frames, σ = 0.05",
                   lambda method=method: getattr(ksensor, method)(Y, S), 50,
                   "frame")
    if "ctc" in sections or "update" in sections:
        import importlib.util
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", ROOT / "chip_smoke.py")
        cs = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(cs)
    if "ctc" in sections:
        from openmeasure_torch import SoftSensor, ctc
        from openmeasure_torch.ctc import raytrace
        grid = ctc.VoxelGrid.from_bounds(cs.CTC_BOUNDS, cs.CTC_DIMS)
        steps = sum(cs.CTC_DIMS) + 3
        cam = cs.ctc_camera(ctc.camera)
        p1, p2, pix = cam._make_rays("thin_lens", 8, np.random.default_rng(0))
        P1, P2 = (torch.as_tensor(p, dtype=torch.float32, device=dev)
                  for p in (p1, p2))
        PIX = torch.as_tensor(pix, dtype=torch.int32, device=dev)
        print(f"CTC at chip_smoke.py phase 19's scale: a 32³ grid, "
              f"{P1.shape[0]:,} thin-lens rays (64×64, N_rand 8), "
              f"{steps} DDA steps", flush=True)
        traced("trace_rays", lambda: raytrace.trace_rays(
            P1, P2, grid.origin, grid.spacing, cs.CTC_DIMS), steps,
            "DDA step")
        cells = raytrace.trace_rays(P1, P2, grid.origin, grid.spacing,
                                    cs.CTC_DIMS)[0]
        traced("csr_from_cells (two sorts, the scatter)",
               lambda: raytrace.csr_from_cells(
                   cells, PIX, grid.n_cells, cam.n_pixels,
                   out_cap=cam.n_pixels * max(cs.CTC_DIMS)), 1, "call")
        traced("camera.project thin_lens, N_rand 8",
               lambda: cam.project(grid, "thin_lens", 8, seed=0), 1, "call")
        rig = cs.ctc_rig(ctc.camera)
        traced("stack_cameras, 4 views × 64×64 parallel",
               lambda: ctc.stack_cameras(rig, grid, "parallel", seed=0), 1,
               "call")
        C = ctc.stack_cameras(rig, grid, "parallel", seed=0)
        xyz = grid.cell_centers()
        X = cs.ctc_fields(xyz).astype(np.float32)
        spr_c = SPR(X[:, :cs.CTC_TRAIN], 1, xyz)
        spr_c.fit(select_modes="number", n_modes=cs.CTC_MODES)
        spr_c.train(C, method="COLS", **cs.CTC_METHODS["COLS"])
        sensor = SoftSensor.from_spr(
            spr_c, feature_ids=np.zeros(C.shape[0], int),
            admm_iters=cs.CTC_SERVE_ITERS).warmup()
        F = torch.as_tensor(np.stack([C @ X[:, j % 12].astype(np.float64)
                                      for j in range(50)]),
                            dtype=torch.float32, device=dev)
        traced(f"SoftSensor COLS on the rig, 50 frames, "
               f"{cs.CTC_SERVE_ITERS} ADMM iterations",
               lambda: sensor.predict_batch(F), 50, "frame")
    if "update" in sections:
        from openmeasure_torch.linalg import incremental
        X, X_new, _, xyz, _, _, _ = cs.update_data()
        spr_u = SPR(X, N_FEATURES, xyz)
        spr_u.fit(select_modes="number", n_modes=R)
        X0n = (torch.as_tensor(X_new, device=dev) - spr_u.X_cnt) \
            / spr_u.X_scl
        print(f"incremental update, chip_smoke.py phase 20's fp32 model "
              f"({X.shape[0]:,} × {X.shape[1]}, r = {R}, 3 new snapshots)",
              flush=True)
        traced("svd_append_columns_eager",
               lambda: incremental.svd_append_columns_eager(
                   spr_u.Ur, spr_u.Sigma_r, spr_u.Vr.T, X0n), 1, "call")
        traced("SPR.update_basis (rank kept)",
               lambda: spr_u.update_basis(X_new), 1, "call")
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
