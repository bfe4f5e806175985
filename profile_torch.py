#!/usr/bin/env python3
"""Where the time of the port's SPR and GP-ROM paths goes on one CUDA card.

Run from the root of a checkout::

    python3 profile_torch.py [qrcp] [spr] [gp]

With no arguments it runs every section.  ``qrcp``: the QRCP kernel's time
per call against k on random panels of the main path's shapes and layout
(``B.T`` of a row-major (n, 14) panel; n = 4,224, 165,258 and 1,723,599),
device time from the profiler's trace, with the launch plan (grid,
resident share) beside it: the slope is the cost of one pivot step, and
the small panel's slope, where every block holds 32 columns, is what the
two grid barriers and the select cost alone.  ``spr`` and ``gp``: for the
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
  device-to-host reads per call and per Adam iteration.

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

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    sections = set(sys.argv[1:]) or {"qrcp", "spr", "gp"}
    unknown = sections - {"qrcp", "spr", "gp"}
    if unknown:
        print(f"profile_torch: unknown section(s) {sorted(unknown)}",
              file=sys.stderr)
        return 2

    if "qrcp" in sections:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        from openmeasure_torch.linalg import qrcp_cuda

        def kernel_ms(fn, reps=5):
            """Mean device time of the qrcp kernel over reps calls of fn,
            from the profiler's trace (the host's time per call does not
            enter)."""
            fn()
            sync()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                sync()
            us = [e.time_range.end - e.time_range.start
                  for e in prof.events() if e.device_type == DeviceType.CUDA
                  and "qrcp_kernel" in e.name]
            return sum(us) / len(us) / 1e3 if us else float("nan")

        print("QRCP kernel (csrc/qrcp.cu): device ms per call against k, "
              "r = 14, row-scaled B.T panels (the main path's layout)",
              flush=True)
        g = torch.Generator(device=dev).manual_seed(0)
        s = torch.logspace(0, 4, R, device=dev)
        for n in (4224, 165258, 1723599):
            A = torch.randn(n, R, generator=g, device=dev).T
            plan = qrcp_cuda.device_plan(R, n, R, dev)
            ts = {k: kernel_ms(lambda k=k: qrcp_cuda.qrcp_pivots_cuda(
                A, k, row_scale=s)) for k in (1, 2, 7, 14)}
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

    def breakdown(fn, top=12):
        """Trace one warmed call of ``fn``; print the window, the device
        busy share and device time by kernel name.  Returns the per-name
        ``{name: [us, count]}`` sums and the call's window in us."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        fn()
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            sync()
        events = list(prof.events())
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
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
