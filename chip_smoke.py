#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``openmeasure_torch``) on one card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``openmeasure_torch/csrc`` (and its
host C++ ray caster from ``openmeasure_torch/native``), holds
each kernel against its plain PyTorch version on the card, and drives two
paths through their user entry points:

* SPR soft sensing — ``spr_end_to_end`` at the flagship size (165,258 × 41
  synthetic flame snapshots, r = 14) and at the 3D size (1,723,599 × 45,
  r = 14, svd_width = 28), and the class API ``SPR.fit → optimal_placement
  → train → predict → reconstruct`` at the flagship size;
* the GP ROM — ``gpr_end_to_end`` at the flagship size (41 training and 4
  test snapshots with 3 parameters each, r = 14, Matérn-2.5, up to 1000
  Adam iterations), the class API ``GPR.fit → train → predict →
  reconstruct`` for SingleTask and MultiTask, and one ``engine='host'``
  run held against the port's float64 CPU result;
* multifidelity — ``mfk_end_to_end`` at the JAX benchmark's co-kriging
  size (K = 8 outputs, 40 LF and 15 HF sites, d = 2), fp32 against float64
  on the card; ``CoKriging`` at flagship width (the flagship's first 15
  snapshots as HF, a low-fidelity set of every 4th cell at all 41
  conditions, 8 modes a side) against float64 and the truth, and its
  ``CoKrigingSensor``; ``PIGPR`` at flagship width against a plain
  MultiTask GPR; ``GPR.update`` with and without a fixed-noise retrain;
* serving — the flagship SPR trained with ``method='COLS'`` under
  per-feature limits and packaged by ``SoftSensor.from_spr`` (300 ADMM
  iterations, adaptive and fixed ρ, batches of 50 frames), held against a
  float64 sensor of the same model on the card, once with limits padded
  outward (the timed configuration) and once padded inward so that they
  bind, the fp32 batches running the ADMM kernel pair of
  ``csrc/admm.cu``, timed at the serving shape beside its bound and its
  plain version, and an OLS sensor against ``SPR.predict``;
  ``GPRSensor.from_gpr`` on the MultiTask model, without
  and with limits, against the eager ``GPR.predict``, its requests
  launching no ``csrc/chol.cu``; ``ROM.CPOD`` on the
  41 flagship snapshots;
* the other placements (phase 16) at flagship width through
  ``SPR.optimal_placement``: GEM (10 sensors, d_min = 0.05), D-optimal DG
  (28 sensors, its phase 1 one ``csrc/qrcp.cu`` launch bit-equal to the
  plain sweep) and vector probes VDG (4 × 9 features), each fp32
  selection's objective held against float64 arithmetic's on the same
  basis, its host reads against the JAX code's, and the held-out gappy-POD
  NRMSE of each sensor set;
* the shallow decoder (phase 17): ``ShallowDecoder`` (hidden (40, 45), 2000
  epochs) on the QR sensors and on the probes, fp32 against float64 from
  the same initial weights, no host read in training, and its
  ``DecoderSensor`` at batch 50 with no host read, against ``predict``;
* the temporal layer (phase 18): ``DMD`` on the dynamics example's series
  (fp32 eigenvalues against float64 at the same rank), ``DynamicSensor``
  against the memoryless ``SoftSensor`` under 50 % sensor noise, and
  ``DynamicSensor.from_spr`` on the flagship model at batch 50: filter and
  smoother against a float64 sensor, with no host read in a batch;
* CTC tomography (phase 19) at the reference's scale: a 32³ ``VoxelGrid``,
  a 64×64 camera (parallel, pinhole and thin lens with N_rand 8) and a
  4-view rig through ``stack_cameras``, the operators from the card held
  equal to the port's CPU run and read back in one copy each; SPR OLS and
  COLS on the rig's operator (a torch sparse tensor on the card) within
  1.10× of the JAX package's float64 held-out NRMSE; the COLS model served
  by ``SoftSensor`` at batch 50 with no host read; an embedded two-feature
  rig; ``resample_to_grid`` at the 3D example's scale; an
  ``UnstructuredMesh`` hexahedral copy of a 16³ grid (the host C++ caster)
  giving the grid's operator.  No TPU kernel lies on this path;
* the incremental update (phase 20) at flagship width:
  ``SPR.update_basis`` (38 + 3 snapshots, r = 14 → 15), the placement after
  it (a ``csrc/qrcp.cu`` launch), fp32 against float64 in the singular
  values, the principal angles and the held-out NRMSE against a full
  refit, and ``GPR.update_basis(retrain=True)`` (``csrc/chol.cu``);
* the out-of-core tier (phases 21–25), from ``.npy`` files written under
  ``build/`` and deleted at the end: the 3D set (1,723,599 rows × 45) as
  one matrix file and as 45 column files, fitted by ``StreamingSPR`` with
  the host engine on both layouts and the device engine on one, each
  held per mode (σ and the principal angle) against the card's float64
  fit; its ``optimal_placement('qr')`` (one ``csrc/qrcp.cu`` launch at the
  3D width, equal to the plain sweep), train, predict and reconstruct; the
  fit's walls with prefetch 2 and 0, a bare disk pass and the upload;
  ``median`` scaling from column files in chunks that cut feature blocks,
  equal to the in-core ``scale_data``; ``StreamingGPR`` at flagship width
  (``csrc/chol.cu``) against its float64 run; ``save_model`` of both
  models and ``SoftSensor.load``/``GPRSensor.load`` on the card, equal to
  the sensors built in memory; ``StreamingDMD`` against the in-core DMD;
* sharding (phase 26, ``parallel/``): on an NCCL world of one,
  ``sharded_spr_step`` and ``sharded_spr_cols_step`` at the flagship size,
  ``StreamingSPR.fit(mesh=…)`` on phase 21's matrix file,
  ``sharded_gpr_train`` (14 modes), the sharded COLS ``SoftSensor`` at
  batch 50 and ``sharded_mfk_end_to_end`` (configuration A), each
  ``torch.equal`` to its call with no mesh and through the kernels; then
  two gloo ranks on the one card (``parallel.harness.dryrun_sharded``,
  the checks of ``dryrun_multichip`` at flagship width): the SPR and COLS
  steps, the QR sweep, GEM, DG and VDG on the unsharded basis split in
  two (equal to the kernel's and the unsharded selections), the GP on two
  mode ranks (iterations equal), the OLS, COLS (2e-3 of max|a|) and Kalman
  sensors, co-kriging and the streamed fit from a matrix file (equal).

The QRCP kernel is held bit-equal to the plain sweep (a panel with a NaN
entry, and k > n, included), and ``qrcp_pivots_auto`` must launch it and
return the plain sweep's pivots for k > n and for views the kernel cannot
read through their strides; the chol kernel is held bit-equal to
``chol_inv_logdet_plain``, and on the main path's matrices against a
float64 Cholesky within a bar scaled by their condition number; on the
co-kriging θ search's correlation matrices (screening and Newton batches,
some of which do not factor in fp32) it must equal the plain version where
finite, with NaN in the same places; the fused GP step kernel
(``csrc/gp_step.cu``) is held to its plain version at (14, 41) and an Adam
iteration of its CUDA graph timed beside the oracle's graph-replayed torch
step.
It checks each reconstruction's NRMSE, shows by the launch counters that
each entry point ran through its kernel, and times the pipelines, the
serving batches and the QRCP kernel with CUDA events and the chol kernel
by its device time in ``torch.profiler``'s trace.  A fixed-budget serving
batch must make no read back to the host (``torch.cuda``'s sync debug
mode set to raise, and no device-to-host copy in the trace).

Every failed check raises, and the script exits non-zero without its final
line.  The last three lines are the card's name and power limit (as
``nvidia-smi`` prints them), the ``kernels`` JSON record, and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or run from a
directory that does not hold the ``openmeasure_torch`` package, it exits 1
and prints no result.
"""

from __future__ import annotations

import contextlib
import functools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
FP32_FLOPS = 67e12            # H100 SXM fp32 outside the tensor cores
FLAGSHIP = dict(n_features=9, r=14)
CUBE = dict(n_cells=191511, n_features=9, m_train=45, m_test=4, seed=1)
NRMSE_FLAGSHIP_MAX = 5e-6
NRMSE_3D_MAX = 1e-5
# fp32 near-tie: two candidates whose float64 deflated norms² differ by
# less than this fraction of the largest initial column norm² are within
# fp32 round-off of the kernel's k-step downdate
NEAR_TIE_REL = 1e-5
# final deflated norms² of kernel and plain version agree to this fraction
# of the largest initial column norm² (fp32 downdate, k + 1 passes)
NORMS_REL_TOL = 1e-4
# csrc/chol.cu against the Cholesky formulation (another algorithm): the
# TPU kernel's bars (tests/test_tpu_kernels.py) — K⁻¹ within this fraction
# of max|K⁻¹|, logdet within this absolute error.  Against its plain
# version (the kernel's fp32 operations in the kernel's order, the Gram a
# fixed-order sequential sum) it must be EQUAL, bit for bit
CHOL_KINV_REL = 5e-6
CHOL_LOGDET_ABS = 5e-3
# the fused GP step against its plain version, one step from the same state
# and K⁻¹: fp32 sums in another order, with FMA (tests/test_torch_gp_step_cuda)
GP_STEP_REL = 1e-5
# the main path's matrices are trained GP kernel matrices (noise ≥ 1e-4
# beside eigenvalues of order p), too ill-conditioned for those bars in
# fp32: there the kernel and the fp32 Cholesky formulation are each held
# against a float64 Cholesky of the same fp32 matrices, per matrix within
# p · cond₂(K) · u (the first-order forward error of a Cholesky-based
# inverse, u the fp32 unit round-off) in K⁻¹ relative to max|K⁻¹| and in
# logdet absolute
FP32_UNIT_ROUNDOFF = 2.0 ** -24
# GP ROM reconstruction NRMSE of the JAX package in float64 on the CPU, on
# the same flagship data and settings (gpr_end_to_end; GPR class flow with
# fit(select_modes="number", n_modes=14) and the default train()).  The
# fp32 bar is 1.10× it: fp32 GP training stops at other hyperparameters
# (near-flat MLL, |Δloss| ≤ 1e-5), and the fp32 runs on the CPU land at
# +1.7 % (the port) and +3.5 % (the JAX package) of the float64 value
GPR_F64_NRMSE = {"gpr_end_to_end": 0.014428297574591142,
                 "SingleTask": 0.014428297574588838,
                 "MultiTask": 0.014422943670200609}
GPR_NRMSE_SLACK = 1.10
# engine='host' against the port's float64 CPU run of the same inputs
HOST_ENGINE_TOL = 1e-10
# serving (bench.py's serving configuration): batches of 50 frames, the
# fixed ADMM budget, limits padded by 5 % of each feature's span
SERVE_BATCH, SERVE_ITERS, SERVE_PAD = 50, 300, 0.05
# fp32 COLS coefficients against a float64 sensor of the same model at the
# same budget, relative to max|a|: each of the 300 iterations adds ~u of
# fp32 round-off, which the non-expansive iteration carries forward, and
# the (r, r) solves scale it by their conditioning (tens): 300 · u · 50 ≈
# 9e-4, so 2e-3 (an H100 measured 1.8e-4 adaptive, 4.2e-5 fixed)
SERVE_COEF_REL = 2e-3
# the served fields' largest excursion past a limit, relative to the
# feature's span: the fields are Ur g, not the clipped split variable z,
# so they may stray by the primal residual left after the budget.  With
# the limits padded INWARD by SERVE_PAD, so that field entries reach them,
# the budget leaves a primal residual in float64 too: there the fp32
# fields may stray by the float64 sensor's excursion plus this
SERVE_VIOL_REL = 1e-3
# GPRSensor (unconstrained) against GPR.predict + reconstruct: the same
# fp32 operations, the GEMMs of other shapes
GP_SERVE_REL = 1e-5
# constrained GPRSensor against the eager constrained predict at the same
# budget: their covariances differ by one fp32 rounding (diag(var) against
# diag(sqrt(var)²)), which 300 non-expansive iterations carry at most
# ~300 · u ≈ 2e-5
GP_SERVE_MAP_REL = 1e-4


# co-kriging (phases 12-15).  fp32 mfk_end_to_end against float64 on the
# card, NRMSE relative to the range of the float64 means: the JAX
# package's fp32 run sits 2.9e-4 from float64 on the CPU and 3.0e-4 on its
# accelerator (BASELINE.md:36,42)
MFK_FP32_NRMSE = 1e-3
# configuration B: modes a side; fp32 CoKriging against float64 (engine
# 'host', float64 alignment) in NRMSE relative to the HF test range, the
# same reason; the reconstruction against the truth below the JAX
# package's own bar (docs/cokriging.md); CoKrigingSensor against
# CoKriging.predict: the same fp32 operations on the same state
CK_MODES = 8
CK_FP32_NRMSE = 1e-3
CK_TRUTH_NRMSE = 0.10
CK_SENSOR_REL = 1e-5
# configuration C: the temperature block's physical band (K), the
# docs/examples/pigpr_example.py recipe
T_LO, T_HI = 200.0, 3000.0


# placements (phase 16): sensors per family (bench.py:650-678 cites GEM's
# 10 for full scale; DG 2r; VDG 4 probes × 9 features,
# docs/examples/decoder_example.py:33-34).  fp32 and float64 selections can
# differ at near ties (QR shares 1 of 14 pivots), so objectives are compared,
# each evaluated in float64: the fp32 selection's must be within this
# fraction of float64 arithmetic's on the same (the fp32 model's) basis, or
# better; VDG's float64 run gets the fp32 run's δ, whose 64·p·eps floor is
# far above float64's.  Against the float64 model's selection on the
# float64 basis the gap is printed: there the fp32 basis's trailing modes,
# which differ from float64's by up to ~4e-2 on this set, decide it
PLACE_N = {"gem": 10, "dg": 28, "vdg": 4}
PLACE_OBJ_REL = 1e-3
# the shallow decoder (phase 17, docs/examples/decoder_example.py:53-54):
# fp32 and float64 from the same initial weights; training amplifies
# round-off through the ReLU pattern, so the held-out NRMSEs are held
# within this fraction of each other; the served batch against predict
# (the same fp32 MLP forward)
DEC_HIDDEN, DEC_EPOCHS, DEC_LR = (40, 45), 2000, 3e-3
DEC_FP32_SLACK = 0.10
DEC_SERVE_REL = 1e-5
# dynamics (phase 18): fp32 Kalman fields against the float64 sensor's,
# relative to the float64 field range; DMD's 6 largest-amplitude
# eigenvalues (fp32 Gram-route SVD, float64 analysis on the host)
KF_FIELD_REL = 1e-3
DMD_EIG_ABS = 1e-4

# CTC (phase 19): the reference's tomography scale (docs/ctc.md §2, §4;
# bench.py:583-645): a 32³ grid over ±0.1, 64×64 cameras, the 4-view rig
# of bench.py, the Gaussian-blob emission fields of
# docs/examples/ctc_example.py; SPR on 10 fields, field 11 held out
CTC_BOUNDS = (-0.1, 0.1, -0.1, 0.1, -0.1, 0.1)
CTC_DIMS = (32, 32, 32)
CTC_TRAIN, CTC_HELD_OUT, CTC_MODES = 10, 11, 5
CTC_METHODS = {"OLS": {}, "COLS": {"limits": [[0.0], [1.0]]}}
# the JAX package's float64 held-out NRMSE of that flow on the CPU
# (tests/test_torch_ctc.py::test_phase19_reference_nrmse_is_jax_float64
# recomputes it); the card's fp32 value must be within 1.10× of it
CTC_F64_NRMSE = {"OLS": 0.001761860205993548, "COLS": 0.0017618602059980965}
CTC_NRMSE_SLACK = 1.10
# COLS fields inside the physical limits [0, 1] within this, and the
# served batch (400 ADMM iterations) against a float64 sensor of the same
# model, relative to the field range: the serving bar of phase 9
CTC_LIMIT_SLACK = 1e-4
CTC_SERVE_ITERS = 400
# fp32 served fields against the float64 sensor relative to the field
# range: SERVE_COEF_REL's reasoning at 400 iterations (400 · u · tens)
CTC_SERVE_REL = 2e-3
# resampling at docs/examples/resampling_3d_example.py's scale
RESAMPLE = dict(n_cells=20000, n_features=3, m=24, points=25)

# incremental update (phase 20, docs/examples/update_example.py): the
# flagship 165,258 rows, 38 snapshots, then 3 that arrive later carrying a
# new regime, r = 14 → 15.  fp32 on the card against the port's float64
# run: the updated singular values relative to float64's; the largest
# principal angle (radians) between the bases at each leading dimension k
# that the fp32 fit resolves (its angle to float64's below
# UPD_ANGLE_RESOLVED), no wider than UPD_ANGLE_FACTOR × the fit's angle
# there (the update must not amplify the fit's error) plus the update's own
# fp32 error, UPD_ANGLE_DK × eps32 · σ₁ / (σ_k − σ_(k+1)) in float64's σ
# (Davis–Kahan's angle for a perturbation of eps32 · σ₁).  Readings, fp32
# against float64 on an H100 at 700 W: the fit resolved k ≤ 10 (≤ 2.2e-3
# rad; 0.29 to 1.50 beyond); after the update the angle there stayed within
# 2.0 × the fit's, and within 7.0 × the Davis–Kahan term (at k = 10, where
# the fit's own error dominates; ≤ 1.3 × up to k = 9).  The held-out NRMSE
# after the update, SPR's and GPR's, against a full refit on all 41
# columns.
UPD_M, UPD_NEW, UPD_R = 38, 3, 14
UPD_SIGMA_REL = 1e-3
UPD_ANGLE_RESOLVED = 1e-2
UPD_ANGLE_FACTOR = 4.0
UPD_ANGLE_DK = 32.0
UPD_NRMSE_SLACK = 1.10
# the out-of-core tier (phases 21-25).  A streamed fit against the card's
# float64 fit, per mode k: the host engine's products are float64, so only
# the fp32 statistics and storage round, and each mode is held to
# |Δσ|/σ₁ ≤ STREAM_DK·eps32 and to an angle ≤ STREAM_DK·eps32·σ₁/gap_k
# (Davis–Kahan; the constant of phase 20).  The device engine's first Gram
# is fp32 (an error ~eps32·σ₁²), so it is held to the same bound for a
# Gram: an angle ≤ STREAM_DK·eps32·σ₁²/(σ_k² − σ_(k±1)²) and |Δσ|/σ₁ ≤
# STREAM_DK·eps32·σ₁/σ_k; its width-limited refine (the JAX design) cannot
# recover a mode under that error.  A bar is capped at STREAM_ANGLE_CAP rad,
# so a wrong column fails also where the bound is loose; the device engine's
# angle is not held at a mode whose Gram bar reaches π/2 (the bound cannot
# say that mode is resolved there), and the log says "not held".  Median
# chunks of a size that cuts the flagship's 18,362-row blocks.
STREAM_DK = 32.0
STREAM_ANGLE_CAP = 0.05
STREAM_MEDIAN_ROWS = 10_007
# phase 26: the sharded COLS step's ADMM budget, and the two-rank world's
# timeout (spawn, CUDA start and every check)
SHARD_COLS_ITERS = 4000
SHARD_WORLD_TIMEOUT = 600.0
# phase 26(b) runs the JAX package's dryrun_multichip at its own rank: at
# r = 14 the fp32 flagship placement is degenerate (ROADMAP §C), so
# a sharded fit's end-to-end pivots, and with them its NRMSE, may move
DRYRUN_R = 8
# phase 27: the post-fit methods after fit(mesh=…): new snapshots a flow,
# the ADMM budget of its COLS predict and CPOD, the GP's Adam budget (the
# retrain warm-starts from it with the same budget).  On two ranks the
# retrained GP is held by its reconstruction NRMSE at the held-out
# parameters, within UPD27_GP_SLACK × the unsharded flow's (the GP bar of
# PERF.md §2): the sharded and unsharded updates differ by round-off, and
# fp32 early stops then fall a few iterations apart (up to 9 of 300 in a
# CPU run at 1,000 cells, the posterior mean 5.9e-3 of its max apart), so
# iteration counts are reported, not held
UPD27_NEW = 3
UPD27_ADMM = 500
UPD27_GP_ITERS = 300
UPD27_GP_SLACK = 1.10


def gem_entropy(U, sel):
    """GEM's objective H_tot of the ordered selection ``sel`` on the
    float64 basis ``U`` (host numpy): Σ over the steps after the first of
    ½ log σ²_{y|a} + ½ (log 2π + 1), with GEM's row scaling and 1e-5
    jitter (``sensing/gem.py``)."""
    import numpy as np
    r = U.shape[1]
    Us = U * (2.0 / np.sqrt(np.nanmax(np.var(U, axis=1, ddof=1))))
    Uc = Us - Us.mean(axis=1, keepdims=True)
    H = 0.0
    for s in range(1, len(sel)):
        Cs, u = Uc[sel[:s]], Uc[sel[s]]
        Saa = Cs @ Cs.T / (r - 1) + 1e-5 * np.eye(s)
        Sya = Cs @ u / (r - 1)
        H += 0.5 * np.log(u @ u / (r - 1) - Sya @ np.linalg.solve(Saa, Sya)) \
            + 0.5 * (np.log(2 * np.pi) + 1.0)
    return H


def dg_logdet(U, sel):
    """DG's objective log det(ΘᵀΘ), Θ = U[sel] (host float64)."""
    import numpy as np
    T = U[np.asarray(sel)]
    return float(np.linalg.slogdet(T.T @ T)[1])


def vdg_delta(U, n_features, eps, ridge=1e-6):
    """(δ, mean block energy / p) as ``vector_dg_select`` sets them for
    the basis ``U`` in a dtype of unit round-off ``eps``: the fp32 floor
    64·p·eps·max‖U_j‖² is far above float64's, so an fp32 and a float64
    selection optimize different δ unless float64 is given fp32's."""
    import numpy as np
    n, r = U.shape
    blocks = np.swapaxes(U.reshape(n_features, n // n_features, r), 0, 1)
    e = np.sum(blocks ** 2, axis=(1, 2))
    energy = e.mean() / n_features
    return max(ridge * energy, 64.0 * n_features * eps * e.max()), energy


def vdg_logdet(U, points, n_features, delta):
    """VDG's objective log det(δI + ΘᵀΘ) of the probes' stacked feature
    blocks (host float64)."""
    import numpy as np
    n, r = U.shape
    blocks = np.swapaxes(U.reshape(n_features, n // n_features, r), 0, 1)
    T = blocks[np.asarray(points)].reshape(-1, r)
    return float(np.linalg.slogdet(delta * np.eye(r) + T.T @ T)[1])


def ctc_fields(xyz):
    """The emission fields of ``docs/examples/ctc_example.py``: 12
    Gaussian blobs of widths 0.3–1.0 (× 0.05) at the cell centers."""
    import numpy as np
    return np.stack([np.exp(-np.sum(xyz ** 2, axis=1) / (2 * (0.05 * a) ** 2))
                     for a in np.linspace(0.3, 1.0, 12)], axis=1)


def ctc_rig(camera):
    """bench.py's 4-view rig of 64×64 parallel cameras, built with the
    given camera class."""
    import numpy as np
    return [camera(np.array([0.3 * np.sin(i), 0.0, 1.0, 1.0]),
                   np.array([0.0, 0.0, i * np.pi / 4]), 0.05, 2.8, 0.06,
                   np.array([64, 64]), 0.25 / 64) for i in range(4)]


def ctc_camera(camera):
    """bench.py's single 64×64 camera at z = 1."""
    import numpy as np
    return camera(np.array([0.0, 0.0, 1.0, 1.0]), np.zeros(3), 0.05, 2.8,
                  0.06, np.array([64, 64]), 0.25 / 64)


def update_data():
    """docs/examples/update_example.py's data: the flagship set's first 38
    snapshots, 3 that arrive later with a new regime (a localized bump on
    the first feature block), and 2 held out; all fp32."""
    import numpy as np
    from openmeasure_torch.datasets.synthetic import make_flame_dataset
    data = make_flame_dataset(n_cells=18362, n_features=9, m_train=UPD_M,
                              m_test=5, seed=0)
    X = np.asarray(data["X_train"], np.float32)
    X_new = np.asarray(data["X_test"], np.float32)[:, :UPD_NEW]
    X_hold = np.asarray(data["X_test"], np.float32)[:, UPD_NEW:]
    xyz = np.asarray(data["xyz"], np.float64)
    n_points = X.shape[0] // 9
    bump = np.exp(-np.sum((xyz - xyz.mean(0) - 0.25 * xyz.std(0)) ** 2,
                          axis=1) / (0.3 * xyz.std()) ** 2)
    u_regime = np.zeros(X.shape[0], np.float32)
    u_regime[:n_points] = (bump / np.linalg.norm(bump)).astype(np.float32)
    amp = np.abs(X[:n_points]).max()
    X_new = X_new + np.outer(u_regime, amp * np.array([1.0, 0.8, 1.2],
                                                      np.float32))
    return (X, X_new, X_hold, data["xyz"], data["P_train"],
            data["P_test"][:UPD_NEW], data["P_test"][UPD_NEW:])


def dynamics_series():
    """The time series of ``docs/examples/dynamics_example.py``: three
    damped rotations (latent rank 6) lifted to 50,000 points × 2 features,
    60 + 40 snapshots, made from seed 0 in its order.  Returns (X_train,
    X_test, xyz, the generator), whose next draws are the example's
    sensor noise."""
    import numpy as np
    rng = np.random.default_rng(0)
    n_points, m_train, m_test = 50_000, 60, 40
    n = n_points * 2
    L, _ = np.linalg.qr(rng.standard_normal((n, 6)).astype(np.float64))
    L *= np.array([[3.0, 3.0, 1.5, 1.5, 0.8, 0.8]])

    def rot(th, rho):
        return rho * np.array([[np.cos(th), -np.sin(th)],
                               [np.sin(th), np.cos(th)]])

    A_z = np.zeros((6, 6))
    A_z[0:2, 0:2] = rot(0.35, 0.998)
    A_z[2:4, 2:4] = rot(0.12, 0.995)
    A_z[4:6, 4:6] = rot(0.58, 0.99)
    z = rng.standard_normal(6)
    Z = []
    for _ in range(m_train + m_test):
        Z.append(z)
        z = A_z @ z + 0.02 * rng.standard_normal(6)
    X = (L @ np.array(Z).T).astype(np.float32) + 5.0
    xyz = rng.standard_normal((n_points, 3))
    return X[:, :m_train], X[:, m_train:], xyz, rng


def chol_ops(B: int, p: int) -> int:
    """The batched SPD inverse's operations, counted on its triangles:
    Schur updates (one multiply and one subtract per trailing
    lower-triangle element), forward substitution (per row below the step,
    per column up to it), the Gram's lower triangle, and one rsqrt and one
    log per pivot."""
    return (sum((p - 1 - j) * (p - j) for j in range(p))
            + sum(2 * (p - 1 - j) * (j + 1) for j in range(p))
            + sum(2 * (p - k) * (k + 1) for k in range(p)) + 2 * p) * B


def chol_bound_ms(B: int, p: int):
    """(bytes, operations) lower bounds in ms of a (B, p, p) launch: K read
    and K⁻¹ and logdet written once at the HBM rate; the operations at the
    fp32 peak."""
    return ((2 * B * p * p + B) * 4 / HBM_BYTES_PER_S * 1e3,
            chol_ops(B, p) / FP32_FLOPS * 1e3)


def gp_step_ops(B: int, p: int, nls: int) -> int:
    """The fused GP step's operations: α = K⁻¹·resid (2p² a model), and
    per (i, j) element the step's M, d², Matérn-5/2 profile and its
    derivative and the sums (15 + 4·nls) and the build's d², profile and
    scale (7 + 2·nls)."""
    return B * p * p * (2 + 22 + 6 * nls)


def gp_step_bound_ms(B: int, p: int, nls: int, n_par: int):
    """(bytes, operations) lower bounds in ms of a fused GP step launch:
    K⁻¹, logdet, the targets, the squared distances and the residual read,
    the next K and residual written, the parameters, moments, loss (fp32)
    and counts (int32) read and written, the stop flags (1 byte) read and
    written, each once; the operations at the fp32 peak."""
    floats = (2 * B * p * p + nls * p * p + 3 * B * p + B
              + 2 * (3 * B * n_par + B + 2 * B))
    return ((4 * floats + 2 * B) / HBM_BYTES_PER_S * 1e3,
            gp_step_ops(B, p, nls) / FP32_FLOPS * 1e3)


def mfk_problem(K=8, n_lf=40, n_hf=15, n_test=25, d=2, seed=3):
    """Configuration A, the JAX benchmark's co-kriging row
    (``bench.py:138-153``): K outputs on shared two-fidelity sites,
    float64 numpy."""
    import numpy as np
    rng = np.random.default_rng(seed)
    X_lf = rng.random((n_lf, d))
    X_hf = X_lf[::max(1, n_lf // n_hf)][:n_hf]
    X_test = rng.random((n_test, d))

    def hf(X, k):
        return np.sin(3 * X[:, 0] + 0.7 * k) + 0.5 * np.cos(2 * X[:, 1] + k)

    Y_hf = np.stack([hf(X_hf, k) for k in range(K)])
    Y_lf = np.stack([0.6 * hf(X_lf, k) - 0.3 + 0.2 * X_lf[:, 0]
                     for k in range(K)])
    return X_lf, Y_lf, X_hf, Y_hf, X_test


def cokriging_lf_set(d):
    """Configuration B's low-fidelity set from a flame dataset ``d``: every
    4th cell of each feature block at all training conditions, each value
    ``X · (1 + 0.1 sin(2π x / 0.35)) + 0.05 · span_f`` (x the cell's x
    coordinate, span_f feature f's span over X_train).  Returns (LF, xyz_lf)
    in the dataset's dtype."""
    import numpy as np
    X, xyz = d["X_train"], d["xyz"]
    npts, nf = xyz.shape[0], X.shape[0] // xyz.shape[0]
    cells = np.arange(0, npts, 4)
    rows = (np.arange(nf)[:, None] * npts + cells[None, :]).reshape(-1)
    Xb = X.reshape(nf, npts, -1)
    span = Xb.max(axis=(1, 2)) - Xb.min(axis=(1, 2))
    mod = 1.0 + 0.1 * np.sin(2 * np.pi * xyz[cells, 0] / 0.35)
    lf = X[rows] * np.tile(mod, nf)[:, None] \
        + 0.05 * np.repeat(span, cells.size)[:, None]
    return lf.astype(X.dtype), xyz[cells]


def principal_angles(A, B):
    """Largest principal angle (radians) between span(A) and span(B) of
    each leading dimension k = 1 … min(A, B columns), host float64."""
    import numpy as np
    out = []
    for k in range(1, min(A.shape[1], B.shape[1]) + 1):
        s = np.linalg.svd(np.linalg.qr(A[:, :k])[0].T
                          @ np.linalg.qr(B[:, :k])[0], compute_uv=False)
        out.append(float(np.arccos(np.clip(s.min(), -1.0, 1.0))))
    return out


def ctc_phase(h):
    """Phase 19: CTC at the reference's tomography scale on the card (see
    the CTC_* settings)."""
    import numpy as np
    import torch
    from openmeasure_torch import SPR, SoftSensor, ctc
    from openmeasure_torch.ctc import raytrace
    from openmeasure_torch.utils.metrics import nrmse

    dev, log, fail = h.dev, h.log, h.fail
    g_card = ctc.VoxelGrid.from_bounds(CTC_BOUNDS, CTC_DIMS, device=dev)
    g_cpu = ctc.VoxelGrid.from_bounds(CTC_BOUNDS, CTC_DIMS, device="cpu")
    steps = sum(CTC_DIMS) + 3

    # the DDA on random rays, card against the plain CPU run
    rng = np.random.default_rng(19)
    p1, p2 = (rng.uniform(-0.15, 0.15, (4096, 3)) for _ in range(2))
    got = {d: raytrace.trace_rays(
        torch.as_tensor(p1, dtype=torch.float32, device=d),
        torch.as_tensor(p2, dtype=torch.float32, device=d),
        g_card.origin, g_card.spacing, CTC_DIMS) for d in (dev, "cpu")}
    same = (torch.equal(got[dev][0].cpu(), got["cpu"][0])
            and torch.equal(got[dev][1].cpu(), got["cpu"][1]))
    n_hit = int((got["cpu"][1] > 0).sum())
    log(f"  DDA, 4,096 random fp32 rays through the 32³ grid ({n_hit} hit "
        f"it, {int(got['cpu'][1].sum())} cells): cells and counts on the "
        f"card equal to the CPU run's={same}")
    if not same:
        fail("the DDA's cells on the card differ from the CPU run's")

    # the projections: the operator from the card equal to the CPU's, one
    # device-to-host copy a trace_csr call
    cam = ctc_camera(ctc.camera)
    for model, nrand in (("parallel", 1), ("pinhole", 8), ("thin_lens", 8)):
        C_card = cam.project(g_card, model, nrand, seed=0)
        C_cpu = cam.project(g_cpu, model, nrand, seed=0)
        same = (C_card.nnz == C_cpu.nnz
                and np.array_equal(C_card.indptr, C_cpu.indptr)
                and np.array_equal(C_card.indices, C_cpu.indices))
        fn = (lambda model=model, nrand=nrand:
              cam.project(g_card, model, nrand, seed=0))
        med, lo_t, hi_t = h.per_call_ms({0: fn}, reps=6, warmup=1)[0]
        kernels, dtoh = h.trace_counts(fn)
        log(f"  project {model} (N_rand {nrand}, {4096 * nrand} rays): "
            f"{C_card.shape} nnz {C_card.nnz}, equal to the CPU run's "
            f"(indptr, indices, nnz)={same}; wall per call median "
            f"{med:.3f} ms (min {lo_t:.3f}, max {hi_t:.3f}; 6 calls); "
            f"{kernels} device kernels per call "
            f"({'not measured' if kernels is None else f'{kernels / steps:.1f}'}"
            f" per DDA step of {steps}), {dtoh} device-to-host copies")
        if not same or C_card.nnz == 0:
            fail(f"the {model} operator from the card differs from the CPU's")
        if dtoh != 1:
            fail(f"project {model} made {dtoh} device-to-host copies, not 1")

    # a grid of 40³ = 64,000 cells: the columns from 32,768 up travel as
    # negative int16 and are read back as uint16
    C_card, C_cpu = (cam.project(ctc.VoxelGrid.from_bounds(
        CTC_BOUNDS, (40, 40, 40), device=d), "parallel") for d in (dev, "cpu"))
    same = (C_card.nnz == C_cpu.nnz
            and np.array_equal(C_card.indptr, C_cpu.indptr)
            and np.array_equal(C_card.indices, C_cpu.indices))
    upper = int((C_card.indices >= 2 ** 15).sum())
    log(f"  project parallel on a 40³ grid: nnz {C_card.nnz}, {upper} "
        f"columns at 32,768 or above, equal to the CPU run's={same}")
    if not same or not upper or C_card.indices.max() >= 40 ** 3:
        fail("the 40³ operator from the card differs from the CPU's")

    # the DDA and the dedup alone, on the thin-lens bundle (32,768 rays)
    p1, p2, pix = cam._make_rays("thin_lens", 8, np.random.default_rng(0))
    P1, P2 = (torch.as_tensor(p, dtype=torch.float32, device=dev)
              for p in (p1, p2))
    PIX = torch.as_tensor(pix, dtype=torch.int32, device=dev)
    cap = cam.n_pixels * max(CTC_DIMS)
    cells = raytrace.trace_rays(P1, P2, g_card.origin, g_card.spacing,
                                CTC_DIMS)[0]
    fns = {"dda": lambda: raytrace.trace_rays(P1, P2, g_card.origin,
                                              g_card.spacing, CTC_DIMS),
           "dedup": lambda: raytrace.csr_from_cells(
               cells, PIX, g_card.n_cells, cam.n_pixels, out_cap=cap)}
    walls = h.per_call_ms(fns, reps=10, warmup=2)
    k_dda, _ = h.trace_counts(fns["dda"])
    k_dedup, _ = h.trace_counts(fns["dedup"])
    log(f"  trace_rays alone (32,768 rays, {steps} steps): median "
        f"{walls['dda'][0]:.3f} ms (min {walls['dda'][1]:.3f}), {k_dda} "
        f"kernels; csr_from_cells alone (two sorts of {32768 * steps:,} "
        f"keys, the scatter): median {walls['dedup'][0]:.3f} ms (min "
        f"{walls['dedup'][1]:.3f}), {k_dedup} kernels (CUDA events, 10 "
        f"calls in turns)")

    # a budget below nnz: the exact nnz shows it, a second copy fetches all
    _, dtoh_cut = h.trace_counts(
        lambda: g_card.trace_csr(p1, p2, pix, cam.n_pixels, readback_cap=64))
    skel_cut = g_card.trace_csr(p1, p2, pix, cam.n_pixels, readback_cap=64)
    skel_full = g_card.trace_csr(p1, p2, pix, cam.n_pixels)
    same = all(np.array_equal(a, b) for a, b in zip(skel_cut, skel_full))
    log(f"  trace_csr with a 64-column budget (nnz {skel_full[1].size}): "
        f"{dtoh_cut} device-to-host copies, the operator equal to the "
        f"default budget's={same}")
    if dtoh_cut != 2 or not same:
        fail("the over-budget trace_csr did not refetch exactly once")

    # the 4-view rig in one trace
    rig = ctc_rig(ctc.camera)
    C_rig = ctc.stack_cameras(rig, g_card, "parallel", seed=0)
    C_rig_cpu = ctc.stack_cameras(rig, g_cpu, "parallel", seed=0)
    fn = lambda: ctc.stack_cameras(rig, g_card, "parallel", seed=0)  # noqa
    med, lo_t, hi_t = h.per_call_ms({0: fn}, reps=6, warmup=1)[0]
    kernels, dtoh = h.trace_counts(fn)
    same = (C_rig != C_rig_cpu).nnz == 0
    log(f"  stack_cameras, 4 views × 64×64 parallel: {C_rig.shape} nnz "
        f"{C_rig.nnz}, equal to the CPU run's={same}; wall median "
        f"{med:.3f} ms (min {lo_t:.3f}, max {hi_t:.3f}), {kernels} kernels, "
        f"{dtoh} device-to-host copies")
    if not same or dtoh != 1:
        fail("the rig's operator differs from the CPU's or took more than "
             "one copy")

    # the reconstruction: SPR on 10 fields, the rig's operator as a torch
    # sparse tensor on the card, OLS and COLS in [0, 1]
    xyz = g_card.cell_centers()
    X = ctc_fields(xyz).astype(np.float32)
    coo = C_rig.tocoo()
    C_t = torch.sparse_coo_tensor(np.vstack([coo.row, coo.col]), coo.data,
                                  size=C_rig.shape, dtype=torch.float32,
                                  device=dev, check_invariants=True)
    truth = torch.as_tensor(X[:, CTC_HELD_OUT], device=dev)
    y = np.zeros((C_rig.shape[0], 3))
    y[:, 0] = C_rig @ X[:, CTC_HELD_OUT].astype(np.float64)
    models = {}
    for method, kw in CTC_METHODS.items():
        spr = SPR(X[:, :CTC_TRAIN], 1, xyz, device=dev)
        spr.fit(select_modes="number", n_modes=CTC_MODES)
        spr.train(C_t, method=method, **kw)
        x = spr.reconstruct(spr.predict(y)[0])[:, 0]
        nr = float(nrmse(x, truth))
        bar = CTC_NRMSE_SLACK * CTC_F64_NRMSE[method]
        log(f"  SPR {method}, n_modes {CTC_MODES}, trained on the rig's "
            f"operator (torch sparse on the card): held-out NRMSE {nr:.6e} "
            f"(≤ {bar:.6e}; the JAX package's float64 "
            f"{CTC_F64_NRMSE[method]:.6e}); field range "
            f"[{float(x.min()):.4e}, {float(x.max()):.4e}]")
        if not nr <= bar:
            fail(f"CTC {method} NRMSE {nr:.3e} above {bar:.3e}")
        if method == "COLS" and not (float(x.min()) >= -CTC_LIMIT_SLACK
                                     and float(x.max()) <= 1 + CTC_LIMIT_SLACK):
            fail("CTC COLS fields leave [0, 1]")
        models[method] = spr

    # the constrained model served at batch 50, each frame C @ x
    fid = np.zeros(C_rig.shape[0], int)
    s32 = SoftSensor.from_spr(models["COLS"], feature_ids=fid,
                              admm_iters=CTC_SERVE_ITERS).warmup()
    s64 = SoftSensor.from_spr(models["COLS"], feature_ids=fid,
                              dtype=torch.float64,
                              admm_iters=CTC_SERVE_ITERS)
    frames = torch.as_tensor(np.stack(
        [C_rig @ X[:, j % 12].astype(np.float64)
         for j in range(SERVE_BATCH)]), dtype=torch.float32, device=dev)
    f32 = s32.predict_batch(frames)[0]
    f64 = s64.predict_batch(frames.double())[0]
    err = float((f32.double() - f64).abs().max() / (f64.max() - f64.min()))
    med, lo_t, hi_t = h.per_call_ms({0: lambda: s32.predict_batch(frames)},
                                    reps=10, warmup=2)[0]
    kernels, dtoh = h.trace_counts(lambda: s32.predict_batch(frames))
    n_sync = h.host_syncs(lambda: s32.predict_batch(frames))
    lo_f, hi_f = float(f32.min()), float(f32.max())
    log(f"  SoftSensor COLS ({CTC_SERVE_ITERS} ADMM iterations, "
        f"feature_ids 0) at batch {SERVE_BATCH}: {med / SERVE_BATCH:.5f} "
        f"ms per frame (batch median {med:.4f} ms, min {lo_t:.4f}, max "
        f"{hi_t:.4f}); {kernels} kernels, {dtoh} device-to-host copies and "
        f"{n_sync} synchronizing calls per batch; fields in [{lo_f:.3e}, "
        f"{hi_f:.6f}]; fp32 against a float64 sensor {err:.3e} of the "
        f"range (≤ {CTC_SERVE_REL})")
    if dtoh or n_sync:
        fail("a served CTC batch read back to the host")
    if not (lo_f >= -CTC_LIMIT_SLACK and hi_f <= 1 + CTC_LIMIT_SLACK):
        fail("served CTC fields leave [0, 1]")
    if not err <= CTC_SERVE_REL:
        fail(f"served CTC fields {err:.3e} from float64")

    # the rig embedded in a two-feature state, the second feature emitting
    C_emb = ctc.stack_cameras(rig, g_card, "parallel", seed=0, n_features=2,
                              feature_index=1)
    same = (C_emb != ctc.embed_projection(C_rig, 2, 1)).nnz == 0
    temp = 1.0 + 0.5 * X + 0.1 * xyz[:, [0]].astype(np.float32)
    X2 = np.concatenate([temp, X], axis=0)
    spr2 = SPR(X2[:, :CTC_TRAIN], 2, xyz, device=dev)
    spr2.fit(select_modes="number", n_modes=CTC_MODES)
    spr2.train(C_emb)
    y2 = np.zeros((C_emb.shape[0], 3))
    y2[:, 0] = C_emb @ X2[:, CTC_HELD_OUT].astype(np.float64)
    y2[:, 2] = 1
    x2 = spr2.reconstruct(spr2.predict(y2)[0])[:, 0]
    nr2 = float(nrmse(x2[g_card.n_cells:], truth))
    log(f"  embedded rig (n_features 2, feature_index 1): {C_emb.shape}, "
        f"equal to embed_projection of the rig's={same}; the emitting "
        f"feature's held-out NRMSE {nr2:.4e}")
    if not same or not np.isfinite(nr2):
        fail("the embedded rig's operator or reconstruction is wrong")

    # resampling at docs/examples/resampling_3d_example.py's scale (host)
    rs = np.random.default_rng(0)
    pts = rs.uniform(-1, 1, (RESAMPLE["n_cells"], 3))
    P = np.linspace(0.2, 1.0, RESAMPLE["m"])
    Xs = np.concatenate([
        np.exp(-np.sum(pts ** 2, 1)[:, None] / (0.3 + 0.4 * P[None, :])),
        np.sin(np.pi * pts[:, [0]] * (1 + P[None, :]))
        * np.cos(np.pi * pts[:, [1]]),
        P[None, :] * pts[:, [2]] ** 2], axis=0)
    for method in ("linear", "idw"):
        t0 = time.perf_counter()
        grid_r, X_int, xyz_int = ctc.resample_to_grid(
            pts, Xs, [RESAMPLE["points"]] * 3, method=method, device=dev)
        dt = (time.perf_counter() - t0) * 1e3
        ok = (X_int.shape == (3 * grid_r.n_cells, RESAMPLE["m"])
              and bool(np.all(np.isfinite(X_int))))
        log(f"  resample_to_grid {method}: {RESAMPLE['n_features']} "
            f"features × {RESAMPLE['n_cells']:,} points × {RESAMPLE['m']} "
            f"snapshots onto {RESAMPLE['points']}³ points ({grid_r.n_cells:,}"
            f" cells): {dt:.1f} ms host wall, finite of shape "
            f"{X_int.shape}={ok}")
        if not ok:
            fail(f"resample_to_grid {method} is not finite of its shape")

    # an unstructured hexahedral copy of a 16³ grid gives its operator
    g16 = ctc.VoxelGrid.from_bounds(CTC_BOUNDS, (16, 16, 16), device=dev)
    P16, cells16 = voxel_hex_mesh(g16)
    mesh = ctc.UnstructuredMesh.from_cells(P16, cells16)
    C_vox = cam.project(g16, "parallel")
    t0 = time.perf_counter()
    C_mesh = cam.project(mesh, "parallel")
    dt = (time.perf_counter() - t0) * 1e3
    same = (C_vox != C_mesh).nnz == 0
    log(f"  UnstructuredMesh.from_cells, the 16³ grid as {len(cells16)} "
        f"hexahedra (exact caster, host C++): project parallel {dt:.1f} ms, "
        f"nnz {C_mesh.nnz}, equal to the voxel grid's operator={same}")
    if not same or C_mesh.nnz == 0:
        fail("the hexahedral copy's operator differs from the voxel grid's")


def voxel_hex_mesh(grid):
    """The voxel grid's cells as explicit hexahedra (VTK vertex order, in
    the grid's cell order): (points, cells)."""
    import numpy as np
    nx, ny, nz = grid.dims
    axes = [grid.origin[a] + grid.spacing[a] * np.arange(n + 1)
            for a, n in enumerate(grid.dims)]
    Z, Y, Xg = np.meshgrid(axes[2], axes[1], axes[0], indexing="ij")
    pts = np.stack([Xg.ravel(), Y.ravel(), Z.ravel()], axis=1)
    i, j, k = (a.ravel() for a in np.meshgrid(np.arange(nx), np.arange(ny),
                                              np.arange(nz), indexing="ij"))
    order = np.lexsort((i, j, k))
    i, j, k = i[order], j[order], k[order]

    def vid(a, b, c):
        return a + (nx + 1) * (b + (ny + 1) * c)
    cells = np.stack([vid(i, j, k), vid(i + 1, j, k), vid(i + 1, j + 1, k),
                      vid(i, j + 1, k), vid(i, j, k + 1),
                      vid(i + 1, j, k + 1), vid(i + 1, j + 1, k + 1),
                      vid(i, j + 1, k + 1)], axis=1)
    return pts, cells


def update_phase(h):
    """Phase 20: the incremental update at flagship width (see the UPD_*
    settings).  Returns (qrcp launches, chol launches)."""
    import numpy as np
    import torch
    from openmeasure_torch import GPR, SPR
    from openmeasure_torch.utils.metrics import nrmse

    dev, log, fail = h.dev, h.log, h.fail
    X, X_new, X_hold, xyz, P_tr, P_new, P_hold = update_data()
    npts = X.shape[0] // 9
    r1 = UPD_R + 1

    def gappy(spr, cols):
        rows = spr.C.argmax(dim=1).cpu().numpy()
        ys = [np.column_stack([cols[rows, j], np.zeros(rows.size),
                               rows // npts]) for j in range(cols.shape[1])]
        x = spr.reconstruct(spr.predict(ys)[0]).double()
        return float(nrmse(x, torch.as_tensor(cols, dtype=torch.float64,
                                              device=dev)))

    def qrcp_on_panel(spr, C, what):
        """csrc/qrcp.cu against the plain sweep on the panel that the fp32
        model's optimal_placement gave it, Ur.T (r, 165,258): the pivots
        and final norms equal, and the pivots those of C."""
        eq, pk, pp, err, _, same_nf = h.kernel_vs_plain(spr.Ur.T, spr.r,
                                                        None)
        placed = bool(np.array_equal(pk, C.argmax(dim=1).cpu().numpy()))
        log(f"  csrc/qrcp.cu vs plain sweep on {what}'s panel "
            f"{tuple(spr.Ur.T.shape)} k = {spr.r}: pivots equal={eq}, final "
            f"norms equal={err == 0.0 and same_nf}, the placement's "
            f"pivots={placed}")
        if not (eq and err == 0.0 and same_nf and placed):
            fail(f"csrc/qrcp.cu differs from the plain sweep on {what}'s "
                 f"panel")

    runs, n_qrcp = {}, 0
    for tag, dt in (("fp32", np.float32), ("float64", np.float64)):
        spr = SPR(X.astype(dt), 9, xyz, device=dev)
        spr.fit(select_modes="number", n_modes=UPD_R)
        C, n = h.counted(lambda: spr.optimal_placement())
        n_qrcp += n
        if tag == "fp32":
            qrcp_on_panel(spr, C, "the fit")
        spr.train(C)
        before = (gappy(spr, X_hold), gappy(spr, X_new))
        U_fit = spr.Ur.double().cpu().numpy()
        kernels, dtoh = h.trace_counts(
            lambda: spr.update_basis(X_new.astype(dt), n_modes=r1))
        C, n = h.counted(lambda: spr.optimal_placement())
        n_qrcp += n
        if tag == "fp32":
            qrcp_on_panel(spr, C, "the update")
        spr.train(C)
        after = (gappy(spr, X_hold), gappy(spr, X_new))
        runs[tag] = dict(spr=spr, U_fit=U_fit, before=before, after=after,
                         kernels=kernels, dtoh=dtoh, qrcp=n)
        if dtoh > 3:
            fail(f"{tag} update_basis read back {dtoh} times; the JAX code "
                 "reads 3 (S, M and R)")

    # the update's wall, each call on a fresh fp32 model, against a refit
    def fresh():
        spr = SPR(X, 9, xyz, device=dev)
        spr.fit(select_modes="number", n_modes=UPD_R)
        return spr
    walls = [h.per_call_ms({0: (lambda m=m: m.update_basis(
        X_new, n_modes=r1))}, reps=1, warmup=0)[0][0]
        for m in [fresh() for _ in range(5)]]
    X_all = np.hstack([X, X_new])
    refit = {}
    for tag, dt in (("fp32", np.float32), ("float64", np.float64)):
        ref = SPR(X_all.astype(dt), 9, xyz, device=dev)
        ref.fit(select_modes="number", n_modes=r1)
        C, n = h.counted(lambda: ref.optimal_placement())
        n_qrcp += n
        if tag == "fp32":
            qrcp_on_panel(ref, C, "the refit")
        ref.train(C)
        refit[tag] = (ref, gappy(ref, X_hold), gappy(ref, X_new))
    fit_wall = h.per_call_ms({0: lambda: SPR(X_all, 9, xyz, device=dev).fit(
        select_modes="number", n_modes=r1)}, reps=5, warmup=1)[0]
    log(f"  SPR.update_basis(3 snapshots, n_modes {r1}) on fresh fp32 "
        f"models: median {statistics.median(walls):.3f} ms (min "
        f"{min(walls):.3f}, max {max(walls):.3f}; 5 calls, CUDA events); "
        f"{runs['fp32']['kernels']} kernels, {runs['fp32']['dtoh']} "
        f"device-to-host copies (the JAX code reads 3: S, M and R); a full "
        f"fp32 refit on all 41 columns {fit_wall[0]:.3f} ms")

    s32 = runs["fp32"]["spr"].Sigma_r.double().cpu().numpy()
    s64 = runs["float64"]["spr"].Sigma_r.cpu().numpy()
    sig_rel = float(np.max(np.abs(s32 - s64)) / s64[0])
    ang_fit = principal_angles(runs["fp32"]["U_fit"], runs["float64"]["U_fit"])
    U32 = runs["fp32"]["spr"].Ur.double().cpu().numpy()
    U64 = runs["float64"]["spr"].Ur.cpu().numpy()
    ang_upd = principal_angles(U32, U64)
    ang_ref = principal_angles(U64, refit["float64"][0].Ur.cpu().numpy())
    log(f"  singular values after the update, fp32 against float64: max "
        f"|Δσ| / σ₁ {sig_rel:.3e} (≤ {UPD_SIGMA_REL}); σ₁ {s64[0]:.6e}, "
        f"σ₁₅ {s64[-1]:.6e}")
    log(f"  largest principal angle fp32 vs float64 (radians) by leading "
        f"dimension k = 1…{r1}, after the update: "
        + ", ".join(f"{a:.2e}" for a in ang_upd)
        + "; after the fit (k = 1…14): "
        + ", ".join(f"{a:.2e}" for a in ang_fit)
        + f"; float64 update vs float64 refit at k = {r1}: "
        f"{ang_ref[-1]:.3e}")
    for tag in ("fp32", "float64"):
        b, a, rf = runs[tag]["before"], runs[tag]["after"], refit[tag]
        log(f"  {tag} held-out / new-snapshot NRMSE from the sensors: before "
            f"the update {b[0]:.4e} / {b[1]:.4e}; after {a[0]:.4e} / "
            f"{a[1]:.4e}; full refit on 41 columns {rf[1]:.4e} / "
            f"{rf[2]:.4e}; qrcp launches after the update "
            f"{runs[tag]['qrcp']}")
        for what, got, ref in (("held-out", a[0], rf[1]),
                               ("new", a[1], rf[2])):
            bar = max(UPD_NRMSE_SLACK * ref, NRMSE_FLAGSHIP_MAX)
            if not got <= bar:
                fail(f"{tag} {what} NRMSE after the update {got:.3e} above "
                     f"{bar:.3e}")
    if not sig_rel <= UPD_SIGMA_REL:
        fail(f"fp32 updated singular values {sig_rel:.3e} from float64")
    k_res = next((k for k, a in enumerate(ang_fit)
                  if a > UPD_ANGLE_RESOLVED), len(ang_fit))
    if k_res < 1:
        fail("the fp32 fit resolves no leading dimension of float64's basis")
    dk = [float(np.finfo(np.float32).eps) * s64[0] / (s64[k] - s64[k + 1])
          for k in range(k_res)]
    bar = [UPD_ANGLE_FACTOR * ang_fit[k] + UPD_ANGLE_DK * dk[k]
           for k in range(k_res)]
    wider = [k + 1 for k in range(k_res) if not ang_upd[k] <= bar[k]]
    log(f"  the fp32 fit resolves k = 1…{k_res} (angle ≤ "
        f"{UPD_ANGLE_RESOLVED}); the update's angle there / the fit's: "
        + ", ".join(f"{ang_upd[k] / max(ang_fit[k], 1e-300):.3f}"
                    for k in range(k_res))
        + "; / eps32·σ₁/gap: "
        + ", ".join(f"{ang_upd[k] / dk[k]:.3f}" for k in range(k_res))
        + f"; / its bar ({UPD_ANGLE_FACTOR} × the fit's + {UPD_ANGLE_DK} × "
        f"eps32·σ₁/gap): "
        + ", ".join(f"{ang_upd[k] / bar[k]:.3f}" for k in range(k_res)))
    if wider:
        fail(f"the fp32 update widened the angle to float64 at k = {wider} "
             f"(the fit resolves k = 1…{k_res})")
    if runs["fp32"]["qrcp"] != 1:
        fail("the placement after the fp32 update did not launch "
             "csrc/qrcp.cu once")

    # GPR.update_basis with a retrain: the rank grows, so Adam runs afresh
    gp = {}
    for tag, dt in (("fp32", np.float32), ("float64", np.float64)):
        g = GPR(X.astype(dt), 9, xyz, P_tr, device=dev)
        g.fit(select_modes="number", n_modes=UPD_R)
        g.train()
        launches = []
        ms = h.per_call_ms({0: lambda: launches.append(h.chol_counted(
            lambda: g.update_basis(X_new.astype(dt), P_new, n_modes=r1,
                                   retrain=True))[1])},
            reps=1, warmup=0)[0][0]
        A, _ = g.predict(P_hold)
        nr = float(nrmse(g.reconstruct(A).double(),
                         torch.as_tensor(X_hold, dtype=torch.float64,
                                         device=dev)))
        gp[tag] = (nr, launches[0], ms, g._iterations.tolist())
        if tag == "fp32":
            # the kernel's input on this path: the retrained model's
            # jittered kernel matrices at its 41 training points
            K = h.gp_matrices(g)
            (eq, dk, dl), (tk, tl) = h.chol_errors(K)
            log(f"  csrc/chol.cu vs chol_inv_logdet_plain on the retrain's "
                f"matrices {tuple(K.shape)}: equal={eq} (max |ΔK⁻¹| "
                f"{dk:.3e}, |Δlogdet| {dl:.3e}); vs the fp32 Cholesky "
                f"formulation K⁻¹ {tk:.3e}, logdet {tl:.3e}")
            if not eq or tuple(K.shape) != (r1, UPD_M + UPD_NEW,
                                            UPD_M + UPD_NEW):
                fail("csrc/chol.cu differs from its plain version on the "
                     "retrain's matrices")
    g_ref = GPR(X_all.astype(np.float64), 9, xyz, np.vstack([P_tr, P_new]),
                device=dev)
    g_ref.fit(select_modes="number", n_modes=r1)
    g_ref.train()
    nr_ref = float(nrmse(g_ref.reconstruct(g_ref.predict(P_hold)[0]),
                         torch.as_tensor(X_hold, dtype=torch.float64,
                                         device=dev)))
    for tag, (nr, n_chol, ms, its) in gp.items():
        log(f"  GPR.update_basis(n_modes {r1}, retrain=True) {tag}: the rank "
            f"changed, Adam afresh ({its} iterations), {ms:.1f} ms, chol "
            f"launches {n_chol}; held-out NRMSE {nr:.6e} (float64 full refit "
            f"on 41 columns {nr_ref:.6e})")
    if not gp["fp32"][0] <= GPR_NRMSE_SLACK * gp["float64"][0]:
        fail(f"fp32 GPR after update_basis {gp['fp32'][0]:.4e} against "
             f"float64's {gp['float64'][0]:.4e}")
    for tag, (nr, *_) in gp.items():
        if not nr <= UPD_NRMSE_SLACK * nr_ref:
            fail(f"{tag} GPR after update_basis {nr:.4e} against the "
                 f"float64 refit's {nr_ref:.4e}")
    if gp["fp32"][1] < 1:
        fail("the fp32 GPR retrain never launched csrc/chol.cu")
    return n_qrcp, gp["fp32"][1]


def streaming_phase(h, after=None):
    """Phases 21–25: the out-of-core tier on the card, from ``.npy`` files
    written to a temporary directory under ``build/`` and deleted at the
    end, also when a phase fails; ``after(h, tmp)`` (phase 26) runs before
    the deletion, while phase 21's matrix file is there.  Returns (qrcp
    launches at the 3D width, chol launches)."""
    import shutil
    import tempfile
    (ROOT / "build").mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip-smoke-stream-",
                                dir=ROOT / "build"))
    try:
        out = _streaming_phases(h, tmp)
        if after is not None:
            after(h, tmp)
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        h.log(f"  deleted the temporary .npy files under build/{tmp.name}")


def _evict(path):
    """Drop ``path``'s pages from the page cache (written back first), so
    the next read comes from the disk; a no-op on a RAM-backed file
    system."""
    import os
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    finally:
        os.close(fd)


def overlap_check(h, path, m, timed):
    """Whether the reader thread overlaps a disk pass with the caller's
    host work: the fit's per-chunk float64 Gram, timed alone on chunks in
    memory, the bare pass alone, and the two together with prefetch 0
    (sequential) and 2, from the page cache and from a cold cache.  The
    share of the shorter part that prefetch 2 hides is
    (prefetch 0 − prefetch 2) / min(read, compute).  Measured, not held."""
    import numpy as np
    from openmeasure_torch.streaming import iter_chunks, open_store

    st = open_store(path)
    mem = [c.copy() for _, c in iter_chunks(st)]

    def gram(chunks):
        acc = np.zeros((m, m))
        for c in chunks:
            c64 = c.astype(np.float64)
            acc += c64.T @ c64
        return acc

    def both(pf, cold):
        if cold:
            _evict(path)
        return timed(lambda: gram(c for _, c in iter_chunks(st,
                                                            prefetch=pf)))[1]

    def read(cold):
        if cold:
            _evict(path)
        return timed(lambda: [None for _ in iter_chunks(st)])[1]

    comp = statistics.median(timed(lambda: gram(mem))[1] for _ in range(3))
    for cold in (False, True):
        t = {"read": [], 0: [], 2: []}
        for _ in range(3):
            t["read"].append(read(cold))
            t[2].append(both(2, cold))
            t[0].append(both(0, cold))
        rd, p0, p2 = (statistics.median(t[k]) for k in ("read", 0, 2))
        h.log(f"  prefetch overlap, {'cold cache' if cold else 'page cache'}"
              f" ({len(mem)} chunks, medians of 3): disk pass alone "
              f"{rd:.1f} ms, per-chunk float64 Gram alone {comp:.1f} ms; "
              f"both with prefetch 0 {p0:.1f} ms, prefetch 2 {p2:.1f} ms; "
              f"hidden share of the shorter part "
              f"{(p0 - p2) / min(rd, comp):.3f}")
    del mem


def _streaming_phases(h, tmp):
    import numpy as np
    import torch
    from openmeasure_torch import (DMD, ROM, SPR, GPRSensor, SoftSensor,
                                   StreamingDMD, StreamingGPR, StreamingROM,
                                   StreamingSPR)
    from openmeasure_torch.linalg import qrcp as plain
    from openmeasure_torch.streaming import iter_chunks, open_store
    from openmeasure_torch.utils.checkpoint import load_model, save_model
    from openmeasure_torch.utils.metrics import nrmse

    dev, log, fail = h.dev, h.log, h.fail
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    eps32 = float(np.finfo(np.float32).eps)
    cube, flag = h.cube, h.flag
    nf, r = 9, 14

    def timed(fn):
        sync()
        t = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t) * 1e3

    def spread(v):
        return (f"min {min(v):.1f}, median {statistics.median(v):.1f}, "
                f"max {max(v):.1f} ms")

    # ---- phase 21: the 3D set from disk --------------------------------
    X = cube["X_train"]
    n, m = X.shape
    mat = tmp / "cube.npy"
    (_, ms_w) = timed(lambda: np.save(mat, X))
    cols = []
    t0 = time.perf_counter()
    for k in range(m):
        cols.append(str(tmp / f"cube_{k:02d}.npy"))
        np.save(cols[-1], X[:, k])
    ms_c = (time.perf_counter() - t0) * 1e3
    log(f"phase 21: the 3D set from disk ({n:,} rows × {m} snapshots, fp32: "
        f"one matrix .npy of {mat.stat().st_size / 1e6:.1f} MB written in "
        f"{ms_w:.0f} ms, and {m} column files in {ms_c:.0f} ms); "
        f"StreamingSPR(device='cuda').fit(select_modes='number', "
        f"n_modes={r}), the host engine on both layouts and the device "
        f"engine on the matrix, against the in-core SPR fit on the card and "
        f"a float64 fit")

    def sfit(src, engine="host", prefetch=2):
        s = StreamingSPR(src, nf, cube["xyz"], prefetch=prefetch, device=dev)
        _, ms = timed(lambda: s.fit(select_modes="number", n_modes=r,
                                    engine=engine))
        return s, ms

    inc = {}
    for tag, dt in (("fp32", np.float32), ("float64", np.float64)):
        s = SPR(X.astype(dt), nf, cube["xyz"], device=dev)
        s.fit(select_modes="number", n_modes=r)
        inc[tag] = (s.Ur.double().cpu().numpy(),
                    s.Sigma_r.double().cpu().numpy())
        del s
    U64, S64 = inc["float64"]

    fits = {}
    for tag, src, engine in (("host, matrix file", str(mat), "host"),
                             ("host, column files", cols, "host"),
                             ("device, matrix file", str(mat), "device")):
        box = []
        kern_n, dtoh = h.trace_counts(lambda: box.append(sfit(src, engine)))
        s, ms = box[0]
        fits[tag] = s
        log(f"  {tag}: fit {ms:.1f} ms (traced), {s.disk_passes_} disk "
            f"passes, fused Gram {s.gram_fused_}, {s.bytes_uploaded_:,} "
            f"bytes uploaded, device reads {s.device_reads_} (trace: "
            f"{dtoh} device-to-host copies, "
            f"{'not measured' if kern_n is None else kern_n} device kernels)")
    # the float64 spectrum's gaps (the host engine's full-width float64
    # Gram), for the Davis–Kahan bars eps32·σ₁/gap
    Sf = fits["host, matrix file"]._S_full
    gaps = np.array([min(Sf[k - 1] - Sf[k] if k else np.inf,
                         Sf[k] - Sf[k + 1]) for k in range(r)])
    gaps2 = np.array([min(Sf[k - 1] ** 2 - Sf[k] ** 2 if k else np.inf,
                          Sf[k] ** 2 - Sf[k + 1] ** 2) for k in range(r)])
    dk = eps32 * S64[0] / gaps

    def per_mode(U, S):
        cos = np.abs(np.sum(U * U64, axis=0)) / (
            np.linalg.norm(U, axis=0) * np.linalg.norm(U64, axis=0))
        return np.abs(S - S64) / S64[0], np.arccos(np.clip(cos, 0.0, 1.0))

    sig32, ang32 = per_mode(*inc["fp32"])
    log("  in-core fp32 SPR fit against float64, per mode k = 1…14: "
        "|Δσ|/σ₁ " + ", ".join(f"{v:.2e}" for v in sig32)
        + "; angle (rad) " + ", ".join(f"{v:.2e}" for v in ang32))
    log("  eps32·σ₁/gap per mode (float64 spectrum): "
        + ", ".join(f"{v:.2e}" for v in dk))
    for tag, s in fits.items():
        sig, ang = per_mode(s.Ur.double().cpu().numpy(),
                            s.Sigma_r.double().cpu().numpy())
        if tag.startswith("host"):
            # float64 products: only the fp32 statistics and storage round
            sig_bar = np.full(r, STREAM_DK * eps32)
            bound = STREAM_DK * dk
            held = np.ones(r, bool)
        else:
            # an fp32 first Gram: the bound for a Gram's eigenvectors
            sig_bar = STREAM_DK * eps32 * Sf[0] / Sf[:r]
            bound = STREAM_DK * eps32 * Sf[0] ** 2 / gaps2
            held = bound < np.pi / 2
        ang_bar = np.minimum(bound, STREAM_ANGLE_CAP)
        log(f"  {tag} against float64, per mode: |Δσ|/σ₁ "
            + ", ".join(f"{v:.2e}" for v in sig) + "; |cos| "
            + ", ".join(f"{np.cos(v):.9f}" for v in ang)
            + f"; angle / its bar (min(bound, {STREAM_ANGLE_CAP} rad)) "
            + ", ".join(f"{a / b:.3f}" if h_ else
                        f"not held (bound {bd:.2e} rad)"
                        for a, b, bd, h_ in zip(ang, ang_bar, bound, held)))
        bad = [k + 1 for k in range(r)
               if not (sig[k] <= sig_bar[k]
                       and (ang[k] <= ang_bar[k] or not held[k]))]
        if bad:
            fail(f"streaming fit ({tag}) departs from float64 at modes {bad}")
    if not torch.equal(fits["host, matrix file"].Ur,
                       fits["host, column files"].Ur):
        fail("the two on-disk layouts gave different bases")

    sm = fits["host, matrix file"]
    C, n_qr = h.counted(lambda: sm.optimal_placement())
    eq, pk, pp, err, _, same_nf = h.kernel_vs_plain(sm.Ur.T, r, None)
    rows = C.argmax(dim=1).cpu().numpy()
    want = plain.qrcp_pivots(sm.Ur.T, r).cpu().numpy()
    log(f"  optimal_placement('qr') on the streamed basis {tuple(sm.Ur.T.shape)}"
        f": csrc/qrcp.cu launches {n_qr}, pivots equal to the plain sweep on "
        f"the same Ur={bool(np.array_equal(rows, want))} (kernel_vs_plain "
        f"{eq}, final norms equal {err == 0.0 and same_nf})")
    if n_qr != 1 or not (eq and np.array_equal(rows, want)
                         and np.array_equal(pk, rows)):
        fail("the streamed model's placement is not one csrc/qrcp.cu launch "
             "equal to the plain sweep")
    # phase 26 fits the same file on a mesh of one rank
    h.stream3d = dict(path=str(mat), Ur=sm.Ur, Sigma_r=sm.Sigma_r, Ar=sm.Ar,
                      rows=rows)
    sm.train(C)
    T3 = cube["X_test"]
    ys = [np.column_stack([T3[rows, j], np.zeros(r), rows // (n // nf)])
          for j in range(T3.shape[1])]
    a, _ = sm.predict(ys)
    xr = sm.reconstruct(a)
    nr3 = float(nrmse(xr.double(), torch.as_tensor(T3, dtype=torch.float64,
                                                   device=dev)))
    log(f"  train → predict → reconstruct the {T3.shape[1]} held-out "
        f"snapshots: NRMSE {nr3:.4e} (≤ {NRMSE_3D_MAX})")
    if tuple(xr.shape) != T3.shape or not bool(torch.isfinite(xr).all()) \
            or not nr3 <= NRMSE_3D_MAX:
        fail(f"3D streamed reconstruction NRMSE {nr3:.3e}")

    # walls: 3 fits each, prefetch 2 and 0 and the device engine in
    # turns; bare disk passes
    walls = {2: [], 0: [], "device": []}
    for _ in range(3):
        for pf in (2, 0):
            walls[pf].append(sfit(str(mat), prefetch=pf)[1])
        walls["device"].append(sfit(str(mat), "device")[1])
    passes = {}
    for tag, src in (("matrix file", str(mat)), ("column files", cols)):
        st = open_store(src)
        passes[tag] = [timed(lambda: [None for _ in iter_chunks(st)])[1]
                       for _ in range(3)]
    up = timed(lambda: torch.as_tensor(np.empty((n, r), np.float32)
                                       ).to(dev))[1]
    overlap_check(h, str(mat), m, timed)
    med = statistics.median(walls[2])
    h.stream3d["ms"] = med
    disk = statistics.median(passes["matrix file"])
    log(f"  host-engine fit from the matrix file, 3 fits: prefetch 2 "
        f"{spread(walls[2])}; prefetch 0 {spread(walls[0])} (prefetch 0 / 2 "
        f"= {statistics.median(walls[0]) / med:.3f}); {n / (med / 1e3):,.0f} "
        f"rows a second; the device engine {spread(walls['device'])}")
    log(f"  one bare disk pass (iter_chunks, 64 MiB chunks, prefetch 2): "
        f"matrix file {spread(passes['matrix file'])}, column files "
        f"{spread(passes['column files'])}; the (n, r) upload alone "
        f"{up:.1f} ms; so of the fit's {med:.1f} ms: 2 disk passes "
        f"{2 * disk:.1f}, upload {up:.1f}, the rest ({med - 2 * disk - up:.1f}"
        f") host float64 BLAS and statistics beside the reads")

    # ---- phase 22: median scaling from column files -----------------------
    F = flag["X_train"]
    fcols = []
    for k in range(F.shape[1]):
        fcols.append(str(tmp / f"flag_{k:02d}.npy"))
        np.save(fcols[-1], F[:, k])
    rows_chunk = STREAM_MEDIAN_ROWS
    log(f"phase 22: median scaling at flagship width from {len(fcols)} "
        f"column files, chunks of {rows_chunk:,} rows (feature blocks of "
        f"{F.shape[0] // nf:,} rows, so chunks cut blocks); X_scl must equal "
        f"the in-core scale_data('median') exactly")
    sr = StreamingROM(fcols, nf, flag["xyz"], chunk_rows=rows_chunk,
                      device=dev)
    _, ms = timed(lambda: sr.fit(scale_type="median", select_modes="number",
                                 n_modes=r))
    ic = ROM(F, nf, flag["xyz"], device=dev)
    ic.scale_data("median")
    same = bool(torch.equal(sr.X_scl, ic.X_scl))
    log(f"  streamed median fit {ms:.1f} ms, {sr.disk_passes_} disk passes; "
        f"X_scl equal to the in-core one={same}; max |ΔX_cnt| "
        f"{float((sr.X_cnt - ic.X_cnt).abs().max()):.3e} (row means: "
        f"float64 then fp32 against fp32 on the card)")
    if not same:
        fail("streamed median X_scl differs from the in-core scale_data")

    # ---- phase 23: the GP from disk --------------------------------------
    fmat = tmp / "flag.npy"
    np.save(fmat, F)
    log(f"phase 23: StreamingGPR at flagship width from the matrix file "
        f"({F.shape[0]:,} × {F.shape[1]}, P_train {flag['P_train'].shape}), "
        f"train (up to 1000 Adam iterations, csrc/chol.cu), predict; fp32 "
        f"against the float64 run")
    gps, n_chol = {}, 0
    T64 = torch.as_tensor(flag["X_test"], dtype=torch.float64, device=dev)
    for tag, dt in (("fp32", np.float32), ("float64", np.float64)):
        g = StreamingGPR(str(fmat), nf, flag["xyz"], flag["P_train"],
                         dtype=dt, device=dev)
        _, ms_fit = timed(lambda: g.fit(select_modes="number", n_modes=r))
        (_, n), ms_tr = timed(lambda: h.chol_counted(lambda: g.train()))
        if tag == "fp32":
            n_chol = n
        A, _ = g.predict(flag["P_test"])
        nr = float(nrmse(g.reconstruct(A).double(), T64))
        gps[tag] = g
        log(f"  {tag}: fit {ms_fit:.1f} ms, train {ms_tr:.1f} ms ({n} "
            f"csrc/chol.cu launches, Adam iterations "
            f"{g._iterations.tolist()}), held-out NRMSE {nr:.6e}")
        gps[tag + " nrmse"] = nr
    g32 = gps["fp32"]
    K = h.gp_matrices(g32)
    (eqk, dkk, dl), _ = h.chol_errors(K)
    log(f"  csrc/chol.cu vs chol_inv_logdet_plain on the trained model's "
        f"matrices {tuple(K.shape)}: equal={eqk}")
    if not eqk:
        fail("csrc/chol.cu differs from its plain version on the streamed "
             "GP's matrices")
    if n_chol < 1:
        fail("the streamed GP never launched csrc/chol.cu")
    if not gps["fp32 nrmse"] <= GPR_NRMSE_SLACK * gps["float64 nrmse"]:
        fail(f"streamed fp32 GP NRMSE {gps['fp32 nrmse']:.4e} against "
             f"float64's {gps['float64 nrmse']:.4e}")

    # ---- phase 24: checkpoints -------------------------------------------
    log(f"phase 24: save_model of the 3D StreamingSPR and the flagship "
        f"StreamingGPR, then SoftSensor.load and GPRSensor.load on the card; "
        f"a batch of {SERVE_BATCH} must predict torch.equal to the sensor "
        f"built in memory")
    rng = np.random.default_rng(24)
    Yb = np.stack([T3[rows, j % T3.shape[1]] for j in range(SERVE_BATCH)])
    Yb = Yb * (1.0 + 1e-3 * rng.standard_normal(Yb.shape)).astype(Yb.dtype)
    Pb = flag["P_test"][rng.integers(0, flag["P_test"].shape[0],
                                     SERVE_BATCH)] \
        * (1.0 + 0.01 * rng.standard_normal((SERVE_BATCH, 3)))
    for tag, model, mk, load, arg in (
            ("StreamingSPR 3D", sm, SoftSensor.from_spr, SoftSensor.load,
             Yb),
            ("StreamingGPR flagship", g32, GPRSensor.from_gpr,
             GPRSensor.load, Pb)):
        path = tmp / f"{tag.split()[0]}.npz"
        _, ms_s = timed(lambda: save_model(model, str(path)))
        loaded, ms_l = timed(lambda: load(str(path), device=dev))
        ref = mk(model)
        out_l = (loaded.predict_batch(arg) if hasattr(loaded,
                                                      "predict_batch")
                 else loaded(arg))[0]
        out_r = (ref.predict_batch(arg) if hasattr(ref, "predict_batch")
                 else ref(arg))[0]
        eqs = bool(torch.equal(out_l, out_r))
        back = load_model(str(path), device=dev)
        log(f"  {tag}: checkpoint {path.stat().st_size / 1e6:.1f} MB, saved "
            f"in {ms_s:.0f} ms, loaded into a sensor in {ms_l:.0f} ms "
            f"(restores as {type(back).__name__} on {back.Ur.device}); batch "
            f"of {SERVE_BATCH} {tuple(out_l.shape)} equal to the in-memory "
            f"sensor's={eqs}")
        if not eqs or out_l.device.type != dev.type:
            fail(f"the loaded {tag} sensor differs from the one built in "
                 "memory")

    # ---- phase 25: StreamingDMD ------------------------------------------
    Xs, Xs_test, xyz_s, _ = dynamics_series()
    dmat = tmp / "dynamics.npy"
    np.save(dmat, Xs)
    log(f"phase 25: StreamingDMD on phase 18's series ({Xs.shape[0]:,} × "
        f"{Xs.shape[1]}, from a matrix file) against the in-core DMD, "
        f"n_modes 8")
    sd = StreamingDMD(str(dmat), 2, xyz_s, device=dev)
    _, ms = timed(lambda: sd.fit(dt=1.0, select_modes="number", n_modes=8))
    dd = {}
    for tag, dt in (("fp32", np.float32), ("float64", np.float64)):
        d_ = DMD(Xs.astype(dt), 2, xyz_s, device=dev)
        d_.fit(dt=1.0, select_modes="number", n_modes=sd.r)
        dd[tag] = d_

    def top(d_):
        return np.sort_complex(d_.eigs[np.argsort(-np.abs(d_.amplitudes))
                                       [:6]])

    err = {tag: float(np.max(np.abs(top(sd) - top(d_))))
           for tag, d_ in dd.items()}
    fc = float(nrmse(sd.forecast_horizon(10).double(),
                     torch.as_tensor(Xs_test[:, :10], dtype=torch.float64,
                                     device=dev)))
    log(f"  fit {ms:.1f} ms, {sd.disk_passes_} disk passes, rank {sd.r}; the "
        f"6 largest-amplitude eigenvalues against the in-core float64 DMD "
        f"max|Δλ| {err['float64']:.3e} (≤ {DMD_EIG_ABS}), against fp32 "
        f"{err['fp32']:.3e}; 10-step forecast NRMSE {fc:.4f} (< 0.2)")
    if not (err["float64"] <= DMD_EIG_ABS and fc < 0.2):
        fail("StreamingDMD departs from the in-core DMD")
    return n_qr, n_chol


def sharded_phase(h, tmp):
    """Phase 26: sharding over torch.distributed at flagship width.  (a) A
    world of one with NCCL: each sharded entry point held ``torch.equal``
    to the same call with no mesh, through the kernels.  (b) Two gloo
    ranks on the one card (NCCL refuses two ranks on one GPU), spawned by
    ``parallel.harness.dryrun_sharded``: the checks of the JAX package's
    ``dryrun_multichip`` at flagship width, each sharded call against the
    unsharded one on the same inputs.  Sets ``h.phase26`` to the launches
    of (a): (qrcp at the flagship width, qrcp at the 3D width, chol)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from openmeasure_torch import SPR, SoftSensor, StreamingSPR
    from openmeasure_torch.gp import exact_gp as E
    from openmeasure_torch.parallel import harness as H
    from openmeasure_torch.parallel import sharded as S
    from openmeasure_torch.parallel._comm import Axis
    from openmeasure_torch.pipelines import mfk_end_to_end

    dev, log, fail, flag = h.dev, h.log, h.fail, h.flag
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    nf, r = 9, 14
    X, Xt = flag["X_train"], flag["X_test"]
    n, m = X.shape
    npts = n // nf

    def ev_ms(fn, reps=10):
        """Median wall of one call of ``fn`` by CUDA events (host clock
        off the card)."""
        fn()
        sync()
        ts = []
        for _ in range(reps):
            if cuda:
                a, b = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                a.record()
                fn()
                b.record()
                b.synchronize()
                ts.append(a.elapsed_time(b))
            else:
                t = time.perf_counter()
                fn()
                ts.append((time.perf_counter() - t) * 1e3)
        return statistics.median(ts)

    def collectives(fn):
        c0 = Axis.collectives
        out = fn()
        sync()
        return out, Axis.collectives - c0

    def same(a, b):
        return all(bool(torch.equal(x, y)) for x, y in zip(a, b))

    # ---- (a) NCCL, a world of one --------------------------------------
    t0 = time.perf_counter()
    mesh = S.make_mesh(1, 1, device=dev)
    init_ms = (time.perf_counter() - t0) * 1e3
    log(f"phase 26(a): a world of one ({dist.get_backend()}), mesh "
        f"(state 1, mode 1): init {init_ms:.1f} ms")
    try:
        Xb, Xtb = (S.shard_snapshots(A, nf, mesh) for A in (X, Xt))
        (res1, n_coll), n_qr = h.counted(lambda: collectives(
            lambda: S.sharded_spr_step(Xb, Xtb, r, mesh=mesh)))
        res0 = S.sharded_spr_step(Xb, Xtb, r)
        ms1 = ev_ms(lambda: S.sharded_spr_step(Xb, Xtb, r, mesh=mesh))
        ms0 = ev_ms(lambda: S.sharded_spr_step(Xb, Xtb, r))
        nr = float(res1[0])
        log(f"  sharded_spr_step {(n, m)} + {Xt.shape[1]} test, r = {r}: "
            f"torch.equal to no mesh={same(res1, res0)}, csrc/qrcp.cu "
            f"launches {n_qr}, collectives {n_coll}, NRMSE {nr:.4e} (≤ "
            f"{NRMSE_FLAGSHIP_MAX}); wall {ms1:.4f} ms with the mesh, "
            f"{ms0:.4f} ms without (CUDA events, median of 10)")
        if not (same(res1, res0) and n_qr == 1 and nr <= NRMSE_FLAGSHIP_MAX):
            fail("the sharded SPR step on a world of one departs from the "
                 "unsharded call")
        Xb64 = X.astype(np.float64).reshape(nf, npts, -1)
        f_lo, f_hi = Xb64.min(axis=(1, 2)), Xb64.max(axis=(1, 2))
        span = f_hi - f_lo
        lims = np.stack([f_lo - SERVE_PAD * span, f_hi + SERVE_PAD * span])
        (c1, n_coll), n_qr_c = h.counted(lambda: collectives(
            lambda: S.sharded_spr_cols_step(Xb, Xtb, r, lims[0], lims[1],
                                            max_iter=SHARD_COLS_ITERS,
                                            mesh=mesh)))
        c0 = S.sharded_spr_cols_step(Xb, Xtb, r, lims[0], lims[1],
                                     max_iter=SHARD_COLS_ITERS)
        nrc = float(c1[0])
        eqc = same(c1[:3], c0[:3]) and same(c1[3], c0[3])
        log(f"  sharded_spr_cols_step (limits ± {SERVE_PAD:.0%} of each "
            f"feature's span, max_iter {SHARD_COLS_ITERS}): torch.equal to "
            f"no mesh={eqc}, csrc/qrcp.cu launches {n_qr_c}, collectives "
            f"{n_coll}, NRMSE {nrc:.4e} (≤ {NRMSE_FLAGSHIP_MAX})")
        if not (eqc and n_qr_c == 1 and nrc <= NRMSE_FLAGSHIP_MAX):
            fail("the sharded COLS step on a world of one departs from the "
                 "unsharded call")

        # the 3D fit from phase 21's matrix file, on the mesh
        st = h.stream3d
        s3 = StreamingSPR(st["path"], nf, h.cube["xyz"], device=dev)
        t0 = time.perf_counter()
        s3.fit(select_modes="number", n_modes=r, mesh=mesh)
        sync()
        ms3 = (time.perf_counter() - t0) * 1e3
        C3, n_qr3 = h.counted(lambda: s3.optimal_placement())
        rows3 = C3.argmax(dim=1).cpu().numpy()
        eq3 = (bool(torch.equal(s3.Ur, st["Ur"]))
               and bool(torch.equal(s3.Sigma_r, st["Sigma_r"]))
               and bool(torch.equal(s3.Ar, st["Ar"])))
        log(f"  StreamingSPR.fit(mesh=…) on phase 21's matrix file "
            f"{tuple(s3.Ur.shape)}: Ur, Sigma_r, Ar torch.equal to phase "
            f"21's fit={eq3}, fit_mesh_ set={s3.fit_mesh_ is mesh}; wall "
            f"{ms3:.1f} ms (phase 21's median {st['ms']:.1f} ms); QR "
            f"placement: csrc/qrcp.cu launches {n_qr3}, pivots equal="
            f"{bool(np.array_equal(rows3, st['rows']))}")
        if not (eq3 and s3.fit_mesh_ is mesh and n_qr3 == 1
                and np.array_equal(rows3, st["rows"])):
            fail("the sharded 3D streaming fit on a world of one departs "
                 "from phase 21's")
        del s3, C3

        # the GP: Vr of the world-of-one basis, 14 modes
        fit = S._fit_and_place(Xb, r, "std", mesh, None)
        X0 = S._scale_blocks(Xb)[0].reshape(n, m)
        Ar = X0.T @ fit.Ur
        Vr = Ar / torch.linalg.vector_norm(Ar, dim=0)[None, :]
        P = torch.as_tensor(flag["P_train"], dtype=torch.float32,
                            device=dev)
        P0 = (P - P.mean(0)) / (P.std(0, correction=0) + 1e-8)
        (g1, n_coll), n_chol_g = h.chol_counted(lambda: collectives(
            lambda: S.sharded_gpr_train(mesh, P0, Vr, max_iter=1000)))
        mean, kernel_, lik = S._specs()
        Y = Vr.T.contiguous()
        g0 = E.adam_early_stop(
            E.make_single_task_loss(mean, kernel_, lik, P0, Y),
            S.init_mode_stacked_params(r, 3, torch.float32, dev), lr=0.1,
            max_iter=1000, rel_error=1e-5,
            value_and_grad=E.make_single_task_value_and_grad(
                mean, kernel_, lik, P0, Y))
        eqg = (bool(torch.equal(g1.loss, g0.loss))
               and bool(torch.equal(g1.iterations, g0.iterations)))
        it = g1.iterations.cpu().numpy()
        log(f"  sharded_gpr_train ({P0.shape[0]}, {P0.shape[1]}) × {r} "
            f"modes, max_iter 1000: losses and iterations torch.equal to "
            f"adam_early_stop={eqg}, iterations {it.min()}–{it.max()}, "
            f"csrc/chol.cu launches {n_chol_g}, collectives {n_coll}")
        if not eqg or n_chol_g < 1:
            fail("the sharded GP trainer on a world of one departs from "
                 "adam_early_stop")

        # the sharded COLS sensor at batch 50
        spr = SPR(X, nf, flag["xyz"], device=dev)
        spr.fit(select_modes="number", n_modes=r)
        C, n_qr_s = h.counted(lambda: spr.optimal_placement())
        spr.train(C, method="COLS", limits=[lims[0], lims[1]])
        rows = C.argmax(dim=1).cpu().numpy()
        frames = np.tile(Xt[rows].T, (13, 1))[:SERVE_BATCH]
        Yf = torch.as_tensor(frames, device=dev)
        serve_ms = {}
        for mode in ("adaptive", "fixed"):
            s0 = SoftSensor.from_spr(spr, admm_iters=SERVE_ITERS,
                                     admm_rho=mode).warmup()
            s1 = s0.shard(mesh)
            out1, n_coll = collectives(lambda: s1.predict_batch(Yf))
            out0 = s0.predict_batch(Yf)
            n_sync = h.host_syncs(lambda: s1.predict_batch(Yf))
            _, dtoh = h.trace_counts(lambda: s1.predict_batch(Yf))
            serve_ms[mode] = (ev_ms(lambda: s1.predict_batch(Yf))
                              / SERVE_BATCH,
                              ev_ms(lambda: s0.predict_batch(Yf))
                              / SERVE_BATCH)
            log(f"  SoftSensor.shard(mesh), COLS, {mode} ρ, batch "
                f"{SERVE_BATCH}, {SERVE_ITERS} iterations: torch.equal to "
                f"the unsharded sensor={same(out1, out0)}, {dtoh} "
                f"device-to-host copies, {n_sync} synchronizing calls, "
                f"collectives {n_coll}; a frame {serve_ms[mode][0]:.4f} ms "
                f"sharded, {serve_ms[mode][1]:.4f} ms unsharded (CUDA "
                f"events, median of 10 batches / {SERVE_BATCH})")
            if not same(out1, out0) or dtoh or n_sync:
                fail(f"the sharded {mode}-ρ sensor departs from the "
                     "unsharded one or reads back to the host")

        # co-kriging, configuration A, fp32
        prob = [a.astype(np.float32) for a in mfk_problem()]
        m1, n_chol_m = h.chol_counted(
            lambda: S.sharded_mfk_end_to_end(mesh, *prob))
        m0 = mfk_end_to_end(*prob, device=dev)
        log(f"  sharded_mfk_end_to_end (configuration A, K = 8): "
            f"torch.equal to mfk_end_to_end={same(m1, m0)}, csrc/chol.cu "
            f"launches {n_chol_m}")
        if not same(m1, m0):
            fail("the sharded co-kriging on a world of one departs from "
                 "mfk_end_to_end")
    finally:
        dist.destroy_process_group()
    h.phase26 = (n_qr + n_qr_c + n_qr_s, n_qr3, n_chol_g + n_chol_m)

    # ---- (b) two gloo ranks on the one card ----------------------------
    store = str(tmp / "shard_X_train.npy")
    np.save(store, H.dryrun_data(npts, nf)[0])
    log(f"phase 26(b): parallel.harness.dryrun_sharded on two gloo ranks on "
        f"the one card, {npts:,} cells × {nf} features (n = {n:,}), the "
        f"dryrun's r = {DRYRUN_R}, GP ≤ 1000 iterations on two mode ranks, "
        f"the streamed fit from a matrix file; walls of this world are not "
        f"a speed figure")
    t0 = time.perf_counter()
    res = H.dryrun_sharded(2, 1, device=dev.type, n_cells=npts, r=DRYRUN_R,
                           gp_iters=1000, store=store, backend="gloo",
                           timeout_s=SHARD_WORLD_TIMEOUT, workdir=str(tmp))
    log(f"  world of 2 ran in {time.perf_counter() - t0:.1f} s (spawn, "
        "CUDA start and the checks)")
    for rank, got in enumerate(res):
        cost = ", ".join(f"{k} {c} ({ms:.1f} ms)"
                         for k, (c, ms) in got["cost"].items())
        log(f"  rank {rank}: the dryrun's bars held (QR sweep equal to the "
            f"kernel's and the plain sweep's, GEM/DG/VDG equal to the "
            f"unsharded, OLS coefficients exact, streamed fit equal); SPR "
            f"NRMSE {got['nrmse']:.4e} (Δ {got['d_nrmse']:.2e} to no mesh); "
            f"GP iterations {got['gpr_iters'][0]}–{got['gpr_iters'][1]} "
            f"equal to the unsharded trainer's, losses max rel "
            f"{got['d_gpr_rel']:.2e}; COLS sensor coefficients "
            f"{got['d_cols_serving_rel']:.3e} of max|a| (≤ "
            f"{SERVE_COEF_REL}); collectives (wall) a call: {cost}")
        # check_dryrun held the dryrun's bars; the GP's is 1e-6 here
        if not got["d_gpr_rel"] <= 1e-6:
            fail(f"rank {rank}: the GP on two mode ranks departs from the "
                 "unsharded trainer")


def sharded_phases(h, tmp):
    """Phases 26 and 27, while phase 21's matrix file exists."""
    sharded_phase(h, tmp)
    t0 = time.perf_counter()
    sharded_update_phase(h, tmp)
    h.log(f"  phase 27 took {time.perf_counter() - t0:.1f} s")


def _unequal(a, b, path=""):
    """The paths at which two nested results (dicts, tuples, tensors,
    arrays, scalars) differ; tensors by ``torch.equal``."""
    import numpy as np
    import torch
    if isinstance(a, dict):
        return [p for k in a for p in _unequal(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, (tuple, list)):
        return [p for i, (x, y) in enumerate(zip(a, b))
                for p in _unequal(x, y, f"{path}[{i}]")]
    if isinstance(a, torch.Tensor):
        ok = a.dtype == b.dtype and bool(torch.equal(a, b))
    elif isinstance(a, np.ndarray):
        ok = np.array_equal(a, b)
    else:
        ok = a == b
    return [] if ok else [path]


def sharded_update_phase(h, tmp):
    """Phase 27: the post-fit methods after ``fit(mesh=…)`` through
    ``parallel.harness.update_flows``: ``update_basis`` with new snapshots
    from column files, the refreshed Theta and the QR placement after it,
    COLS under limits ± 5 % of each feature's span and a user constraint
    set on the first three coefficients, ``CPOD`` under both, and
    ``StreamingGPR.update_basis(retrain=True)``.  (a) An NCCL world of one:
    the SPR flow on phase 21's 3D matrix file with 3 held-out 3D
    snapshots, the GP flow at flagship width, every output ``torch.equal``
    to the calls with no mesh, the same kernel launches, 0 collectives.
    (b) Two gloo ranks on the card at flagship width and the dryrun's r:
    both flows held against the unsharded ones by
    ``harness.check_update``.  Sets ``h.phase27`` to the launches of (a)'s
    mesh flows: (qrcp at the 3D width, chol)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from openmeasure_torch.datasets.synthetic import make_flame_dataset
    from openmeasure_torch.parallel import harness as H
    from openmeasure_torch.parallel import sharded as S
    from openmeasure_torch.parallel._comm import Axis

    dev, log, fail = h.dev, h.log, h.fail
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    nf, r = 9, 14
    cube = h.cube
    npts = h.flag["X_train"].shape[0] // nf

    def columns(tag, A):
        paths = []
        for k in range(A.shape[1]):
            paths.append(str(tmp / f"{tag}_{k}.npy"))
            np.save(paths[-1], np.ascontiguousarray(A[:, k]))
        return paths

    def limits_of(X):
        Xb = X.reshape(nf, -1, X.shape[1])
        lo = Xb.min(axis=(1, 2)).astype(np.float64)
        hi = Xb.max(axis=(1, 2)).astype(np.float64)
        return [lo - SERVE_PAD * (hi - lo), hi + SERVE_PAD * (hi - lo)]

    new3 = columns("new3d", cube["X_test"][:, :UPD27_NEW])
    # the flagship set with 4 held-out snapshots: 3 arrive as new, the GP
    # predicts the last one's parameters
    fd = make_flame_dataset(n_cells=npts, n_features=nf, m_train=41,
                            m_test=UPD27_NEW + 1, seed=0, dtype=np.float32)
    Xf, xyzf = fd["X_train"], fd["xyz"]
    flag_path = str(tmp / "update_X_train.npy")
    np.save(flag_path, Xf)
    newf = columns("newflag", fd["X_test"][:, :UPD27_NEW])
    gp_kw = dict(P=fd["P_train"], P_new=fd["P_test"][:UPD27_NEW],
                 P_test=fd["P_test"][UPD27_NEW:], gp_iters=UPD27_GP_ITERS)

    # ---- (a) NCCL, a world of one --------------------------------------
    rec = {"plain": {}, "mesh": {}}

    def probe(tag, key, fn):
        c0 = Axis.collectives
        sync()
        t0 = time.perf_counter()
        (out, n_chol), n_qr = h.counted(lambda: h.chol_counted(fn))
        rec[tag][key] = (n_qr, n_chol, Axis.collectives - c0,
                         (time.perf_counter() - t0) * 1e3)
        return out

    mesh = S.make_mesh(1, 1, device=dev)
    log(f"phase 27(a): the post-fit methods after fit(mesh=…) on a world of "
        f"one ({dist.get_backend()}): StreamingSPR on phase 21's matrix file "
        f"({cube['X_train'].shape[0]:,} × {cube['X_train'].shape[1]}, r = "
        f"{r}) → update_basis with {UPD27_NEW} held-out 3D snapshots from "
        f"column files → QR placement → COLS (limits ± {SERVE_PAD:.0%} of "
        f"each feature's span and 3 coefficient rows, ≤ {UPD27_ADMM} ADMM "
        f"iterations) → predict → CPOD; StreamingGPR at flagship width "
        f"({Xf.shape[0]:,} × {Xf.shape[1]}, r = {r}, {UPD27_GP_ITERS} Adam "
        f"iterations) → update_basis({UPD27_NEW} snapshots, retrain=True); "
        f"each beside the same calls with no mesh")
    try:
        a_spr = H.update_flows(mesh, h.stream3d["path"], new3, nf, r,
                               cube["xyz"], dtype=np.float32,
                               limits=limits_of(cube["X_train"]),
                               admm_iters=UPD27_ADMM, cpod=("both",),
                               gp=False, probe=probe)
        a_gp = H.update_flows(mesh, flag_path, newf, nf, r, xyzf,
                              dtype=np.float32, spr=False, probe=probe,
                              **gp_kw)
    finally:
        dist.destroy_process_group()
    bad = (_unequal(a_spr["mesh"], a_spr["plain"], "SPR")
           + _unequal(a_gp["mesh"], a_gp["plain"], "GP"))
    for key in rec["mesh"]:
        (q1, c1, k1, ms1), (q0, c0, _, ms0) = rec["mesh"][key], \
            rec["plain"][key]
        log(f"  {key}: wall {ms1:.1f} ms with the mesh, {ms0:.1f} ms "
            f"without; csrc/qrcp.cu launches {q1} / {q0}, csrc/chol.cu "
            f"launches {c1} / {c0}, collectives {k1}")
        if (q1, c1) != (q0, c0) or k1:
            bad.append(f"launches or collectives of {key}")
    U, S_, _, _, r_new = a_spr["mesh"]["update"]
    Ya, its, rec3 = a_spr["mesh"]["cols"]
    truth = torch.as_tensor(cube["X_test"][:, :UPD27_NEW], device=dev)
    nr = float(torch.sqrt(torch.mean((rec3.double() - truth) ** 2))
               / (truth.max() - truth.min()))
    gp = a_gp["mesh"]["gp"]
    log(f"  torch.equal to the calls with no mesh={not bad}; the update: "
        f"Ur {tuple(U.shape)}, σ₁ {float(S_[0]):.6e}, r {r_new}; QR after "
        f"it: csrc/qrcp.cu launches {rec['mesh']['qr'][0]} at "
        f"({r_new}, {U.shape[0]:,}); COLS ADMM iterations "
        f"{its.min().item()}–{its.max().item()}, the {UPD27_NEW} new "
        f"snapshots reconstructed from the sensors: NRMSE {nr:.4e}; CPOD "
        f"iterations {a_spr['mesh']['cpod_both'][1].min().item()}–"
        f"{a_spr['mesh']['cpod_both'][1].max().item()}; GP retrain "
        f"iterations {gp[3].min().item()}–{gp[3].max().item()}, csrc/chol.cu "
        f"launches {rec['mesh']['gp_update'][1]}")
    if bad:
        fail(f"phase 27(a) departs from the calls with no mesh at {bad}")
    if rec["mesh"]["qr"][0] != 1 or rec["mesh"]["gp_update"][1] < 1:
        fail("phase 27(a): the placement after the update is not one "
             "csrc/qrcp.cu launch, or the retrain launched no csrc/chol.cu")
    finite = all(bool(torch.isfinite(t).all()) for t in
                 (U, S_, Ya, rec3, a_spr["mesh"]["cpod_both"][0], gp[5]))
    if not finite or tuple(rec3.shape) != tuple(truth.shape):
        fail("phase 27(a): non-finite or misshapen outputs")
    h.phase27 = (rec["mesh"]["qr"][0], rec["mesh"]["gp_update"][1])

    # ---- (b) two gloo ranks on the one card ----------------------------
    kw = dict(src=flag_path, new=newf, nf=nf, r=DRYRUN_R, xyz=xyzf,
              dtype=np.float32, limits=limits_of(Xf), admm_iters=UPD27_ADMM,
              cpod=("both",), **gp_kw)
    log(f"phase 27(b): the same flows at flagship width and the dryrun's r "
        f"= {DRYRUN_R} on two ranks ({H.default_backend(dev.type, 2)}), "
        f"each rank against the unsharded calls: σ within {UPD_SIGMA_REL} "
        f"of σ₁, each leading subspace's angle within {UPD_ANGLE_DK:g}·eps32"
        f"·σ₁/gap, QR pivots equal, COLS and CPOD coefficients within "
        f"{SERVE_COEF_REL} of max|a|, the GP's σ as the SPR's and its "
        f"NRMSE at the held-out parameters within {UPD27_GP_SLACK} × the "
        f"unsharded flow's")
    t0 = time.perf_counter()
    res = H.run_world(H.update_rank, 2, 1, dev.type, SHARD_WORLD_TIMEOUT,
                      args=(kw,), workdir=str(tmp))
    log(f"  world of 2 ran in {time.perf_counter() - t0:.1f} s")
    for rank, out in enumerate(res):
        try:
            d = H.check_update(out, fd["X_test"][:, UPD27_NEW:], UPD_SIGMA_REL,
                               SERVE_COEF_REL, UPD_ANGLE_DK, UPD27_GP_SLACK)
        except AssertionError as e:
            fail(f"phase 27(b), rank {rank}: {e}")
        ang = max(a / b for a, b in zip(d["angle"], d["angle_bar"]))
        cost = "; ".join(
            f"{k} {c} ({ms:.1f} ms, {out['cost']['plain'][k][1]:.1f} ms "
            f"unsharded)" for k, (c, ms) in out["cost"]["mesh"].items())
        log(f"  rank {rank}: |Δσ|/σ₁ {d['d_sigma']:.3e}, largest angle / "
            f"its bar {ang:.3e}, QR pivots equal, COLS {d['d_cols']:.3e} and "
            f"CPOD {d['d_cpod_both']:.3e} of max|a|; GP σ "
            f"{d['d_gp_sigma']:.3e}, NRMSE {d['gp_nrmse'][1]:.4e} against "
            f"{d['gp_nrmse'][0]:.4e} unsharded, iterations "
            f"{d['gp_iters'][1].tolist()} against "
            f"{d['gp_iters'][0].tolist()}, posterior mean "
            f"{d['d_gp_mean']:.3e} of its max; "
            f"collectives (wall) a call: {cost}")


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not (ROOT / "openmeasure_torch" / "__init__.py").is_file():
        print(f"chip_smoke: the openmeasure_torch package is not beside "
              f"{Path(__file__).name}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))

    import numpy as np
    import openmeasure_torch  # noqa: F401  (pins full-fp32 matmuls)
    from openmeasure_torch import GPR, ROM, SPR, GPRSensor, SoftSensor, _build
    from openmeasure_torch.core import scaling
    from openmeasure_torch.datasets.synthetic import make_flame_dataset
    from openmeasure_torch.gp import exact_gp
    from openmeasure_torch.gp import gp_step as gp_step_mod
    from openmeasure_torch.linalg import admm_cuda as admm_k
    from openmeasure_torch.linalg import boxls as boxls_mod
    from openmeasure_torch.linalg import chol as chol_plain
    from openmeasure_torch.linalg import chol_cuda as chol_kern
    from openmeasure_torch.linalg import qrcp as plain
    from openmeasure_torch.linalg import qrcp_cuda as kern
    from openmeasure_torch.linalg import svd
    from openmeasure_torch.pipelines import gpr_end_to_end, spr_end_to_end
    from openmeasure_torch.utils import logging as tlog
    from openmeasure_torch.utils.convert import gpr_from_numpy
    from openmeasure_torch.utils.metrics import nrmse
    from openmeasure_torch.utils.timing import device_ms

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    dev_name = torch.cuda.get_device_name(0)
    log(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| {dev_name}")
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 matmuls are enabled")

    # ---- build every kernel from the checkout's sources ----------------
    t0 = time.perf_counter()
    names = _build.load_all()
    log(f"build: {names} in {time.perf_counter() - t0:.1f} s (one nvcc or "
        "g++ per source, in parallel)")
    for name in _build.sources():
        for line in _build.build_log(name).splitlines():
            if any(w in line for w in ("registers", "spill", "smem",
                                       "Compiling entry")):
                log(f"  ptxas[{name}]: {line.strip()}")

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize

    def kernel_launches(kernel, fn):
        """``(fn(), the launches of csrc/<kernel>.cu it made)``, read from
        the recorder's ``<kernel>.kernel_launches`` (an open recording's,
        else one opened for the call)."""
        name = kernel + ".kernel_launches"
        with contextlib.ExitStack() as stack:
            rec = tlog.recorder() or stack.enter_context(tlog.recording())
            before = rec.counters.get(name, 0)
            out = fn()
            sync()
            return out, rec.counters.get(name, 0) - before

    def kernel_vs_plain(A, k, s):
        """Kernel and plain version on the same panel: (pivots equal?,
        kernel pivots, plain pivots, max |Δ final norms²| over the entries
        finite in both, max finite norm0², non-finite norms in the same
        places with the same values?)."""
        pk, nk = kern._launch(A, k, s)
        As = A * s[:, None] if s is not None else A
        pp, npl = plain._sweep(As, k)
        sync()
        fin = torch.isfinite(nk) & torch.isfinite(npl)
        err = float(torch.max(torch.abs(nk[fin] - npl[fin]))) \
            if bool(fin.any()) else 0.0
        nan_k, nan_p = torch.isnan(nk), torch.isnan(npl)
        same_nonfinite = bool(torch.equal(nan_k, nan_p)) and bool(torch.equal(
            nk[~fin & ~nan_k], npl[~fin & ~nan_p]))
        n0 = torch.sum(As * As, dim=0)
        n0 = float(torch.max(n0[torch.isfinite(n0)]))
        pk, pp = pk.cpu().numpy(), pp.cpu().numpy()
        return (bool(np.array_equal(pk, pp)), pk, pp, err, n0,
                same_nonfinite)

    def near_tie_report(A, s, pk, pp, n0):
        """First differing step and both candidates' float64 deflated
        norms²; True if it is a near-tie within fp32 round-off."""
        st = int(np.flatnonzero(pk != pp)[0])
        As = (A * s[:, None] if s is not None else A).double()
        if st:
            Qs, _ = torch.linalg.qr(As[:, torch.as_tensor(pk[:st], device=dev).long()])
        cand = {}
        for who, j in (("kernel", int(pk[st])), ("plain", int(pp[st]))):
            a = As[:, j]
            d = float(a @ a) - (float(torch.sum((Qs.T @ a) ** 2)) if st else 0.0)
            cand[who] = (j, d)
        gap = abs(cand["kernel"][1] - cand["plain"][1])
        log(f"    first difference at step {st}: kernel picks "
            f"{cand['kernel'][0]} (deflated norm² {cand['kernel'][1]:.9e}), "
            f"plain picks {cand['plain'][0]} ({cand['plain'][1]:.9e}); "
            f"gap/max norm0² = {gap / n0:.3e} (near-tie if ≤ {NEAR_TIE_REL})")
        return gap <= NEAR_TIE_REL * n0

    # ---- kernel against its plain version on random panels -------------
    log("phase 1: csrc/qrcp.cu vs plain sweep, random fp32 panels "
        "(pivots must be equal)")
    rng = np.random.default_rng(0)
    # (shape, k, row scales, layout); the kernel holds each block's
    # columns in shared memory where they fit: all of them for the first
    # panels, a few (r = 8192) or part (n = 2,000,000) of them, and none for
    # a panel taller than one block's shared memory (r = 60,000).  "B.T" is
    # the main path's layout, the transpose of a row-major (n, r) panel;
    # "rows" a row-major (r, n) panel
    regimes = set()
    for shape, k, scales, layout in (
            ((14, 5000), 14, (False, True), "rows"),
            ((8, 20000), 8, (False, True), "rows"),
            ((14, 50000), 14, (False, True), "rows"),
            ((14, 50000), 14, (False, True), "B.T"),
            ((8192, 2048), 4, (False, True), "rows"),
            ((14, 2000000), 14, (False, True), "rows"),
            ((14, 2000000), 14, (False, True), "B.T"),
            ((60000, 300), 4, (True,), "rows")):
        r, n = shape
        bt = layout == "B.T"
        plan = kern.device_plan(r, n, k, dev)
        regime = ("all" if plan.resident_cols == n else
                  "part" if plan.resident_cols else "none")
        regimes.add(regime)
        A = torch.as_tensor(rng.standard_normal((n, r) if bt else shape),
                            dtype=torch.float32, device=dev)
        A = A.T if bt else A
        for scaled in scales:
            s = (torch.as_tensor(np.geomspace(1.0, 1e4, r),
                                 dtype=torch.float32, device=dev)
                 if scaled else None)
            eq, pk, pp, err, n0, same_nf = kernel_vs_plain(A, k, s)
            log(f"  {shape} {layout} k={k} row_scale={scaled}: grid "
                f"{plan.grid}, resident {plan.resident_cols}/{n} columns "
                f"({regime}), pivots equal={eq}, "
                f"max|Δnorms²|/max norm0²={err / n0:.3e}")
            if not eq:
                fail(f"kernel pivots {pk.tolist()} != plain {pp.tolist()} "
                     f"on random panel {shape} {layout} row_scale={scaled}")
            if err != 0.0 or not same_nf:
                fail(f"final norms differ from the plain sweep's: {err:.3e}")
        del A
    if regimes != {"all", "part", "none"}:
        fail(f"phase 1 covered the residency regimes {sorted(regimes)} only")

    # a NaN entry: its column's norm is NaN, which torch.argmax ranks above
    # every number (the lowest index among NaNs); the kernel must too
    for shape, regime in (((14, 50000), "all"), ((14, 2000000), "part")):
        r, n = shape
        plan = kern.device_plan(r, n, 14, dev)
        got = ("all" if plan.resident_cols == n else
               "part" if plan.resident_cols else "none")
        A = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device=dev)
        A[5, n // 3] = float("nan")
        for scaled in (False, True):
            s = (torch.as_tensor(np.geomspace(1.0, 1e4, r),
                                 dtype=torch.float32, device=dev)
                 if scaled else None)
            eq, pk, pp, err, _, same_nf = kernel_vs_plain(A, 14, s)
            log(f"  NaN at ({5}, {n // 3}) of {shape} ({got}) row_scale="
                f"{scaled}: pivots equal={eq} {pk.tolist()}, finite norms "
                f"equal={err == 0.0}, NaN/-inf norms in the same places="
                f"{same_nf}")
            if got != regime or not (eq and err == 0.0 and same_nf):
                fail(f"NaN panel {shape}: kernel and plain sweep differ")
        del A

    # k > n (and k > r): once every column is a pivot, each later step
    # picks column 0 in both; k r > 4096 keeps Q in global memory
    for shape, k in (((14, 10), 12), ((8, 5), 7), ((200, 30), 40)):
        A = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device=dev)
        for scaled in (False, True):
            s = (torch.as_tensor(np.geomspace(1.0, 1e4, shape[0]),
                                 dtype=torch.float32, device=dev)
                 if scaled else None)
            eq, pk, pp, err, _, same_nf = kernel_vs_plain(A, k, s)
            log(f"  k={k} > n={shape[1]}, {shape} row_scale={scaled}: pivots "
                f"equal={eq} {pk.tolist()}, finite norms equal={err == 0.0}, "
                f"-inf norms in the same places={same_nf}")
            if not (eq and err == 0.0 and same_nf):
                fail(f"k > n on {shape}: kernel and plain sweep differ")

    # qrcp_pivots_auto launches the kernel for every CUDA fp32 panel with
    # k <= 128: k > n directly, a view the kernel cannot read through its
    # strides after a contiguous copy
    A = torch.as_tensor(rng.standard_normal((14, 10)), dtype=torch.float32,
                        device=dev)
    base = torch.as_tensor(rng.standard_normal(20000), dtype=torch.float32,
                           device=dev)
    for what, V, k in (("k=12 > n=10", A, 12),
                       ("expanded (14, 5000) stride 0",
                        base[:5000].expand(14, 5000), 14),
                       ("overlapping (14, 5000) strides (7, 1)",
                        torch.as_strided(base, (14, 5000), (7, 1)), 14)):
        pa, launched = kernel_launches(
            "qrcp", lambda: kern.qrcp_pivots_auto(V, k))
        pp = plain.qrcp_pivots(V, k)
        sync()
        eq = bool(torch.equal(pa, pp))
        log(f"  qrcp_pivots_auto, {what}: kernel launches {launched}, pivots "
            f"equal to the plain sweep's={eq}")
        if not eq or launched != 1:
            fail(f"qrcp_pivots_auto on {what} is not the plain sweep's")

    # ---- data (host numpy from a seed, then one upload) ----------------
    t0 = time.perf_counter()
    flag = make_flame_dataset(dtype=np.float32)
    cube = make_flame_dataset(dtype=np.float32, **CUBE)
    log(f"data: flagship X_train {flag['X_train'].shape}, 3D X_train "
        f"{cube['X_train'].shape}, made in {time.perf_counter() - t0:.1f} s")

    # ---- the main path, each entry point with the counter reset --------
    def counted(fn):
        return kernel_launches("qrcp", fn)

    log("phase 2: main path (counters reset before each entry point)")
    res_f, launches_f = counted(lambda: spr_end_to_end(
        flag["X_train"], flag["X_test"], **FLAGSHIP))
    nr_f = float(res_f.nrmse)
    log(f"  spr_end_to_end flagship: NRMSE {nr_f:.3e} (≤ {NRMSE_FLAGSHIP_MAX})"
        f", qrcp launches {launches_f}, pivots {res_f.pivots.tolist()}")
    res_c, launches_c = counted(lambda: spr_end_to_end(
        cube["X_train"], cube["X_test"], n_features=9, r=14, svd_width=28))
    nr_c = float(res_c.nrmse)
    log(f"  spr_end_to_end 3D: NRMSE {nr_c:.3e} (≤ {NRMSE_3D_MAX}), qrcp "
        f"launches {launches_c}")

    def class_flow():
        spr = SPR(flag["X_train"], 9, flag["xyz"])
        spr.fit(select_modes="number", n_modes=14)
        C = spr.optimal_placement()
        spr.train(C)
        Cn = C.cpu().numpy()
        rows = np.argmax(Cn, axis=1)
        ys = []
        for j in range(flag["X_test"].shape[1]):
            y = np.zeros((14, 3))
            y[:, 0] = flag["X_test"][rows, j]
            y[:, 2] = rows // flag["xyz"].shape[0]
            ys.append(y)
        ap, _ = spr.predict(ys)
        return spr.reconstruct(ap)

    xp, launches_k = counted(class_flow)
    nr_k = float(nrmse(xp, torch.as_tensor(flag["X_test"], device=dev)))
    log(f"  class API flagship: NRMSE {nr_k:.3e} (≤ {NRMSE_FLAGSHIP_MAX}), "
        f"qrcp launches {launches_k}")
    for what, res, shape in (("flagship", res_f.X_rec, flag["X_test"].shape),
                             ("3D", res_c.X_rec, cube["X_test"].shape),
                             ("class API", xp, flag["X_test"].shape)):
        if tuple(res.shape) != shape or not bool(torch.isfinite(res).all()):
            fail(f"{what} reconstruction is not finite of shape {shape}")
    if not nr_f <= NRMSE_FLAGSHIP_MAX:
        fail(f"flagship NRMSE {nr_f:.3e} > {NRMSE_FLAGSHIP_MAX}")
    if not nr_c <= NRMSE_3D_MAX:
        fail(f"3D NRMSE {nr_c:.3e} > {NRMSE_3D_MAX}")
    if not nr_k <= NRMSE_FLAGSHIP_MAX:
        fail(f"class API NRMSE {nr_k:.3e} > {NRMSE_FLAGSHIP_MAX}")
    for what, n in (("flagship", launches_f), ("3D", launches_c),
                    ("class API", launches_k)):
        if n < 1:
            fail(f"the {what} path never launched csrc/qrcp.cu")

    # ---- kernel vs plain on the panels the pipeline produces -----------
    log("phase 3: csrc/qrcp.cu vs plain sweep on the pipeline's B panels")

    def pipeline_panel(X, refine=None, width=None):
        X = torch.as_tensor(X, device=dev)
        X0, _, _ = scaling.scale_data(X, 9, "std", 1)
        B, S, _ = svd.svd_tall(X0, refine=refine, canonicalize=False, rank=14,
                               width=width, normalize=False)
        dinv = 1.0 / svd.floored_norms(S[:14], X0.shape[0], X0.dtype)
        return B, dinv

    panels = {}
    for tag, X, width, res in (("flagship", flag["X_train"], None, res_f),
                               ("3d", cube["X_train"], 28, res_c)):
        B, dinv = pipeline_panel(X, width=width)
        A = B.T
        eq, pk, pp, err, n0, _ = kernel_vs_plain(A, 14, dinv)
        same_as_pipeline = bool(np.array_equal(pk, res.pivots.cpu().numpy()))
        log(f"  {tag} B.T {tuple(A.shape)} strides {A.stride()}: pivots "
            f"equal={eq}, kernel pivots == pipeline's={same_as_pipeline}, "
            f"max|Δnorms²|={err:.3e} (max norm0² {n0:.3e})")
        if not eq and not near_tie_report(A, dinv, pk, pp, n0):
            fail(f"{tag}: kernel and plain pivots differ beyond a near-tie")
        if eq and err > NORMS_REL_TOL * n0:
            fail(f"{tag}: final norms disagree: {err:.3e}")
        panels[tag] = (A, dinv, err)

    # ---- timings --------------------------------------------------------
    def per_call_ms(fns, reps=20, warmup=3):
        """Wall time per call of each of ``fns`` (key -> callable), timed in
        turns (A B B A ...) so that drift on the card hits all of them
        alike; key -> (median, min, max) ms."""
        for fn in fns.values():
            for _ in range(warmup):
                fn()
        sync()
        keys = list(fns)
        ts = {key: [] for key in keys}
        for rep in range(reps):
            for key in (keys if rep % 2 == 0 else keys[::-1]):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                fns[key]()
                b.record()
                b.synchronize()
                ts[key].append(a.elapsed_time(b))
        return {key: (statistics.median(v), min(v), max(v))
                for key, v in ts.items()}

    def loop_ms(fn, n, warmup=3, rounds=3):
        for _ in range(warmup):
            fn()
        sync()
        out = []
        for _ in range(rounds):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(n):
                fn()
            b.record()
            sync()
            out.append(a.elapsed_time(b) / n)
        return statistics.median(out)

    log("phase 4: timings (CUDA events; inputs resident on the card)")
    Xf = torch.as_tensor(flag["X_train"], device=dev)
    Tf = torch.as_tensor(flag["X_test"], device=dev)
    Xc = torch.as_tensor(cube["X_train"], device=dev)
    Tc = torch.as_tensor(cube["X_test"], device=dev)
    for tag, X, T, kw in (("flagship", Xf, Tf, {}),
                          ("3D", Xc, Tc, dict(svd_width=28))):
        torch.cuda.reset_peak_memory_stats()
        spr_end_to_end(X, T, **FLAGSHIP, **kw)
        sync()
        peak = torch.cuda.max_memory_allocated() / 2**20
        fns = {refine: (lambda refine=refine: spr_end_to_end(
            X, T, **FLAGSHIP, refine=refine, **kw)) for refine in (1, 2)}
        for refine, (med, lo, hi) in per_call_ms(fns).items():
            log(f"  {tag} spr_end_to_end refine={refine}: NRMSE "
                f"{float(fns[refine]().nrmse):.3e}, wall per call median "
                f"{med:.4f} ms (min {lo:.4f}, max {hi:.4f}, 20 calls in "
                f"turns with the other refine)")
        log(f"  {tag} max_memory_allocated of one call at the default "
            f"refine: {peak:.1f} MiB")

    def trace_counts(fn):
        """(device kernels, device-to-host copies) of one call of ``fn`` in
        torch.profiler's trace; kernels None when the trace holds no device
        activity.  A trace can miss its first few device events, so a few
        small launches go first, and only the events that start after the
        call began are counted."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile, record_function
        lead = torch.zeros(1, device=dev)
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(8):
                lead.add_(1.0)
            sync()
            with record_function("chip_smoke::call"):
                fn()
                sync()
        events = list(prof.events())
        t0 = min(e.time_range.start for e in events
                 if e.name == "chip_smoke::call")
        # the marker itself shows on the device's timeline as a range
        names = [e.name for e in events
                 if e.device_type == DeviceType.CUDA
                 and e.time_range.start >= t0
                 and e.name != "chip_smoke::call"]
        kernels = [n for n in names if "memcpy" not in n.lower()
                   and "memset" not in n.lower()]
        return (len(kernels) if kernels else None,
                sum(1 for n in names if "DtoH" in n))

    records = []
    for tag, replaces, launches in (
            ("flagship", "openmeasure_tpu/linalg/qrcp_pallas.py:66",
             launches_f + launches_k),
            ("3d", "openmeasure_tpu/linalg/qrcp_pallas.py:137", launches_c)):
        A, dinv, err = panels[tag]
        r, n = A.shape
        k = 14
        plan = kern.device_plan(r, n, k, dev)
        ms = loop_ms(lambda: kern.qrcp_pivots_cuda(A, k, row_scale=dinv),
                     n=50 if tag == "flagship" else 10)
        plain_ms = loop_ms(lambda: plain.qrcp_pivots(A * dinv[:, None], k),
                           n=5, warmup=1)
        per_call, _ = trace_counts(
            lambda: kern.qrcp_pivots_cuda(A, k, row_scale=dinv))
        bytes_ms = (r * n * 4 + r * 4 + k * 4) / HBM_BYTES_PER_S * 1e3
        ops_ms = (2.0 * r * n * (k + 1) + 2.0 * n * k) / FP32_FLOPS * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        log(f"  qrcp {tag} {(r, n)}: kernel {ms:.4f} ms per call "
            f"({'not measured' if per_call is None else per_call} device "
            f"kernel(s) per call by torch.profiler; grid {plan.grid} × "
            f"{kern.THREADS} threads, {plan.barriers} grid barriers, "
            f"{plan.smem_bytes} B shared memory a block), plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms (bytes "
            f"{bytes_ms:.5f}, ops {ops_ms:.5f}); resident "
            f"{plan.resident_cols}/{n} columns "
            f"({100.0 * plan.resident_cols / n:.1f} %), re-read from global "
            f"memory per step {(n - plan.resident_cols) * r * 4 / 1e9:.4f} "
            f"GB")
        if per_call is not None and per_call != 1:
            fail(f"one qrcp_pivots_cuda call ran {per_call} kernels, not 1")
        records.append({
            "name": f"qrcp_pivots_cuda[{tag}]", "route": "cuda",
            "source": "openmeasure_torch/csrc/qrcp.cu", "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None})

    # ---- GP ROM: csrc/chol.cu against its plain versions ---------------
    log("phase 5: csrc/chol.cu vs chol_inv_logdet_plain (K⁻¹ and logdet "
        f"equal) and the Cholesky formulation (K⁻¹ ≤ {CHOL_KINV_REL} × "
        f"max|K⁻¹|, logdet ≤ {CHOL_LOGDET_ABS}), random SPD fp32 batches")

    def spd_batch(B, p, seed):
        g = np.random.default_rng(seed)
        Q = g.standard_normal((B, p, p))
        K = np.einsum("bij,bkj->bik", Q, Q) / p + 0.5 * np.eye(p)[None]
        return torch.as_tensor((K + np.swapaxes(K, 1, 2)) / 2,
                               dtype=torch.float32, device=dev)

    def chol_errors(K):
        """The kernel against the plain version — (K⁻¹ and logdet equal?,
        max |ΔK⁻¹|, max |Δlogdet|) — and against the Cholesky formulation
        — (K⁻¹ error / max|K⁻¹|, logdet error)."""
        kk, lk = chol_kern.chol_inv_logdet_cuda(K)
        kp, lp = chol_plain.chol_inv_logdet_plain(K)
        kt, lt = chol_plain.chol_inv_logdet_torch(K)
        sync()
        equal = bool(torch.equal(kk, kp)) and bool(torch.equal(lk, lp))
        return ((equal, float(torch.max(torch.abs(kk - kp))),
                 float(torch.max(torch.abs(lk - lp)))),
                (float(torch.max(torch.abs(kk - kt)))
                 / float(torch.max(torch.abs(kt))),
                 float(torch.max(torch.abs(lk - lt)))))

    for B, p in ((14, 41), (3, 17), (30, 64), (2, 128), (4, 1), (1, 100)):
        (eq, dk, dl), (tk, tl) = chol_errors(spd_batch(B, p, seed=p))
        log(f"  ({B}, {p}, {p}): vs plain equal={eq} (max |ΔK⁻¹| {dk:.3e}, "
            f"|Δlogdet| {dl:.3e}); vs Cholesky K⁻¹ {tk:.3e}, logdet {tl:.3e}")
        if not eq:
            fail(f"chol kernel differs from its plain version at "
                 f"({B}, {p}, {p})")
        if not (tk <= CHOL_KINV_REL and tl <= CHOL_LOGDET_ABS):
            fail(f"chol kernel disagrees with the Cholesky formulation at "
                 f"({B}, {p}, {p})")

    # ---- GP ROM: the main path, each entry point with the counter reset --
    log("phase 6: GP ROM main path, flagship (the chol.cu and gp_step.cu "
        "launches of each entry point, from the recorder's counters)")
    Pf, Ptf = flag["P_train"], flag["P_test"]
    Tf64 = torch.as_tensor(flag["X_test"], dtype=torch.float64)

    def chol_counted(fn):
        return kernel_launches("chol", fn)

    def gp_counted(fn):
        """``((out, chol.cu launches), gp_step.cu launches)`` of ``fn``."""
        return kernel_launches("gp_step", lambda: chol_counted(fn))

    def fused_launches(its, max_iter=1000, unroll=4):
        """The gp_step.cu launches a fused training whose models took
        ``its`` iterations may make: the first build, then one a loop step,
        the loop running whole blocks of ``unroll`` up to ``max_iter`` and
        one block more, enqueued before the host read the stop of the last
        one (none more where the copy of the stop flags read a flag that
        block had already turned on)."""
        steps = min(-(-max(its) // unroll) * unroll, max_iter)
        return (steps + 1, min(steps + unroll, max_iter) + 1)

    def gp_class_flow(gpr_type, engine="device"):
        g = GPR(flag["X_train"], 9, flag["xyz"], Pf, gpr_type)
        g.fit(select_modes="number", n_modes=14)
        g.train(engine=engine)
        a_pred, _ = g.predict(Ptf)
        return g, a_pred, g.reconstruct(a_pred)

    gp_runs = {}
    (res_g, n_g), n_gs = gp_counted(lambda: gpr_end_to_end(
        flag["X_train"], Pf, Ptf, flag["X_test"], **FLAGSHIP))
    gp_runs["gpr_end_to_end"] = (res_g.X_rec, float(res_g.nrmse), n_g, n_gs,
                                 res_g.iterations.tolist())
    gp_models = {}
    for gpr_type in ("SingleTask", "MultiTask"):
        ((g, _, xr), n), n_gs = gp_counted(lambda: gp_class_flow(gpr_type))
        gp_runs[gpr_type] = (xr, float(nrmse(xr, Tf)), n, n_gs,
                             g._iterations.tolist())
        gp_models[gpr_type] = g
    gp_single = gp_models["SingleTask"]
    gp_step_main_launches = 0
    for what, (xr, nr, n, n_gs, its) in gp_runs.items():
        bar = GPR_NRMSE_SLACK * GPR_F64_NRMSE[what]
        want_gs = (0,) if what == "MultiTask" else fused_launches(its)
        gp_step_main_launches += n_gs
        log(f"  {what}: NRMSE {nr:.6e} (≤ {bar:.6e}; float64 JAX on the CPU "
            f"{GPR_F64_NRMSE[what]:.6e}), chol launches {n}, gp_step "
            f"launches {n_gs} (want {want_gs}), Adam iterations {its}")
        if tuple(xr.shape) != flag["X_test"].shape or \
                not bool(torch.isfinite(xr).all()):
            fail(f"GP {what} reconstruction is not finite of shape "
                 f"{flag['X_test'].shape}")
        if not nr <= bar:
            fail(f"GP {what} NRMSE {nr:.6e} > {bar:.6e}")
        if n < 1:
            fail(f"the GP {what} path never launched csrc/chol.cu")
        if n_gs not in want_gs:
            fail(f"the GP {what} path launched csrc/gp_step.cu {n_gs} times, "
                 f"not one of {want_gs}")

    log("phase 7: engine='host' against the port's float64 CPU run of the "
        f"same inputs (|ΔNRMSE| ≤ {HOST_ENGINE_TOL})")
    (gh, a_host, xr_host), n_host = chol_counted(
        lambda: gp_class_flow("SingleTask", engine="host"))
    state = {k: getattr(gh, k).double().cpu().numpy()
             for k in ("X_cnt", "X_scl", "Ur", "Ar", "Vr", "Sigma_r",
                       "P_cnt", "P_scl", "P0")}
    ref = gpr_from_numpy(dict(state, P=np.asarray(Pf, np.float64)),
                         {"n_features": 9}, device="cpu")
    ref.train()
    a_ref, _ = ref.predict(np.asarray(Ptf, np.float64))

    def nrmse64(a):
        x = (ref.Ur @ a.T) * ref.X_scl + ref.X_cnt
        return float(torch.sqrt(torch.mean((x - Tf64) ** 2))
                     / (Tf64.max() - Tf64.min()))

    nr_host, nr_ref = nrmse64(a_host), nrmse64(a_ref)
    log(f"  host engine: A_pred on {a_host.device} {a_host.dtype}, NRMSE "
        f"(float64 reconstruction) {nr_host!r}, port float64 CPU {nr_ref!r}, "
        f"|Δ| {abs(nr_host - nr_ref):.3e}; fp32 reconstruction on the card "
        f"{float(nrmse(xr_host, Tf)):.6e}; iterations "
        f"{gh._iterations.tolist()} vs {ref._iterations.tolist()}; chol "
        f"launches {n_host} (the GP stage runs on the host)")
    if a_host.device.type != "cpu" or a_host.dtype != torch.float64:
        fail("engine='host' did not keep its results on the host in float64")
    if not abs(nr_host - nr_ref) <= HOST_ENGINE_TOL:
        fail(f"engine='host' NRMSE {nr_host!r} != float64 CPU {nr_ref!r}")

    # ---- GP ROM timings -------------------------------------------------
    log("phase 8: GP timings (CUDA events; inputs resident on the card)")
    Pft = torch.as_tensor(Pf, device=dev)
    Ptft = torch.as_tensor(Ptf, device=dev)
    walls = []
    for _ in range(6):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        res = gpr_end_to_end(Xf, Pft, Ptft, Tf, **FLAGSHIP)
        b.record()
        b.synchronize()
        walls.append(a.elapsed_time(b))
    walls = walls[1:]
    its = res.iterations
    log(f"  gpr_end_to_end flagship: wall per call median "
        f"{statistics.median(walls):.4f} ms (min {min(walls):.4f}, max "
        f"{max(walls):.4f}; 5 calls after one warm-up), Adam iterations "
        f"max {int(its.max())} → "
        f"{statistics.median(walls) / int(its.max()):.4f} ms per iteration")

    def gp_matrices(g):
        """A trained GPR's jittered kernel matrices at its training points,
        (r, m, m): what csrc/chol.cu gets on its path."""
        with torch.no_grad():
            tp = g.params
            Kn = exact_gp._add_noise(g.kernel(tp["kernel"], g.P0, g.P0),
                                     g.likelihood.noise(tp["likelihood"]))
            return (Kn + exact_gp._jitter(Kn.dtype)
                    * torch.eye(Kn.shape[-1], device=dev)).contiguous()

    # the kernel's input on the main path: the trained SingleTask model's
    # matrices at its 41 training points, (14, 41, 41)
    Kmain = gp_matrices(gp_single)
    (eq, dk, dl), (tk, tl) = chol_errors(Kmain)
    log(f"  main-path matrices {tuple(Kmain.shape)}: vs plain equal={eq} "
        f"(max |ΔK⁻¹| {dk:.3e}, |Δlogdet| {dl:.3e}); vs the fp32 Cholesky "
        f"formulation K⁻¹ {tk:.3e}, logdet {tl:.3e}")
    if not eq:
        fail("chol kernel differs from its plain version on the main path's "
             "matrices")
    Bm, pm, _ = Kmain.shape

    # which side is nearer the float64 answer: the kernel or the fp32
    # Cholesky formulation (cuSOLVER's cholesky_ex + cholesky_solve)
    K64 = Kmain.double()
    L64 = torch.linalg.cholesky(K64)
    kinv64 = torch.cholesky_inverse(L64)
    ld64 = 2.0 * torch.log(torch.diagonal(L64, dim1=-2, dim2=-1)).sum(-1)
    cond = torch.linalg.cond(K64)
    cond_bar = pm * cond * FP32_UNIT_ROUNDOFF

    def vs_float64(kinv, ld):
        rel = ((kinv.double() - kinv64).abs().amax((-2, -1))
               / kinv64.abs().amax((-2, -1)))
        return rel, (ld.double() - ld64).abs()

    rel_k, ld_k = vs_float64(*chol_kern.chol_inv_logdet_cuda(Kmain))
    rel_t, ld_t = vs_float64(*chol_plain.chol_inv_logdet_torch(Kmain))
    sync()
    log(f"  main-path matrices against float64 Cholesky: cond₂(K) "
        f"{float(cond.min()):.4e} to {float(cond.max()):.4e}; K⁻¹ error / "
        f"max|K⁻¹|: kernel max {float(rel_k.max()):.4e}, fp32 Cholesky "
        f"formulation max {float(rel_t.max()):.4e}, the kernel nearer on "
        f"{int((rel_k < rel_t).sum())} of {Bm} matrices (equal on "
        f"{int((rel_k == rel_t).sum())}); |Δlogdet|: kernel max "
        f"{float(ld_k.max()):.4e}, fp32 Cholesky formulation max "
        f"{float(ld_t.max()):.4e}, the kernel nearer on "
        f"{int((ld_k < ld_t).sum())}; kernel's worst error / (p · cond · u) "
        f"{float(torch.maximum(rel_k, ld_k).div(cond_bar).max()):.4e} "
        f"(≤ 1)")
    for b in range(Bm):
        log(f"    matrix {b}: cond₂ {float(cond[b]):.4e}, K⁻¹ kernel "
            f"{float(rel_k[b]):.4e} Cholesky {float(rel_t[b]):.4e}, logdet "
            f"kernel {float(ld_k[b]):.4e} Cholesky {float(ld_t[b]):.4e}")
    if not bool(((rel_k <= cond_bar) & (ld_k <= cond_bar)).all()):
        fail("chol kernel is further from the float64 Cholesky than "
             "p · cond(K) · u on the main path's matrices")

    def cusolver_composition():
        L, _ = torch.linalg.cholesky_ex(Kmain)
        kinv = torch.cholesky_inverse(L)
        return kinv, 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)
                                     ).sum(-1)

    def traced_ms(fn, name, reps, want):
        """``device_ms`` again, up to 3 traces, until the trace holds at
        least ``want`` of the ``reps`` launches (a trace can drop a short
        run's events)."""
        for _ in range(3):
            ms_, seen = device_ms(fn, name, reps)
            if seen >= want:
                break
        return ms_, seen

    chol_ms, chol_n = traced_ms(
        lambda: chol_kern.chol_inv_logdet_cuda(Kmain), "chol_inv_logdet", 300,
        100)
    if chol_n < 100:
        fail(f"torch.profiler saw {chol_n} chol_inv_logdet launches of 300")
    chol_call_ms = loop_ms(lambda: chol_kern.chol_inv_logdet_cuda(Kmain),
                           n=200)
    chol_plain_ms = loop_ms(lambda: chol_plain.chol_inv_logdet_plain(Kmain),
                            n=5, warmup=1)
    cusolver_ms = loop_ms(cusolver_composition, n=200)
    chol_bytes_ms, chol_ops_ms = chol_bound_ms(Bm, pm)
    ops = chol_ops(Bm, pm)
    chol_bound = max(chol_bytes_ms, chol_ops_ms)
    log(f"  yardstick, not a port: cuSOLVER composition (cholesky_ex + "
        f"cholesky_inverse + log-diag, three calls) {cusolver_ms:.5f} ms")
    log(f"  chol {tuple(Kmain.shape)}: kernel {chol_ms:.5f} ms per launch "
        f"(device time, median of {chol_n} launches by torch.profiler; "
        f"{chol_call_ms:.5f} ms per wrapper call with the host's part, CUDA "
        f"events over 200 back-to-back calls), plain {chol_plain_ms:.4f} ms, "
        f"bound {chol_bound:.6f} ms (bytes {chol_bytes_ms:.6f}, ops "
        f"{chol_ops_ms:.6f}: {ops} operations)")
    records.append({
        "name": "chol_inv_logdet_cuda", "route": "cuda",
        "source": "openmeasure_torch/csrc/chol.cu",
        "replaces": "openmeasure_tpu/linalg/chol_pallas.py:85",
        "launches": sum(v[2] for v in gp_runs.values()),
        "max_abs_err": max(dk, dl), "ms": chol_ms,
        "plain_ms": chol_plain_ms,
        "bound_ms": chol_bound,
        "bound_by": "bytes" if chol_bytes_ms >= chol_ops_ms else "operations",
        "library_ms": None})

    # ---- the fused GP step: csrc/gp_step.cu against its plain version ----
    log(f"phase 8(b): csrc/gp_step.cu against its plain version at the main "
        f"path's (14, 41) (one step from gpytorch's initial parameters, "
        f"≤ {GP_STEP_REL} × each quantity's max), and an iteration's device "
        f"time, the fused graph (chol.cu + gp_step.cu) beside the oracle's "
        f"graph-replayed torch step as the yardstick")
    g1 = gp_single
    vag = exact_gp.make_single_task_value_and_grad(
        g1.mean, g1.kernel, g1.likelihood, g1.P0, g1.Vr.T)
    if vag.fused is None:
        fail("the main path's oracle offers no fused step")
    init = [torch.zeros_like(t) for t in exact_gp.tree_leaves(g1.params)]
    gk = vag.fused([t.clone() for t in init], 0.1, 1e-5)
    gpl = vag.fused([t.clone() for t in init], 0.1, 1e-5)
    gp_step_mod._build_plain(gpl)
    kinv0, ld0 = chol_kern.chol_inv_logdet_cuda(gk.kj)
    gp_step_mod.gp_step(gk, kinv0, ld0)
    gp_step_mod._step_plain(gpl, kinv0, ld0)
    sync()
    gs_err, gs_abs = {}, {}
    for name in ("theta", "mu", "nu", "loss", "kj", "resid"):
        a_, b_ = getattr(gk, name), getattr(gpl, name)
        gs_abs[name] = float(torch.max(torch.abs(a_ - b_)))
        gs_err[name] = gs_abs[name] / float(torch.max(torch.abs(b_)))
    gs_exact = all(torch.equal(getattr(gk, n), getattr(gpl, n))
                   for n in ("conv", "iters", "count"))
    log("  kernel vs plain, error / max: " + ", ".join(
        f"{k} {v:.3e}" for k, v in gs_err.items())
        + f" (max |Δ| {max(gs_abs.values()):.3e}); stop flags and counts "
        f"equal={gs_exact}")
    if not (gs_exact and max(gs_err.values()) <= GP_STEP_REL):
        fail("csrc/gp_step.cu differs from its plain version at (14, 41)")

    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        run = vag.fused([t.clone() for t in init], 0.1, 1e-5)
        run.step()
        fused_graph = exact_gp._Replay(run.step)
        ostep = functools.partial(
            exact_gp._adam_step, functools.partial(
                exact_gp._grads_at, g1.params, None, vag),
            lr=0.1, rel_error=1e-5)
        orun = exact_gp._OracleRun(ostep, [t.clone() for t in init],
                                   max_iter=1000)
        orun.step()
        oracle_graph = exact_gp._Replay(orun.step)
        sync()
        fused_ms = loop_ms(fused_graph.step, n=500)
        oracle_ms = loop_ms(oracle_graph.step, n=200)
        step_ms, step_n = traced_ms(fused_graph.step, "gp_step", 300, 100)
    if step_n < 100:
        fail(f"torch.profiler saw {step_n} gp_step launches of 300")
    gs_plain_ms = loop_ms(lambda: gp_step_mod._step_plain(gpl, kinv0, ld0),
                          n=20, warmup=2)
    gs_bytes_ms, gs_ops_ms = gp_step_bound_ms(Bm, pm, gk.nls,
                                              gk.theta.shape[1])
    gs_bound = max(gs_bytes_ms, gs_ops_ms)
    log(f"  an Adam iteration at ({Bm}, {pm}): fused graph {fused_ms * 1e3:.2f}"
        f" µs on the card (CUDA events over 500 replays; chol.cu "
        f"{chol_ms * 1e3:.2f} µs of it), yardstick, the oracle's graph-"
        f"replayed torch step {oracle_ms * 1e3:.2f} µs (200 replays): "
        f"{oracle_ms / fused_ms:.2f}×")
    log(f"  gp_step kernel {step_ms:.5f} ms per launch (device time, median "
        f"of {step_n} launches by torch.profiler), plain {gs_plain_ms:.4f} ms "
        f"a step, bound {gs_bound:.6f} ms (bytes {gs_bytes_ms:.6f}, ops "
        f"{gs_ops_ms:.6f})")
    records.append({
        "name": "gp_step", "route": "cuda",
        "source": "openmeasure_torch/csrc/gp_step.cu", "replaces": None,
        "launches": gp_step_main_launches,
        "max_abs_err": max(gs_abs.values()), "ms": step_ms,
        "plain_ms": gs_plain_ms, "bound_ms": gs_bound,
        "bound_by": "bytes" if gs_bytes_ms >= gs_ops_ms else "operations",
        "library_ms": None})

    # ---- serving, SPR family -------------------------------------------
    log(f"phase 9: serving, SPR family — the flagship trained with "
        f"method='COLS' under per-feature limits (min/max of the training "
        f"snapshots ± {SERVE_PAD:.0%} of the span), SoftSensor.from_spr, "
        f"batches of {SERVE_BATCH} frames, {SERVE_ITERS} ADMM iterations")
    npts = flag["xyz"].shape[0]
    Xb = flag["X_train"].astype(np.float64).reshape(9, npts, -1)
    f_lo, f_hi = Xb.min(axis=(1, 2)), Xb.max(axis=(1, 2))
    span = f_hi - f_lo
    limits = [f_lo - SERVE_PAD * span, f_hi + SERVE_PAD * span]

    def serving_model():
        spr = SPR(flag["X_train"], 9, flag["xyz"])
        spr.fit(select_modes="number", n_modes=14)
        C = spr.optimal_placement()
        spr.train(C, method="COLS", limits=limits)
        return spr, C

    (spr_s, C_s), launches_s = counted(serving_model)
    log(f"  fit → optimal_placement → train(COLS): qrcp launches "
        f"{launches_s}")
    if launches_s < 1:
        fail("the serving placement never launched csrc/qrcp.cu")
    rows_s = C_s.argmax(dim=1).cpu().numpy()
    frames = flag["X_test"][rows_s]                           # (14, 4)
    Y = torch.as_tensor(np.tile(frames.T, (13, 1))[:SERVE_BATCH], device=dev)
    span_rows = torch.as_tensor(np.repeat(span, npts), device=dev)

    def violation(x, lims):
        """The fields' largest excursion past ``lims`` relative to the
        feature's span, and the count of entries within 1e-6 of the span of
        a limit or past it."""
        lo_r, hi_r = (torch.as_tensor(np.repeat(v, npts), device=dev)
                      for v in lims)
        v = torch.maximum(lo_r - x.double(), x.double() - hi_r)
        return (float((torch.clamp(v, min=0.0) / span_rows).max()),
                int((v >= -1e-6 * span_rows).sum()))

    def host_syncs(fn):
        """How many synchronizing CUDA calls one call of ``fn`` makes, by
        torch.cuda's sync debug mode set to warn."""
        import warnings
        sync()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        sync()
        return sum(1 for w in caught
                   if "synchronizing CUDA operation" in str(w.message))

    t_phase = time.perf_counter()
    admm_main_launches = 0
    for mode in ("adaptive", "fixed"):
        s32 = SoftSensor.from_spr(spr_s, admm_iters=SERVE_ITERS,
                                  admm_rho=mode).warmup()
        s64 = SoftSensor.from_spr(spr_s, dtype=torch.float64,
                                  admm_iters=SERVE_ITERS, admm_rho=mode)
        # the main path reaches csrc/admm.cu: two launches an iteration of
        # one fp32 batch
        (x32, a32, _), n_admm = kernel_launches(
            "admm", lambda: s32.predict_batch(Y))
        admm_main_launches += n_admm
        _, a64, _ = s64.predict_batch(Y)
        sync()
        err = float((a32.double() - a64).abs().max() / a64.abs().max())
        viol_rel, at_limit = violation(x32, limits)
        finite = bool(torch.isfinite(x32).all())
        med, lo_t, hi_t = per_call_ms(
            {0: lambda: s32.predict_batch(Y)}, reps=10, warmup=2)[0]
        per_batch, dtoh = trace_counts(lambda: s32.predict_batch(Y))
        n_sync = host_syncs(lambda: s32.predict_batch(Y))
        log(f"  admm_rho={mode!r}: fp32 coefficients vs the float64 sensor "
            f"on the card max|Δa|/max|a| {err:.4e} (≤ {SERVE_COEF_REL}); "
            f"largest limit violation of the fields {viol_rel:.4e} of the "
            f"feature's span (≤ {SERVE_VIOL_REL}), {at_limit} field "
            f"entries within 1e-6 of the span of a limit; per frame at batch "
            f"{SERVE_BATCH} {med / SERVE_BATCH:.5f} ms (batch median "
            f"{med:.4f} ms, min {lo_t:.4f}, max {hi_t:.4f}; 10 batches, CUDA "
            f"events, inputs on the card); "
            f"{'not measured' if per_batch is None else per_batch} device "
            f"kernels per batch ({'-' if per_batch is None else f'{per_batch / SERVE_ITERS:.1f}'}"
            f" per iteration); device-to-host copies in predict_batch {dtoh}, "
            f"synchronizing calls {n_sync}; csrc/admm.cu launches in one "
            f"batch {n_admm}")
        if n_admm != 2 * SERVE_ITERS:
            fail(f"an fp32 COLS batch ({mode}) made {n_admm} csrc/admm.cu "
                 f"launches, not {2 * SERVE_ITERS}: the main path missed the "
                 f"kernels")
        if not finite or tuple(x32.shape) != (SERVE_BATCH, flag["X_train"].shape[0]):
            fail(f"COLS serving fields ({mode}) are not finite of shape "
                 f"({SERVE_BATCH}, n)")
        if not err <= SERVE_COEF_REL:
            fail(f"fp32 COLS coefficients ({mode}) {err:.3e} from float64")
        if not viol_rel <= SERVE_VIOL_REL:
            fail(f"COLS fields ({mode}) violate the limits by {viol_rel:.3e}")
        if dtoh != 0 or n_sync != 0:
            fail(f"a tol = 0 predict_batch ({mode}) read back to the host")

    # the serving ADMM's kernel pair (csrc/admm.cu) at the serving shape:
    # its device time an iteration against the bytes' bound, its result
    # against the float64 loop, and the plain version's time (the loop of
    # boxls._admm in fp32 on the card); no single PyTorch call runs an ADMM
    # iteration, so there is no library yardstick
    st_s = SoftSensor.from_spr(spr_s, admm_iters=SERVE_ITERS)._state
    Th_s = st_s["Theta"]
    H_s = (Th_s.T @ Th_s).expand(SERVE_BATCH, -1, -1)
    c_s = ((Y - st_s["cnt_sensors"]) / st_s["scl_sensors"]) @ Th_s
    A_s, lo_s, hi_s, AtA_s = (st_s[k] for k in ("A_c", "lo", "hi", "AtA"))
    n_s, r_s = A_s.shape
    plan_s = admm_k.device_plan(SERVE_BATCH, n_s, r_s, True, dev)

    def admm_solve(iters):
        return boxls_mod._admm_kernels(H_s, c_s, boxls_mod._Operator(A_s),
                                       lo_s, hi_s, AtA_s, None, iters, 1.6,
                                       True, True)

    def admm_loop(iters, dtype=torch.float32):
        H, c, A, lo, hi, AtA = (x.to(dtype) for x in (H_s, c_s, A_s, lo_s,
                                                      hi_s, AtA_s))
        return boxls_mod._admm(H, c, boxls_mod._Operator(A), lo, hi, AtA,
                               None, iters, 0.0, 1.6, True, True)

    g_k = admm_solve(SERVE_ITERS)[0].double()
    g_64 = admm_loop(SERVE_ITERS, torch.float64)[0]
    g_32 = admm_loop(SERVE_ITERS)[0].double()
    admm_scale = float(g_64.abs().max())
    admm_err = float((g_k - g_64).abs().max())
    admm_loop_err = float((g_32 - g_64).abs().max())
    admm_err_bound = 2.0 * admm_loop_err + 100 * 2.0 ** -24 * admm_scale
    admm_row_ms, n_row = traced_ms(lambda: admm_solve(10), "row_pass", 5, 20)
    admm_step_ms, n_step = traced_ms(lambda: admm_solve(10), "r_step", 5, 20)
    if min(n_row, n_step) < 20:
        fail(f"torch.profiler saw {n_row} row passes and {n_step} r-steps "
             f"of 50")
    admm_iter_ms = ((loop_ms(lambda: admm_solve(SERVE_ITERS), n=5)
                     - loop_ms(lambda: admm_solve(0), n=5)) / SERVE_ITERS)
    admm_plain_ms = ((loop_ms(lambda: admm_loop(30), n=3)
                      - loop_ms(lambda: admm_loop(0), n=3)) / 30)
    admm_bytes = (4 * SERVE_BATCH * n_s + n_s * r_s
                  + lo_s.numel() + hi_s.numel()) * 4
    admm_bound_ms = admm_bytes / HBM_BYTES_PER_S * 1e3
    admm_ops_ms = 2.0 * 4 * r_s * SERVE_BATCH * n_s / FP32_FLOPS * 1e3
    per_solve, _ = trace_counts(lambda: admm_solve(SERVE_ITERS))
    log(f"  csrc/admm.cu at ({SERVE_BATCH}, {n_s:,}, {r_s}), adaptive ρ: "
        f"an iteration {admm_iter_ms:.5f} ms on the card (CUDA events, "
        f"({SERVE_ITERS} − 0 iterations) / {SERVE_ITERS}); row pass "
        f"{admm_row_ms:.5f} ms, r-step {admm_step_ms:.5f} ms device time a "
        f"launch (grid {plan_s.grid} × {32 * plan_s.warps} threads, "
        f"{plan_s.rows} rows a block, {plan_s.smem_bytes} B shared memory); "
        f"bound {admm_bound_ms:.5f} ms ({admm_bytes / 1e6:.1f} MB; "
        f"operations {admm_ops_ms:.5f} ms); plain version (the fp32 loop) "
        f"{admm_plain_ms:.4f} ms an iteration; "
        f"{'not measured' if per_solve is None else per_solve} device "
        f"kernels a solve of {SERVE_ITERS}; coefficients against the "
        f"float64 loop max|Δg| {admm_err:.4e} ({admm_err / admm_scale:.4e} "
        f"of max|g|; the fp32 loop's {admm_loop_err:.4e}, bound "
        f"{admm_err_bound:.4e})")
    if not admm_err <= admm_err_bound:
        fail(f"csrc/admm.cu's coefficients lie {admm_err:.3e} from the "
             f"float64 loop, beyond {admm_err_bound:.3e}")
    if per_solve is not None and per_solve > 3 * SERVE_ITERS:
        fail(f"a kernel solve ran {per_solve} device kernels, as if the "
             f"loop had run")
    records.append({
        "name": "admm_fused", "route": "cuda",
        "source": "openmeasure_torch/csrc/admm.cu", "replaces": None,
        "launches": admm_main_launches, "max_abs_err": admm_err,
        "ms": admm_iter_ms, "plain_ms": admm_plain_ms,
        "bound_ms": admm_bound_ms,
        "bound_by": "bytes" if admm_bound_ms >= admm_ops_ms else
        "operations", "library_ms": None})

    # the padded limits are out of the fields' reach: the same model with
    # the limits padded inward, where the clip and the projection do work
    bind_limits = [f_lo + SERVE_PAD * span, f_hi - SERVE_PAD * span]
    spr_s.train(C_s, method="COLS", limits=bind_limits)
    for mode in ("adaptive", "fixed"):
        s32 = SoftSensor.from_spr(spr_s, admm_iters=SERVE_ITERS,
                                  admm_rho=mode)
        s64 = SoftSensor.from_spr(spr_s, dtype=torch.float64,
                                  admm_iters=SERVE_ITERS, admm_rho=mode)
        x32, a32, _ = s32.predict_batch(Y)
        x64, a64, _ = s64.predict_batch(Y)
        sync()
        err = float((a32.double() - a64).abs().max() / a64.abs().max())
        v32, at32 = violation(x32, bind_limits)
        v64, at64 = violation(x64, bind_limits)
        log(f"  limits padded inward, admm_rho={mode!r}: fp32 coefficients "
            f"vs the float64 sensor max|Δa|/max|a| {err:.4e} (≤ "
            f"{SERVE_COEF_REL}); {at32} fp32 and {at64} float64 field "
            f"entries at or past a limit (within 1e-6 of the span); largest "
            f"excursion past a limit {v32:.4e} of the span in fp32, "
            f"{v64:.4e} in float64 (fp32 ≤ float64 + {SERVE_VIOL_REL})")
        if not bool(torch.isfinite(x32).all()):
            fail(f"binding COLS serving fields ({mode}) are not finite")
        if at32 == 0:
            fail(f"the inward limits bind no field entry ({mode})")
        if not err <= SERVE_COEF_REL:
            fail(f"fp32 COLS coefficients under binding limits ({mode}) "
                 f"{err:.3e} from float64")
        if not v32 <= v64 + SERVE_VIOL_REL:
            fail(f"binding COLS fields ({mode}) stray {v32:.3e} past the "
                 f"limits, float64 {v64:.3e}")
    log(f"  phase 9 took {time.perf_counter() - t_phase:.1f} s")

    # OLS serving against the eager SPR.predict (host float64 pinv)
    spr_s.train(C_s, cond=True)
    s_ols = SoftSensor.from_spr(spr_s).warmup()
    x_ols, a_ols, _ = s_ols.predict_batch(frames.T)
    ys = []
    for j in range(frames.shape[1]):
        y = np.zeros((14, 3))
        y[:, 0] = frames[:, j]
        y[:, 2] = rows_s // npts
        ys.append(y)
    a_spr, _ = spr_s.predict(ys)
    ols_bar = 14 * spr_s.k * FP32_UNIT_ROUNDOFF
    ols_err = float((a_ols.double() - a_spr.double()).abs().max()
                    / a_spr.double().abs().max())
    nr_ols = float(nrmse(x_ols.T, Tf))
    log(f"  OLS SoftSensor vs SPR.predict (host float64): max|Δa|/max|a| "
        f"{ols_err:.4e} (≤ s · cond₂(Θ) · u = 14 · {spr_s.k:.4e} · 2⁻²⁴ = "
        f"{ols_bar:.4e}); 4-frame NRMSE {nr_ols:.4e} (≤ "
        f"{NRMSE_FLAGSHIP_MAX})")
    if not ols_err <= ols_bar:
        fail(f"OLS sensor coefficients {ols_err:.3e} from SPR.predict's")
    if not nr_ols <= NRMSE_FLAGSHIP_MAX:
        fail(f"OLS serving NRMSE {nr_ols:.3e} > {NRMSE_FLAGSHIP_MAX}")
    for r_ in records:
        if r_["name"] == "qrcp_pivots_cuda[flagship]":
            r_["launches"] += launches_s

    # ---- serving, GP family ---------------------------------------------
    log("phase 10: serving, GP family — GPRSensor.from_gpr on phase 6's "
        "MultiTask model, without and with limits")
    t_phase = time.perf_counter()
    gm = gp_models["MultiTask"]
    gp_limits = bind_limits
    g_free = GPRSensor.from_gpr(gm).warmup(batch=Ptft.shape[0])
    g_box = GPRSensor.from_gpr(gm, limits=gp_limits,
                               admm_iters=SERVE_ITERS).warmup(
                                   batch=Ptft.shape[0])
    # a request's posterior is a Cholesky factor and triangular solves:
    # it launches no csrc/chol.cu (training does)
    n_req = 0
    outs = {}

    def requests():
        nonlocal n_req
        for tag, sensor in (("free", g_free), ("limits", g_box)):
            for _ in range(3):
                outs[tag] = sensor(Ptft)
                n_req += 1
    _, gp_sensor_launches = chol_counted(requests)
    if gp_sensor_launches:
        fail(f"GPRSensor requests launched csrc/chol.cu "
             f"{gp_sensor_launches} times")
    a_free_ref, s_free_ref = gm.predict(Ptft)
    x_free_ref = gm.reconstruct(a_free_ref).T
    a_box_ref, _ = gm.predict(Ptft, limits=gp_limits, max_iter=SERVE_ITERS,
                              tol=0.0)

    def rel(a, b):
        return float((a.double() - b.double()).abs().max()
                     / b.double().abs().max())

    e_free = max(rel(outs["free"][1], a_free_ref),
                 rel(outs["free"][2], s_free_ref),
                 rel(outs["free"][0], x_free_ref))
    e_box = rel(outs["limits"][1], a_box_ref)
    g_at = violation(outs["limits"][0], gp_limits)[1]
    t_free = per_call_ms({0: lambda: g_free(Ptft)}, reps=20, warmup=2)[0]
    t_box = per_call_ms({0: lambda: g_box(Ptft)}, reps=10, warmup=2)[0]
    log(f"  unconstrained sensor vs GPR.predict + reconstruct: max rel "
        f"{e_free:.4e} (≤ {GP_SERVE_REL}); with limits vs GPR.predict("
        f"limits=…, max_iter={SERVE_ITERS}, tol=0): max|ΔA|/max|A| "
        f"{e_box:.4e} (≤ {GP_SERVE_MAP_REL}), {g_at} field entries at a "
        f"limit (within 1e-6 of the span); chol launches "
        f"{gp_sensor_launches} in {n_req} requests; per request batch of "
        f"{Ptft.shape[0]} points: unconstrained {t_free[0]:.4f} ms (min "
        f"{t_free[1]:.4f}, max {t_free[2]:.4f}), with limits "
        f"{t_box[0]:.4f} ms (min {t_box[1]:.4f}, max {t_box[2]:.4f})")
    for tag, (f_, a_, s_) in outs.items():
        if not all(bool(torch.isfinite(t).all()) for t in (f_, a_, s_)):
            fail(f"GPRSensor ({tag}) output is not finite")
    if not e_free <= GP_SERVE_REL:
        fail(f"GPRSensor disagrees with GPR.predict: {e_free:.3e}")
    if not e_box <= GP_SERVE_MAP_REL:
        fail(f"constrained GPRSensor disagrees with the eager MAP: "
             f"{e_box:.3e}")
    log(f"  phase 10 took {time.perf_counter() - t_phase:.1f} s")

    # ---- CPOD -------------------------------------------------------------
    log("phase 11: ROM.CPOD on the 41 flagship snapshots, limits only "
        "(max_iter 4000, tol 1e-9)")
    t_phase = time.perf_counter()
    rom = ROM(flag["X_train"], 9, flag["xyz"])
    rom.fit(select_modes="number", n_modes=14)
    a_ev = torch.cuda.Event(enable_timing=True)
    b_ev = torch.cuda.Event(enable_timing=True)
    a_ev.record()
    rom.CPOD(limits=limits)
    b_ev.record()
    b_ev.synchronize()
    cpod_ms = a_ev.elapsed_time(b_ev)
    its = rom.admm_info.iterations.cpu().numpy()
    cpod_reads = host_syncs(lambda: rom.CPOD(limits=limits))
    lo_s, hi_s = rom.scale_limits(limits)
    z = rom.Ur @ rom.Ar.T
    viol = torch.clamp(torch.maximum(lo_s[:, None] - z, z - hi_s[:, None]),
                       min=0.0)
    viol_rel = float((viol / (hi_s - lo_s)[:, None]).max())
    log(f"  {cpod_ms:.2f} ms (CUDA events, first call); iterations per "
        f"snapshot {its.tolist()}; synchronizing calls {cpod_reads} (one "
        f"flag every 16 iterations, and the result's); largest violation of "
        f"the scaled limits "
        f"{viol_rel:.4e} of their width")
    if not bool(torch.isfinite(rom.Ar).all()) or tuple(rom.Ar.shape) != (41, 14):
        fail("CPOD coefficients are not finite of shape (41, 14)")
    if not viol_rel <= SERVE_VIOL_REL:
        fail(f"CPOD reconstruction violates the limits by {viol_rel:.3e}")
    log(f"  phase 11 took {time.perf_counter() - t_phase:.1f} s")

    # ---- multifidelity: the co-kriging θ search on csrc/chol.cu ---------
    from openmeasure_torch import CoKriging, CoKrigingSensor, PIGPR
    from openmeasure_torch.multifi import mfk as mfk_mod
    from openmeasure_torch.pipelines import mfk_end_to_end

    mfk_a = mfk_problem()
    mfk_a32 = [a.astype(np.float32) for a in mfk_a]
    lf_b32 = cokriging_lf_set(flag)

    def cokriging_b(d, lf, engine):
        """Configuration B: ``CoKriging`` on the flagship HF snapshots
        (15 linked) and the LF set (41 conditions); returns the model and
        the walls (ms) of alignment and fit."""
        P = d["P_train"]
        ck = CoKriging(P[:15], P[15:], lf[0][:, :15], lf[0][:, 15:],
                       d["X_train"][:, :15], lf[1], d["xyz"], 9)
        ck.engine = engine
        walls = []
        for step in (lambda: ck.manifold_alignment(
                select_modes="number", n_modes_hf=CK_MODES,
                n_modes_lf=CK_MODES), ck.fit):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            step()
            b.record()
            b.synchronize()
            walls.append(a.elapsed_time(b))
        return ck, walls

    def captured(fn):
        """``fn()`` with every batch the dispatch hands ``csrc/chol.cu``
        recorded, in order (the wrapper itself still launches)."""
        seen = []
        real = chol_plain.chol_inv_logdet_cuda

        def record(K):
            seen.append(K.detach().clone())
            return real(K)

        chol_plain.chol_inv_logdet_cuda = record
        try:
            out = fn()
            sync()
        finally:
            chol_plain.chol_inv_logdet_cuda = real
        return out, seen

    log("phase 12: csrc/chol.cu vs chol_inv_logdet_plain on the co-kriging "
        "θ search's correlation matrices (configurations A and B, fp32): "
        "equal where finite, NaN in the same places")
    t_phase = time.perf_counter()
    _, seen_a = captured(lambda: mfk_end_to_end(*mfk_a32))
    _, seen_b = captured(lambda: cokriging_b(flag, lf_b32, "device"))
    ck_batches = {}
    for tag, seen in (("A", seen_a), ("B", seen_b)):
        for K in seen:
            key = (tag, K.shape[0], K.shape[-1])
            if key not in ck_batches:       # first screening / Newton batch
                ck_batches[key] = K
    ck_err = 0.0
    for (tag, B, n), K in sorted(ck_batches.items()):
        kk, lk = chol_kern.chol_inv_logdet_cuda(K)
        kp, lp = chol_plain.chol_inv_logdet_plain(K)
        sync()
        same_nan = bool(torch.equal(torch.isnan(kk), torch.isnan(kp))) and \
            bool(torch.equal(torch.isnan(lk), torch.isnan(lp)))
        fin_k, fin_l = ~torch.isnan(kk), ~torch.isnan(lk)
        equal = same_nan and bool(torch.equal(kk[fin_k], kp[fin_k])) and \
            bool(torch.equal(lk[fin_l], lp[fin_l]))
        if same_nan:
            ck_err = max(ck_err, float((kk[fin_k] - kp[fin_k]).abs().max())
                         if bool(fin_k.any()) else 0.0)
        bad = int((~torch.isfinite(lk) | ~torch.isfinite(kk).all(-1).all(-1)
                   ).sum())
        log(f"  {tag} {'screening' if B == 8 * 32 else 'Newton'} batch"
            f" ({B}, {n}, {n}): equal where finite={equal}, NaN masks "
            f"equal={same_nan}; non-finite matrices {bad} of {B}")
        if not equal:
            fail(f"chol kernel differs from its plain version on the "
                 f"co-kriging batch {tag} ({B}, {n}, {n})")
    if not any(k[1] == 8 * 32 for k in ck_batches) or \
            not any(k[1] == 8 * 5 for k in ck_batches):
        fail(f"phase 12 captured no screening or Newton batch: "
             f"{sorted(ck_batches)}")
    # the kernel at the search's shapes: device time, plain, bound
    ck_times = {}
    for (tag, B, n), K in sorted(ck_batches.items()):
        if tag != "A":
            continue
        dev_ms_, n_seen = traced_ms(
            lambda K=K: chol_kern.chol_inv_logdet_cuda(K), "chol_inv_logdet",
            100, 50)
        if n_seen < 50:
            fail(f"torch.profiler saw {n_seen} chol_inv_logdet launches of "
                 f"100 at ({B}, {n}, {n}) in 3 traces")
        plain_ms_ = loop_ms(lambda K=K: chol_plain.chol_inv_logdet_plain(K),
                            n=3, warmup=1)
        b_ms, o_ms = chol_bound_ms(B, n)
        ck_times[(B, n)] = (dev_ms_, plain_ms_, b_ms, o_ms)
        log(f"  chol at ({B}, {n}, {n}): {dev_ms_:.5f} ms device time a "
            f"launch (median of {n_seen}), plain {plain_ms_:.4f} ms, bound "
            f"{max(b_ms, o_ms):.6f} ms (bytes {b_ms:.6f}, ops {o_ms:.6f})")
    log(f"  phase 12 took {time.perf_counter() - t_phase:.1f} s")

    log(f"phase 13: mfk_end_to_end, configuration A (K = 8 outputs, 40 LF "
        f"and 15 HF sites, 25 test points, d = 2, seed 3): fp32 against "
        f"float64 on the card (NRMSE ≤ {MFK_FP32_NRMSE} of the float64 "
        "means' range)")
    t_phase = time.perf_counter()
    n_evals = [0]
    real_inv = mfk_mod._level_nll_inv

    def eval_counted(*a):
        n_evals[0] += 1
        return real_inv(*a)

    mfk_mod._level_nll_inv = eval_counted
    try:
        r32, n_mfk = chol_counted(lambda: mfk_end_to_end(*mfk_a32))
    finally:
        mfk_mod._level_nll_inv = real_inv
    r64 = mfk_end_to_end(*mfk_a)
    sync()
    m64 = r64.mean
    mfk_nrmse = float(torch.sqrt(torch.mean((r32.mean.double() - m64) ** 2))
                      / (m64.max() - m64.min()))
    a32 = [torch.as_tensor(a, device=dev) for a in mfk_a32]
    walls = []
    for _ in range(6):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        res = mfk_end_to_end(*a32)
        b.record()
        b.synchronize()
        walls.append(a.elapsed_time(b))
    walls = walls[1:]
    steps = r32.newton_steps.tolist()
    # the search reads one "all lanes done" flag every CHECK_EVERY steps
    # of each level, and nothing else
    flag_reads = sum(-(-s // mfk_mod.CHECK_EVERY) for s in steps)
    _, mfk_dtoh = trace_counts(lambda: mfk_end_to_end(*a32))
    n_sync = host_syncs(lambda: mfk_end_to_end(*a32))
    log(f"  one call: device-to-host copies {mfk_dtoh} (the stop flags: "
        f"{flag_reads}), synchronizing calls {n_sync} (uploads of the "
        "starts and the screening cloud included)")
    if mfk_dtoh > flag_reads:
        fail(f"mfk_end_to_end read back {mfk_dtoh} times, beyond its "
             f"{flag_reads} stop flags")
    log(f"  fp32 vs float64 NRMSE / range {mfk_nrmse:.4e} (≤ "
        f"{MFK_FP32_NRMSE}); chol launches {n_mfk} for {n_evals[0]} NLL "
        f"evaluations; Newton steps of the slowest lane per level "
        f"{steps} (float64 {r64.newton_steps.tolist()}); wall per call "
        f"median {statistics.median(walls):.4f} ms (min {min(walls):.4f}, "
        f"max {max(walls):.4f}; 5 calls after one warm-up, CUDA events, "
        f"inputs on the card) → {statistics.median(walls) / sum(steps):.4f} "
        f"ms per Newton step")
    if not (bool(torch.isfinite(r32.mean).all())
            and bool(torch.isfinite(r32.mse).all())
            and tuple(r32.mean.shape) == (8, 25)):
        fail("fp32 mfk_end_to_end output is not finite of shape (8, 25)")
    if not mfk_nrmse <= MFK_FP32_NRMSE:
        fail(f"fp32 mfk_end_to_end {mfk_nrmse:.3e} from float64")
    if n_evals[0] < 1 or n_mfk < n_evals[0]:
        fail(f"mfk_end_to_end launched csrc/chol.cu {n_mfk} times for "
             f"{n_evals[0]} NLL evaluations")
    log(f"  phase 13 took {time.perf_counter() - t_phase:.1f} s")

    log(f"phase 14: CoKriging at flagship width, configuration B (HF: the "
        f"flagship's first 15 snapshots; LF: every 4th cell, 41 conditions, "
        f"{lf_b32[0].shape}), {CK_MODES} modes a side; fp32 against float64 "
        f"(engine='host', float64 alignment), the truth and the sensor")
    t_phase = time.perf_counter()
    (ck32, ck_walls), n_ck = chol_counted(
        lambda: cokriging_b(flag, lf_b32, "device"))
    flag64 = make_flame_dataset(dtype=np.float64)
    ck64, _ = cokriging_b(flag64, cokriging_lf_set(flag64), "host")
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    Y32, _ = ck32.predict(Ptf)
    b.record()
    b.synchronize()
    pred_ms = a.elapsed_time(b)
    Y64, _ = ck64.predict(flag64["P_test"])
    T64 = torch.as_tensor(flag64["X_test"], device=dev)
    rng64 = float(T64.max() - T64.min())
    ck_gap = float(torch.sqrt(torch.mean((Y32.double() - Y64) ** 2))) / rng64
    ck_gap_max = float((Y32.double() - Y64).abs().max()) / rng64
    ck_truth = float(torch.sqrt(torch.mean((Y32.double() - T64) ** 2))) \
        / rng64
    ck_truth64 = float(torch.sqrt(torch.mean((Y64 - T64) ** 2))) / rng64
    sensor = CoKrigingSensor.from_cokriging(ck32).warmup(
        batch=Ptft.shape[0])
    Ys, _ = sensor(Ptft)
    sync()
    ck_sensor = float((Ys - Y32).abs().max() / (Y32.max() - Y32.min()))
    t_req = per_call_ms({0: lambda: sensor(Ptft)}, reps=20, warmup=2)[0]
    log(f"  fp32: alignment {ck_walls[0]:.2f} ms, fit {ck_walls[1]:.2f} ms "
        f"(chol launches {n_ck}), predict {pred_ms:.2f} ms (CUDA events, "
        f"first calls); n_latent {ck32.n_latent}")
    log(f"  fp32 vs float64: NRMSE / HF test range {ck_gap:.4e} (≤ "
        f"{CK_FP32_NRMSE}), max {ck_gap_max:.4e}; reconstruction NRMSE vs "
        f"the 4 HF test snapshots {ck_truth:.4e} fp32, {ck_truth64:.4e} "
        f"float64 (< {CK_TRUTH_NRMSE}); CoKrigingSensor vs predict "
        f"{ck_sensor:.4e} of the span (≤ {CK_SENSOR_REL}); one sensor "
        f"request of {Ptft.shape[0]} points {t_req[0]:.4f} ms (min "
        f"{t_req[1]:.4f}, max {t_req[2]:.4f})")
    if not bool(torch.isfinite(Y32).all()) or \
            tuple(Y32.shape) != flag["X_test"].shape:
        fail("fp32 CoKriging prediction is not finite of the test shape")
    if not ck_gap <= CK_FP32_NRMSE:
        fail(f"fp32 CoKriging {ck_gap:.3e} from float64")
    if not ck_truth < CK_TRUTH_NRMSE:
        fail(f"CoKriging reconstruction NRMSE {ck_truth:.3e}")
    if not ck_sensor <= CK_SENSOR_REL:
        fail(f"CoKrigingSensor differs from CoKriging.predict: "
             f"{ck_sensor:.3e}")
    if n_ck < 1:
        fail("the CoKriging fit never launched csrc/chol.cu")
    log(f"  phase 14 took {time.perf_counter() - t_phase:.1f} s")

    log("phase 15: PIGPR at flagship width (configuration C: r = 14, the 8 "
        "corners and the centre of the P box, temperature block within "
        f"[{T_LO:.0f}, {T_HI:.0f}] K, max_iter 1000) against a plain "
        "MultiTask GPR; GPR.update on phase 6's SingleTask model "
        "(configuration D)")
    t_phase = time.perf_counter()
    npts = flag["xyz"].shape[0]
    lo_p, hi_p = Pf.min(axis=0), Pf.max(axis=0)
    P_cstr = np.vstack([np.stack(np.meshgrid(*zip(lo_p, hi_p))).reshape(
        3, -1).T, (lo_p + hi_p) / 2])

    def t_violation(model):
        A, _ = model.predict(P_cstr)
        T = model.reconstruct(A)[:npts].double()
        return float(torch.mean(torch.clamp(T - T_HI, min=0.0) ** 2
                                + torch.clamp(T_LO - T, min=0.0) ** 2))

    pig = PIGPR(flag["X_train"], 9, flag["xyz"], Pf, P_cstr, None)
    pig.fit(select_modes="number", n_modes=14)
    UrS = pig.Ur[:npts] * pig.Sigma_r[None, :]
    Xc, Xs = pig.X_cnt[:npts], pig.X_scl[:npts]
    n_tr = Pf.shape[0]

    def added_loss(ctx):
        V = ctx["output"].mean[n_tr:]
        T = Xs * (UrS @ V.T) + Xc
        return -ctx["loss_dict"]["coef"] * torch.mean(
            torch.clamp(T - T_HI, min=0.0) ** 2
            + torch.clamp(T_LO - T, min=0.0) ** 2)

    pig.AddedLoss = added_loss
    loss_mll, V0 = pig.compute_mll()
    T0 = Xs * (UrS @ V0[n_tr:].T) + Xc
    v0 = float(torch.mean(torch.clamp(T0 - T_HI, min=0.0) ** 2
                          + torch.clamp(T_LO - T0, min=0.0) ** 2))
    coef = abs(float(loss_mll)) / max(v0, 1.0)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    _, n_pig = chol_counted(lambda: pig.train(loss_dict={"coef": coef}))
    b.record()
    b.synchronize()
    pig_ms = a.elapsed_time(b)
    pig_its = int(pig._iterations[0])
    pig_loss = float(pig._final_loss[0])
    gm_plain = gp_models["MultiTask"]
    v_pig, v_gpr = t_violation(pig), t_violation(gm_plain)
    nr_pig = float(nrmse(pig.reconstruct(pig.predict(Ptf)[0]), Tf))
    nr_gpr = float(nrmse(gm_plain.reconstruct(gm_plain.predict(Ptf)[0]), Tf))
    log(f"  PIGPR: initial MLL {float(loss_mll):.4f}, initial violation "
        f"{v0:.4f} K² → coefficient {coef:.4e}; final loss {pig_loss:.6f}; "
        f"Adam iterations {pig_its}, {pig_ms:.2f} ms ({pig_ms / pig_its:.4f} "
        f"ms per iteration, CUDA events, first call); chol launches "
        f"{n_pig} ({n_pig / pig_its:.2f} per iteration)")
    log(f"  mean squared temperature violation at the constraint points: "
        f"PIGPR {v_pig:.6e} K², plain MultiTask GPR {v_gpr:.6e} K²; test "
        f"NRMSE PIGPR {nr_pig:.6e}, plain {nr_gpr:.6e}")
    if not np.isfinite(pig_loss):
        fail("PIGPR's final loss is not finite")
    if not v_pig <= v_gpr:
        fail(f"PIGPR violates the bounds more than the plain GPR: "
             f"{v_pig:.4e} > {v_gpr:.4e} K²")
    if n_pig < pig_its:
        fail(f"PIGPR launched csrc/chol.cu {n_pig} times in {pig_its} "
             "iterations")

    # the 4 test snapshots' projections on the basis, assimilated 2 by 2
    gs = gp_single
    A_new = (((Tf - gs.X_cnt) / gs.X_scl).T @ gs.Ur).double().cpu().numpy()
    gs.update(Ptf[:2], A_new[:2])
    A_sig = 0.05 * np.abs(A_new[2:]) + 1e-3
    _, n_upd = chol_counted(lambda: gs.update(
        Ptf[2:], A_new[2:], A_sig, retrain=True))
    a_upd, s_upd = gs.predict(Ptf)
    sync()
    upd_nr = float(nrmse(gs.reconstruct(a_upd), Tf))
    log(f"  GPR.update: 2 points assimilated without retraining, then 2 with "
        f"retrain=True and A_sigma (fixed noise, "
        f"{type(gs.likelihood).__name__}): training set "
        f"{gs._train_X.shape[0]} points, Adam iterations "
        f"{gs._iterations.tolist()}, chol launches of the retrain {n_upd}; "
        f"predictions finite={bool(torch.isfinite(a_upd).all())}, NRMSE "
        f"{upd_nr:.6e}")
    if not (bool(torch.isfinite(a_upd).all())
            and bool(torch.isfinite(s_upd).all())):
        fail("predictions after GPR.update are not finite")
    if n_upd < 1:
        fail("the fixed-noise retrain never launched csrc/chol.cu")
    log(f"  phase 15 took {time.perf_counter() - t_phase:.1f} s")

    for r_ in records:
        if r_["name"] == "chol_inv_logdet_cuda":
            r_["launches"] += n_pig + n_upd
            r_["max_abs_err"] = max(r_["max_abs_err"], ck_err)
    nb = (8 * 5, mfk_a[0].shape[0])
    dms, pms, bms, oms = ck_times[nb]
    records.append({
        "name": "chol_inv_logdet_cuda[cokriging]", "route": "cuda",
        "source": "openmeasure_torch/csrc/chol.cu",
        "replaces": "openmeasure_tpu/linalg/chol_pallas.py:85",
        "launches": n_mfk + n_ck, "max_abs_err": ck_err, "ms": dms,
        "plain_ms": pms, "bound_ms": max(bms, oms),
        "bound_by": "bytes" if bms >= oms else "operations",
        "library_ms": None})

    # ---- the other placements (phase 16) --------------------------------
    from openmeasure_torch import (DMD, DecoderSensor, DynamicSensor,
                                   ShallowDecoder)
    from openmeasure_torch.sensing import decoder as dec_mod
    from openmeasure_torch.sensing import dg as dg_mod
    from openmeasure_torch.sensing import gem as gem_mod
    from openmeasure_torch.sensing import vector as vec_mod

    log(f"phase 16: placements at flagship width (165,258 rows, r = 14): "
        f"GEM {PLACE_N['gem']} sensors with d_min = 0.05, DG "
        f"{PLACE_N['dg']} (2r), VDG {PLACE_N['vdg']} probes × 9 features; "
        f"the fp32 selections' objectives (in float64) within "
        f"{PLACE_OBJ_REL} of float64 arithmetic's on the same basis, or "
        f"better; the float64 model's beside them")
    t_phase = time.perf_counter()
    spr_p = SPR(flag["X_train"], 9, flag["xyz"])
    spr_p.fit(select_modes="number", n_modes=14)
    spr_64 = SPR(flag["X_train"].astype(np.float64), 9, flag["xyz"])
    spr_64.fit(select_modes="number", n_modes=14)
    U64 = spr_64.Ur.cpu().numpy()
    C_qr, n_qr16 = counted(lambda: spr_p.optimal_placement())
    rows_qr = C_qr.argmax(dim=1).cpu().numpy()
    if n_qr16 != 1:
        fail(f"the QR placement launched csrc/qrcp.cu {n_qr16} times, not 1")
    place_kw = {"gem": dict(n_sensors=PLACE_N["gem"], d_min=0.05),
                "dg": dict(n_sensors=PLACE_N["dg"]),
                "vdg": dict(n_sensors=PLACE_N["vdg"])}
    tiled = np.tile(flag["xyz"], (9, 1))
    U32d = spr_p.Ur.double()
    U32np = U32d.cpu().numpy()
    # VDG's δ: float64 arithmetic on the fp32 model's basis is given the
    # fp32 run's δ, and each basis's objective is taken at its model's δ
    d32, e32 = vdg_delta(U32np, 9, float(np.finfo(np.float32).eps))
    d64, _ = vdg_delta(U64, 9, float(np.finfo(np.float64).eps))
    # each family's selection by float64 arithmetic on the fp32 model's
    # basis, and each family's objective on a basis
    select64 = {
        "gem": lambda U: gem_mod.gem_select(U, tiled, PLACE_N["gem"],
                                            d_min=0.05),
        "dg": lambda U: dg_mod.dg_select(U, PLACE_N["dg"]),
        "vdg": lambda U: vec_mod.vector_dg_select(U, 9, PLACE_N["vdg"],
                                                  ridge=d32 / e32)}
    objective = {"gem": gem_entropy, "dg": dg_logdet,
                 "vdg": lambda U, sel: vdg_logdet(
                     U, sel, 9, d32 if U is U32np else d64)}
    # the JAX code's reads: GEM one (the result), DG one (the result), VDG
    # three (the block energies' mean and max, then the result)
    jax_reads = {"gem": 1, "dg": 1, "vdg": 3}

    def gappy_nrmse(C):
        """Held-out NRMSE of the gappy-POD solve with the sensors of C."""
        spr_p.train(C)
        rows = C.argmax(dim=1).cpu().numpy()
        ys = [np.column_stack([flag["X_test"][rows, j], np.zeros(rows.size),
                               rows // npts])
              for j in range(flag["X_test"].shape[1])]
        a, _ = spr_p.predict(ys)
        return float(nrmse(spr_p.reconstruct(a), Tf))

    def points(kind, spr, C):
        return (spr.sensor_points if kind == "vdg"
                else C.argmax(dim=1).cpu().numpy())

    place_C = {"qr": C_qr}
    n_place = {}
    for kind, kw in place_kw.items():
        C32, n_place[kind] = counted(
            lambda kind=kind, kw=kw: spr_p.optimal_placement(kind, **kw))
        s32 = points(kind, spr_p, C32)
        s64 = points(kind, spr_64, spr_64.optimal_placement(kind, **kw))
        s64_same = select64[kind](U32d)
        o32, o64 = (objective[kind](U32np, sel) for sel in (s32, s64_same))
        b32, b64 = (objective[kind](U64, sel) for sel in (s32, s64))
        med, lo_t, hi_t = per_call_ms(
            {0: lambda kind=kind, kw=kw: spr_p.optimal_placement(kind, **kw)},
            reps=6, warmup=1)[0]
        kernels, dtoh = trace_counts(
            lambda kind=kind, kw=kw: spr_p.optimal_placement(kind, **kw))
        log(f"  {kind}: {C32.shape[0]} sensor rows; on the fp32 model's "
            f"basis (in float64) objective of the fp32 selection {o32:.9e}, "
            f"of float64 arithmetic's {o64:.9e} (relative gap "
            f"{(o64 - o32) / abs(o64):.3e}, shared sensors "
            f"{len(set(s32.tolist()) & set(s64_same.tolist()))}/{len(s32)}); "
            f"on the float64 model's basis: fp32 selection {b32:.9e}, "
            f"float64 model's selection {b64:.9e} (relative gap "
            f"{(b64 - b32) / abs(b64):.3e}, shared sensors "
            f"{len(set(s32.tolist()) & set(s64.tolist()))}/{len(s32)}); "
            f"wall per optimal_placement call median {med:.4f} ms (min "
            f"{lo_t:.4f}, max {hi_t:.4f}; 6 calls, CUDA events); "
            f"{'not measured' if kernels is None else kernels} device "
            f"kernels and {dtoh} device-to-host copies per call (the JAX "
            f"code reads {jax_reads[kind]}); qrcp launches {n_place[kind]}")
        if not bool(torch.isfinite(C32).all()) or C32.shape[1] != 165258:
            fail(f"the {kind} placement's C is not finite of width 165,258")
        if not (o32 >= o64 or abs(o32 - o64) <= PLACE_OBJ_REL * abs(o64)):
            fail(f"{kind}: fp32 objective {o32:.6e} against float64 "
                 f"arithmetic's {o64:.6e} on the same basis")
        if dtoh > jax_reads[kind]:
            fail(f"{kind} read back {dtoh} times, the JAX code "
                 f"{jax_reads[kind]}")
        place_C[kind] = C32
        if kind == "dg":
            piv = s32[:14]
            want = plain.qrcp_pivots(spr_p.Ur.T, 14).cpu().numpy()
            log(f"  dg phase 1: pivots equal to the plain sweep on the same "
                f"panel={bool(np.array_equal(piv, want))}, to the QR "
                f"placement's={bool(np.array_equal(piv, rows_qr))}, "
                f"csrc/qrcp.cu launches {n_place['dg']}")
            if not np.array_equal(piv, want) or n_place["dg"] != 1:
                fail("dg phase 1 is not one csrc/qrcp.cu launch bit-equal "
                     "to the plain sweep")
    log("  held-out gappy-POD NRMSE (4 test snapshots) by sensor set: "
        + ", ".join(f"{kind} ({C.shape[0]} rows) {gappy_nrmse(C):.4e}"
                    for kind, C in place_C.items()))
    spr_p.train(C_qr)
    log(f"  phase 16 took {time.perf_counter() - t_phase:.1f} s")

    # ---- the shallow decoder (phase 17) ---------------------------------
    log(f"phase 17: ShallowDecoder hidden {DEC_HIDDEN}, {DEC_EPOCHS} epochs, "
        f"lr {DEC_LR} (docs/examples/decoder_example.py), on the QR "
        f"placement's 14 sensors and on the VDG probes; fp32 against float64 "
        f"from the same initial weights (held-out NRMSE within "
        f"{DEC_FP32_SLACK:.0%}); DecoderSensor at batch {SERVE_BATCH}")
    t_phase = time.perf_counter()
    X64f = flag["X_train"].astype(np.float64)
    for tag in ("qr", "vdg"):
        C = place_C[tag]
        rows = C.argmax(dim=1).cpu().numpy()
        ys = [np.column_stack([flag["X_test"][rows, j], np.zeros(rows.size),
                               rows // npts])
              for j in range(flag["X_test"].shape[1])]
        sizes = (C.shape[0],) + DEC_HIDDEN + (C.shape[1],)
        p0 = dec_mod.init_params(sizes, 0, torch.float64, dev)
        decs, dec_nr = {}, {}
        for dt, X in ((torch.float32, flag["X_train"]), (torch.float64, X64f)):
            d_ = ShallowDecoder(X, 9, flag["xyz"], hidden=DEC_HIDDEN)
            d_.fit(C.to(dt), epochs=DEC_EPOCHS, lr=DEC_LR, params0=p0)
            decs[dt] = d_
            dec_nr[dt] = float(nrmse(d_.predict(ys).double(), Tf))
        dec = decs[torch.float32]
        X0 = ((torch.as_tensor(flag["X_train"], device=dev) - dec.X_cnt)
              / dec.X_scl)
        Y0 = C @ X0
        p32 = [(W.float(), b.float()) for W, b in p0]
        ep_ms = loop_ms(lambda: dec_mod._train(Y0.T, X0.T, p32, 100, DEC_LR,
                                               1e-6), n=1, warmup=1,
                        rounds=3) / 100
        k_ep, dtoh_tr = trace_counts(
            lambda: dec_mod._train(Y0.T, X0.T, p32, 10, DEC_LR, 1e-6))
        sync_tr = host_syncs(
            lambda: dec_mod._train(Y0.T, X0.T, p32, 10, DEC_LR, 1e-6))
        sensor = DecoderSensor.from_decoder(dec).warmup()
        Yd = torch.as_tensor(np.tile(flag["X_test"][rows].T, (13, 1))
                             [:SERVE_BATCH], device=dev)
        med, lo_t, hi_t = per_call_ms(
            {0: lambda: sensor.predict_batch(Yd)}, reps=10, warmup=2)[0]
        k_b, dtoh_b = trace_counts(lambda: sensor.predict_batch(Yd))
        sync_b = host_syncs(lambda: sensor.predict_batch(Yd))
        x_dec = dec.predict(ys)
        x_srv = sensor.predict_batch(
            torch.as_tensor(flag["X_test"][rows].T, device=dev))
        srv_err = float((x_srv.T - x_dec).abs().max() / x_dec.abs().max())
        loss = dec.loss_history.cpu().numpy()
        log(f"  {tag} ({C.shape[0]} sensors): held-out NRMSE fp32 "
            f"{dec_nr[torch.float32]:.4e}, float64 "
            f"{dec_nr[torch.float64]:.4e}; final loss fp32 {loss[-1]:.4e}; "
            f"training {ep_ms:.4f} ms per epoch (100 epochs, CUDA events), "
            f"{'not measured' if k_ep is None else f'{k_ep / 10:.1f}'} "
            f"kernels per epoch, {dtoh_tr} device-to-host copies and "
            f"{sync_tr} synchronizing calls in 10 epochs; DecoderSensor "
            f"batch {SERVE_BATCH}: {med / SERVE_BATCH:.6f} ms per frame "
            f"(batch median {med:.4f} ms, min {lo_t:.4f}, max {hi_t:.4f}), "
            f"{k_b} kernels per batch, {dtoh_b} device-to-host copies, "
            f"{sync_b} synchronizing calls; served vs predict "
            f"{srv_err:.3e} (≤ {DEC_SERVE_REL})")
        if not np.all(np.isfinite(loss)) or not np.isfinite(
                dec_nr[torch.float32]):
            fail(f"decoder ({tag}) training is not finite")
        if abs(dec_nr[torch.float32] - dec_nr[torch.float64]) \
                > DEC_FP32_SLACK * dec_nr[torch.float64]:
            fail(f"decoder ({tag}) fp32 NRMSE {dec_nr[torch.float32]:.4e} "
                 f"against float64 {dec_nr[torch.float64]:.4e}")
        if dtoh_tr or sync_tr:
            fail(f"decoder ({tag}) training read back to the host")
        if dtoh_b or sync_b:
            fail(f"DecoderSensor ({tag}) batch read back to the host")
        if not srv_err <= DEC_SERVE_REL:
            fail(f"DecoderSensor ({tag}) {srv_err:.3e} from predict")
    log(f"  phase 17 took {time.perf_counter() - t_phase:.1f} s")

    # ---- the temporal layer (phase 18) ----------------------------------
    log("phase 18: DMD and DynamicSensor on the docs/examples/"
        "dynamics_example.py series (50,000 points × 2 features, 60 + 40 "
        "snapshots, latent rank 6, σ = 0.5·std), then DynamicSensor.from_spr "
        f"on the flagship SPR at batch {SERVE_BATCH}, σ = 0.05")
    t_phase = time.perf_counter()
    Xs_train, Xs_test, xyz_s, rng_s = dynamics_series()
    dmds = {}
    for key, X, n_modes in (("fp32", Xs_train, 8),
                            ("float64", Xs_train.astype(np.float64), 8)):
        dmd = DMD(X, 2, xyz_s)
        dmd.fit(dt=1.0, select_modes="number", n_modes=n_modes)
        dmds[key] = dmd
    # the float64 fit at the rank the fp32 fit kept: truncating at another
    # rank moves the dominant eigenvalues too, whatever the precision
    dmd = DMD(Xs_train.astype(np.float64), 2, xyz_s)
    dmd.fit(dt=1.0, select_modes="number", n_modes=dmds["fp32"].r)
    dmds["float64, fp32's rank"] = dmd
    top = {key: np.sort_complex(d_.eigs[np.argsort(-np.abs(d_.amplitudes))
                                        [:6]])
           for key, d_ in dmds.items()}
    eig_err = float(np.max(np.abs(top["fp32"]
                                  - top["float64, fp32's rank"])))
    eig_err_8 = float(np.max(np.abs(top["fp32"] - top["float64"])))
    fc = dmds["fp32"].forecast_horizon(10)
    fc_nr = float(nrmse(fc.double(), torch.as_tensor(Xs_test[:, :10],
                                                     device=dev)))
    log(f"  DMD n_modes = 8: ranks fp32 {dmds['fp32'].r}, float64 "
        f"{dmds['float64'].r}; the 6 largest-amplitude eigenvalues, fp32 "
        f"against float64 at fp32's rank max|Δλ| {eig_err:.3e} (≤ "
        f"{DMD_EIG_ABS}), against float64 at its own rank {eig_err_8:.3e}; "
        f"fp32 10-step forecast NRMSE {fc_nr:.4f} (the example's bar 0.2)")
    if not eig_err <= DMD_EIG_ABS:
        fail(f"fp32 DMD eigenvalues {eig_err:.3e} from float64")
    if not fc_nr < 0.2:
        fail(f"DMD forecast NRMSE {fc_nr:.4f}")
    spr_d = SPR(Xs_train, 2, xyz_s)
    spr_d.fit(select_modes="number", n_modes=6)
    C_d, n_qr18 = counted(lambda: spr_d.optimal_placement())
    spr_d.train(C_d)
    rows_d = C_d.argmax(dim=1).cpu().numpy()
    Y_clean = Xs_test[rows_d, :].T
    sig_d = 0.5 * np.std(Y_clean, axis=0)
    Y_noisy = Y_clean + rng_s.standard_normal(Y_clean.shape) * sig_d[None, :]
    S_d = np.broadcast_to(sig_d, Y_clean.shape)
    dyn = DynamicSensor.from_spr(spr_d).warmup(batch=Y_noisy.shape[0])
    static = SoftSensor.from_spr(spr_d).warmup()
    Xt_d = torch.as_tensor(Xs_test, device=dev)
    err_kf = float(nrmse(dyn.filter_batch(Y_noisy, S_d)[0].T.double(), Xt_d))
    err_sm = float(nrmse(dyn.smooth_batch(Y_noisy, S_d)[0].T.double(), Xt_d))
    err_st = float(nrmse(static.predict_batch(Y_noisy, S_d)[0].T.double(),
                         Xt_d))
    log(f"  series: NRMSE under 50 % sensor noise filtered {err_kf:.4f}, "
        f"smoothed {err_sm:.4f}, memoryless SoftSensor {err_st:.4f} "
        f"({err_st / err_kf:.2f}× better filtered; the example's bar "
        f"filtered < 0.8 × memoryless); qrcp launches {n_qr18}")
    if not err_kf < 0.8 * err_st:
        fail(f"the filter ({err_kf:.4f}) does not beat the memoryless "
             f"solve ({err_st:.4f})")
    if n_qr18 != 1:
        fail(f"the series' QR placement launched csrc/qrcp.cu {n_qr18} times")
    k32 = DynamicSensor.from_spr(spr_p).warmup(batch=SERVE_BATCH)
    k64 = DynamicSensor.from_spr(spr_p, dtype=torch.float64)
    Yk = torch.as_tensor(np.tile(flag["X_test"][rows_qr].T, (13, 1))
                         [:SERVE_BATCH], device=dev)
    Sk = torch.full_like(Yk, 0.05)
    for method in ("filter_batch", "smooth_batch"):
        fn = getattr(k32, method)
        x32 = fn(Yk, Sk)[0]
        x64 = getattr(k64, method)(Yk.double(), Sk.double())[0]
        sync()
        f_err = float((x32.double() - x64).abs().max()
                      / (x64.max() - x64.min()))
        med, lo_t, hi_t = per_call_ms({0: lambda: fn(Yk, Sk)}, reps=10,
                                      warmup=2)[0]
        k_b, dtoh_b = trace_counts(lambda: fn(Yk, Sk))
        sync_b = host_syncs(lambda: fn(Yk, Sk))
        log(f"  flagship {method}: {med / SERVE_BATCH:.5f} ms per frame "
            f"(batch median {med:.4f} ms, min {lo_t:.4f}, max {hi_t:.4f}; "
            f"10 batches, CUDA events); "
            f"{'not measured' if k_b is None else f'{k_b / SERVE_BATCH:.1f}'}"
            f" kernels per frame ({k_b} per batch), {dtoh_b} device-to-host "
            f"copies, {sync_b} synchronizing calls; fp32 vs float64 fields "
            f"max|Δ| / float64 range {f_err:.3e} (≤ {KF_FIELD_REL})")
        if not bool(torch.isfinite(x32).all()) or tuple(x32.shape) != (
                SERVE_BATCH, 165258):
            fail(f"{method} fields are not finite of shape (50, 165,258)")
        if dtoh_b or sync_b:
            fail(f"a DynamicSensor {method} batch read back to the host")
        if not f_err <= KF_FIELD_REL:
            fail(f"fp32 {method} fields {f_err:.3e} from float64")
    log(f"  phase 18 took {time.perf_counter() - t_phase:.1f} s")
    for r_ in records:
        if r_["name"] == "qrcp_pivots_cuda[flagship]":
            r_["launches"] += n_qr16 + n_place["dg"] + n_qr18

    h = SimpleNamespace(dev=dev, log=log, fail=fail, counted=counted,
                        chol_counted=chol_counted, per_call_ms=per_call_ms,
                        trace_counts=trace_counts, host_syncs=host_syncs,
                        kernel_vs_plain=kernel_vs_plain,
                        chol_errors=chol_errors, gp_matrices=gp_matrices)
    log(f"phase 19: CTC at the reference's tomography scale — a 32³ "
        f"VoxelGrid over ±0.1, a 64×64 camera (parallel; pinhole and thin "
        f"lens with N_rand 8, seed 0), bench.py's 4-view rig through "
        f"stack_cameras, SPR (n_modes {CTC_MODES}) OLS and COLS in [0, 1] "
        f"on {CTC_TRAIN} Gaussian-blob fields with field {CTC_HELD_OUT} "
        f"held out, SoftSensor at batch {SERVE_BATCH}, resampling, and an "
        f"unstructured copy of a 16³ grid.  No TPU kernel is on this path "
        f"(the JAX package's is XLA: jit, vmap, fori_loop, sort)")
    t_phase = time.perf_counter()
    ctc_phase(h)
    log(f"  phase 19 took {time.perf_counter() - t_phase:.1f} s")
    log(f"phase 20: incremental update at flagship width "
        f"(docs/examples/update_example.py: 165,258 rows, {UPD_M} "
        f"snapshots, then {UPD_NEW} with a new regime; r = {UPD_R} → "
        f"{UPD_R + 1}); SPR.update_basis → optimal_placement (csrc/qrcp.cu) "
        f"→ train, GPR.update_basis(retrain=True) (csrc/chol.cu); fp32 "
        f"against the port's float64 run on the card")
    t_phase = time.perf_counter()
    n_qr20, n_chol20 = update_phase(h)
    log(f"  phase 20 took {time.perf_counter() - t_phase:.1f} s")
    for r_ in records:
        if r_["name"] == "qrcp_pivots_cuda[flagship]":
            r_["launches"] += n_qr20
        if r_["name"] == "chol_inv_logdet_cuda":
            r_["launches"] += n_chol20
    h.cube, h.flag = cube, flag
    t_phase = time.perf_counter()
    n_qr21, n_chol23 = streaming_phase(h, after=sharded_phases)
    log(f"  phases 21-27 took {time.perf_counter() - t_phase:.1f} s")
    n_qr26, n_qr26_3d, n_chol26 = h.phase26
    n_qr27_3d, n_chol27 = h.phase27
    for r_ in records:
        if r_["name"] == "qrcp_pivots_cuda[flagship]":
            r_["launches"] += n_qr26
        if r_["name"] == "qrcp_pivots_cuda[3d]":
            r_["launches"] += n_qr21 + n_qr26_3d + n_qr27_3d
        if r_["name"] == "chol_inv_logdet_cuda":
            r_["launches"] += n_chol23 + n_chol26 + n_chol27

    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
