"""CTC tomography and the incremental basis update on the card: the DDA
and the operator assembled on the device against the port's CPU run (on a
grid over 32,768 cells too, where the columns wrap in int16), the one
device-to-host copy of ``VoxelGrid.trace_csr``, a constrained CTC
``SoftSensor`` batch with no read back to the host, and ``update_basis``
in fp32 against float64.

Every test here needs a CUDA card and skips without one; this file imports
neither JAX nor the JAX package, so on a machine with a card it runs as::

    python -m pytest tests/test_torch_ctc_cuda.py --noconftest -q

Bars: the cells, counts and operators EQUAL to the CPU run's in the same
float32 rays (the trace keeps one elementwise operation at a time, so the
card rounds as the CPU does); a served COLS field inside its limits [0, 1]
within 1e-4 (the JAX example's bar) and within 2e-3 of a float64 sensor
relative to the field range (serving's bar, ``chip_smoke.py`` phase 9);
fp32 updated singular values within 1e-3 of float64's relative to the
largest (the fp32 Gram-route fit's own error, which the update carries).
"""

import numpy as np
import pytest
import torch

from openmeasure_torch import SPR, SoftSensor
from openmeasure_torch import ctc
from openmeasure_torch.ctc import raytrace
from openmeasure_torch.datasets.synthetic import make_flame_dataset

BOX = (-0.1, 0.1, -0.1, 0.1, -0.1, 0.1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the trace and the update run there")
    return torch.device("cuda")


def _dtoh_copies(fn):
    """Device-to-host copies in torch.profiler's trace of one call of
    ``fn`` (a few small launches go first: a trace can miss its first
    device events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    lead = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(8):
            lead.add_(1.0)
        torch.cuda.synchronize()
        with record_function("test::call"):
            out = fn()
            torch.cuda.synchronize()
    events = list(prof.events())
    t0 = min(e.time_range.start for e in events if e.name == "test::call")
    n = sum(1 for e in events if e.device_type == DeviceType.CUDA
            and e.time_range.start >= t0 and "DtoH" in e.name)
    return out, n


def _camera(px=16):
    return ctc.camera(np.array([0.05, -0.02, 1.0, 1.0]),
                      np.array([0.05, -0.03, 0.2]), 0.05, 2.8, 0.06,
                      np.array([px, px]), 0.25 / px)


@pytest.mark.cuda
def test_dda_on_the_card_equals_the_cpu(card):
    rng = np.random.default_rng(0)
    p1 = rng.uniform(-0.2, 0.2, (4096, 3))
    p2 = rng.uniform(-0.2, 0.2, (4096, 3))
    grid = ctc.VoxelGrid.from_bounds(BOX, (16, 16, 16), device=card)
    for dtype in (torch.float32, torch.float64):
        out = [raytrace.trace_rays(torch.as_tensor(p1, dtype=dtype,
                                                   device=dev),
                                   torch.as_tensor(p2, dtype=dtype,
                                                   device=dev),
                                   grid.origin, grid.spacing, grid.dims)
               for dev in (card, "cpu")]
        assert torch.equal(out[0][0].cpu(), out[1][0])
        assert torch.equal(out[0][1].cpu(), out[1][1])


@pytest.mark.cuda
@pytest.mark.parametrize("model,nrand", [("parallel", 1), ("pinhole", 4),
                                         ("thin_lens", 4)])
def test_operator_on_the_card_equals_the_cpu(card, model, nrand):
    g_card = ctc.VoxelGrid.from_bounds(BOX, (16, 16, 16), device=card)
    g_cpu = ctc.VoxelGrid.from_bounds(BOX, (16, 16, 16), device="cpu")
    C_card = _camera().project(g_card, model, nrand, seed=1)
    C_cpu = _camera().project(g_cpu, model, nrand, seed=1)
    assert C_card.nnz == C_cpu.nnz > 0
    np.testing.assert_array_equal(C_card.indptr, C_cpu.indptr)
    np.testing.assert_array_equal(C_card.indices, C_cpu.indices)


@pytest.mark.cuda
@pytest.mark.parametrize("model,nrand", [("parallel", 1), ("pinhole", 3)])
def test_narrow_columns_above_int16_on_the_card_equal_the_cpu(card, model,
                                                              nrand):
    """A 40³ grid (64,000 cells): the card's int16 columns from 32,768 up
    read back as the CPU run's uint16 ones."""
    cam = ctc.camera(np.array([0, 0, 1.0, 1.0]), np.zeros(3), 0.05, 2.8,
                     0.06, np.array([12, 12]), 0.25 / 12)
    p1, p2, pix = cam._make_rays(model, nrand, np.random.default_rng(4))
    out = [ctc.VoxelGrid.from_bounds(BOX, (40, 40, 40), device=dev)
           .trace_csr(p1, p2, pix, 144) for dev in (card, "cpu")]
    np.testing.assert_array_equal(out[0][0], out[1][0])
    np.testing.assert_array_equal(out[0][1], out[1][1])
    cols = out[0][1]
    assert cols.size and (cols >= 2 ** 15).sum() >= cols.size // 4
    assert cols.max() < 64000


@pytest.mark.cuda
def test_trace_csr_makes_one_copy_from_the_device(card):
    grid = ctc.VoxelGrid.from_bounds(BOX, (16, 16, 16), device=card)
    p1, p2, pix = _camera()._make_rays("thin_lens", 4,
                                       np.random.default_rng(2))
    (indptr, cols), n = _dtoh_copies(lambda: grid.trace_csr(p1, p2, pix,
                                                            256))
    assert n == 1 and indptr[-1] == cols.size > 0
    # a budget below nnz: a second, full-size fetch, and the same operator
    (indptr2, cols2), n2 = _dtoh_copies(
        lambda: grid.trace_csr(p1, p2, pix, 256, readback_cap=16))
    assert n2 == 2
    np.testing.assert_array_equal(indptr2, indptr)
    np.testing.assert_array_equal(cols2, cols)


@pytest.mark.cuda
def test_cols_ctc_batch_makes_no_read(card):
    grid = ctc.VoxelGrid.from_bounds(BOX, (12, 12, 12), device=card)
    xyz = grid.cell_centers()
    X = np.stack([np.exp(-np.sum(xyz ** 2, 1) / (2 * (0.05 * a) ** 2))
                  for a in np.linspace(0.3, 1.0, 12)], axis=1)
    cams = [ctc.camera(np.array([0, 0, 1.0, 1.0]), np.zeros(3), 0.05, 2.8,
                       0.06, np.array([12, 12]), 0.25 / 12),
            ctc.camera(np.array([1.0, 0, 0.0, 1.0]),
                       np.array([0.0, -np.pi / 2, 0.0]), 0.05, 2.8, 0.06,
                       np.array([12, 12]), 0.25 / 12)]
    C = ctc.stack_cameras(cams, grid)
    coo = C.tocoo()
    C_t = torch.sparse_coo_tensor(np.vstack([coo.row, coo.col]), coo.data,
                                  size=C.shape, device=card,
                                  dtype=torch.float32, check_invariants=True)
    spr = SPR(X[:, :10].astype(np.float32), 1, xyz, device=card)
    spr.fit(select_modes="number", n_modes=5)
    spr.train(C_t, method="COLS", limits=[[0.0], [1.0]])
    fid = np.zeros(C.shape[0], int)
    s32 = SoftSensor.from_spr(spr, feature_ids=fid, admm_iters=400).warmup()
    s64 = SoftSensor.from_spr(spr, feature_ids=fid, dtype=torch.float64,
                              admm_iters=400)
    frames = torch.as_tensor(np.stack([C @ X[:, j % 12] for j in range(50)]),
                             device=card, dtype=torch.float32)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        f32 = s32.predict_batch(frames)[0]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    f64 = s64.predict_batch(frames.double())[0]
    assert float(f32.min()) >= -1e-4 and float(f32.max()) <= 1.0 + 1e-4
    err = float((f32.double() - f64).abs().max() / (f64.max() - f64.min()))
    assert err <= 2e-3, err


@pytest.mark.cuda
def test_update_basis_on_the_card_agrees_with_float64(card):
    d = make_flame_dataset(n_cells=3000, m_train=20, m_test=3, seed=4)
    out = {}
    for dtype in (np.float32, np.float64):
        spr = SPR(d["X_train"][:, :17].astype(dtype), 9, d["xyz"],
                  device=card)
        spr.fit(select_modes="number", n_modes=10)
        spr.train(spr.optimal_placement())
        (_, n) = _dtoh_copies(lambda: spr.update_basis(
            d["X_train"][:, 17:].astype(dtype), n_modes=11))
        assert n <= 3            # the JAX code reads S, M and R
        out[dtype] = spr
    s32 = out[np.float32].Sigma_r.double()
    s64 = out[np.float64].Sigma_r
    assert float((s32 - s64).abs().max() / s64[0]) <= 1e-3
    # the fp32 update reconstructs every snapshot it holds as float64's
    for spr in out.values():
        assert tuple(spr.Ar.shape) == (20, 11)
        assert torch.allclose(spr.Theta, spr.C @ spr.Ur)
    rec = {k: (m.Ur.double() @ m.Ar.double().T) for k, m in out.items()}
    span = float(rec[np.float64].max() - rec[np.float64].min())
    assert float((rec[np.float32] - rec[np.float64]).abs().max()) \
        <= 1e-3 * span
