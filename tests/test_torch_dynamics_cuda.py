"""The shallow decoder and the temporal layer on the card
(``openmeasure_torch/sensing/decoder.py``, ``dynamics/dmd.py``,
``dynamics/kalman.py`` and the ``DecoderSensor``/``DynamicSensor``
serving): fp32 against float64 on the card, and no read back to the host
in a training run or a serving batch.

Every test here needs a CUDA card and skips without one; this file imports
neither JAX nor the JAX package, so on a machine with a card it runs as::

    python -m pytest tests/test_torch_dynamics_cuda.py --noconftest -q

Bars, ``chip_smoke.py``'s: the fp32 decoder's held-out NRMSE within 10 %
of float64's from the same initial weights (training amplifies round-off
through the ReLU pattern); a served decoder batch against ``predict`` to
1e-5 relative (one MLP forward either way); the fp32 Kalman fields within
1e-3 of the float64 field range (the filter's covariance recursions in
fp32); DMD's dominant eigenvalues within 1e-4 (fp32 Gram-route SVD, then
float64 on the host).
"""

import numpy as np
import pytest
import torch

from openmeasure_torch import DMD, SPR, DecoderSensor, DynamicSensor
from openmeasure_torch import ShallowDecoder
from openmeasure_torch.datasets.synthetic import make_flame_dataset
from openmeasure_torch.sensing import decoder as tdec
from openmeasure_torch.utils.metrics import nrmse


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: this is the card's path")
    return torch.device("cuda")


def _series(n_points=5000, m=100, seed=0):
    """The time series of ``docs/examples/dynamics_example.py`` at a
    smaller width: three damped rotations lifted to 2 features."""
    rng = np.random.default_rng(seed)
    n = 2 * n_points
    L, _ = np.linalg.qr(rng.standard_normal((n, 6)))
    L *= np.array([[3.0, 3.0, 1.5, 1.5, 0.8, 0.8]])
    A_z = np.zeros((6, 6))
    for j, (th, rho) in enumerate(((0.35, 0.998), (0.12, 0.995),
                                   (0.58, 0.99))):
        A_z[2 * j:2 * j + 2, 2 * j:2 * j + 2] = rho * np.array(
            [[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    z = rng.standard_normal(6)
    Z = []
    for _ in range(m):
        Z.append(z)
        z = A_z @ z + 0.02 * rng.standard_normal(6)
    X = L @ np.array(Z).T + 5.0
    return X[:, :60], X[:, 60:], rng.standard_normal((n_points, 3))


def _no_sync(fn):
    """Run ``fn`` with torch's sync debug mode set to raise."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out


@pytest.mark.cuda
def test_decoder_trains_without_host_reads_fp32_near_float64(card):
    d = make_flame_dataset(n_cells=2000, m_train=20, m_test=3,
                           dtype=np.float64, seed=3)
    spr = SPR(d["X_train"].astype(np.float32), 9, d["xyz"], device=card)
    spr.fit(select_modes="number", n_modes=10)
    C = spr.optimal_placement()
    rows = C.argmax(dim=1).cpu().numpy()
    ys = []
    for j in range(d["X_test"].shape[1]):
        y = np.zeros((10, 3))
        y[:, 0] = d["X_test"][rows, j]
        y[:, 2] = rows // 2000
        ys.append(y)
    truth = torch.as_tensor(d["X_test"], device=card)
    p0 = tdec.init_params((10, 40, 45, C.shape[1]), 0, torch.float64, card)
    nr, decs = {}, {}
    for dtype, np_dtype in ((torch.float32, np.float32),
                            (torch.float64, np.float64)):
        dec = ShallowDecoder(d["X_train"].astype(np_dtype), 9, d["xyz"],
                             hidden=(40, 45), device=card)
        dec.fit(C.to(dtype), epochs=300, lr=3e-3, params0=p0)
        nr[dtype] = float(nrmse(dec.predict(ys).double(), truth))
        decs[dtype] = dec
    assert abs(nr[torch.float32] - nr[torch.float64]) \
        <= 0.10 * nr[torch.float64], nr
    # the trainer alone, under sync debug mode set to raise
    X0 = torch.as_tensor(d["X_train"], device=card, dtype=torch.float32)
    Y0 = X0[torch.as_tensor(rows, device=card)]
    p32 = [(W.float(), b.float()) for W, b in p0]
    _no_sync(lambda: tdec._train(Y0.T, X0.T, p32, 20, 3e-3, 1e-6))
    dec = decs[torch.float32]
    sensor = DecoderSensor.from_decoder(dec).warmup()
    Y = torch.as_tensor(np.stack([y[:, 0] for y in ys]), device=card,
                        dtype=torch.float32)
    fields = _no_sync(lambda: sensor.predict_batch(Y))
    x = dec.predict(ys)
    err = float((fields.T - x).abs().max() / x.abs().max())
    assert err <= 1e-5, err


@pytest.mark.cuda
def test_dmd_dominant_eigenvalues_fp32_against_float64(card):
    X_train, _, xyz = _series()
    eigs = {}
    for dtype in (np.float32, np.float64):
        dmd = DMD(X_train.astype(dtype), 2, xyz, device=card)
        dmd.fit(dt=1.0, select_modes="number", n_modes=6)
        top = np.argsort(-np.abs(dmd.amplitudes))[:6]
        eigs[dtype] = np.sort_complex(dmd.eigs[top])
    assert np.max(np.abs(eigs[np.float32] - eigs[np.float64])) <= 1e-4


@pytest.mark.cuda
def test_kalman_serving_reads_nothing_fp32_near_float64(card):
    X_train, X_test, xyz = _series()
    spr = SPR(X_train.astype(np.float32), 2, xyz, device=card)
    spr.fit(select_modes="number", n_modes=6)
    C = spr.optimal_placement()
    spr.train(C)
    rows = C.argmax(dim=1).cpu().numpy()
    Yc = X_test[rows].T
    sigma = 0.5 * np.std(Yc, axis=0)
    Y = Yc + np.random.default_rng(1).standard_normal(Yc.shape) * sigma
    Yt = torch.as_tensor(Y, device=card, dtype=torch.float32)
    St = torch.as_tensor(np.broadcast_to(sigma, Y.shape).copy(),
                         device=card, dtype=torch.float32)
    s32 = DynamicSensor.from_spr(spr, gate=5.0).warmup(batch=len(Y))
    s64 = DynamicSensor.from_spr(spr, dtype=torch.float64, gate=5.0)
    rng_field = float(X_test.max() - X_test.min())
    for method in ("filter_batch", "smooth_batch"):
        x32 = _no_sync(lambda: getattr(s32, method)(Yt, St))[0]
        x64 = getattr(s64, method)(Yt.double(), St.double())[0]
        err = float((x32.double() - x64).abs().max()) / rng_field
        assert err <= 1e-3, (method, err)
    _no_sync(lambda: s32.step(Yt[0], St[0]))
    _no_sync(lambda: s32.forecast(5, from_carry=True))
