"""The out-of-core tier on the card: the device engine's uploads from the
ring of pinned host buffers, the host engine's one (n, r) upload, and a
checkpoint loaded back onto the card.

Every test here needs a CUDA card and skips without one; this file imports
neither JAX nor the JAX package, so on a machine with a card it runs as::

    python -m pytest tests/test_torch_streaming_cuda.py --noconftest -q

Bars: the device engine on the card against the same engine on the CPU in
float64 — it runs the same passes, so the factors agree to 1e-10 relative
(σ) and |cos| ≥ 1 − 1e-10 per mode, with chunks small enough that the ring
of pinned buffers is reused many times (a chunk overwritten while still in
flight would show here); the host engine on the card EQUAL to the host
engine on the CPU (the same host float64 arithmetic, then one upload); a
loaded checkpoint's sensor EQUAL to the one built in memory.
"""

import numpy as np
import pytest
import torch

from openmeasure_torch import SoftSensor, StreamingSPR
from openmeasure_torch.datasets.synthetic import make_flame_dataset
from openmeasure_torch.utils.checkpoint import load_model, save_model


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the uploads and the fit run there")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def data():
    return make_flame_dataset(n_cells=4000, n_features=9, m_train=24,
                              m_test=2, seed=3)


def _cos(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return torch.abs((a * b).sum(0)) / (a.norm(dim=0) * b.norm(dim=0))


@pytest.mark.cuda
@pytest.mark.parametrize("prefetch", [0, 2])
def test_device_engine_ring_matches_the_cpu(card, data, tmp_path, prefetch):
    path = str(tmp_path / "X.npy")
    np.save(path, data["X_train"])
    fits = {}
    for dev in ("cpu", card):
        s = StreamingSPR(path, 9, data["xyz"], chunk_rows=997,
                         dtype=np.float64, prefetch=prefetch, device=dev)
        s.fit(select_modes="number", n_modes=10, engine="device")
        fits[str(dev)] = s
    c, g = fits["cpu"], fits[str(card)]
    assert g.Ur.device.type == "cuda"
    n_chunks = -(-data["X_train"].shape[0] // 997)
    # one Gram read a chunk per pass (2 refine passes on the CPU's rule:
    # the card's is 1), then the norms and signs
    assert g.device_reads_ == n_chunks * 2 + 1
    assert g.bytes_uploaded_ >= 2 * data["X_train"].nbytes
    sig = (g.Sigma_r.cpu() - c.Sigma_r).abs().max() / c.Sigma_r.abs().max()
    assert float(sig) <= 1e-10
    assert bool((_cos(g.Ur, c.Ur) >= 1 - 1e-10).all())


@pytest.mark.cuda
def test_host_engine_uploads_once_and_equals_the_cpu(card, data):
    fits = {}
    for dev in ("cpu", card):
        s = StreamingSPR(data["X_train"], 9, data["xyz"], chunk_rows=1501,
                         device=dev)
        s.fit(select_modes="number", n_modes=10)
        fits[str(dev)] = s
    c, g = fits["cpu"], fits[str(card)]
    assert g.device_reads_ == 0 and c.bytes_uploaded_ == 0
    assert g.bytes_uploaded_ >= g.Ur.numel() * 4
    for a in ("Ur", "Sigma_r", "Ar", "X_cnt", "X_scl"):
        assert torch.equal(getattr(g, a).cpu(), getattr(c, a)), a


@pytest.mark.cuda
def test_checkpoint_sensor_on_the_card(card, data, tmp_path):
    s = StreamingSPR(data["X_train"], 9, data["xyz"], device=card)
    s.fit(select_modes="number", n_modes=8)
    C = s.optimal_placement()
    s.train(C)
    path = str(tmp_path / "spr.npz")
    save_model(s, path)
    back = load_model(path)
    assert back.Ur.device.type == "cuda"
    rows = C.argmax(dim=1).cpu().numpy()
    Y = np.stack([data["X_test"][rows, j % 2] for j in range(50)])
    got = SoftSensor.load(path).predict_batch(Y)[0]
    want = SoftSensor.from_spr(s).predict_batch(Y)[0]
    assert torch.equal(got, want)
