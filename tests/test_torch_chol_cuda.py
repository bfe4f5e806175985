"""The batched SPD inverse + logdet CUDA kernel (``openmeasure_torch/
csrc/chol.cu``) against its plain versions on the card.

Every test here needs a CUDA card and skips without one; this file imports
neither JAX nor the JAX package, so on a machine with a card it runs as::

    python -m pytest tests/test_torch_chol_cuda.py --noconftest -q

Tolerances (fp32): against the Cholesky formulation (another algorithm)
K⁻¹ within 5e-6 of max|K⁻¹| and logdet within 5e-3 absolute — the TPU
kernel's bars (``tests/test_tpu_kernels.py``); against
``chol_inv_logdet_plain`` (the same fp32 operations in the same order, but
the Gram's sums) tightened to 1e-6 and 1e-5, five times what the card
showed on its first run (K⁻¹ ≤ 1.8e-7 of max, logdet equal).
"""

import numpy as np
import pytest
import torch

from openmeasure_torch.linalg import chol as TC
from openmeasure_torch.linalg import chol_cuda as TCC

KINV_REL, LOGDET_ABS = 5e-6, 5e-3
PLAIN_KINV_REL, PLAIN_LOGDET_ABS = 1e-6, 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _spd(B, p, seed, device):
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((B, p, p))
    K = np.einsum("bij,bkj->bik", Q, Q) / p + 0.5 * np.eye(p)[None]
    K = (K + np.swapaxes(K, 1, 2)) / 2
    return torch.as_tensor(K, dtype=torch.float32, device=device)


def _close(got, want, kinv_rel, logdet_abs):
    (kg, lg), (kw, lw) = got, want
    scale = float(torch.max(torch.abs(kw)))
    assert float(torch.max(torch.abs(kg - kw))) <= kinv_rel * scale
    assert float(torch.max(torch.abs(lg - lw))) <= logdet_abs


@pytest.mark.cuda
@pytest.mark.parametrize("B,p", [(14, 41), (3, 17), (30, 64), (2, 128),
                                 (5, 1), (1, 100)])
def test_kernel_matches_both_plain_versions(card, B, p):
    K = _spd(B, p, seed=p, device=card)
    before = TCC.chol_inv_logdet_cuda.launches
    got = TCC.chol_inv_logdet_cuda(K)
    torch.cuda.synchronize()
    assert TCC.chol_inv_logdet_cuda.launches == before + 1
    assert got[0].shape == (B, p, p) and got[1].shape == (B,)
    _close(got, TC.chol_inv_logdet_plain(K), PLAIN_KINV_REL,
           PLAIN_LOGDET_ABS)
    _close(got, TC.chol_inv_logdet_torch(K), KINV_REL, LOGDET_ABS)


@pytest.mark.cuda
def test_auto_and_autograd_go_through_the_kernel(card):
    """A CUDA fp32 stack with p ≤ 128 launches once for all its leading
    dims; float64 or p > 128 takes the Cholesky formulation on the card;
    the autograd Function's forward is one launch."""
    K = _spd(6, 20, seed=1, device=card).reshape(2, 3, 20, 20)
    before = TCC.chol_inv_logdet_cuda.launches
    kinv, ld = TC.chol_inv_logdet_auto(K)
    assert TCC.chol_inv_logdet_cuda.launches == before + 1
    assert kinv.shape == (2, 3, 20, 20) and ld.shape == (2, 3)
    TC.chol_inv_logdet_auto(K.double())
    TC.chol_inv_logdet_auto(_spd(1, 130, seed=2, device=card))
    assert TCC.chol_inv_logdet_cuda.launches == before + 1
    Kg = K.clone().requires_grad_(True)
    kinv, ld = TC.chol_inv_logdet(Kg)
    (g,) = torch.autograd.grad(ld.sum(), Kg)
    assert TCC.chol_inv_logdet_cuda.launches == before + 2
    assert float(torch.max(torch.abs(g - kinv.detach()))) == 0.0


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    K = _spd(2, 8, seed=3, device=card)
    with pytest.raises(ValueError, match="float32"):
        TCC.chol_inv_logdet_cuda(K.double())
    with pytest.raises(ValueError, match="p <="):
        TCC.chol_inv_logdet_cuda(_spd(1, 129, seed=4, device=card))
    with pytest.raises(ValueError, match="B, p, p"):
        TCC.chol_inv_logdet_cuda(K[0])
    with pytest.raises(ValueError, match="CUDA tensor"):
        TCC.chol_inv_logdet_cuda(K.cpu())


@pytest.mark.cuda
def test_gp_paths_on_card_go_through_the_kernel(card):
    """gpr_end_to_end and the class flow launch the kernel; their fp32
    reconstruction is close to the float64 run of the same data."""
    from openmeasure_torch import GPR
    from openmeasure_torch.datasets.synthetic import make_flame_dataset
    from openmeasure_torch.pipelines import gpr_end_to_end
    d = make_flame_dataset(n_cells=2000, n_features=3, m_train=20, m_test=3,
                           dtype=np.float32)
    before = TCC.chol_inv_logdet_cuda.launches
    res = gpr_end_to_end(d["X_train"], d["P_train"], d["P_test"],
                         d["X_test"], n_features=3, r=6, max_iter=200)
    torch.cuda.synchronize()
    assert TCC.chol_inv_logdet_cuda.launches > before
    assert res.X_rec.device.type == "cuda"
    d64 = make_flame_dataset(n_cells=2000, n_features=3, m_train=20,
                             m_test=3, dtype=np.float64)
    ref = gpr_end_to_end(d64["X_train"], d64["P_train"], d64["P_test"],
                         d64["X_test"], n_features=3, r=6, max_iter=200)
    assert abs(float(res.nrmse) - float(ref.nrmse)) <= 0.1 * float(ref.nrmse)
    before = TCC.chol_inv_logdet_cuda.launches
    g = GPR(d["X_train"], 3, d["xyz"], d["P_train"], "MultiTask")
    g.fit(select_modes="number", n_modes=6)
    g.train(max_iter=50)
    a, s = g.predict(d["P_test"])
    assert TCC.chol_inv_logdet_cuda.launches > before
    assert bool(torch.isfinite(g.reconstruct(a)).all())
