"""The batched SPD inverse + logdet CUDA kernel (``openmeasure_torch/
csrc/chol.cu``) against its plain versions on the card.

Every test here needs a CUDA card and skips without one; this file imports
neither JAX nor the JAX package, so on a machine with a card it runs as::

    python -m pytest tests/test_torch_chol_cuda.py --noconftest -q

Tolerances (fp32): against the Cholesky formulation (another algorithm)
K⁻¹ within 5e-6 of max|K⁻¹| and logdet within 5e-3 absolute — the TPU
kernel's bars (``tests/test_tpu_kernels.py``); against
``chol_inv_logdet_plain`` EQUAL, bit for bit: the plain version runs the
kernel's fp32 operations in the kernel's order, its Gram included (a
fixed-order sequential sum), each separately rounded.  On matrices built
like the GP trainer's, too ill-conditioned for the fixed bars, the kernel
is held against a float64 Cholesky within p · cond₂(K) · u.  The GP
trainer's iteration, replayed from a CUDA graph on the card, is held bit
for bit to the same iterations run as plain launches.
"""

import numpy as np
import pytest
import torch

from openmeasure_torch.linalg import chol as TC
from openmeasure_torch.linalg import chol_cuda as TCC
from openmeasure_torch.utils import logging as L

KINV_REL, LOGDET_ABS = 5e-6, 5e-3


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


def _equal(got, want):
    (kg, lg), (kw, lw) = got, want
    assert torch.equal(kg, kw), float(torch.max(torch.abs(kg - kw)))
    assert torch.equal(lg, lw), float(torch.max(torch.abs(lg - lw)))


def _kernel_vs_plain_versions(K):
    B, p, _ = K.shape
    with L.recording() as rec:
        got = TCC.chol_inv_logdet_cuda(K)
    torch.cuda.synchronize()
    assert rec.counters == {"chol.kernel_launches": 1}
    assert got[0].shape == (B, p, p) and got[1].shape == (B,)
    _equal(got, TC.chol_inv_logdet_plain(K))
    _close(got, TC.chol_inv_logdet_torch(K), KINV_REL, LOGDET_ABS)


@pytest.mark.cuda
@pytest.mark.parametrize("B,p", [(14, 41), (3, 17), (30, 64), (2, 128),
                                 (5, 1), (1, 100)])
def test_kernel_matches_both_plain_versions(card, B, p):
    _kernel_vs_plain_versions(_spd(B, p, seed=p, device=card))


@pytest.mark.cuda
def test_kernel_on_gp_trainer_matrices(card):
    """A (14, 41, 41) batch built as the GP trainer builds it: a scaled
    Matérn-2.5 kernel of 41 three-parameter points, one lengthscale and
    outputscale per mode, plus the likelihood's noise in the range training
    reaches (its floor 1e-4 up to 1e-2) and the fp32 jitter.  Such matrices
    are too ill-conditioned for the fixed fp32 bars, so the kernel is held
    EQUAL to its plain version and, per matrix, within p · cond₂(K) · u of
    a float64 Cholesky of the same fp32 matrix (K⁻¹ relative to max|K⁻¹|,
    logdet absolute; u the fp32 unit round-off)."""
    from openmeasure_torch.gp import exact_gp
    from openmeasure_torch.gp.kernels import MaternKernel, ScaleKernel
    rng = np.random.default_rng(16)
    P = torch.as_tensor(rng.uniform(0.0, 1.0, (41, 3)), dtype=torch.float32,
                        device=card)
    par = {"raw_outputscale": torch.as_tensor(
               rng.uniform(-1.0, 1.0, 14), dtype=torch.float32, device=card),
           "base": {"raw_lengthscale": torch.as_tensor(
               rng.uniform(-2.0, 0.0, (14, 1)), dtype=torch.float32,
               device=card)}}
    noise = torch.as_tensor(10.0 ** rng.uniform(-4.0, -2.0, 14),
                            dtype=torch.float32, device=card)
    Kn = exact_gp._add_noise(ScaleKernel(MaternKernel(2.5))(par, P, P), noise)
    K = (Kn + exact_gp._jitter(Kn.dtype) * torch.eye(41, device=card)
         ).contiguous()
    assert K.shape == (14, 41, 41)
    got = TCC.chol_inv_logdet_cuda(K)
    _equal(got, TC.chol_inv_logdet_plain(K))
    K64 = K.double()
    L64 = torch.linalg.cholesky(K64)
    kinv64 = torch.cholesky_inverse(L64)
    ld64 = 2.0 * torch.log(torch.diagonal(L64, dim1=-2, dim2=-1)).sum(-1)
    bar = 41 * torch.linalg.cond(K64) * 2.0 ** -24
    assert float(bar.max()) > 5e-6     # beyond the fixed bars' reach
    rel = ((got[0].double() - kinv64).abs().amax((-2, -1))
           / kinv64.abs().amax((-2, -1)))
    assert bool((rel <= bar).all()), (rel / bar).max()
    assert bool(((got[1].double() - ld64).abs() <= bar).all())


@pytest.mark.cuda
def test_one_call_is_one_kernel(card):
    """One chol_inv_logdet_cuda call runs exactly one kernel on the card.
    The trace can miss the first device events it records, so a few
    fills of a marker run first, and fills are left out of the count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    K = _spd(14, 41, seed=17, device=card)
    TCC.chol_inv_logdet_cuda(K)
    marker = torch.empty(1, device=card)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(8):
            marker.fill_(1.0)
        torch.cuda.synchronize()
        TCC.chol_inv_logdet_cuda(K)
        torch.cuda.synchronize()
        marker.fill_(2.0)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and "memcpy" not in e.name.lower()
               and "memset" not in e.name.lower()
               and "Fill" not in e.name]
    assert len(kernels) == 1 and "chol" in kernels[0], kernels


@pytest.mark.cuda
def test_phase_stamps_build(card):
    """The -DCHOL_STAMPS build (``profile_torch.py chol`` splits a launch's
    cycles by phase with it) builds and launches; its outputs equal the
    shipped kernel's bit for bit, each block's six stamps never decrease,
    and the launch is not counted."""
    K = _spd(3, 41, seed=19, device=card)
    with L.recording() as rec:
        kinv, ld, st = TCC.chol_phase_stamps(K)
    torch.cuda.synchronize()
    assert "chol.kernel_launches" not in rec.counters
    _equal((kinv, ld), TCC.chol_inv_logdet_cuda(K))
    st = st.cpu()
    assert st.shape == (3, 6, 2)
    assert bool((st[:, 1:] >= st[:, :-1]).all())
    assert bool((st[:, -1] > st[:, 0]).all())


@pytest.mark.cuda
def test_auto_and_autograd_go_through_the_kernel(card):
    """A CUDA fp32 stack with p ≤ 128 launches once for all its leading
    dims; float64 or p > 128 takes the Cholesky formulation on the card;
    the autograd Function's forward is one launch."""
    K = _spd(6, 20, seed=1, device=card).reshape(2, 3, 20, 20)
    with L.recording() as rec:
        kinv, ld = TC.chol_inv_logdet_auto(K)
        assert rec.counters["chol.kernel_launches"] == 1
        assert kinv.shape == (2, 3, 20, 20) and ld.shape == (2, 3)
        TC.chol_inv_logdet_auto(K.double())
        TC.chol_inv_logdet_auto(_spd(1, 130, seed=2, device=card))
        assert rec.counters["chol.kernel_launches"] == 1
        Kg = K.clone().requires_grad_(True)
        kinv, ld = TC.chol_inv_logdet(Kg)
        (g,) = torch.autograd.grad(ld.sum(), Kg)
    assert rec.counters["chol.kernel_launches"] == 2
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
    with L.recording() as rec:
        res = gpr_end_to_end(d["X_train"], d["P_train"], d["P_test"],
                             d["X_test"], n_features=3, r=6, max_iter=200)
    torch.cuda.synchronize()
    assert rec.counters["chol.kernel_launches"] > 0
    assert res.X_rec.device.type == "cuda"
    d64 = make_flame_dataset(n_cells=2000, n_features=3, m_train=20,
                             m_test=3, dtype=np.float64)
    ref = gpr_end_to_end(d64["X_train"], d64["P_train"], d64["P_test"],
                         d64["X_test"], n_features=3, r=6, max_iter=200)
    assert abs(float(res.nrmse) - float(ref.nrmse)) <= 0.1 * float(ref.nrmse)
    g = GPR(d["X_train"], 3, d["xyz"], d["P_train"], "MultiTask")
    g.fit(select_modes="number", n_modes=6)
    with L.recording() as rec:
        g.train(max_iter=50)
    a, s = g.predict(d["P_test"])
    assert rec.counters["chol.kernel_launches"] > 0
    assert bool(torch.isfinite(g.reconstruct(a)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("gpr_type,mean", [
    pytest.param("SingleTask", "LinearMean", id="SingleTask"),
    pytest.param("MultiTask", None, id="MultiTask"),
    pytest.param("SingleTask", "ConstantMean", id="SingleTask-fused")])
def test_trainer_graph_replays_the_eager_step(card, monkeypatch, gpr_type,
                                              mean):
    """On the card the Adam loop replays each block of 4 iterations as a
    CUDA graph after a first eager block: the trained state equals, bit
    for bit, the same iterations run eagerly (each replay's block run as
    plain launches), and the recorder counts the replays' launches of
    ``csrc/chol.cu``, one an iteration, with the block enqueued before
    the host read the stop of the last one (or none more, where the copy
    of the flags read a flag that block had already turned on).  A
    LinearMean and the MultiTask model keep the oracle's step; a
    ConstantMean takes the fused step of ``csrc/gp_step.cu``, which
    launches once more than there are iterations (the first build)."""
    from openmeasure_torch import GPR
    from openmeasure_torch.datasets.synthetic import make_flame_dataset
    from openmeasure_torch.gp import exact_gp as E
    from openmeasure_torch.gp import kernels as GK

    class Eager:
        def __init__(self, block):
            self.step = block

    d = make_flame_dataset(n_cells=2000, n_features=3, m_train=20, m_test=3,
                           dtype=np.float32)

    def trained():
        g = GPR(d["X_train"], 3, d["xyz"], d["P_train"], gpr_type)
        g.fit(select_modes="number", n_modes=6)
        with L.recording() as rec:
            g.train(max_iter=203,
                    mean=None if mean is None else getattr(GK, mean)())
        torch.cuda.synchronize()
        return g, rec.counters

    g_graph, counted = trained()
    monkeypatch.setattr(E, "_Replay", Eager)
    g_eager, counted_eager = trained()
    for a, b in zip(E.tree_leaves(g_graph.params),
                    E.tree_leaves(g_eager.params)):
        assert torch.equal(a, b)
    assert torch.equal(g_graph._final_loss, g_eager._final_loss)
    assert torch.equal(g_graph._iterations, g_eager._iterations)
    blockwise = min(-(-int(g_graph._iterations.max()) // 4) * 4, 203)
    fused = mean == "ConstantMean"
    for c in (counted, counted_eager):
        steps = c["chol.kernel_launches"]
        assert steps in (blockwise, min(blockwise + 4, 203))
        assert c.get("gp.fused_iters", 0) == (steps if fused else 0)
        assert c.get("gp_step.kernel_launches", 0) == \
            (steps + 1 if fused else 0)
