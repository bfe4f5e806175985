"""The sharded paths on the card, on a world of one with NCCL: each
sharded entry point ``torch.equal`` to the same call with no mesh, and
through the kernels (``csrc/qrcp.cu`` for the QR placement, ``csrc/chol.cu``
in the GP trainer).  Phase 26(a) of ``chip_smoke.py`` at a small size.

Every test here needs a CUDA card and skips without one; this file imports
neither JAX nor the JAX package, so on a machine with a card it runs as::

    python -m pytest tests/test_torch_parallel_cuda.py --noconftest -q

Bars: EQUAL — an axis of one rank issues no collective and runs the
unsharded operations.
"""

import numpy as np
import pytest
import torch

from openmeasure_torch.datasets.synthetic import make_flame_dataset


@pytest.fixture(scope="module")
def mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the NCCL mesh and the kernels run "
                    "there")
    from openmeasure_torch.parallel.harness import local_world
    with local_world("cuda") as m:
        yield m


@pytest.fixture(scope="module")
def data():
    return make_flame_dataset(n_cells=3000, n_features=9, m_train=20,
                              m_test=2, seed=4, dtype=np.float32)


def _equal(a, b):
    return all(bool(torch.equal(x, y)) for x, y in zip(a, b))


@pytest.mark.cuda
def test_world_of_one_is_nccl_on_the_card(mesh):
    import torch.distributed as dist
    assert mesh.device_type == "cuda"
    assert dist.get_backend() == "nccl"


@pytest.mark.cuda
def test_sharded_spr_step_equal_and_through_the_kernel(mesh, data):
    from openmeasure_torch.linalg import qrcp_cuda
    from openmeasure_torch.parallel import sharded as S
    Xb, Xtb = (S.shard_snapshots(data[k], 9, mesh)
               for k in ("X_train", "X_test"))
    qrcp_cuda.qrcp_pivots_cuda.launches = 0
    got = S.sharded_spr_step(Xb, Xtb, 8, mesh=mesh)
    assert qrcp_cuda.qrcp_pivots_cuda.launches == 1
    assert _equal(got, S.sharded_spr_step(Xb, Xtb, 8))
    lo = data["X_train"].reshape(9, 3000, -1).min(axis=(1, 2)) - 1.0
    hi = data["X_train"].reshape(9, 3000, -1).max(axis=(1, 2)) + 1.0
    c1 = S.sharded_spr_cols_step(Xb, Xtb, 8, lo, hi, max_iter=200, mesh=mesh)
    c0 = S.sharded_spr_cols_step(Xb, Xtb, 8, lo, hi, max_iter=200)
    assert _equal(c1[:3], c0[:3]) and _equal(c1[3], c0[3])


@pytest.mark.cuda
def test_sharded_gpr_train_equal_and_through_the_kernel(mesh, data):
    from openmeasure_torch.gp import exact_gp as E
    from openmeasure_torch.linalg import chol_cuda
    from openmeasure_torch.parallel import sharded as S
    g = torch.Generator().manual_seed(0)
    P0 = torch.randn((20, 3), generator=g).cuda()
    Vr = torch.sin(torch.randn((20, 4), generator=g)).cuda()
    chol_cuda.chol_inv_logdet_cuda.launches = 0
    res = S.sharded_gpr_train(mesh, P0, Vr, max_iter=60)
    assert chol_cuda.chol_inv_logdet_cuda.launches >= 1
    mean, kern, lik = S._specs()
    Y = Vr.T.contiguous()
    ref = E.adam_early_stop(
        E.make_single_task_loss(mean, kern, lik, P0, Y),
        S.init_mode_stacked_params(4, 3, torch.float32, "cuda"), lr=0.1,
        max_iter=60, rel_error=1e-5,
        value_and_grad=E.make_single_task_value_and_grad(mean, kern, lik,
                                                         P0, Y))
    assert torch.equal(res.loss, ref.loss)
    assert torch.equal(res.iterations, ref.iterations)


@pytest.mark.cuda
@pytest.mark.parametrize("rho", ["adaptive", "fixed"])
def test_sharded_softsensor_equal_with_no_host_read(mesh, data, rho):
    from openmeasure_torch import SPR, SoftSensor
    spr = SPR(data["X_train"], 9, data["xyz"], device="cuda")
    spr.fit(select_modes="number", n_modes=8)
    C = spr.optimal_placement()
    Xb = data["X_train"].reshape(9, 3000, -1)
    spr.train(C, method="COLS", limits=[Xb.min(axis=(1, 2)) - 0.1,
                                        Xb.max(axis=(1, 2)) + 0.1])
    sensor = SoftSensor.from_spr(spr, admm_iters=50, admm_rho=rho).warmup()
    ssen = sensor.shard(mesh)
    rows = C.argmax(dim=1).cpu().numpy()
    Y = torch.as_tensor(np.tile(data["X_test"][rows].T, (5, 1)),
                        device="cuda")
    ssen.predict_batch(Y)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ssen.predict_batch(Y)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert _equal(got, sensor.predict_batch(Y))


@pytest.mark.cuda
def test_sharded_mfk_equal(mesh):
    from openmeasure_torch.parallel import sharded as S
    from openmeasure_torch.pipelines import mfk_end_to_end
    rng = np.random.default_rng(4)
    X_lf = rng.random((20, 2)).astype(np.float32)
    X_hf = X_lf[::3]
    Y_hf = np.stack([np.sin(3 * X_hf[:, 0] + k) for k in range(4)])
    Y_lf = np.stack([0.7 * np.sin(3 * X_lf[:, 0] + k) for k in range(4)])
    X_t = rng.random((5, 2)).astype(np.float32)
    args = (X_lf, Y_lf.astype(np.float32), X_hf, Y_hf.astype(np.float32),
            X_t)
    assert _equal(S.sharded_mfk_end_to_end(mesh, *args),
                  mfk_end_to_end(*args, device="cuda"))
