"""The fixed-budget ADMM's kernel pair (``csrc/admm.cu`` through
``openmeasure_torch/linalg/admm_cuda.py``) on the card: against the loop
of ``linalg/boxls.py``, its plain version, at the serving batch's shape
(b = 50 frames, n = 165,258 rows, r = 14), with shared and per-frame
bounds, and at ragged ones (row counts off the copies' 16-byte grain,
frame counts that split strips or that no warp count divides, the 3D
rows); each case twice, for the same bits; the
recorder's ``admm.kernel_launches`` and ``boxls.kernel_solves``; a solve
with no host read;
the same bits for the same batch; a solve on a card other than the
current one.

Every test here needs a CUDA card and skips without one; this file
imports neither JAX nor the JAX package, so on a machine with a card it
runs as::

    python -m pytest tests/test_torch_admm_cuda.py --noconftest -q

Tolerance: the kernels and the fp32 loop are two fp32 evaluations of one
iteration with their sums in other orders; the kernels are held to the
float64 loop on the card by the fp32 loop's own distance from it, twice
over, plus 100 u of max|g| (u = 2⁻²⁴).
"""

import pytest
import torch

from openmeasure_torch.linalg import admm_cuda as K
from openmeasure_torch.linalg import boxls as T
from openmeasure_torch.utils import logging as L

U = 2.0 ** -24


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ADMM kernels run only there")
    return torch.device("cuda")


def _problem(dev, seed, b, r, n, batched_bounds=False):
    """A COLS problem in float64 on the card: weighted Hessians of r + 4
    sensor rows of an orthonormal (n, r) operator, a box that binds."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev,
                           dtype=torch.float64)
    A, _ = torch.linalg.qr(rnd(n, r))
    rows = torch.randperm(n, generator=torch.Generator().manual_seed(seed))
    Theta = A[rows[:r + 4].to(dev)]
    Y = Theta @ rnd(r, b) * 1.5 + 0.01 * rnd(r + 4, b)
    W = torch.rand(b, r + 4, generator=gen, device=dev,
                   dtype=torch.float64) + 0.5
    box = 1.5 * float(A.abs().max()) / 2
    lo = torch.full((n,), -box, dtype=torch.float64, device=dev)
    hi = -lo
    if batched_bounds:
        lo = lo - 0.1 * box * torch.rand(b, n, generator=gen, device=dev,
                                         dtype=torch.float64)
        hi = hi + 0.1 * box * torch.rand(b, n, generator=gen, device=dev,
                                         dtype=torch.float64)
    Wt = Theta * W[..., :, None]
    H = Wt.mT @ Wt
    c = (Wt.mT @ (Y.T * W)[..., None])[..., 0]
    return H, c, A, lo, hi, A.T @ A


def _solve(P, adapt, iters, how):
    H, c, A, lo, hi, AtA = P
    op = T._Operator(A)
    if how == "loop":
        return T._admm(H, c, op, lo, hi, AtA, None, iters, 0.0, 1.6, adapt,
                       True)
    return T._admm_kernels(H, c, op, lo, hi, AtA, None, iters, 1.6, adapt,
                           True)


SHAPES = [
    # (b, n, r, batched bounds)
    (50, 165258, 14, False),        # the serving batch
    (7, 1001, 5, True),             # ragged last block, per-frame bounds
    (1, 33, 1, False),
    (13, 5003, 32, False),
    (20, 40000, 9, True),
    (33, 40001, 14, False),         # n = 1 mod 4: a padded last tile
    (4, 1723599, 14, True),         # n = 3 mod 4, 3D rows: 6 waves of strips
    (17, 20011, 14, False),         # 17 frames: no consumer-warp count divides
    (50, 165258, 14, True),         # per-frame bounds at the serving shape
]


@pytest.mark.cuda
@pytest.mark.parametrize("adapt", [True, False])
@pytest.mark.parametrize("b,n,r,batched", SHAPES)
def test_kernels_against_plain_and_loop(card, adapt, b, n, r, batched):
    iters = 300 if n > 100000 else 200
    P64 = _problem(card, 1000 + b + r, b, r, n, batched)
    P32 = [x.float() for x in P64]
    g64, _ = _solve(P64, adapt, iters, "loop")
    g32, i32 = _solve(P32, adapt, iters, "loop")
    gk, ik = _solve(P32, adapt, iters, "kernel")
    again, _ = _solve(P32, adapt, iters, "kernel")
    assert torch.equal(gk, again)                  # the same bits twice
    scale = float(g64.abs().max())
    bound = 2.0 * float((g32.double() - g64).abs().max()) + 100 * U * scale
    assert float((gk.double() - g64).abs().max()) <= bound
    assert torch.equal(ik.iterations, i32.iterations)
    assert bool(torch.isfinite(gk).all())
    if adapt:
        assert bool(torch.isfinite(ik.primal_residual).all())
        assert bool(torch.isfinite(ik.dual_residual).all())
    else:
        assert bool(torch.isnan(ik.dual_residual).all())


@pytest.mark.cuda
def test_frozen_frame(card):
    """A frame with c = 0 stops at the first iteration with both residuals
    exactly 0 and stays there, as in the loop."""
    P = [x.float() for x in _problem(card, 7, 9, 12, 3000)]
    P[1][4] = 0.0
    g, info = _solve(P, True, 100, "kernel")
    gl, il = _solve(P, True, 100, "loop")
    assert info.iterations.tolist() == [100] * 4 + [1] + [100] * 4
    assert torch.equal(info.iterations, il.iterations)
    assert float(info.primal_residual[4]) == 0.0 == float(
        info.dual_residual[4])
    assert torch.equal(g[4], torch.zeros_like(g[4]))


@pytest.mark.cuda
@pytest.mark.parametrize("adapt", [True, False])
def test_launches_and_kernel_solves(card, adapt):
    """Two launches an iteration, and the recorder counts the solve as the
    kernels'; one ``boxls.iter`` span an iteration."""
    H, c, A, lo, hi, AtA = (x.float() for x in _problem(card, 3, 50, 14,
                                                          20000))
    with L.recording() as rec:
        g, _ = T.admm_box_qp(H, c, A, lo, hi, AtA=AtA, max_iter=77, tol=0.0,
                             adapt_rho=adapt)
    torch.cuda.synchronize()
    assert rec.counters.get("admm.kernel_launches") == 2 * 77
    assert rec.counters.get("boxls.kernel_solves") == 1
    assert [s.name for s in rec.spans].count("boxls.iter") == 77
    with L.recording() as rec:
        T.admm_box_qp(H, c, A, lo, hi, AtA=AtA, max_iter=77, tol=1e-9)
    assert "boxls.kernel_solves" not in rec.counters
    assert "admm.kernel_launches" not in rec.counters


@pytest.mark.cuda
@pytest.mark.parametrize("adapt", [True, False])
def test_no_host_read_and_same_bits(card, adapt):
    """A fixed-budget solve (warmed up: the library built, the plan's
    device asked) runs clean under the sync debug mode's "error", and the
    same batch served twice gives the same bits."""
    P = [x.float() for x in _problem(card, 5, 50, 14, 165258)]
    H, c, A, lo, hi, AtA = P
    first, _ = T.admm_box_qp(H, c, A, lo, hi, AtA=AtA, max_iter=300,
                             tol=0.0, adapt_rho=adapt)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again, info = T.admm_box_qp(H, c, A, lo, hi, AtA=AtA, max_iter=300,
                                    tol=0.0, adapt_rho=adapt)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(first, again)


@pytest.mark.cuda
@pytest.mark.parametrize("adapt", [True, False])
def test_measuring_build_keeps_the_bits(card, adapt):
    """The ``-DADMM_STAMPS`` build (``admm_cuda.row_pass_stamps``) runs the
    shipped build's iterations to the same bits, and each block's stamps
    are in order: the producer's last issue and every consumer's end after
    the block's entry, no negative cycle count."""
    H, c, A, lo, hi, AtA = (x.float() for x in _problem(card, 12, 13, 14,
                                                          20000))
    b, r = c.shape
    op = T._Operator(A)
    plan = K.plan_for(H, c, A, lo, hi, AtA, adapt)
    rho = T._penalty(H, AtA, None, b, c.dtype, c.device)
    L = T._factorizer(H, AtA, r)(rho)
    g, z, _ = T._warm_start(c, op, lo, hi, L)
    gn = T._cho_solve(L, c + rho[:, None] * op.adj(z))
    args = (H, c, A, lo, hi, AtA, L, g, z, gn, rho)
    shipped = K.admm_fused(plan, *[x.clone() for x in args], 50, 1.6, adapt,
                           1.0)[0]
    stamped, stamps = K.row_pass_stamps(plan, *[x.clone() for x in args], 50,
                                        1.6, adapt, 1.0)
    torch.cuda.synchronize()
    assert torch.equal(shipped, stamped)
    st = stamps.cpu()
    w = plan.warps
    assert bool((st[:, 0] > 0).all())
    assert bool((st[:, 3] >= st[:, 0]).all())
    assert bool((st[:, 56:56 + w] >= st[:, :1]).all())
    assert bool((st[:, [2, 4]] >= 0).all() and (st[:, 8:8 + w] >= 0).all())
    assert bool((st[:, 24:24 + w] >= 0).all()
                and (st[:, 40:40 + w] >= 0).all())


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(card):
    H, c, A, lo, hi, AtA = (x.float() for x in _problem(card, 8, 3, 4, 100))
    op = T._Operator(A)
    with pytest.raises(ValueError):
        T._admm_kernels(H.double(), c.double(), T._Operator(A.double()),
                        lo.double(), hi.double(), AtA.double(), None, 5, 1.6,
                        True, True)
    with pytest.raises(ValueError):
        T._admm_kernels(H, c, op, lo[:50], hi[:50], AtA, None, 5, 1.6, True,
                        True)
    with pytest.raises(ValueError):
        K.plan_for(H, c, A, lo, hi, AtA[:2], True)


@pytest.mark.cuda
def test_solve_on_another_card(card):
    """Tensors on the second card while the first is current: the launches
    go to the tensors' card, and the result agrees with the loop there."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second CUDA card")
    dev = torch.device("cuda", 1)
    P64 = _problem(dev, 9, 7, 5, 1001)
    P32 = [x.float() for x in P64]
    with torch.cuda.device(0):
        gk, _ = _solve(P32, True, 200, "kernel")
        g32, _ = _solve(P32, True, 200, "loop")
        g64, _ = _solve(P64, True, 200, "loop")
    torch.cuda.synchronize(dev)
    assert gk.device == dev
    scale = float(g64.abs().max())
    bound = 2.0 * float((g32.double() - g64).abs().max()) + 100 * U * scale
    assert float((gk.double() - g64).abs().max()) <= bound
