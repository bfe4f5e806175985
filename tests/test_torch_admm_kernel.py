"""The fixed-budget ADMM's kernel pair (``openmeasure_torch/linalg/
admm_cuda.py``, ``csrc/admm.cu``) on the CPU: the loop's frozen frame,
which the kernels keep, the launch plan on an H100's numbers, the bounds
as the row pass reads them, and the predicate that sends a solve to the
kernels.  The kernels themselves run only on a card
(``tests/test_torch_admm_cuda.py``); their plain version is the loop of
``linalg/boxls.py`` (``_admm``) at ``tol == 0``, which a CPU solve runs.
"""

import numpy as np
import pytest
import torch

from openmeasure_torch import SPR, SoftSensor
from openmeasure_torch.datasets.synthetic import make_flame_dataset
from openmeasure_torch.linalg import admm_cuda as K
from openmeasure_torch.linalg import boxls as T
from openmeasure_torch.utils import logging as L

ITERS = 120
H100 = dict(sms=132, smem_optin=232448)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Many tiny torch ops: one intra-op thread beside the other workers
    (see ``tests/test_torch_boxls.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(seed, b, r, n, batched_bounds, dtype=torch.float64):
    """A COLS problem: (b, r, r) weighted Hessians of s = r + 4 sensors,
    an orthonormal (n, r) operator and a box that binds some rows."""
    rng = np.random.default_rng(seed)
    s = r + 4
    Theta = rng.standard_normal((s, r))
    Y = 3.0 * rng.standard_normal((b, s))
    W = rng.random((b, s)) + 0.5
    A, _ = np.linalg.qr(rng.standard_normal((n, r)))
    lo, hi = -0.3 * np.ones(n) / np.sqrt(n / 30), 0.3 * np.ones(n) / np.sqrt(
        n / 30)
    if batched_bounds:
        lo = lo[None, :] - 0.01 * rng.random((b, n))
        hi = hi[None, :] + 0.01 * rng.random((b, n))

    def t(x):
        return torch.as_tensor(x, dtype=dtype)
    Wt = t(Theta) * t(W)[..., :, None]
    H = Wt.mT @ Wt
    c = (Wt.mT @ (t(Y) * t(W))[..., None])[..., 0]
    A = t(A)
    return H, c, A, t(lo), t(hi), A.T @ A


def _loop(H, c, A, lo, hi, AtA, adapt, iters=ITERS):
    return T._admm(H, c, T._Operator(A), lo, hi, AtA, None, iters, 0.0, 1.6,
                   adapt, True)


def test_frame_with_zero_residuals_stays_frozen():
    """A frame with c = 0 and 0 inside its box: g, z and w stay 0, so
    both residuals are exactly 0 at the first iteration and the frame
    stops there (k = 1) while the others run the whole budget.  The
    kernels, which keep it on the card (``tests/test_torch_admm_cuda.py``),
    have no CPU version: a CPU solve sent to them raises."""
    H, c, A, lo, hi, AtA = _problem(11, 7, 14, 400, False)
    c[3] = 0.0
    for dtype in (torch.float64, torch.float32):
        P = [x.to(dtype) for x in (H, c, A, lo, hi, AtA)]
        g, info = _loop(*P, True)
        assert info.iterations.tolist() == [ITERS] * 3 + [1] + [ITERS] * 3
        assert float(info.primal_residual[3]) == 0.0
        assert float(info.dual_residual[3]) == 0.0
        assert torch.equal(g[3], torch.zeros_like(g[3]))
        with pytest.raises(ValueError, match="CUDA float32"):
            T._admm_kernels(*P[:2], T._Operator(P[2]), *P[3:], None, ITERS,
                            1.6, True, True)


@pytest.mark.parametrize("kind,want", [
    ("shared", (9,)), ("one_row", (9,)), ("expanded", (9,)),
    ("per_frame", (4, 9))])
def test_bounds_as_the_row_pass_reads_them(kind, want):
    """Bounds shared by every frame reach the row pass as one (n,) row;
    per-frame bounds (here a transposed, non-contiguous view) as a
    contiguous (b, n) block."""
    x = torch.arange(9.0)
    x = {"shared": x, "one_row": x[None], "expanded": x.expand(4, 9),
         "per_frame": torch.arange(36.0).reshape(9, 4).T}[kind]
    got = K._rows_of(x, 4, 9)
    assert tuple(got.shape) == want and got.is_contiguous()
    assert torch.equal(torch.broadcast_to(got, (4, 9)),
                       torch.broadcast_to(x, (4, 9)))


# ---- the launch plan on an H100 -------------------------------------------

PLAN_CASES = [
    # (b, n, r, adapt)
    (50, 165258, 14, True),      # flagship serving batch
    (50, 165258, 14, False),
    (1, 165258, 14, True),
    (7, 1001, 5, True),
    (13, 5000, 32, False),
    (50, 1723599, 14, True),     # 3D rows: strips capped by shared memory
    (100, 165258, 32, True),
    (1, 1, 1, True),
    (16, 31, 3, False),          # fewer rows than a strip's minimum
]


def _covers(p, b, n, r, adapt, batched):
    """The strips cover the rows, every consumer warp has units, and the
    sizes follow from the shapes."""
    assert p.grid * p.rows >= n > (p.grid - 1) * p.rows      # no empty block
    assert p.seg * p.splits >= p.rows > (p.splits - 1) * p.seg - K.ALIGN
    assert p.seg >= K.MIN_ROWS and p.rows >= K.MIN_ROWS
    assert 1 <= p.warps <= K.CONSUMERS_MAX
    units = b * p.splits
    per = -(-units // p.warps)
    assert p.warps * per >= units > (p.warps - 1) * per     # no idle warp
    assert p.splits == 1 or b * p.splits <= K.CONSUMERS_MAX
    assert p.R in (4, 8, 16, 32) and r <= p.R < 2 * r + 4
    assert p.slot == (3 * r + 1 if adapt else r)
    assert p.partials == p.grid * p.splits * b * p.slot


def _aligned(p, b, n, r, adapt, batched):
    """Every bulk copy's start and size is a whole number of 16-byte
    units in the padded layout: each strip's and tile's first row in each
    frame's row of z, w, Aᵀ and the bounds, and each copy's rows."""
    assert p.ld >= n and p.ld % K.ALIGN == 0 and 4 * K.ALIGN % 16 == 0
    assert p.ld - n < K.ALIGN
    tiles = -(-p.seg // p.tile)
    for blk in {0, 1 % p.grid, p.grid - 1}:
        i0 = blk * p.rows
        nrow = min(p.rows, n - i0)
        for u in range(p.splits):
            for k in range(tiles):
                t0 = u * p.seg + k * p.tile
                tn = min(t0 + p.tile, (u + 1) * p.seg, nrow) - t0
                if tn <= 0:
                    continue
                size = 4 * K._up(tn, K.ALIGN)
                assert size % 16 == 0 and tn <= p.tile
                for j in {0, 1 % b, b - 1}:
                    start = 4 * (j * p.ld + i0 + t0)
                    assert start % 16 == 0
                    assert j * p.ld + i0 + t0 + size // 4 <= (j + 1) * p.ld
        assert (4 * i0) % 16 == 0 and (4 * K._up(nrow, K.ALIGN)) % 16 == 0
        assert i0 + K._up(nrow, K.ALIGN) <= p.ld


def _fits(p, b, n, r, adapt, batched):
    """The rings, A's strip and the staged bounds fit the device's shared
    memory, every region 16-byte aligned, with 2 stages a consumer warp at
    least."""
    stages = p.warps * p.depth
    bars = K._bar_bytes(stages, -(-p.seg // p.tile))
    strip = 4 * p.R * p.rows + (0 if batched else 8 * p.rows)
    stage = 4 * p.tile * (4 if batched else 2)
    assert bars % 16 == 0 and strip % 16 == 0 and stage % 16 == 0
    assert p.depth >= 2 and stages <= K.STAGES_MAX
    red = 4 * K.RED_FLOATS * p.warps                       # reductions' scratch
    assert p.smem_bytes == bars + strip + stages * stage + red
    assert p.smem_bytes <= H100["smem_optin"]
    assert stages + p.warps > K.STAGES_MAX or \
        p.smem_bytes + p.warps * stage + 16 > H100["smem_optin"]  # it fills


PLAN_CHECKS = [pytest.param(_covers, *c, id="-".join(map(str, c)))
               for c in PLAN_CASES] + [
    pytest.param(check, *c, id="-".join([check.__name__[1:]] +
                                        [str(x) for x in c]))
    for check in (_aligned, _fits) for c in PLAN_CASES]


@pytest.mark.parametrize("check,b,n,r,adapt", PLAN_CHECKS)
def test_plan_covers_rows_and_frames_within_the_device(check, b, n, r, adapt):
    """Each check of the plan (:func:`_covers`, :func:`_aligned`,
    :func:`_fits`) with the bounds shared and per frame."""
    for batched in (False, True):
        p = K._plan(b, n, r, adapt, **H100, batched=batched)
        check(p, b, n, r, adapt, batched)


def test_plan_flagship_numbers():
    """The serving batch on an H100: one block an SM, 132 strips of 1256
    rows (80,384 bytes of A, its columns padded to 16, and 10,048 of the
    shared bounds), 13 consumer warps of 4 frames (two hold 3), each
    frame's strip in 3 tiles of 424 rows, a ring of 2 stages of 3,392
    bytes for each warp and 1,728 bytes of reduction scratch, 43 sums a
    (block, frame): 1.14 MB of partials.  One frame: its strip split among
    15 warps, 88 rows each, 4 stages a warp.  Per-frame bounds: tiles of
    256 rows, to keep 2 stages a warp.  3D rows: 6 equal waves."""
    p = K._plan(50, 165258, 14, True, **H100)
    assert p == K.Plan(grid=132, rows=1256, warps=13, splits=1, seg=1256,
                       tile=424, depth=2, ld=165264, R=16, slot=43,
                       partials=132 * 50 * 43,
                       smem_bytes=448 + 80384 + 10048 + 26 * 3392 + 13 * 1728)
    q = K._plan(1, 165258, 14, True, **H100)
    assert (q.warps, q.splits, q.grid, q.seg, q.tile, q.depth) == (
        15, 15, 132, 88, 88, 4)
    pb = K._plan(50, 165258, 14, True, **H100, batched=True)
    assert (pb.tile, pb.depth) == (256, 2)
    s = K._plan(50, 1723599, 14, True, **H100)
    assert (s.grid, s.rows) == (790, 2184)                   # 6 equal waves


def test_plan_refuses_what_the_kernels_do_not_take():
    for bad in (dict(b=0, n=10, r=3), dict(b=2, n=0, r=3),
                dict(b=2, n=10, r=0), dict(b=2, n=10, r=K.R_MAX + 1)):
        with pytest.raises(ValueError):
            K._plan(adapt=True, **bad, **H100)


# ---- the predicate: which solves the kernels run ------------------------

def _kernel_solves(fn):
    """Run ``fn`` with the recorder on; the ``boxls.kernel_solves`` count."""
    with L.recording() as rec:
        fn()
    return rec.counters.get("boxls.kernel_solves", 0)


class _OnCard:
    """A tensor's stand-in that says it is a card's, for the predicate."""
    is_cuda = True

    def __init__(self, t):
        self.dtype = t.dtype


@pytest.fixture
def card_like(monkeypatch):
    """The predicate answers as if CPU tensors were on a card, and the
    solves it takes run the kernels' plain version, the loop at
    ``tol == 0``, in place of the kernels, which run only on a card."""
    takes = K.takes
    monkeypatch.setattr(K, "takes",
                        lambda c, op, tol: takes(_OnCard(c), op, tol))
    monkeypatch.setattr(
        T, "_admm_kernels",
        lambda H, c, op, lo, hi, AtA, rho, max_iter, over_relax, adapt,
        batched, n_rows=None: T._admm(H, c, op, lo, hi, AtA, rho, max_iter,
                                      0.0, over_relax, adapt, batched,
                                      n_rows))
    return takes


def test_predicate_on_the_operator_and_the_budget():
    A = torch.zeros(10, 4)
    c = torch.zeros(2, 4)
    op = T._Operator(A)
    assert not K.takes(c, op, 0.0)                  # a CPU tensor
    card = _OnCard(c)
    assert K.takes(card, op, 0.0)
    assert not K.takes(_OnCard(c.double()), T._Operator(A.double()), 0.0)
    assert not K.takes(card, op, 1e-9)                           # tol > 0
    assert not K.takes(card, T._Operator(A, R=torch.eye(4)[None]), 0.0)
    assert not K.takes(card, T._Operator(A, axis=object()), 0.0)  # sharded
    assert not K.takes(card, T._Operator(A.to_sparse()), 0.0)
    wide = torch.zeros(10, K.R_MAX + 1)
    assert not K.takes(_OnCard(torch.zeros(2, K.R_MAX + 1)),
                       T._Operator(wide), 0.0)
    assert K.takes(card, T._Operator(torch.zeros(10, K.R_MAX)), 0.0)


def _sensor_model():
    """An fp32 SPR trained for COLS on a small synthetic flame, its test
    frames read at the sensors (b, s) and the sensors' rows."""
    d = make_flame_dataset(n_cells=120, m_train=12, m_test=3,
                           dtype=np.float32, seed=4)
    npts = d["xyz"].shape[0]
    Xb = d["X_train"].reshape(9, npts, -1)
    lo, hi = Xb.min(axis=(1, 2)), Xb.max(axis=(1, 2))
    spr = SPR(d["X_train"], 9, d["xyz"], device="cpu")
    spr.fit(select_modes="number", n_modes=5)
    C = spr.optimal_placement()
    spr.train(C, method="COLS", limits=[lo, hi])
    rows = C.argmax(dim=1).numpy()
    return spr, torch.as_tensor(d["X_test"][rows].T), rows


@pytest.mark.parametrize("admm_rho", ["adaptive", "fixed"])
def test_serving_takes_the_kernels_and_agrees(card_like, monkeypatch,
                                              admm_rho):
    """An fp32 COLS ``SoftSensor`` batch (tol = 0) takes the kernel pair,
    whose plain version gives the loop's coefficients; a float64 sensor
    keeps the loop."""
    spr, Y, _ = _sensor_model()
    s32 = SoftSensor.from_spr(spr, dtype=torch.float32, admm_iters=200,
                              admm_rho=admm_rho)
    s64 = SoftSensor.from_spr(spr, dtype=torch.float64, admm_iters=200,
                              admm_rho=admm_rho)
    out = {}
    assert _kernel_solves(lambda: out.update(k=s32.predict_batch(Y))) == 1
    assert _kernel_solves(lambda: s64.predict_batch(Y.double())) == 0
    monkeypatch.setattr(K, "takes", card_like)     # the real predicate
    assert _kernel_solves(lambda: out.update(l=s32.predict_batch(Y))) == 0
    assert torch.equal(out["k"][1], out["l"][1])


def test_other_callers_keep_the_loop(card_like):
    """``SPR.predict`` COLS (``admm_tol`` 1e-9), ``ROM.CPOD`` (tol > 0),
    the constrained GP MAP (a right factor) and a float64 solve run the
    loop even where the device test passes; ``box_constrained_lstsq`` at
    ``tol = 0`` in float32 takes the kernels."""
    H, c, A, lo, hi, AtA = (x.float() for x in _problem(21, 3, 4, 60,
                                                          False))
    gen = torch.Generator().manual_seed(21)
    Th = torch.randn(8, 4, generator=gen)
    Y = torch.randn(3, 8, generator=gen)
    W = torch.rand(3, 8, generator=gen) + 0.5
    assert _kernel_solves(lambda: T.box_constrained_lstsq(
        Th, Y, W, A, lo, hi, max_iter=50, tol=0.0)) == 1
    assert _kernel_solves(lambda: T.box_constrained_lstsq(
        Th, Y, W, A, lo, hi, max_iter=50, tol=1e-9)) == 0
    assert _kernel_solves(lambda: T.box_constrained_lstsq(
        Th.double(), Y.double(), W.double(), A.double(), lo.double(),
        hi.double(), max_iter=50, tol=0.0)) == 0
    cov = torch.eye(4)[None].repeat(3, 1, 1) * 0.5
    assert _kernel_solves(lambda: T.box_constrained_map(
        torch.randn(3, 4, generator=gen), cov, A, lo, hi, max_iter=50,
        tol=0.0)) == 0
    assert _kernel_solves(lambda: T.admm_box_qp(
        H, c, A, lo, hi, max_iter=50, tol=0.0)) == 1

    spr, Y, rows = _sensor_model()
    ys = []
    for j in range(Y.shape[0]):
        y = np.zeros((Y.shape[1], 3))
        y[:, 0] = Y[j].numpy()
        y[:, 2] = rows // 120
        ys.append(y)
    assert spr.Theta.dtype == torch.float32
    assert _kernel_solves(lambda: spr.predict(ys)) == 0
    lims = [np.full(9, -1e3), np.full(9, 1e3)]
    assert _kernel_solves(lambda: spr.CPOD(limits=lims, max_iter=50)) == 0
