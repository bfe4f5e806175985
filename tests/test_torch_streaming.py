"""Port parity for the out-of-core tier (``openmeasure_torch/streaming.py``):
the prefetching chunk iterator, the streamed statistics of all 14 scale
types, the exact block medians, the fused Gram and its cancellation
fallback, both fit engines, and the streaming SPR, GPR, PIGPR and DMD,
against the JAX package (x64) on the same numpy inputs, CPU, float64.

The data are 9 features × 500 cells (n = 4500) × m = 12 snapshots read in
chunks of 333 rows, so chunks cut feature blocks.  Bars: the statistics
to 1e-12 relative (median EXACTLY equal, to ``np.median`` and to the
in-core ``scale_data('median')``); σ to 1e-10 relative and |cos| ≥
1 − 1e-10 per mode against JAX's streamed fit of the same data; the disk
pass counts JAX's tests pin; the GP posteriors and final losses after
training to 1e-9; DMD's spectrum to 1e-9.
"""

import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openmeasure_tpu.streaming as J
import openmeasure_torch.streaming as T
from openmeasure_tpu import ROM as JROM
from openmeasure_torch import ROM as TROM
from openmeasure_torch.datasets.synthetic import make_flame_dataset
from openmeasure_torch.linalg import svd as tsvd

CPU = "cpu"
NF, NPTS, M, ROWS = 9, 500, 12, 333
SCALE_TYPES = ["std", "none", "pareto", "vast", "range", "level", "max",
               "variance", "poisson", "vast_2", "vast_3", "vast_4",
               "l2-norm", "median"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch intra-op thread: beside the other test workers torch's
    OpenMP threads spin between the many tiny ops of a GP training."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_X(n_features=NF, n_points=NPTS, m=M, rank=6, seed=42):
    rng = np.random.default_rng(seed)
    n = n_features * n_points
    U = rng.standard_normal((n, rank))
    V = rng.standard_normal((m, rank))
    X = (U * np.geomspace(50.0, 0.5, rank)) @ V.T
    return X + 10.0 + np.abs(X).max()          # strictly positive


@pytest.fixture(scope="module")
def X():
    return make_X()


class Counting(T.ArrayStore):
    """An ArrayStore that counts full passes (a pass starts at row 0)."""

    def __init__(self, X):
        super().__init__(X)
        self.passes = 0

    def read_rows(self, row0, nrows, dtype=np.float32, out=None):
        self.passes += row0 == 0
        return super().read_rows(row0, nrows, dtype, out)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _same_basis(t, j, tol=1e-10):
    """σ to ``tol`` relative and |cos| ≥ 1 − tol per mode."""
    assert _rel(t.Sigma_r, j.Sigma_r) <= tol
    Ut, Uj = _np(t.Ur), _np(j.Ur)
    cos = np.abs(np.sum(Ut * Uj, axis=0)) / (
        np.linalg.norm(Ut, axis=0) * np.linalg.norm(Uj, axis=0))
    assert np.all(cos >= 1.0 - tol), cos


def fit_pair(X, engine="host", chunk_rows=ROWS, **kw):
    j = J.StreamingROM(J.ArrayStore(X), NF, chunk_rows=chunk_rows,
                       dtype=np.float64)
    j.fit(engine=engine, **kw)
    st = Counting(X)
    t = T.StreamingROM(st, NF, chunk_rows=chunk_rows, dtype=np.float64,
                       device=CPU)
    t.fit(engine=engine, **kw)
    return j, t, st


# --------------------------------------------------------------------- #
# The chunk iterator
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("chunk_rows", [1, 7, 40, 1000])
def test_iter_chunks_covers_everything(chunk_rows, prefetch):
    Xs = make_X(3, 40)
    seen = np.zeros_like(Xs)
    hit = np.zeros(Xs.shape[0], dtype=int)
    for row0, chunk in T.iter_chunks(T.ArrayStore(Xs), chunk_rows,
                                     np.float64, prefetch):
        seen[row0:row0 + chunk.shape[0]] = chunk
        hit[row0:row0 + chunk.shape[0]] += 1
    assert (hit == 1).all()
    np.testing.assert_array_equal(seen, Xs)


def test_iter_chunks_under_rapid_thread_switching():
    """The reader thread and the consumer share only the bounded queue and
    the stop event: with the interpreter switching threads every
    microsecond, several iterators at once still see every row once, in
    order, and stop when closed early."""
    Xs = make_X(3, 40)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        gens = [T.iter_chunks(T.ArrayStore(Xs), 3, np.float64, prefetch=p)
                for p in (1, 2, 3, 1, 2, 3)]
        seen = [[] for _ in gens]
        done = [False] * len(gens)
        while not all(done):
            for i, g in enumerate(gens):
                if done[i]:
                    continue
                try:
                    row0, chunk = next(g)
                except StopIteration:
                    done[i] = True
                    continue
                seen[i].append(row0)
                np.testing.assert_array_equal(chunk,
                                              Xs[row0:row0 + chunk.shape[0]])
                if i == 0 and len(seen[0]) == 5:
                    g.close()
                    done[0] = True
    finally:
        sys.setswitchinterval(old)
    assert seen[0] == [0, 3, 6, 9, 12]
    for rows in seen[1:]:
        assert rows == list(range(0, Xs.shape[0], 3))


def _readers():
    return [t for t in threading.enumerate()
            if t.name == "omtorch-chunk-prefetch"]


def test_iter_chunks_early_close_stops_reader():
    before = len(_readers())
    gen = T.iter_chunks(T.ArrayStore(make_X(3, 40)), 5, np.float64,
                        prefetch=2)
    next(gen)
    gen.close()
    deadline = time.time() + 5.0
    while len(_readers()) > before and time.time() < deadline:
        time.sleep(0.01)
    assert len(_readers()) == before


def test_iter_chunks_surfaces_a_reader_error():
    class Broken(T.ArrayStore):
        def read_rows(self, row0, nrows, dtype=np.float32, out=None):
            if row0 >= 20:
                raise OSError(f"disk gone at row {row0}")
            return super().read_rows(row0, nrows, dtype, out)

    got = []
    with pytest.raises(OSError, match="disk gone at row 20"):
        for row0, _ in T.iter_chunks(Broken(make_X(3, 40)), 10,
                                     np.float64, prefetch=2):
            got.append(row0)
    assert got == [0, 10]


# --------------------------------------------------------------------- #
# Statistics, medians, the fused Gram
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("scale_type", SCALE_TYPES)
def test_scaling_stats_match_jax(X, scale_type):
    j, t, _ = fit_pair(X, scale_type=scale_type, select_modes="number",
                       n_modes=5)
    if scale_type == "median":
        np.testing.assert_array_equal(_np(t.X_scl), np.asarray(j.X_scl))
        incore = TROM(X, NF, None, device=CPU)
        incore.scale_data("median")
        np.testing.assert_array_equal(_np(t.X_scl), _np(incore.X_scl))
        meds = [np.median(X[f * NPTS:(f + 1) * NPTS]) for f in range(NF)]
        np.testing.assert_array_equal(_np(t.X_scl)[::NPTS, 0], meds)
    else:
        assert _rel(t.X_scl, j.X_scl) <= 1e-12
    assert _rel(t.X_cnt, j.X_cnt) <= 1e-12
    _same_basis(t, j)


def run_medians(mod, X, n_features, chunk_rows):
    st = mod.ArrayStore(X)
    bmin = np.array([X[f * (X.shape[0] // n_features):
                       (f + 1) * (X.shape[0] // n_features)].min()
                     for f in range(n_features)], dtype=np.float64)
    npts = X.shape[0] // n_features
    bmax = np.array([X[f * npts:(f + 1) * npts].max()
                     for f in range(n_features)], dtype=np.float64)
    return mod._block_medians(st, n_features, X.dtype, chunk_rows, 0,
                              bmin, bmax)


def expected_medians(X, n_features):
    npts = X.shape[0] // n_features
    return np.array([np.median(X[f * npts:(f + 1) * npts]
                               .astype(np.float64))
                     for f in range(n_features)])


@pytest.mark.parametrize("chunk_rows", [7, 61, 500])
@pytest.mark.parametrize("m", [9, 10])          # odd and even counts
def test_block_medians_exact(chunk_rows, m):
    Xr = np.random.default_rng(11).standard_normal((120, m))
    got = run_medians(T, Xr, 3, chunk_rows)
    np.testing.assert_array_equal(got, expected_medians(Xr, 3))
    np.testing.assert_array_equal(got, run_medians(J, Xr, 3, chunk_rows))


def _force_histograms(monkeypatch):
    monkeypatch.setattr(T, "_MEDIAN_COLLECT_LIMIT", 1)
    monkeypatch.setattr(J, "_MEDIAN_COLLECT_LIMIT", 1)


def test_block_medians_histogram_paths(monkeypatch):
    """A collect limit of 1 forces the full histogram refinement."""
    _force_histograms(monkeypatch)
    rng = np.random.default_rng(5)
    for m in (9, 10):
        Xr = rng.standard_normal((80, m))
        got = run_medians(T, Xr, 2, 17)
        np.testing.assert_array_equal(got, expected_medians(Xr, 2))
        np.testing.assert_array_equal(got, run_medians(J, Xr, 2, 17))


def test_block_medians_ties_and_few_distinct_values(monkeypatch):
    """Two masses in different bins (the straddle pass), two ADJACENT
    fp32 values (the exact enumeration), a constant block, and blocks of
    at most 64 distinct values with ties, in chunks that cut blocks."""
    _force_histograms(monkeypatch)
    two = np.concatenate([np.zeros(20), np.ones(20)])[:, None] * np.ones(4)
    assert run_medians(T, two, 1, 13)[0] == 0.5
    a = np.float32(1.0)
    b = np.nextafter(a, np.float32(2.0), dtype=np.float32)
    adj = (np.concatenate([np.full(20, a), np.full(20, b)])[:, None]
           * np.ones((1, 3), dtype=np.float32)).astype(np.float32)
    assert run_medians(T, adj, 1, 9)[0] == 0.5 * (np.float64(a)
                                                  + np.float64(b))
    rng = np.random.default_rng(7)
    const = np.full((30, 5), 3.25)
    dups = rng.choice([1.0, 2.0, 2.0, 7.5], size=(30, 5))
    few = rng.integers(0, 64, size=(30, 5)).astype(np.float64) / 8.0
    Xr = np.concatenate([const, dups, few], axis=0)
    got = run_medians(T, Xr, 3, 11)
    np.testing.assert_array_equal(got, expected_medians(Xr, 3))
    np.testing.assert_array_equal(got, run_medians(J, Xr, 3, 11))


@pytest.mark.parametrize("axis_cnt", [1, None])
def test_fused_gram_matches_streamed_gram_and_jax(X, axis_cnt):
    t = T.StreamingROM(X, NF, chunk_rows=ROWS, dtype=np.float64, device=CPU)
    t.disk_passes_ = 0
    cnt, scl, stats, blocks = t._stream_scaling("std", axis_cnt,
                                                want_gram=True)
    G_fused, lost = T._gram_from_block_stats(stats, blocks, axis_cnt, NPTS,
                                             np.float64)
    assert lost < T.StreamingROM._FUSED_MAX_DIGITS_LOST
    G_streamed = t._assemble_gram(None, None, axis_cnt, cnt, scl)
    assert not t.gram_fused_
    assert _rel(G_fused, G_streamed) <= 1e-10
    js = J._block_stats_pass(J.ArrayStore(X), NF, np.float64, ROWS,
                             axis_cnt == 1, 0, accumulate_gram=True)
    G_j, lost_j = J._gram_from_block_stats(js, blocks, axis_cnt, NPTS,
                                           np.float64)
    assert _rel(G_fused, G_j) <= 1e-13 and abs(lost - lost_j) <= 1e-12


def test_offset_dominated_data_falls_back_to_the_streamed_gram(X):
    """|mean| ≫ spread loses more than 6 digits in the fused algebra: one
    streamed centred Gram pass runs instead (3 passes), as in JAX.
    ``scale_type='none'`` isolates the Gram algebra."""
    Xo = X + 1e6
    j, t, st = fit_pair(Xo, scale_type="none", select_modes="number",
                        n_modes=5)
    assert not t.gram_fused_ and not j.gram_fused_
    assert st.passes == 3 and t.disk_passes_ == 3
    _same_basis(t, j)
    incore = TROM(Xo, NF, None, device=CPU)
    incore.fit(scale_type="none", select_modes="number", n_modes=5)
    assert _rel(t.Sigma_r, incore.Sigma_r) <= 1e-9


# --------------------------------------------------------------------- #
# The fit engines
# --------------------------------------------------------------------- #

def test_refine_rule_c4():
    """C.4 settled (ROADMAP.md §C): refine 1 on a CUDA card, 2 on the
    CPU; the streaming device engine takes its default from the same
    rule, so a CPU fit makes 1 stats + 1 Gram + 2 refine + 1 U passes."""
    assert tsvd.default_refine(torch.device("cuda")) == 1
    assert tsvd.default_refine(torch.device("cuda:0")) == 1
    assert tsvd.default_refine(torch.device("cpu")) == 2
    t = T.StreamingROM(Counting(make_X(3, 40)), 3, chunk_rows=50,
                       dtype=np.float64, device=CPU)
    t.fit(engine="device", select_modes="number", n_modes=3)
    assert t.store.passes == 5 and t.disk_passes_ == 5


@pytest.mark.parametrize("engine", ["host", "device"])
@pytest.mark.parametrize("axis_cnt", [1, None])
def test_engines_match_jax(X, engine, axis_cnt):
    j, t, st = fit_pair(X, engine=engine, axis_cnt=axis_cnt,
                        select_modes="number", n_modes=6)
    _same_basis(t, j)
    assert _rel(t.Ar, j.Ar) <= 1e-10
    assert t.r == j.r == 6
    # JAX's pinned pass counts: the moment types fit in two passes on the
    # host engine; the device engine makes stats + Gram + refine + U
    assert st.passes == (2 if engine == "host" else 5)
    assert t.gram_fused_ == (engine == "host")
    # past the data's rank the values are round-off, √eps·σ₁ at most
    np.testing.assert_allclose(t._S_full, j._S_full, rtol=1e-10,
                               atol=1e-8 * j._S_full[0])


def test_median_passes_and_variance_selection(X):
    j, t, st = fit_pair(X, scale_type="median", n_modes=99.9)
    assert t.r == j.r and st.passes <= 4 and t.gram_fused_
    _same_basis(t, j)


def test_from_disk_both_layouts(tmp_path, X):
    """A matrix file and the reference's column files fit like the
    in-memory array, and like JAX's fit of the same files."""
    Xf = X.astype(np.float32)
    mat = str(tmp_path / "X.npy")
    np.save(mat, Xf)
    cols = []
    for k in range(M):
        cols.append(str(tmp_path / f"snap{k}.npy"))
        np.save(cols[-1], Xf[:, k] if k % 2 else Xf[:, k:k + 1])
    mem = T.StreamingSPR(Xf, NF, chunk_rows=ROWS, device=CPU)
    mem.fit(select_modes="number", n_modes=5)
    for src in (mat, cols):
        t = T.StreamingSPR(src, NF, chunk_rows=ROWS, device=CPU)
        t.fit(select_modes="number", n_modes=5)
        for a in ("Ur", "Sigma_r", "Ar", "X_cnt", "X_scl"):
            assert torch.equal(getattr(t, a), getattr(mem, a)), a
        j = J.StreamingSPR(src, NF, chunk_rows=ROWS)
        j.fit(select_modes="number", n_modes=5)
        np.testing.assert_array_equal(_np(t.X_scl), np.asarray(j.X_scl))
        assert _rel(t.Sigma_r, j.Sigma_r) <= 1e-6
    assert mem.Ur.dtype == torch.float32


def test_errors_and_in_core_only_methods(X):
    t = T.StreamingROM(X, NF, dtype=np.float64, device=CPU)
    with pytest.raises(NotImplementedError, match="never materializes"):
        t.scale_data()
    with pytest.raises(NotImplementedError, match="decomposes inside"):
        t.decomposition(None)
    with pytest.raises(ValueError, match="unknown streaming fit engine"):
        t.fit(engine="gpu")
    with pytest.raises(ValueError, match="device-engine knobs"):
        t.fit(refine=1)
    with pytest.raises(NotImplementedError, match="not been implemented"):
        t.fit(scale_type="bogus")
    with pytest.raises(AttributeError, match="fit function"):
        t.update_basis(X[:, :2])
    with pytest.raises(Exception, match="multiple of n_features"):
        T.StreamingROM(X[:-1], NF, device=CPU)
    with pytest.raises(TypeError, match="not an integer"):
        T.StreamingROM(X, 9.0, device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.StreamingROM(X, NF)
    t.fit(select_modes="number", n_modes=4)
    with pytest.raises(NotImplementedError, match="solver_fn"):
        t.CPOD(solver_fn=lambda *a: None)
    with pytest.raises(NotImplementedError, match="re-fit"):
        t.adaptive_sampling(np.zeros((M, 2)), scale_type="range")


def test_basis_injection(X):
    j, t, _ = fit_pair(X, select_modes="number", n_modes=4)
    basis = (_np(t.Ur), _np(t.Ar))
    t2 = T.StreamingROM(X, NF, chunk_rows=ROWS, dtype=np.float64,
                        device=CPU)
    t2.fit(basis=basis, select_modes="number", n_modes=4)
    assert t2.disk_passes_ == 1 and t2.r == 4
    assert torch.equal(t2.Ur, t.Ur)
    j2 = J.StreamingROM(J.ArrayStore(X), NF, chunk_rows=ROWS,
                        dtype=np.float64)
    j2.fit(basis=basis)
    assert _rel(t2.Vr, j2.Vr) <= 1e-13


# --------------------------------------------------------------------- #
# CPOD, adaptive sampling, the update
# --------------------------------------------------------------------- #

def test_cpod_matches_jax(X):
    j, t, _ = fit_pair(X, n_modes=99.9)
    limits = [np.min(X) * np.ones(NF), np.max(X) * 0.9 * np.ones(NF)]
    j.CPOD(limits=limits, max_iter=400)
    t.CPOD(limits=limits, max_iter=400)
    assert _rel(t.Ar, j.Ar) <= 1e-9
    assert _rel(t.Vr, j.Vr) <= 1e-9


def test_adaptive_sampling_matches_jax(X):
    j, t, _ = fit_pair(X, select_modes="number", n_modes=5)
    P = np.random.default_rng(3).random((M, 2))
    np.testing.assert_allclose(t.adaptive_sampling(P, seed=4),
                               j.adaptive_sampling(P, seed=4), rtol=1e-12)


def test_update_basis_matches_jax(tmp_path, X):
    Xn = make_X(m=3, seed=9)
    p = str(tmp_path / "new.npy")
    np.save(p, Xn)
    for new in (Xn, p):
        j, t, _ = fit_pair(X, select_modes="number", n_modes=5)
        j.update_basis(new, n_modes=6)
        t.update_basis(new, n_modes=6)
        assert t.r == j.r == 6 and t._S_full is None
        _same_basis(t, j, 1e-9)
        assert _rel(t.Ar, j.Ar) <= 1e-9
    with pytest.raises(ValueError, match="rows; expected"):
        t.update_basis(Xn[:-1])


# --------------------------------------------------------------------- #
# The streaming families
# --------------------------------------------------------------------- #

def test_streaming_spr_flow_matches_jax(X):
    j = J.StreamingSPR(J.ArrayStore(X), NF, chunk_rows=ROWS,
                       dtype=np.float64)
    t = T.StreamingSPR(X, NF, chunk_rows=ROWS, dtype=np.float64, device=CPU)
    for m in (j, t):
        m.fit(select_modes="number", n_modes=6)
    Cj = np.asarray(j.optimal_placement())
    Ct = t.optimal_placement()
    np.testing.assert_array_equal(_np(Ct), Cj)
    j.train(Cj)
    t.train(Ct)
    rows = Cj.argmax(axis=1)
    Xt = make_X(m=3, seed=5)
    ys = [np.column_stack([Xt[rows, k], np.zeros(rows.size), rows // NPTS])
          for k in range(3)]
    aj, _ = j.predict(ys)
    at, _ = t.predict(ys)
    assert _rel(at, aj) <= 1e-9
    assert _rel(t.reconstruct(at), j.reconstruct(aj)) <= 1e-9
    Xn = make_X(m=2, seed=8)
    j.update_basis(Xn, n_modes=7)
    t.update_basis(Xn, n_modes=7)
    assert _rel(t.Theta, j.Theta) <= 1e-9


@pytest.fixture(scope="module")
def flame():
    return make_flame_dataset(n_cells=200, n_features=3, m_train=16,
                              m_test=3, seed=0)


def _gp_close(t, j, flame, tol=1e-9, loss=True):
    """The posterior at the test parameters (and the training's final
    loss, which JAX's ``update_basis`` does not refresh) to ``tol``."""
    if loss:
        assert _rel(t._final_loss, j._final_loss) <= tol
    aj, sj = j.predict(flame["P_test"])
    at, st = t.predict(flame["P_test"])
    assert _rel(at, aj) <= tol and _rel(st, sj) <= tol


@pytest.mark.parametrize("gpr_type", ["SingleTask", "MultiTask"])
def test_streaming_gpr_matches_jax(flame, gpr_type):
    args = (flame["X_train"], 3, flame["xyz"], flame["P_train"])
    j = J.StreamingGPR(J.ArrayStore(args[0]), *args[1:], gpr_type=gpr_type,
                       chunk_rows=97, dtype=np.float64)
    t = T.StreamingGPR(*args, gpr_type=gpr_type, chunk_rows=97,
                       dtype=np.float64, device=CPU)
    for m in (j, t):
        m.fit(select_modes="number", n_modes=4)
        m.train(max_iter=40)
    _same_basis(t, j)
    _gp_close(t, j, flame)
    with pytest.raises(Exception, match="number of parameters"):
        T.StreamingGPR(*args[:3], flame["P_train"][:-1], device=CPU)


def test_streaming_pigpr_matches_jax(flame):
    P = flame["P_train"]
    P_cstr = np.vstack([P.min(axis=0), P.max(axis=0), P.mean(axis=0)])
    args = (flame["X_train"], 3, flame["xyz"], P, P_cstr, None)
    j = J.StreamingPIGPR(J.ArrayStore(args[0]), *args[1:], chunk_rows=97,
                         dtype=np.float64)
    t = T.StreamingPIGPR(*args, chunk_rows=97, dtype=np.float64, device=CPU)
    for m in (j, t):
        m.fit(select_modes="number", n_modes=4)
    n_tr = P.shape[0]

    def added_jnp(ctx):
        return -ctx["loss_dict"]["coef"] * jnp.mean(
            ctx["output"].mean[n_tr:] ** 2)

    def added_torch(ctx):
        return -ctx["loss_dict"]["coef"] * torch.mean(
            ctx["output"].mean[n_tr:] ** 2)

    j.AddedLoss, t.AddedLoss = added_jnp, added_torch
    for m in (j, t):
        m.train(max_iter=30, loss_dict={"coef": 0.5})
    _gp_close(t, j, flame)
    with pytest.raises(ValueError, match="cannot retrain"):
        t.update_basis(flame["X_test"], flame["P_test"], retrain=True)


def test_streaming_gpr_update_basis_matches_jax(flame):
    args = (flame["X_train"], 3, flame["xyz"], flame["P_train"])
    j = J.StreamingGPR(J.ArrayStore(args[0]), *args[1:], chunk_rows=97,
                       dtype=np.float64)
    t = T.StreamingGPR(*args, chunk_rows=97, dtype=np.float64, device=CPU)
    for m in (j, t):
        m.fit(select_modes="number", n_modes=4)
        m.train(max_iter=30)
        m.update_basis(flame["X_test"], flame["P_test"], retrain=True)
    _same_basis(t, j, 1e-9)
    _gp_close(t, j, flame, loss=False)


def test_streaming_dmd_matches_jax():
    rng = np.random.default_rng(2)
    n, m, r = 3 * 300, 20, 4
    modes = rng.standard_normal((n, r))
    lam = np.array([0.95, 0.9, 0.8, 0.7])
    Xd = modes @ (lam[:, None] ** np.arange(m)[None, :]) + 5.0 \
        + 1e-3 * rng.standard_normal((n, m))
    j = J.StreamingDMD(J.ArrayStore(Xd), 3, chunk_rows=77, dtype=np.float64)
    t = T.StreamingDMD(Xd, 3, chunk_rows=77, dtype=np.float64, device=CPU)
    for d in (j, t):
        d.fit(dt=0.5, select_modes="number", n_modes=r)
    order_j, order_t = np.argsort(j.eigs), np.argsort(t.eigs)
    np.testing.assert_allclose(t.eigs[order_t], j.eigs[order_j], rtol=1e-9)
    assert t.disk_passes_ == 2 and t.gram_fused_
    assert _rel(t.forecast_horizon(3), j.forecast_horizon(3)) <= 1e-9
    assert _rel(t.reconstruct_dmd(), j.reconstruct_dmd()) <= 1e-9
    with pytest.raises(NotImplementedError, match="not supported"):
        t.update_basis(Xd[:, :1])
