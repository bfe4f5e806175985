"""The port's span and counter recorder (``openmeasure_torch/utils/
logging.py``) at the layer boundaries of a served COLS batch
(``SoftSensor.predict_batch``), of the fit (``spr_end_to_end``) and of the
GP ROM flow (``GPR.fit`` → ``train`` → ``predict`` → ``reconstruct``):
off, it records nothing and reads no clock; on, the spans nest as the
layers call each other, share their root's call id, lie on
``torch.profiler``'s clock, and leave the outputs as they were.

CPU at tiny sizes; the ``cuda`` tests hold the ``host_reads`` counter of
a fit and of a GP training on the card to the reads that ``torch.cuda``'s
sync debug mode reports.  This file imports neither JAX nor the JAX package,
so on a machine with a card it runs as::

    python -m pytest tests/test_torch_tracing.py --noconftest -q
"""

import contextlib
import functools
import types
import warnings

import numpy as np
import pytest
import torch

from openmeasure_torch import GPR, SPR, SoftSensor
from openmeasure_torch.gp import exact_gp as E
from openmeasure_torch.gp import kernels as GK
from openmeasure_torch.pipelines import spr_end_to_end
from openmeasure_torch.utils import logging as tlog

N_FEATURES, N_POINTS, M, R = 2, 40, 8, 4


def _snapshots(seed, m=M, device="cpu"):
    rng = np.random.default_rng(seed)
    X = rng.random((N_FEATURES * N_POINTS, m)) + np.arange(m) * 0.1
    return torch.as_tensor(X, dtype=torch.float64, device=device)


def _sensor(admm_iters, admm_rho="adaptive", seed=0):
    """A COLS sensor on a tiny model, per-feature limits ± 5 % of the
    span, and a batch of 3 frames with σ, read at its sensors."""
    X = _snapshots(seed)
    xyz = np.random.default_rng(seed).random((N_POINTS, 2))
    spr = SPR(X, N_FEATURES, xyz, device="cpu")
    spr.fit(select_modes="number", n_modes=R)
    C = spr.optimal_placement("qr")
    Xb = X.reshape(N_FEATURES, -1)
    lo, hi = Xb.amin(dim=1), Xb.amax(dim=1)
    pad = 0.05 * (hi - lo)
    spr.train(C, method="COLS", limits=[(lo - pad).numpy(),
                                        (hi + pad).numpy()])
    sensor = SoftSensor.from_spr(spr, dtype=torch.float64,
                                 admm_iters=admm_iters, admm_rho=admm_rho)
    piv = C.argmax(dim=1)
    Y = _snapshots(seed + 1, m=3)[piv].T.contiguous()
    return sensor, Y, 0.01 * torch.ones_like(Y)


def _fit(**kw):
    return spr_end_to_end(_snapshots(3), _snapshots(4, m=2), N_FEATURES, R,
                          device="cpu", **kw)


def _gpr(device="cpu", dtype=torch.float64):
    """A fitted tiny GP ROM: 8 snapshots at 8 points of (D, H2, φ), 4
    modes, and 2 held-out points."""
    X = _snapshots(5, device=device).to(dtype)
    rng = np.random.default_rng(5)
    xyz = rng.random((N_POINTS, 2))
    P = torch.as_tensor(rng.random((M, 3)), dtype=dtype, device=device)
    gpr = GPR(X, N_FEATURES, xyz, P, device=device)
    gpr.fit(select_modes="number", n_modes=R)
    return gpr, P[:2] + 0.05


def _gpr_flow(max_iter):
    gpr, Pt = _gpr()
    gpr.train(max_iter=max_iter, rel_error=0.0)
    A, A_sigma = gpr.predict(Pt)
    return A, A_sigma, gpr.reconstruct(A)


def _children(rec, i):
    return [j for j, s in enumerate(rec.spans) if s.parent == i]


def _check_tree(rec):
    """Every span closed, inside its parent, with its root's call id."""
    for i, s in enumerate(rec.spans):
        assert 0 < s.start_ns <= s.end_ns
        if s.parent < 0:
            assert s.call == i
        else:
            p = rec.spans[s.parent]
            assert s.parent < i and s.call == p.call
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


@pytest.mark.parametrize("flow", ["predict_batch", "spr_end_to_end", "gpr"])
def test_off_records_nothing(flow, monkeypatch):
    """Off: no clock read, no span begun, no counter, and every ``span``
    is the one shared no-op context."""
    def boom(*a, **k):
        raise AssertionError("the recorder worked while off")
    monkeypatch.setattr(tlog, "time", types.SimpleNamespace(time_ns=boom))
    monkeypatch.setattr(tlog.Recording, "begin", boom)
    assert tlog.recorder() is None
    assert tlog.span("a") is tlog.span("b")
    if flow == "predict_batch":
        sensor, Y, S = _sensor(3)
        sensor.predict_batch(Y, S)
    elif flow == "gpr":
        _gpr_flow(5)
    else:
        _fit()
    assert tlog.recorder() is None


@pytest.mark.parametrize("admm_rho", ["adaptive", "fixed"])
@pytest.mark.parametrize("k", [1, 7])
def test_cols_batch_spans(k, admm_rho):
    """A COLS batch: one ``serve.predict_batch`` root over
    ``serve.solve``, one ``boxls.admm`` holding ``k`` ``boxls.iter`` and
    ``serve.reconstruct``, in that order; no counter (serving reads
    nothing back)."""
    sensor, Y, S = _sensor(k, admm_rho)
    with tlog.recording() as rec:
        sensor.predict_batch(Y, S)
    _check_tree(rec)
    assert rec.spans[0].name == "serve.predict_batch"
    assert [s.parent for s in rec.spans].count(-1) == 1
    top = [rec.spans[j].name for j in _children(rec, 0)]
    assert top == ["serve.solve", "boxls.admm", "serve.reconstruct"]
    admm = _children(rec, 0)[1]
    assert [rec.spans[j].name for j in _children(rec, admm)] == \
        ["boxls.iter"] * k
    assert len(rec.spans) == 4 + k
    assert rec.counters == {}


@pytest.mark.parametrize("refine", [0, 1, 2])
def test_fit_stage_spans(refine):
    """A fit: its stages in order under one root, one ``svd.eigh`` a
    Gram (1 + refine), and on the CPU no ``host_reads``: nothing is read
    back from a device."""
    with tlog.recording() as rec:
        _fit(refine=refine)
    _check_tree(rec)
    names = [s.name for s in rec.spans]
    svd = ["svd.gram", "svd.eigh", "svd.panel"] * (1 + refine)
    assert names == ["fit.spr_end_to_end", "fit.scale", *svd, "fit.place",
                     "fit.solve"]
    assert all(s.parent == 0 for s in rec.spans[1:])
    assert rec.counters == {}


def test_kernel_launch_counter():
    """The one launch counter of the hand-written kernels counts only
    while the recorder is on, as ``<kernel>.kernel_launches``; during a
    graph's capture it fills the capture's tally instead, which each
    replay adds again."""
    tlog.launched("chol")
    with tlog.recording() as rec:
        tlog.launched("chol")
        tlog.launched("qrcp")
        tlog.launched("admm", 2 * 300)
        tlog.launched("gp_step")
        tlog.launched("chol")
        with tlog.capture_tally() as tally:
            tlog.launched("chol")
            tlog.launched("gp_step")
            tlog.count("gp.fused_iters")
        assert rec.counters == {"chol.kernel_launches": 2,
                                "qrcp.kernel_launches": 1,
                                "admm.kernel_launches": 600,
                                "gp_step.kernel_launches": 1}
        for _ in range(3):
            tlog.count_all(tally)
    assert tally == {"chol.kernel_launches": 1, "gp_step.kernel_launches": 1,
                     "gp.fused_iters": 1}
    assert rec.counters == {"chol.kernel_launches": 5,
                            "qrcp.kernel_launches": 1,
                            "admm.kernel_launches": 600,
                            "gp_step.kernel_launches": 4,
                            "gp.fused_iters": 3}
    tlog.launched("qrcp")
    tlog.count_all(tally)
    assert tlog.recorder() is None
    assert rec.counters["qrcp.kernel_launches"] == 1


@pytest.mark.parametrize("max_iter", [1, 4, 10])
def test_gpr_flow_spans(max_iter):
    """A GP ROM flow: one root span a method, in order; ``gpr.train``
    holds ``gp.adam``, which holds one ``gp.iter`` an Adam iteration
    (``rel_error = 0``: every model runs all ``max_iter``);
    ``gpr.predict`` holds one ``gp.posterior``.  On the CPU neither
    ``host_reads`` nor ``chol.kernel_launches``: no card is read, no
    kernel launched."""
    gpr, Pt = _gpr()
    with tlog.recording() as rec:
        gpr.fit(select_modes="number", n_modes=R)
        gpr.train(max_iter=max_iter, rel_error=0.0)
        A, _ = gpr.predict(Pt)
        gpr.reconstruct(A)
    _check_tree(rec)
    roots = [i for i, s in enumerate(rec.spans) if s.parent < 0]
    assert [rec.spans[i].name for i in roots] == [
        "gpr.fit", "gpr.train", "gpr.predict", "gpr.reconstruct"]
    fit, train, predict, rebuild = roots
    svd = [rec.spans[j].name for j in _children(rec, fit)]
    assert svd and svd == ["svd.gram", "svd.eigh", "svd.panel"] * (
        len(svd) // 3)
    (adam,) = _children(rec, train)
    assert rec.spans[adam].name == "gp.adam"
    iters = [rec.spans[j].name for j in _children(rec, adam)]
    assert iters == ["gp.iter"] * max_iter
    assert gpr._iterations.tolist() == [max_iter] * R
    assert [rec.spans[j].name for j in _children(rec, predict)] == \
        ["gp.posterior"]
    assert _children(rec, rebuild) == []
    assert rec.counters == {}


@pytest.mark.parametrize("flow", ["predict_batch", "spr_end_to_end", "gpr"])
def test_recorded_outputs_identical(flow):
    if flow == "predict_batch":
        sensor, Y, S = _sensor(5)
        run = lambda: sensor.predict_batch(Y, S)          # noqa: E731
    elif flow == "gpr":
        run = lambda: _gpr_flow(6)                        # noqa: E731
    else:
        run = _fit
    plain = run()
    with tlog.recording() as rec:
        recorded = run()
    assert rec.spans
    for a, b in zip(plain, recorded):
        assert torch.equal(a, b)


def test_spans_on_profiler_clock():
    """With ``torch.profiler`` recording the host around a recorded
    batch, every ``aten::`` operator of the call lies inside the root
    span: the spans and the profiler's events share one clock."""
    from torch.profiler import ProfilerActivity, profile
    sensor, Y, S = _sensor(3)
    sensor.predict_batch(Y, S)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tlog.recording() as rec:
            sensor.predict_batch(Y, S)
    root = rec.spans[0]
    ops = [(e.start_ns(), e.end_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith("aten::")]
    assert len(ops) > 20
    assert all(root.start_ns <= s and e <= root.end_ns for s, e in ops)


def test_span_closed_on_error():
    """An exception closes its span and those it left open inside it."""
    with tlog.recording() as rec:
        with pytest.raises(ValueError):
            with tlog.span("outer"):
                rec.begin("left open")
                raise ValueError
        with tlog.span("after"):
            pass
    outer, left, after = rec.spans
    assert outer.end_ns > 0 and left.end_ns == 0
    assert after.parent == -1 and after.call == 2


@pytest.mark.cuda
def test_fit_host_reads_on_card():
    """On the card, ``host_reads`` counts each read of a fit that the host
    waits on: as many as the sync debug mode warns of, one an eigh."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: host reads are reads of the card")
    dev = torch.device("cuda")
    X = _snapshots(3, device=dev).float()
    Xt = _snapshots(4, m=2, device=dev).float()
    for refine in (1, 2):
        spr_end_to_end(X, Xt, N_FEATURES, R, refine=refine, device=dev)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught, \
                    tlog.recording() as rec:
                warnings.simplefilter("always")
                spr_end_to_end(X, Xt, N_FEATURES, R, refine=refine,
                               device=dev)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        syncs = [w for w in caught if "synchroniz" in str(w.message)]
        assert rec.counters.get("host_reads", 0) == len(syncs) == 1 + refine


@pytest.mark.cuda
@pytest.mark.parametrize("max_iter, rel_error", [(10, 0.0), (1000, 1e-5)])
def test_gp_training_host_reads_on_card(max_iter, rel_error):
    """On the card, a GP training's ``host_reads`` are its Adam loop's
    stop tests, each read one block behind the newest (so each also a
    ``gp.overlapped_reads``): none before the second block is enqueued,
    then one before each further block and one more where every model
    stopped before ``max_iter``.  None drains the stream: the sync debug
    mode warns of no synchronization in the whole training.
    ``chol.kernel_launches`` is one an iteration enqueued, and a
    ``predict`` launches none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: host reads are reads of the card")
    gpr, Pt = _gpr(torch.device("cuda"), torch.float32)
    gpr.train(max_iter=8, rel_error=rel_error)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught, \
                tlog.recording() as rec:
            warnings.simplefilter("always")
            gpr.train(max_iter=max_iter, rel_error=rel_error)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    steps = sum(s.name == "gp.iter" for s in rec.spans)
    blocks = -(-steps // 4)
    reads = blocks - 1 if steps < max_iter else max(blocks - 2, 0)
    assert rec.counters["host_reads"] == \
        rec.counters["gp.overlapped_reads"] == reads
    assert syncs == []
    assert rec.counters["chol.kernel_launches"] == steps
    with tlog.recording() as rec:
        gpr.predict(Pt)
    assert "chol.kernel_launches" not in rec.counters


def _adam_problem(B=6, p=20, d=3, seed=0):
    """A float64 CPU batch of B single-task GPs (constant mean, scaled
    Matérn-2.5) on p points, parameters scattered about their initial
    values: ``(loss_fn, params0, value_and_grad)``."""
    rng = np.random.default_rng(seed)
    X = torch.as_tensor(rng.uniform(-1.5, 1.5, (p, d)))
    Y = torch.as_tensor(rng.standard_normal((B, p)))
    mean, kern = GK.ConstantMean(), GK.ScaleKernel(GK.MaternKernel(2.5))
    lik = GK.GaussianLikelihood()
    like = dict(dtype=torch.float64)
    p0 = {"mean": mean.init_params(d, **like),
          "kernel": kern.init_params(d, **like),
          "likelihood": lik.init_params(**like)}
    params0 = E.tree_map(lambda x: x + 0.3 * torch.as_tensor(
        rng.standard_normal((B,) + tuple(x.shape))), p0)
    return (E.make_single_task_loss(mean, kern, lik, X, Y), params0,
            E.make_single_task_value_and_grad(mean, kern, lik, X, Y))


def _blockwise(loss_fn, params0, vag, max_iter, rel_error, table):
    """The Adam loop stepped eagerly with ``all(converged)`` read before
    every block of 4 (the bias corrections from the card's table where
    ``table``): ``((leaves, losses, iterations), iterations enqueued)``."""
    run = E._OracleRun(functools.partial(
        E._adam_step, functools.partial(E._grads_at, params0, loss_fn, vag),
        lr=0.1, rel_error=rel_error),
        [t.clone() for t in E.tree_leaves(params0)],
        max_iter if table else None)
    j = 0
    while j < max_iter and not bool(torch.all(run.conv)):
        for _ in range(min(4, max_iter - j)):
            run.step()
            j += 1
    return run.result(), j


def _same_training(res, want):
    (leaves, loss, iters) = want
    for a, b in zip(E.tree_leaves(res.params), leaves):
        assert torch.equal(a, b)
    assert torch.equal(res.loss, loss)
    assert torch.equal(res.iterations, iters)


LOOPS = [pytest.param(10, 0.0, id="no-stop"),
         pytest.param(60, 2e-3, id="stops")]


@pytest.mark.parametrize("max_iter, rel_error", LOOPS)
def test_gp_loop_on_the_cpu_reads_as_before(max_iter, rel_error):
    """On the CPU the Adam loop keeps its schedule: ``all(converged)``
    read before every block of 4, one ``gp.iter`` span an iteration, no
    ``gp.overlapped_reads`` (nor ``host_reads``: no card is read), and the
    results of the loop stepped block by block."""
    loss_fn, params0, vag = _adam_problem()
    with tlog.recording() as rec:
        res = E.adam_early_stop(loss_fn, params0, max_iter=max_iter,
                                rel_error=rel_error, value_and_grad=vag)
    want, enqueued = _blockwise(loss_fn, params0, vag, max_iter, rel_error,
                                table=False)
    _same_training(res, want)
    iters = res.iterations.tolist()
    if max_iter == 10:
        assert iters == [10] * 6
    else:            # models stop on different iterations, before max_iter
        assert len(set(iters)) > 1 and max(iters) + 8 <= max_iter
    assert sum(s.name == "gp.iter" for s in rec.spans) == enqueued
    assert rec.counters == {}


@pytest.mark.parametrize("max_iter, rel_error", LOOPS)
def test_gp_loop_reads_one_block_behind_where_it_captures(
        monkeypatch, max_iter, rel_error):
    """The schedule of a loop that captures (on the card), run on the CPU
    with stand-ins for what only the card has (the streams, a block's CUDA
    graph, the events): the host enqueues the next block before it
    reads the last one's stop flags, so it enqueues one block more than
    the loop that reads before every block, never past ``max_iter``;
    every stop test is an overlapped read; the trained models are the
    same, bit for bit."""
    class Event:        # the CPU's copies are done once enqueued
        def record(self):
            pass

        def synchronize(self):
            pass

    class Stream:
        def __init__(self, device, priority=0):
            pass

        def wait_event(self, event):
            pass
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(torch.Tensor, "record_stream",
                        lambda self, stream: None)
    monkeypatch.setattr(E, "_side_stream",
                        lambda like: contextlib.nullcontext())
    monkeypatch.setattr(E, "_Replay",
                        lambda block: types.SimpleNamespace(step=block))
    loss_fn, params0, vag = _adam_problem()
    captures = functools.partial(vag)
    captures.capturable = True
    with tlog.recording() as rec:
        res = E.adam_early_stop(loss_fn, params0, max_iter=max_iter,
                                rel_error=rel_error, value_and_grad=captures)
    want, enqueued = _blockwise(loss_fn, params0, vag, max_iter, rel_error,
                                table=True)
    _same_training(res, want)
    steps = sum(s.name == "gp.iter" for s in rec.spans)
    assert steps == min(enqueued + 4, max_iter)
    if max_iter == 60:
        assert enqueued + 4 < max_iter      # the spare block was enqueued
    blocks = -(-steps // 4)
    reads = blocks - 1 if steps < max_iter else max(blocks - 2, 0)
    assert rec.counters == {"host_reads": reads,
                            "gp.overlapped_reads": reads}
