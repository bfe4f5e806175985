"""Faults planted in the program's timed path, to show that ``correct``
catches them: the CPU tests (``tests/test_bench_faults.py``) plant them at
a tiny size, ``readings.py --fault <name>`` on the card at a cell's own.

:func:`plant` patches the program and returns a function that undoes the
patch.  Each fault breaks one thing where it is produced:

- ``coef_altered``: every served frame's leading coefficient off by 1 %;
- ``tenth_altered``: the same in the first tenth of each batch's frames;
- ``half_batch``: half of each batch left out, its frames answered with
  the other half's answers;
- ``rec_altered``: one reconstructed held-out entry of a fit off by 1 %
  of the fields' range;
- ``basis_tilted``: the fit's leading mode tilted by 1 % towards a
  direction drawn at random, before the placement sees it;
- ``pivots_reversed``: the placement's pivots handed out in reverse
  order (the same sensors, a non-greedy order);
- ``pivot_swapped``: the placement's last pivot swapped for a row that
  greedy never picks, half the rows away;
- ``step_unchanged``: a GP training step that returns its state
  unchanged;
- ``pred_altered``: every GP prediction's leading coefficient off by
  10 %.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch


def _patch(owner, name: str, make: Callable) -> Callable[[], None]:
    inner = getattr(owner, name)
    setattr(owner, name, make(inner))
    return lambda: setattr(owner, name, inner)


def _served(how):
    """``_predict_math`` with ``how`` applied to its (x, a, σ)."""
    from openmeasure_torch import serving

    def make(inner):
        def broken(*args, **kwargs):
            return how(*(t.clone() for t in inner(*args, **kwargs)))
        return broken
    return _patch(serving, "_predict_math", make)


def _coef(rows):
    def how(x, a, s):
        a[rows(a.shape[0]), 0] *= 1.01
        return x, a, s
    return how


def _tenth(b):
    return slice(0, max(1, b // 10))


def _half(x, a, s):
    h = x.shape[0] // 2
    for t in (x, a, s):
        t[h:2 * h] = t[:h]
    return x, a, s


def _fit_result(how):
    from openmeasure_torch import pipelines

    def make(inner):
        def broken(*args, **kwargs):
            return how(inner(*args, **kwargs))
        return broken
    return _patch(pipelines, "spr_end_to_end", make)


def _rec_altered(res):
    X = res.X_rec.clone()
    X[0, 0] += 0.01 * (X.max() - X.min())
    return res._replace(X_rec=X)


def _basis_tilted():
    from openmeasure_torch.linalg import svd

    def make(inner):
        def broken(*args, **kwargs):
            B, S, V = inner(*args, **kwargs)
            g = torch.Generator(device=B.device)
            g.manual_seed(12345)
            d = torch.randn(B.shape[0], generator=g, dtype=B.dtype,
                            device=B.device)
            B = B.clone()
            B[:, 0] += 0.01 * torch.linalg.vector_norm(B[:, 0]) \
                * d / torch.linalg.vector_norm(d)
            return B, S, V
        return broken
    return _patch(svd, "svd_tall", make)


def _swap_last(piv, n):
    piv = piv.clone()
    cand = (int(piv[-1]) + n // 2) % n
    while bool((piv == cand).any()):
        cand = (cand + 1) % n
    piv[-1] = cand
    return piv


def _step_unchanged():
    from openmeasure_torch.gp import exact_gp

    def make(inner):
        def stuck(loss_fn, params0, **kw):
            losses = loss_fn(params0).detach()
            n = torch.ones_like(losses, dtype=torch.int32)
            return exact_gp.TrainResult(params0, losses, n)
        return stuck
    return _patch(exact_gp, "adam_early_stop", make)


def _pred_altered():
    from openmeasure_torch.gp.gpr import GPR

    def make(inner):
        def broken(*args, **kwargs):
            A, S = inner(*args, **kwargs)
            A = A.clone()
            A[:, 0] *= 1.1
            return A, S
        return broken
    return _patch(GPR, "predict", make)


def _pivots(how):
    """The placement's pivots changed by ``how(pivots, n_rows)``; the
    panel it is handed is (r, n)."""
    from openmeasure_torch import pipelines

    def make(inner):
        def broken(Bt, k, *args, **kwargs):
            return how(inner(Bt, k, *args, **kwargs), Bt.shape[1])
        return broken
    return _patch(pipelines, "qrcp_pivots_auto", make)


FAULTS: Dict[str, Callable[[], Callable[[], None]]] = {
    "coef_altered": lambda: _served(_coef(lambda b: slice(None))),
    "tenth_altered": lambda: _served(_coef(_tenth)),
    "half_batch": lambda: _served(_half),
    "rec_altered": lambda: _fit_result(_rec_altered),
    "basis_tilted": _basis_tilted,
    "pivots_reversed": lambda: _pivots(lambda p, n: p.flip(0)),
    "pivot_swapped": lambda: _pivots(_swap_last),
    "step_unchanged": _step_unchanged,
    "pred_altered": _pred_altered,
}


def plant(name: str) -> Callable[[], None]:
    """Plant the fault ``name`` in the program; returns its undo."""
    if name not in FAULTS:
        raise KeyError(f"no fault named {name!r}; there are "
                       f"{', '.join(sorted(FAULTS))}")
    return FAULTS[name]()
