"""Greedy column-pivoted QR pivots, plain PyTorch (port of
``openmeasure_tpu/linalg/qrcp.py``).

Only the first ``k`` pivot indices are consumed (they become the one-hot
rows of the measurement matrix C), so the primitive is greedy norm
pivoting: k sequential steps, each an argmax over the n column norms
(ties to the LOWEST index, LAPACK's and ``jnp.argmax``'s rule, which
``torch.argmax`` shares) followed by a norm downdate.

Read-only left-looking CGS2: each accepted direction ``q_i`` is orthogonal
to the previous ones, so ``q_iᵀ(I − QQᵀ)A = q_iᵀA`` — the panel is never
written; each step reads A once for the projection row, and the deflated
pivot column is recovered from the original column by two Gram-Schmidt
passes against the small (r, k) block Q.

This is the plain version of the CUDA kernel in ``qrcp_cuda`` (its oracle
on the card and the path every CPU tensor takes).  It stays on the device
it is given: no host synchronization per step.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _rowsum(terms) -> torch.Tensor:
    """Sequential sum of an iterable of equally shaped tensors, one
    separately rounded add at a time, starting from zero."""
    acc = None
    for t in terms:
        acc = torch.zeros_like(t) + t if acc is None else acc + t
    return acc


def _sweep(A: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k-step sweep; returns ``(pivots int32 (k,), final deflated
    norms² (n,))`` — the norms (−inf at the pivots) let a caller compare
    this version's arithmetic with the kernel's.

    Every sum runs sequentially in a fixed order (over rows for the norms,
    the projections and the Gram-Schmidt coefficients, over accepted
    directions for the update) from separately rounded products: the
    CUDA kernel follows the same rounding sequence, so on the card the two
    agree bit for bit.  That matters because late greedy steps compare
    deflated norms that are small differences of large ones, where
    round-off alone can decide the argmax."""
    r, n = A.shape
    rows = range(r)
    norms2 = _rowsum(A[i] * A[i] for i in rows)
    tiny = torch.finfo(A.dtype).tiny
    Q = torch.zeros((r, k), dtype=A.dtype, device=A.device)
    pivots = torch.zeros((k,), dtype=torch.int32, device=A.device)
    for i in range(k):
        j = torch.argmax(norms2).reshape(1)      # stays on the device
        col = A.index_select(1, j)[:, 0]
        # two Gram-Schmidt passes (CGS2) against the i accepted directions
        for _ in range(2 if i else 0):
            coef = _rowsum(Q[m, :i] * col[m] for m in rows)
            col = col - _rowsum(Q[:, c] * coef[c] for c in range(i))
        ss = _rowsum(col[m] * col[m] for m in rows)
        q = col / torch.sqrt(torch.clamp(ss, min=tiny))
        proj = _rowsum(q[m] * A[m] for m in rows)   # read-only panel pass
        norms2 = norms2 - proj * proj
        norms2.index_fill_(0, j, float("-inf"))  # never re-pick
        Q[:, i] = q
        pivots[i:i + 1] = j.to(torch.int32)
    return pivots, norms2


def qrcp_pivots(A: torch.Tensor, k: int) -> torch.Tensor:
    """First ``k`` column pivots of A (r, n), LAPACK-geqp3-equivalent up to
    floating-point ties.  Returns int32 pivot indices, shape (k,)."""
    return _sweep(A, k)[0]


def pivots_to_onehot(pivots: torch.Tensor, n: int) -> torch.Tensor:
    """The one-hot measurement matrix C (s, n), float32, from pivot
    indices."""
    cols = torch.arange(n, device=pivots.device)
    return (cols[None, :] == pivots.long()[:, None]).to(torch.float32)
