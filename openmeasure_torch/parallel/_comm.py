"""Collective helpers of the sharded paths: one mesh axis as this rank sees
it, row ranges, all-reduces that are the identity on a one-rank axis, the
cross-rank argmax with the unsharded code's tie rule, row gathers.

The JAX package shards by GSPMD: arrays are global and XLA inserts the
collectives.  Here each rank holds its own rows and every collective is
written out, on local tensors, through ``torch.distributed``.  Only
collectives that both NCCL and gloo take on CUDA tensors are used:
``all_reduce`` (SUM, MAX, MIN), ``broadcast`` and list-form
``all_gather``.  NCCL and gloo hand every rank the same bits of an
all-reduce, so a host decision taken from a reduced value (a stop test, a
scalar read) is the same on every rank, and no rank leaves a loop the
others stay in.

On an axis of one rank every helper returns its input unchanged and
launches nothing, so a world of size 1 runs the unsharded code's
operations and launch counts.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist


def row_range(n: int, size: int, rank: int) -> Tuple[int, int, int]:
    """Rank ``rank``'s rows of ``n`` split over ``size`` ranks in contiguous
    blocks of ``per = ceil(n / size)``: ``(start, stop, per)``.  The last
    ranks hold fewer real rows (possibly none) when ``size`` does not
    divide ``n``; a padded layout fills each to ``per``."""
    per = -(-n // size)
    start = min(n, rank * per)
    return start, min(n, start + per), per


class Axis:
    """One axis of a mesh as this rank sees it: its process group, its
    size, this rank's index on it and the device of the mesh.

    ``Axis.collectives`` counts the collectives issued (on axes of more
    than one rank), for a caller that reports how many a call makes."""

    collectives = 0

    def __init__(self, group, size: int, rank: int, device: torch.device):
        self.group, self.size, self.rank, self.device = (group, int(size),
                                                         int(rank), device)

    @classmethod
    def of(cls, mesh, name: str) -> "Axis":
        check_mesh(mesh)
        group = mesh.get_group(name)
        dev = torch.device(mesh.device_type)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        return cls(group, dist.get_world_size(group),
                   mesh.get_local_rank(name), dev)

    # ------------------------------------------------------------ #

    def _reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        if self.size == 1:
            return x
        y = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=op, group=self.group)
        Axis.collectives += 1
        return y

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.SUM)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.MAX)

    def min(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.MIN)

    def all(self, flag: bool) -> bool:
        """True when ``flag`` holds on every rank (one host read)."""
        if self.size == 1:
            return bool(flag)
        t = torch.tensor([1 if flag else 0], dtype=torch.int32,
                         device=self.device)
        return bool(self.min(t).item())

    def gather(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``x`` (same shape on each), in rank order."""
        if self.size == 1:
            return [x]
        x = x.detach().contiguous()
        out = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(out, x, group=self.group)
        Axis.collectives += 1
        return out

    def gather_cat(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim``, in rank order; the
        ranks' sizes along ``dim`` may differ (one extra gather of the
        sizes)."""
        if self.size == 1:
            return x
        x = torch.movedim(x, dim, 0)
        sizes = self.gather(torch.tensor([x.shape[0]], dtype=torch.int64,
                                         device=x.device))
        sizes = [int(s) for s in torch.cat(sizes).tolist()]
        top = max(sizes)
        pad = x.new_zeros((top - x.shape[0],) + tuple(x.shape[1:]))
        parts = self.gather(torch.cat([x, pad], dim=0))
        out = torch.cat([p[:s] for p, s in zip(parts, sizes)], dim=0)
        return torch.movedim(out, 0, dim)

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` of the axis's first rank on every rank (in place into
        ``x``, which must have the right shape and dtype everywhere)."""
        if self.size == 1:
            return x
        dist.broadcast(x, src=dist.get_global_rank(self.group, 0),
                       group=self.group)
        Axis.collectives += 1
        return x


def check_mesh(mesh) -> None:
    """Raise ``TypeError`` unless ``mesh`` is a ``DeviceMesh`` with the
    port's named axes."""
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(
            "mesh must be a torch.distributed DeviceMesh from "
            "openmeasure_torch.parallel.make_mesh (axes 'state' and "
            f"'mode'); got {type(mesh).__name__}.")


def axis_of(mesh, name: str = "state") -> Optional[Axis]:
    """The :class:`Axis` ``name`` of ``mesh``, or ``None`` for no mesh."""
    return None if mesh is None else Axis.of(mesh, name)


def active(axis: Optional[Axis]) -> Optional[Axis]:
    """``axis`` when it spans more than one rank, else ``None``: the
    sharded loops take their unsharded branch on a one-rank axis, so a
    world of size 1 runs the unsharded operations exactly."""
    return axis if axis is not None and axis.size > 1 else None


def norms(axis: Optional[Axis], *vs: torch.Tensor) -> List[torch.Tensor]:
    """Euclidean norms over the last dimension of each row-sharded ``v``,
    with one all-reduce of the squared sums for all of them."""
    if axis is None:
        return [torch.linalg.vector_norm(v, dim=-1) for v in vs]
    ss = torch.stack([torch.sum(v * v, dim=-1) for v in vs])
    return list(torch.sqrt(axis.sum(ss)))


# --------------------------------------------------------------------- #
# Argmax across ranks
# --------------------------------------------------------------------- #

def _winner(vals: torch.Tensor, gidx: torch.Tensor) -> torch.Tensor:
    """Index along dim 0 of the winning candidate, per trailing position:
    a NaN first, else the largest value; ties (and several NaN) to the
    lowest global index — the rule of ``torch.argmax`` on the unsharded
    vector (ROADMAP C.2)."""
    nan = torch.isnan(vals)
    any_nan = torch.any(nan, dim=0, keepdim=True)
    top = torch.where(any_nan, nan,
                      vals == torch.amax(vals, dim=0, keepdim=True))
    return torch.argmin(torch.where(top, gidx, float("inf")), dim=0)


def pick(axis: Optional[Axis], scores: torch.Tensor,
         gidx: Optional[torch.Tensor], *rows: torch.Tensor):
    """The argmax of ``scores`` over every rank's rows and the winning row
    of each tensor in ``rows`` (each (n_local, ...)), all on the device:
    ``(global index (1,) int64, winning score (), [winning rows])``.

    Each rank takes its local argmax; one all-gather of each rank's
    (score, global index, rows) candidate packed in float64 (exact for
    fp32 and fp64 values and for indices below 2⁵³) lets every rank pick
    the same winner by :func:`_winner` and read the winner's rows from the
    gathered candidates — the rows a broadcast from their owner would
    give, with no host read to learn the owner.  With ``axis`` ``None``
    this is the unsharded code's own ``argmax`` and ``index_select``."""
    i = torch.argmax(scores).reshape(1)
    if axis is None:
        return (i, scores.index_select(0, i)[0],
                [r.index_select(0, i)[0] for r in rows])
    parts = [scores.index_select(0, i).to(torch.float64),
             gidx.index_select(0, i).to(torch.float64)]
    parts += [r.index_select(0, i).reshape(-1).to(torch.float64)
              for r in rows]
    allc = torch.stack(axis.gather(torch.cat(parts)))      # (size, L)
    w = _winner(allc[:, 0], allc[:, 1]).reshape(1)
    win = allc.index_select(0, w)[0]
    out, at = [], 2
    for r in rows:
        shape = tuple(r.shape[1:])
        k = 1
        for s in shape:
            k *= s
        out.append(win[at:at + k].reshape(shape).to(r.dtype))
        at += k
    return win[1:2].to(torch.int64), win[0].to(scores.dtype), out


def argmax_cols(axis: Optional[Axis], X: torch.Tensor,
                gidx: Optional[torch.Tensor]) -> torch.Tensor:
    """The entry of largest |.| of each column of the row-sharded ``X``
    (n_local, c), signed, with the tie rule of :func:`_winner`: the
    per-column pick of :func:`..linalg.svd.canonical_signs`."""
    idx = torch.argmax(torch.abs(X), dim=0)
    cols = torch.arange(X.shape[1], device=X.device)
    val = X[idx, cols]
    if axis is None:
        return val
    cand = torch.stack([torch.abs(val).to(torch.float64),
                        gidx[idx].to(torch.float64),
                        val.to(torch.float64)])                 # (3, c)
    allc = torch.stack(axis.gather(cand))                       # (size, 3, c)
    w = _winner(allc[:, 0], allc[:, 1])
    return allc[w, 2, cols].to(X.dtype)


def take_rows(axis: Optional[Axis], X: torch.Tensor,
              gidx: Optional[torch.Tensor], idx: torch.Tensor
              ) -> torch.Tensor:
    """Rows ``idx`` (global indices, (k,)) of the row-sharded ``X``
    (n_local, ...), replicated on every rank: each owner's rows reach the
    others through one all-gather, bit for bit.  ``gidx`` (ascending
    within a rank) maps local rows to global ones."""
    idx = idx.to(torch.int64)
    if axis is None:
        return X.index_select(0, idx)
    pos = torch.clamp(torch.searchsorted(gidx, idx), max=X.shape[0] - 1)
    own = gidx.index_select(0, pos) == idx                       # (k,)
    mine = X.index_select(0, pos)
    mine = torch.where(own.reshape((-1,) + (1,) * (X.ndim - 1)), mine,
                       torch.zeros((), dtype=X.dtype, device=X.device))
    vals = torch.stack(axis.gather(mine))                         # (size, k, ...)
    owner = torch.argmax(torch.stack(axis.gather(own.to(torch.int32))),
                         dim=0)                                   # (k,)
    return vals[owner, torch.arange(idx.shape[0], device=X.device)]


def local_gidx(axis: Axis, n_local: int, device) -> torch.Tensor:
    """Global row indices of this rank's ``n_local`` rows when the ranks'
    blocks are stacked in rank order (one gather of the block sizes)."""
    sizes = torch.cat(axis.gather(torch.tensor([n_local], dtype=torch.int64,
                                               device=device)))
    start = int(torch.sum(sizes[:axis.rank]).item())
    return torch.arange(start, start + n_local, dtype=torch.int64,
                        device=device)


def gather_rows(x: torch.Tensor, mesh, axis_name: str = "state"
                ) -> torch.Tensor:
    """The whole row-sharded array from every rank's real rows (the ranks'
    blocks concatenated in rank order): the counterpart of reading a
    global array in the JAX package, for tests and small cases."""
    return Axis.of(mesh, axis_name).gather_cat(x, dim=0)
