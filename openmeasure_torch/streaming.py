"""Out-of-core snapshot ingestion and the streaming POD fit (port of
``openmeasure_tpu/streaming.py``).

A snapshot set larger than host RAM or device memory never sits whole in
either: the Gram-route SVD needs only row-chunk passes over the tall
(n, m) panel, so the whole ROM fit runs with fixed-size host buffers and a
tiny (m, m) spectral problem in host float64.

Components
----------
* :class:`NpyMatrixStore` / :class:`NpyColumnStore` — row-chunk readers over
  the two on-disk layouts (one C-order (n, m) matrix file, or m
  per-snapshot column files, the reference's 3D layout).  Reads go through
  the port's native loader (``native/npyloader.cpp``, built with g++ at
  first use).  A file in a format the loader does not take (another dtype,
  Fortran order, another shape) is read through a numpy memmap, the plain
  version; any other failure of the loader (open, read, bounds) raises.
  Documented deviation: the JAX package falls back to numpy on every
  loader error and hides an open or read failure behind numpy's.
* :func:`iter_chunks` — a reader thread keeps ``prefetch`` chunks ahead
  through a bounded queue; ctypes releases the GIL for the loader's whole
  read, so a read may run beside the caller's compute (how much of it
  does is measured by ``chip_smoke.py``'s overlap check).  Its errors
  surface in the consumer, and a generator closed early stops it.
* :class:`StreamingROM` and the streaming SPR, GPR, PIGPR and DMD — the
  in-core classes' post-fit API over a :class:`SnapshotStore`.

The fit (``StreamingROM.fit``)
------------------------------
1. **Statistics** (host float64, one pass): row means, per-feature-block
   power sums and extrema, and on the host engine the raw per-block Grams
   as well, from which the scaled, centred Gram follows by algebra (no
   second pass, :func:`_gram_from_block_stats`).  A cancellation check
   falls back to one streamed centred-Gram pass when an offset dominates
   a block.  ``median`` adds exact histogram-refinement selection passes
   (:func:`_block_medians`).
2. **U**: ``U[rows] = x0_chunk @ V[:, :r]``; the column norms give
   ``Sigma_r``, then the eps·max·√n norm floor and the canonical signs
   (:func:`_finalize_basis`).

Two engines:

* ``'host'`` (the default): the Gram and the U pass in host float64 BLAS
  while chunks stream; the card sees one (n, r) upload at the end.  These
  passes stay on the host by design: they set the numbers, and the pass
  count is part of the contract (moment-based scale types fit in two disk
  passes).
* ``'device'``: every chunk is uploaded from a ring of pinned host buffers
  on a side stream (the next chunk's copy overlaps the current chunk's
  product), its Gram computed on the model's device in full fp32 and read
  back once a chunk into a host float64 sum, as the JAX code does; then
  ``refine`` width-limited orthogonal-iteration passes and a scatter of U
  into one (n, r) device buffer.  The reader thread waits on a buffer's
  copy event before it fills that buffer again.

The sharded fit (``fit(mesh=...)``, host engine only): every rank of the
mesh's ``state`` axis calls it with the same source.  The axis's first
rank runs the stats, Gram and U passes in host float64, exactly as the
unsharded host engine does; the replicated results (V, S², r, the column
norms, the fused flag, the block scales) are broadcast, and each (n/k, r)
row slice of the U panel, with its rows of ``X_cnt`` and ``X_scl``, is
broadcast from that rank the moment the stream completes it, and kept by
its owner.  :func:`_finalize_sharded_u` then normalizes and picks the
canonical signs on the shards.  So ``Ur``, ``Sigma_r`` and ``Ar`` equal
the unsharded fit's bit for bit; each rank holds its rows of ``Ur``,
``X_cnt`` and ``X_scl`` (documented deviation: the JAX package holds one
global sharded array).  The post-fit methods run on the shards:
``update_basis`` reads each rank's rows of the new snapshots and updates
by the CholQR form, ``CPOD`` and the COLS ``predict`` split their box and
``constraints`` rows over the ranks, the placements take a cross-rank
argmax.
"""

from __future__ import annotations

import os
import queue
import threading
import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import native as _native
from .core import scaling as _scaling
from .core.device import DeviceLike, as_tensor, resolve_device, to_numpy
from .core.device import to_numpy_once
from .dynamics.dmd import DMD as _DMD_base
from .gp.gpr import GPR, PIGPR
from .linalg import boxls as _boxls
from .linalg import svd as _svd
from .rom.rom import ROM, influence_candidate
from .sensing.spr import SPR
from .parallel._comm import Axis, active, argmax_cols, row_range

__all__ = [
    "SnapshotStore", "NpyMatrixStore", "NpyColumnStore", "ArrayStore",
    "open_store", "default_chunk_rows", "iter_chunks", "StreamingROM",
    "StreamingSPR", "StreamingGPR", "StreamingPIGPR", "StreamingDMD",
]


_TORCH_DTYPES = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.float64): torch.float64}
_NP_DTYPES = {v: k for k, v in _TORCH_DTYPES.items()}


# --------------------------------------------------------------------- #
# Stores
# --------------------------------------------------------------------- #

class SnapshotStore:
    """Row-chunk access to an on-disk ``(n, m)`` snapshot matrix.

    Subclasses provide ``shape`` and :meth:`read_rows`, which writes into
    ``out`` (a C-contiguous (nrows, m) array of ``dtype``, such as a view
    of pinned host memory) when it is given.  ``ndim`` makes the store
    duck-type as an array for shape validation in ``SPR.train``."""

    shape: Tuple[int, int]
    ndim = 2

    def read_rows(self, row0: int, nrows: int, dtype=np.float32,
                  out: Optional[np.ndarray] = None) -> np.ndarray:
        raise NotImplementedError


def _into(rows: np.ndarray, out: Optional[np.ndarray]) -> np.ndarray:
    if out is None:
        return rows
    out[...] = rows
    return out


def _probe_npy(path: str) -> Tuple[int, Tuple[int, int]]:
    """(itemsize, (n, m)) of a .npy file; 1-D files report m = 1."""
    try:
        item, shape, _ = _native.npy_probe(path)
        return item, shape
    except _native.NpyUnsupported:
        pass                      # a format the loader does not take
    arr = np.load(path, mmap_mode="r")
    if arr.ndim == 1:
        return arr.dtype.itemsize, (arr.shape[0], 1)
    if arr.ndim != 2:
        raise ValueError(f"{path}: expected a 1-D or 2-D .npy, got "
                         f"{arr.ndim}-D")
    return arr.dtype.itemsize, arr.shape


class NpyMatrixStore(SnapshotStore):
    """One C-order ``(n, m)`` .npy matrix file; a row chunk is a single
    contiguous ``pread``."""

    def __init__(self, path: str):
        self.path = os.fspath(path)
        _, self.shape = _probe_npy(self.path)

    def read_rows(self, row0, nrows, dtype=np.float32, out=None):
        try:
            return _native.read_rows_matrix(self.path, row0, nrows,
                                            self.shape[1], dtype, out)
        except _native.NpyUnsupported:
            pass
        arr = np.load(self.path, mmap_mode="r")
        rows = np.asarray(arr[row0:row0 + nrows], dtype=dtype)
        return _into(rows.reshape(nrows, self.shape[1]), out)


class NpyColumnStore(SnapshotStore):
    """m per-snapshot column files (each ``(n,)`` or ``(n, 1)``), the
    reference 3D dataset's on-disk layout.  A row chunk gathers one slice
    from every file (native: an OpenMP scatter transpose)."""

    def __init__(self, paths: Sequence[str]):
        self.paths = [os.fspath(p) for p in paths]
        if not self.paths:
            raise ValueError("NpyColumnStore needs at least one file")
        n = None
        for p in self.paths:
            _, (ni, mi) = _probe_npy(p)
            if mi != 1:
                raise ValueError(f"{p}: column files must be (n,) or (n, 1); "
                                 f"got {ni}x{mi}")
            if n is None:
                n = ni
            elif ni != n:
                raise ValueError(f"{p}: inconsistent length {ni} != {n}")
        self.shape = (n, len(self.paths))

    def read_rows(self, row0, nrows, dtype=np.float32, out=None):
        try:
            return _native.read_rows_files(self.paths, row0, nrows, dtype,
                                           out)
        except _native.NpyUnsupported:
            pass
        if out is None:
            out = np.empty((nrows, len(self.paths)), dtype=dtype)
        for j, p in enumerate(self.paths):
            col = np.load(p, mmap_mode="r")
            out[:, j] = np.asarray(col[row0:row0 + nrows],
                                   dtype=dtype).reshape(-1)
        return out


class ArrayStore(SnapshotStore):
    """In-RAM adapter: the streaming fit (and its tests) run over an
    existing array through the same chunked code path.  A tensor is
    copied to host numpy."""

    def __init__(self, X):
        self.X = to_numpy(X)
        if self.X.ndim != 2:
            raise ValueError("ArrayStore needs a 2-D array")
        self.shape = self.X.shape

    def read_rows(self, row0, nrows, dtype=np.float32, out=None):
        return _into(np.asarray(self.X[row0:row0 + nrows], dtype=dtype), out)


def open_store(source) -> SnapshotStore:
    """Sniff a snapshot source: path → :class:`NpyMatrixStore`, list of
    paths → :class:`NpyColumnStore`, array or tensor →
    :class:`ArrayStore`, store → itself."""
    if isinstance(source, SnapshotStore):
        return source
    if isinstance(source, (str, os.PathLike)):
        return NpyMatrixStore(os.fspath(source))
    if isinstance(source, (list, tuple)) and source and \
            isinstance(source[0], (str, os.PathLike)):
        return NpyColumnStore(source)
    return ArrayStore(source)


# --------------------------------------------------------------------- #
# Prefetching chunk iterator
# --------------------------------------------------------------------- #

def default_chunk_rows(m: int, dtype=np.float32,
                       budget_bytes: int = 64 << 20) -> int:
    """Rows per chunk for a ~64 MiB host buffer."""
    return max(1, budget_bytes // (max(m, 1) * np.dtype(dtype).itemsize))


class _PinnedRing:
    """``k`` pinned host buffers of (chunk_rows, m) that the reader thread
    fills in turn (chunk j into buffer j mod k).  Before it fills a buffer
    again it waits on the event recorded after that buffer's last copy to
    the card: a chunk still in flight is never overwritten."""

    def __init__(self, k: int, chunk_rows: int, m: int, dtype):
        self.chunk_rows = chunk_rows
        self.bufs = [torch.empty((chunk_rows, m), dtype=_TORCH_DTYPES[
            np.dtype(dtype)], pin_memory=True) for _ in range(k)]
        self.views = [b.numpy() for b in self.bufs]
        self.events: List[Optional[torch.cuda.Event]] = [None] * k

    def _slot(self, row0: int) -> int:
        return (row0 // self.chunk_rows) % len(self.bufs)

    def acquire(self, row0: int, nrows: int) -> np.ndarray:
        """The host view to read rows [row0, row0 + nrows) into (reader
        thread); waits until the buffer's previous copy has finished."""
        i = self._slot(row0)
        if self.events[i] is not None:
            self.events[i].synchronize()
        return self.views[i][:nrows]

    def tensor(self, row0: int, nrows: int) -> torch.Tensor:
        return self.bufs[self._slot(row0)][:nrows]

    def release(self, row0: int, event: torch.cuda.Event) -> None:
        """Record the event after the copy out of this chunk's buffer."""
        self.events[self._slot(row0)] = event


def iter_chunks(store: SnapshotStore, chunk_rows: Optional[int] = None,
                dtype=np.float32, prefetch: int = 2,
                ring: Optional[_PinnedRing] = None,
                rows: Optional[Tuple[int, int]] = None):
    """Yield ``(row0, chunk)`` covering all rows, or the rows ``[a, b)``
    of ``rows=(a, b)`` (a rank's block of a sharded model), with a
    background reader thread keeping up to ``prefetch`` chunks ahead
    (``prefetch=0`` reads in the caller's thread).  The native loader
    releases the GIL, so the next chunk's disk read may run beside the
    caller's compute on the current one.  With ``ring`` each chunk is read
    into a pinned buffer of it (the device engine's uploads).  Closing the
    generator early stops the reader promptly; an error in the reader
    surfaces in the consumer."""
    n, m = store.shape
    first, n = (0, n) if rows is None else rows
    if chunk_rows is None:
        chunk_rows = default_chunk_rows(m, dtype)
    chunk_rows = max(1, min(chunk_rows, n - first))

    def read(row0):
        c = min(chunk_rows, n - row0)
        out = ring.acquire(row0, c) if ring is not None else None
        return store.read_rows(row0, c, dtype, out)

    if prefetch < 1:                      # synchronous
        for row0 in range(first, n, chunk_rows):
            yield row0, read(row0)
        return

    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()
    done = object()

    def reader():
        try:
            for row0 in range(first, n, chunk_rows):
                if stop.is_set():
                    return
                chunk = read(row0)
                while not stop.is_set():
                    try:
                        q.put((row0, chunk), timeout=0.1)
                        break
                    except queue.Full:
                        continue
            q.put(done)
        except BaseException as e:  # surfaced in the consumer
            q.put(e)

    t = threading.Thread(target=reader, daemon=True,
                         name="omtorch-chunk-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


# --------------------------------------------------------------------- #
# Streaming statistics (pass 1, host float64)
# --------------------------------------------------------------------- #

_MEDIAN_BINS = 4096
_MEDIAN_COLLECT_LIMIT = 1 << 22      # gather-and-partition threshold
_MEDIAN_EXACT_CAP = 64               # distinct-value counting threshold

# the fused stats+Gram pass keeps one (n_features, m, m) f64 accumulator;
# above this budget (4096 blocks at m = 41) the separate Gram pass runs
# instead of ballooning host memory
_FUSED_GRAM_BYTES_CAP = 512 * 1024 * 1024


def _block_stats_pass(store, n_features, dtype, chunk_rows, need_row_means,
                      prefetch, accumulate_gram=False):
    """One disk pass: per-row means (host n-vector) and per-block power
    sums and extrema in float64.  Blocks are the contiguous
    ``n_points``-row feature slabs; chunks may straddle block boundaries.

    With ``accumulate_gram=True`` the same pass also accumulates the RAW
    per-block Grams ``G_f = X_fᵀX_f`` and column sums ``t_f = X_fᵀ1``, from
    which :func:`_gram_from_block_stats` derives the scaled, centred Gram.
    The row-mean cross terms (``t2_f = Σ c̃_i x_i``, ``sc2_f = Σ c̃_i²``)
    use the centres ROUNDED to the store dtype — the values the U pass and
    ``X_cnt`` use — so the fused Gram describes the matrix the U pass
    projects even for an fp32 store with large offsets."""
    n, m = store.shape
    n_points = n // n_features
    row_means = np.empty(n, dtype=np.float64) if need_row_means else None
    s1 = np.zeros(n_features)
    s2 = np.zeros(n_features)
    s3 = np.zeros(n_features)
    s4 = np.zeros(n_features)
    bmin = np.full(n_features, np.inf)
    bmax = np.full(n_features, -np.inf)
    G_blocks = t_blocks = t2_blocks = sc2_blocks = None
    if accumulate_gram:
        G_blocks = np.zeros((n_features, m, m), dtype=np.float64)
        t_blocks = np.zeros((n_features, m), dtype=np.float64)
        t2_blocks = np.zeros((n_features, m), dtype=np.float64)
        sc2_blocks = np.zeros(n_features, dtype=np.float64)

    for row0, chunk in iter_chunks(store, chunk_rows, dtype, prefetch):
        c = chunk.astype(np.float64, copy=False)
        if need_row_means:
            row_means[row0:row0 + chunk.shape[0]] = c.mean(axis=1)
        r = row0
        end = row0 + chunk.shape[0]
        while r < end:
            f = r // n_points
            r_stop = min(end, (f + 1) * n_points)
            seg = c[r - row0:r_stop - row0]
            s1[f] += seg.sum()
            sq = seg * seg
            s2[f] += sq.sum()
            s3[f] += (sq * seg).sum()
            s4[f] += (sq * sq).sum()
            bmin[f] = min(bmin[f], seg.min())
            bmax[f] = max(bmax[f], seg.max())
            if accumulate_gram:
                G_blocks[f] += seg.T @ seg
                t_blocks[f] += seg.sum(axis=0)
                if need_row_means:
                    cr = seg.mean(axis=1).astype(dtype).astype(np.float64)
                    t2_blocks[f] += cr @ seg
                    sc2_blocks[f] += float(cr @ cr)
            r = r_stop
    cnt = float(n_points * m)
    return {"row_means": row_means, "s1": s1, "s2": s2, "s3": s3, "s4": s4,
            "min": bmin, "max": bmax, "count": cnt,
            "G_blocks": G_blocks, "t_blocks": t_blocks,
            "t2_blocks": t2_blocks, "sc2_blocks": sc2_blocks}


def _gram_from_block_stats(stats, scl_blocks, axis_cnt, n_points, dtype):
    """Scaled, centred Gram ``X0ᵀX0`` assembled from the raw per-block
    Grams of the fused stats pass, with no second disk pass.

    Per feature block f, with ``c̃``/``μ̃``/``scl̃`` the store-dtype-rounded
    statistics:

    * ``axis_cnt=1``: ``Gc_f = G_f − (1 t2_fᵀ + t2_f 1ᵀ) + sc2_f·1 1ᵀ``
    * ``axis_cnt=None``: ``Gc_f = G_f − μ̃_f (1 t_fᵀ + t_f 1ᵀ)
      + n_points·μ̃_f²·1 1ᵀ``

    and ``G = Σ_f Gc_f / scl̃_f²``, all (m, m) host float64.  The
    raw-minus-correction form cancels when ``|mean| ≫ spread``; returns
    ``(G, digits_lost)``, the worst base-10 cancellation over the blocks,
    so the caller can fall back to the streamed centred Gram."""
    G_blocks, t_blocks = stats["G_blocks"], stats["t_blocks"]
    n_features, m, _ = G_blocks.shape
    ones = np.ones(m)
    G = np.zeros((m, m), dtype=np.float64)
    worst = 0.0
    for f in range(n_features):
        Gf = G_blocks[f]
        if axis_cnt == 1:
            t2 = stats["t2_blocks"][f]
            Gc = Gf - np.outer(t2, ones) - np.outer(ones, t2) \
                + stats["sc2_blocks"][f] * np.outer(ones, ones)
        else:
            mu = float(np.asarray(stats["s1"][f] / stats["count"],
                                  dtype=dtype))
            tf = t_blocks[f]
            Gc = Gf - mu * (np.outer(ones, tf) + np.outer(tf, ones)) \
                + n_points * mu * mu * np.outer(ones, ones)
        raw_mag = float(np.abs(np.diag(Gf)).max())
        cen_mag = float(np.abs(np.diag(Gc)).max())
        if raw_mag > 0:
            worst = max(worst, np.log10(
                raw_mag / max(cen_mag, np.finfo(np.float64).tiny)))
        # a 0-scale block gives inf/nan here exactly as the streamed pass
        # would: the same failure, no silent flooring
        G += Gc / float(np.asarray(scl_blocks[f], dtype=dtype)) ** 2
    return G, worst


def _distinct_vals(lo: float, hi_excl: float, dt: np.dtype,
                   cap: int) -> Optional[np.ndarray]:
    """The representable values of ``dt`` in ``[lo, hi_excl)`` if there
    are at most ``cap`` of them, else None: finishes the median selection
    exactly where bisection stalls (two adjacent representable values each
    holding a large mass)."""
    if not np.issubdtype(dt, np.floating):
        dt = np.dtype(np.float64)
    v = dt.type(lo)
    # dt.type(lo) rounds to nearest and may land below lo: step up first
    while np.float64(v) < lo:
        v = np.nextafter(v, np.inf, dtype=dt)
    out = []
    while np.float64(v) < hi_excl:
        out.append(v)
        if len(out) > cap:
            return None
        nxt = np.nextafter(v, np.inf, dtype=dt)
        if nxt == v:                       # inf saturation guard
            break
        v = nxt
    return np.asarray(out, dtype=np.float64)


def _block_medians(store, n_features: int, dtype, chunk_rows, prefetch,
                   bmin: np.ndarray, bmax: np.ndarray) -> np.ndarray:
    """Exact per-feature-block medians (``np.median`` semantics: the mean
    of the two middle order statistics for an even count) with O(1)
    memory, by histogram refinement over disk passes.

    Each pass histograms every unfinished block's in-interval entries into
    ``_MEDIAN_BINS`` equal float64 bins (``searchsorted`` against explicit
    edges, so bin membership and the interval tests share one order) and
    narrows the interval to the bins of the two middle order statistics
    k1 = (N−1)//2 and k2 = N//2.  A block finishes when (a) fewer than
    ``_MEDIAN_COLLECT_LIMIT`` candidates survive — the next pass gathers
    and partitions them; (b) all survivors are one value; (c) the interval
    holds at most ``_MEDIAN_EXACT_CAP`` representable values of the store
    dtype — the next pass counts each; or (d) the two ranks land in
    different bins — every bin between is empty, so one min/max pass
    finishes.  Realistic data needs 2 extra passes."""
    n, m = store.shape
    n_points = n // n_features
    N = n_points * m
    k1, k2 = (N - 1) // 2, N // 2
    dt = np.dtype(dtype)

    lo = bmin.astype(np.float64).copy()
    hi_excl = np.nextafter(bmax.astype(np.float64), np.inf)
    below = np.zeros(n_features, dtype=np.int64)
    count = np.full(n_features, N, dtype=np.int64)
    med = np.full(n_features, np.nan)
    done = bmin >= bmax                   # constant blocks
    med[done] = bmin[done]
    # pending straddle resolutions: f → (aLo, aHi, bLo, bHi)
    straddle: List[Optional[tuple]] = [None] * n_features

    for _ in range(200):                  # hard cap; realistic data: 1-2
        if done.all():
            break
        modes: List[Optional[list]] = [None] * n_features
        for f in range(n_features):
            if done[f]:
                continue
            if straddle[f] is not None:
                modes[f] = ["straddle", straddle[f],
                            np.array([-np.inf]), np.array([np.inf])]
            elif count[f] <= _MEDIAN_COLLECT_LIMIT:
                modes[f] = ["collect", []]
            else:
                vals = _distinct_vals(lo[f], hi_excl[f], dt,
                                      _MEDIAN_EXACT_CAP)
                if vals is not None:
                    modes[f] = ["exact", vals,
                                np.zeros(len(vals), dtype=np.int64)]
                else:
                    edges = np.linspace(lo[f], hi_excl[f],
                                        _MEDIAN_BINS + 1)
                    modes[f] = ["hist", edges,
                                np.zeros(_MEDIAN_BINS, dtype=np.int64),
                                np.array([np.inf]), np.array([-np.inf])]

        for row0, chunk in iter_chunks(store, chunk_rows, dtype, prefetch):
            c = chunk.astype(np.float64, copy=False)
            r, end = row0, row0 + chunk.shape[0]
            while r < end:
                f = r // n_points
                r_stop = min(end, (f + 1) * n_points)
                mode = modes[f]
                if mode is not None:
                    seg = c[r - row0:r_stop - row0].ravel()
                    if mode[0] == "straddle":
                        a_lo, a_hi, b_lo, b_hi = mode[1]
                        in_a = seg[(seg >= a_lo) & (seg < a_hi)]
                        in_b = seg[(seg >= b_lo) & (seg < b_hi)]
                        if in_a.size:
                            mode[2][0] = max(mode[2][0], in_a.max())
                        if in_b.size:
                            mode[3][0] = min(mode[3][0], in_b.min())
                    else:
                        cand = seg[(seg >= lo[f]) & (seg < hi_excl[f])]
                        if mode[0] == "collect":
                            mode[1].append(cand)
                        elif mode[0] == "exact":
                            idx = np.searchsorted(mode[1], cand)
                            mode[2] += np.bincount(
                                idx, minlength=len(mode[2])
                            ).astype(np.int64)
                        else:
                            idx = np.searchsorted(mode[1], cand,
                                                  side="right") - 1
                            mode[2] += np.bincount(
                                idx, minlength=_MEDIAN_BINS
                            ).astype(np.int64)
                            if cand.size:
                                mode[3][0] = min(mode[3][0], cand.min())
                                mode[4][0] = max(mode[4][0], cand.max())
                r = r_stop

        for f in range(n_features):
            mode = modes[f]
            if mode is None:
                continue
            if mode[0] == "straddle":
                med[f] = 0.5 * (mode[2][0] + mode[3][0])
                done[f] = True
            elif mode[0] == "collect":
                vals = (np.concatenate(mode[1]) if mode[1]
                        else np.empty(0))
                vals.sort()
                med[f] = 0.5 * (vals[k1 - below[f]] + vals[k2 - below[f]])
                done[f] = True
            elif mode[0] == "exact":
                cum = below[f] + np.cumsum(mode[2])
                v1 = mode[1][np.searchsorted(cum, k1, side="right")]
                v2 = mode[1][np.searchsorted(cum, k2, side="right")]
                med[f] = 0.5 * (v1 + v2)
                done[f] = True
            else:
                _, edges, cnts, cmin, cmax = mode
                if cmin[0] == cmax[0]:    # all survivors identical
                    med[f] = cmin[0]
                    done[f] = True
                    continue
                cum = below[f] + np.cumsum(cnts)
                b1 = int(np.searchsorted(cum, k1, side="right"))
                b2 = int(np.searchsorted(cum, k2, side="right"))
                if b1 != b2:              # adjacent ranks, distinct bins
                    straddle[f] = (edges[b1], edges[b1 + 1],
                                   edges[b2], edges[b2 + 1])
                    continue
                new_lo = max(edges[b1], cmin[0])
                new_hi = min(edges[b2 + 1], np.nextafter(cmax[0], np.inf))
                below[f] = below[f] + int(cnts[:b1].sum())
                count[f] = int(cnts[b1:b2 + 1].sum())
                lo[f], hi_excl[f] = new_lo, new_hi
    if not done.all():
        raise RuntimeError("streaming median failed to converge "
                           f"(blocks {np.flatnonzero(~done)})")
    return med


def _scale_from_stats(stats, scale_type: str) -> np.ndarray:
    """Per-block scale factors from the streamed power sums — the moment
    forms of ``core.scaling``'s block statistics (biased moments)."""
    N = stats["count"]
    mean = stats["s1"] / N
    var = np.maximum(stats["s2"] / N - mean * mean, 0.0)
    std = np.sqrt(var)
    if scale_type == "std":
        return std
    if scale_type == "none":
        return np.ones_like(std)
    if scale_type == "pareto":
        return np.sqrt(std)
    if scale_type == "vast":
        return var / mean
    if scale_type == "range":
        return stats["max"] - stats["min"]
    if scale_type == "level":
        return mean
    if scale_type == "max":
        return stats["max"]
    if scale_type == "variance":
        return var
    if scale_type == "poisson":
        return np.sqrt(mean)
    if scale_type == "l2-norm":
        return np.sqrt(stats["s2"])
    if scale_type in ("vast_2", "vast_3", "vast_4"):
        # central moments from raw power sums
        m2 = var
        m4 = (stats["s4"] / N - 4.0 * mean * stats["s3"] / N
              + 6.0 * mean ** 2 * stats["s2"] / N - 3.0 * mean ** 4)
        kurt = m4 / (m2 * m2) - 3.0
        base = var * kurt ** 2
        if scale_type == "vast_2":
            return base / mean
        if scale_type == "vast_3":
            return base / stats["max"]
        return base / (stats["max"] - stats["min"])
    raise NotImplementedError(
        "The scaling method selected has not been implemented yet")


# --------------------------------------------------------------------- #
# Fit helpers
# --------------------------------------------------------------------- #

def _chunk_gram(chunk: torch.Tensor, cnt: torch.Tensor, scl: torch.Tensor,
                W: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gram of the scaled chunk ``x0 = (chunk − cnt)/scl`` (row-wise), or of
    ``x0 W``, in full precision on the chunk's device."""
    x0 = (chunk - cnt[:, None]) / scl[:, None]
    if W is not None:
        x0 = x0 @ W
    return x0.T @ x0


def _finalize_basis(U, colnorm, S2, V, r, n, norm_dtype=None):
    """Both engines' epilogue: the eps·max·√n norm floor, the column
    normalization, the canonical signs (largest-|.| entry positive, V
    flipped to match) and the full-width S.  ``U`` is host numpy (the host
    engine, float64 ``colnorm``) or a tensor (the device engine, its norms
    in U's dtype).  ``norm_dtype`` is the dtype the norms were accumulated
    in: the host engine's float64 norms resolve genuine tail modes far
    below fp32's floor, and flooring those would de-normalize real basis
    columns.  Returns ``(U, sr_f64, S_f64, V_f64)``."""
    safe = _svd.floored_norms(colnorm, n, norm_dtype or U.dtype, U.dtype)
    if isinstance(U, np.ndarray):
        safe = safe.astype(U.dtype)
    U = U / safe[None, :]
    signs = _svd.canonical_signs(U)
    U = U * signs[None, :]
    if isinstance(U, np.ndarray):
        sr, signs64 = np.asarray(colnorm, np.float64), signs.astype(np.float64)
    else:
        # one device-to-host copy for the norms and the signs
        sr, signs64 = (a.astype(np.float64)
                       for a in to_numpy_once(colnorm, signs))
    S = np.sqrt(S2)
    S[:r] = sr
    V[:, :r] *= signs64[None, :]
    return U, sr, S, V


def _finalize_sharded_u(U: torch.Tensor, colnorm: np.ndarray, n: int,
                        axis, gidx: torch.Tensor):
    """:func:`_finalize_basis`'s normalization and sign canonicalization on
    a row-sharded raw U panel (this rank's rows ``U``, their global
    indices ``gidx``): the division is shard-local, each column's
    largest-|.| entry is an (r,)-sized all-gather with the unsharded tie
    rule.  ``colnorm`` is the host float64 norms of the whole panel, so
    the floor and the signs are the unsharded ones.  Returns the canonical
    U and the signs (host float64)."""
    safe = _svd.floored_norms(colnorm, n, np.float64,
                              U.dtype).astype(_NP_DTYPES[U.dtype])
    U = U / torch.as_tensor(safe, device=U.device)[None, :]
    signs = torch.sign(argmax_cols(active(axis), U, gidx))
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    return U * signs[None, :], to_numpy(signs).astype(np.float64)


# --------------------------------------------------------------------- #
# StreamingROM
# --------------------------------------------------------------------- #

class StreamingROM(ROM):
    """Out-of-core :class:`ROM`: the post-fit API over a
    :class:`SnapshotStore` instead of an in-RAM matrix.

    ``StreamingROM(source, n_features, xyz=None, chunk_rows=None,
    dtype=np.float32, prefetch=2, device=None)``: ``source`` is an ``.npy``
    path, a list of column-file paths, an array or a store; ``dtype`` the
    dtype of the chunks and of the fitted state on ``device`` (``None``
    means the card).

    ``X0`` is never materialized: ``scale_data``, ``decomposition`` and a
    ``solver_fn`` CPOD raise.  ``CPOD`` works from ``UrᵀX0 = Arᵀ``;
    ``adaptive_sampling`` reuses the fitted full-width spectrum.  After a
    fit, ``disk_passes_`` counts the full passes over the store,
    ``bytes_uploaded_`` the bytes copied to the device and
    ``device_reads_`` the device-to-host copies of the fit."""

    def __init__(self, source, n_features, xyz=None, chunk_rows=None,
                 dtype=np.float32, prefetch: int = 2,
                 device: DeviceLike = None):
        if type(n_features) is not int:
            raise TypeError("The parameter n_features is not an integer.")
        self.device = resolve_device(device)
        self.store = open_store(source)
        self.X = self.store          # duck-typed: .shape/.ndim only
        self.n_features = n_features
        self.xyz = xyz
        n = self.store.shape[0]
        self.n_points = n // n_features
        if n % n_features != 0:
            raise Exception(
                "The number of rows of X is not a multiple of n_features")
        self.chunk_rows = chunk_rows
        self.dtype = np.dtype(dtype)
        if self.dtype not in _TORCH_DTYPES:
            raise ValueError(f"dtype must be float32 or float64; got "
                             f"{self.dtype}")
        self.prefetch = prefetch

    # -------------------------------------------------------------- #

    def scale_data(self, scale_type="std", axis_cnt=1):
        raise NotImplementedError(
            "StreamingROM never materializes X0; call fit() — it computes "
            "X_cnt/X_scl in its streaming stats pass. Use the in-core ROM "
            "if you need the scaled snapshot matrix itself.")

    def decomposition(self, X0, select_modes="variance", n_modes=99):
        raise NotImplementedError(
            "StreamingROM decomposes inside fit() (streamed Gram route); "
            "there is no in-core X0 to decompose.")

    def _stream_scaling(self, scale_type, axis_cnt, want_gram=False):
        """Stats pass → (cnt, scl, stats, scl_blocks) in the store dtype.
        With ``want_gram=True`` the pass also accumulates the raw
        per-block Grams (skipped above :data:`_FUSED_GRAM_BYTES_CAP`)."""
        if scale_type not in _scaling.SCALE_TYPES:
            raise NotImplementedError(
                "The scaling method selected has not been implemented yet")
        if axis_cnt not in (1, None):
            raise ValueError("axis_cnt must be 1 or None")
        m = self.store.shape[1]
        want_gram = want_gram and (
            self.n_features * m * m * 8 <= _FUSED_GRAM_BYTES_CAP)
        stats = _block_stats_pass(
            self.store, self.n_features, self.dtype, self.chunk_rows,
            need_row_means=(axis_cnt == 1), prefetch=self.prefetch,
            accumulate_gram=want_gram)
        self.disk_passes_ += 1
        if scale_type == "median":
            # not a moment statistic: exact selection by histogram-
            # refinement passes; the fused raw Grams stay valid (only the
            # final /scl_f² uses the medians)
            passes = [0]
            store = _CountedStore(self.store, passes)
            scl_blocks = _block_medians(
                store, self.n_features, self.dtype, self.chunk_rows,
                self.prefetch, stats["min"], stats["max"])
            self.disk_passes_ += passes[0]
        else:
            scl_blocks = _scale_from_stats(stats, scale_type)
        if axis_cnt == 1:
            cnt = stats["row_means"]
        else:
            cnt = np.repeat(stats["s1"] / stats["count"], self.n_points)
        scl = np.repeat(scl_blocks, self.n_points)
        return (cnt.astype(self.dtype), scl.astype(self.dtype), stats,
                scl_blocks)

    def fit(self, scale_type: str = "std", axis_cnt: Optional[int] = 1,
            select_modes: str = "variance", n_modes=99, basis=None,
            refine: Optional[int] = None, width: Optional[int] = None,
            config=None, engine: str = "host", mesh=None,
            mesh_axis: str = "state"):
        """The streaming ``ROM.fit`` (see the module docstring for the
        passes).

        ``engine='host'`` (default): Gram and U in host float64 BLAS, one
        (n, r) upload at the end; ``refine``/``width`` are device-engine
        knobs and raise here.  ``engine='device'``: per-chunk products on
        the model's device, then ``refine`` passes (default
        :func:`linalg.svd.default_refine` of the device) on the leading
        ``width`` subspace (default ``min(m, max(2r, r + 4))``).
        ``basis=(Ur, Ar)`` takes the basis as given after the stats pass.

        ``mesh=`` (a ``DeviceMesh`` of :func:`..parallel.make_mesh`, called
        on every rank) shards the fit over the mesh's ``mesh_axis`` axis
        (see the module docstring): host engine only, no ``basis=``, and
        n divisible by the axis size.  ``fit_mesh_`` records the mesh
        (``None`` after an unsharded fit)."""
        if config is not None:
            scale_type = config.scale_type
            axis_cnt = config.axis_cnt
            select_modes = config.select_modes
            n_modes = config.n_modes
        self.fit_mesh_ = None
        self._mesh_axis = mesh_axis
        self._shard_rows = (0, self.store.shape[0])
        if engine not in ("host", "device"):
            raise ValueError(f"unknown streaming fit engine {engine!r}")
        if mesh is not None:
            Axis.of(mesh, mesh_axis)            # a DeviceMesh, or TypeError
            if engine != "host":
                raise ValueError(
                    "mesh= composes with engine='host' only (the device "
                    "engine's chunk scatter assumes one resident buffer).")
            if basis is not None:
                raise ValueError(
                    "mesh= shards the streamed U pass; with basis= there is "
                    "no U pass — shard the injected basis yourself "
                    "(e.g. serving.shard_state_rows).")
        if engine == "host" and (refine is not None or width is not None):
            raise ValueError(
                "refine/width are device-engine knobs; the host engine's "
                "float64 Gram does not use them — pass engine='device' "
                "or drop them.")
        if refine is None:
            refine = _svd.default_refine(self.device)
        self.scale_type = scale_type
        self.gram_fused_ = False
        self.disk_passes_ = 0
        self.bytes_uploaded_ = 0
        self.device_reads_ = 0
        n, m = self.store.shape
        if mesh is not None:
            ax = Axis.of(mesh, mesh_axis)
            if n % ax.size != 0:
                raise ValueError(
                    f"sharded streaming fit needs the state dimension "
                    f"(n={n}) divisible by the '{mesh_axis}' mesh axis "
                    f"({ax.size} ranks) — pad the store upstream or pick a "
                    "divisor mesh (same convention as "
                    "parallel.shard_snapshots).")
            if active(ax) is not None:
                self._fit_sharded(scale_type, axis_cnt, select_modes,
                                  n_modes, mesh, ax)
                self._fit_axis_cnt = axis_cnt
                self._invalidate_trained_state()
                return
            # an axis of one rank holds every row: the unsharded host fit

        # pass 1: stats (fused with the raw block Grams on the host engine)
        cnt_h, scl_h, stats, scl_blocks = self._stream_scaling(
            scale_type, axis_cnt,
            want_gram=(engine == "host" and basis is None))
        self.X_cnt = self._upload(cnt_h[:, None])
        self.X_scl = self._upload(scl_h[:, None])
        self._cnt_vector_cache = None
        self._scl_vector_cache = None
        self._cols_cache = None

        if basis is not None:
            Ur, Ar = self._t(basis[0]), self._t(basis[1])
            self.Ur, self.Ar, self.r = Ur, Ar, Ar.shape[1]
            Sigma_r = torch.linalg.vector_norm(Ar, dim=0)
            self.Vr = Ar / Sigma_r[None, :]
            self.Sigma_r = Sigma_r
            self._invalidate_trained_state()
            return

        if engine == "host":
            self._fit_host_spectral(cnt_h, scl_h, select_modes, n_modes,
                                    stats=stats, scl_blocks=scl_blocks,
                                    axis_cnt=axis_cnt)
            self._fit_axis_cnt = axis_cnt
            self.fit_mesh_ = mesh
            self._invalidate_trained_state()
            return

        cnt_d, scl_d = self.X_cnt[:, 0], self.X_scl[:, 0]

        def gram_pass(W=None):
            w = m if W is None else W.shape[1]
            G = np.zeros((w, w), dtype=np.float64)
            for row0, x in self._device_chunks():
                c = x.shape[0]
                G += to_numpy(_chunk_gram(x, cnt_d[row0:row0 + c],
                                          scl_d[row0:row0 + c], W))
                self.device_reads_ += 1
            return G

        # pass 2: Gram → V, eigenvalues, rank
        V, S2, r = self._rank_from_gram(gram_pass(), select_modes, n_modes)

        # refine passes: width-limited orthogonal iteration
        if width is None:
            width = min(m, max(2 * r, r + 4))
        if not r <= width <= m:
            raise ValueError("need rank <= width <= m")
        Vw = V[:, :width] if refine > 0 and width < m else V
        for _ in range(refine):
            G2 = gram_pass(self._upload(Vw.astype(self.dtype)))
            e2, V2 = np.linalg.eigh(G2)
            V2 = V2[:, ::-1]
            S2[:Vw.shape[1]] = np.maximum(e2[::-1], 0.0)
            Vw = Vw @ V2
        V[:, :Vw.shape[1]] = Vw

        # U pass: each chunk's product written in place into (n, r)
        VU = self._upload(V[:, :r].astype(self.dtype))
        buf = torch.zeros((n, r), dtype=VU.dtype, device=self.device)
        for row0, x in self._device_chunks():
            c = x.shape[0]
            torch.matmul((x - cnt_d[row0:row0 + c, None])
                         / scl_d[row0:row0 + c, None], VU,
                         out=buf[row0:row0 + c])
        colnorm = torch.linalg.vector_norm(buf, dim=0)
        U, sr, S, V = _finalize_basis(buf, colnorm, S2, V, r, n)
        self.device_reads_ += 1
        self._set_spectral_attrs(U, sr, S, V)
        self._fit_axis_cnt = axis_cnt
        self._invalidate_trained_state()

    # -------------------------------------------------------------- #

    # worst tolerable base-10 cancellation in the fused raw-Gram algebra:
    # 6 lost digits still leave ~1e-10 relative in f64; above it the
    # streamed centred Gram pass runs instead
    _FUSED_MAX_DIGITS_LOST = 6.0

    def _fit_host_spectral(self, cnt_h, scl_h, select_modes, n_modes,
                           stats=None, scl_blocks=None, axis_cnt=1):
        """``engine='host'``: :meth:`_host_passes`, then the basis
        normalized (the norms in float64) and one (n, r) upload."""
        n = self.store.shape[0]
        U_h, colnorm, S2, V, r = self._host_passes(
            cnt_h, scl_h, select_modes, n_modes, stats, scl_blocks, axis_cnt)
        U_h, sr, S, V = _finalize_basis(U_h, colnorm, S2, V, r, n,
                                        norm_dtype=np.float64)
        self._set_spectral_attrs(self._upload(U_h), sr, S, V)

    def _host_passes(self, cnt_h, scl_h, select_modes, n_modes, stats,
                     scl_blocks, axis_cnt, on_rank=None, on_rows=None):
        """The host engine's float64 work: the Gram (fused or streamed),
        ``eigh`` and the rank rule, then one disk pass building U = X0·V_r
        in host float64, stored in the store dtype.  Returns ``(U_h,
        colnorm, S2, V, r)``.  ``on_rank(V, S2, r)`` runs once the rank is
        known and ``on_rows(U_h, stop)`` after each chunk, with rows
        [0, stop) of U_h complete: the sharded fit's broadcasts."""
        n, m = self.store.shape
        cnt64 = cnt_h.astype(np.float64)
        scl64 = scl_h.astype(np.float64)

        G = self._assemble_gram(stats, scl_blocks, axis_cnt, cnt64, scl64)
        V, S2, r = self._rank_from_gram(G, select_modes, n_modes)
        if on_rank is not None:
            on_rank(V, S2, r)

        Vr_ = V[:, :r]
        U_h = np.empty((n, r), dtype=self.dtype)
        colnorm2 = np.zeros((r,), dtype=np.float64)
        for row0, chunk in self._chunks():
            c = chunk.shape[0]
            x0 = (chunk.astype(np.float64)
                  - cnt64[row0:row0 + c, None]) / scl64[row0:row0 + c, None]
            u = x0 @ Vr_
            colnorm2 += np.sum(u * u, axis=0)
            U_h[row0:row0 + c] = u.astype(self.dtype)
            if on_rows is not None:
                on_rows(U_h, row0 + c)
        return U_h, np.sqrt(colnorm2), S2, V, r

    def _fit_sharded(self, scale_type, axis_cnt, select_modes, n_modes,
                     mesh, ax):
        """The sharded host-engine fit over the axis ``ax`` of several
        ranks: its first rank runs :meth:`_host_passes` as the unsharded
        host engine does, broadcasting the spectrum and then each
        (n/k)-row slice of [U, cnt, scl] as the stream completes it; each
        rank keeps its slice."""
        n, m = self.store.shape
        k, per = ax.size, n // ax.size
        dev, tdt = ax.device, _TORCH_DTYPES[self.dtype]
        f64 = dict(dtype=torch.float64, device=dev)
        head = torch.zeros(3, **f64)              # r, gram_fused_, passes
        small = torch.zeros(m * m + m + self.n_features, **f64)
        if ax.rank == 0:
            cnt_h, scl_h, stats, scl_blocks = self._stream_scaling(
                scale_type, axis_cnt, want_gram=True)

            def send_spectrum(V, S2, r):
                head.copy_(torch.tensor(
                    [r, float(self.gram_fused_), self.disk_passes_],
                    dtype=torch.float64))
                small.copy_(torch.as_tensor(np.concatenate(
                    [V.reshape(-1), S2,
                     np.asarray(scl_blocks, np.float64)])))
                ax.broadcast(head)
                ax.broadcast(small)

            sent = []

            def send_rows(U_h, stop):
                while len(sent) < k and (len(sent) + 1) * per <= stop:
                    a = len(sent) * per
                    t = np.empty((per, U_h.shape[1] + 2), dtype=self.dtype)
                    t[:, :-2] = U_h[a:a + per]
                    t[:, -2] = cnt_h[a:a + per]
                    t[:, -1] = scl_h[a:a + per]
                    sent.append(ax.broadcast(torch.as_tensor(t, device=dev)))

            colnorm = self._host_passes(
                cnt_h, scl_h, select_modes, n_modes, stats, scl_blocks,
                axis_cnt, on_rank=send_spectrum, on_rows=send_rows)[1]
            mine = sent[0]
            colnorm = torch.as_tensor(colnorm, **f64)
        else:
            ax.broadcast(head)
            ax.broadcast(small)
            r = int(head[0])
            got = [ax.broadcast(torch.empty((per, r + 2), dtype=tdt,
                                            device=dev)) for _ in range(k)]
            mine = got[ax.rank]
            colnorm = torch.zeros(r, **f64)
        ax.broadcast(colnorm)
        sr = colnorm.cpu().numpy()
        r = int(head[0])
        self.r = r
        self.gram_fused_ = bool(head[1])
        self.disk_passes_ = int(head[2]) + 1
        small = small.cpu().numpy()
        V = small[:m * m].reshape(m, m).copy()
        S2 = small[m * m:m * m + m].copy()
        scl_blocks = small[m * m + m:]

        a, b, _ = row_range(n, k, ax.rank)
        gidx = torch.arange(a, b, dtype=torch.int64, device=dev)
        U, signs = _finalize_sharded_u(mine[:, :r].contiguous(), sr, n, ax,
                                       gidx)
        S = np.sqrt(S2)
        S[:r] = sr
        V[:, :r] *= signs[None, :]
        self._set_spectral_attrs(U, sr, S, V)
        # the n-row unscaling vectors ride the same row sharding, so
        # reconstruct() stays shard-local end to end
        self.X_cnt = mine[:, r:r + 1].contiguous()
        self.X_scl = mine[:, r + 1:r + 2].contiguous()
        self._cnt_vector_cache = None
        self._cols_cache = None
        self._scl_vector_cache = np.repeat(
            np.asarray(scl_blocks, self.dtype), self.n_points)
        self._shard_rows = (a, b)
        self.fit_mesh_ = mesh

    def _assemble_gram(self, stats, scl_blocks, axis_cnt, cnt64, scl64):
        """Scaled, centred float64 Gram of the whole panel: the fused
        algebra when the stats pass carried it and it lost at most
        ``_FUSED_MAX_DIGITS_LOST`` digits, else ONE streamed centred Gram
        pass.  Sets ``gram_fused_``.  Shared by the ROM fit and
        StreamingDMD."""
        self.gram_fused_ = False
        if stats is not None and stats.get("G_blocks") is not None:
            G, digits_lost = _gram_from_block_stats(
                stats, scl_blocks, axis_cnt, self.n_points, self.dtype)
            # a non-finite fused Gram (a 0-scale block) is not a fallback
            # case: the streamed pass would divide by the same zero
            if digits_lost <= self._FUSED_MAX_DIGITS_LOST \
                    or not np.all(np.isfinite(G)):
                self.gram_fused_ = True
                return G
        m = self.store.shape[1]
        G = np.zeros((m, m), dtype=np.float64)
        for row0, chunk in self._chunks():
            c = chunk.shape[0]
            x0 = (chunk.astype(np.float64) - cnt64[row0:row0 + c, None]
                  ) / scl64[row0:row0 + c, None]
            G += x0.T @ x0
        return G

    def _rank_from_gram(self, G, select_modes, n_modes):
        """Host float64 ``eigh`` of the Gram, explained variance, the
        in-core rank rule.  Sets ``self.r``."""
        m = G.shape[0]
        evals, V = np.linalg.eigh(G)          # ascending
        V = V[:, ::-1]
        S2 = np.maximum(evals[::-1], 0.0)
        exp_var = 100.0 * np.cumsum(S2) / max(S2.sum(), np.finfo(float).tiny)
        r = _svd.select_rank(exp_var, select_modes, n_modes, m)
        self.r = r
        return V, S2, r

    def _set_spectral_attrs(self, U_dev, sr, S, V):
        """Both engines' post-fit attributes."""
        r = self.r
        self.Ur = U_dev
        self.Sigma_r = self._upload(sr.astype(self.dtype))
        self.Ar = self._upload((V[:, :r] * S[:r][None, :]).astype(self.dtype))
        self.Vr = self._upload(V[:, :r].astype(self.dtype))
        self._S_full = S                       # (m,) host float64
        self._V_full = V                       # (m, m) host float64

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host array as a tensor on the model's device, counted in
        ``bytes_uploaded_`` when that is the card."""
        if self.device.type != "cpu":
            self.bytes_uploaded_ = getattr(self, "bytes_uploaded_", 0) \
                + a.nbytes
        return as_tensor(np.ascontiguousarray(a), self.device)

    def _chunks(self):
        """One full pass over the store (counted in ``disk_passes_``)."""
        self.disk_passes_ = getattr(self, "disk_passes_", 0) + 1
        return iter_chunks(self.store, self.chunk_rows, self.dtype,
                           self.prefetch)

    def _device_chunks(self):
        """One pass over the store as ``(row0, chunk on the device)``.  On
        a card each chunk is read into a ring of pinned buffers and copied
        on a side stream; the copy of chunk j + 1 is issued before chunk j
        is handed out, so it overlaps chunk j's product.  The consumer's
        stream waits on each copy's event before it uses the chunk."""
        if self.device.type != "cuda":
            for row0, chunk in self._chunks():
                yield row0, as_tensor(chunk, self.device)
            return
        n, m = self.store.shape
        rows = min(self.chunk_rows or default_chunk_rows(m, self.dtype), n)
        ring = _PinnedRing(self.prefetch + 2, rows, m, self.dtype)
        side = torch.cuda.Stream(device=self.device)
        cur = torch.cuda.current_stream(self.device)
        self.disk_passes_ += 1
        pending = None
        for row0, chunk in iter_chunks(self.store, rows, self.dtype,
                                       self.prefetch, ring=ring):
            c = chunk.shape[0]
            x = torch.empty((c, m), dtype=_TORCH_DTYPES[self.dtype],
                            device=self.device)
            # x's memory may have served a chunk whose product the
            # current stream has not finished: the copy waits for it
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                x.copy_(ring.tensor(row0, c), non_blocking=True)
                copied = torch.cuda.Event()
                copied.record(side)
            ring.release(row0, copied)
            self.bytes_uploaded_ += x.numel() * x.element_size()
            if pending is not None:
                cur.wait_event(pending[2])
                yield pending[0], pending[1]
            pending = (row0, x, copied)
        if pending is not None:
            cur.wait_event(pending[2])
            yield pending[0], pending[1]

    # -------------------------------------------------------------- #

    def CPOD(self, limits=None, solver_fn=None, max_iter: int = 4000,
             tol: float = 1e-9, over_relax: float = 1.6, solver_config=None,
             constraints=None, **kwargs):
        """Constrained POD without ``X0``: the box-QP's linear term is
        ``UrᵀX0[:, i]``, which equals ``Ar[i]`` for the orthonormal
        streamed basis, so the batched ADMM runs from the reduced
        coordinates alone.

        After a fit sharded over several ranks, ``UrᵀUr`` is one
        all-reduce, the box rows are this rank's (``limits`` scaled by its
        rows of the statistics), a ``constraints`` set's global rows are
        split over the ranks (:func:`..linalg.boxls.shard_constraint_set`)
        and the ADMM runs with ``axis=`` and the global row count;
        ``Ar``, ``Vr`` and ``admm_info`` come out replicated."""
        if solver_fn is not None:
            raise NotImplementedError(
                "solver_fn CPOD needs the in-core X0; use ROM.CPOD.")
        if solver_config is not None:
            max_iter = solver_config.max_iter
            tol = solver_config.tol
            over_relax = solver_config.over_relax
        Ur = self.Ur
        H = Ur.T @ Ur
        axis = self._shard_axis()[1]
        if axis is not None:
            H = axis.sum(H)
            box = None if limits is None else (Ur,) + tuple(
                self._scale_limit_rows(limits, Ur.dtype))
            cs = _boxls.shard_constraint_set(constraints, box, axis,
                                             self.store.shape[0], Ur.dtype,
                                             self.device)
        else:
            box = None
            if limits is not None:
                lo_b, hi_b = self.scale_limits(limits)
                box = (Ur, lo_b, hi_b)
            cs, box_only = _boxls.build_constraint_set(constraints, box)
            if cs is not None:
                lo, hi = (as_tensor(x, self.device, dtype=Ur.dtype)
                          for x in (cs.lo, cs.hi))
                if box_only:
                    A_c, AtA = Ur, H
                else:
                    A_c = as_tensor(cs.A, self.device, dtype=Ur.dtype)
                    AtA = A_c.T @ A_c
                cs = (A_c, lo, hi, AtA, None)
        if cs is None:
            raise ValueError(
                "CPOD requires `limits`, `constraints`, or a solver_fn.")
        A_c, lo, hi, AtA, n_rows = cs
        Gr, info = _boxls.admm_box_qp(
            H, self.Ar, A_c, lo, hi, AtA=AtA, max_iter=max_iter, tol=tol,
            over_relax=over_relax, n_rows=n_rows, axis=axis)
        self.admm_info = info
        self.Ar = Gr
        self.Vr = Gr / self.Sigma_r[None, :]

    def adaptive_sampling(self, P, scale_type: str = "std", seed=None):
        """The in-core DoE step on the fitted full-width spectrum (the
        influence needs only ``S`` (m,) and ``V`` (m, m), not the panel).
        ``scale_type`` must be the fit's."""
        if getattr(self, "_S_full", None) is None:
            raise RuntimeError(
                "call fit() before adaptive_sampling (an update_basis "
                "invalidates the fitted full-width spectrum — refit)")
        if scale_type != self.scale_type:
            raise NotImplementedError(
                "StreamingROM.adaptive_sampling reuses the fitted spectrum; "
                f"re-fit with scale_type={scale_type!r} first.")
        S = as_tensor(self._S_full.astype(self.dtype), self.device)
        V = as_tensor(self._V_full.astype(self.dtype), self.device)
        return influence_candidate(S, V, P, seed)

    def update_basis(self, X_new, select_modes: str = "number",
                     n_modes=None, reorth: bool = True):
        """Incremental basis update without touching the original store.

        ``X_new`` is an in-RAM (n, q) array or tensor, or any
        :class:`SnapshotStore` source (an ``.npy`` path, a list of column
        files), streamed in row chunks.  The new snapshots are scaled with
        the frozen fit statistics and folded in by Brand's update
        (:meth:`ROM.update_basis` semantics); the original snapshots are
        never read again.  The fitted full-width spectrum no longer
        describes the enlarged set and is dropped.

        After a fit sharded over several ranks (``fit(mesh=...)``, called
        on every rank with the same ``X_new``) each rank reads only its
        rows of ``X_new``, scales them with its rows of the statistics and
        keeps its rows of the updated ``Ur``; the update's small factors
        (``Sigma_r``, ``Vr``, ``Ar``, ``r``) are replicated
        (:meth:`ROM._update_basis_core`)."""
        if not hasattr(self, "Ur"):
            raise AttributeError(
                "The fit function has to be called before update_basis.")
        n = self.store.shape[0]
        a, b = self._shard_axis()[3]
        if isinstance(X_new, (np.ndarray, torch.Tensor)):
            Xn_h = to_numpy(X_new).astype(self.dtype, copy=False)
            if Xn_h.ndim == 1:
                Xn_h = Xn_h[:, None]
            if Xn_h.shape[0] != n:
                raise ValueError(
                    f"X_new has {Xn_h.shape[0]} rows; expected {n} "
                    f"(the fitted snapshot dimension).")
            Xn_h = Xn_h[a:b]
        else:
            new_store = open_store(X_new)
            if new_store.shape[0] != n:
                raise ValueError(
                    f"new source has {new_store.shape[0]} rows; expected "
                    f"{n} (the fitted snapshot dimension).")
            Xn_h = np.empty((b - a, new_store.shape[1]), dtype=self.dtype)
            for row0, chunk in iter_chunks(new_store, self.chunk_rows,
                                           self.dtype, self.prefetch,
                                           rows=(a, b)):
                Xn_h[row0 - a:row0 - a + chunk.shape[0]] = chunk
        cnt_h, scl_h = to_numpy_once(self.X_cnt[:, 0], self.X_scl[:, 0])
        X0n = as_tensor((Xn_h - cnt_h[:, None]) / scl_h[:, None],
                        self.device, dtype=self.Ur.dtype)
        self._update_basis_core(X0n, select_modes, n_modes, reorth)
        self._n_appended = getattr(self, "_n_appended", 0) + X0n.shape[1]
        self._S_full = None
        self._V_full = None


class _CountedStore(SnapshotStore):
    """A store that counts the full passes over it (a pass starts at
    row 0) into ``counter[0]``."""

    def __init__(self, store, counter):
        self.store, self.counter, self.shape = store, counter, store.shape

    def read_rows(self, row0, nrows, dtype=np.float32, out=None):
        if row0 == 0:
            self.counter[0] += 1
        return self.store.read_rows(row0, nrows, dtype, out)


class StreamingSPR(StreamingROM, SPR):
    """Out-of-core :class:`SPR`: the streaming fit with the placement /
    train / predict stack of :class:`SPR`, which consumes only the
    memory-resident reduced quantities.  MRO: fit/CPOD from
    :class:`StreamingROM`; placement, train, predict from :class:`SPR`."""

    def update_basis(self, X_new, select_modes: str = "number",
                     n_modes=None, reorth: bool = True):
        """:meth:`StreamingROM.update_basis`, then ``Theta = C @ Ur`` again
        (:meth:`SPR.update_basis` semantics)."""
        StreamingROM.update_basis(self, X_new, select_modes=select_modes,
                                  n_modes=n_modes, reorth=reorth)
        self._refresh_theta_after_update()


class StreamingGPR(StreamingROM, GPR):
    """Out-of-core :class:`GPR`: the snapshot side of ``fit`` streams; the
    GP consumes only ``Vr`` (m, r) and the scaled parameters ``P0``
    (m, d), so train / predict / update / reconstruct / serving come from
    :class:`GPR` unchanged.

    ``StreamingGPR(source, n_features, xyz, P, gpr_type='SingleTask',
    chunk_rows=None, dtype=np.float32, prefetch=2, device=None)``."""

    def __init__(self, source, n_features, xyz, P,
                 gpr_type: str = "SingleTask", chunk_rows=None,
                 dtype=np.float32, prefetch: int = 2,
                 device: DeviceLike = None):
        StreamingROM.__init__(self, source, n_features, xyz,
                              chunk_rows=chunk_rows, dtype=dtype,
                              prefetch=prefetch, device=device)
        P = np.atleast_2d(to_numpy(P))
        self.P = P
        self.gpr_type = gpr_type
        if P.shape[0] != self.store.shape[1]:
            raise Exception(
                f"The number of parameters ({P.shape[0]}) is different"
                f" from the number of columns of X ({self.store.shape[1]})")

    def fit(self, scaleX_type: str = "std", scaleP_type: str = "std",
            axis_cnt: Optional[int] = 1, select_modes: str = "variance",
            n_modes=99, verbose: bool = False, basis=None,
            refine: Optional[int] = None, width: Optional[int] = None,
            config=None, engine: str = "host", mesh=None,
            mesh_axis: str = "state"):
        """:meth:`StreamingROM.fit` for the snapshots (``engine``,
        ``refine``, ``width``, ``mesh`` as there), then the parameter
        scaling.  ``config`` overrides the kwargs as in :meth:`GPR.fit`."""
        if config is not None:
            scaleX_type = config.scale_type
            scaleP_type = config.scale_type
            axis_cnt = config.axis_cnt
            select_modes = config.select_modes
            n_modes = config.n_modes
        self.scaleX_type = scaleX_type
        self.scaleP_type = scaleP_type
        self.select_modes = select_modes
        self.n_modes = n_modes
        self.verbose = verbose
        StreamingROM.fit(self, scale_type=scaleX_type, axis_cnt=axis_cnt,
                         select_modes=select_modes, n_modes=n_modes,
                         basis=basis, refine=refine, width=width,
                         engine=engine, mesh=mesh, mesh_axis=mesh_axis)
        self.d = self.P.shape[1]
        self.P0 = self.scale_GPR_data(self.P, scaleP_type)

    def update_basis(self, X_new, P_new, select_modes: str = "number",
                     n_modes=None, reorth: bool = True,
                     retrain: bool = False, verbose: bool = False):
        """:meth:`StreamingROM.update_basis` for the snapshots (only the
        new ones are read), then :meth:`GPR.update_basis`'s bookkeeping."""
        self._guard_pigpr_retrain(retrain)
        self._guard_no_orphaned_updates()
        if isinstance(X_new, (np.ndarray, torch.Tensor)):
            q = 1 if X_new.ndim == 1 else X_new.shape[1]
        else:
            q = open_store(X_new).shape[1]
        P_new = self._validate_update_params(P_new, q)
        trained = hasattr(self, "params")
        r_old = self.r
        StreamingROM.update_basis(self, X_new, select_modes=select_modes,
                                  n_modes=n_modes, reorth=reorth)
        self._assimilate_params_after_update(P_new, trained, r_old,
                                             retrain, verbose)


class StreamingPIGPR(StreamingGPR, PIGPR):
    """Out-of-core :class:`PIGPR`: the streamed snapshot side
    (:meth:`StreamingGPR.fit`) with the physics-informed training and
    prediction of :class:`PIGPR`."""

    def __init__(self, source, n_features, xyz, P, P_cstr, AddedLoss,
                 chunk_rows=None, dtype=np.float32, prefetch: int = 2,
                 device: DeviceLike = None):
        StreamingGPR.__init__(self, source, n_features, xyz, P,
                              gpr_type="MultiTask", chunk_rows=chunk_rows,
                              dtype=dtype, prefetch=prefetch, device=device)
        self.P_cstr = P_cstr
        self.AddedLoss = AddedLoss

    def update_basis(self, X_new, P_new, select_modes: str = "number",
                     n_modes=None, reorth: bool = True,
                     retrain: bool = False, verbose: bool = False):
        """The streaming update with :meth:`PIGPR.update_basis`'s contract:
        ``retrain=True`` raises (the standard loop would drop the added
        loss); call :meth:`train` after the update instead."""
        if retrain:
            raise ValueError(
                "PIGPR.update_basis cannot retrain with the standard loop "
                "(it would drop the added-loss term); update with "
                "retrain=False and call train() again.")
        StreamingGPR.update_basis(self, X_new, P_new,
                                  select_modes=select_modes,
                                  n_modes=n_modes, reorth=reorth,
                                  retrain=False, verbose=verbose)


class StreamingDMD(StreamingROM, _DMD_base):
    """Out-of-core DMD of a time-ordered snapshot series on disk.

    The full float64 snapshot Gram ``G = X0ᵀX0`` holds the whole DMD
    identification: ``X1ᵀX1 = G[:-1, :-1]`` (the basis), ``X1ᵀX2 =
    G[:-1, 1:]`` (the cross term) and the coefficients of every snapshot,
    ``X0ᵀUr = G[:, :-1] V_r S_r⁻¹``.  So the fit is the stats pass (fused
    with the Gram) and ONE panel pass that builds both (n, r) forecast
    panels (``Ur`` from the X1 columns, ``B = X2 V_r S_r⁻¹`` from the X2
    columns of the same chunks).  The spectrum and amplitudes are the
    in-core class's host float64 computation."""

    def fit(self, dt: float = 1.0, scale_type: str = "std",
            axis_cnt: Optional[int] = 1, select_modes: str = "variance",
            n_modes=99):
        self.scale_type = scale_type
        self.dt = float(dt)
        self.disk_passes_ = 0
        self.bytes_uploaded_ = 0
        self.device_reads_ = 0
        n, m = self.store.shape
        self._m = m
        if m < 2:
            raise ValueError("DMD needs at least 2 time-ordered snapshots.")

        cnt_h, scl_h, stats, scl_blocks = self._stream_scaling(
            scale_type, axis_cnt, want_gram=True)
        self.X_cnt = self._upload(cnt_h[:, None])
        self.X_scl = self._upload(scl_h[:, None])
        self._cnt_vector_cache = None
        cnt64 = cnt_h.astype(np.float64)
        scl64 = scl_h.astype(np.float64)

        G = self._assemble_gram(stats, scl_blocks, axis_cnt, cnt64, scl64)

        V, S2, r = self._rank_from_gram(G[:-1, :-1], select_modes, n_modes)
        S1 = np.sqrt(S2)
        # numerical-rank clamp, as the in-core DMD: inverting noise-floor
        # singular values fabricates a spurious spectrum
        floor = np.finfo(self.dtype).eps * S1.max() * float(n) ** 0.5
        r_num = int(np.sum(S1 > floor))
        if r > r_num:
            warnings.warn(
                f"DMD rank clamped {r} -> {r_num}: requested mode count "
                "exceeds the series' numerical rank.", stacklevel=2)
            r = max(r_num, 1)
            self.r = r
        Sr = np.maximum(S1[:r], np.finfo(np.float64).tiny)
        Wf = V[:, :r] / Sr[None, :]                       # (m-1, r)
        A_tilde = Wf.T @ G[:-1, 1:] @ Wf                  # Urᵀ X2 V S⁻¹
        self.A_tilde = A_tilde
        self.Sigma_r = self._upload(Sr.astype(self.dtype))
        self.Vr = self._upload(V[:, :r].astype(self.dtype))
        self.Ar = self._upload((G[:, :-1] @ Wf).astype(self.dtype))

        lam, W = np.linalg.eig(A_tilde)
        a0 = Sr * V[0, :r]
        b, *_ = np.linalg.lstsq(W, a0.astype(np.complex128), rcond=None)
        be, *_ = np.linalg.lstsq(W * lam[None, :],
                                 a0.astype(np.complex128), rcond=None)
        self.eigs, self.W = lam, W
        self.amplitudes, self._b_exact = b, be
        with np.errstate(divide="ignore", invalid="ignore"):
            self.omega = np.log(lam.astype(np.complex128)) / self.dt

        # the two (n, r) forecast panels from the same chunks
        U_h = np.empty((n, r), dtype=self.dtype)
        B_h = np.empty((n, r), dtype=self.dtype)
        for row0, chunk in self._chunks():
            c = chunk.shape[0]
            x0 = (chunk.astype(np.float64)
                  - cnt64[row0:row0 + c, None]) / scl64[row0:row0 + c, None]
            U_h[row0:row0 + c] = (x0[:, :-1] @ Wf).astype(self.dtype)
            B_h[row0:row0 + c] = (x0[:, 1:] @ Wf).astype(self.dtype)
        self.Ur = self._upload(U_h)
        self._B = self._upload(B_h)
        self._invalidate_trained_state()

    def update_basis(self, *args, **kwargs):
        """Disabled, as for the in-core DMD: an incremental POD update
        would decouple the basis from the identified propagator; refit on
        the extended store."""
        raise NotImplementedError(
            "StreamingDMD.update_basis is not supported (the propagator is "
            "tied to the fitted basis); call fit() on the extended store.")
