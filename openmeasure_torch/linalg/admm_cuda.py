"""The fixed-budget ADMM on the card: the two CUDA kernels of
``csrc/admm.cu`` that run one iteration of :func:`.boxls._admm`, their
launch plan, their argument block, the launches and the dispatch
predicate.

The JAX package has no Pallas kernel here: its ADMM is a
``lax.while_loop`` that XLA compiles into one program.  Eager PyTorch
runs the same iteration as some seventy launches and about forty passes
over the (b, n) iterates; the two kernels run it as two launches and one
pass over them:

* the **row pass** (one launch an iteration) walks the n constraint rows
  for every active frame of the batch from ``g`` (b, r), the step's new
  coefficients: ``Ag = A g``, the relaxation, the clip and the dual
  update, z and w updated in place, and each frame's partial sums over a
  segment of rows (``‖Ag − z_n‖²``, ``Aᵀ(z_n − z)``, ``Aᵀz_n``, ``Aᵀw_n``;
  with fixed ρ only ``Aᵀ(z_n − w_n)``) into one slot a (segment, frame).
  One block an SM holds its strip of A in shared memory; a producer warp
  streams tiles of z and w (and of per-frame bounds) by asynchronous bulk
  copies into a ring of stages for each consumer warp, which computes
  from them;
* the **r-step** (one launch an iteration, one block a frame) sums the
  slots in a fixed order, forms the residuals, the residual-balancing ρ
  and the stop flag, accepts the step, and factors ``H + ρAᵀA`` (plus
  the loop's ridge) to solve for the next step's coefficients from
  ``c + ρ(Aᵀz − s·Aᵀw)``.

The penalty's rescale of the scaled dual, ``w ← w·s`` with ``s = ρ/ρ_n``,
is applied lazily: w is kept unscaled and the row pass reads it times the
frame's ``s``, so the adjoint is ``Aᵀz − s·Aᵀw`` and w takes no pass of
its own.  A frame whose residuals reach zero stops and stays frozen, as
in the loop.  The kernels take ``tol == 0`` only: the stop test is then
``pri ≤ 0 and dua ≤ 0``, and ``‖z_n‖``, which only a positive tolerance
reads, is not summed.  z and w are the solve's own buffers, laid out
once a solve with a leading dimension padded to :data:`ALIGN` floats
(:func:`_state`), so that every bulk copy is 16-byte aligned, and updated
in place.  No float atomics: the same batch gives the same bits.

:func:`takes` picks the solves that the kernels run: CUDA float32, an
unsharded dense operator of r ≤ :data:`R_MAX` columns and no right
factor, ``tol == 0``.  Every other solve keeps the loop.  The plain
version of the pair is the loop itself, :func:`.boxls._admm` at
``tol == 0``, which also owns the solve's warm start, its first step and
its :class:`.boxls.ADMMInfo` (:func:`.boxls._admm_kernels`); the kernels
have no CPU version.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Tuple

import torch

from ..utils import logging as _log

R_MAX = 32          # columns of A the kernels take (kRMax of csrc/admm.cu)
CONSUMERS_MAX = 15  # consumer warps a row-pass block; one producer warp more
STAGES_MAX = 64     # stages of a block's rings, all warps'
ALIGN = 8           # floats (32 bytes): rows, segments, tiles and ld
TILE = 640          # rows a stage aims at
RING_MIN = 65536    # bytes of ring a block keeps where A's strip is capped
BAR_RESERVE = 2048  # bytes kept for the mbarriers when capping the strip
MIN_ROWS = 32       # rows a segment walks at least: one a lane
STEP_THREADS = 256  # threads of an r-step block (kStepThreads)
RED_FLOATS = 432    # a consumer warp's reduction scratch (kRedFloats)
STAMPS = ("ADMM_STAMPS",)  # the measuring build's define (row_pass_stamps)

_libs: Dict[Tuple[str, ...], ctypes.CDLL] = {}
_device_info: Dict[int, Tuple[int, int]] = {}


class Plan(NamedTuple):
    """How an iteration is laid out on the card."""
    grid: int        # row-pass blocks; block q: rows [q·rows, (q+1)·rows)
    rows: int        # rows a block (the last block may have fewer)
    warps: int       # consumer warps a block; warp v: units v, v + warps, …
    splits: int      # segments a strip: a unit is one frame's segment
    seg: int         # rows a segment (the last ones may have fewer)
    tile: int        # rows a stage of the ring holds
    depth: int       # stages of each consumer warp's ring
    ld: int          # leading dimension of z, w, A's layout and the bounds
    R: int           # r rounded up to the kernels' instantiation (4, 8, 16, 32)
    slot: int        # sums a (segment, frame): 3r + 1, or r with fixed ρ
    partials: int    # floats of the partial sums, grid · splits · b · slot
    smem_bytes: int  # dynamic shared memory a row-pass block


def _padded(r: int) -> int:
    return next(R for R in (4, 8, 16, 32) if r <= R)


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def _bar_bytes(stages: int, tiles: int) -> int:
    """The ring's full and empty mbarriers and one a tile of A's strip,
    rounded up to 16."""
    return _up(8 * (2 * stages + tiles), 16)


def _plan(b: int, n: int, r: int, adapt: bool, sms: int, smem_optin: int,
          batched: bool = False) -> Plan:
    """The launch plan of a (b frames, n rows, r columns) solve on a device
    with ``sms`` SMs and ``smem_optin`` bytes of dynamic shared memory a
    block may take; ``batched``: per-frame bounds, which travel in the
    ring's stages (shared bounds are staged once a strip beside A).

    One block an SM holds its strip of A (``R`` floats a row, transposed)
    and, while the ring keeps at least ``RING_MIN`` bytes, the strips are
    those of one wave, else of the fewest equal waves.  A frame's strip is
    one unit of work, or, where fewer frames than ``CONSUMERS_MAX`` leave
    warps idle, ``splits`` segments; the consumer warps share out the
    units, as few a warp as ``CONSUMERS_MAX`` warps allow and as few warps
    as hold that many each.  A stage holds about ``TILE`` rows of a
    segment; each consumer warp has a ring of ``depth`` stages, as many as
    the rest of the shared memory holds (``STAGES_MAX`` in all at most),
    and two at least, for which tiles shrink."""
    if not (1 <= r <= R_MAX and b >= 1 and n >= 1 and sms >= 1):
        raise ValueError(f"no ADMM plan for b={b}, n={n}, r={r}, sms={sms}")
    splits = max(1, CONSUMERS_MAX // b)
    units = b * splits
    per = -(-units // CONSUMERS_MAX)           # units a warp
    warps = -(-units // per)
    R = _padded(r)
    row_bytes = 4 * R + (0 if batched else 8)  # A's strip and shared bounds
    stage_row = 4 * (4 if batched else 2)      # z, w (, lo, hi) a stage row
    cap = (smem_optin - RING_MIN - BAR_RESERVE) // row_bytes
    cap -= cap % ALIGN
    waves = -(-n // (sms * cap))
    rows = max(_up(-(-n // (sms * waves)), ALIGN),
               _up(MIN_ROWS * splits, ALIGN))
    if rows > cap:
        raise ValueError(f"no ADMM plan for b={b}, n={n}, r={r} in "
                         f"{smem_optin} bytes of shared memory")
    grid = -(-n // rows)
    seg = _up(-(-rows // splits), ALIGN)
    free = smem_optin - rows * row_bytes - warps * 4 * RED_FLOATS
    tiles = -(-seg // TILE)
    while True:   # two stages a consumer warp at least
        tile = _up(-(-seg // tiles), ALIGN)
        depth = max([d for d in range(1, STAGES_MAX // warps + 1)
                     if _bar_bytes(warps * d, tiles)
                     + warps * d * tile * stage_row <= free] or [0])
        if depth >= 2:
            break
        tiles += 1
    slot = 3 * r + 1 if adapt else r
    smem = (_bar_bytes(warps * depth, tiles) + rows * row_bytes
            + warps * (depth * tile * stage_row + 4 * RED_FLOATS))
    return Plan(grid, rows, warps, splits, seg, tile, depth, _up(n, ALIGN),
                R, slot, grid * splits * b * slot, smem)


class _Args(ctypes.Structure):
    """``AdmmArgs`` of ``csrc/admm.cu``, field for field."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "At", "lo", "hi", "z", "w", "H", "c", "AtA", "Lfix", "g", "gn", "rho",
        "rho0", "s", "pri", "dua", "k", "conv", "part", "stream")] + [
        (name, ctypes.c_int64) for name in ("bnd_bs", "H_bs", "AtA_bs")] + [
        (name, ctypes.c_int) for name in (
            "n", "ld", "r", "b", "rows", "grid", "warps", "splits", "seg",
            "tile", "depth", "slots", "adapt", "smem")] + [
        (name, ctypes.c_float) for name in (
            "alpha", "beta", "sqrt_n", "sqrt_r", "ridge")]


class _LayoutArgs(ctypes.Structure):
    """``LayoutArgs`` of ``csrc/admm.cu``, field for field."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "A", "z", "lo", "hi", "At", "zp", "w", "lo_p", "hi_p", "stream")] + [
        (name, ctypes.c_int64) for name in ("lo_bs", "hi_bs")] + [
        (name, ctypes.c_int) for name in ("n", "r", "R", "b", "ld", "bbat")]


def _library(defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The built kernel library (with ``defines``, a measuring build), its
    C signatures declared (first call builds ``csrc/admm.cu``)."""
    lib = _libs.get(defines)
    if lib is None:
        from .._build import load_library
        lib = load_library("admm", defines)
        args = ctypes.POINTER(_Args)
        for fn in ("admm_prepare", "admm_row_launch", "admm_step_launch"):
            getattr(lib, fn).argtypes = [args]
            getattr(lib, fn).restype = ctypes.c_int
        lib.admm_layout_launch.argtypes = [ctypes.POINTER(_LayoutArgs)]
        lib.admm_layout_launch.restype = ctypes.c_int
        lib.admm_device_info.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
        lib.admm_device_info.restype = ctypes.c_int
        consts = (ctypes.c_int * 7)()
        lib.admm_constants.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.admm_constants.restype = None
        lib.admm_constants(consts)
        if tuple(consts)[:6] != (R_MAX, CONSUMERS_MAX, STAGES_MAX, ALIGN,
                                 STEP_THREADS, RED_FLOATS):
            raise RuntimeError("csrc/admm.cu and its wrapper disagree on "
                               "R_MAX, CONSUMERS_MAX, STAGES_MAX, ALIGN, the "
                               "r-step's threads or RED_FLOATS")
        if defines == STAMPS:
            lib.admm_set_stamps.argtypes = [ctypes.c_void_p]
            lib.admm_set_stamps.restype = ctypes.c_int
        _libs[defines] = lib
    return lib


def device_plan(b: int, n: int, r: int, adapt: bool, device: torch.device,
                batched: bool = False) -> Plan:
    """:func:`_plan` for a CUDA device, from its SM count and dynamic
    shared memory limit (asked once a device)."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    info = _device_info.get(idx)
    if info is None:
        vals = [ctypes.c_int(0), ctypes.c_int(0)]
        with torch.cuda.device(idx):
            err = _library().admm_device_info(*[ctypes.byref(v)
                                                for v in vals])
        if err != 0:
            raise RuntimeError(f"csrc/admm.cu cannot run on this device: "
                               f"cudaError {err}")
        info = _device_info[idx] = (vals[0].value, vals[1].value)
    return _plan(b, n, r, adapt, sms=info[0], smem_optin=info[1],
                 batched=batched)


def takes(c: torch.Tensor, op, tol) -> bool:
    """Whether the kernels run this solve: ``c`` a CUDA float32 tensor, the
    operator unsharded (``op.axis`` None), with no right factor (``op.R``
    None), dense with 1 ≤ r ≤ :data:`R_MAX` columns and at least one row,
    and the fixed budget ``tol == 0``."""
    A = op.A
    return (c.is_cuda and c.dtype == torch.float32
            and op.axis is None and op.R is None and float(tol) == 0.0
            and A.layout == torch.strided and A.ndim == 2
            and A.shape[0] >= 1 and 1 <= A.shape[1] <= R_MAX)


class _State(NamedTuple):
    """One solve's tensors, as the kernels read them."""
    At: torch.Tensor       # (R/4, ld, 4): A's columns in fours, zero past n, r
    lo: torch.Tensor       # (ld,), or (b, ld) with hi (b, ld) too
    hi: torch.Tensor
    z: torch.Tensor        # (b, ld)
    w: torch.Tensor        # (b, ld), unscaled: the frame's w is s·w
    H: torch.Tensor        # (r, r) or (b, r, r)
    c: torch.Tensor        # (b, r)
    AtA: torch.Tensor      # (r, r) or (b, r, r)
    Lfix: torch.Tensor     # (b, r, r) the fixed-ρ factor; unused when adapting
    g: torch.Tensor        # (b, r) the accepted iterate
    gn: torch.Tensor       # (b, r) the next step's coefficients
    rho: torch.Tensor      # (b,)
    rho0: torch.Tensor
    s: torch.Tensor        # (b,) the lazy scale of w
    pri: torch.Tensor
    dua: torch.Tensor
    k: torch.Tensor        # (b,) int32
    conv: torch.Tensor     # (b,) int32, 1 once a frame has stopped
    part: torch.Tensor     # (plan.partials,)
    n: int                 # constraint rows
    alpha: float
    sqrt_n: float
    sqrt_r: float
    adapt: bool


def _per_frame(x: torch.Tensor) -> bool:
    """Whether bounds ``x`` differ between frames (a (b, n) block that is
    not one row broadcast)."""
    return x.ndim == 2 and x.shape[0] != 1 and x.stride(0) != 0


def _rows_of(x: torch.Tensor, b: int, n: int) -> torch.Tensor:
    """Bounds as the layout kernel reads them: (n,) when every frame shares
    them, else (b, n), contiguous."""
    if not _per_frame(x):
        return torch.broadcast_to(x, (b, n))[0].contiguous()
    return x.contiguous()


# ---- the kernels --------------------------------------------------------

def _launcher(st: _State, plan: Plan, lib: ctypes.CDLL):
    """The ctypes arguments of one solve, built once, and the two launch
    calls of ``lib`` that read them; the tensors stay referenced by
    ``st``.  Called with the solve's device current, as the launches
    are."""
    b, r = st.c.shape
    ptr = {f: getattr(st, f).data_ptr() for f in (
        "At", "lo", "hi", "z", "w", "H", "c", "AtA", "Lfix", "g", "gn", "rho",
        "rho0", "s", "pri", "dua", "k", "conv", "part")}
    args = _Args(
        **ptr, stream=torch.cuda.current_stream(st.c.device).cuda_stream,
        bnd_bs=plan.ld if st.lo.ndim == 2 else 0,
        H_bs=r * r if st.H.ndim == 3 else 0,
        AtA_bs=r * r if st.AtA.ndim == 3 else 0,
        n=st.n,
        ld=plan.ld, r=r, b=b, rows=plan.rows, grid=plan.grid,
        warps=plan.warps, splits=plan.splits, seg=plan.seg, tile=plan.tile,
        depth=plan.depth, slots=plan.grid * plan.splits,
        adapt=int(st.adapt), smem=plan.smem_bytes,
        alpha=st.alpha, beta=1.0 - st.alpha, sqrt_n=st.sqrt_n,
        sqrt_r=st.sqrt_r, ridge=64.0 * torch.finfo(torch.float32).eps)
    ref = ctypes.byref(args)          # holds ``args`` alive
    err = lib.admm_prepare(ref)
    if err != 0:
        raise RuntimeError(f"csrc/admm.cu cannot take this plan: "
                           f"cudaError {err}")
    return ref, lib.admm_row_launch, lib.admm_step_launch


def _check(H, c, A, lo, hi, AtA) -> None:
    """Raise on what the kernels do not take."""
    if not all(isinstance(x, torch.Tensor) and x.is_cuda
               and x.dtype == torch.float32 for x in (H, c, A, lo, hi, AtA)):
        raise ValueError("the ADMM kernels need CUDA float32 tensors")
    b, r = c.shape
    n = A.shape[0]
    if A.ndim != 2 or A.shape[1] != r or not 1 <= r <= R_MAX:
        raise ValueError(f"the ADMM kernels take an (n, r) operator with "
                         f"1 <= r <= {R_MAX}, got {tuple(A.shape)} for r={r}")
    if not (1 <= n < 2 ** 31 - ALIGN and 1 <= b < 2 ** 31):
        raise ValueError(f"the ADMM kernels take 1 <= n < 2**31 - {ALIGN}, "
                         f"1 <= b < 2**31, got n={n}, b={b}")
    for name, x in (("lo", lo), ("hi", hi)):
        if x.ndim > 2 or (x.ndim and x.shape[-1] != n) or (
                x.ndim == 2 and x.shape[0] not in (1, b)):
            raise ValueError(f"{name} must be (n,) or (b, n), got "
                             f"{tuple(x.shape)}")
    for name, x in (("H", H), ("AtA", AtA)):
        if x.ndim not in (2, 3) or x.shape[-2:] != (r, r) or (
                x.ndim == 3 and x.shape[0] != b):
            raise ValueError(f"{name} must be (r, r) or (b, r, r), got "
                             f"{tuple(x.shape)}")


def plan_for(H, c, A, lo, hi, AtA, adapt: bool) -> Plan:
    """The launch plan of a solve on ``c``'s card; raises on what the
    kernels do not take."""
    _check(H, c, A, lo, hi, AtA)
    b, r = c.shape
    return device_plan(b, A.shape[0], r, adapt, c.device,
                       batched=_per_frame(lo) or _per_frame(hi))


def _state(plan: Plan, lib: ctypes.CDLL, H, c, A, lo, hi, AtA, L, g, z, gn,
           rho, over_relax, adapt_rho: bool, sqrt_n: float) -> _State:
    """A solve's tensors as the kernels read them, laid out once a solve by
    one launch of ``lib``'s layout kernel: A as (R/4, ld, 4), its columns
    in fours zero-padded to R; z and w = 0 at the plan's leading dimension
    ld; the bounds at ld, one row or, where either differs between frames,
    both a row a frame (:func:`_rows_of`'s rows, padded)."""
    b, r = c.shape
    n = A.shape[0]
    dtype, dev = c.dtype, c.device
    lo, hi = (_rows_of(x, b, n) for x in (lo, hi))
    per_frame = lo.ndim == 2 or hi.ndim == 2
    A, z = A.contiguous(), z.contiguous()
    At = A.new_empty(plan.R // 4, plan.ld, 4)
    zp = z.new_empty(b, plan.ld)
    w = torch.empty_like(zp)
    lo_p, hi_p = (x.new_empty((b, plan.ld) if per_frame else (plan.ld,))
                  for x in (lo, hi))
    args = _LayoutArgs(
        A=A.data_ptr(), z=z.data_ptr(), lo=lo.data_ptr(), hi=hi.data_ptr(),
        At=At.data_ptr(), zp=zp.data_ptr(), w=w.data_ptr(),
        lo_p=lo_p.data_ptr(), hi_p=hi_p.data_ptr(),
        stream=torch.cuda.current_stream(dev).cuda_stream,
        lo_bs=n if lo.ndim == 2 else 0, hi_bs=n if hi.ndim == 2 else 0,
        n=n, r=r, R=plan.R, b=b, ld=plan.ld, bbat=int(per_frame))
    with torch.cuda.device(dev):
        err = lib.admm_layout_launch(ctypes.byref(args))
    if err != 0:
        raise RuntimeError(f"csrc/admm.cu layout launch failed: cudaError "
                           f"{err}")
    inf = torch.full((b,), float("inf"), dtype=dtype, device=dev)
    return _State(
        At=At, lo=lo_p, hi=hi_p, z=zp, w=w, H=H.contiguous(),
        c=c.contiguous(),
        AtA=AtA.contiguous(), Lfix=L.contiguous(), g=g.contiguous(),
        gn=gn.contiguous(), rho=rho, rho0=rho.clone(),
        s=torch.ones(b, dtype=dtype, device=dev), pri=inf, dua=inf.clone(),
        k=torch.zeros(b, dtype=torch.int32, device=dev),
        conv=torch.zeros(b, dtype=torch.int32, device=dev),
        part=torch.empty(plan.partials, dtype=dtype, device=dev),
        n=n, alpha=float(over_relax), sqrt_n=sqrt_n, sqrt_r=float(r) ** 0.5,
        adapt=bool(adapt_rho))


def _iterate(st: _State, plan: Plan, lib: ctypes.CDLL, max_iter: int) -> None:
    """``max_iter`` iterations of ``lib``'s kernels on ``st``, each a
    ``boxls.iter`` span: two launches, no host read, nothing allocated."""
    rec = _log.recorder()
    with torch.cuda.device(st.c.device):
        ref, row, step = _launcher(st, plan, lib)
        for _ in range(max_iter):
            if rec is not None:
                at = rec.begin("boxls.iter")
            e1 = row(ref)
            e2 = step(ref)
            if e1 or e2:
                raise RuntimeError(f"csrc/admm.cu launch failed: cudaError "
                                   f"{e1 or e2}")
            if rec is not None:
                rec.end(at)


def admm_fused(plan: Plan, H, c, A, lo, hi, AtA, L, g, z, gn, rho,
               max_iter: int, over_relax, adapt_rho: bool, sqrt_n: float):
    """The iterations of :func:`.boxls._admm` at ``tol == 0`` from its warm
    start (``g``, ``z``, w = 0), its factor ``L`` at the initial penalty
    ``rho`` and its first step's coefficients ``gn``, each as the row pass
    and the r-step of ``csrc/admm.cu`` (no host read, nothing allocated in
    the loop); with ``adapt_rho=False``, ``L`` is the factor throughout.
    ``z`` is read once, into the solve's padded buffer, and left as it is.
    Returns the accepted iterate and, per frame, the iterations and the
    last primal and dual residuals: ``(g, k, pri, dua)``.  The iterations'
    launches, two an iteration, are counted in the recorder's
    ``admm.kernel_launches``; the solve's one layout launch, in place of
    w's zero fill, is not."""
    lib = _library()
    st = _state(plan, lib, H, c, A, lo, hi, AtA, L, g, z, gn, rho, over_relax,
                adapt_rho, sqrt_n)
    _iterate(st, plan, lib, max_iter)
    _log.launched("admm", 2 * max_iter)
    return st.g, st.k, st.pri, st.dua


def row_pass_stamps(plan: Plan, H, c, A, lo, hi, AtA, L, g, z, gn, rho,
                    max_iter: int, over_relax, adapt_rho: bool,
                    sqrt_n: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Where a row pass's time goes, for measurement only (nothing on a
    user's path calls it, and it is not counted in
    ``admm.kernel_launches``): :func:`admm_fused`'s iterations with a build
    of ``csrc/admm.cu`` with ``-DADMM_STAMPS``, which updates ``g``, ``gn``
    and ``rho`` in place as :func:`admm_fused` does.  Returns the accepted
    iterate, the same bits as :func:`admm_fused`'s, and the last row pass's
    stamps, int64 (plan.grid, 72), one row a block, as the source's note
    lists them: clock64() readings and cycle counts of the producer and of
    each consumer warp."""
    lib = _library(STAMPS)
    stamps = torch.zeros(plan.grid, 72, dtype=torch.int64, device=c.device)
    with torch.cuda.device(c.device):
        err = lib.admm_set_stamps(stamps.data_ptr())
    if err != 0:
        raise RuntimeError(f"admm_set_stamps failed: cudaError {err}")
    st = _state(plan, lib, H, c, A, lo, hi, AtA, L, g, z, gn, rho, over_relax,
                adapt_rho, sqrt_n)
    _iterate(st, plan, lib, max_iter)
    return st.g, stamps
