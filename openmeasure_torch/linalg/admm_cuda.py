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
  block of rows (``‖Ag − z_n‖²``, ``Aᵀ(z_n − z)``, ``Aᵀz_n``, ``Aᵀw_n``;
  with fixed ρ only ``Aᵀ(z_n − w_n)``) into one slot a (block, frame);
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
reads, is not summed.  z and w are the solve's own buffers, updated in
place.  No float atomics: the same batch gives the same bits.

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
WARPS_MAX = 16      # warps a row-pass block, one frame at a time each
TARGET_WARPS = 16   # resident warps an SM that the row pass's grid aims at
MIN_ROWS = 32       # rows a block walks at least: one a lane
STEP_THREADS = 256  # threads of an r-step block (kStepThreads)

_lib = None
_device_info: Dict[int, Tuple[int, int]] = {}


class Plan(NamedTuple):
    """How an iteration is laid out on the card."""
    grid: int        # row-pass blocks; block q: rows [q·rows, (q+1)·rows)
    rows: int        # rows a block (the last block may have fewer)
    warps: int       # warps a row-pass block; warp v: frames v, v + warps, …
    R: int           # r rounded up to the kernels' instantiation (4, 8, 16, 32)
    slot: int        # partial sums a (block, frame): 3r + 1, or r with fixed ρ
    partials: int    # floats of the partial-sum buffer, grid · b · slot
    smem_bytes: int  # dynamic shared memory a row-pass block: its strip of A


def _padded(r: int) -> int:
    return next(R for R in (4, 8, 16, 32) if r <= R)


def _plan(b: int, n: int, r: int, adapt: bool, sms: int,
          smem_optin: int) -> Plan:
    """The launch plan of a (b frames, n rows, r columns) solve on a device
    with ``sms`` SMs and ``smem_optin`` bytes of dynamic shared memory a
    block may take.

    A block holds its strip of A (``R`` floats a row, transposed) in shared
    memory for all its frames; its warps share out the frames, as few a
    warp as ``WARPS_MAX`` warps allow, and as few warps as hold that many
    frames each.  The grid gives each SM about ``TARGET_WARPS`` warps in
    equal strips, no strip shorter than ``MIN_ROWS`` or longer than a
    block's share of the SM's shared memory holds."""
    if not (1 <= r <= R_MAX and b >= 1 and n >= 1 and sms >= 1):
        raise ValueError(f"no ADMM plan for b={b}, n={n}, r={r}, sms={sms}")
    per = -(-b // min(b, WARPS_MAX))           # frames a warp
    warps = -(-b // per)
    blocks_per_sm = max(1, TARGET_WARPS // warps)
    R = _padded(r)
    cap = max(MIN_ROWS, smem_optin // blocks_per_sm // (4 * R))
    rows = min(max(MIN_ROWS, -(-n // (sms * blocks_per_sm))), cap)
    grid = -(-n // rows)
    slot = 3 * r + 1 if adapt else r
    return Plan(grid, rows, warps, R, slot, grid * b * slot, 4 * R * rows)


class _Args(ctypes.Structure):
    """``AdmmArgs`` of ``csrc/admm.cu``, field for field."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "A", "lo", "hi", "z", "w", "H", "c", "AtA", "Lfix", "g", "gn", "rho",
        "rho0", "s", "pri", "dua", "k", "conv", "part", "stream")] + [
        (name, ctypes.c_int64) for name in (
            "lo_bs", "hi_bs", "H_bs", "AtA_bs")] + [
        (name, ctypes.c_int) for name in (
            "n", "r", "b", "rows", "grid", "warps", "adapt", "smem")] + [
        (name, ctypes.c_float) for name in (
            "alpha", "beta", "sqrt_n", "sqrt_r", "ridge")]


def _library() -> ctypes.CDLL:
    """The built kernel library, its C signatures declared (first call
    builds ``csrc/admm.cu``)."""
    global _lib
    if _lib is None:
        from .._build import load_library
        lib = load_library("admm")
        args = ctypes.POINTER(_Args)
        for fn in ("admm_prepare", "admm_row_launch", "admm_step_launch"):
            getattr(lib, fn).argtypes = [args]
            getattr(lib, fn).restype = ctypes.c_int
        lib.admm_device_info.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
        lib.admm_device_info.restype = ctypes.c_int
        for fn in ("admm_r_max", "admm_step_threads"):
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = ctypes.c_int
        if (lib.admm_r_max(), lib.admm_step_threads()) != (R_MAX,
                                                           STEP_THREADS):
            raise RuntimeError("csrc/admm.cu and its wrapper disagree on "
                               "R_MAX or the r-step's threads")
        _lib = lib
    return _lib


def device_plan(b: int, n: int, r: int, adapt: bool,
                device: torch.device) -> Plan:
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
    return _plan(b, n, r, adapt, sms=info[0], smem_optin=info[1])


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
    A: torch.Tensor        # (n, r)
    lo: torch.Tensor       # (n,) or (b, n)
    hi: torch.Tensor
    z: torch.Tensor        # (b, n)
    w: torch.Tensor        # (b, n), unscaled: the frame's w is s·w
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
    alpha: float
    sqrt_n: float
    sqrt_r: float
    adapt: bool


def _rows_of(x: torch.Tensor, b: int, n: int) -> torch.Tensor:
    """Bounds as the row pass reads them: (n,) when every frame shares them,
    else (b, n), contiguous."""
    if x.ndim < 2 or x.shape[0] == 1 or x.stride(0) == 0:
        return torch.broadcast_to(x, (b, n))[0].contiguous()
    return x.contiguous()


# ---- the kernels --------------------------------------------------------

def _launcher(st: _State, plan: Plan):
    """The ctypes arguments of one solve, built once, and the two launch
    calls that read them; the tensors stay referenced by ``st``.  Called
    with the solve's device current, as the launches are."""
    lib = _library()
    b, r = st.c.shape
    ptr = {f: getattr(st, f).data_ptr() for f in (
        "A", "lo", "hi", "z", "w", "H", "c", "AtA", "Lfix", "g", "gn", "rho",
        "rho0", "s", "pri", "dua", "k", "conv", "part")}
    args = _Args(
        **ptr, stream=torch.cuda.current_stream(st.c.device).cuda_stream,
        lo_bs=st.lo.shape[-1] if st.lo.ndim == 2 else 0,
        hi_bs=st.hi.shape[-1] if st.hi.ndim == 2 else 0,
        H_bs=r * r if st.H.ndim == 3 else 0,
        AtA_bs=r * r if st.AtA.ndim == 3 else 0,
        n=st.A.shape[0], r=r, b=b, rows=plan.rows, grid=plan.grid,
        warps=plan.warps, adapt=int(st.adapt), smem=plan.smem_bytes,
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
    if not (1 <= n < 2 ** 31 and 1 <= b < 2 ** 31):
        raise ValueError(f"the ADMM kernels take 1 <= n, b < 2**31, got "
                         f"n={n}, b={b}")
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
    return device_plan(b, A.shape[0], r, adapt, c.device)


def admm_fused(plan: Plan, H, c, A, lo, hi, AtA, L, g, z, gn, rho,
               max_iter: int, over_relax, adapt_rho: bool, sqrt_n: float):
    """The iterations of :func:`.boxls._admm` at ``tol == 0`` from its warm
    start (``g``, ``z``, w = 0), its factor ``L`` at the initial penalty
    ``rho`` and its first step's coefficients ``gn``, each as the row pass
    and the r-step of ``csrc/admm.cu`` (no host read, nothing allocated in
    the loop); with ``adapt_rho=False``, ``L`` is the factor throughout.
    Returns the accepted iterate and, per frame, the iterations and the
    last primal and dual residuals: ``(g, k, pri, dua)``.  The launches
    are counted in the recorder's ``admm.kernel_launches``."""
    b, r = c.shape
    n = A.shape[0]
    dtype, dev = c.dtype, c.device
    inf = torch.full((b,), float("inf"), dtype=dtype, device=dev)
    st = _State(
        A=A.contiguous(), lo=_rows_of(lo, b, n), hi=_rows_of(hi, b, n), z=z,
        w=torch.zeros_like(z), H=H.contiguous(), c=c.contiguous(),
        AtA=AtA.contiguous(), Lfix=L.contiguous(), g=g.contiguous(),
        gn=gn.contiguous(), rho=rho, rho0=rho.clone(),
        s=torch.ones(b, dtype=dtype, device=dev), pri=inf, dua=inf.clone(),
        k=torch.zeros(b, dtype=torch.int32, device=dev),
        conv=torch.zeros(b, dtype=torch.int32, device=dev),
        part=torch.empty(plan.partials, dtype=dtype, device=dev),
        alpha=float(over_relax), sqrt_n=sqrt_n, sqrt_r=float(r) ** 0.5,
        adapt=bool(adapt_rho))
    rec = _log.recorder()
    with torch.cuda.device(dev):
        ref, row, step = _launcher(st, plan)
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
    _log.launched("admm", 2 * max_iter)
    return st.g, st.k, st.pri, st.dua
