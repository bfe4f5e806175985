"""Greedy QRCP pivots on the card: the persistent cooperative CUDA kernel
of ``csrc/qrcp.cu``, its launch plan, wrapper, launch counter and dispatch.

One kernel is the port of both TPU kernels of
``openmeasure_tpu/linalg/qrcp_pallas.py`` (the in-VMEM ``_qrcp_kernel``
and the HBM-streamed ``_qrcp_streamed_kernel``): a call is one
cooperative launch of one block per SM, in which each block holds as many
of its columns in shared memory as fit and reads the rest from global
memory at each pivot step (see the note at the top of the CUDA source).
The kernel takes the optional ``row_scale`` in-kernel, as the streamed TPU
kernel does, and reads the panel through its strides: the main path hands
it ``B.T`` of a row-major (n, r) panel, whose column j is r contiguous
floats, and no ``.contiguous()`` copy is made.

The launch plan is computed here, by :func:`_plan`, from the device's SM
count, shared memory and occupancy, so that it can be tested without a
card.  The plain version is :func:`openmeasure_torch.linalg.qrcp.qrcp_pivots`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from .qrcp import _sweep, qrcp_pivots

K_MAX = 128         # pivot cap of the kernel (and of the TPU kernels)
THREADS = 1024      # threads per block, kThreads of csrc/qrcp.cu
MIN_COLS = 32       # a block owns at least a warp's worth of columns
Q_STAGE_FLOATS = 4096  # every block keeps Q (k·r floats) in shared memory
                       # up to this size
L1_KEEP = 64 * 1024  # shared memory left to L1 when columns are streamed
                     # from global memory (see csrc/qrcp.cu)

_lib = None
_device_info: Dict[int, Tuple[int, int, int]] = {}


class Plan(NamedTuple):
    """How one call is laid out on the card."""
    grid: int             # blocks, one launch, all co-resident
    cols_per_block: int   # block b owns columns [b·c, min(n, (b+1)·c))
    resident: int         # the first this-many of a block's columns live
                          # in its shared memory (fewer in a short last block)
    resident_cols: int    # resident columns over all blocks
    q_floats: int         # floats of Q staged in shared memory: k·r, or 0
    smem_bytes: int       # dynamic shared memory per block
    barriers: int         # grid barriers in the call (2k)


def _plan(r: int, n: int, k: int, sms: int, smem_optin: int,
          blocks_per_sm: int) -> Plan:
    """The launch plan of an (r, n) panel and k pivots on a device with
    ``sms`` SMs, ``smem_optin`` bytes of dynamic shared memory a block may
    take and ``blocks_per_sm`` co-resident blocks per SM at that size.

    The grid is the co-resident maximum, and no more blocks than give each
    at least ``MIN_COLS`` columns; columns are split in contiguous ranges
    with no empty block; each block holds the leading columns of its range
    in shared memory, r floats each, beside the staged Q: all of them when
    they fit, else as many as fit in all but ``L1_KEEP`` bytes, which stay
    L1 for the columns read from global memory."""
    if sms < 1 or blocks_per_sm < 1:
        raise ValueError(f"no co-resident block of the QRCP kernel fits on "
                         f"this device (sms={sms}, blocks_per_sm="
                         f"{blocks_per_sm})")
    grid = max(1, min(sms * blocks_per_sm, -(-n // MIN_COLS)))
    cpb = -(-n // grid)
    grid = -(-n // cpb)
    q_floats = k * r if k * r <= Q_STAGE_FLOATS else 0
    budget = smem_optin - 4 * q_floats
    if 4 * r * cpb <= budget:
        resident = cpb
    else:
        resident = max(0, (budget - L1_KEEP) // (4 * r))
    last = n - (grid - 1) * cpb
    resident_cols = (grid - 1) * resident + min(resident, last)
    return Plan(grid, cpb, resident, resident_cols, q_floats,
                4 * (q_floats + resident * r), 2 * k)


def _library() -> ctypes.CDLL:
    """The built kernel library, its C signatures declared (first call
    builds ``csrc/qrcp.cu``)."""
    global _lib
    if _lib is None:
        from .._build import load_library
        lib = load_library("qrcp")
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.qrcp_pivots_launch.argtypes = [p, i32, i32, i64, i64, p, i32, i32,
                                           i32, i32, i32, i32,
                                           p, p, p, p, p, p]
        lib.qrcp_pivots_launch.restype = ctypes.c_int
        lib.qrcp_device_info.argtypes = [ctypes.POINTER(i32)] * 3
        lib.qrcp_device_info.restype = ctypes.c_int
        lib.qrcp_threads.argtypes = []
        lib.qrcp_threads.restype = ctypes.c_int
        if lib.qrcp_threads() != THREADS:
            raise RuntimeError(f"csrc/qrcp.cu runs {lib.qrcp_threads()} "
                               f"threads a block, the wrapper plans {THREADS}")
        _lib = lib
    return _lib


def device_plan(r: int, n: int, k: int, device: torch.device) -> Plan:
    """:func:`_plan` for a CUDA device, from its SM count, the kernel's
    dynamic shared memory limit and occupancy (asked once per device)."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    info = _device_info.get(idx)
    if info is None:
        lib = _library()
        vals = [ctypes.c_int(0) for _ in range(3)]
        with torch.cuda.device(idx):
            err = lib.qrcp_device_info(*[ctypes.byref(v) for v in vals])
        if err != 0:
            raise RuntimeError(f"csrc/qrcp.cu cannot run on this device: "
                               f"cudaError {err}")
        info = _device_info[idx] = tuple(v.value for v in vals)
    sms, smem, per_sm = info
    return _plan(r, n, k, sms, smem, per_sm)


def _strides_ok(shape: Tuple[int, int], strides: Tuple[int, int]) -> bool:
    """Whether the kernel can read an (r, n) view through its strides: it
    reads A[i * sr + j * sc], so both orders of a dense or column-sliced
    panel are fine; zero or overlapping strides are not."""
    (r, n), (sr, sc) = shape, strides
    return sr >= 1 and sc >= 1 and (sr >= sc * n or sc >= sr * r)


def _check(A: torch.Tensor, k: int, row_scale) -> None:
    if not isinstance(A, torch.Tensor) or not A.is_cuda:
        raise ValueError("qrcp_pivots_cuda needs a CUDA tensor; CPU tensors "
                         "take qrcp_pivots (or qrcp_pivots_auto).")
    if A.dtype != torch.float32:
        raise ValueError(f"qrcp_pivots_cuda needs float32, got {A.dtype}")
    if A.ndim != 2:
        raise ValueError(f"A must be an (r, n) panel, got shape {tuple(A.shape)}")
    r, n = A.shape
    if not 1 <= r < 2 ** 31 or not 1 <= n < 2 ** 31:
        raise ValueError(f"qrcp_pivots_cuda supports 1 <= r, n < 2**31, "
                         f"got {(r, n)}")
    if not 1 <= k <= K_MAX:
        raise ValueError(f"qrcp_pivots_cuda supports 1 <= k <= {K_MAX} "
                         f"(got k={k}); use linalg.qrcp.qrcp_pivots for "
                         "larger pivot counts.")
    if not _strides_ok((r, n), A.stride()):
        raise ValueError(f"qrcp_pivots_cuda needs a non-overlapping (r, n) "
                         f"view, got strides {A.stride()} for shape {(r, n)}")
    if row_scale is not None:
        if not isinstance(row_scale, torch.Tensor) or row_scale.shape != (r,):
            raise ValueError("row_scale must be an (r,) tensor")


def _launch(A: torch.Tensor, k: int, row_scale: Optional[torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Enqueue the kernel's one launch; returns ``(pivots int32 (k,), final
    deflated norms² (n,))`` on A's device, without synchronizing."""
    _check(A, k, row_scale)
    lib = _library()
    r, n = A.shape
    sr, sc = A.stride()
    dev = A.device
    plan = device_plan(r, n, k, dev)
    with torch.cuda.device(dev):
        pivots = torch.empty(k, dtype=torch.int32, device=dev)
        norms = torch.empty(n, dtype=torch.float32, device=dev)
        part_v = torch.empty(plan.grid, dtype=torch.float32, device=dev)
        part_i = torch.empty(plan.grid, dtype=torch.int32, device=dev)
        Q = torch.empty(k * r, dtype=torch.float32, device=dev)
        scale = None
        if row_scale is not None:
            scale = row_scale.to(device=dev, dtype=torch.float32).contiguous()
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.qrcp_pivots_launch(
            A.data_ptr(), r, n, sr, sc,
            None if scale is None else scale.data_ptr(), k, plan.grid,
            plan.cols_per_block, plan.resident, int(plan.q_floats > 0),
            plan.smem_bytes,
            pivots.data_ptr(), norms.data_ptr(), part_v.data_ptr(),
            part_i.data_ptr(), Q.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"csrc/qrcp.cu launch failed: cudaError {err}")
    qrcp_pivots_cuda.launches += 1
    return pivots, norms


def qrcp_pivots_cuda(A: torch.Tensor, k: int,
                     row_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """First ``k`` greedy column pivots of ``diag(row_scale) @ A`` for a
    CUDA fp32 (r, n) panel, by the CUDA kernel.  Returns int32 (k,) on A's
    device; launches on the current stream and does not synchronize.

    k may exceed n: the steps past n pick column 0, as the plain sweep
    does.  Raises on anything the kernel does not take (a CPU tensor,
    another dtype, k outside [1, 128], overlapping strides, a row scale
    that is not (r,)) and when a launch is refused.
    ``qrcp_pivots_cuda.launches`` counts the calls that launched the kernel
    (one launch each)."""
    return _launch(A, k, row_scale)[0]


qrcp_pivots_cuda.launches = 0


def _route(device_type: str, dtype: torch.dtype, k: int, shape: tuple,
           strides: tuple) -> str:
    """Where :func:`qrcp_pivots_auto` sends a panel: ``"kernel"``,
    ``"copy"`` (a contiguous copy, then the kernel) or ``"plain"`` (the
    plain sweep on the panel's device).

    As in the JAX package's gate, a CUDA fp32 panel with k ≤ 128 goes to
    the kernel, which raises on what it does not take; an (r, n) view it
    cannot read through its strides (a zero stride, overlapping rows or
    columns) is copied first.  Everything else takes the plain sweep."""
    if device_type != "cuda" or dtype != torch.float32 or k > K_MAX:
        return "plain"
    if len(shape) == 2 and not _strides_ok(shape, strides):
        return "copy"
    return "kernel"


def qrcp_pivots_auto(A: torch.Tensor, k: int,
                     row_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """QRCP pivots of ``diag(row_scale) @ A`` by the best route for the
    tensor's device, mirroring the JAX package's gate (keyed there on
    ``jax.default_backend() == "tpu"``, here on the tensor's device; see
    :func:`_route`):

    * a CUDA fp32 panel with k ≤ 128 goes to the CUDA kernel, with
      ``row_scale`` applied in-kernel; a zero-stride or overlapping view is
      copied to a contiguous panel first;
    * a CPU tensor takes the plain sweep :func:`qrcp_pivots`, with
      ``row_scale`` applied to a copy;
    * a CUDA tensor that is not fp32, or asks for k > 128, takes the plain
      sweep on the card, as the JAX package sends such panels to its jnp
      sweep.

    There is no fallback: a kernel that fails to build or launch raises.
    """
    if row_scale is not None:
        row_scale = torch.as_tensor(row_scale, dtype=A.dtype, device=A.device)
    route = _route(A.device.type, A.dtype, k, tuple(A.shape), A.stride())
    if route == "copy":
        A = A.clone(memory_format=torch.contiguous_format)
    if route != "plain":
        return qrcp_pivots_cuda(A, k, row_scale=row_scale)
    if row_scale is not None:
        A = A * row_scale[:, None]
    return qrcp_pivots(A, k)


def qrcp_pivots_sharded(A: torch.Tensor, k: int, mesh=None,
                        gidx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """QRCP pivots of a panel whose columns are sharded over the mesh's
    ``state`` axis: ``A`` is this rank's (r, n_local) block, ``gidx`` the
    global index of each of its columns (default: the ranks' blocks
    stacked in rank order).  Returns the global int32 pivots (k,),
    replicated.

    The JAX package's sharded-operand rule (``qrcp_pivots_auto``'s gate):
    on an axis of one rank the panel is whole and takes
    :func:`qrcp_pivots_auto` — the CUDA kernel for a CUDA fp32 panel; on
    more ranks the plain sweep's arithmetic runs on each rank's columns
    with the argmax all-gathered and the pivot column taken from its
    owner, bit-equal to the unsharded plain sweep.  No kernel runs then,
    as a Pallas call is not partitioned in the JAX package either."""
    from ..parallel._comm import active, axis_of, local_gidx
    ax = active(axis_of(mesh))
    if ax is None:
        return qrcp_pivots_auto(A, k)
    if gidx is None:
        gidx = local_gidx(ax, A.shape[1], A.device)
    return _sweep(A, k, ax, gidx)[0]
