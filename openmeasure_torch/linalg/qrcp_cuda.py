"""Greedy QRCP pivots on the card: the CUDA kernel set of ``csrc/qrcp.cu``,
its wrapper, launch counter and dispatch.

One kernel set is the port of both TPU kernels of
``openmeasure_tpu/linalg/qrcp_pallas.py`` (the in-VMEM ``_qrcp_kernel``
and the HBM-streamed ``_qrcp_streamed_kernel``); their split follows the
TPU's VMEM and has no counterpart on Hopper (see the note at the top of
the CUDA source).  The kernel takes the optional ``row_scale`` in-kernel,
as the streamed TPU kernel does, and reads the panel through its strides:
the main path hands it ``B.T`` of a row-major (n, r) panel, whose column j
is r contiguous floats, and no ``.contiguous()`` copy is made.

The plain version is :func:`openmeasure_torch.linalg.qrcp.qrcp_pivots`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .qrcp import qrcp_pivots

K_MAX = 128     # pivot cap of the kernel (and of the TPU kernels)
_BLOCKS_PER_SM = 8

_lib = None


def _library() -> ctypes.CDLL:
    """The built kernel library, its C signatures declared (first call
    builds ``csrc/qrcp.cu``)."""
    global _lib
    if _lib is None:
        from .._build import load_library
        lib = load_library("qrcp")
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.qrcp_pivots_launch.argtypes = [p, i32, i32, i64, i64, p, i32, i32,
                                           p, p, p, p, p, p]
        lib.qrcp_pivots_launch.restype = ctypes.c_int
        lib.qrcp_threads.argtypes = []
        lib.qrcp_threads.restype = ctypes.c_int
        _lib = lib
    return _lib


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
    if not 1 <= k <= min(K_MAX, n):
        raise ValueError(f"qrcp_pivots_cuda supports 1 <= k <= min({K_MAX}, n)"
                         f" (got k={k}, n={n}); use linalg.qrcp.qrcp_pivots "
                         "for larger pivot counts.")
    sr, sc = A.stride()
    # the kernel reads A[i * sr + j * sc]: both orders of a dense or
    # column-sliced panel are fine; zero or overlapping strides are not
    if not (sr >= 1 and sc >= 1 and (sr >= sc * n or sc >= sr * r)):
        raise ValueError(f"qrcp_pivots_cuda needs a non-overlapping (r, n) "
                         f"view, got strides {(sr, sc)} for shape {(r, n)}")
    if row_scale is not None:
        if not isinstance(row_scale, torch.Tensor) or row_scale.shape != (r,):
            raise ValueError("row_scale must be an (r,) tensor")


def _launch(A: torch.Tensor, k: int, row_scale: Optional[torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Enqueue the kernel set; returns ``(pivots int32 (k,), final
    deflated norms² (n,))`` on A's device, without synchronizing."""
    _check(A, k, row_scale)
    lib = _library()
    r, n = A.shape
    sr, sc = A.stride()
    dev = A.device
    with torch.cuda.device(dev):
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        threads = lib.qrcp_threads()
        nblocks = max(1, min(-(-n // threads), _BLOCKS_PER_SM * sms))
        pivots = torch.empty(k, dtype=torch.int32, device=dev)
        norms = torch.empty(n, dtype=torch.float32, device=dev)
        part_v = torch.empty(nblocks, dtype=torch.float32, device=dev)
        part_i = torch.empty(nblocks, dtype=torch.int32, device=dev)
        Q = torch.empty(k * r, dtype=torch.float32, device=dev)
        scale = None
        if row_scale is not None:
            scale = row_scale.to(device=dev, dtype=torch.float32).contiguous()
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.qrcp_pivots_launch(
            A.data_ptr(), r, n, sr, sc,
            None if scale is None else scale.data_ptr(), k, nblocks,
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

    Raises on anything the kernel does not take (a CPU tensor, another
    dtype, k outside [1, min(128, n)], overlapping strides) and when a
    launch is refused.  ``qrcp_pivots_cuda.launches`` counts the calls
    that launched the kernel set."""
    return _launch(A, k, row_scale)[0]


qrcp_pivots_cuda.launches = 0


def qrcp_pivots_auto(A: torch.Tensor, k: int,
                     row_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """QRCP pivots of ``diag(row_scale) @ A`` by the best route for the
    tensor's device, mirroring the JAX package's gate (keyed there on
    ``jax.default_backend() == "tpu"``, here on the tensor's device):

    * a CUDA fp32 panel with k ≤ 128 goes to the CUDA kernel, with
      ``row_scale`` applied in-kernel (it raises if k exceeds n);
    * a CPU tensor takes the plain sweep :func:`qrcp_pivots`, with
      ``row_scale`` applied to a copy;
    * a CUDA tensor that is not fp32, or asks for k > 128, takes the plain
      sweep on the card, as the JAX package sends such panels to its jnp
      sweep.

    There is no fallback: a kernel that fails to build or launch raises.
    """
    if A.is_cuda and A.dtype == torch.float32 and k <= K_MAX:
        return qrcp_pivots_cuda(A, k, row_scale=row_scale)
    if row_scale is not None:
        A = A * torch.as_tensor(row_scale, dtype=A.dtype,
                                device=A.device)[:, None]
    return qrcp_pivots(A, k)
