"""Batched small-SPD inverse and log-determinant on the card: the CUDA
kernel of ``csrc/chol.cu`` and its wrapper.

The kernel is the port of the TPU kernel ``_chol_kernel``
(``openmeasure_tpu/linalg/chol_pallas.py:85``): one launch for a whole
(B, p, p) batch, one thread block per matrix, K⁻¹ = L⁻ᵀL⁻¹ formed inside
the kernel.  The dispatch that decides which tensors reach it, and the
plain versions, are in :mod:`openmeasure_torch.linalg.chol`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from ..utils import logging as _log

P_MAX = 128     # size cap of the kernel (the TPU kernel's unroll cap)
STAMPS = ("CHOL_STAMPS",)   # the defines of the phase-stamping build

_libs: Dict[Tuple[str, ...], ctypes.CDLL] = {}


def _library(defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The built kernel library, its C signatures declared (first call
    builds ``csrc/chol.cu``, with ``-D`` each of ``defines``)."""
    lib = _libs.get(defines)
    if lib is None:
        from .._build import load_library
        lib = load_library("chol", defines)
        p, i32 = ctypes.c_void_p, ctypes.c_int
        lib.chol_inv_logdet_launch.argtypes = [p, i32, i32, p, p, p]
        lib.chol_inv_logdet_launch.restype = ctypes.c_int
        if defines == STAMPS:
            lib.chol_set_stamps.argtypes = [p]
            lib.chol_set_stamps.restype = ctypes.c_int
        _libs[defines] = lib
    return lib


def _check(K: torch.Tensor) -> None:
    if not isinstance(K, torch.Tensor) or not K.is_cuda:
        raise ValueError("chol_inv_logdet_cuda needs a CUDA tensor; CPU "
                         "tensors take chol_inv_logdet_auto.")
    if K.dtype != torch.float32:
        raise ValueError(f"chol_inv_logdet_cuda needs float32, got {K.dtype}")
    if K.ndim != 3 or K.shape[1] != K.shape[2]:
        raise ValueError(f"K must be a (B, p, p) batch, got shape "
                         f"{tuple(K.shape)}")
    B, p, _ = K.shape
    if not 1 <= B < 2 ** 31:
        raise ValueError(f"chol_inv_logdet_cuda supports 1 <= B < 2**31, "
                         f"got B={B}")
    if not 1 <= p <= P_MAX:
        raise ValueError(f"chol_inv_logdet_cuda supports 1 <= p <= {P_MAX}, "
                         f"got p={p}; larger matrices take "
                         "chol_inv_logdet_torch.")


def _launch(lib: ctypes.CDLL, K: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Enqueue one launch of ``lib``'s kernel on a checked batch."""
    B, p, _ = K.shape
    Kc = K.contiguous()
    with torch.cuda.device(K.device):
        kinv = torch.empty_like(Kc)
        logdet = torch.empty(B, dtype=torch.float32, device=K.device)
        stream = torch.cuda.current_stream(K.device).cuda_stream
        err = lib.chol_inv_logdet_launch(Kc.data_ptr(), B, p, kinv.data_ptr(),
                                         logdet.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"csrc/chol.cu launch failed: cudaError {err}")
    return kinv, logdet


def chol_inv_logdet_cuda(K: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(K⁻¹ (B, p, p), logdet (B,))`` of a CUDA fp32 batch of SPD
    matrices, by the CUDA kernel: one launch on the current stream, no
    synchronization.  Only the lower triangle of each matrix is read.

    Raises on anything the kernel does not take (a CPU tensor, another
    dtype, p outside [1, 128], an empty batch) and when the launch is
    refused.  Each launch is counted in the recorder's
    ``chol.kernel_launches`` (:func:`..utils.logging.launched`)."""
    _check(K)
    out = _launch(_library(), K)
    _log.launched("chol")
    return out


def chol_phase_stamps(K: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Where a launch's time goes: one launch of ``csrc/chol.cu`` built
    with ``-DCHOL_STAMPS`` on K, for measurement only (nothing on a user's
    path calls it, and it is not counted in ``chol.kernel_launches``).
    Returns ``(K⁻¹, logdet, stamps)``, the outputs bit-equal to
    :func:`chol_inv_logdet_cuda`'s and ``stamps`` int64 (B, 6, 2): for each
    block, ``clock64()`` and the global timer (ns) at the start and at
    the end of the prologue, Schur, substitution, logdet and Gram phases.

    Each stamp follows a block barrier, six more than the shipped kernel
    has; the one after the logdet keeps warp 0's logs from overlapping the
    Gram, as they do in the shipped kernel.  So the phases' times are those
    of a kernel with more barriers than the one that ships."""
    _check(K)
    lib = _library(STAMPS)
    stamps = torch.zeros(K.shape[0] * 16, dtype=torch.int64, device=K.device)
    with torch.cuda.device(K.device):
        err = lib.chol_set_stamps(stamps.data_ptr())
    if err != 0:
        raise RuntimeError(f"chol_set_stamps failed: cudaError {err}")
    kinv, logdet = _launch(lib, K)
    return kinv, logdet, stamps.view(-1, 8, 2)[:, :6]
