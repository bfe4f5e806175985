"""Device and tensor helpers shared by every entry point of the port."""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card (``"cuda"``).  A CUDA device with no card
    present raises: the port never drops to the CPU on its own — a caller
    who wants the host passes ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested (device=None means 'cuda') but "
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the host.")
    return dev


def as_tensor(x, device: torch.device,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x`` (numpy array, tensor or scalar) as a tensor on ``device``.
    Keeps the input's dtype unless ``dtype`` is given (a float64 numpy
    array stays float64)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    a = np.asarray(x)
    if not a.flags.writeable:
        a = a.copy()        # torch refuses to wrap read-only memory
    return torch.as_tensor(a, device=device, dtype=dtype)


def to_numpy(x) -> np.ndarray:
    """Host numpy copy of a tensor (or pass-through for array-likes)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def to_numpy_once(*tensors) -> list:
    """Host numpy copies of several tensors of one device in ONE
    device-to-host copy: each is viewed as bytes, the bytes are
    concatenated on the device and read back together, then split and
    viewed as their dtypes again (bit for bit).  Counterpart of the JAX
    package's single ``jax.device_get`` of a tuple of results."""
    flat = [t.detach().contiguous().reshape(-1) for t in tensors]
    raw = torch.cat([t.view(torch.uint8) for t in flat]).cpu().numpy()
    out, at = [], 0
    for t, f in zip(tensors, flat):
        nbytes = f.numel() * f.element_size()
        np_dtype = torch.empty((), dtype=t.dtype).numpy().dtype
        out.append(raw[at:at + nbytes].view(np_dtype).reshape(tuple(t.shape)))
        at += nbytes
    return out
