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
