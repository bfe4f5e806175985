"""The reference's arithmetic: float64, or the control's float32 with
TF32 matrix products (the step below the configurations' float32 with TF32
off).

:func:`arithmetic` yields an :class:`Arithmetic`: its ``dtype`` and its
``mm``, which every matrix product of the reference goes through.  In the
control, ``mm`` rounds both operands to TF32 (10 explicit mantissa bits,
to nearest) before an fp32 product, so the control is computed in TF32
whatever kernel the library would pick for a shape, and TF32 is also
switched on for the library's own products."""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to the nearest TF32 value, ties to even."""
    b = x.contiguous().view(torch.int32)
    low = b & 0x1FFF
    keep = b & ~0x1FFF
    half = 0x1000
    odd = (b >> 13) & 1
    up = (low > half) | ((low == half) & (odd == 1))
    out = torch.where(up, keep + 0x2000, keep)
    # leave inf and NaN alone
    special = (b & 0x7F800000) == 0x7F800000
    return torch.where(special, b, out).view(torch.float32)


@dataclass(frozen=True)
class Arithmetic:
    name: str
    dtype: torch.dtype

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "tf32":
            return tf32_round(a) @ tf32_round(b)
        return a @ b


@contextlib.contextmanager
def arithmetic(name: str):
    """``"float64"``: float64 tensors, TF32 off.  ``"tf32"``: float32
    tensors, products in TF32.  Restores the process's TF32 switches on
    exit."""
    if name not in ("float64", "tf32"):
        raise ValueError(f"unknown arithmetic {name!r}")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    tf32 = name == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield Arithmetic(name, torch.float32 if tf32 else torch.float64)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])
