"""Device and dtype resolution for the port's constructors.

A constructor runs on the card unless the caller asks for the CPU: its
`device=None` default resolves to "cuda". Asking for a CUDA device on a
machine without one raises: nothing moves work to the CPU on its own.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

_NUMPY_DTYPES = {
    torch.float32: np.float32,
    torch.float64: np.float64,
}


def resolve_device(device=None) -> torch.device:
    """`device`, or "cuda" when it is None; raises if that is CUDA and
    there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False"
        )
    return dev


def numpy_dtype(dtype: torch.dtype):
    """NumPy twin of a floating torch dtype, for host-side assembly."""
    try:
        return _NUMPY_DTYPES[dtype]
    except KeyError:
        raise ValueError(f"no host assembly dtype for {dtype}") from None


def check_same_device(x: torch.Tensor, *tensors: Optional[torch.Tensor]) -> None:
    """Raise unless every tensor (None for an absent one) lies on x's device."""
    for t in tensors:
        if t is not None and t.device != x.device:
            raise ValueError(
                f"operator tensor on {t.device} but vector on {x.device}"
            )
