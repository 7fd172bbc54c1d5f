"""Dtype helpers of the planar API."""

import numpy as np
import torch

FLOAT_DTYPES = (torch.float32, torch.float64)


def dtype_name(dtype: torch.dtype) -> str:
    """Plan dtype name ('complex64' / 'complex128') of a planar float
    dtype."""
    if dtype == torch.float32:
        return "complex64"
    if dtype == torch.float64:
        return "complex128"
    raise TypeError(f"Expected float32 or float64, got {dtype}.")


def as_tensor(x, dtype=None, device=None) -> torch.Tensor:
    """Tensor view of ``x`` (numpy arrays are copied; tensors are moved
    only when ``device`` or ``dtype`` differ)."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    elif not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x)
    return x.to(device=device if device is not None else x.device,
                dtype=dtype if dtype is not None else x.dtype)
