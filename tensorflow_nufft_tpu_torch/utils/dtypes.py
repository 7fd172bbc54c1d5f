"""Dtype and device helpers of the entry points."""

import numpy as np
import torch

FLOAT_DTYPES = (torch.float32, torch.float64)
COMPLEX_DTYPES = (torch.complex64, torch.complex128)

_REAL_OF = {torch.complex64: torch.float32, torch.complex128: torch.float64}
_COMPLEX_OF = {v: k for k, v in _REAL_OF.items()}
_NAMES = {torch.float32: "complex64", torch.float64: "complex128"}


def is_complex_dtype(dtype: torch.dtype) -> bool:
    """Whether ``dtype`` is a complex dtype."""
    return dtype.is_complex


def real_dtype(dtype: torch.dtype) -> torch.dtype:
    """Float dtype of the precision of a complex (or float) dtype."""
    if dtype in _REAL_OF:
        return _REAL_OF[dtype]
    if dtype in FLOAT_DTYPES:
        return dtype
    raise TypeError(f"Expected a complex or float dtype, got {dtype}.")


def complex_dtype(dtype: torch.dtype) -> torch.dtype:
    """Complex dtype of the precision of a float (or complex) dtype."""
    if dtype in _COMPLEX_OF:
        return _COMPLEX_OF[dtype]
    if dtype in COMPLEX_DTYPES:
        return dtype
    raise TypeError(f"Expected a complex or float dtype, got {dtype}.")


def dtype_name(dtype: torch.dtype) -> str:
    """Plan dtype name ('complex64' / 'complex128') of a float or complex
    dtype."""
    if dtype in _REAL_OF:
        dtype = _REAL_OF[dtype]
    if dtype in _NAMES:
        return _NAMES[dtype]
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


def entry_tensors(*xs, device=None):
    """The entry points' inputs as tensors, on one device.

    With ``device``, every input moves there. Without it, tensors stay
    on the device they are on (a CPU tensor is the caller asking for the
    CPU), and other inputs (numpy arrays, lists) go to the device of the
    first tensor among ``xs`` or, when there is none, to the CUDA card.
    Non-tensor input with no tensor beside it and no ``device`` raises
    on a machine without CUDA: it never falls back to the CPU.
    """
    if device is not None:
        return tuple(as_tensor(x, device=torch.device(device)) for x in xs)
    device = next((x.device for x in xs if isinstance(x, torch.Tensor)),
                  None)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "non-tensor input (numpy array or list) goes to the CUDA "
                "device by default, and torch sees no CUDA device; pass "
                "device='cpu' (or CPU tensors) to run on the CPU")
        device = torch.device("cuda")
    return tuple(x if isinstance(x, torch.Tensor)
                 else as_tensor(x, device=device) for x in xs)
