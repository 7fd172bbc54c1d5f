"""Native (C++/OpenMP) CPU engine: float64 / high-precision NUFFT paths.

``tensorflow_nufft_tpu_torch.native.nufft`` is the eager NumPy API and
``tensorflow_nufft_tpu_torch.native.engine`` the low-level bindings;
``Options(backend="native")`` runs the engine inside the torch
transforms.
"""

from tensorflow_nufft_tpu_torch.native.engine import available
from tensorflow_nufft_tpu_torch.native.nufft_impl import (
    interp, nufft, spread)

__all__ = ["available", "nufft", "interp", "spread"]
