"""Utility helpers: smooth-integer sizing, dtype helpers, batching and
profiling spans."""

from tensorflow_nufft_tpu_torch.utils.smooth import next_smooth_integer
from tensorflow_nufft_tpu_torch.utils.dtypes import (
    complex_dtype,
    real_dtype,
    is_complex_dtype,
)

__all__ = [
    "next_smooth_integer",
    "complex_dtype",
    "real_dtype",
    "is_complex_dtype",
]
