"""Spread/interp stages: plain torch ops, tile binning, and the
hand-written CUDA kernels (``csrc/``) behind ``dispatch``.

The public names are those of the JAX package's ``kernels``: the fold
and the ES kernel (``torch_ops``) and the XLA path's spread and interp
in torch ops (``xla_ops``).
"""

from tensorflow_nufft_tpu_torch.kernels.torch_ops import (
    fold_and_rescale,
    es_kernel,
)
from tensorflow_nufft_tpu_torch.kernels.xla_ops import (
    spread_geometry,
    spread_xla,
    interp_xla,
)

__all__ = [
    "fold_and_rescale",
    "es_kernel",
    "spread_geometry",
    "spread_xla",
    "interp_xla",
]
