"""PyTorch port of tensorflow_nufft_tpu (planar 2D type-1/type-2 NUFFT).

The spread and interp hot loops run as hand-written CUDA kernels on CUDA
tensors (``csrc/``, built with nvcc at first use) and as their plain
PyTorch versions on CPU tensors. Everything else (fold, binning, FFT
stages) is plain torch, mirroring the JAX package module for module.

Typical usage::

    import tensorflow_nufft_tpu_torch as tnt
    op = tnt.planar.PlannedNufft(points, (256, 256), "type_1")
    modes = op(strengths)          # [B, M, 2] -> [B, 256, 256, 2]
"""

from tensorflow_nufft_tpu_torch.__about__ import __version__
from tensorflow_nufft_tpu_torch import planar
from tensorflow_nufft_tpu_torch.options.options import Options, PointsRange
from tensorflow_nufft_tpu_torch.plan.plan import (
    NufftPlan, PlanSpec, make_plan)
from tensorflow_nufft_tpu_torch.planar import PlannedNufft

__all__ = [
    "planar",
    "PlannedNufft",
    "Options",
    "PointsRange",
    "NufftPlan",
    "PlanSpec",
    "make_plan",
    "__version__",
]
