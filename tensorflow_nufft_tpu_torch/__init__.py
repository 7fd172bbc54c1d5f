"""PyTorch port of tensorflow_nufft_tpu (planar 1D, 2D and 3D
type-1/type-2 NUFFT).

The spread and interp hot loops, and at 3D the mode stages and their
FFT, run as hand-written CUDA kernels on CUDA tensors (``csrc/``, built
with nvcc at first use) and as their plain PyTorch versions on CPU
tensors. Everything else (binning, the rank-1 and rank-2 mode stages and
FFT) is plain torch, mirroring the JAX package module for module. Numpy input goes to the CUDA card unless
the caller passes ``device=``. ``planar.nufft``, ``planar.interp`` and
``planar.spread`` are differentiable in source and points,
``PlannedNufft`` in its source.

Typical usage::

    import tensorflow_nufft_tpu_torch as tnt
    op = tnt.planar.PlannedNufft(points, (128, 128, 128), "type_1")
    modes = op(strengths)          # [B, M, 2] -> [B, 128, 128, 128, 2]

    k = points.requires_grad_()    # trajectory learning
    loss = tnt.planar.nufft(image, k).square().sum()
    loss.backward()                # image.grad, k.grad
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
