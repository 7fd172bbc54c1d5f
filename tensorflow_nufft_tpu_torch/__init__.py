"""PyTorch port of tensorflow_nufft_tpu: 1D, 2D and 3D type-1/type-2
NUFFTs on complex tensors (``nufft``, ``interp``, ``spread``, ``nudft``)
and on planar ones (``planar``), type-3 (``nufft_type3``, ``Type3Plan``,
``nudft_type3``), the planned ``PlannedNufft`` and its per-trajectory
stack ``planar.BatchedPlannedNufft``, the Toeplitz-embedded normal
operator, the MRI models (``models.mri``) and sharding over a device
mesh (``parallel``: ``Mesh``, ``sharded_nufft``, ``sharded_nufft_grid``,
``sharded_nufft_type3``, ``ShardedPlannedNufft``).

The spread and interp hot loops, and at 3D the mode stages and their
FFT, run as hand-written CUDA kernels on float32 CUDA tensors
(``csrc/``, built with nvcc at first use) and as their plain PyTorch
versions on CPU tensors. Float64 on the card, and
``Options(backend='xla')``, run the torch-op counterpart of the JAX
package's XLA path (``kernels.xla_ops``, ``fft.fft_ops``);
``Options(backend='native')`` runs that path's spread and interp on the
native C++ host engine (``native``, also an eager NumPy API). Each stage
of a transform is a ``utils.profiling`` span in profiler traces. Everything
else (binning, the rank-1 and rank-2 mode stages and FFT) is plain
torch, mirroring the JAX package module for module. Numpy input goes to
the CUDA card unless the caller passes ``device=``. The transforms are
differentiable in source and points, ``PlannedNufft`` in its source.

Typical usage::

    import tensorflow_nufft_tpu_torch as tnt
    kspace = tnt.nufft(image, points)          # complex64 [*grid] -> [M]
    op = tnt.planar.PlannedNufft(points, (128, 128, 128), "type_1")
    modes = op(strengths)          # [B, M, 2] -> [B, 128, 128, 128, 2]

    k = points.requires_grad_()    # trajectory learning
    loss = tnt.nufft(image, k).abs().square().sum()
    loss.backward()                # image.grad, k.grad
"""

from tensorflow_nufft_tpu_torch.__about__ import __version__
from tensorflow_nufft_tpu_torch import models, native, parallel, planar
from tensorflow_nufft_tpu_torch.ops.nufft_ops import (
    interp, nudft, nufft, spread)
from tensorflow_nufft_tpu_torch.ops.type3 import (
    Type3Plan, nudft_type3, nufft_type3)
from tensorflow_nufft_tpu_torch.options.options import (
    DebuggingOptions, FftwOptions, FftwPlanningRigor, Options, PointsRange)
from tensorflow_nufft_tpu_torch.plan.plan import (
    NufftPlan, PlanSpec, make_plan)
from tensorflow_nufft_tpu_torch.planar import PlannedNufft

__all__ = [
    "planar",
    "models",
    "parallel",
    "nufft",
    "nufft_type3",
    "nudft_type3",
    "Type3Plan",
    "interp",
    "spread",
    "nudft",
    "PlannedNufft",
    "Options",
    "DebuggingOptions",
    "FftwOptions",
    "FftwPlanningRigor",
    "PointsRange",
    "NufftPlan",
    "PlanSpec",
    "make_plan",
    "__version__",
]
