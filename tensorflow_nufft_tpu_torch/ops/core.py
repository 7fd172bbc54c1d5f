"""The complex cores and the helpers of the transform gradients.

``nufft_core`` and ``spread_only_core`` are the port's counterparts of
the JAX package's ``ops.core.nufft_core`` and ``spread_only_core``: one
point set, an inner batch of transforms on complex tensors. Each runs
its planar core (``ops.planar_core``) on the ``torch.view_as_real`` view
of the source and views the result as complex again, so a complex64
transform takes the planar route (the kernels on the card) bit for bit,
and both differentiate through the planar ``autograd.Function``s.

Gradient convention: PyTorch's gradient of a real loss with respect to a
complex tensor is dL/dRe + i dL/dIm, the conjugate of what ``jax.grad``
returns (JAX's custom VJPs are plain transposes); the points gradient is
real and equals JAX's.

``_mode_grid`` and ``_replace`` are the port's copies of the JAX
package's helpers of the same names.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from tensorflow_nufft_tpu_torch.plan.plan import PlanSpec


def _mode_grid(grid_shape: Tuple[int, ...], axis: int, dtype,
               device) -> torch.Tensor:
    """Mode indices k along ``axis``, CMCL order, shaped to broadcast
    over the grid ([1, .., N, .., 1]), on ``device``: no grid of indices
    is built on the host.

    Integer modes k = i - N//2 (the reference oracle uses
    linspace(-N/2, N/2-1) — identical for even N; for odd N these are
    the integer modes that the reference's C++ kernels use,
    cc/kernels/nufft_plan.cc:729-733).
    """
    n = grid_shape[axis]
    shape = [1] * len(grid_shape)
    shape[axis] = n
    k = torch.arange(n, dtype=dtype, device=device) - n // 2
    return k.reshape(shape)


def _replace(spec: PlanSpec, **kw) -> PlanSpec:
    return dataclasses.replace(spec, **kw)


def _through_planar(planar_fn, source: torch.Tensor, points: torch.Tensor,
                    spec: PlanSpec) -> torch.Tensor:
    out = planar_fn(torch.view_as_real(source.resolve_conj()), points, spec)
    return torch.view_as_complex(out.contiguous())


def nufft_core(source: torch.Tensor, points: torch.Tensor,
               spec: PlanSpec) -> torch.Tensor:
    """Inner-batched complex NUFFT: source [B, M] (type-1) or
    [B, *grid] (type-2), points [M, rank]; differentiable in both."""
    from tensorflow_nufft_tpu_torch.ops.planar_core import nufft_core_planar
    return _through_planar(nufft_core_planar, source, points, spec)


def spread_only_core(source: torch.Tensor, points: torch.Tensor,
                     spec: PlanSpec) -> torch.Tensor:
    """Inner-batched complex spread (type-1) or interp (type-2) with
    ``spec.spread_only``; differentiable in both inputs."""
    from tensorflow_nufft_tpu_torch.ops.planar_core import (
        spread_only_core_planar)
    return _through_planar(spread_only_core_planar, source, points, spec)
