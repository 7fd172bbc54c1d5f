"""Helpers of the transform gradients.

The port's counterparts of ``_mode_grid`` and ``_replace`` of
``tensorflow_nufft_tpu.ops.core``.
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
