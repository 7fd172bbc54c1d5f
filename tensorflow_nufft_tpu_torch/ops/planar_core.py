"""Planar-real core NUFFT: one point set, an inner batch of transforms.

Counterpart of ``tensorflow_nufft_tpu.ops.planar_core._execute_planar``
(the tiled, non-spread-only branches). Every tensor is real with a
trailing (re, im) channel; the spread/interp stages are real-linear and
channel-independent, so the channel folds into the batch axis with row
order (b, re/im). Forward only: autograd is not ported yet.
"""

from __future__ import annotations

import torch

from tensorflow_nufft_tpu_torch.fft.planar_fft import (
    amplify_pad_dft_tiled, dft_truncate_deconvolve_tiled)
from tensorflow_nufft_tpu_torch.kernels import binning, dispatch
from tensorflow_nufft_tpu_torch.kernels.torch_ops import (
    fold_and_rescale_split)
from tensorflow_nufft_tpu_torch.plan.plan import (
    PlanSpec, check_fine_grid_size, make_plan)


def _fold(x: torch.Tensor) -> torch.Tensor:
    """[B, *elem, 2] -> [2B, *elem] (channel becomes fastest batch dim)."""
    return x.movedim(-1, 1).reshape((x.shape[0] * 2,) + x.shape[1:-1])


def _unfold(x: torch.Tensor, batch: int) -> torch.Tensor:
    """[2B, *elem] -> [B, *elem, 2]."""
    return x.reshape((batch, 2) + x.shape[1:]).movedim(1, -1)


def bin_for_plan(points: torch.Tensor, plan):
    """Points-side preprocessing: two-float fold, tile geometry and
    binning. Returns (geom, binned)."""
    geom = binning.choose_geometry(plan.fine_shape, plan.width,
                                   int(points.shape[0]))
    if not binning.geometry_valid(geom):
        raise ValueError(
            f"cannot tile fine shape {plan.fine_shape}: a dim is smaller "
            f"than twice the halo {geom.pad}")
    points_resc = fold_and_rescale_split(points, plan.fine_shape,
                                         plan.spec.points_range)
    return geom, binning.bin_points(points_resc, geom)


def _execute_planar(source: torch.Tensor, points: torch.Tensor,
                    plan) -> torch.Tensor:
    """source: [B, M, 2] (type-1) or [B, *grid, 2] (type-2); points:
    [M, rank]. Returns the planar output."""
    spec = plan.spec
    if spec.spread_only:
        raise NotImplementedError("spread-only ops are not ported yet")
    batch = source.shape[0]
    check_fine_grid_size(plan, 2 * batch)    # planar: re/im channel pair
    geom, binned = bin_for_plan(points, plan)
    if spec.transform_type == "type_1":
        tiles = dispatch.spread_tiled(_fold(source), binned, geom, plan)
        return dft_truncate_deconvolve_tiled(tiles, plan, geom, batch)
    tiles = amplify_pad_dft_tiled(source, plan, geom)
    values = dispatch.interp_tiled(tiles, binned, geom, plan)
    return _unfold(values, batch)


def nufft_core_planar(source: torch.Tensor, points: torch.Tensor,
                      spec: PlanSpec) -> torch.Tensor:
    """Inner-batched planar NUFFT (one point set, B transforms)."""
    return _execute_planar(source, points, make_plan(spec))
