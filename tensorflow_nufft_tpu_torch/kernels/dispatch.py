"""Dispatch of the spread/interp stages.

Counterpart of the spread/interp entry points of
``tensorflow_nufft_tpu.kernels.dispatch``: the tiled ones of the
transforms, the full-fine-grid ``spread``/``interp`` of the spread-only
ops and ``interp_deriv`` of their points gradients. A CUDA tensor goes
to the hand-written kernel (which raises on what it does not take, such
as float64); a CPU tensor goes to the plain PyTorch version. There is no
other branch and no fallback.

The full-grid entry points take and return planar grids [B, *fine, 2],
whose channel fold (b, re/im) is the tiles' channel order, and window
or overlap-add the halos with the mode-stage steps of the transforms
(``kernels.mode3d``: its kernels at rank 3 on the card, its plain
versions otherwise).
"""

from __future__ import annotations

from typing import Optional

import torch

from tensorflow_nufft_tpu_torch.kernels import binning, mode3d
from tensorflow_nufft_tpu_torch.kernels import interp as interp_k
from tensorflow_nufft_tpu_torch.kernels import spread as spread_k
from tensorflow_nufft_tpu_torch.kernels.binning import (
    BinnedPoints, KernelWeights, TileGeometry)


def spread_tiled(values_cm: torch.Tensor, binned: BinnedPoints,
                 geom: TileGeometry, plan,
                 kw: Optional[KernelWeights] = None) -> torch.Tensor:
    """Channel-major values [B2, M] -> tiles [*tiles, B2, *ext].

    ``kw`` (a planned transform's windows) selects the planned kernel;
    without it the kernel evaluates the windows from the coords payload.
    """
    values_pl = binning.build_values_payload(values_cm, binned)
    coords = None if kw is not None else binning.build_coords_payload(binned)
    if values_pl.is_cuda:
        if kw is not None:
            return spread_k.spread_planned_cuda(
                values_pl, binned.tile_bounds, geom, plan, kw)
        return spread_k.spread_unplanned_cuda(
            values_pl, binned.tile_bounds, geom, plan, coords)
    return spread_k.spread_tiles_plain(values_pl, binned.tile_bounds,
                                       geom, plan, kw=kw, coords=coords)


def _point_order(chunk_vals: torch.Tensor, binned: BinnedPoints,
                 geom: TileGeometry) -> torch.Tensor:
    """[num_chunks, B2, chunk] slot-order kernel output -> [B2, M]."""
    batch2 = chunk_vals.shape[1]
    flat = chunk_vals.transpose(0, 1).reshape(batch2, geom.num_slots)
    return binning.scatter_chunked(flat, binned)


def interp_tiled(tiles: torch.Tensor, binned: BinnedPoints,
                 geom: TileGeometry, plan,
                 kw: Optional[KernelWeights] = None) -> torch.Tensor:
    """Tiles [*tiles, B2, *ext] -> point-order values [B2, M]."""
    coords = None if kw is not None else binning.build_coords_payload(binned)
    if tiles.is_cuda:
        if kw is not None:
            chunk_vals = interp_k.interp_planned_cuda(
                tiles, binned.tile_bounds, geom, plan, kw)
        else:
            chunk_vals = interp_k.interp_unplanned_cuda(
                tiles, binned.tile_bounds, geom, plan, coords)
    else:
        chunk_vals = interp_k.interp_tiles_plain(
            tiles, binned.tile_bounds, geom, plan, kw=kw, coords=coords)
    return _point_order(chunk_vals, binned, geom)


def spread(values_cm: torch.Tensor, binned: BinnedPoints,
           geom: TileGeometry, plan) -> torch.Tensor:
    """Channel-major values [2B, M] -> planar fine grid [B, *fine, 2]:
    the unplanned tiled spread, then the periodic overlap-add of the
    halos."""
    tiles = spread_tiled(values_cm, binned, geom, plan)
    batch = values_cm.shape[0] // 2
    if mode3d.on_kernels(tiles, geom.rank):
        fine = mode3d.fold3d_cuda(tiles, geom, batch)
    else:
        fine = mode3d.fold_plain(tiles, geom, batch)
    return torch.view_as_real(fine)


def extend(grid: torch.Tensor, geom: TileGeometry) -> torch.Tensor:
    """Planar fine grid [B, *fine, 2] -> tiles [*tiles, 2B, *ext] with
    periodic halos."""
    fine = torch.view_as_complex(grid.contiguous())
    if mode3d.on_kernels(fine, geom.rank):
        return mode3d.extend_tiles3d_cuda(fine, geom)
    return mode3d.extend_plain(fine, geom)


def interp(grid: torch.Tensor, binned: BinnedPoints, geom: TileGeometry,
           plan) -> torch.Tensor:
    """Planar fine grid [B, *fine, 2] -> channel-major point values
    [2B, M] (the unplanned interp)."""
    return interp_tiled(extend(grid, geom), binned, geom, plan)


def interp_deriv(tiles: torch.Tensor, binned: BinnedPoints,
                 geom: TileGeometry, plan, axis: int) -> torch.Tensor:
    """``interp_tiled`` (unplanned) with the kernel's derivative phi' on
    ``axis``: the building block of the spread-only ops' points
    gradients. Tiles [*tiles, B2, *ext] -> point-order values [B2, M]."""
    coords = binning.build_coords_payload(binned)
    if tiles.is_cuda:
        chunk_vals = interp_k.interp_deriv_cuda(
            tiles, binned.tile_bounds, geom, plan, coords, axis)
    else:
        chunk_vals = interp_k.interp_tiles_plain(
            tiles, binned.tile_bounds, geom, plan, coords=coords,
            deriv_axis=axis)
    return _point_order(chunk_vals, binned, geom)
