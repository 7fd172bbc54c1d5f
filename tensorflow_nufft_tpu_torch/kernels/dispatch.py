"""Dispatch of the spread/interp stages.

Counterpart of the tiled entry points of
``tensorflow_nufft_tpu.kernels.dispatch``. A CUDA tensor goes to the
hand-written kernel (which raises on what it does not take, such as
float64); a CPU tensor goes to the plain PyTorch version. There is no
other branch and no fallback.
"""

from __future__ import annotations

from typing import Optional

import torch

from tensorflow_nufft_tpu_torch.kernels import binning, interp, spread
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
            return spread.spread_planned_cuda(
                values_pl, binned.tile_bounds, geom, plan, kw)
        return spread.spread_unplanned_cuda(
            values_pl, binned.tile_bounds, geom, plan, coords)
    return spread.spread_tiles_plain(values_pl, binned.tile_bounds, geom,
                                     plan, kw=kw, coords=coords)


def interp_tiled(tiles: torch.Tensor, binned: BinnedPoints,
                 geom: TileGeometry, plan,
                 kw: Optional[KernelWeights] = None) -> torch.Tensor:
    """Tiles [*tiles, B2, *ext] -> point-order values [B2, M]."""
    coords = None if kw is not None else binning.build_coords_payload(binned)
    if tiles.is_cuda:
        if kw is not None:
            chunk_vals = interp.interp_planned_cuda(
                tiles, binned.tile_bounds, geom, plan, kw)
        else:
            chunk_vals = interp.interp_unplanned_cuda(
                tiles, binned.tile_bounds, geom, plan, coords)
    else:
        chunk_vals = interp.interp_tiles_plain(
            tiles, binned.tile_bounds, geom, plan, kw=kw, coords=coords)
    batch2 = chunk_vals.shape[1]
    flat = chunk_vals.transpose(0, 1).reshape(batch2, geom.num_slots)
    return binning.scatter_chunked(flat, binned)
