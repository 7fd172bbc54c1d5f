"""Dispatch of the spread/interp stages.

Counterpart of the spread/interp entry points of
``tensorflow_nufft_tpu.kernels.dispatch``: the tiled ones of the
transforms (with the planned levels' inputs: windows, or coords and the
rank-3 band, and slot-order values in or out), the fused banded spread
of the type-1 route, the full-fine-grid ``spread``/``interp`` of the
spread-only ops and ``interp_deriv`` of their points gradients. A CUDA
tensor goes to the hand-written kernel (which raises on what it does not
take, such as float64); a CPU tensor goes to the plain PyTorch version.
There is no fallback between the two.

Which of these a transform takes at all is ``route``'s rule, decided once
from the plan spec and the device before anything launches: the kernels
(float32 on the card), their plain versions (the CPU), the torch-op
counterpart of the JAX package's XLA path (``kernels.xla_ops`` and
``fft.fft_ops``: float64 on the card, and ``backend='xla'``), or the
native C++ host engine (``backend='native'``: ``native_spread`` and
``native_interp``, the JAX package's host callbacks, on the XLA path's
mode stages).

The full-grid entry points take and return planar grids [B, *fine, 2],
whose channel fold (b, re/im) is the tiles' channel order, and window
or overlap-add the halos with the mode-stage steps of the transforms
(``kernels.mode3d``: its kernels at rank 3 on the card, its plain
versions otherwise).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tensorflow_nufft_tpu_torch.kernels import binning, mode3d
from tensorflow_nufft_tpu_torch.kernels import interp as interp_k
from tensorflow_nufft_tpu_torch.kernels import spread as spread_k
from tensorflow_nufft_tpu_torch.kernels.binning import (
    BandInfo, BinnedPoints, KernelWeights, TileGeometry)


def route(spec, device) -> str:
    """The route of a transform of plan spec ``spec`` on ``device``:
    "kernels", "plain", "xla" or "native".

    The outcome of the JAX package's ``pallas_active`` (its VMEM model
    aside): the Pallas kernels serve float32 only, and float64 runs the
    XLA path. Here float32 CUDA tensors run the hand-written kernels and
    float64 CUDA tensors the XLA-path ops; CPU tensors run the kernels'
    plain versions (which compute float64 too); ``backend='xla'`` takes
    the XLA-path ops on any device. ``backend='pallas'`` on float64
    raises, as in the JAX package. ``backend='native'`` takes the XLA
    path with the native engine's spread and interp, on any device (card
    tensors go to the host and back, as the JAX package's host callbacks
    do; no kernel launches).
    """
    backend = spec.backend
    if backend in ("xla", "native"):
        return backend
    if spec.dtype_name != "complex64":
        if backend == "pallas":
            raise ValueError(
                f"backend='pallas' requires complex64/planar-float32 "
                f"data and rank in (1, 2, 3); got "
                f"dtype_name={spec.dtype_name!r}, rank={spec.rank}. "
                f"Use backend='xla' (or 'auto') instead.")
        return "xla" if torch.device(device).type == "cuda" else "plain"
    return "kernels" if torch.device(device).type == "cuda" else "plain"


def spread_tiled(values_cm: Optional[torch.Tensor], binned: BinnedPoints,
                 geom: TileGeometry, plan,
                 kw: Optional[KernelWeights] = None,
                 coords: Optional[torch.Tensor] = None,
                 band: Optional[BandInfo] = None,
                 values_slots: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Channel-major values [B2, M] -> tiles [*tiles, B2, *ext].

    ``kw`` (a "mats" plan's windows) selects the planned kernel; without
    it the kernel evaluates the windows from ``coords`` (built here if
    not given), with ``band`` (a rank-3 "binned" plan) the banded one.
    ``values_slots`` [B2, num_slots] (slot order, zero in padded slots)
    replaces ``values_cm`` and skips its gather.
    """
    values_pl = (values_slots.contiguous() if values_slots is not None
                 else binning.build_values_payload(values_cm, binned))
    if kw is None and coords is None:
        coords = binning.build_coords_payload(binned)
    tb = binned.tile_bounds
    if values_pl.is_cuda:
        if kw is not None:
            return spread_k.spread_planned_cuda(values_pl, tb, geom, plan,
                                                kw)
        if band is not None:
            return spread_k.spread_banded_cuda(values_pl, tb, geom, plan,
                                               coords, band)
        return spread_k.spread_unplanned_cuda(values_pl, tb, geom, plan,
                                              coords)
    return spread_k.spread_tiles_plain(values_pl, tb, geom, plan, kw=kw,
                                       coords=coords, band=band)


def spread_dfta(values_pl: torch.Tensor, binned: BinnedPoints,
                geom: TileGeometry, plan, coords: torch.Tensor,
                band: BandInfo, twiddles: torch.Tensor) -> torch.Tensor:
    """Slot-order values [B2, num_slots] -> y [nt0, nt1, B2, E0, E1, n2]:
    the banded spread with its axis-2 DFT epilogue (the fused type-1
    route of ``fft.planar_fft.spread_dft_fused``)."""
    tb = binned.tile_bounds
    if values_pl.is_cuda:
        return spread_k.spread_dfta_cuda(values_pl.contiguous(), tb, geom,
                                         plan, coords, band, twiddles)
    tiles = spread_k.spread_tiles_plain(values_pl, tb, geom, plan,
                                        coords=coords, band=band)
    return spread_k.dfta_plain(tiles, twiddles)


def _slot_order(chunk_vals: torch.Tensor, geom: TileGeometry
                ) -> torch.Tensor:
    """[num_chunks, B2, chunk] kernel output -> slot order [B2, slots]."""
    batch2 = chunk_vals.shape[1]
    return chunk_vals.transpose(0, 1).reshape(batch2, geom.num_slots)


def _point_order(chunk_vals: torch.Tensor, binned: BinnedPoints,
                 geom: TileGeometry) -> torch.Tensor:
    """[num_chunks, B2, chunk] slot-order kernel output -> [B2, M]."""
    return binning.scatter_chunked(_slot_order(chunk_vals, geom), binned)


def interp_tiled(tiles: torch.Tensor, binned: BinnedPoints,
                 geom: TileGeometry, plan,
                 kw: Optional[KernelWeights] = None,
                 coords: Optional[torch.Tensor] = None,
                 band: Optional[BandInfo] = None,
                 chunk_order: bool = False) -> torch.Tensor:
    """Tiles [*tiles, B2, *ext] -> point-order values [B2, M], or with
    ``chunk_order`` slot-order values [B2, num_slots] (zero in padded
    slots and unused chunks). Kernel choice as ``spread_tiled``."""
    if kw is None and coords is None:
        coords = binning.build_coords_payload(binned)
    tb = binned.tile_bounds
    if tiles.is_cuda:
        if kw is not None:
            chunk_vals = interp_k.interp_planned_cuda(tiles, tb, geom, plan,
                                                      kw)
        elif band is not None:
            chunk_vals = interp_k.interp_banded_cuda(tiles, tb, geom, plan,
                                                     coords, band)
        else:
            chunk_vals = interp_k.interp_unplanned_cuda(tiles, tb, geom,
                                                        plan, coords)
    else:
        chunk_vals = interp_k.interp_tiles_plain(
            tiles, tb, geom, plan, kw=kw, coords=coords, band=band)
    if chunk_order:
        return _slot_order(chunk_vals, geom)
    return _point_order(chunk_vals, binned, geom)


def spread(values_cm: torch.Tensor, binned: BinnedPoints,
           geom: TileGeometry, plan, kw: Optional[KernelWeights] = None,
           coords: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Channel-major values [2B, M] -> planar fine grid [B, *fine, 2]:
    the tiled spread (unplanned, or from a plan's ``kw`` or ``coords``
    as ``spread_tiled``), then the periodic overlap-add of the halos."""
    tiles = spread_tiled(values_cm, binned, geom, plan, kw=kw, coords=coords)
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


def host_points(points_resc: Tuple[torch.Tensor, torch.Tensor]
                ) -> np.ndarray:
    """Float64 rescaled coordinates [M, rank] on the host from the
    two-float pair (hi, lo), as the JAX package's ``_host_points``: the
    native engine takes double points, and hi alone would lose the low
    word."""
    hi, lo = points_resc
    return (hi.detach().cpu().double() + lo.detach().cpu().double()).numpy()


def native_spread(values: torch.Tensor, points: np.ndarray, plan
                  ) -> torch.Tensor:
    """Complex values [B, M] + host points from ``host_points`` ->
    complex fine grid [B, *fine] on the native engine (the JAX package's
    ``_native_spread_callback``), on the device of ``values``."""
    from tensorflow_nufft_tpu_torch.native import engine
    fine = engine.spread(values.detach().resolve_conj().cpu().numpy(),
                         points, plan.fine_shape, plan.width, plan.beta)
    return torch.from_numpy(fine).to(values.device)


def native_interp(grid: torch.Tensor, points: np.ndarray, plan
                  ) -> torch.Tensor:
    """Complex fine grid [B, *fine] + host points -> complex values
    [B, M] on the native engine (``_native_interp_callback``), on the
    device of ``grid``."""
    from tensorflow_nufft_tpu_torch.native import engine
    vals = engine.interp(grid.detach().resolve_conj().cpu().numpy(), points,
                         plan.width, plan.beta)
    return torch.from_numpy(vals).to(grid.device)
