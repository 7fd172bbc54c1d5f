"""Spread: slot-order point values -> per-tile halo-padded blocks.

Counterpart of ``tensorflow_nufft_tpu.kernels.pallas_spread`` (ranks 2
and 3). Two entry points launch the hand-written Hopper kernel of
``csrc/spread.cu``, one per weight source:

- ``spread_planned_cuda`` replaces ``pallas_spread._spread_kernel_
  resident_mats`` (rank 2) and ``_spread_kernel_mats`` (the rank-3
  per-tile grid): precomputed per-slot windows (``KernelWeights``).
  Where the JAX plan cannot keep its dense matrices (the 3D headline)
  it runs ``_spread_kernel_banded``, whose tile blocks this computes on
  the unbanded geometry.
- ``spread_unplanned_cuda`` replaces ``pallas_spread._spread_kernel_
  resident`` (rank 2) and ``_spread_kernel`` (rank 3): windows evaluated
  in the kernel from the coords payload. It also replaces the wide-
  channel pair ``_spread_kernel_resident_split`` and
  ``_spread_kernel_split``, which the TPU takes once a channel group no
  longer fits one 8-row payload beside its coordinates (2 * rank + B2 >
  8: training's source and points gradients): coords and values are
  separate payloads here at every width, and channels beyond one
  block's group go to the launch grid's second dimension, the last
  group partial (``launch_shape``). The split pair's slot-order input
  (``values_slots``, of ``PlannedNufft.normal``) is not ported yet.

``spread_tiles_plain`` is the plain PyTorch version of both; the
dispatcher uses it for CPU tensors and ``chip_smoke.py`` holds the kernel
to it on the card. Each CUDA entry point counts its launches in its
``launches`` attribute.

What bounds the kernel on the H100 and what its design does about it is
in the source note of ``csrc/spread.cu``; in short: one block per tile
and channel group keeps the tile's halo block in shared memory, each
thread owns fixed rows along the last axis and adds slots in order
(deterministic, no atomics), and only the rows a slot's window covers do
work on it.
"""

from __future__ import annotations

import functools
import itertools
from typing import Optional

import numpy as np
import torch

from tensorflow_nufft_tpu_torch.kernels import _build, binning
from tensorflow_nufft_tpu_torch.kernels.binning import (
    KernelWeights, TileGeometry)

# Slots staged in shared memory at a time (kSub in csrc/spread.cu).
_SUB = 128


def launch_shape(geom: TileGeometry, batch2: int, width: int):
    """(group, threads, smem bytes) of a spread launch: the largest
    channel group whose [group, *ext] block, staging buffers and one
    thread per (channel, row along the last axis) fit one Hopper
    block."""
    rows = int(np.prod(geom.ext[:-1]))
    cells = rows * geom.ext[-1]
    staging = 4 * geom.rank * (_SUB * width + _SUB)
    per_channel = 4 * (cells + _SUB)
    group = min(batch2, 1024 // rows,
                (_build.SMEM_LIMIT - staging) // per_channel)
    if group < 1:
        raise ValueError(
            f"spread kernel: extended tile {geom.ext} does not fit one "
            f"thread block (shared memory or 1024 threads)")
    threads = -(-group * rows // 32) * 32
    return group, threads, staging + group * per_channel


def _launch(values_pl, tile_bounds, geom: TileGeometry, plan,
            kw: Optional[KernelWeights], coords: Optional[torch.Tensor]):
    rank = geom.rank
    if rank not in (2, 3):
        raise NotImplementedError("the spread kernel takes ranks 2 and 3")
    batch2, slots = values_pl.shape[0], geom.num_slots
    f32, i32 = torch.float32, torch.int32
    need = functools.partial(_build.require_cuda, "spread")
    need(values_pl, "values", f32, (batch2, slots))
    need(tile_bounds, "tile_bounds", i32, (geom.num_tiles + 1,))
    if kw is not None:
        need(kw.weights, "weights", f32, (rank, slots, plan.width))
        need(kw.starts, "starts", i32, (rank, slots))
        ptrs = (0, kw.weights.data_ptr(), kw.starts.data_ptr())
    else:
        need(coords, "coords", f32, (2 * rank, slots))
        ptrs = (coords.data_ptr(), 0, 0)
    lib = _build.library()
    group, threads, smem = launch_shape(geom, batch2, plan.width)
    ints, floats = _build.kernel_params(geom, plan, batch2, group, threads,
                                        smem)
    out = torch.empty((geom.num_tiles, batch2) + geom.ext,
                      dtype=torch.float32, device=values_pl.device)
    with torch.cuda.device(values_pl.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tnt_spread(int(kw is not None), tile_bounds.data_ptr(),
                            values_pl.data_ptr(), *ptrs, out.data_ptr(),
                            ints, floats, stream)
    _build.check(rc, "spread kernel launch")
    return out.reshape(geom.tiles + (batch2,) + geom.ext)


def spread_planned_cuda(values_pl: torch.Tensor, tile_bounds: torch.Tensor,
                        geom: TileGeometry, plan,
                        kw: KernelWeights) -> torch.Tensor:
    """Hopper spread from the planned windows: values [B2, slots]
    -> tiles [*tiles, B2, *ext] (float32)."""
    out = _launch(values_pl, tile_bounds, geom, plan, kw, None)
    spread_planned_cuda.launches += 1
    return out


def spread_unplanned_cuda(values_pl: torch.Tensor,
                          tile_bounds: torch.Tensor, geom: TileGeometry,
                          plan, coords: torch.Tensor) -> torch.Tensor:
    """Hopper spread evaluating the windows in the kernel from the
    [4, slots] coords payload."""
    out = _launch(values_pl, tile_bounds, geom, plan, None, coords)
    spread_unplanned_cuda.launches += 1
    return out


spread_planned_cuda.launches = 0
spread_unplanned_cuda.launches = 0


def spread_tiles_plain(values_pl: torch.Tensor, tile_bounds: torch.Tensor,
                       geom: TileGeometry, plan,
                       kw: Optional[KernelWeights] = None,
                       coords: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Plain PyTorch spread, the same function as the kernel: values
    [B2, slots] -> [*tiles, B2, *ext], from the planned windows ``kw``
    or from ``coords``. Any float dtype; sums with ``index_add_``, one
    [B2, slots, width] contribution per leading-axis window offset (the
    last axis's window is the vector dimension), in the kernel's
    product order wl * (v * wlast)."""
    if kw is None:
        kw = binning.slot_weights(coords, tile_bounds, geom, plan)
    batch2 = values_pl.shape[0]
    ext, rank, width = geom.ext, geom.rank, plan.width
    cells = int(np.prod(ext))
    dev = values_pl.device
    tile_of = binning.slot_tiles(tile_bounds, geom)
    starts = [s.long() for s in kw.starts]
    cols = starts[-1][:, None] + torch.arange(width, device=dev)
    col_ok = (cols >= 0) & (cols < ext[-1]) & (tile_of >= 0)[:, None]
    base = (tile_of.clamp(min=0)[None, :, None] * batch2
            + torch.arange(batch2, device=dev)[:, None, None]) * cells
    out = values_pl.new_zeros(geom.num_tiles * batch2 * cells)
    vwl = values_pl[:, :, None] * kw.weights[-1][None]      # [B2, S, w]
    for offs in itertools.product(range(width), repeat=rank - 1):
        ok, row, wl = col_ok, 0, None
        for d, o in enumerate(offs):
            r = starts[d] + o
            ok = ok & ((r >= 0) & (r < ext[d]))[:, None]
            row = row * ext[d] + r
            wd = kw.weights[d][:, o]
            wl = wd if wl is None else wl * wd
        idx = base + (row[:, None] * ext[-1] + cols)[None]
        contrib = wl[None, :, None] * vwl
        ok = ok[None]
        out.index_add_(0, torch.where(ok, idx, 0).reshape(-1),
                       torch.where(ok, contrib, 0.0).reshape(-1))
    return out.reshape(geom.tiles + (batch2,) + ext)
