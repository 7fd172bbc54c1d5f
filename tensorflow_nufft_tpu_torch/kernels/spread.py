"""Spread: slot-order point values -> per-tile halo-padded blocks.

Counterpart of ``tensorflow_nufft_tpu.kernels.pallas_spread`` (rank 2).
Two entry points launch the hand-written Hopper kernel of
``csrc/spread.cu``, one per weight source:

- ``spread_planned_cuda`` replaces ``pallas_spread._spread_kernel_
  resident_mats``: precomputed per-slot windows (``KernelWeights``).
- ``spread_unplanned_cuda`` replaces ``pallas_spread._spread_kernel_
  resident``: windows evaluated in the kernel from the coords payload.

``spread_tiles_plain`` is the plain PyTorch version of both; the
dispatcher uses it for CPU tensors and ``chip_smoke.py`` holds the kernel
to it on the card. Each CUDA entry point counts its launches in its
``launches`` attribute.

What bounds the kernel on the H100 and what its design does about it is
in the source note of ``csrc/spread.cu``; in short: one block per tile
and channel group keeps the tile's halo block in shared memory, each
thread owns fixed rows and adds slots in order (deterministic, no
atomics), and the 64 tiles of the 2D headline leave half the SMs idle.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from tensorflow_nufft_tpu_torch.kernels import _build, binning
from tensorflow_nufft_tpu_torch.kernels.binning import (
    KernelWeights, TileGeometry)

# Slots staged in shared memory at a time (kSub in csrc/spread.cu).
_SUB = 128


def launch_shape(geom: TileGeometry, batch2: int, width: int):
    """(group, threads, smem bytes) of a spread launch: the largest
    channel group whose [group, E0, E1] block, staging buffers and one
    thread per (channel, row) fit one Hopper block."""
    e0, e1 = geom.ext
    staging = 4 * (2 * _SUB * width + 2 * _SUB)
    per_channel = 4 * (e0 * e1 + _SUB)
    group = min(batch2, 1024 // e0,
                (_build.SMEM_LIMIT - staging) // per_channel)
    if group < 1:
        raise ValueError(
            f"spread kernel: extended tile {geom.ext} does not fit one "
            f"thread block (shared memory or 1024 threads)")
    threads = -(-group * e0 // 32) * 32
    return group, threads, staging + group * per_channel


def _launch(values_pl, tile_bounds, geom: TileGeometry, plan,
            kw: Optional[KernelWeights], coords: Optional[torch.Tensor]):
    if geom.rank != 2:
        raise NotImplementedError("the spread kernel is rank 2 only")
    batch2, slots = values_pl.shape[0], geom.num_slots
    f32, i32 = torch.float32, torch.int32
    need = functools.partial(_build.require_cuda, "spread")
    need(values_pl, "values", f32, (batch2, slots))
    need(tile_bounds, "tile_bounds", i32, (geom.num_tiles + 1,))
    if kw is not None:
        need(kw.weights, "weights", f32, (2, slots, plan.width))
        need(kw.starts, "starts", i32, (2, slots))
        ptrs = (0, kw.weights.data_ptr(), kw.starts.data_ptr())
    else:
        need(coords, "coords", f32, (4, slots))
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
    or from ``coords``. Any float dtype; sums with ``index_add_``."""
    if kw is None:
        kw = binning.slot_weights(coords, tile_bounds, geom, plan)
    batch2 = values_pl.shape[0]
    e0, e1 = geom.ext
    width = plan.width
    dev = values_pl.device
    tile_of = binning.slot_tiles(tile_bounds, geom)
    starts0, starts1 = kw.starts[0].long(), kw.starts[1].long()
    cols = starts1[:, None] + torch.arange(width, device=dev)
    col_ok = (cols >= 0) & (cols < e1) & (tile_of >= 0)[:, None]
    base = (tile_of.clamp(min=0)[None, :, None] * batch2
            + torch.arange(batch2, device=dev)[:, None, None]) * (e0 * e1)
    out = values_pl.new_zeros(geom.num_tiles * batch2 * e0 * e1)
    vw1 = values_pl[:, :, None] * kw.weights[1][None]        # [B2, S, w]
    for i in range(width):
        rows = starts0 + i
        ok = (col_ok & ((rows >= 0) & (rows < e0))[:, None])[None]
        idx = base + (rows[:, None] * e1 + cols)[None]
        contrib = kw.weights[0][None, :, i, None] * vw1
        out.index_add_(0, torch.where(ok, idx, 0).reshape(-1),
                       torch.where(ok, contrib, 0.0).reshape(-1))
    return out.reshape(geom.tiles + (batch2,) + geom.ext)
