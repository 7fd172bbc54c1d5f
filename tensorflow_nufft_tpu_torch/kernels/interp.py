"""Interp: per-tile halo-padded blocks -> slot-order point values.

Counterpart of ``tensorflow_nufft_tpu.kernels.pallas_interp`` (ranks 1,
2 and 3). Four entry points launch the hand-written Hopper kernels of
``csrc/interp.cu``:

- ``interp_planned_cuda`` replaces ``pallas_interp._interp_kernel_
  resident_mats`` and ``_interp_kernel_mats`` (the per-tile grid, the
  form of rank 3 and of tile arrays the TPU cannot keep resident):
  precomputed per-slot windows (``KernelWeights``).
- ``interp_unplanned_cuda`` replaces ``pallas_interp._interp_kernel``
  (ranks 1-3): windows evaluated in the kernel from the coords payload.
- ``interp_deriv_cuda`` is the same kernel with ``_interp_kernel``'s
  ``deriv_axis`` flag: the window of one axis holds the kernel's
  derivative phi' (the points gradients of the spread-only ops).
- ``interp_banded_cuda`` replaces ``pallas_interp._interp_kernel_
  banded``: the planned rank-3 binned level, each sub-chunk reading only
  its band of axis-0 rows (``binning.BandInfo``), windows evaluated in
  the kernel.

``interp_tiles_plain`` is the plain PyTorch version of all four. Outputs are
[num_chunks, B2, chunk] in slot order, as the TPU kernels write them;
``binning.scatter_chunked`` brings them to point order. Each CUDA entry
point counts its launches in its ``launches`` attribute.

What bounds the kernels on the H100 and what their design does about it
is in the source note of ``csrc/interp.cu``: no block holds a whole tile
(one extended tile exceeds a block's shared memory on many geometries);
a block serves up to 512 slots of one chunk for one channel, one thread
per slot with its windows in registers, and stages the axis-0 rows its
windows touch (banded: the union of its sub-chunks' bands) in
double-buffered pieces with asynchronous copies (``launch_shape``,
``banded_shape``). At rank 1 a block serves every channel from one
window a slot, for up to ``LINE_UNITS`` units of slots in turn, staging
its tile's line of each channel once for all of them (``line_units``).
"""

from __future__ import annotations

import functools
import itertools
from typing import Optional

import numpy as np
import torch

from tensorflow_nufft_tpu_torch.kernels import _build, binning
from tensorflow_nufft_tpu_torch.kernels.binning import (
    SUB, BandInfo, KernelWeights, TileGeometry)

# Slots one interp block serves at most (one thread each; kMaxSlotThreads
# in csrc/interp.cu).
MAX_SLOTS = 512
# Shared memory of a rank-1 interp block's staged lines at most: two
# blocks per SM (half its 228 KB, less the 1 KB each block reserves).
LINE_SMEM = 113 * 1024
# Units of slots (``launch_shape``'s ``slots``) a rank-1 interp block
# takes in turn at most, staging its tile's lines once for all of them.
LINE_UNITS = 8


def line_units(geom: TileGeometry) -> int:
    """Units a rank-1 interp block takes in turn: up to ``LINE_UNITS``,
    fewer where that would leave fewer than 4096 blocks (the 132 SMs of
    an H100 then still hold several waves)."""
    units = geom.num_slots // launch_shape(geom)[2]
    return max(1, min(LINE_UNITS, units // 4096))


def piece_rows(geom: TileGeometry) -> int:
    """Axis-0 rows of one of an interp block's two staging buffers: as
    many as let two blocks share an SM (one, where a single row per
    buffer does not fit that), at most E0; 0 where two rows do not fit a
    block, and the block then reads the tile array in place."""
    plane = 4 * int(np.prod(geom.ext[1:]))
    # Two blocks per SM: half the SM's 228 KB, less each block's 1 KB.
    slab = (114 * 1024 - 1024) // (2 * plane)
    if slab < 1:
        slab = _build.SMEM_LIMIT // (2 * plane)
    return min(geom.ext[0], slab)


def launch_shape(geom: TileGeometry, batch2: int = 1):
    """(group, slab, slots, threads, smem bytes) of an interp launch of
    ``batch2`` channels: a block serves ``slots`` consecutive slots of
    one chunk (the most that divide the chunk within ``MAX_SLOTS``), one
    thread each (``threads``: whole warps).

    Ranks 2 and 3: one channel a block (``group`` 1); the block stages
    the axis-0 rows its windows touch in two buffers of ``slab`` rows
    (``piece_rows``).

    Rank 1: every channel in one block, in groups of ``group`` channels,
    each staged as pieces of ``slab`` cells of the tile's line: all
    channels' whole lines where they fit ``LINE_SMEM`` (one buffer),
    else groups of whole lines in two buffers, else (a line above half
    of it) one channel at a time in pieces of at most half of it.

    Every geometry fits."""
    slots = next(d for d in range(min(geom.chunk, MAX_SLOTS), 0, -1)
                 if geom.chunk % d == 0)
    threads = -(-slots // 32) * 32
    if geom.rank == 1:
        line = 4 * geom.ext[0]
        if batch2 * line <= LINE_SMEM:
            return batch2, geom.ext[0], slots, threads, batch2 * line
        most = LINE_SMEM // (2 * line)
        if most >= 1:
            group = -(-batch2 // -(-batch2 // most))
            return group, geom.ext[0], slots, threads, 2 * group * line
        slab = LINE_SMEM // 8 // 4 * 4
        return 1, slab, slots, threads, 2 * 4 * slab
    slab = piece_rows(geom)
    plane = 4 * int(np.prod(geom.ext[1:]))
    return 1, slab, slots, threads, 2 * slab * plane


def _launch(tiles, tile_bounds, geom: TileGeometry, plan,
            kw: Optional[KernelWeights], coords: Optional[torch.Tensor],
            deriv_axis: int = -1):
    rank = geom.rank
    if rank not in (1, 2, 3):
        raise ValueError(f"the interp kernel takes ranks 1-3, got {rank}")
    batch2, slots = tiles.shape[rank], geom.num_slots
    f32, i32 = torch.float32, torch.int32
    need = functools.partial(_build.require_cuda, "interp")
    need(tiles, "tiles", f32, geom.tiles + (batch2,) + geom.ext)
    need(tile_bounds, "tile_bounds", i32, (geom.num_tiles + 1,))
    if kw is not None:
        need(kw.weights, "weights", f32, (rank, slots, plan.width))
        need(kw.starts, "starts", i32, (rank, slots))
        ptrs = (0, kw.weights.data_ptr(), kw.starts.data_ptr())
    else:
        need(coords, "coords", f32, (2 * rank, slots))
        ptrs = (coords.data_ptr(), 0, 0)
    lib = _build.library()
    group, slab, per, threads, smem = launch_shape(geom, batch2)
    ints, floats = _build.kernel_params(
        geom, plan, batch2, group, threads, smem, deriv_axis, slab=slab,
        sublen=per, run=line_units(geom) if rank == 1 else 1)
    # Zeros: chunks past tile_bounds[-1] are never written by the kernel.
    out = torch.zeros((geom.num_chunks, batch2, geom.chunk),
                      dtype=torch.float32, device=tiles.device)
    with torch.cuda.device(tiles.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tnt_interp(int(kw is not None), tile_bounds.data_ptr(),
                            tiles.data_ptr(), *ptrs, out.data_ptr(),
                            ints, floats, stream)
    _build.check(rc, "interp kernel launch")
    return out


def interp_planned_cuda(tiles: torch.Tensor, tile_bounds: torch.Tensor,
                        geom: TileGeometry, plan,
                        kw: KernelWeights) -> torch.Tensor:
    """Hopper interp from the planned windows: tiles [*tiles, B2, *ext]
    -> [num_chunks, B2, chunk] (float32)."""
    out = _launch(tiles, tile_bounds, geom, plan, kw, None)
    interp_planned_cuda.launches += 1
    return out


def interp_unplanned_cuda(tiles: torch.Tensor, tile_bounds: torch.Tensor,
                          geom: TileGeometry, plan,
                          coords: torch.Tensor) -> torch.Tensor:
    """Hopper interp evaluating the windows in the kernel from the
    [4, slots] coords payload."""
    out = _launch(tiles, tile_bounds, geom, plan, None, coords)
    interp_unplanned_cuda.launches += 1
    return out


def interp_deriv_cuda(tiles: torch.Tensor, tile_bounds: torch.Tensor,
                      geom: TileGeometry, plan, coords: torch.Tensor,
                      axis: int) -> torch.Tensor:
    """Hopper interp with the kernel's derivative phi' on ``axis`` (phi
    on the others), evaluated in the kernel from the coords payload."""
    if not 0 <= axis < geom.rank:
        raise ValueError(f"deriv axis {axis} out of range for rank "
                         f"{geom.rank}")
    out = _launch(tiles, tile_bounds, geom, plan, None, coords, axis)
    interp_deriv_cuda.launches += 1
    return out


interp_planned_cuda.launches = 0
interp_unplanned_cuda.launches = 0
interp_deriv_cuda.launches = 0


def banded_shape(geom: TileGeometry):
    """(slab, run, threads, smem bytes) of a banded interp launch: a block
    serves ``run`` consecutive sub-chunks of one chunk (the most that
    divide the chunk within ``MAX_SLOTS``), one thread per slot, for one
    channel, and stages the union of their bands in two buffers of
    ``slab`` axis-0 rows (``piece_rows``)."""
    sublen = min(SUB, geom.chunk)
    subs = geom.chunk // sublen
    run = max(r for r in range(1, subs + 1)
              if subs % r == 0 and r * sublen <= MAX_SLOTS)
    slab = piece_rows(geom)
    if slab < 1:
        raise ValueError(
            f"banded interp kernel: two axis-0 rows of ext {geom.ext} do "
            f"not fit one thread block's shared memory")
    plane = 4 * geom.ext[1] * geom.ext[2]
    return slab, run, run * sublen, 2 * slab * plane


def interp_banded_cuda(tiles: torch.Tensor, tile_bounds: torch.Tensor,
                       geom: TileGeometry, plan, coords: torch.Tensor,
                       band: BandInfo) -> torch.Tensor:
    """Hopper banded interp (rank 3, z-ordered binning): tiles
    [*tiles, B2, *ext] -> [num_chunks, B2, chunk] (float32)."""
    if geom.rank != 3:
        raise NotImplementedError("the banded interp kernel is rank 3")
    batch2, slots = tiles.shape[3], geom.num_slots
    sublen = min(SUB, geom.chunk)
    need = functools.partial(_build.require_cuda, "banded interp")
    need(tiles, "tiles", torch.float32, geom.tiles + (batch2,) + geom.ext)
    need(tile_bounds, "tile_bounds", torch.int32, (geom.num_tiles + 1,))
    need(coords, "coords", torch.float32, (6, slots))
    need(band.zorigins, "zorigins", torch.int32, (slots // sublen,))
    slab, run, threads, smem = banded_shape(geom)
    lib = _build.library()
    ints, floats = _build.kernel_params(
        geom, plan, batch2, 1, threads, smem, band=band.band, slab=slab,
        sublen=sublen, run=run)
    # Zeros: chunks past tile_bounds[-1] are never written by the kernel.
    out = torch.zeros((geom.num_chunks, batch2, geom.chunk),
                      dtype=torch.float32, device=tiles.device)
    with torch.cuda.device(tiles.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tnt_interp_banded(
            tile_bounds.data_ptr(), band.zorigins.data_ptr(),
            tiles.data_ptr(), coords.data_ptr(), out.data_ptr(), ints,
            floats, stream)
    _build.check(rc, "banded interp kernel launch")
    interp_banded_cuda.launches += 1
    return out


interp_banded_cuda.launches = 0


def interp_tiles_plain(tiles: torch.Tensor, tile_bounds: torch.Tensor,
                       geom: TileGeometry, plan,
                       kw: Optional[KernelWeights] = None,
                       coords: Optional[torch.Tensor] = None,
                       deriv_axis: Optional[int] = None,
                       band: Optional[BandInfo] = None) -> torch.Tensor:
    """Plain PyTorch interp, the same function as the kernels: tiles
    [*tiles, B2, *ext] -> [num_chunks, B2, chunk], from the planned
    windows ``kw`` or from ``coords`` (with phi' on ``deriv_axis``; with
    ``band``, the banded kernel's axis-0 windows).
    Any float dtype. Per leading-axis window offset, one [B2, slots,
    width] gather contracted with the last axis's window, then weighted
    by the leading-axis product, as the kernel does."""
    if kw is None:
        kw = binning.slot_weights(coords, tile_bounds, geom, plan,
                                  deriv_axis, band)
    batch2 = tiles.shape[geom.rank]
    ext, rank, width = geom.ext, geom.rank, plan.width
    cells = int(np.prod(ext))
    dev = tiles.device
    flat = tiles.reshape(-1)
    tile_of = binning.slot_tiles(tile_bounds, geom)
    starts = [s.long() for s in kw.starts]
    cols = starts[-1][:, None] + torch.arange(width, device=dev)
    col_ok = (cols >= 0) & (cols < ext[-1]) & (tile_of >= 0)[:, None]
    base = (tile_of.clamp(min=0)[None, :, None] * batch2
            + torch.arange(batch2, device=dev)[:, None, None]) * cells
    out = tiles.new_zeros(batch2, geom.num_slots)
    for offs in itertools.product(range(width), repeat=rank - 1):
        ok, row, wl = col_ok, 0, None
        for d, o in enumerate(offs):
            r = starts[d] + o
            ok = ok & ((r >= 0) & (r < ext[d]))[:, None]
            row = row * ext[d] + r
            wd = kw.weights[d][:, o]
            wl = wd if wl is None else wl * wd
        ok = ok[None]
        lead = 0 if wl is None else row[:, None] * ext[-1]
        idx = torch.where(ok, base + (lead + cols)[None], 0)
        vals = torch.where(ok, flat[idx], 0.0)               # [B2, S, w]
        inner = torch.sum(vals * kw.weights[-1][None], dim=-1)
        # Rank 1 has no leading axis: the window sum is the value.
        out = inner if wl is None else out + wl[None] * inner
    return out.reshape(batch2, geom.num_chunks, geom.chunk).transpose(
        0, 1).contiguous()
