"""Spread: slot-order point values -> per-tile halo-padded blocks.

Counterpart of ``tensorflow_nufft_tpu.kernels.pallas_spread`` (ranks 1,
2 and 3). Four entry points launch the hand-written Hopper kernels of
``csrc/spread.cu``:

- ``spread_planned_cuda`` replaces ``pallas_spread._spread_kernel_
  resident_mats`` and ``_spread_kernel_mats`` (the per-tile grid, the
  form of rank 3 and of tile arrays the TPU cannot keep resident):
  precomputed per-slot windows (``KernelWeights``).
- ``spread_unplanned_cuda`` replaces ``pallas_spread._spread_kernel_
  resident`` and ``_spread_kernel`` (the per-tile grid): windows
  evaluated on the card from the coords payload, once per slot (ranks 2
  and 3: by a first kernel; rank 1: in the spread's block that uses
  them).
  It also replaces the wide-channel pair
  ``_spread_kernel_resident_split`` and ``_spread_kernel_split``, which
  the TPU takes once a channel group no longer fits one 8-row payload
  beside its coordinates (2 * rank + B2 > 8: training's source and
  points gradients): coords and values are separate payloads here at
  every width, and channel groups (rank 3: pairs; rank 2: up to
  ``ROW_CHANNELS``; rank 1: up to ``LINE_CHANNELS``) go to the launch
  grid's second dimension, the last one partial. Values are always read in slot
  order, so the split pair's slot-order input (``values_slots``, of
  ``PlannedNufft.normal`` and ``apply_from_slots``) only skips the
  caller's gather (``dispatch.spread_tiled``).
- ``spread_banded_cuda`` replaces ``pallas_spread._spread_kernel_
  banded`` and ``_spread_kernel_split_banded``: the planned rank-3
  binned level, z-ordered binning whose sub-chunks touch only a band of
  axis-0 rows (``binning.BandInfo``), windows evaluated on the card.
- ``spread_dfta_cuda`` replaces ``pallas_spread._spread_kernel_split_
  banded_dfta``: the banded spread with the axis-2 mode-DFT pass as an
  epilogue, returning y [nt0, nt1, B2, E0, E1, n2].

``spread_tiles_plain`` is the plain PyTorch version of the first three
(``dfta_plain`` adds the epilogue's); the dispatcher uses them for CPU
tensors and ``chip_smoke.py`` holds each kernel to them on the card.
Each CUDA entry point counts its launches in its ``launches``
attribute; ``spread_planned_cuda`` and ``spread_unplanned_cuda`` also
count the channel groups of their rank-2 launches in
``channel_groups``.

What bounds the kernels on the H100 and what their design does about it
is in the source note of ``csrc/spread.cu``; in short: no block holds a
whole tile (one extended tile exceeds a block's shared memory on many
geometries), a block owns an axis-0 slab of a tile (and of each row the
axis-1 lines that fit) for a channel group, one warp per row, with
the same layout banded or not (``launch_shape``). Each warp finds the
slots that hit its row with one ballot per 32 slots and takes the hits
in slot order: every output cell has one owner and a fixed order
(deterministic, no atomics). At rank 3 the group is one or two
channels and a hit's window goes across the warp's lanes. At rank 2
the lanes go across the channels instead, up to ``ROW_CHANNELS`` in one
group, so one pass of a tile's slots serves them all: the block stages
the tile's slots (starts, windows, every channel's values) in shared
memory in batches, and each lane adds its own channel's products to its
own cells of each hit. At rank 1, where a
row is one cell, a warp owns a run of ``LINE_RUN`` cells of a tile's
line instead, two a lane in registers for up to ``LINE_CHANNELS``
channels, and blocks of up to ``LINE_WARPS`` warps cover a tile's runs,
taking the tile's slots in batches whose windows the block evaluates
(or loads) once into shared memory.
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


# Warps of a spread block at most, one per slab row (kMaxRowThreads / 32
# in csrc/spread.cu), so that 128 registers a thread fit.
ROW_WARPS = 16
# Shared memory of a spread block at most: two blocks per SM (half its
# 228 KB, less the 1 KB each block reserves).
HALF_SM = 113 * 1024
# Channels of a rank-2 spread block at most, one a lane (kMaxRowChannels
# in csrc/spread.cu).
ROW_CHANNELS = 32
# Cells of a rank-1 tile's line one warp owns (kLineRun in csrc/spread.cu).
LINE_RUN = 64
# Warps of a rank-1 spread block at most (kMaxLineThreads / 32), and the
# channels it serves from one evaluation of its windows
# (kMaxLineChannels).
LINE_WARPS = 32
LINE_CHANNELS = 8


def line_channels(group: int) -> int:
    """Channels a rank-1 or rank-2 spread block holds for a group of
    ``group``: the next power of two (``line_channels`` and
    ``row_channels`` in csrc/spread.cu)."""
    return 1 << (group - 1).bit_length()


def row_record(chan: int, width: int) -> int:
    """Words of a slot staged by a rank-2 spread block holding ``chan``
    channels: two window starts, two windows and the values, made odd
    (``row_record`` in csrc/spread.cu)."""
    return (2 + 2 * width + chan) | 1


def launch_shape(geom: TileGeometry, batch2: int, width: int,
                 fused: bool = False):
    """(group, slab, lines, threads, smem bytes) of a spread launch, banded
    or not. Rank 3: a channel pair (the fused epilogue needs one) or a
    single channel; of each axis-0 row the axis-1 lines a block owns,
    all E1 where a row's planes [group, E1, E2] and the warp's copy of 32
    slots' windows past axis 0 fit half an SM, else as many as fit,
    evened out over E1; and the most axis-0 rows, one warp each, that let
    two blocks share an SM, evened out over E0. Every geometry fits: a
    line is at most E2 floats a channel.

    Rank 2: the same slabs and lines, for a group of up to
    ``ROW_CHANNELS`` channels, one a lane: a row's planes are
    [lines, line_channels(group)], a line padded to an odd
    ``line_channels(group) | 1`` floats; each warp's share of the staged
    slots is 32 records of ``row_record`` words and their slot indices,
    and the block adds a count a warp (``ROW_WARPS``). The group is
    narrowed (to the next lower power of two) only where one row of all
    E1 lines and its share do not fit half an SM; wider channel counts
    take groups on the grid.

    Rank 1: ``group`` is up to ``LINE_CHANNELS`` channels, all served by
    one block from one evaluation of the windows (wider channel counts
    take groups on the grid); ``slab`` is the warps of a block, each
    owning ``LINE_RUN`` cells of the line (at most ``LINE_WARPS``,
    evened out over the runs of E0; blocks of a tile on the grid);
    ``lines`` is 1; the shared memory holds two batches of one slot a
    thread: its values (``line_channels(group)`` floats), window start
    and weights."""
    rank = geom.rank
    if rank == 1:
        group = min(batch2, LINE_CHANNELS)
        runs = -(-geom.ext[0] // LINE_RUN)
        slab = -(-runs // -(-runs // LINE_WARPS))
        threads = 32 * slab
        return group, slab, 1, threads, 2 * threads * 4 * (
            line_channels(group) + 1 + width)
    e0, e1 = geom.ext[:2]
    if rank == 2:
        # Channels go across the lanes: the group narrows from
        # ROW_CHANNELS only where a row's planes [E1, chan] and the
        # warp's share of the staged slots (32 records and their slot
        # indices) do not fit half an SM beside the warps' counts.
        fixed = 4 * ROW_WARPS
        group = min(batch2, ROW_CHANNELS)
        while True:
            chan = line_channels(group)
            win = 4 * 32 * (row_record(chan, width) + 1)
            if chan == 1 or 4 * e1 * (chan | 1) + win + fixed <= HALF_SM:
                break
            group = chan // 2
        line = chan | 1  # floats of an axis-1 line, padded to be odd
    else:
        fixed = 0
        group = 2 if fused else min(batch2, 2)
        line = group * geom.ext[2]
        win = 4 * 32 * 2 * width
    most_lines = (HALF_SM - fixed - win) // (4 * line)
    if most_lines < 1:
        raise ValueError(
            f"spread kernel: one axis-1 line of ext {geom.ext} does not fit "
            f"one thread block")
    lines = -(-e1 // -(-e1 // min(most_lines, e1)))
    row = 4 * lines * line + win
    most = min((HALF_SM - fixed) // row, ROW_WARPS, e0)
    slab = -(-e0 // -(-e0 // most))
    return group, slab, lines, 32 * slab, row * slab + fixed


def _launch(values_pl, tile_bounds, geom: TileGeometry, plan,
            kw: Optional[KernelWeights], coords: Optional[torch.Tensor]):
    rank = geom.rank
    if rank not in (1, 2, 3):
        raise ValueError(f"the spread kernel takes ranks 1-3, got {rank}")
    batch2, slots = values_pl.shape[0], geom.num_slots
    f32, i32 = torch.float32, torch.int32
    need = functools.partial(_build.require_cuda, "spread")
    need(values_pl, "values", f32, (batch2, slots))
    need(tile_bounds, "tile_bounds", i32, (geom.num_tiles + 1,))
    dev = values_pl.device
    if kw is not None:
        need(kw.weights, "weights", f32, (rank, slots, plan.width))
        need(kw.starts, "starts", i32, (rank, slots))
        ws, st, coords_ptr = kw.weights, kw.starts, 0
    else:
        need(coords, "coords", f32, (2 * rank, slots))
        coords_ptr = coords.data_ptr()
        if rank == 1:  # the spread evaluates them as it takes the slots
            ws = st = None
        else:
            # The slots' windows, evaluated once per call by a first kernel.
            ws = torch.empty((rank, slots, plan.width), dtype=f32,
                             device=dev)
            st = torch.empty((rank, slots), dtype=i32, device=dev)
    lib = _build.library()
    group, slab, lines, threads, smem = launch_shape(geom, batch2,
                                                     plan.width)
    ints, floats = _build.kernel_params(geom, plan, batch2, group, threads,
                                        smem, slab=slab, lines=lines)
    out = torch.empty((geom.num_tiles, batch2) + geom.ext,
                      dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tnt_spread(int(kw is not None), tile_bounds.data_ptr(),
                            values_pl.data_ptr(), coords_ptr,
                            0 if ws is None else ws.data_ptr(),
                            0 if st is None else st.data_ptr(),
                            out.data_ptr(), ints, floats, stream)
    _build.check(rc, "spread kernel launch")
    return (out.reshape(geom.tiles + (batch2,) + geom.ext),
            -(-batch2 // group))


def _count(wrapper, geom: TileGeometry, groups: int) -> None:
    wrapper.launches += 1
    if geom.rank == 2:
        wrapper.channel_groups += groups


def spread_planned_cuda(values_pl: torch.Tensor, tile_bounds: torch.Tensor,
                        geom: TileGeometry, plan,
                        kw: KernelWeights) -> torch.Tensor:
    """Hopper spread from the planned windows: values [B2, slots]
    -> tiles [*tiles, B2, *ext] (float32)."""
    out, groups = _launch(values_pl, tile_bounds, geom, plan, kw, None)
    _count(spread_planned_cuda, geom, groups)
    return out


def spread_unplanned_cuda(values_pl: torch.Tensor,
                          tile_bounds: torch.Tensor, geom: TileGeometry,
                          plan, coords: torch.Tensor) -> torch.Tensor:
    """Hopper spread evaluating the windows in the kernel from the
    [4, slots] coords payload."""
    out, groups = _launch(values_pl, tile_bounds, geom, plan, None, coords)
    _count(spread_unplanned_cuda, geom, groups)
    return out


# Launches, and the channel groups (the launch grid's second dimension)
# of the rank-2 launches: each group is one pass of every tile's slots.
spread_planned_cuda.launches = 0
spread_unplanned_cuda.launches = 0
spread_planned_cuda.channel_groups = 0
spread_unplanned_cuda.channel_groups = 0


def _launch_banded(values_pl, tile_bounds, geom: TileGeometry, plan,
                   coords, band: BandInfo, twiddles=None):
    if geom.rank != 3:
        raise NotImplementedError("the banded spread kernel is rank 3")
    fused = twiddles is not None
    batch2, slots = values_pl.shape[0], geom.num_slots
    sublen = min(SUB, geom.chunk)
    f32, i32 = torch.float32, torch.int32
    need = functools.partial(_build.require_cuda, "banded spread")
    need(values_pl, "values", f32, (batch2, slots))
    need(tile_bounds, "tile_bounds", i32, (geom.num_tiles + 1,))
    need(coords, "coords", f32, (6, slots))
    need(band.zorigins, "zorigins", i32, (slots // sublen,))
    group, slab, lines, threads, smem = launch_shape(geom, batch2,
                                                     plan.width, fused)
    if lines != geom.ext[1]:
        raise ValueError(
            f"banded spread kernel: a row's planes of ext {geom.ext} do not "
            f"fit one thread block")
    if fused:
        n2 = twiddles.shape[-1]
        need(twiddles, "twiddles", f32,
             (3, geom.tiles[2], geom.ext[2], n2))
        if batch2 % 2:
            raise ValueError("the fused banded spread takes (re, im) "
                             "channel pairs")
        shape = geom.tiles[:2] + (batch2,) + geom.ext[:2] + (n2,)
    else:
        n2 = 0
        shape = (geom.num_tiles, batch2) + geom.ext
    lib = _build.library()
    ints, floats = _build.kernel_params(
        geom, plan, batch2, group, threads, smem, band=band.band,
        slab=slab, sublen=sublen, n2=n2, lines=lines)
    dev = values_pl.device
    out = torch.empty(shape, dtype=f32, device=dev)
    # The slots' windows, evaluated once per call by the first kernel.
    ws = torch.empty((3, slots, plan.width), dtype=f32, device=dev)
    st = torch.empty((3, slots), dtype=i32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tnt_spread_banded(
            int(fused), tile_bounds.data_ptr(), band.zorigins.data_ptr(),
            values_pl.data_ptr(), coords.data_ptr(), ws.data_ptr(),
            st.data_ptr(), twiddles.data_ptr() if fused else 0,
            out.data_ptr(), ints, floats, stream)
    _build.check(rc, "banded spread kernel launch")
    if fused:
        return out
    return out.reshape(geom.tiles + (batch2,) + geom.ext)


def spread_banded_cuda(values_pl: torch.Tensor, tile_bounds: torch.Tensor,
                       geom: TileGeometry, plan, coords: torch.Tensor,
                       band: BandInfo) -> torch.Tensor:
    """Hopper banded spread (rank 3, z-ordered binning): values
    [B2, slots] -> tiles [*tiles, B2, *ext] (float32)."""
    out = _launch_banded(values_pl, tile_bounds, geom, plan, coords, band)
    spread_banded_cuda.launches += 1
    return out


def spread_dfta_cuda(values_pl: torch.Tensor, tile_bounds: torch.Tensor,
                     geom: TileGeometry, plan, coords: torch.Tensor,
                     band: BandInfo, twiddles: torch.Tensor) -> torch.Tensor:
    """Hopper banded spread with the fused axis-2 DFT epilogue: values
    [B2, slots] and the twiddles [3, nt2, E2, n2] (c, s - c, s + c) ->
    y [nt0, nt1, B2, E0, E1, n2] (float32)."""
    out = _launch_banded(values_pl, tile_bounds, geom, plan, coords, band,
                         twiddles)
    spread_dfta_cuda.launches += 1
    return out


spread_banded_cuda.launches = 0
spread_dfta_cuda.launches = 0


def spread_tiles_plain(values_pl: torch.Tensor, tile_bounds: torch.Tensor,
                       geom: TileGeometry, plan,
                       kw: Optional[KernelWeights] = None,
                       coords: Optional[torch.Tensor] = None,
                       band: Optional[BandInfo] = None) -> torch.Tensor:
    """Plain PyTorch spread, the same function as the kernels: values
    [B2, slots] -> [*tiles, B2, *ext], from the planned windows ``kw``
    or from ``coords`` (with ``band``: the banded kernel's axis-0
    windows). Any float dtype; sums with ``index_add_``, one
    [B2, slots, width] contribution per leading-axis window offset (the
    last axis's window is the vector dimension), in the kernel's
    product order wl * (v * wlast)."""
    if kw is None:
        kw = binning.slot_weights(coords, tile_bounds, geom, plan,
                                  band=band)
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
        lead = 0 if wl is None else row[:, None] * ext[-1]
        idx = base + (lead + cols)[None]
        # Rank 1 has no leading axis: the contribution is v * w0.
        contrib = vwl if wl is None else wl[None, :, None] * vwl
        ok = ok[None]
        out.index_add_(0, torch.where(ok, idx, 0).reshape(-1),
                       torch.where(ok, contrib, 0.0).reshape(-1))
    return out.reshape(geom.tiles + (batch2,) + ext)


def dfta_plain(tiles: torch.Tensor, twiddles: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the fused epilogue: tiles
    [nt0, nt1, nt2, B2, E0, E1, E2] (channels (b, re/im)) and twiddles
    [3, nt2, E2, n2] (c, s - c, s + c) -> y [nt0, nt1, B2, E0, E1, n2],
    each tile's E2 axis contracted as t1 = (xr + xi) c, t2 = xr (s - c),
    t3 = xi (s + c), (yr, yi) = (t1 - t3, t1 + t2), summed over t2 in
    order."""
    cw, smcw, spcw = twiddles
    yr = yi = None
    for t2 in range(tiles.shape[2]):
        xr, xi = tiles[:, :, t2, 0::2], tiles[:, :, t2, 1::2]
        t1 = (xr + xi) @ cw[t2]
        ar, ai = t1 - xi @ spcw[t2], t1 + xr @ smcw[t2]
        yr, yi = (ar, ai) if yr is None else (yr + ar, yi + ai)
    y = torch.stack([yr, yi], dim=3)             # [nt0, nt1, B, 2, ...]
    return y.reshape(y.shape[:2] + (-1,) + y.shape[4:])
