"""Tile binning, chunk payloads and the halo folds, in plain torch.

Counterpart of ``tensorflow_nufft_tpu.kernels.binning``. Points are
assigned to fine-grid tiles; the point stream, grouped by tile, is padded
at tile boundaries up to a multiple of the chunk size, which bounds the
chunk count by ``M // chunk + num_tiles`` for any distribution. One
thread block of the CUDA kernels owns each tile's halo-padded block, so
no global atomics are needed; ``overlap_add`` then folds the halos back
periodically.

The geometry (``choose_geometry``) is the JAX package's, unchanged, so
both packages lay out the same chunks and the tests can compare tile
blocks and slot-order values directly. Binning is one stable int32 sort
by tile id (the JAX package's ``_ranks_and_starts_bigm`` form), which
keeps arrival order within a tile as its prefix-sum forms do.

The planned artifact of the "mats" plan level is ``KernelWeights``: per
slot and per axis the ``width`` kernel weights and the int window start.
It replaces the dense per-chunk [sum(E), chunk] kernel matrices of the
TPU path, which are mostly zeros (about 6 MB against 54 MB at 65,536
points on a 512^2 fine grid). Plans whose dense matrices would exceed
``MATS_BYTES_BUDGET`` take the "binned" level instead, as the JAX
package's do: they keep the coords payload, and at rank 3 bin in z-order
on a coarse axis-0 geometry (``choose_geometry(banded=True)``,
``bin_points(zorder=True)``) so that each sub-chunk touches only a
``band`` of axis-0 rows (``compute_band_origins``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from tensorflow_nufft_tpu_torch.kernels.torch_ops import _const, es_kernel_for

# Sentinel coordinate for padded slots: far outside any tile, so kernel
# windows land out of range and contribute exactly zero.
SENTINEL = -1.0e6

# Window starts are clamped to this magnitude before the int32 cast, so
# far-out (or NaN) coordinates give an out-of-range window, never UB.
_START_LIMIT = 1.0e8


@dataclasses.dataclass(frozen=True)
class TileGeometry:
    """Static tiling parameters (any rank)."""
    fine_shape: Tuple[int, ...]
    tile: Tuple[int, ...]          # core tile dims (divide fine dims)
    pad: int                       # halo on each side
    chunk: int                     # points per chunk
    num_chunks: int                # static chunk-count bound

    @property
    def rank(self) -> int:
        return len(self.fine_shape)

    @property
    def tiles(self) -> Tuple[int, ...]:
        return tuple(nf // t for nf, t in zip(self.fine_shape, self.tile))

    @property
    def num_tiles(self) -> int:
        return int(np.prod(self.tiles))

    @property
    def ext(self) -> Tuple[int, ...]:
        """Extended (halo-padded) tile dims."""
        return tuple(t + 2 * self.pad for t in self.tile)

    @property
    def num_slots(self) -> int:
        return self.num_chunks * self.chunk


_TILE_PREFS = {
    1: (1024, 768, 512, 1280, 256, 1536, 2048, 128, 64, 32, 16),
    2: (64, 96, 128, 160, 192, 256, 320, 32, 16),
}
_TILE_PREFS_3D = (
    (16, 8, 24, 32, 40, 64, 48, 96, 128),     # leading axis
    (16, 24, 32, 40, 8, 64, 48, 96, 128),     # middle axis
    (64, 48, 96, 80, 40, 32, 128, 24, 16),    # last axis
)
# The binned level's rank-3 prefs: the axis-0 band bounds each
# sub-chunk's work, so axis 0 goes coarse (fewer tiles, less padding).
_TILE_PREFS_3D_BANDED = (
    (128, 256, 64, 96, 192, 32, 16, 8),       # leading axis (banded)
    (16, 24, 32, 40, 8, 64, 48, 96, 128),     # middle axis
    (64, 48, 96, 80, 40, 32, 128, 24, 16),    # last axis
)

# Slots of one rank-3 sub-chunk: the unit of the axis-0 band (and of the
# kernels' slot staging, kSub in csrc/spread.cu).
SUB = 128

# The dense [sum(E), chunk] matrices a JAX plan would precompute, in
# bytes, above which PlannedNufft takes the binned level (the JAX
# package's pallas_spread.MATS_BYTES_BUDGET). Tests lower it to reach the
# binned level at small sizes.
MATS_BYTES_BUDGET = 256 * 2 ** 20


def choose_geometry(fine_shape: Sequence[int], width: int,
                    num_points: int, chunk: int = 0,
                    tile_pref: int = 0,
                    banded: bool = False) -> TileGeometry:
    """Picks tile dims that divide the fine grid and a chunk size, as
    the JAX package does (its tile preferences were tuned on a TPU;
    retuning them for Hopper is later, measured work). ``banded`` takes
    the binned level's rank-3 prefs and chunk cap.

    The halo covers the kernel footprint: a point owned by a tile can
    touch indices down to ceil(s - w/2) >= tile_start - (w//2 + 1), so
    pad = width//2 + 1, rounded up to a multiple of 4.
    """
    fine_shape = tuple(int(n) for n in fine_shape)
    rank = len(fine_shape)
    pad = -(-(width // 2 + 1) // 4) * 4
    tile = []
    for d, nf in enumerate(fine_shape):
        if rank == 3:
            prefs = (_TILE_PREFS_3D_BANDED if banded else _TILE_PREFS_3D)[d]
        else:
            prefs = _TILE_PREFS[rank]
        prefs = ((tile_pref,) if tile_pref else ()) + prefs
        t = nf
        for cand in prefs:
            if cand and nf % cand == 0 and cand >= 2 * pad:
                t = cand
                break
        tile.append(t)
    tile = tuple(tile)
    num_tiles = int(np.prod([nf // t for nf, t in zip(fine_shape, tile)]))
    if chunk == 0:
        # Aim for ~25% padding waste worst-case, in [256, 2048].
        target = max(num_points // (2 * num_tiles), 1)
        chunk = int(min(2048, max(256, 2 ** int(np.ceil(np.log2(target))))))
    sum_ext = sum(t + 2 * pad for t in tile)
    vmem_cap = max(256, ((2 << 20) // (4 * sum_ext)) // 256 * 256)
    chunk = min(chunk, vmem_cap)
    if rank == 3:
        chunk = min(chunk, 512 if banded else 1024)
    chunk = min(chunk, max(64, int(np.ceil(num_points / 64)) * 64))
    if rank == 3 and chunk > 128:
        chunk = -(-chunk // 128) * 128
    num_chunks = num_points // chunk + num_tiles
    return TileGeometry(fine_shape, tile, pad, chunk, num_chunks)


def geometry_valid(geom: TileGeometry) -> bool:
    """Whether each tile covers both halo bands (tile >= 2*pad), which
    the periodic overlap-add needs."""
    return all(t >= 2 * geom.pad for t in geom.tile)


def mats_supported(geom: TileGeometry) -> bool:
    """Whether the JAX package's dense-matrix payload layout serves the
    geometry (8-aligned extended dims, 128-aligned chunks)."""
    return all(e % 8 == 0 for e in geom.ext) and geom.chunk % 128 == 0


def mats_payload_bytes(geom: TileGeometry) -> int:
    """Bytes of the dense per-chunk [sum(E), chunk] kernel matrices a JAX
    plan of this geometry would precompute."""
    return 4 * geom.num_chunks * geom.chunk * sum(geom.ext)


# The JAX package's rule for when a rank-3 binned plan keeps its geometry
# (pallas_spread.streaming_group_size and the terms it reads): a layout
# rule, ported like MATS_BYTES_BUDGET because the slot surface exposes the
# layout it picks. No kernel of the port reads these numbers; they model
# a TPU program's memory, not a Hopper block's.
VMEM_RESIDENT_BUDGET = 12 * 2 ** 20
MAX_CHANNELS = 8
NBUF = 4


def _stack_bytes_streaming(geom: TileGeometry, batch2: int,
                           band: Optional[int] = None) -> int:
    if geom.rank != 3:
        return 4 * batch2 * max(geom.ext) * geom.chunk
    e0, e1, e2 = geom.ext
    if band:
        e0 = band
    sub = min(SUB, geom.chunk)
    return 4 * (7 * e0 * e1 * sub + 3 * batch2 * e0 * e1 * e2)


def _scratch_bytes_streaming(geom: TileGeometry, batch2: int,
                             band: Optional[int] = None) -> int:
    per_chunk = (sum(geom.ext) + 8) * geom.chunk
    out_stream = 2 * batch2 * geom.chunk
    mref = 0
    if geom.rank == 3:
        mref = (sum(geom.ext[1:]) if band else sum(geom.ext)) * geom.chunk
    return (4 * (NBUF * per_chunk + out_stream + mref)
            + _stack_bytes_streaming(geom, batch2, band))


def streaming_group_size(geom: TileGeometry,
                         band: Optional[int] = None) -> int:
    """The JAX package's channel group of its per-tile-grid kernels on
    ``geom`` (with ``band``: the banded ones); 0 where not even a channel
    pair fits its memory model, and then the JAX plan re-plans."""
    g = MAX_CHANNELS
    while g >= 2:
        block = g * int(np.prod(geom.ext)) * 4
        if block + _scratch_bytes_streaming(geom, g, band) <= \
                VMEM_RESIDENT_BUDGET:
            return g
        g -= 2
    return 0


def sort_cell_size(geom: TileGeometry) -> int:
    """Axis-0 cell of z-ordered binning: fine enough that a sub-chunk's
    axis-0 span stays tight, coarse enough that the (tile, cell) keys
    stay few."""
    t0 = geom.tile[0]
    cell = max(2, t0 // 32)
    while t0 % cell:
        cell += 1
    return cell


class BinnedPoints(NamedTuple):
    """Tile-ordered, chunk-padded point metadata."""
    points_hi: torch.Tensor    # [M, rank] coordinate high words
    points_lo: torch.Tensor    # [M, rank] coordinate low words
    padpos: torch.Tensor       # [M] int32 slot of each point
    invpos: torch.Tensor       # [num_chunks * chunk] int32 point of each
    #                            slot (M for padded slots)
    chunk_tidx: Tuple[torch.Tensor, ...]  # per-axis int32 tile index
    #                                       of each chunk
    tile_bounds: torch.Tensor  # [num_tiles + 1] int32: tile t owns
    #                            chunks [b[t], b[t+1])


class BandInfo(NamedTuple):
    """The axis-0 band of a z-ordered rank-3 binning: sub-chunk j (of
    ``SUB`` slots) touches only extended-tile rows [zorigins[j],
    zorigins[j] + band)."""
    band: int
    zorigins: torch.Tensor     # [num_chunks * subs] int32


class KernelWeights(NamedTuple):
    """Planned spread/interp artifact: per-slot separable kernel
    windows relative to the slot's extended tile. Padded slots (hi =
    SENTINEL) have window starts far out of range, so every consumer,
    which bounds-checks each window index, takes nothing from them."""
    weights: torch.Tensor      # [rank, num_slots, width] kernel values
    starts: torch.Tensor       # [rank, num_slots] int32 window starts


def bin_points(points_resc, geom: TileGeometry,
               zorder: bool = False) -> BinnedPoints:
    """Groups points by tile and builds the padded chunk stream.

    The per-tile counts come from the stable sort by tile id, without a
    host readback (``torch.bincount`` reads its range back on the card),
    so on the card the binning queues its work and never waits for it.

    Args:
        points_resc: coordinates in fine-grid units ([0, nf)): a
            [M, rank] tensor or a two-float (hi, lo) pair.
        geom: static tiling.
        zorder: order points within each tile by their axis-0 cell
            (``sort_cell_size``), then by arrival, instead of by arrival
            alone: the layout the axis-0 band needs.
    """
    if isinstance(points_resc, tuple):
        points_hi, points_lo = points_resc
    else:
        points_hi = points_resc
        points_lo = torch.zeros_like(points_resc)
    device = points_hi.device
    i32 = torch.int32
    m = points_hi.shape[0]
    rank, tiles = geom.rank, geom.tiles
    num_tiles, chunk = geom.num_tiles, geom.chunk

    tid = None
    for d in range(rank):
        td = torch.clamp(
            torch.floor_divide(points_hi[:, d], geom.tile[d]).to(i32),
            0, tiles[d] - 1)
        tid = td if tid is None else tid * tiles[d] + td
        if d == 0:
            tid0 = td
    key = tid
    if zorder:
        cell = sort_cell_size(geom)
        zcells = geom.tile[0] // cell
        zc = torch.clamp(
            torch.floor_divide(points_hi[:, 0], cell).to(i32)
            - tid0 * zcells, 0, zcells - 1)
        key = tid * zcells + zc

    # Stable sort keeps arrival order within each tile (and z-cell); a
    # point's rank within its tile is its sorted position minus the
    # tile's first. The key orders by tile first, so a search of the
    # sorted tile ids gives each tile's first position and count (tid is
    # in range by its clamp).
    order = torch.argsort(key, stable=True)
    tid_sorted = tid[order]
    tile_ids = torch.arange(num_tiles + 1, dtype=i32, device=device)
    bounds = torch.searchsorted(tid_sorted, tile_ids, out_int32=True)
    first = bounds[:-1]
    counts = bounds[1:] - first
    rounds = torch.clamp((counts + chunk - 1) // chunk, min=1)
    chunk_starts = torch.cumsum(rounds, 0, dtype=i32) - rounds
    tid_sorted = tid_sorted.long()
    pos = torch.arange(m, dtype=i32, device=device)
    padpos_sorted = (chunk_starts[tid_sorted] * chunk
                     + (pos - first[tid_sorted]))
    padpos = torch.empty(m, dtype=i32, device=device)
    padpos[order] = padpos_sorted

    chunk_tile = _chunk_tiles(chunk_starts, geom)
    chunk_tidx = []
    rem = chunk_tile
    for d in range(rank - 1, -1, -1):
        chunk_tidx.append((rem % tiles[d]).to(i32))
        rem = rem // tiles[d]
    chunk_tidx = tuple(reversed(chunk_tidx))

    tile_bounds = torch.cat(
        [chunk_starts, (chunk_starts[-1] + rounds[-1]).reshape(1)]).to(i32)
    invpos = torch.full((geom.num_slots,), m, dtype=i32, device=device)
    invpos[padpos.long()] = pos
    return BinnedPoints(points_hi, points_lo, padpos, invpos, chunk_tidx,
                        tile_bounds)


def _chunk_tiles(chunk_starts: torch.Tensor, geom: TileGeometry
                 ) -> torch.Tensor:
    """Tile of each chunk; chunks beyond the used range attach to the
    last tile."""
    chunk_ids = torch.arange(geom.num_chunks, dtype=torch.int32,
                             device=chunk_starts.device)
    chunk_tile = torch.searchsorted(chunk_starts.contiguous(), chunk_ids,
                                    right=True) - 1
    return torch.clamp(chunk_tile, 0, geom.num_tiles - 1)


def slot_tiles(tile_bounds: torch.Tensor, geom: TileGeometry
               ) -> torch.Tensor:
    """[num_slots] int64 tile owning each slot; -1 for the slots of
    chunks past ``tile_bounds[-1]``, which no tile owns."""
    chunk_tile = _chunk_tiles(tile_bounds[:-1], geom)
    used = torch.arange(geom.num_chunks, device=tile_bounds.device) \
        < tile_bounds[-1]
    chunk_tile = torch.where(used, chunk_tile, -1)
    return chunk_tile.repeat_interleave(geom.chunk)


def binned_from_numpy(points_hi, points_lo, padpos, invpos, chunk_tidx,
                      tile_bounds, device=None) -> BinnedPoints:
    """``BinnedPoints`` from numpy arrays (for instance the fields of
    the JAX package's ``BinnedPoints``), so that both packages run on
    the identical chunk layout."""
    def t(x, dtype=None):
        return torch.as_tensor(np.array(x, dtype=dtype), device=device)
    return BinnedPoints(
        t(points_hi), t(points_lo), t(padpos, np.int32),
        t(invpos, np.int32), tuple(t(c, np.int32) for c in chunk_tidx),
        t(tile_bounds, np.int32))


def build_values_payload(values_cm: torch.Tensor,
                         binned: BinnedPoints) -> torch.Tensor:
    """Channel-major point values [B2, M] -> slot order [B2, num_slots],
    zero in padded slots (one gather through ``invpos``)."""
    src = torch.cat([values_cm, values_cm.new_zeros(values_cm.shape[0], 1)],
                    dim=1)
    return src[:, binned.invpos.long()]


def build_coords_payload(binned: BinnedPoints) -> torch.Tensor:
    """[2*rank, num_slots] slot-order coordinates: rows 0..rank-1 high
    words (SENTINEL in padded slots), rank..2rank-1 low words (zero)."""
    hi, lo = binned.points_hi, binned.points_lo
    rank = hi.shape[1]
    src = torch.cat([hi.t(), lo.t()], dim=0)
    pads = src.new_zeros(2 * rank, 1)
    pads[:rank] = SENTINEL
    return torch.cat([src, pads], dim=1)[:, binned.invpos.long()]


def slot_origins(tile_bounds: torch.Tensor, geom: TileGeometry,
                 dtype: torch.dtype) -> torch.Tensor:
    """[rank, num_slots] extended-tile origin (tile_idx * tile - pad) of
    each slot, from the chunk ranges the tiles own."""
    chunk_tile = _chunk_tiles(tile_bounds[:-1], geom)
    origins = []
    rem = chunk_tile
    for d in range(geom.rank - 1, -1, -1):
        tidx = (rem % geom.tiles[d]).to(dtype)
        origins.append(tidx * float(geom.tile[d]) - float(geom.pad))
        rem = rem // geom.tiles[d]
    origins = torch.stack(list(reversed(origins)))          # [rank, NC]
    return origins.repeat_interleave(geom.chunk, dim=1)


def slot_weights(coords: torch.Tensor, tile_bounds: torch.Tensor,
                 geom: TileGeometry, plan,
                 deriv_axis: Optional[int] = None,
                 band: Optional[BandInfo] = None) -> KernelWeights:
    """Per-slot kernel windows from the coords payload.

    Axis d's window of a slot starts at i0 = ceil(s - w/2), where
    s = hi - origin is the coordinate in extended-tile units, and holds
    phi(((i0 + j) - s) - lo) for j < w: the nonzero entries of the TPU
    path's dense kernel matrices, evaluated by the same arithmetic.
    On ``deriv_axis`` the window holds phi' instead (the spread-only
    points gradients; ``pallas_spread.kernel_matrices_from``).

    With ``band``: the banded kernels' windows (``es_window_exact`` in
    ``csrc/tnt_common.cuh``). The argument is formed from the fine-grid
    row, c = ceil(hi - w/2) and z_j = ((c + j) - hi) - lo, exact but for
    the last step, so it does not round where s = hi - origin crosses a
    binade (tile 0 of the coarse binned geometry); the start is c -
    origin. Axis-0 rows outside the slot's sub-chunk band [zo, zo +
    band) get weight 0 (they lie outside the kernel's support by the
    band's construction, so this drops exact zeros).
    """
    rank = geom.rank
    origins = slot_origins(tile_bounds, geom, coords.dtype)
    j = torch.arange(plan.width, dtype=coords.dtype, device=coords.device)
    hw = _const(plan.half_width, coords)
    weights, starts = [], []
    for d in range(rank):
        hi, lo = coords[d], coords[rank + d]
        if band is None:
            s = hi - origins[d]
            i0 = torch.ceil(s - hw)
            z = ((i0[:, None] + j[None, :]) - s[:, None]) - lo[:, None]
        else:
            c = torch.ceil(hi - hw)
            z = ((c[:, None] + j[None, :]) - hi[:, None]) - lo[:, None]
            i0 = c - origins[d]
        w = es_kernel_for(z, plan, deriv=d == deriv_axis)
        if band is not None and d == 0:
            zo = band.zorigins.repeat_interleave(
                min(SUB, geom.chunk)).to(coords.dtype)
            row = (i0 - zo)[:, None] + j[None, :]
            w = torch.where((row >= 0) & (row < band.band), w, 0.0)
        weights.append(w)
        i0 = torch.nan_to_num(i0, nan=-_START_LIMIT)
        starts.append(torch.clamp(i0, -_START_LIMIT, _START_LIMIT)
                      .to(torch.int32))
    return KernelWeights(torch.stack(weights).contiguous(),
                         torch.stack(starts).contiguous())


def build_weight_payload(binned: BinnedPoints, geom: TileGeometry,
                         plan) -> KernelWeights:
    """The planned artifact: ``slot_weights`` of the binned points."""
    return slot_weights(build_coords_payload(binned), binned.tile_bounds,
                        geom, plan)


def compute_band_origins(binned: BinnedPoints, geom: TileGeometry,
                         half_width: float, sub: int = SUB):
    """The axis-0 band of a z-ordered rank-3 binning (the JAX package's
    ``binning.compute_band_origins``, a numpy pass at plan time).

    Each ``sub``-slot sub-chunk touches only the extended-tile rows e
    with a nonzero kernel weight, e in the open interval (s - hw, s + hw)
    of some slot's axis-0 coordinate s: [floor(s_min - hw) + 1,
    ceil(s_max + hw) - 1]. The 1e-3 slack covers the two-float low
    words, which this high-word bound ignores.

    Returns (band, zorigins): band, a multiple of 4 and at most E0 (E0
    means the band degenerated), and the int32 [num_chunks * subs]
    numpy array of band start rows, clamped to [0, E0 - band] (0 for
    empty sub-chunks).
    """
    e0 = geom.ext[0]
    chunk, nc = geom.chunk, geom.num_chunks
    sublen = min(sub, chunk)
    subs = -(-chunk // sublen)
    z = binned.points_hi[:, 0].detach().cpu().numpy().astype(np.float64)
    invpos = binned.invpos.cpu().numpy()
    zs = np.concatenate([z, [np.nan]])[invpos]            # slot order
    t0 = binned.chunk_tidx[0].cpu().numpy().astype(np.float64)
    origin = t0 * geom.tile[0] - geom.pad                 # [NC]
    s_ext = zs.reshape(nc, subs, sublen) - origin[:, None, None]
    valid = np.isfinite(s_ext)
    any_valid = valid.any(axis=-1)
    mins = np.where(valid, s_ext, np.inf).min(axis=-1)
    maxs = np.where(valid, s_ext, -np.inf).max(axis=-1)
    lo = np.floor(mins - half_width - 1e-3) + 1.0
    hi = np.ceil(maxs + half_width + 1e-3) - 1.0
    need = np.where(any_valid, hi - lo + 1.0, 0.0)
    band = int(need.max()) if need.size else 0
    band = min(-(-max(band, 4) // 4) * 4, e0)
    zo = np.where(any_valid, lo, 0.0)
    zo = np.clip(zo, 0, e0 - band).astype(np.int32)
    return band, zo.reshape(nc * subs)


def slot_order_scalar(x: torch.Tensor, binned: BinnedPoints
                      ) -> torch.Tensor:
    """Point-order reals [M] -> slot order [num_slots], zero in padded
    slots, in the points' dtype (one gather through ``invpos``): per-point
    weights for ``PlannedNufft.normal``."""
    x = x.to(binned.points_hi.dtype)
    return torch.cat([x, x.new_zeros(1)])[binned.invpos.long()]


def scatter_chunked(values: torch.Tensor, binned: BinnedPoints
                    ) -> torch.Tensor:
    """Slot-order values [R, num_slots] -> point order [R, M] (one
    gather through ``padpos``)."""
    return values[:, binned.padpos.long()]


def overlap_add(tiles: torch.Tensor, geom: TileGeometry,
                axes: Optional[int] = None) -> torch.Tensor:
    """Per-tile extended blocks [*tiles, B, *ext] -> fine grid
    [B, *fine_shape], adding each halo band periodically onto the
    neighbouring tile's core. With ``axes`` = a, only the first a axes
    are tiled: [*tiles[:a], B, *ext[:a], *rest] -> [B, *fine[:a], *rest]
    (the fused type-1 route's [nt0, nt1, B2, E0, E1, n2])."""
    rank, pad = axes or geom.rank, geom.pad
    x = tiles
    for d in range(rank):
        tile_ax, ext_ax = d, rank + 1 + d
        t = geom.tile[d]
        left = torch.roll(x.narrow(ext_ax, 0, pad), -1, dims=tile_ax)
        right = torch.roll(x.narrow(ext_ax, t + pad, pad), 1, dims=tile_ax)
        x = torch.cat([
            x.narrow(ext_ax, pad, pad) + right,
            x.narrow(ext_ax, 2 * pad, t - 2 * pad),
            x.narrow(ext_ax, t, pad) + left,
        ], dim=ext_ax)                       # ext axis now length t
    perm = [rank]
    for d in range(rank):
        perm.extend([d, rank + 1 + d])
    rest = tuple(range(2 * rank + 1, x.ndim))
    x = x.permute(perm + list(rest))
    return x.reshape((x.shape[0],) + geom.fine_shape[:rank]
                     + tuple(x.shape[2 * rank + 1:]))


def extend_tiles(fine: torch.Tensor, geom: TileGeometry) -> torch.Tensor:
    """Fine grid [B, *fine] -> per-tile extended blocks
    [*tiles, B, *ext] with periodic halos (inverse companion of
    ``overlap_add``)."""
    rank, pad = geom.rank, geom.pad
    x = fine
    for d in range(rank):
        ax = 1 + 2 * d
        nt, t = geom.tiles[d], geom.tile[d]
        shape = tuple(x.shape)
        x = x.reshape(shape[:ax] + (nt, t) + shape[ax + 1:])
        left = torch.roll(x.narrow(ax + 1, t - pad, pad), 1, dims=ax)
        right = torch.roll(x.narrow(ax + 1, 0, pad), -1, dims=ax)
        x = torch.cat([left, x, right], dim=ax + 1)
    perm = [1 + 2 * d for d in range(rank)] + [0] + \
        [2 + 2 * d for d in range(rank)]
    return x.permute(perm).contiguous()
