"""Launch planning of the port's spread, interp and halo kernels (pure
Python).

Every geometry ``choose_geometry`` returns at ranks 2 and 3 must launch:
a block owns an axis-0 slab of a tile (spread) or stages its rows in
pieces (interp), never a whole tile, so extended tiles larger than one
thread block's shared memory (2D ext 308^2 at 150^2 modes, 3D (108, 108,
108) at 50^3, (32, 32, 80) at width 10) take the same kernels as the
headlines. The sizes sweep the ranges that did not fit a block when it
held a whole tile, and the headlines.
"""

import numpy as np
import pytest

from tensorflow_nufft_tpu_torch.kernels import (_build, binning, interp,
                                                mode3d, spread)
from tensorflow_nufft_tpu_torch.plan.plan import PlanSpec, make_plan

SIZES = ([(2, n) for n in (121, 150, 180, 256, 300, 500)]
         + [(3, n) for n in (13, 17, 30, 50, 90, 128, 150, 192, 256)])
POINTS = {2: 65_536, 3: 800_000}


def _geometry(rank, n, tol):
    plan = make_plan(PlanSpec("type_1", "forward", rank, (n,) * rank,
                              "complex64", tol, 1))
    return plan, binning.choose_geometry(plan.fine_shape, plan.width,
                                         POINTS[rank])


@pytest.mark.parametrize("b2", (1, 2, 6, 16))
@pytest.mark.parametrize("tol", (1e-6, 1e-7))
@pytest.mark.parametrize("rank,n", SIZES)
def test_launch_plans_take_every_geometry(rank, n, tol, b2):
    plan, geom = _geometry(rank, n, tol)
    e0, e1 = geom.ext[:2]

    group, slab, lines, threads, smem = spread.launch_shape(
        geom, b2, plan.width)
    assert group == min(b2, 2)
    assert 1 <= slab <= e0 and 1 <= lines <= e1
    assert threads == 32 * slab <= 1024 and smem <= _build.SMEM_LIMIT
    # The blocks' slabs and line ranges cover the extended tile, and the
    # block's planes and window copies are what it asks for.
    assert -(-e0 // slab) * slab >= e0 and -(-e1 // lines) * lines >= e1
    line = geom.ext[2] if rank == 3 else 1
    assert smem == 4 * slab * (group * lines * line
                               + 32 * (rank - 1) * plan.width)

    group, slab, slots, threads, smem = interp.launch_shape(geom, b2)
    assert group == 1
    assert geom.chunk % slots == 0 and slots <= threads <= 1024
    assert threads % 32 == 0 and threads - slots < 32
    assert 0 <= slab <= e0 and smem <= _build.SMEM_LIMIT
    assert smem == 2 * slab * 4 * int(np.prod(geom.ext[1:]))


# Rank 1: small fine grids (one tile, and ext 258 where no preference
# divides 250), the mats-size and headline grids (ext 1032), and one
# wide tile (ext 20258).
SIZES_1D = (128, 250, 20_250, 131_072, 2_097_152)


@pytest.mark.parametrize("b2", (1, 2, 8, 16))
@pytest.mark.parametrize("width", (2, 7, 12, 16))
@pytest.mark.parametrize("nf", SIZES_1D)
def test_rank1_launch_plans_take_every_geometry(nf, width, b2):
    geom = binning.choose_geometry((nf,), width, 10_000_000)
    e0 = geom.ext[0]
    group, slab, lines, threads, smem = spread.launch_shape(geom, b2, width)
    # A block serves up to LINE_CHANNELS channels from one evaluation of
    # its windows; the groups on the grid cover every channel.
    assert group == min(b2, spread.LINE_CHANNELS) and lines == 1
    assert -(-b2 // group) * group >= b2 > (-(-b2 // group) - 1) * group
    assert 1 <= slab <= spread.LINE_WARPS and threads == 32 * slab <= 1024
    # The blocks of a tile cover its line in runs of LINE_RUN cells, one
    # warp each, with fewer than one block's warps to spare.
    runs = -(-e0 // spread.LINE_RUN)
    blocks = -(-runs // slab)
    assert blocks * slab >= runs and (blocks - 1) * slab < runs
    assert blocks * slab - runs < blocks
    # Two batches of one slot a thread: values, start and window.
    chan = spread.line_channels(group)
    assert group <= chan < 2 * group
    assert smem == 2 * threads * 4 * (chan + 1 + width)
    assert smem <= _build.SMEM_LIMIT

    group, slab, slots, threads, smem = interp.launch_shape(geom, b2)
    assert geom.chunk % slots == 0 and slots <= threads <= 1024
    assert threads % 32 == 0 and threads - slots < 32
    # Every channel in one block, in groups staged in turn; pieces of the
    # line only one channel at a time; one buffer where one stage holds
    # every channel's line.
    assert 1 <= group <= b2 and 1 <= slab <= e0
    groups = -(-b2 // group)
    assert groups * group >= b2 > (groups - 1) * group
    assert slab == e0 or (group == 1 and slab % 4 == 0)
    bufs = 1 if groups * -(-e0 // slab) == 1 else 2
    assert smem == bufs * group * slab * 4 <= _build.SMEM_LIMIT
    # A block takes up to LINE_UNITS units of slots in turn.
    assert 1 <= interp.line_units(geom) <= interp.LINE_UNITS


# Rank 3: the halo kernels (extend_tiles3d, fold3d, and fold3d on the
# fused route's y, axis 2 one untiled block of its n modes), at every
# geometry choose_geometry returns at the sizes above, unbanded and
# banded, for batch 1 to 8, with both tensors 16-byte aligned or not.
# The kernels use no shared memory.
@pytest.mark.parametrize("batch", (1, 2, 3, 8))
@pytest.mark.parametrize("banded", (False, True))
@pytest.mark.parametrize("tol", (1e-6, 1e-7))
@pytest.mark.parametrize("n", [n for rank, n in SIZES if rank == 3])
def test_halo_launch_plans_take_every_geometry(n, tol, banded, batch):
    plan = make_plan(PlanSpec("type_1", "forward", 3, (n,) * 3,
                              "complex64", tol, 1))
    geom = binning.choose_geometry(plan.fine_shape, plan.width, POINTS[3],
                                   banded=banded)
    for kind, g, axes in (("extend", geom, 3), ("fold", geom, 3),
                          ("fold", mode3d._modes2_geometry(geom, n), 2)):
        pad2 = g.pad if axes == 3 else 0
        t0, t1, t2 = g.tile
        if kind == "extend":
            width, rows_per_tile = t2 + 2 * pad2, g.ext[0] * g.ext[1]
        else:
            width, rows_per_tile = t2, t0 * t1
        for aligned in (True, False):
            vec, lanes, rows, iters, blocks = mode3d.halo_launch(
                g, batch, kind, axes, aligned)
            # Four cells a lane only where they are one aligned float4
            # that never straddles the periodic wrap of axis 2.
            assert vec in (1, 4) and width % vec == 0
            if vec == 4:
                assert aligned and t2 % 4 == 0 and pad2 % 4 == 0
            # The lanes cover a row, in turns beyond HALO_THREADS lanes,
            # with none idle, and the block fits its thread limit.
            assert lanes * vec <= width
            assert lanes * vec >= min(width, mode3d.HALO_THREADS * vec)
            assert rows >= 1
            assert lanes * rows <= mode3d.HALO_THREADS <= 1024
            # The blocks cover every row of the tiles once, in row steps
            # of at most HALO_ITERS, and fill the card where rows allow.
            total = g.num_tiles * batch * rows_per_tile
            assert total < 2 ** 31
            assert 1 <= iters <= mode3d.HALO_ITERS
            assert (blocks - 1) * rows * iters < total <= blocks * rows * iters
            assert iters == 1 or blocks >= mode3d.HALO_BLOCKS
