"""The port's planned 3D path against the JAX package's binned level.

The JAX ``PlannedNufft`` takes its binned level when the dense kernel
matrices would exceed ``pallas_spread.MATS_BYTES_BUDGET`` (256 MiB), as
at the 3D headline (128^3 modes, 800,000 points: 6.36e8 bytes). At rank 3 that
level bins points in z-order on a coarse axis-0 geometry and runs the
axis-0-banded kernels: ``_spread_kernel_banded`` for the planned type-1
(``_spread_kernel_split_banded_dfta`` where the fused axis-2 DFT fits
VMEM) and ``_interp_kernel_banded`` for the planned type-2. The band only
limits which axis-0 rows of a tile block a sub-chunk's contraction
touches; the tile blocks written and read are those of the unbanded
kernels.

Here the budget is zeroed to select that level at a small size, as
``tests/test_banded.py`` does, and the Pallas kernels run in interpret
mode. On the identical z-ordered chunk layout and banded geometry, the
port's plain planned spread and interp give the banded kernels' tile
blocks and values, and the port's ``PlannedNufft`` gives the binned-level
type-1 transform, all to 1e-5 of the peak (float32 summation order).
"""

import functools

import numpy as np
import pytest
import torch

from tensorflow_nufft_tpu import planar as jplanar
from tensorflow_nufft_tpu.kernels import binning as jb
from tensorflow_nufft_tpu.kernels import pallas_interp, pallas_spread
from tensorflow_nufft_tpu.options import Options
from tensorflow_nufft_tpu_torch import PlannedNufft
from tensorflow_nufft_tpu_torch.kernels import binning as tb
from tensorflow_nufft_tpu_torch.kernels import dispatch, spread
from tensorflow_nufft_tpu_torch.plan import plan as tplan
from tests.torch_threads import one_torch_thread  # noqa: F401

GRID = (24, 16, 16)
M = 3000
RTOL = 1e-5


def _points():
    return np.random.default_rng(11).uniform(
        -np.pi, np.pi, (M, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def binned_level_plan():
    """The JAX binned-level type-1 plan, and its layout as the port sees
    it."""
    budget = pallas_spread.MATS_BYTES_BUDGET
    pallas_spread.MATS_BYTES_BUDGET = 0
    try:
        op = jplanar.PlannedNufft(_points(), GRID, transform_type="type_1",
                                  tol=1e-6, options=Options(backend="pallas"))
    finally:
        pallas_spread.MATS_BYTES_BUDGET = budget
    assert op._level == "binned" and op.band_info is not None
    assert op.band_info[0] < op.geom.ext[0]
    g = op.geom
    tgeom = tb.TileGeometry(g.fine_shape, g.tile, g.pad, g.chunk,
                            g.num_chunks)
    binned = op.binned
    tbinned = tb.binned_from_numpy(
        *(np.asarray(x) for x in binned[:4]),
        [np.asarray(c) for c in binned.chunk_tidx],
        np.asarray(binned.tile_bounds))
    tp = tplan.make_plan(tplan.PlanSpec(
        "type_1", "forward", 3, GRID, "complex64", 1e-6, 1))
    return op, tgeom, tbinned, tp, tb.build_weight_payload(tbinned, tgeom,
                                                            tp)


def test_the_3d_headline_takes_the_banded_kernels():
    """At 128^3 modes and 800,000 points the JAX plan's dense matrices
    exceed their budget, so PlannedNufft takes the binned level on a
    coarse axis-0 geometry. There the fused axis-2 DFT fits VMEM at no
    band, so the planned type-1 runs ``_spread_kernel_banded`` (combined
    payload) and passes A-C; the unplanned path keeps the per-tile grid,
    since a channel group fits."""
    fine, m = (256, 256, 256), 800_000
    geom = jb.choose_geometry(fine, 7, m)
    assert pallas_spread.mats_payload_bytes(geom) == 635_535_360
    assert pallas_spread.MATS_BYTES_BUDGET == 256 * 2 ** 20
    assert pallas_spread.streaming_group_size(geom) > 0
    banded = jb.choose_geometry(fine, 7, m, banded=True)
    assert (banded.tile, banded.ext) == ((128, 16, 64), (136, 24, 72))
    assert not any(pallas_spread.fused_dfta_fits(banded, 2, 128, band)
                   for band in range(4, banded.ext[0], 4))
    assert pallas_spread.combined_fits(3, 2)


def _spy(monkeypatch, module, name):
    """Records each trace of the Pallas kernel ``module.name``."""
    calls = []
    kernel = getattr(module, name)

    def traced(*args, **kwargs):
        calls.append(name)
        return kernel(*args, **kwargs)
    monkeypatch.setattr(module, name, traced)
    return calls


def _relerr(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.mark.parametrize("stage,kernel", [
    ("spread", "_spread_kernel_banded"),
    ("interp", "_interp_kernel_banded")])
def test_plain_planned_stage_is_the_banded_kernel(monkeypatch, stage, kernel):
    op, tgeom, tbinned, tp, kw = binned_level_plan()
    rng = np.random.default_rng(5)
    if stage == "spread":
        calls = _spy(monkeypatch, pallas_spread, kernel)
        vals = rng.standard_normal((2, M)).astype(np.float32)
        want, _ = pallas_spread.spread_pallas_tiles(
            vals, op.points_resc, op.plan, binned=op.binned,
            coords=op.coords, geom=op.geom, band_info=op.band_info)
        got = spread.spread_tiles_plain(
            tb.build_values_payload(torch.from_numpy(vals), tbinned),
            tbinned.tile_bounds, tgeom, tp, kw=kw)
    else:
        calls = _spy(monkeypatch, pallas_interp, kernel)
        tiles = rng.standard_normal(
            tgeom.tiles + (2,) + tgeom.ext).astype(np.float32)
        want = pallas_interp.interp_pallas_tiled(
            tiles, op.points_resc, op.plan, op.geom, binned=op.binned,
            coords=op.coords, band_info=op.band_info)
        got = dispatch.interp_tiled(torch.from_numpy(tiles), tbinned, tgeom,
                                    tp, kw=kw)
    assert calls, f"{kernel} did not run"
    assert _relerr(got, want) <= RTOL


def test_planned_type1_matches_the_binned_level(monkeypatch):
    """The whole planned type-1: at this size the JAX level runs the
    banded spread with the axis-2 DFT fused into its epilogue
    (``_spread_kernel_split_banded_dfta``), then DFT passes B and C; the
    port runs its planned spread, fold3d and the FFT passes with the
    truncation and deconvolution (plain versions here)."""
    op = binned_level_plan()[0]
    calls = _spy(monkeypatch, pallas_spread,
                 "_spread_kernel_split_banded_dfta")
    top = PlannedNufft(_points(), GRID, transform_type="type_1",
                       device="cpu")
    src = np.random.default_rng(6).standard_normal((1, M, 2)).astype(
        np.float32)
    want = op(src)
    assert calls, "the fused banded spread did not run"
    assert _relerr(top(torch.from_numpy(src)), want) <= RTOL
