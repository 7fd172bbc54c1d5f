"""The port's rank-3 binned plan level against the JAX package's.

With the dense-matrix budget lowered (as ``tests/test_banded.py`` lowers
the JAX package's), both ``PlannedNufft``s take the binned level at a
small 3D size: z-ordered binning on the coarse axis-0 geometry, with an
axis-0 band per sub-chunk. The port's layout, band and origins are
bit-equal to the JAX package's, and on that layout the plain versions of
the port's banded kernels give what the TPU kernels give in interpret
mode, to 1e-5 of the peak (float32 summation order, and the kernel
argument, which the port forms from the fine-grid row where the TPU
kernels' (hi - origin) - zo rounds):

- row 7, ``_spread_kernel_banded`` (combined payload, two channels);
- row 8, ``_spread_kernel_split_banded`` (four channels, and slot-order
  values);
- row 9, ``_spread_kernel_split_banded_dfta``: the fused epilogue's y
  [nt0, nt1, B2, E0, E1, n2] directly, at ``tests/test_pallas_dft.py``'s
  size (grid (24, 16, 16), 3000 points, batch 2);
- row 13, ``_interp_kernel_banded``, in chunk and point order.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tensorflow_nufft_tpu import planar as jplanar
from tensorflow_nufft_tpu.kernels import binning as jb
from tensorflow_nufft_tpu.kernels import pallas_dft, pallas_interp
from tensorflow_nufft_tpu.kernels import pallas_spread
from tensorflow_nufft_tpu.options import Options
from tensorflow_nufft_tpu_torch import PlannedNufft
from tensorflow_nufft_tpu_torch.fft import planar_fft
from tensorflow_nufft_tpu_torch.kernels import binning as tb
from tensorflow_nufft_tpu_torch.kernels import dispatch, spread
from tests.torch_threads import one_torch_thread  # noqa: F401

GRID = (24, 16, 16)
M = 3000
RTOL = 1e-5


def _points(m=M, clustered=False, seed=11):
    rng = np.random.default_rng(seed)
    if not clustered:
        return rng.uniform(-np.pi, np.pi, (m, 3)).astype(np.float32)
    # Two tight axis-0 slabs: varying band origins, as test_banded.py.
    x0 = np.concatenate([rng.normal(0.0, 0.05, (m // 2,)),
                         rng.normal(2.0, 0.05, (m - m // 2,))])
    pts = np.stack([x0] + [rng.uniform(-np.pi, np.pi, (m,))
                           for _ in range(2)], axis=-1).astype(np.float32)
    rng.shuffle(pts, axis=0)
    return pts


def _low_budget(build):
    """Runs ``build`` with both packages' dense-matrix budget at 0."""
    jax_budget, port_budget = (pallas_spread.MATS_BYTES_BUDGET,
                               tb.MATS_BYTES_BUDGET)
    pallas_spread.MATS_BYTES_BUDGET = tb.MATS_BYTES_BUDGET = 0
    try:
        return build()
    finally:
        pallas_spread.MATS_BYTES_BUDGET = jax_budget
        tb.MATS_BYTES_BUDGET = port_budget


@functools.lru_cache(maxsize=None)
def plans(clustered=False):
    """The JAX and port binned-level type-1 plans on the same points."""
    pts = _points(clustered=clustered)
    return _low_budget(lambda: (
        jplanar.PlannedNufft(pts, GRID, transform_type="type_1", tol=1e-6,
                             options=Options(backend="pallas")),
        PlannedNufft(pts, GRID, transform_type="type_1", device="cpu")))


def _relerr(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def _spy(monkeypatch, module, name):
    """Records each trace of the Pallas kernel ``module.name``."""
    calls = []
    kernel = getattr(module, name)

    def traced(*args, **kwargs):
        calls.append(name)
        return kernel(*args, **kwargs)
    monkeypatch.setattr(module, name, traced)
    return calls


@pytest.mark.parametrize("clustered", (False, True))
def test_zorder_layout_and_band_match_jax(clustered):
    jop, top = plans(clustered)
    assert jop._level == top.level == "binned"
    assert jop.band_info is not None and top.band_info is not None
    g = jop.geom
    assert (top.geom.fine_shape, top.geom.tile, top.geom.pad,
            top.geom.chunk, top.geom.num_chunks) == (
        g.fine_shape, g.tile, g.pad, g.chunk, g.num_chunks)
    for name in ("padpos", "invpos", "tile_bounds"):
        np.testing.assert_array_equal(getattr(top.binned, name).numpy(),
                                      np.asarray(getattr(jop.binned, name)))
    for got, want in zip(top.binned.chunk_tidx, jop.binned.chunk_tidx):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert top.band_info.band == jop.band_info[0] < g.ext[0]
    np.testing.assert_array_equal(top.band_info.zorigins.numpy(),
                                  np.asarray(jop.band_info[1]))
    assert tb.sort_cell_size(top.geom) == jb.sort_cell_size(g)
    # The slot surface's layout: the JAX plan's slot count and mask.
    assert top.num_slots == jop.num_slots
    np.testing.assert_array_equal(top.slot_mask.numpy(),
                                  np.asarray(jop.slot_mask))


def test_plan_levels_at_the_3d_headline():
    """Pure formulas, no binning: the unbanded headline geometry's
    matrices exceed the budget (binned level), the 200,000-point size's
    do not (mats), and the banded geometry is the JAX package's."""
    fine, width = (256, 256, 256), 7
    assert tb.MATS_BYTES_BUDGET == pallas_spread.MATS_BYTES_BUDGET
    for m, fits in ((800_000, False), (200_000, True)):
        geom = tb.choose_geometry(fine, width, m)
        jgeom = jb.choose_geometry(fine, width, m)
        assert tb.mats_payload_bytes(geom) == \
            pallas_spread.mats_payload_bytes(jgeom)
        assert tb.mats_supported(geom) == jb.mats_supported(jgeom)
        assert (tb.mats_payload_bytes(geom) <= tb.MATS_BYTES_BUDGET) == fits
    banded = tb.choose_geometry(fine, width, 800_000, banded=True)
    jbanded = jb.choose_geometry(fine, width, 800_000, banded=True)
    assert (banded.tile, banded.chunk, banded.num_chunks) == (
        jbanded.tile, jbanded.chunk, jbanded.num_chunks) == (
        (128, 16, 64), 512, 1690)
    assert banded.ext == (136, 24, 72) and banded.num_slots == 865_280


def test_degenerate_band_replans_on_the_unbanded_geometry():
    """test_banded.py's case: 2000 uniform points on 128^3 modes leave
    every sub-chunk spanning its tile's whole axis-0 range, so the band
    degenerates to E0 and both plans re-plan on the unbanded geometry
    (z-ordered still, with no band there either). The budget is lowered
    as there."""
    pts = np.random.default_rng(3).uniform(
        -np.pi, np.pi, (2000, 3)).astype(np.float32)
    jop, top = _low_budget(lambda: (
        jplanar.PlannedNufft(pts, (128, 128, 128), transform_type="type_1",
                             options=Options(backend="pallas")),
        PlannedNufft(pts, (128, 128, 128), transform_type="type_1",
                     device="cpu")))
    assert jop._level == top.level == "binned"
    assert top.geom.tile == jop.geom.tile == (16, 16, 64)
    assert top.band_info is None and jop.band_info is None
    for name in ("padpos", "invpos", "tile_bounds"):
        np.testing.assert_array_equal(getattr(top.binned, name).numpy(),
                                      np.asarray(getattr(jop.binned, name)))


@pytest.mark.parametrize("case,kernel", [
    ("b2_2", "_spread_kernel_banded"),
    ("b2_4", "_spread_kernel_split_banded"),
    ("slots", "_spread_kernel_split_banded")])
def test_plain_banded_spread_is_the_pallas_kernel(monkeypatch, case, kernel):
    """Rows 7 and 8; the slot-order values enter without a gather."""
    jop, top = plans()
    b2 = 4 if case == "b2_4" else 2
    vals = np.random.default_rng(b2).standard_normal((b2, M)).astype(
        np.float32)
    calls = _spy(monkeypatch, pallas_spread, kernel)
    if case == "slots":
        slots = tb.build_values_payload(torch.from_numpy(vals), top.binned)
        want, _ = pallas_spread.spread_pallas_tiles(
            None, jop.points_resc, jop.plan, binned=jop.binned,
            coords=jop.coords, geom=jop.geom, band_info=jop.band_info,
            values_slots=jnp.asarray(slots.numpy()))
        got = dispatch.spread_tiled(None, top.binned, top.geom, top.plan,
                                    coords=top.coords, band=top.band_info,
                                    values_slots=slots)
    else:
        want, _ = pallas_spread.spread_pallas_tiles(
            vals, jop.points_resc, jop.plan, binned=jop.binned,
            coords=jop.coords, geom=jop.geom, band_info=jop.band_info)
        got = spread.spread_tiles_plain(
            tb.build_values_payload(torch.from_numpy(vals), top.binned),
            top.binned.tile_bounds, top.geom, top.plan, coords=top.coords,
            band=top.band_info)
    assert calls, f"{kernel} did not run"
    assert _relerr(got, want) <= RTOL


@pytest.mark.parametrize("chunk_order", (True, False))
def test_plain_banded_interp_is_the_pallas_kernel(monkeypatch, chunk_order):
    """Row 13, slot-order output and point order."""
    jop, top = plans()
    tiles = np.random.default_rng(5).standard_normal(
        top.geom.tiles + (2,) + top.geom.ext).astype(np.float32)
    calls = _spy(monkeypatch, pallas_interp, "_interp_kernel_banded")
    want = pallas_interp.interp_pallas_tiled(
        tiles, jop.points_resc, jop.plan, jop.geom, binned=jop.binned,
        coords=jop.coords, band_info=jop.band_info, chunk_order=chunk_order)
    got = dispatch.interp_tiled(torch.from_numpy(tiles), top.binned,
                                top.geom, top.plan, coords=top.coords,
                                band=top.band_info, chunk_order=chunk_order)
    assert calls, "_interp_kernel_banded did not run"
    want = np.asarray(want)
    if chunk_order:
        # Chunks past tile_bounds[-1] belong to no tile: the TPU kernel
        # leaves them unwritten (NaN in interpret mode), the port zero.
        used = int(top.binned.tile_bounds[-1]) * top.geom.chunk
        assert not got[:, used:].any()
        got, want = got[:, :used], want[:, :used]
    assert _relerr(got, want) <= RTOL
    # The band only skips rows of zero weight: a band of all E0 rows gives
    # the same values.
    whole = tb.BandInfo(top.geom.ext[0],
                        torch.zeros_like(top.band_info.zorigins))
    full = dispatch.interp_tiled(torch.from_numpy(tiles), top.binned,
                                 top.geom, top.plan, coords=top.coords,
                                 band=whole, chunk_order=chunk_order)
    if chunk_order:
        full = full[:, :got.shape[1]]
    assert torch.equal(got, full)


def test_plain_dfta_is_the_fused_kernel(monkeypatch):
    """Row 9 at test_pallas_dft.py's size (batch 2): the twiddles are
    the JAX package's pass-A triple, and the plain banded spread with
    the plain epilogue gives the fused kernel's y."""
    jop, top = plans()
    batch = 2
    vals = np.random.default_rng(7).standard_normal(
        (2 * batch, M)).astype(np.float32)
    wa = pallas_dft._twiddle_statics(jop.plan.spec, jop.geom,
                                     tuple(jop.plan.grid_shape))[0]
    twiddles = planar_fft.dfta_twiddles(top.plan, top.geom, "cpu")
    np.testing.assert_array_equal(twiddles.numpy(), np.stack(wa))
    calls = _spy(monkeypatch, pallas_spread,
                 "_spread_kernel_split_banded_dfta")
    want, _ = pallas_spread.spread_pallas_tiles(
        vals, jop.points_resc, jop.plan, binned=jop.binned,
        coords=jop.coords, geom=jop.geom, band_info=jop.band_info,
        dft_a=wa + (GRID[2],))
    values_pl = tb.build_values_payload(torch.from_numpy(vals), top.binned)
    got = dispatch.spread_dfta(values_pl, top.binned, top.geom, top.plan,
                               top.coords, top.band_info, twiddles)
    assert calls, "the fused banded spread did not run"
    assert got.shape == want.shape == (
        top.geom.tiles[:2] + (2 * batch,) + top.geom.ext[:2] + (GRID[2],))
    assert _relerr(got, want) <= RTOL


@functools.lru_cache(maxsize=None)
def jax_type1():
    """The JAX binned-level type-1 at batch 2, and whether it took its
    fused route (``_spread_kernel_split_banded_dfta``)."""
    jop = plans()[0]
    src = np.random.default_rng(8).standard_normal((2, M, 2)).astype(
        np.float32)
    kernel = pallas_spread._spread_kernel_split_banded_dfta
    calls = []

    def traced(*args, **kwargs):
        calls.append(1)
        return kernel(*args, **kwargs)
    pallas_spread._spread_kernel_split_banded_dfta = traced
    try:
        return src, np.asarray(jop(src)), bool(calls)
    finally:
        pallas_spread._spread_kernel_split_banded_dfta = kernel


@pytest.mark.parametrize("fused", (True, False))
def test_planned_type1_routes_match_the_binned_level(monkeypatch, fused):
    """The whole planned type-1 at batch 2 on the fused route (y, the
    two-axis fold, FFT and truncation) and on the staged route (banded
    tiles, the three-axis stage), against the JAX binned level (its fused
    route with passes B and C)."""
    top = plans()[1]
    src, want, took_fused = jax_type1()
    assert took_fused, "the JAX plan did not take its fused route"
    monkeypatch.setattr(planar_fft, "FUSED_DFTA", fused)
    assert _relerr(top(torch.from_numpy(src)), want) <= RTOL
