"""The port's rank-3 points prep, spread and interp against the JAX
package, on the identical chunk layout.

Geometry: modes (16, 16, 64) -> fine (32, 32, 128) -> 2 x 2 x 2 tiles of
ext (24, 24, 72), so halos wrap on all three axes; M = 3000 points. The
fold words and ``BinnedPoints`` must be bit-equal; the planned windows,
scattered back, must be JAX's ``build_kernel_matrix_payload`` matrices
to 1e-7 of the peak. The plain spread and interp are held to the Pallas
per-tile-grid kernels in interpret mode (``_spread_kernel_mats`` and
``_spread_kernel``, ``_interp_kernel_mats`` and ``_interp_kernel``; the
single-program resident kernels are switched off for this, since the
small tile array would fit them) to 1e-5 of the peak, for float32
summation order.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_nufft_tpu.kernels import binning as jb
from tensorflow_nufft_tpu.kernels import (pallas_interp, pallas_spread,
                                          xla_ops)
from tensorflow_nufft_tpu.plan import plan as jplan
from tensorflow_nufft_tpu_torch.kernels import binning as tb
from tensorflow_nufft_tpu_torch.kernels import (dispatch, interp, spread,
                                                torch_ops)
from tensorflow_nufft_tpu_torch.plan import plan as tplan
from tests.torch_threads import one_torch_thread  # noqa: F401

GRID = (16, 16, 64)
M = 3000
RTOL = 1e-5
# One compiled binning per geometry instead of op-by-op dispatch.
_jax_bin_points = jax.jit(jb.bin_points, static_argnums=1)


def _points(kind, m, seed):
    rng = np.random.default_rng(seed)
    if kind == "clustered":
        # Two tight clusters: most tiles empty, two tiles overfull.
        centers = np.array([[0.3, -2.0, 1.0], [-1.1, 2.9, -3.0]])
        pts = centers[rng.integers(0, 2, m)] + 0.05 * rng.standard_normal(
            (m, 3))
        return pts.astype(np.float32)
    scale = 3 if kind == "extended" else 1
    return rng.uniform(-scale * np.pi, scale * np.pi, (m, 3)).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def layout(tol):
    """One binned point set, as both packages see it."""
    kw = dict(transform_type="type_1", fft_direction="forward", rank=3,
              grid_shape=GRID, dtype_name="complex64", tol=tol,
              points_range=1)
    jp = jplan.make_plan(jplan.PlanSpec(**kw))
    tp = tplan.make_plan(tplan.PlanSpec(**kw))
    pts = _points("uniform", M, 7)
    pr = xla_ops.fold_and_rescale_split(jnp.asarray(pts), jp.fine_shape, 1)
    jgeom = jb.choose_geometry(jp.fine_shape, jp.width, M)
    jbinned = _jax_bin_points(pr, jgeom)
    mats = jb.build_kernel_matrix_payload(jbinned, jgeom, jp)
    tgeom = tb.choose_geometry(tp.fine_shape, tp.width, M)
    assert tgeom.tiles == (2, 2, 2) and tgeom.ext == (24, 24, 72)
    tbinned = tb.binned_from_numpy(
        *(np.asarray(x) for x in jbinned[:4]),
        [np.asarray(c) for c in jbinned.chunk_tidx],
        np.asarray(jbinned.tile_bounds))
    return dict(jp=jp, tp=tp, pr=pr, jgeom=jgeom, jbinned=jbinned,
                mats=mats, tgeom=tgeom, tbinned=tbinned,
                kw=tb.build_weight_payload(tbinned, tgeom, tp))


@pytest.fixture
def per_tile_grid(monkeypatch):
    """Routes the Pallas calls to the per-tile-grid kernels, the 3D
    path at full size, instead of the resident ones."""
    monkeypatch.setattr(pallas_spread, "resident_fits", lambda *_: False)


def _assert_close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    peak = np.max(np.abs(want))
    assert np.max(np.abs(got - want)) <= rtol * peak


@pytest.mark.parametrize("points_range,kind", [
    (0, "uniform"), (1, "extended"), (2, "uniform")])
def test_fold_split_words_bit_equal_3d(points_range, kind):
    pts = _points(kind, M, 1)
    if points_range == 2:
        pts = pts * 7.0          # far out: exercises the compensated wrap
    fine = (32, 32, 128)
    j_hi, j_lo = xla_ops.fold_and_rescale_split(
        jnp.asarray(pts), fine, points_range)
    t_hi, t_lo = torch_ops.fold_and_rescale_split(
        torch.from_numpy(pts), fine, points_range)
    np.testing.assert_array_equal(t_hi.numpy(), np.asarray(j_hi))
    np.testing.assert_array_equal(t_lo.numpy(), np.asarray(j_lo))


@pytest.mark.parametrize("kind,m", [("uniform", 3000), ("clustered", 2000)])
def test_binned_points_bit_equal_3d(kind, m):
    pts = _points(kind, m, m)
    fine = (32, 32, 128)
    geom_j = jb.choose_geometry(fine, 7, m)
    geom_t = tb.choose_geometry(fine, 7, m)
    pr = xla_ops.fold_and_rescale_split(jnp.asarray(pts), fine, 1)
    bj = _jax_bin_points(pr, geom_j)
    bt = tb.bin_points(tuple(torch.from_numpy(np.array(x)) for x in pr),
                       geom_t)
    for field in ("padpos", "invpos", "tile_bounds"):
        got, want = getattr(bt, field).numpy(), np.asarray(getattr(bj, field))
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=field)
    for d in range(3):
        np.testing.assert_array_equal(bt.chunk_tidx[d].numpy(),
                                      np.asarray(bj.chunk_tidx[d]))
    for a, b in ((bt.points_hi, pr[0]), (bt.points_lo, pr[1])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("tol", (1e-6, 1e-3))
def test_weight_payload_is_the_dense_mats_3d(tol):
    """The planned windows, scattered into dense [sum(E), C] matrices,
    are the JAX package's precomputed kernel matrices."""
    lay = layout(tol)
    geom, kw, mats = lay["tgeom"], lay["kw"], np.asarray(lay["mats"])
    nc, c, w = geom.num_chunks, geom.chunk, lay["tp"].width
    used = int(lay["tbinned"].tile_bounds[-1])
    dense = np.zeros_like(mats)
    off = 0
    for d in range(3):
        starts = kw.starts[d].numpy().reshape(nc, c)[:used]
        weights = kw.weights[d].numpy().reshape(nc, c, w)[:used]
        rows = starts[:, :, None] + np.arange(w)              # [used, c, w]
        k, col, j = np.nonzero((rows >= 0) & (rows < geom.ext[d]))
        dense[k, off + rows[k, col, j], col] = weights[k, col, j]
        off += geom.ext[d]
    peak = np.max(np.abs(mats))
    assert np.max(np.abs(dense[:used] - mats[:used])) <= 1e-7 * peak


@pytest.mark.parametrize("tol,b2,source", [
    (1e-6, 2, "planned"), (1e-6, 2, "unplanned"), (1e-3, 4, "planned"),
    (1e-3, 2, "unplanned")])
def test_spread_plain_matches_pallas_3d(per_tile_grid, tol, b2, source):
    lay = layout(tol)
    vals = np.random.default_rng(b2).standard_normal((b2, M)).astype(
        np.float32)
    want, _ = pallas_spread.spread_pallas_tiles(
        jnp.asarray(vals), lay["pr"], lay["jp"], binned=lay["jbinned"],
        mats=lay["mats"] if source == "planned" else None,
        geom=lay["jgeom"])
    tbinned = lay["tbinned"]
    values_pl = tb.build_values_payload(torch.from_numpy(vals), tbinned)
    weights = dict(kw=lay["kw"]) if source == "planned" else dict(
        coords=tb.build_coords_payload(tbinned))
    got = spread.spread_tiles_plain(values_pl, tbinned.tile_bounds,
                                    lay["tgeom"], lay["tp"], **weights)
    _assert_close(got.numpy(), want)


@pytest.mark.parametrize("tol,b2,source", [
    (1e-6, 2, "planned"), (1e-6, 2, "unplanned"), (1e-3, 4, "planned"),
    (1e-3, 2, "unplanned")])
def test_interp_plain_matches_pallas_3d(per_tile_grid, tol, b2, source):
    lay = layout(tol)
    geom, tbinned = lay["tgeom"], lay["tbinned"]
    tiles = np.random.default_rng(b2).standard_normal(
        geom.tiles + (b2,) + geom.ext).astype(np.float32)
    want = np.asarray(pallas_interp.interp_pallas_tiled(
        jnp.asarray(tiles), lay["pr"], lay["jp"], lay["jgeom"],
        binned=lay["jbinned"],
        mats=lay["mats"] if source == "planned" else None))  # [B2, M]
    got = dispatch.interp_tiled(
        torch.from_numpy(tiles), tbinned, geom, lay["tp"],
        kw=lay["kw"] if source == "planned" else None)      # [B2, M]
    _assert_close(got.numpy(), want)


@pytest.mark.parametrize("source", ("planned", "unplanned"))
def test_dispatch_on_cpu_is_the_plain_version_3d(source):
    lay = layout(1e-6)
    tbinned, geom, tp = lay["tbinned"], lay["tgeom"], lay["tp"]
    vals = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, M)).astype(np.float32))
    kw = lay["kw"] if source == "planned" else None
    counters = (spread.spread_planned_cuda, spread.spread_unplanned_cuda,
                interp.interp_planned_cuda, interp.interp_unplanned_cuda)
    before = [c.launches for c in counters]
    got = dispatch.spread_tiled(vals, tbinned, geom, tp, kw=kw)
    values_pl = tb.build_values_payload(vals, tbinned)
    weights = dict(kw=kw) if kw is not None else dict(
        coords=tb.build_coords_payload(tbinned))
    want = spread.spread_tiles_plain(values_pl, tbinned.tile_bounds, geom,
                                     tp, **weights)
    assert torch.equal(got, want)
    dispatch.interp_tiled(got, tbinned, geom, tp, kw=kw)
    assert [c.launches for c in counters] == before


def test_launch_shapes_at_the_3d_headline():
    """The full-size 3D geometry's launch plans: a spread block owns 6
    axis-0 rows (one warp each, all 24 axis-1 lines) of a tile for a
    channel pair, two blocks per SM; an interp block serves a whole chunk
    (512 slots) for one channel and stages 8-row pieces of [24, 72]
    planes in two buffers, two blocks per SM."""
    geom = tb.choose_geometry((256, 256, 256), 7, 800_000)
    assert (geom.tile, geom.ext, geom.tiles, geom.chunk, geom.num_chunks) \
        == ((16, 16, 64), (24, 24, 72), (16, 16, 4), 512, 2586)
    group, slab, lines, threads, smem = spread.launch_shape(geom, 2, 7)
    assert (group, slab, lines, threads) == (2, 6, 24, 192)
    assert smem == 6 * 4 * (2 * 24 * 72 + 64 * 7) <= spread.HALF_SM
    group, slab, slots, threads, smem = interp.launch_shape(geom, 2)
    assert (group, slab, slots, threads, smem) == (
        1, 8, 512, 512, 2 * 8 * 4 * 24 * 72)
