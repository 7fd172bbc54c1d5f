"""The port's spread (plain version and dispatch) against the JAX Pallas
spread kernels, on the identical chunk layout.

JAX runs ``pallas_spread.spread_pallas_tiles`` in interpret mode on the
CPU: with ``mats`` (``_spread_kernel_resident_mats``) for the planned
weights, and from the coordinate payload (``_spread_kernel_resident``,
or the split variant at 8 channels) for the unplanned ones. Tolerance:
1e-5 of the peak, for float32 summation order.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_nufft_tpu.kernels import binning as jb
from tensorflow_nufft_tpu.kernels import pallas_spread, xla_ops
from tensorflow_nufft_tpu.plan import plan as jplan
from tensorflow_nufft_tpu_torch.kernels import binning as tb
from tensorflow_nufft_tpu_torch.kernels import dispatch, spread
from tensorflow_nufft_tpu_torch.plan import plan as tplan
from tests.torch_threads import one_torch_thread  # noqa: F401

GRID = (64, 96)      # fine 128 x 192: 2 x 3 tiles, halos wrap both axes
M = 2000
RTOL = 1e-5


@functools.lru_cache(maxsize=None)
def layout(tol):
    """One binned point set, as both packages see it."""
    kw = dict(transform_type="type_1", fft_direction="forward", rank=2,
              grid_shape=GRID, dtype_name="complex64", tol=tol,
              points_range=1)
    jp = jplan.make_plan(jplan.PlanSpec(**kw))
    tp = tplan.make_plan(tplan.PlanSpec(**kw))
    pts = np.random.default_rng(7).uniform(
        -np.pi, np.pi, (M, 2)).astype(np.float32)
    pr = xla_ops.fold_and_rescale_split(jnp.asarray(pts), jp.fine_shape, 1)
    jgeom = jb.choose_geometry(jp.fine_shape, jp.width, M)
    jbinned = jb.bin_points(pr, jgeom)
    mats = jb.build_kernel_matrix_payload(jbinned, jgeom, jp)
    tgeom = tb.choose_geometry(tp.fine_shape, tp.width, M)
    tbinned = tb.binned_from_numpy(
        *(np.asarray(x) for x in jbinned[:4]),
        [np.asarray(c) for c in jbinned.chunk_tidx],
        np.asarray(jbinned.tile_bounds))
    return dict(jp=jp, tp=tp, pr=pr, jgeom=jgeom, jbinned=jbinned,
                mats=mats, tgeom=tgeom, tbinned=tbinned,
                kw=tb.build_weight_payload(tbinned, tgeom, tp))


def _assert_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    peak = np.max(np.abs(want))
    assert np.max(np.abs(got - want)) <= RTOL * peak


@pytest.mark.parametrize("tol", (1e-6, 1e-3))
def test_weight_payload_is_the_dense_mats(tol):
    """The planned windows, scattered into dense [E, C] matrices, are the
    JAX package's precomputed kernel matrices."""
    lay = layout(tol)
    geom, kw, mats = lay["tgeom"], lay["kw"], np.asarray(lay["mats"])
    nc, c, w = geom.num_chunks, geom.chunk, lay["tp"].width
    used = int(lay["tbinned"].tile_bounds[-1])
    dense = np.zeros_like(mats)
    off = 0
    for d in range(2):
        e = geom.ext[d]
        starts = kw.starts[d].numpy().reshape(nc, c)
        weights = kw.weights[d].numpy().reshape(nc, c, w)
        for k in range(used):
            for j in range(w):
                rows = starts[k] + j
                ok = (rows >= 0) & (rows < e)
                dense[k, off + rows[ok], np.nonzero(ok)[0]] = \
                    weights[k, ok, j]
        off += e
    peak = np.max(np.abs(mats))
    assert np.max(np.abs(dense[:used] - mats[:used])) <= 1e-7 * peak


@pytest.mark.parametrize("tol,b2,source", [
    (1e-6, 2, "planned"), (1e-6, 2, "unplanned"), (1e-6, 8, "planned"),
    (1e-6, 8, "unplanned"), (1e-3, 2, "planned"), (1e-3, 2, "unplanned")])
def test_spread_plain_matches_pallas(tol, b2, source):
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


@pytest.mark.parametrize("source", ("planned", "unplanned"))
def test_dispatch_on_cpu_is_the_plain_version(source):
    lay = layout(1e-6)
    tbinned, geom, tp = lay["tbinned"], lay["tgeom"], lay["tp"]
    vals = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (4, M)).astype(np.float32))
    kw = lay["kw"] if source == "planned" else None
    before = (spread.spread_planned_cuda.launches,
              spread.spread_unplanned_cuda.launches)
    got = dispatch.spread_tiled(vals, tbinned, geom, tp, kw=kw)
    values_pl = tb.build_values_payload(vals, tbinned)
    weights = dict(kw=kw) if kw is not None else dict(
        coords=tb.build_coords_payload(tbinned))
    want = spread.spread_tiles_plain(values_pl, tbinned.tile_bounds, geom,
                                     tp, **weights)
    assert torch.equal(got, want)
    assert (spread.spread_planned_cuda.launches,
            spread.spread_unplanned_cuda.launches) == before


def test_spread_plain_float64_matches_float32():
    lay = layout(1e-6)
    tbinned, geom, tp = lay["tbinned"], lay["tgeom"], lay["tp"]
    vals = np.random.default_rng(5).standard_normal((2, M))
    coords = tb.build_coords_payload(tbinned)
    out32 = spread.spread_tiles_plain(
        tb.build_values_payload(torch.from_numpy(vals.astype(np.float32)),
                                tbinned), tbinned.tile_bounds, geom, tp,
        coords=coords)
    out64 = spread.spread_tiles_plain(
        tb.build_values_payload(torch.from_numpy(vals), tbinned),
        tbinned.tile_bounds, geom, tp, coords=coords.double())
    assert out64.dtype == torch.float64
    _assert_close(out32.numpy(), out64.numpy())


def test_spread_cuda_wrappers_refuse_cpu_tensors():
    lay = layout(1e-6)
    tbinned, geom, tp = lay["tbinned"], lay["tgeom"], lay["tp"]
    values_pl = torch.zeros(2, geom.num_slots)
    with pytest.raises(ValueError, match="CUDA"):
        spread.spread_planned_cuda(values_pl, tbinned.tile_bounds, geom, tp,
                                   lay["kw"])
