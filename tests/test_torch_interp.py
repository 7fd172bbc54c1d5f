"""The port's interp (plain version and dispatch) against the JAX Pallas
interp kernels, on the identical chunk layout.

JAX runs ``pallas_interp.interp_pallas_tiled`` in interpret mode on the
CPU: with ``mats`` (``_interp_kernel_resident_mats``) for the planned
weights and from the coordinate payload (``_interp_kernel``) for the
unplanned ones, both in slot order (``chunk_order=True``). Tolerance:
1e-5 of the peak, for float32 summation order.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_nufft_tpu.kernels import binning as jb
from tensorflow_nufft_tpu.kernels import pallas_interp, xla_ops
from tensorflow_nufft_tpu.plan import plan as jplan
from tensorflow_nufft_tpu_torch.kernels import binning as tb
from tensorflow_nufft_tpu_torch.kernels import dispatch, interp
from tensorflow_nufft_tpu_torch.plan import plan as tplan
from tests.torch_threads import one_torch_thread  # noqa: F401

GRID = (64, 96)      # fine 128 x 192: 2 x 3 tiles, halos wrap both axes
M = 2000
RTOL = 1e-5


@functools.lru_cache(maxsize=None)
def layout(tol):
    """One binned point set, as both packages see it."""
    kw = dict(transform_type="type_2", fft_direction="forward", rank=2,
              grid_shape=GRID, dtype_name="complex64", tol=tol,
              points_range=1)
    jp = jplan.make_plan(jplan.PlanSpec(**kw))
    tp = tplan.make_plan(tplan.PlanSpec(**kw))
    pts = np.random.default_rng(11).uniform(
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


def _tiles(geom, b2, seed):
    return np.random.default_rng(seed).standard_normal(
        geom.tiles + (b2,) + geom.ext).astype(np.float32)


def _weights(lay, source):
    if source == "planned":
        return dict(kw=lay["kw"])
    return dict(coords=tb.build_coords_payload(lay["tbinned"]))


@pytest.mark.parametrize("tol,b2,source", [
    (1e-6, 2, "planned"), (1e-6, 2, "unplanned"), (1e-6, 8, "planned"),
    (1e-6, 8, "unplanned"), (1e-3, 2, "planned"), (1e-3, 2, "unplanned")])
def test_interp_plain_matches_pallas(tol, b2, source):
    lay = layout(tol)
    geom, tbinned = lay["tgeom"], lay["tbinned"]
    tiles = _tiles(geom, b2, b2)
    want = np.asarray(pallas_interp.interp_pallas_tiled(
        jnp.asarray(tiles), lay["pr"], lay["jp"], lay["jgeom"],
        binned=lay["jbinned"],
        mats=lay["mats"] if source == "planned" else None,
        chunk_order=True))                               # [B2, NC * C]
    got = interp.interp_tiles_plain(
        torch.from_numpy(tiles), tbinned.tile_bounds, geom, lay["tp"],
        **_weights(lay, source))                         # [NC, B2, C]
    assert got.shape == (geom.num_chunks, b2, geom.chunk)
    got = got.transpose(0, 1).reshape(b2, -1).numpy()
    # Slots past the used chunks are unwritten in the TPU layout.
    used = int(tbinned.tile_bounds[-1]) * geom.chunk
    peak = np.max(np.abs(want[:, :used]))
    assert np.max(np.abs(got[:, :used] - want[:, :used])) <= RTOL * peak
    assert not got[:, used:].any()
    # Padded slots inside the used chunks are exactly zero.
    padded = tbinned.invpos.numpy()[:used] == M
    assert not got[:, :used][:, padded].any()


@pytest.mark.parametrize("source", ("planned", "unplanned"))
def test_dispatch_on_cpu_is_the_plain_version(source):
    lay = layout(1e-6)
    geom, tbinned, tp = lay["tgeom"], lay["tbinned"], lay["tp"]
    tiles = torch.from_numpy(_tiles(geom, 4, 1))
    kw = lay["kw"] if source == "planned" else None
    before = (interp.interp_planned_cuda.launches,
              interp.interp_unplanned_cuda.launches)
    got = dispatch.interp_tiled(tiles, tbinned, geom, tp, kw=kw)
    chunk_vals = interp.interp_tiles_plain(tiles, tbinned.tile_bounds, geom,
                                           tp, **_weights(lay, source))
    want = tb.scatter_chunked(chunk_vals.transpose(0, 1).reshape(4, -1),
                              tbinned)
    assert got.shape == (4, M)
    assert torch.equal(got, want)
    assert (interp.interp_planned_cuda.launches,
            interp.interp_unplanned_cuda.launches) == before


def test_interp_point_order_matches_pallas():
    """Point order through scatter_chunked, against the unplanned TPU
    path in point order."""
    lay = layout(1e-6)
    geom, tbinned, tp = lay["tgeom"], lay["tbinned"], lay["tp"]
    tiles = _tiles(geom, 2, 2)
    want = np.asarray(pallas_interp.interp_pallas_tiled(
        jnp.asarray(tiles), lay["pr"], lay["jp"], lay["jgeom"],
        binned=lay["jbinned"]))                          # [B2, M]
    got = dispatch.interp_tiled(torch.from_numpy(tiles), tbinned, geom, tp)
    peak = np.max(np.abs(want))
    assert np.max(np.abs(got.numpy() - want)) <= RTOL * peak


def test_interp_cuda_wrappers_refuse_cpu_tensors():
    lay = layout(1e-6)
    geom, tbinned, tp = lay["tgeom"], lay["tbinned"], lay["tp"]
    tiles = torch.from_numpy(_tiles(geom, 2, 0))
    with pytest.raises(ValueError, match="CUDA"):
        interp.interp_unplanned_cuda(tiles, tbinned.tile_bounds, geom, tp,
                                     tb.build_coords_payload(tbinned))
