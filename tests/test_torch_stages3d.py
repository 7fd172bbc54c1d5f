"""The port's rank-3 mode stages (plain versions) against the JAX
package's rank-3 stages.

The type-1 post-stage (halo fold, FFT, truncation, deconvolution) is held
to ``pallas_dft.dft_truncate_deconvolve_tiled_pallas`` (``_pass_a/b/c_
kernel``) and the type-2 pre-stage (amplification, padding, FFT, halo
windows) to ``amplify_pad_dft_tiled_pallas`` (``_dual_c/b/a_kernel``),
both in interpret mode on the CPU, which ``pallas_dft.supported`` allows
at this geometry; other directions and batches are held to the ``_xla``
pair-contraction twins, the JAX package's own oracle for those kernels.
Tolerance: 1e-4 of the peak, as the JAX tests hold the Pallas passes to
the XLA formulation (f32 matmul DFT against an FFT).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_nufft_tpu.fft import planar_fft as jfft
from tensorflow_nufft_tpu.kernels import binning as jb
from tensorflow_nufft_tpu.kernels import pallas_dft
from tensorflow_nufft_tpu.plan import plan as jplan
from tensorflow_nufft_tpu_torch.fft import planar_fft as tfft
from tensorflow_nufft_tpu_torch.kernels import binning as tb
from tensorflow_nufft_tpu_torch.kernels import fft3d, mode3d
from tensorflow_nufft_tpu_torch.plan import plan as tplan
from tests.torch_threads import one_torch_thread  # noqa: F401

GRID = (16, 16, 64)
M = 3000
RTOL = 1e-4


@functools.lru_cache(maxsize=None)
def plans(direction):
    kw = dict(transform_type="type_1", fft_direction=direction, rank=3,
              grid_shape=GRID, dtype_name="complex64", tol=1e-6,
              points_range=1)
    jp = jplan.make_plan(jplan.PlanSpec(**kw))
    tp = tplan.make_plan(tplan.PlanSpec(**kw))
    jgeom = jb.choose_geometry(jp.fine_shape, jp.width, M)
    tgeom = tb.choose_geometry(tp.fine_shape, tp.width, M)
    assert tgeom.tiles == (2, 2, 2)
    assert pallas_dft.supported(jgeom, GRID)
    return jp, tp, jgeom, tgeom


def _assert_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    peak = np.max(np.abs(want))
    assert np.max(np.abs(got - want)) <= RTOL * peak


def _tiles(geom, batch, seed):
    return np.random.default_rng(seed).standard_normal(
        geom.tiles + (2 * batch,) + geom.ext).astype(np.float32)


def _modes(batch, seed):
    return np.random.default_rng(seed).standard_normal(
        (batch,) + GRID + (2,)).astype(np.float32)


@pytest.mark.parametrize("direction,batch,reference", [
    ("forward", 1, "pallas"), ("backward", 2, "xla"), ("forward", 2, "xla")])
def test_type1_stage_matches_jax_3d(direction, batch, reference):
    jp, tp, jgeom, tgeom = plans(direction)
    tiles = _tiles(tgeom, batch, batch)
    fn = (pallas_dft.dft_truncate_deconvolve_tiled_pallas
          if reference == "pallas" else jfft.dft_truncate_deconvolve_tiled_xla)
    want = fn(jnp.asarray(tiles), jp, jgeom, batch)
    got = tfft.dft_truncate_deconvolve_tiled(torch.from_numpy(tiles), tp,
                                             tgeom, batch)
    assert got.dtype == torch.float32
    _assert_close(got.numpy(), want)


@pytest.mark.parametrize("direction,batch,reference", [
    ("backward", 1, "pallas"), ("forward", 2, "xla"), ("backward", 2, "xla")])
def test_type2_stage_matches_jax_3d(direction, batch, reference):
    jp, tp, jgeom, tgeom = plans(direction)
    modes = _modes(batch, 10 + batch)
    fn = (pallas_dft.amplify_pad_dft_tiled_pallas
          if reference == "pallas" else jfft.amplify_pad_dft_tiled_xla)
    want = fn(jnp.asarray(modes), jp, jgeom)
    got = tfft.amplify_pad_dft_tiled(torch.from_numpy(modes), tp, tgeom)
    _assert_close(got.numpy(), want)


def test_stages_on_cpu_are_the_plain_versions_3d():
    _, tp, _, tgeom = plans("backward")
    tiles = torch.from_numpy(_tiles(tgeom, 1, 6))
    modes = torch.from_numpy(_modes(1, 7))
    counters = (mode3d.fold3d_cuda, fft3d.fine_to_modes_cuda,
                fft3d.modes_to_fine_cuda, mode3d.extend_tiles3d_cuda,
                fft3d.fft3d_cuda)
    before = [c.launches for c in counters]
    got1 = tfft.dft_truncate_deconvolve_tiled(tiles, tp, tgeom, 1)
    spec = torch.fft.ifftn(mode3d.fold_plain(tiles, tgeom, 1),
                           dim=(1, 2, 3), norm="forward")
    assert torch.equal(got1, mode3d.truncate_deconvolve_plain(spec, tp))
    got2 = tfft.amplify_pad_dft_tiled(modes, tp, tgeom)
    fine = torch.fft.ifftn(mode3d.amplify_pad_plain(modes, tp),
                           dim=(1, 2, 3), norm="forward")
    assert torch.equal(got2, mode3d.extend_plain(fine, tgeom))
    assert [c.launches for c in counters] == before


def test_plain_stages_float64_match_float32():
    _, tp, _, tgeom = plans("forward")
    tiles = _tiles(tgeom, 1, 8)
    out32 = tfft.dft_truncate_deconvolve_tiled(torch.from_numpy(tiles), tp,
                                               tgeom, 1)
    out64 = tfft.dft_truncate_deconvolve_tiled(
        torch.from_numpy(tiles.astype(np.float64)), tp, tgeom, 1)
    assert out64.dtype == torch.float64
    _assert_close(out32.numpy(), out64.numpy())


def test_mode3d_cuda_wrappers_refuse_cpu_tensors():
    _, tp, _, tgeom = plans("forward")
    with pytest.raises(ValueError, match="CUDA"):
        mode3d.fold3d_cuda(torch.from_numpy(_tiles(tgeom, 1, 9)), tgeom, 1)
    with pytest.raises(ValueError, match="CUDA"):
        fft3d.modes_to_fine_cuda(torch.from_numpy(_modes(1, 9)), tp)


# Halo geometries (grid, banded, tile_pref, tiles): the binned level's
# banded tiles, one and two on axis 0, and one tile on every axis (each
# halo is the tile's own other edge).
HALO_CASES = [((64, 16, 16), True, 0, (1, 2, 1)),
              ((128, 16, 16), True, 0, (2, 2, 1)),
              ((16, 16, 16), False, 32, (1, 1, 1))]


@pytest.mark.parametrize("grid,banded,tile_pref,tiles", HALO_CASES)
@pytest.mark.parametrize("batch", (1, 3))
def test_halo_plain_versions_match_jax(grid, banded, tile_pref, tiles,
                                       batch):
    """extend_plain and fold_plain (the yardsticks of the halo kernels)
    against the JAX package's extend_tiles and overlap_add on the same
    channels (2b the real part, 2b + 1 the imaginary): equal, as a copy
    and the same per-axis additions in the same order are."""
    kw = dict(transform_type="type_1", fft_direction="forward", rank=3,
              grid_shape=grid, dtype_name="complex64", tol=1e-6,
              points_range=1)
    jp, tp = jplan.make_plan(jplan.PlanSpec(**kw)), tplan.make_plan(
        tplan.PlanSpec(**kw))
    geoms = [mod.choose_geometry(p.fine_shape, p.width, M,
                                 tile_pref=tile_pref, banded=banded)
             for mod, p in ((tb, tp), (jb, jp))]
    tgeom, jgeom = geoms
    assert tgeom.tiles == tiles and jgeom.tiles == tiles
    rng = np.random.default_rng(20 + batch)
    planes = rng.standard_normal((batch, 2) + tgeom.fine_shape).astype(
        np.float32)
    fine = torch.complex(*torch.from_numpy(planes).unbind(1))
    np.testing.assert_array_equal(
        mode3d.extend_plain(fine, tgeom).numpy(),
        np.asarray(jb.extend_tiles(jnp.asarray(planes.reshape(
            (2 * batch,) + tgeom.fine_shape)), jgeom)))
    blocks = _tiles(tgeom, batch, 30 + batch)
    want = np.asarray(jb.overlap_add(jnp.asarray(blocks), jgeom)).reshape(
        (batch, 2) + tgeom.fine_shape)
    got = mode3d.fold_plain(torch.from_numpy(blocks), tgeom, batch)
    np.testing.assert_array_equal(got.real.numpy(), want[:, 0])
    np.testing.assert_array_equal(got.imag.numpy(), want[:, 1])
