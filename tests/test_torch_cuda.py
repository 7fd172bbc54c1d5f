"""Tests of the hand-written CUDA kernels; they need an NVIDIA GPU.

They skip where torch sees no CUDA device (the kernels have no CPU or
interpret mode; the CPU tests hold the plain versions to the JAX
package). This file imports no jax, so it also runs on a GPU machine
without it:

    python -m pytest --noconftest -o markers=cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

import tensorflow_nufft_tpu_torch as tnt
from tensorflow_nufft_tpu_torch.fft import planar_fft
from tensorflow_nufft_tpu_torch.fft.planar_fft import dfta_twiddles
from tensorflow_nufft_tpu_torch.kernels import (
    binning, fft3d, interp, mode3d, spread)
from tensorflow_nufft_tpu_torch.ops.planar_core import bin_for_plan
from tensorflow_nufft_tpu_torch.plan.plan import (
    PlanSpec, fit_horner_coeffs, make_plan)

pytestmark = pytest.mark.cuda
RTOL = 1e-5
# (grid, points, tol, kernel evaluation, clustered points): both Horner
# widths, the in-kernel exp/sqrt branch, mostly-empty tiles, headline.
CASES = [
    ((64, 96), 2000, 1e-6, "auto", False),
    ((64, 96), 2000, 1e-3, "auto", False),
    ((64, 96), 2000, 1e-6, "direct", False),
    ((64, 96), 2000, 1e-6, "auto", True),
    ((256, 256), 65536, 1e-6, "auto", False),
]
# Rank 3: 2 x 2 x 2 tiles (every halo wraps) at both Horner widths and
# the exp/sqrt branch, clustered points, and 4 x 4 x 2 tiles.
CASES_3D = [
    ((16, 16, 64), 3000, 1e-6, "auto", False),
    ((16, 16, 64), 3000, 1e-3, "auto", False),
    ((16, 16, 64), 3000, 1e-6, "direct", False),
    ((16, 16, 64), 3000, 1e-6, "auto", True),
    ((32, 32, 64), 20000, 1e-6, "auto", False),
]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _layout(grid, m, tol, dev, seed=0, kev="auto", clustered=False):
    rank = len(grid)
    plan = make_plan(PlanSpec("type_1", "forward", rank, grid, "complex64",
                              tol, 1, kernel_evaluation_method=kev))
    rng = np.random.default_rng(seed)
    if clustered:
        # Two tight clusters: most tiles own one chunk of padded slots.
        centers = np.array([[0.3, -2.0, 1.0], [-1.1, 2.9, -3.0]])[:, :rank]
        pts = centers[rng.integers(0, 2, m)]
        pts = (pts + 0.05 * rng.standard_normal((m, rank))).astype(
            np.float32)
    else:
        pts = rng.uniform(-np.pi, np.pi, (m, rank)).astype(np.float32)
    geom, binned = bin_for_plan(torch.from_numpy(pts).to(dev), plan)
    kw = binning.build_weight_payload(binned, geom, plan)
    return plan, geom, binned, kw, binning.build_coords_payload(binned)


def _close(got, want):
    assert got.shape == want.shape
    peak = float(want.abs().max())
    assert float((got - want).abs().max()) <= RTOL * peak


@pytest.mark.parametrize("grid,m,tol,kev,clustered", CASES + CASES_3D)
@pytest.mark.parametrize("b2", (2, 8))
@pytest.mark.parametrize("source", ("planned", "unplanned"))
def test_spread_kernel_matches_plain(dev, grid, m, tol, kev, clustered,
                                    b2, source):
    plan, geom, binned, kw, coords = _layout(grid, m, tol, dev, kev=kev,
                                             clustered=clustered)
    vals = torch.from_numpy(np.random.default_rng(b2).standard_normal(
        (b2, m)).astype(np.float32)).to(dev)
    values_pl = binning.build_values_payload(vals, binned)
    tb = binned.tile_bounds
    if source == "planned":
        got = spread.spread_planned_cuda(values_pl, tb, geom, plan, kw)
        want = spread.spread_tiles_plain(values_pl, tb, geom, plan, kw=kw)
    else:
        got = spread.spread_unplanned_cuda(values_pl, tb, geom, plan,
                                           coords)
        want = spread.spread_tiles_plain(values_pl, tb, geom, plan,
                                         coords=coords)
    _close(got, want)


@pytest.mark.parametrize("grid,m,tol,kev,clustered", CASES + CASES_3D)
@pytest.mark.parametrize("b2", (2, 8))
@pytest.mark.parametrize("source", ("planned", "unplanned"))
def test_interp_kernel_matches_plain(dev, grid, m, tol, kev, clustered,
                                    b2, source):
    plan, geom, binned, kw, coords = _layout(grid, m, tol, dev, kev=kev,
                                             clustered=clustered)
    tiles = torch.from_numpy(np.random.default_rng(b2).standard_normal(
        geom.tiles + (b2,) + geom.ext).astype(np.float32)).to(dev)
    tb = binned.tile_bounds
    if source == "planned":
        got = interp.interp_planned_cuda(tiles, tb, geom, plan, kw)
        want = interp.interp_tiles_plain(tiles, tb, geom, plan, kw=kw)
    else:
        got = interp.interp_unplanned_cuda(tiles, tb, geom, plan, coords)
        want = interp.interp_tiles_plain(tiles, tb, geom, plan,
                                         coords=coords)
    _close(got, want)


@pytest.mark.parametrize("grid,m,tol,kev,clustered",
                         [CASES[0], CASES[1], CASES[4], CASES_3D[0],
                          CASES_3D[4]])
def test_interp_deriv_kernel_matches_plain(dev, grid, m, tol, kev,
                                           clustered):
    """phi' on each axis (direct evaluation; phi by Horner elsewhere)."""
    plan, geom, binned, _, coords = _layout(grid, m, tol, dev, kev=kev,
                                            clustered=clustered)
    tiles = torch.from_numpy(np.random.default_rng(3).standard_normal(
        geom.tiles + (2,) + geom.ext).astype(np.float32)).to(dev)
    tb = binned.tile_bounds
    for axis in range(len(grid)):
        before = interp.interp_deriv_cuda.launches
        got = interp.interp_deriv_cuda(tiles, tb, geom, plan, coords, axis)
        assert interp.interp_deriv_cuda.launches == before + 1
        _close(got, interp.interp_tiles_plain(tiles, tb, geom, plan,
                                              coords=coords,
                                              deriv_axis=axis))


@pytest.mark.parametrize("grid,m,b2", [
    ((64, 96), 2000, 12), ((256, 256), 65536, 16), ((256, 256), 65536, 32),
    ((16, 16, 64), 3000, 4), ((32, 32, 64), 20000, 6)])
def test_wide_channel_spread_matches_plain(dev, grid, m, b2):
    """Channel counts past one block's group (a channel pair): the
    groups go to blockIdx.y, and the last one is partial at odd B2."""
    plan, geom, binned, _, coords = _layout(grid, m, 1e-6, dev)
    group = spread.launch_shape(geom, b2, plan.width)[0]
    assert group < b2
    vals = torch.from_numpy(np.random.default_rng(b2).standard_normal(
        (b2, m)).astype(np.float32)).to(dev)
    values_pl = binning.build_values_payload(vals, binned)
    tb = binned.tile_bounds
    _close(spread.spread_unplanned_cuda(values_pl, tb, geom, plan, coords),
           spread.spread_tiles_plain(values_pl, tb, geom, plan,
                                     coords=coords))


@pytest.mark.parametrize("grid,transform_type", [
    ((64, 96), "type_1"), ((64, 96), "type_2"), ((16, 16, 64), "type_1"),
    ((16, 16, 64), "type_2")])
def test_nufft_grads_on_cuda_match_cpu(dev, grid, transform_type):
    m, batch = 3000, 3
    rng = np.random.default_rng(7)
    pts = rng.uniform(-np.pi, np.pi, (m, len(grid))).astype(np.float32)
    shape = (batch,) + ((m,) if transform_type == "type_1" else grid) + (2,)
    src = rng.standard_normal(shape).astype(np.float32)
    kw = dict(grid_shape=grid if transform_type == "type_1" else None,
              transform_type=transform_type, fft_direction="backward")
    grads = []
    for device in ("cpu", dev):
        s = torch.from_numpy(src).to(device).requires_grad_()
        p = torch.from_numpy(pts).to(device).requires_grad_()
        out = tnt.planar.nufft(s, p, **kw)
        out.backward(torch.ones_like(out))
        grads.append((out.detach().cpu(), s.grad.cpu(), p.grad.cpu()))
    for want, got in zip(*grads):
        _close(got, want)


@pytest.mark.parametrize("grid", [(64, 96), (32, 32, 64)])
def test_spread_only_ops_on_cuda_match_cpu(dev, grid):
    m = 3000
    rng = np.random.default_rng(8)
    pts = torch.from_numpy(rng.uniform(-np.pi, np.pi, (m, len(grid))).astype(
        np.float32))
    src = torch.from_numpy(rng.standard_normal((2, m, 2)).astype(np.float32))
    results = []
    for device in ("cpu", dev):
        s = src.to(device, copy=True).requires_grad_()
        p = pts.to(device, copy=True).requires_grad_()
        before = interp.interp_deriv_cuda.launches
        fine = tnt.planar.spread(s, p, grid)
        back = tnt.planar.interp(fine, p)
        back.square().sum().backward()
        launched = interp.interp_deriv_cuda.launches - before
        assert launched == (2 * len(grid) if device == dev else 0)
        results.append((fine.detach().cpu(), back.detach().cpu(),
                        s.grad.cpu(), p.grad.cpu()))
    for want, got in zip(*results):
        _close(got, want)


@pytest.mark.parametrize("grid,m", [((256, 256), 65536),
                                    ((32, 32, 64), 20000)])
def test_spread_kernel_is_deterministic(dev, grid, m):
    plan, geom, binned, kw, coords = _layout(grid, m, 1e-6, dev)
    vals = torch.randn(2, m, device=dev)
    values_pl = binning.build_values_payload(vals, binned)
    tb = binned.tile_bounds
    first = spread.spread_planned_cuda(values_pl, tb, geom, plan, kw)
    first_u = spread.spread_unplanned_cuda(values_pl, tb, geom, plan, coords)
    for _ in range(3):
        assert torch.equal(
            first, spread.spread_planned_cuda(values_pl, tb, geom, plan, kw))
        assert torch.equal(first_u, spread.spread_unplanned_cuda(
            values_pl, tb, geom, plan, coords))


# Extended tiles larger than one thread block's shared memory (and the
# geometries of width 8 and 10): (grid, points, tol). 150^2: one tile of
# ext (308, 308); 50^3: one tile of (108, 108, 108); 192^3 (width 10)
# and 128^3 at 1e-7 (width 8): ext (32, 32, 64) and (32, 32, 80); 90^3:
# ext (188, 188, 188), whose [188, 188] planes split into line ranges for
# the spread and are read in place by the interp; (64, 96) at 1e-9:
# width 9, the rank-2 interp's wide instantiation.
LARGE_CASES = [
    ((150, 150), 20000, 1e-6), ((50, 50, 50), 20000, 1e-6),
    ((192, 192, 192), 100000, 1e-6), ((128, 128, 128), 100000, 1e-7),
    ((90, 90, 90), 5000, 1e-6), ((64, 96), 2000, 1e-9)]


@pytest.mark.parametrize("grid,m,tol", LARGE_CASES)
@pytest.mark.parametrize("b2", (2, 6))
@pytest.mark.parametrize("source", ("planned", "unplanned"))
def test_large_tile_kernels_match_plain(dev, grid, m, tol, b2, source):
    plan, geom, binned, kw, coords = _layout(grid, m, tol, dev)
    rng = np.random.default_rng(b2)
    values_pl = binning.build_values_payload(torch.from_numpy(
        rng.standard_normal((b2, m)).astype(np.float32)).to(dev), binned)
    tiles = torch.from_numpy(rng.standard_normal(
        geom.tiles + (b2,) + geom.ext).astype(np.float32)).to(dev)
    tb = binned.tile_bounds
    weights = dict(kw=kw) if source == "planned" else dict(coords=coords)
    arg = kw if source == "planned" else coords
    sp = (spread.spread_planned_cuda if source == "planned"
          else spread.spread_unplanned_cuda)
    ip = (interp.interp_planned_cuda if source == "planned"
          else interp.interp_unplanned_cuda)
    before = (sp.launches, ip.launches)
    _close(sp(values_pl, tb, geom, plan, arg),
           spread.spread_tiles_plain(values_pl, tb, geom, plan, **weights))
    _close(ip(tiles, tb, geom, plan, arg),
           interp.interp_tiles_plain(tiles, tb, geom, plan, **weights))
    assert (sp.launches, ip.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("grid,m,tol", [LARGE_CASES[0], LARGE_CASES[2],
                                        LARGE_CASES[4]])
def test_large_tile_interp_deriv_matches_plain(dev, grid, m, tol):
    plan, geom, binned, _, coords = _layout(grid, m, tol, dev)
    tiles = torch.from_numpy(np.random.default_rng(3).standard_normal(
        geom.tiles + (2,) + geom.ext).astype(np.float32)).to(dev)
    tb = binned.tile_bounds
    axis = len(grid) - 1
    _close(interp.interp_deriv_cuda(tiles, tb, geom, plan, coords, axis),
           interp.interp_tiles_plain(tiles, tb, geom, plan, coords=coords,
                                     deriv_axis=axis))


@pytest.mark.parametrize("grid", [(150, 150), (50, 50, 50)])
@pytest.mark.parametrize("transform_type", ("type_1", "type_2"))
def test_large_tile_nufft_on_cuda_matches_cpu(dev, grid, transform_type):
    m = 5000
    rng = np.random.default_rng(11)
    pts = torch.from_numpy(rng.uniform(-np.pi, np.pi, (m, len(grid))).astype(
        np.float32))
    shape = (1, m, 2) if transform_type == "type_1" else (1,) + grid + (2,)
    src = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    kw = dict(grid_shape=grid if transform_type == "type_1" else None,
              transform_type=transform_type)
    want = tnt.planar.nufft(src, pts, **kw)
    counter = (spread.spread_unplanned_cuda if transform_type == "type_1"
               else interp.interp_unplanned_cuda)
    before = counter.launches
    got = tnt.planar.nufft(src.to(dev), pts.to(dev), **kw)
    assert counter.launches == before + 1
    _close(got.cpu(), want)


@pytest.mark.parametrize("grid,m", [((150, 150), 20000),
                                    ((90, 90, 90), 5000)])
def test_large_tile_kernels_are_deterministic(dev, grid, m):
    plan, geom, binned, _, coords = _layout(grid, m, 1e-6, dev)
    values_pl = binning.build_values_payload(
        torch.randn(2, m, device=dev), binned)
    tiles = torch.randn(geom.tiles + (2,) + geom.ext, device=dev)
    tb = binned.tile_bounds
    args = (tb, geom, plan, coords)
    first = (spread.spread_unplanned_cuda(values_pl, *args),
             interp.interp_unplanned_cuda(tiles, *args))
    for _ in range(2):
        assert torch.equal(first[0],
                           spread.spread_unplanned_cuda(values_pl, *args))
        assert torch.equal(first[1], interp.interp_unplanned_cuda(tiles,
                                                                  *args))


# Mode-stage geometries: (grid, direction, banded, tile_pref): 2 x 2 x 2
# and 4 x 4 x 2 tiles; the binned level's banded tiles, 1 x 2 x 1 of ext
# (136, 24, 40) and 2 x 2 x 1; one tile on every axis (each halo is the
# tile's own other edge); 3 x 1 x 1 tiles of ext (16, 28, 38), whose
# axis 2 is no multiple of 4 (the halo kernels' one-cell lanes).
MODE3D_CASES = [
    ((16, 16, 64), "forward", False, 0),
    ((32, 32, 64), "backward", False, 0),
    ((64, 16, 16), "forward", True, 0),
    ((128, 16, 16), "backward", True, 0),
    ((16, 16, 16), "forward", False, 32),
    ((12, 10, 14), "backward", False, 0),
]


def _unaligned(t):
    """A contiguous copy of ``t`` whose data is not 16-byte aligned (the
    halo kernels then take one cell a lane)."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    return out.view(t.shape).copy_(t)


@pytest.mark.parametrize("grid,direction,banded,tile_pref", MODE3D_CASES)
@pytest.mark.parametrize("batch", (1, 2, 3))
def test_mode3d_kernels_match_plain(dev, grid, direction, banded, tile_pref,
                                    batch):
    plan = make_plan(PlanSpec("type_1", direction, 3, grid, "complex64",
                              1e-6, 1))
    geom = binning.choose_geometry(plan.fine_shape, plan.width, 3000,
                                   tile_pref=tile_pref, banded=banded)
    rng = np.random.default_rng(batch)
    tiles = torch.from_numpy(rng.standard_normal(
        geom.tiles + (2 * batch,) + geom.ext).astype(np.float32)).to(dev)
    fine = mode3d.fold3d_cuda(tiles, geom, batch)
    want = mode3d.fold_plain(tiles, geom, batch)
    _close(torch.view_as_real(fine), torch.view_as_real(want))
    assert torch.equal(fine, mode3d.fold3d_cuda(tiles, geom, batch))
    assert torch.equal(fine, mode3d.fold3d_cuda(_unaligned(tiles), geom,
                                                batch))
    spec = fft3d.fft_plain(want, (1, 2, 3), direction)
    _close(fft3d.fine_to_modes_cuda(want, plan),
           mode3d.truncate_deconvolve_plain(spec, plan))
    modes = torch.from_numpy(rng.standard_normal(
        (batch,) + grid + (2,)).astype(np.float32)).to(dev)
    got = fft3d.modes_to_fine_cuda(modes, plan)
    _close(torch.view_as_real(got), torch.view_as_real(fft3d.fft_plain(
        mode3d.amplify_pad_plain(modes, plan), (1, 2, 3), direction)))
    ext = mode3d.extend_tiles3d_cuda(spec, geom)
    assert torch.equal(ext, mode3d.extend_plain(spec, geom))
    assert torch.equal(ext, mode3d.extend_tiles3d_cuda(spec, geom))
    assert torch.equal(ext, mode3d.extend_tiles3d_cuda(_unaligned(spec),
                                                       geom))
    # The fused route's y [nt0, nt1, 2B, E0, E1, n2] (axis 2 untiled).
    y = torch.from_numpy(rng.standard_normal(
        geom.tiles[:2] + (2 * batch,) + geom.ext[:2] + (grid[2],)).astype(
            np.float32)).to(dev)
    fine2 = mode3d.fold2_cuda(y, geom, batch)
    _close(torch.view_as_real(fine2),
           torch.view_as_real(mode3d.fold_plain(y, geom, batch, axes=2)))
    assert torch.equal(fine2, mode3d.fold2_cuda(y, geom, batch))


# (shape, dims): the 3D headline's fine grid, the large-tile cell's
# (radix 5), batch 3 with lines of 2, 3 and 5 factors, and the fused
# route's two-axis transform of [B, nf0, nf1, n2]; then fine grids with
# an axis longer than shared memory (the four-step split, two launches)
# on axes 2, 0 and 1.
FFT_CASES = [((1, 256, 256, 256), (1, 2, 3)),
             ((1, 320, 320, 320), (1, 2, 3)),
             ((3, 90, 36, 50), (1, 2, 3)),
             ((2, 256, 256, 128), (1, 2))]
LONG_FFT_CASES = [(1, 16, 16, 8192), (1, 8192, 16, 16), (1, 32, 6000, 32)]


def _fft_close(got, want, rtol):
    got, want = torch.view_as_real(got), torch.view_as_real(want)
    peak = float(want.abs().max())
    assert float((got - want).abs().max()) <= rtol * peak


@pytest.mark.parametrize("shape,dims", FFT_CASES + [
    (shape, (1, 2, 3)) for shape in LONG_FFT_CASES])
@pytest.mark.parametrize("direction", ("forward", "backward"))
def test_fft3d_kernel_matches_torch_fft(dev, shape, dims, direction):
    gen = torch.Generator(device=dev).manual_seed(sum(shape))
    x = torch.complex(*(torch.randn(shape, generator=gen, device=dev)
                        for _ in range(2)))
    splits = sum(fft3d.split_of(shape[d]) is not None for d in dims)
    before = fft3d.fft3d_cuda.launches
    got = fft3d.fft3d_cuda(x, dims, direction)
    assert fft3d.fft3d_cuda.launches == before + len(dims) + splits
    want = fft3d.fft_plain(x, dims, direction)
    _fft_close(got, want, 2e-6 if splits else RTOL)
    assert torch.equal(got, fft3d.fft3d_cuda(x, dims, direction))


# (modes, tol): the 3D headline (fine 256^3), the large-tile cell (fine
# 320^3, sigma 1.25), and modes whose fine grid has a long axis.
PRUNED_CASES = [((128, 128, 128), 1e-6), ((256, 256, 256), 1e-6),
                ((8, 8, 4096), 1e-6), ((4096, 8, 8), 1e-6)]


@pytest.mark.parametrize("grid,tol", PRUNED_CASES)
@pytest.mark.parametrize("batch", (1, 3))
@pytest.mark.parametrize("direction", ("forward", "backward"))
def test_pruned_stages_match_plain(dev, grid, tol, batch, direction):
    """modes_to_fine and fine_to_modes (three pruned passes each, three
    launches but for a split axis) and the fused route's two-axis
    fine_to_modes against the plain stages with torch.fft."""
    plan = make_plan(PlanSpec("type_1", direction, 3, grid, "complex64",
                              tol, 1))
    fine_shape, n2 = plan.fine_shape, grid[2]
    splits = sum(fft3d.split_of(n) is not None for n in fine_shape)
    gen = torch.Generator(device=dev).manual_seed(batch + sum(grid))
    modes = torch.randn((batch,) + grid + (2,), generator=gen, device=dev)
    before = (fft3d.modes_to_fine_cuda.launches,
              fft3d.fine_to_modes_cuda.launches)
    got = fft3d.modes_to_fine_cuda(modes, plan)
    want = fft3d.fft_plain(mode3d.amplify_pad_plain(modes, plan), (1, 2, 3),
                           direction)
    _fft_close(got, want, 2e-6)
    assert torch.equal(got, fft3d.modes_to_fine_cuda(modes, plan))
    del want
    fine = torch.complex(*(torch.randn((batch,) + fine_shape, generator=gen,
                                       device=dev) for _ in range(2)))
    got = fft3d.fine_to_modes_cuda(fine, plan)
    _close(got, mode3d.truncate_deconvolve_plain(
        fft3d.fft_plain(fine, (1, 2, 3), direction), plan))
    assert torch.equal(got, fft3d.fine_to_modes_cuda(fine, plan))
    assert (fft3d.modes_to_fine_cuda.launches,
            fft3d.fine_to_modes_cuda.launches) == (
                before[0] + 2 * (3 + splits), before[1] + 2 * (3 + splits))
    fine2 = fine[..., :n2].contiguous()
    _close(fft3d.fine_to_modes_cuda(fine2, plan, axes=2),
           mode3d.truncate_deconvolve_plain(
               fft3d.fft_plain(fine2, (1, 2), direction), plan, axes=2))


@pytest.mark.parametrize("grid", [(8, 8, 4096), (4096, 8, 8)])
@pytest.mark.parametrize("transform_type", ("type_1", "type_2"))
def test_long_axis_transforms_match_nudft(dev, grid, transform_type):
    """Planned and unplanned 3D transforms whose fine grid has a long
    axis, against the dense NUDFT at the JAX tests' gate (1e-3), on the
    card end to end with no torch.fft."""
    m = 3000
    rng = np.random.default_rng(8)
    pts = torch.from_numpy(rng.uniform(-np.pi, np.pi, (m, 3)).astype(
        np.float32)).to(dev)
    shape = (1, m, 2) if transform_type == "type_1" else (1,) + grid + (2,)
    src = torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dev)
    kw = dict(grid_shape=grid if transform_type == "type_1" else None,
              transform_type=transform_type)
    oracle = tnt.planar.nudft(src.double(), pts.double(), **kw)
    with _no_torch_fft():
        outs = (tnt.planar.nufft(src, pts, **kw),
                tnt.PlannedNufft(pts, grid, transform_type=transform_type)(
                    src))
    for got in outs:
        err = float((got.double() - oracle).abs().max()
                    / oracle.abs().max())
        assert err <= 1e-3


class _no_torch_fft:
    """Raises if torch.fft transforms a tensor while it is entered."""

    def __enter__(self):
        self.saved = torch.fft.fftn, torch.fft.ifftn

        def refuse(*args, **kwargs):
            raise AssertionError("torch.fft ran on the card path")
        torch.fft.fftn = torch.fft.ifftn = refuse

    def __exit__(self, *exc):
        torch.fft.fftn, torch.fft.ifftn = self.saved


def test_3d_paths_launch_the_pruned_passes_only(dev, monkeypatch):
    """Each 3D transform on the card (unplanned, planned at the binned
    level on the staged and the fused route, and the adjoint) launches
    three FFT passes and its halo kernel, and no torch.fft."""
    grid, m = (32, 32, 64), 20000
    rng = np.random.default_rng(9)
    pts = rng.uniform(-np.pi, np.pi, (m, 3)).astype(np.float32)
    c = torch.from_numpy(rng.standard_normal((1, m, 2)).astype(
        np.float32)).to(dev)
    f = torch.from_numpy(rng.standard_normal((1,) + grid + (2,)).astype(
        np.float32)).to(dev)
    op = _binned_plan(monkeypatch, grid, m, False, dev)
    counters = {"fold3d": mode3d.fold3d_cuda, "fold2": mode3d.fold2_cuda,
                "extend": mode3d.extend_tiles3d_cuda,
                "to_fine": fft3d.modes_to_fine_cuda,
                "to_modes": fft3d.fine_to_modes_cuda,
                "full": fft3d.fft3d_cuda}
    cases = {
        "type-1": (lambda: tnt.planar.nufft(c, torch.from_numpy(pts).to(dev),
                                            grid_shape=grid,
                                            transform_type="type_1"),
                   {"fold3d": 1, "to_modes": 3}),
        "type-2": (lambda: tnt.planar.nufft(f, torch.from_numpy(pts).to(dev),
                                            transform_type="type_2"),
                   {"extend": 1, "to_fine": 3}),
        "planned type-1": (lambda: op(c), {"fold3d": 1, "to_modes": 3}),
        "adjoint": (lambda: op.adjoint()(f), {"extend": 1, "to_fine": 3}),
    }
    for fused in (False, True):
        monkeypatch.setattr(planar_fft, "FUSED_DFTA", fused)
        for name, (fn, want) in cases.items():
            if fused and name != "planned type-1":
                continue
            if fused:
                want = {"fold2": 1, "to_modes": 2}
            before = {k: v.launches for k, v in counters.items()}
            with _no_torch_fft():
                fn()
            got = {k: v.launches - before[k] for k, v in counters.items()}
            assert got == dict(dict.fromkeys(counters, 0), **want), name


@pytest.mark.parametrize("transform_type", ("type_1", "type_2"))
@pytest.mark.parametrize("points_range,scale", [(0, 1.0), (1, 3.0),
                                                 (2, 20.0)])
def test_transform_on_cuda_matches_cpu(dev, transform_type, points_range,
                                       scale):
    grid, m = (64, 96), 3000
    rng = np.random.default_rng(4)
    pts = torch.from_numpy(rng.uniform(-np.pi, np.pi, (m, 2)).astype(
        np.float32) * np.float32(scale))
    shape = (2, m, 2) if transform_type == "type_1" else (2,) + grid + (2,)
    src = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    kw = dict(grid_shape=grid if transform_type == "type_1" else None,
              transform_type=transform_type, fft_direction="backward",
              options=tnt.Options(points_range=points_range))
    want = tnt.planar.nufft(src, pts, **kw)
    counters = (spread.spread_unplanned_cuda, interp.interp_unplanned_cuda)
    before = [c.launches for c in counters]
    got = tnt.planar.nufft(src.to(dev), pts.to(dev), **kw)
    assert got.device.type == "cuda"
    assert sum(c.launches for c in counters) == sum(before) + 1
    _close(got.cpu(), want)
    op = tnt.PlannedNufft(pts, grid, transform_type=transform_type,
                          fft_direction="backward", options=kw["options"],
                          device=dev)
    _close(op(src.to(dev)).cpu(), want)


@pytest.mark.parametrize("transform_type", ("type_1", "type_2"))
def test_transform_3d_on_cuda_matches_cpu_and_nudft(dev, transform_type):
    grid, m = (16, 16, 64), 3000
    rng = np.random.default_rng(5)
    pts = torch.from_numpy(rng.uniform(-np.pi, np.pi, (m, 3)).astype(
        np.float32))
    shape = (2, m, 2) if transform_type == "type_1" else (2,) + grid + (2,)
    src = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    kw = dict(grid_shape=grid if transform_type == "type_1" else None,
              transform_type=transform_type)
    want = tnt.planar.nufft(src, pts, **kw)
    counters = (spread.spread_unplanned_cuda, interp.interp_unplanned_cuda,
                mode3d.fold3d_cuda, mode3d.extend_tiles3d_cuda)
    before = [c.launches for c in counters]
    got = tnt.planar.nufft(src.to(dev), pts.to(dev), **kw)
    assert got.device.type == "cuda"
    assert sum(c.launches for c in counters) == sum(before) + 2
    _close(got.cpu(), want)
    op = tnt.PlannedNufft(pts, grid, transform_type=transform_type,
                          device=dev)
    _close(op(src.to(dev)).cpu(), want)
    oracle = tnt.planar.nudft(src.double().to(dev), pts.double().to(dev),
                              **kw)
    err = float((got.double() - oracle).abs().max() / oracle.abs().max())
    assert err <= 1e-3


def test_numpy_input_runs_on_the_card(dev):
    pts = np.random.default_rng(6).uniform(
        -np.pi, np.pi, (500, 3)).astype(np.float32)
    src = np.ones((500, 2), np.float32)
    out = tnt.planar.nufft(src, pts, grid_shape=(16, 16, 64),
                           transform_type="type_1")
    assert out.device.type == "cuda"
    assert tnt.PlannedNufft(pts, (16, 16, 64)).device.type == "cuda"


_ALL_COUNTERS = (spread.spread_planned_cuda, spread.spread_unplanned_cuda,
                 spread.spread_banded_cuda, spread.spread_dfta_cuda,
                 interp.interp_planned_cuda, interp.interp_unplanned_cuda,
                 interp.interp_deriv_cuda, interp.interp_banded_cuda,
                 mode3d.fold3d_cuda, mode3d.extend_tiles3d_cuda,
                 mode3d.fold2_cuda, fft3d.modes_to_fine_cuda,
                 fft3d.fine_to_modes_cuda)


def test_float64_on_cuda_raises(dev):
    """Float64 CUDA tensors no longer raise: they take the float64 route
    (the XLA-path ops), meet the NUDFT at 10 * tol and launch no kernel,
    through the planar and the complex API, both types, ranks 2 and 3."""
    rng = np.random.default_rng(7)
    for grid in ((32, 32), (8, 12, 16)):
        pts = torch.from_numpy(rng.uniform(-np.pi, np.pi, (300, len(grid)))
                               ).to(dev)
        assert tnt.PlannedNufft(pts, grid).level == "none"
        for transform_type in ("type_1", "type_2"):
            src = torch.from_numpy(rng.standard_normal(
                (300, 2) if transform_type == "type_1" else grid + (2,))
            ).to(dev)
            kw = dict(grid_shape=grid if transform_type == "type_1"
                      else None, transform_type=transform_type)
            before = [c.launches for c in _ALL_COUNTERS]
            got = tnt.planar.nufft(src, pts, tol=1e-9, **kw)
            got_c = tnt.nufft(torch.view_as_complex(src), pts, tol=1e-9,
                              **kw)
            assert [c.launches for c in _ALL_COUNTERS] == before
            assert got.dtype == torch.float64 and got.is_cuda
            oracle = tnt.planar.nudft(src, pts, **kw)
            for out in (got, torch.view_as_real(got_c)):
                err = float((out - oracle).abs().max() / oracle.abs().max())
                assert err <= 1e-8


def test_pallas_backend_on_float64_raises(dev):
    pts = torch.rand(100, 2, dtype=torch.float64, device=dev)
    src = torch.rand(100, 2, dtype=torch.float64, device=dev)
    with pytest.raises(ValueError, match="backend='pallas' requires"):
        tnt.planar.nufft(src, pts, grid_shape=(32, 32),
                         transform_type="type_1",
                         options=tnt.Options(backend="pallas"))


@pytest.mark.parametrize("grid", ((64, 96), (16, 16, 64)))
@pytest.mark.parametrize("direction", ("forward", "backward"))
@pytest.mark.parametrize("transform_type", ("type_1", "type_2"))
def test_complex64_equals_planar_on_cuda(dev, transform_type, direction,
                                         grid):
    """The complex API's complex64 transform is the planar one on the
    card (the same kernels), bit for bit."""
    rng = np.random.default_rng(8)
    m = 3000
    pts = torch.from_numpy(rng.uniform(-np.pi, np.pi, (m, len(grid))).astype(
        np.float32)).to(dev)
    shape = (2, m) if transform_type == "type_1" else (2,) + grid
    src = torch.from_numpy((rng.standard_normal(shape)
                            + 1j * rng.standard_normal(shape)).astype(
                                np.complex64)).to(dev)
    kw = dict(grid_shape=grid if transform_type == "type_1" else None,
              transform_type=transform_type, fft_direction=direction)
    before = interp.interp_unplanned_cuda.launches
    got = tnt.nufft(src, pts, **kw)
    assert interp.interp_unplanned_cuda.launches == before + (
        transform_type == "type_2")
    want = tnt.planar.nufft(torch.view_as_real(src), pts, **kw)
    assert torch.equal(torch.view_as_real(got), want)


# The binned plan level: z-ordered rank-3 binning with an axis-0 band
# (the dense-matrix budget lowered to reach it at small sizes), and the
# degenerate band (every sub-chunk spanning all of E0), which the kernels
# take as well.
BINNED_CASES = [((24, 16, 16), 3000, False), ((24, 16, 16), 4000, True),
                ((32, 32, 64), 20000, False)]


def _binned_plan(monkeypatch, grid, m, clustered, dev,
                 transform_type="type_1", seed=0):
    monkeypatch.setattr(binning, "MATS_BYTES_BUDGET", 0)
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-np.pi, np.pi, (m, 3))
    if clustered:
        pts[:, 0] = np.where(rng.random(m) < 0.5, 0.0, 2.0) \
            + 0.05 * rng.standard_normal(m)
    op = tnt.PlannedNufft(torch.from_numpy(pts.astype(np.float32)), grid,
                          transform_type=transform_type, device=dev)
    assert op.level == "binned" and op.band_info is not None
    return op


def _bands(op):
    """The plan's band, and the degenerate one (band E0 from row 0)."""
    full = binning.BandInfo(op.geom.ext[0],
                            torch.zeros_like(op.band_info.zorigins))
    return (op.band_info, full)


@pytest.mark.parametrize("grid,m,clustered", BINNED_CASES)
@pytest.mark.parametrize("b2", (1, 2, 3, 4))
def test_banded_kernels_match_plain(dev, monkeypatch, grid, m, clustered,
                                    b2):
    """B2 1 and 3 reach a spread block of one channel (alone, and as the
    last group); the degenerate band is wider than a spread slab and an
    interp piece, so a band meets several slabs and is staged in pieces.
    The fused spread takes channel pairs: even B2 only."""
    op = _binned_plan(monkeypatch, grid, m, clustered, dev)
    geom, tb, coords = op.geom, op.binned.tile_bounds, op.coords
    rng = np.random.default_rng(b2)
    values_pl = binning.build_values_payload(torch.from_numpy(
        rng.standard_normal((b2, m)).astype(np.float32)).to(dev), op.binned)
    tiles = torch.from_numpy(rng.standard_normal(
        geom.tiles + (b2,) + geom.ext).astype(np.float32)).to(dev)
    twiddles = dfta_twiddles(op.plan, geom, dev)
    bands = _bands(op)
    assert bands[1].band > max(
        spread.launch_shape(geom, 2, op.plan.width)[1],
        interp.banded_shape(geom)[0])
    fused = b2 % 2 == 0
    for band in bands:
        before = (spread.spread_banded_cuda.launches,
                  interp.interp_banded_cuda.launches,
                  spread.spread_dfta_cuda.launches)
        want = spread.spread_tiles_plain(values_pl, tb, geom, op.plan,
                                         coords=coords, band=band)
        _close(spread.spread_banded_cuda(values_pl, tb, geom, op.plan,
                                         coords, band), want)
        if fused:
            _close(spread.spread_dfta_cuda(values_pl, tb, geom, op.plan,
                                           coords, band, twiddles),
                   spread.dfta_plain(want, twiddles))
        _close(interp.interp_banded_cuda(tiles, tb, geom, op.plan, coords,
                                         band),
               interp.interp_tiles_plain(tiles, tb, geom, op.plan,
                                         coords=coords, band=band))
        assert (spread.spread_banded_cuda.launches,
                interp.interp_banded_cuda.launches,
                spread.spread_dfta_cuda.launches) == (
                    before[0] + 1, before[1] + 1, before[2] + fused)


@pytest.mark.parametrize("batch", (1, 2))
def test_modes2_kernels_match_plain(dev, monkeypatch, batch):
    op = _binned_plan(monkeypatch, (24, 16, 16), 3000, False, dev)
    geom, n2 = op.geom, op.grid_shape[2]
    rng = np.random.default_rng(batch)
    y = torch.from_numpy(rng.standard_normal(
        geom.tiles[:2] + (2 * batch,) + geom.ext[:2] + (n2,)).astype(
            np.float32)).to(dev)
    want = mode3d.fold_plain(y, geom, batch, axes=2)
    _close(torch.view_as_real(mode3d.fold2_cuda(y, geom, batch)),
           torch.view_as_real(want))
    spec = fft3d.fft_plain(want, (1, 2), "forward")
    _close(fft3d.fine_to_modes_cuda(want, op.plan, axes=2),
           mode3d.truncate_deconvolve_plain(spec, op.plan, axes=2))


def test_banded_spread_is_deterministic(dev, monkeypatch):
    op = _binned_plan(monkeypatch, (32, 32, 64), 20000, False, dev)
    values_pl = binning.build_values_payload(
        torch.randn(2, 20000, device=dev), op.binned)
    args = (values_pl, op.binned.tile_bounds, op.geom, op.plan, op.coords,
            op.band_info)
    first = spread.spread_banded_cuda(*args)
    for _ in range(3):
        assert torch.equal(first, spread.spread_banded_cuda(*args))


def test_banded_interp_is_deterministic(dev, monkeypatch):
    op = _binned_plan(monkeypatch, (32, 32, 64), 20000, False, dev)
    tiles = torch.randn(op.geom.tiles + (2,) + op.geom.ext, device=dev)
    args = (tiles, op.binned.tile_bounds, op.geom, op.plan, op.coords,
            op.band_info)
    first = interp.interp_banded_cuda(*args)
    for _ in range(3):
        assert torch.equal(first, interp.interp_banded_cuda(*args))


@pytest.mark.parametrize("grid,m,clustered", BINNED_CASES[:2])
@pytest.mark.parametrize("fused", (False, True))
def test_binned_plan_on_cuda_matches_cpu(dev, monkeypatch, grid, m,
                                         clustered, fused):
    """Every apply of a binned-level plan, on the card and on the CPU (the
    plain versions), on both type-1 routes, and the gradients of the slot
    surface."""
    monkeypatch.setattr(planar_fft, "FUSED_DFTA", fused)
    counter = spread.spread_dfta_cuda if fused else spread.spread_banded_cuda
    before = counter.launches
    ops = {d: _binned_plan(monkeypatch, grid, m, clustered, d, "type_2")
           for d in ("cpu", dev)}
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((2,) + grid + (2,)).astype(
        np.float32))
    c = torch.from_numpy(rng.standard_normal((2, m, 2)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0.5, 1.5, m).astype(np.float32))
    results = []
    for d, op in ops.items():
        xs = x.to(d, copy=True).requires_grad_()
        slots = op.to_slots(c.to(d))
        sw = op.slot_weights(w.to(d))
        outs = [op(xs), op.adjoint()(c.to(d)), op.apply_to_slots(xs),
                op.adjoint().apply_from_slots(slots), op.normal(xs, sw)]
        sum(o.square().sum() for o in (outs[0], outs[2], outs[4])
            ).backward()
        results.append([o.detach().cpu() for o in outs] + [xs.grad.cpu()])
    for want, got in zip(*results):
        _close(got, want)
    assert counter.launches > before
    assert interp.interp_banded_cuda.launches > 0


def test_binned_2d_slot_surface_on_cuda_matches_cpu(dev, monkeypatch):
    """The rank-2 binned level: slot-order values into the unplanned
    spread (the split spread's slot-order input), on the card and on the
    CPU."""
    monkeypatch.setattr(binning, "MATS_BYTES_BUDGET", 0)
    grid, m = (64, 96), 3000
    rng = np.random.default_rng(10)
    pts = torch.from_numpy(rng.uniform(-np.pi, np.pi, (m, 2)).astype(
        np.float32))
    x = torch.from_numpy(rng.standard_normal((2,) + grid + (2,)).astype(
        np.float32))
    c = torch.from_numpy(rng.standard_normal((2, m, 2)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0.5, 1.5, m).astype(np.float32))
    results = []
    for d in ("cpu", dev):
        op = tnt.PlannedNufft(pts, grid, transform_type="type_2", device=d)
        assert op.level == "binned"
        before = spread.spread_unplanned_cuda.launches
        outs = (op.normal(x.to(d), op.slot_weights(w.to(d))),
                op.adjoint().apply_from_slots(op.to_slots(c.to(d))),
                op.apply_to_slots(x.to(d)))
        if d == dev:
            assert spread.spread_unplanned_cuda.launches == before + 2
        results.append([o.cpu() for o in outs])
    for want, got in zip(*results):
        _close(got, want)


# Rank 1: three tiles (every halo wraps) at both Horner widths and the
# exp/sqrt branch, clustered points, the 1D mats-size geometry (128 tiles
# of ext 1032), and one tile of ext 20258 (no tile preference divides
# the fine grid: 20 spread blocks and two interp pieces a tile).
CASES_1D = [
    ((96,), 2000, 1e-6, "auto", False),
    ((96,), 2000, 1e-3, "auto", False),
    ((96,), 2000, 1e-6, "direct", False),
    ((96,), 2000, 1e-6, "auto", True),
    ((65536,), 16384, 1e-6, "auto", False),
    ((10125,), 5000, 1e-6, "auto", False),
]


@pytest.mark.parametrize("grid,m,tol,kev,clustered", CASES_1D)
@pytest.mark.parametrize("b2", (1, 2, 8, 16))
@pytest.mark.parametrize("source", ("planned", "unplanned"))
def test_rank1_kernels_match_plain(dev, grid, m, tol, kev, clustered, b2,
                                   source):
    """The rank-1 spread and interp (and, unplanned, the phi' interp)
    against their plain versions; a second call repeats bit for bit."""
    plan, geom, binned, kw, coords = _layout(grid, m, tol, dev, kev=kev,
                                             clustered=clustered)
    rng = np.random.default_rng(b2)
    values_pl = binning.build_values_payload(torch.from_numpy(
        rng.standard_normal((b2, m)).astype(np.float32)).to(dev), binned)
    tiles = torch.from_numpy(rng.standard_normal(
        geom.tiles + (b2,) + geom.ext).astype(np.float32)).to(dev)
    tb = binned.tile_bounds
    weights = dict(kw=kw) if source == "planned" else dict(coords=coords)
    if source == "planned":
        calls = ((lambda: spread.spread_planned_cuda(values_pl, tb, geom,
                                                     plan, kw),
                  lambda: spread.spread_tiles_plain(values_pl, tb, geom,
                                                    plan, **weights)),
                 (lambda: interp.interp_planned_cuda(tiles, tb, geom, plan,
                                                     kw),
                  lambda: interp.interp_tiles_plain(tiles, tb, geom, plan,
                                                    **weights)))
    else:
        calls = ((lambda: spread.spread_unplanned_cuda(values_pl, tb, geom,
                                                       plan, coords),
                  lambda: spread.spread_tiles_plain(values_pl, tb, geom,
                                                    plan, **weights)),
                 (lambda: interp.interp_unplanned_cuda(tiles, tb, geom,
                                                       plan, coords),
                  lambda: interp.interp_tiles_plain(tiles, tb, geom, plan,
                                                    **weights)),
                 (lambda: interp.interp_deriv_cuda(tiles, tb, geom, plan,
                                                   coords, 0),
                  lambda: interp.interp_tiles_plain(tiles, tb, geom, plan,
                                                    deriv_axis=0,
                                                    **weights)))
    for kernel, plain in calls:
        got = kernel()
        _close(got, plain())
        assert torch.equal(kernel(), got)


@pytest.mark.parametrize("kev", ("horner", "direct"))
@pytest.mark.parametrize("b2", (2, 8))
def test_rank1_kernels_match_plain_at_width_16(dev, kev, b2):
    """The widest window (w = 16: a complex128 plan's width at tol 1e-15,
    with exp/sqrt or a Horner fit of that width, on float32 data): the
    rank-1 spread, interp and phi' interp, unplanned and planned, against
    their plain versions; a second call repeats bit for bit."""
    plan = make_plan(PlanSpec("type_1", "forward", 1, (2000,), "complex128",
                              1e-15, 1))
    if kev == "horner":
        plan = dataclasses.replace(plan, horner=fit_horner_coeffs(
            plan.width, plan.beta, 1e-7))
    assert plan.width == 16 and (plan.horner is None) == (kev == "direct")
    rng = np.random.default_rng(16)
    pts = rng.uniform(-np.pi, np.pi, (6000, 1)).astype(np.float32)
    geom, binned = bin_for_plan(torch.from_numpy(pts).to(dev), plan)
    coords = binning.build_coords_payload(binned)
    kw = binning.build_weight_payload(binned, geom, plan)
    tb = binned.tile_bounds
    values_pl = binning.build_values_payload(torch.from_numpy(
        rng.standard_normal((b2, 6000)).astype(np.float32)).to(dev), binned)
    tiles = torch.from_numpy(rng.standard_normal(
        geom.tiles + (b2,) + geom.ext).astype(np.float32)).to(dev)
    calls = (
        (lambda: spread.spread_unplanned_cuda(values_pl, tb, geom, plan,
                                              coords),
         lambda: spread.spread_tiles_plain(values_pl, tb, geom, plan,
                                           coords=coords)),
        (lambda: spread.spread_planned_cuda(values_pl, tb, geom, plan, kw),
         lambda: spread.spread_tiles_plain(values_pl, tb, geom, plan,
                                           kw=kw)),
        (lambda: interp.interp_unplanned_cuda(tiles, tb, geom, plan, coords),
         lambda: interp.interp_tiles_plain(tiles, tb, geom, plan,
                                           coords=coords)),
        (lambda: interp.interp_planned_cuda(tiles, tb, geom, plan, kw),
         lambda: interp.interp_tiles_plain(tiles, tb, geom, plan, kw=kw)),
        (lambda: interp.interp_deriv_cuda(tiles, tb, geom, plan, coords, 0),
         lambda: interp.interp_tiles_plain(tiles, tb, geom, plan,
                                           coords=coords, deriv_axis=0)))
    for kernel, plain in calls:
        got = kernel()
        _close(got, plain())
        assert torch.equal(kernel(), got)


@pytest.mark.parametrize("units", (None, 5))
@pytest.mark.parametrize("source", ("planned", "unplanned"))
def test_rank1_kernels_repeat_bit_for_bit_at_b2_8(dev, monkeypatch, source,
                                                  units):
    """At B2 = 8 one block serves every channel (the spread from one
    window evaluation a slot, the interp from one window a thread): the
    1D mats-size geometry (128 tiles of ext 1032, 17-warp spread blocks)
    with 200,000 points, held to the plain versions, five calls of each
    kernel equal bit for bit, and each channel equal to the same kernel
    run on that channel alone; with ``units``, interp blocks that take 5
    units of slots in turn (the headline's plan takes 8), crossing tile
    boundaries."""
    if units is not None:
        monkeypatch.setattr(interp, "line_units", lambda geom: units)
    plan, geom, binned, kw, coords = _layout((65536,), 200_000, 1e-6, dev)
    rng = np.random.default_rng(8)
    values_pl = binning.build_values_payload(torch.from_numpy(
        rng.standard_normal((8, 200_000)).astype(np.float32)).to(dev),
        binned)
    tiles = torch.from_numpy(rng.standard_normal(
        geom.tiles + (8,) + geom.ext).astype(np.float32)).to(dev)
    tb = binned.tile_bounds
    weights = dict(kw=kw) if source == "planned" else dict(coords=coords)
    if source == "planned":
        def run_spread(v):
            return spread.spread_planned_cuda(v, tb, geom, plan, kw)

        def run_interp(f):
            return interp.interp_planned_cuda(f, tb, geom, plan, kw)
    else:
        def run_spread(v):
            return spread.spread_unplanned_cuda(v, tb, geom, plan, coords)

        def run_interp(f):
            return interp.interp_unplanned_cuda(f, tb, geom, plan, coords)
    for run, x, axis, plain in (
            (run_spread, values_pl, 0, spread.spread_tiles_plain),
            (run_interp, tiles, 1, interp.interp_tiles_plain)):
        first = run(x)
        _close(first, plain(x, tb, geom, plan, **weights))
        for _ in range(4):
            assert torch.equal(run(x), first)
        for c in range(8):
            one = x.narrow(axis, c, 1).contiguous()
            assert torch.equal(run(one), first.narrow(-2, c, 1))


@pytest.mark.parametrize("transform_type", ("type_1", "type_2"))
@pytest.mark.parametrize("level", ("mats", "binned"))
def test_rank1_nufft_and_plan_on_cuda_match_cpu(dev, monkeypatch,
                                                transform_type, level):
    """planar.nufft, PlannedNufft (at the "mats" and, budget lowered, the
    "binned" level) and its slot surface at rank 1 on the card against
    the same calls on the CPU; the card runs the rank-1 kernels."""
    if level == "binned":
        monkeypatch.setattr(binning, "MATS_BYTES_BUDGET", 0)
    grid, m = (96,), 3000
    rng = np.random.default_rng(11)
    pts = torch.from_numpy(rng.uniform(-np.pi, np.pi, (m, 1)).astype(
        np.float32))
    shape = (2, m, 2) if transform_type == "type_1" else (2,) + grid + (2,)
    src = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((2,) + grid + (2,)).astype(
        np.float32))
    c = torch.from_numpy(rng.standard_normal((2, m, 2)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0.5, 1.5, m).astype(np.float32))
    kw = dict(grid_shape=grid if transform_type == "type_1" else None,
              transform_type=transform_type, fft_direction="backward")
    counters = (spread.spread_planned_cuda, spread.spread_unplanned_cuda,
                interp.interp_planned_cuda, interp.interp_unplanned_cuda)
    results = []
    for d in ("cpu", dev):
        before = [k.launches for k in counters]
        op = tnt.PlannedNufft(pts, grid, transform_type=transform_type,
                              fft_direction="backward", device=d)
        assert op.level == level
        t2 = op if transform_type == "type_2" else op.adjoint()
        outs = (tnt.planar.nufft(src.to(d), pts.to(d), **kw), op(src.to(d)),
                t2.normal(x.to(d), t2.slot_weights(w.to(d))),
                t2.apply_to_slots(x.to(d)),
                t2.adjoint().apply_from_slots(t2.to_slots(c.to(d))))
        launched = [k.launches - b for k, b in zip(counters, before)]
        if d == dev:
            # One kernel for nufft, op and each slot apply, two for
            # normal: the planned ones at "mats", else all unplanned.
            assert sum(launched) == 6
            assert launched[0] + launched[2] == (5 if level == "mats"
                                                 else 0)
        else:
            assert launched == [0, 0, 0, 0]
        results.append([o.cpu() for o in outs])
    for want, got in zip(*results):
        _close(got, want)


def test_rank1_grads_and_spread_only_on_cuda_match_cpu(dev):
    """Source and points gradients of planar.nufft (type-2, batch 4: the
    spread of the source gradient at B2 = 8) and of the spread-only ops
    (the phi' interp) on the card against the CPU."""
    grid, m = (96,), 3000
    rng = np.random.default_rng(12)
    pts = torch.from_numpy(rng.uniform(-np.pi, np.pi, (m, 1)).astype(
        np.float32))
    x = torch.from_numpy(rng.standard_normal((4,) + grid + (2,)).astype(
        np.float32))
    vals = torch.from_numpy(rng.standard_normal((2, m, 2)).astype(
        np.float32))
    results = []
    for d in ("cpu", dev):
        s = x.to(d, copy=True).requires_grad_()
        p = pts.to(d, copy=True).requires_grad_()
        out = tnt.planar.nufft(s, p)
        out.square().sum().backward()
        v = vals.to(d, copy=True).requires_grad_()
        q = pts.to(d, copy=True).requires_grad_()
        before = interp.interp_deriv_cuda.launches
        fine = tnt.planar.spread(v, q, (192,))
        back = tnt.planar.interp(fine, q)
        back.square().sum().backward()
        assert interp.interp_deriv_cuda.launches - before == (
            2 if d == dev else 0)
        results.append([t.detach().cpu() for t in (
            out, s.grad, p.grad, fine, back, v.grad, q.grad)])
    for want, got in zip(*results):
        _close(got, want)


@pytest.mark.parametrize("rank", (1, 2, 3))
def test_type3_on_cuda_matches_cpu(dev, rank):
    """The planar and complex64 type-3 plans on the card against the same
    plans on the CPU (the plain pipeline), with the kernels of both
    stages launched: the outer spread, the fold at rank 3 and the inner
    type-2's interp and mode stage; complex128 launches none."""
    rng = np.random.default_rng(30 + rank)
    m, k = 3000, 2500
    span = 4.0 if rank == 3 else 24.0
    x = torch.from_numpy(rng.uniform(-np.pi, np.pi, (m, rank)).astype(
        np.float32))
    t = torch.from_numpy(rng.uniform(-span, span, (k, rank)).astype(
        np.float32))
    c = torch.from_numpy(rng.standard_normal((2, m, 2)).astype(np.float32))
    counters = (spread.spread_planned_cuda, spread.spread_unplanned_cuda,
                interp.interp_planned_cuda, interp.interp_unplanned_cuda,
                interp.interp_banded_cuda, mode3d.fold3d_cuda,
                mode3d.extend_tiles3d_cuda, fft3d.modes_to_fine_cuda)
    results = []
    for d in ("cpu", dev):
        op = tnt.planar.Type3Plan(x.to(d), t.to(d))
        before = [n.launches for n in counters]
        out = op(c.to(d))
        out_c = tnt.Type3Plan(x.to(d), t.to(d))(
            torch.view_as_complex(c.to(d)))
        launched = [n.launches - b for n, b in zip(counters, before)]
        if d == dev:
            # Outer spread (planned or unplanned), inner interp: once for
            # each plan; at rank 3 also fold3d, extend and three passes.
            assert sum(launched[:2]) == 2 and sum(launched[2:5]) == 2
            assert launched[5:] == ([2, 2, 6] if rank == 3 else [0, 0, 0])
            before = [n.launches for n in counters]
            tnt.Type3Plan(x.to(d).double(), t.to(d).double())(
                torch.view_as_complex(c.to(d).double()))
            assert [n.launches for n in counters] == before
        results.append([out.cpu(), torch.view_as_real(out_c).cpu()])
    for want, got in zip(*results):
        _close(got, want)


@pytest.mark.parametrize("budget", (None, 0))
@pytest.mark.parametrize("transform_type", ("type_1", "type_2"))
def test_batched_on_cuda_equals_loop(dev, monkeypatch, transform_type,
                                     budget):
    """BatchedPlannedNufft on the card equals its per-plan loop bit for
    bit, at the "mats" level and, with the budget at 0, at the rank-2
    "binned" level (coords, the unbanded kernels), and the CPU's output
    within 1e-5."""
    if budget is not None:
        monkeypatch.setattr(binning, "MATS_BYTES_BUDGET", budget)
    grid, s, m = (64, 64), 4, 5000
    rng = np.random.default_rng(40)
    pts = torch.from_numpy(rng.uniform(-np.pi, np.pi, (s, m, 2)).astype(
        np.float32))
    shape = (s, m, 2) if transform_type == "type_1" else (s,) + grid + (2,)
    src = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    results = []
    for d in ("cpu", dev):
        op = tnt.planar.BatchedPlannedNufft(pts.to(d), grid,
                                            transform_type=transform_type)
        assert [sh.level for sh in op._shards] == [
            "mats" if budget is None else "binned"] * s
        got = op(src.to(d))
        for i, sh in enumerate(op._shards):
            assert torch.equal(got[i], sh(src[i][None].to(d))[0])
        results.append(got.cpu())
    _close(results[1], results[0])


def _all_launches():
    wrappers = (spread.spread_planned_cuda, spread.spread_unplanned_cuda,
                spread.spread_banded_cuda, spread.spread_dfta_cuda,
                interp.interp_planned_cuda, interp.interp_unplanned_cuda,
                interp.interp_banded_cuda, interp.interp_deriv_cuda,
                mode3d.fold3d_cuda, mode3d.extend_tiles3d_cuda,
                mode3d.fold2_cuda, fft3d.modes_to_fine_cuda,
                fft3d.fine_to_modes_cuda, fft3d.fft3d_cuda)
    return sum(w.launches for w in wrappers)


@pytest.mark.parametrize("transform_type", ["type_1", "type_2"])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_native_backend_on_cuda_launches_nothing(dev, transform_type,
                                                 dtype):
    """backend='native' on CUDA tensors: the host engine runs, the
    result comes back to the card, no kernel launches; it agrees with
    the same call on CPU tensors (the fold and the FFT run on each
    device) within the JAX package's native-backend gates, 1e-10 of the
    peak in complex128 and 1e-5 in complex64."""
    from tensorflow_nufft_tpu_torch import native
    if not native.available():
        pytest.skip("native engine unavailable (no C++ compiler)")
    rng = np.random.default_rng(3)
    real = torch.float32 if dtype == torch.complex64 else torch.float64
    pts = torch.from_numpy(rng.uniform(-np.pi, np.pi, (500, 2))).to(real)
    shape = (500,) if transform_type == "type_1" else (32, 48)
    src = torch.from_numpy(rng.standard_normal(shape)
                           + 1j * rng.standard_normal(shape)).to(dtype)
    kw = dict(transform_type=transform_type, tol=1e-6,
              options=tnt.Options(backend="native"))
    if transform_type == "type_1":
        kw["grid_shape"] = (32, 48)
    before = _all_launches()
    got = tnt.nufft(src.to(dev), pts.to(dev), **kw)
    torch.cuda.synchronize()
    assert _all_launches() == before
    assert got.is_cuda and got.dtype == dtype
    want = tnt.nufft(src, pts, device="cpu", **kw)
    rtol = 1e-5 if dtype == torch.complex64 else 1e-10
    assert float((got.cpu() - want).abs().max()) <= rtol * float(
        want.abs().max())


def test_kernels_run_under_their_stage_spans(dev):
    """The unplanned 2D and 3D transforms under torch.profiler: every
    hand-written kernel launch sits under its stage's span."""
    import chip_smoke
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(5)
    for grid in ((64, 96), (16, 16, 64)):
        pts = torch.from_numpy(rng.uniform(
            -np.pi, np.pi, (3000, len(grid))).astype(np.float32)).to(dev)
        vals = torch.from_numpy(rng.standard_normal((3000, 2)).astype(
            np.float32)).to(dev)
        modes = torch.from_numpy(rng.standard_normal(grid + (2,)).astype(
            np.float32)).to(dev)
        for call in (lambda: tnt.planar.nufft(vals, pts, grid_shape=grid,
                                              transform_type="type_1"),
                     lambda: tnt.planar.nufft(modes, pts)):
            call()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
            index = chip_smoke.SpanIndex(prof.events())
            seen = 0
            for evt in index.device:
                kernel = next((k for k in chip_smoke.SPAN_STAGES
                               if k in evt.name), None)
                if kernel is not None:
                    seen += 1
                    assert index.span_of(evt) in \
                        chip_smoke.SPAN_STAGES[kernel], evt.name
            assert seen >= 1


def _sharded_case(case, dev, monkeypatch):
    """(sharded call, unsharded call, {wrapper: launches}) of one public
    function of tnt.parallel on a (2, 2) ("data", "points") mesh (or a
    (4,) "grid" mesh) repeating the card, at a small size."""
    from tensorflow_nufft_tpu_torch import parallel
    rng = np.random.default_rng(50)
    grid, m, batch = (32, 48), 2000, 4
    pts = torch.from_numpy(rng.uniform(-np.pi, np.pi, (m, 2)).astype(
        np.float32)).to(dev)
    images = torch.from_numpy(rng.standard_normal((batch,) + grid + (2,))
                              .astype(np.float32)).to(dev)
    vals = torch.from_numpy(rng.standard_normal((batch, m, 2)).astype(
        np.float32)).to(dev)
    mesh = parallel.Mesh(np.array([str(dev)] * 4).reshape(2, 2),
                         ("data", "points"))
    grid_mesh = parallel.Mesh([str(dev)] * 4, ("grid",))
    t1 = dict(grid_shape=grid, transform_type="type_1")
    if case == "nufft_type_2":
        return (lambda: parallel.sharded_nufft(images, pts, mesh),
                lambda: tnt.planar.nufft(images, pts),
                {interp.interp_unplanned_cuda: 4})
    if case == "nufft_type_1":
        return (lambda: parallel.sharded_nufft(vals, pts, mesh, **t1),
                lambda: tnt.planar.nufft(vals, pts, **t1),
                {spread.spread_unplanned_cuda: 4})
    if case == "grid_type_1":
        return (lambda: parallel.sharded_nufft_grid(vals, pts, grid_mesh,
                                                    **t1),
                lambda: tnt.planar.nufft(vals, pts, **t1),
                {spread.spread_unplanned_cuda: 4})
    if case == "grid_type_2":
        return (lambda: parallel.sharded_nufft_grid(images, pts, grid_mesh),
                lambda: tnt.planar.nufft(images, pts),
                {interp.interp_unplanned_cuda: 4})
    if case == "type3":
        t = torch.from_numpy(rng.uniform(-20, 20, (1000, 2)).astype(
            np.float32)).to(dev)
        return (lambda: parallel.sharded_nufft_type3(vals, pts, t, mesh),
                lambda: tnt.planar.Type3Plan(pts, t)(vals),
                {spread.spread_unplanned_cuda: 4,
                 interp.interp_unplanned_cuda: 4})
    if case == "planned_3d_banded":
        monkeypatch.setattr(binning, "MATS_BYTES_BUDGET", 0)
        grid3 = (16, 16, 32)
        p3 = torch.from_numpy(rng.uniform(-np.pi, np.pi, (8000, 3)).astype(
            np.float32)).to(dev)
        src = vals.new_tensor(rng.standard_normal((2, 8000, 2)))
        op = parallel.ShardedPlannedNufft(p3, grid3, mesh,
                                          transform_type="type_1")
        assert op.level == "binned" and op._band is not None
        ref = tnt.planar.PlannedNufft(p3, grid3, transform_type="type_1")
        return (lambda: op(src), lambda: ref(src),
                {spread.spread_banded_cuda: 4, mode3d.fold3d_cuda: 4,
                 fft3d.fine_to_modes_cuda: 12})
    if case == "planned_mixed_devices":
        # Data row 1 runs each points block on the other device: its
        # plans are copies of the shards', every tensor moved there.
        mixed = parallel.Mesh([[str(dev), "cpu"], ["cpu", str(dev)]],
                              ("data", "points"))
        op = parallel.ShardedPlannedNufft(pts, grid, mixed)
        ref = tnt.planar.PlannedNufft(pts, grid)
        for plan in op._plans.values():
            tensors = [v for v in plan.__dict__.values()
                       if isinstance(v, torch.Tensor)]
            for field in plan.__dict__.values():
                if isinstance(field, tuple):
                    tensors += [v for v in field
                                if isinstance(v, torch.Tensor)]
            assert all(t.device == plan.device for t in tensors)
        assert op._plans[(1, 0)].device.type == "cpu"
        y = op(images)
        assert torch.equal(op.from_slots(op.to_slots(y)), y)
        sw, sw_ref = op.slot_weights(pts[:, 0].abs()), ref.slot_weights(
            pts[:, 0].abs())
        adj = op.adjoint()
        # The CUDA blocks, (0, 0) and (1, 1), launch the kernels.
        return (lambda: torch.cat([
                    op(images).flatten(), op.normal(images, sw).flatten(),
                    adj.apply_from_slots(op.apply_to_slots(images))
                    .flatten()]),
                lambda: torch.cat([
                    ref(images).flatten(),
                    ref.normal(images, sw_ref).flatten(),
                    ref.adjoint()(ref(images)).flatten()]),
                {interp.interp_planned_cuda: 6,
                 spread.spread_planned_cuda: 4})
    op = parallel.ShardedPlannedNufft(pts, grid, mesh)
    ref = tnt.planar.PlannedNufft(pts, grid)
    assert op.level == ref.level == "mats"
    if case == "planned_type_2":
        return (lambda: op(images), lambda: ref(images),
                {interp.interp_planned_cuda: 4})
    if case == "planned_type_1":
        return (lambda: op.adjoint()(vals), lambda: ref.adjoint()(vals),
                {spread.spread_planned_cuda: 4})
    if case == "normal":
        sw, sw_ref = op.slot_weights(pts[:, 0].abs()), ref.slot_weights(
            pts[:, 0].abs())
        return (lambda: op.normal(images, sw),
                lambda: ref.normal(images, sw_ref),
                {interp.interp_planned_cuda: 4,
                 spread.spread_planned_cuda: 4})
    # The slot surface: the conversions round-trip bit for bit; the
    # slot-order applies compose to the unsharded normal operator.
    adj = op.adjoint()
    y = op(images)
    assert torch.equal(op.from_slots(op.to_slots(y)), y)
    return (lambda: adj.apply_from_slots(op.apply_to_slots(images)),
            lambda: ref.adjoint()(ref(images)),
            {interp.interp_planned_cuda: 4, spread.spread_planned_cuda: 4})


@pytest.mark.parametrize("case", (
    "nufft_type_2", "nufft_type_1", "grid_type_1", "grid_type_2", "type3",
    "planned_type_2", "planned_type_1", "normal", "slots",
    "planned_3d_banded", "planned_mixed_devices"))
def test_sharded_on_cuda_matches_unsharded(dev, monkeypatch, case):
    """Each public function of tnt.parallel on a mesh of the card four
    times (and the planned one on a mesh mixing the card and the CPU):
    within 1e-5 of the peak of the unsharded port call on the same
    global inputs, every block launching its kernels (the counts are the
    blocks')."""
    sharded, unsharded, want = _sharded_case(case, dev, monkeypatch)
    before = {w: w.launches for w in want}
    got = sharded()
    torch.cuda.synchronize()
    assert {w: w.launches - before[w] for w in want} == want
    assert got.is_cuda
    _close(got, unsharded())


def test_training_step_has_no_blocking_sync(dev):
    """Once warmed up, a 3D type-2 training step (loss, backward to the
    image and the points: three folds and binnings of the same points)
    queues its work without waiting for the card: no host readback and no
    pageable host-to-device copy."""
    grid, m = (32, 32, 32), 4000
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((1,) + grid + (2,)).astype(
        np.float32)).to(dev).requires_grad_()
    k = torch.from_numpy(rng.uniform(-np.pi, np.pi, (m, 3)).astype(
        np.float32)).to(dev).requires_grad_()
    y = torch.from_numpy(rng.standard_normal((1, m, 2)).astype(
        np.float32)).to(dev)

    def step():
        x.grad = k.grad = None
        out = tnt.planar.nufft(x, k)
        loss = 0.5 * (out - y).square().sum()
        loss.backward()
        return loss.detach()

    want = step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got, want)
    assert x.grad is not None and k.grad is not None
