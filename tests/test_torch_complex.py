"""The port's complex API against the JAX package.

``tnt.nufft``/``interp``/``spread``/``nudft`` on CPU tensors against
``tfft.nufft``/... on the same numpy-seeded inputs (the JAX complex API
runs its XLA path): complex64 within 1e-5 of the peak, complex128 at tol
1e-12 within 1e-10. Each port call runs on both of its CPU routes, the
kernels' plain versions (``backend='auto'``) and the torch-op XLA path
(``backend='xla'``, the route float64 takes on the card). Also the
points-range check of ``tests/test_points_range.py``.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import tensorflow_nufft_tpu as tfft
import tensorflow_nufft_tpu_torch as tnt
from tests.torch_complex_cases import (
    BACKENDS, M, REAL, RTOL, SPREAD_GRIDS, TOL, case, complex_normal, opts,
    relerr)
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("direction", ["forward", "backward"])
@pytest.mark.parametrize("transform_type", ["type_1", "type_2"])
@pytest.mark.parametrize("rank", [1, 2, 3])
def test_nufft_matches_jax(rank, transform_type, direction, dtype):
    grid, pts, src = case(rank, M, transform_type, dtype, rank)
    kw = dict(grid_shape=grid if transform_type == "type_1" else None,
              transform_type=transform_type, fft_direction=direction,
              tol=TOL[dtype])
    want = np.asarray(jax.jit(functools.partial(tfft.nufft, **kw))(
        src, pts))
    for backend in BACKENDS:
        got = tnt.nufft(src, pts, options=opts(backend), device="cpu",
                        **kw)
        assert got.dtype == torch.from_numpy(src).dtype
        assert relerr(got, want) <= RTOL[dtype], backend


@pytest.mark.parametrize("transform_type", ["type_1", "type_2"])
@pytest.mark.parametrize("rank", [1, 2, 3])
def test_nudft_matches_jax(rank, transform_type):
    grid, pts, src = case(rank, M, transform_type, np.complex128, 7)
    kw = dict(grid_shape=grid if transform_type == "type_1" else None,
              transform_type=transform_type, fft_direction="backward")
    want = np.asarray(jax.jit(functools.partial(tfft.nudft, **kw))(
        src, pts))
    assert relerr(tnt.nudft(src, pts, device="cpu", **kw), want) <= 1e-12


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("op", ["interp", "spread"])
@pytest.mark.parametrize("rank", [1, 2, 3])
def test_spread_interp_match_jax(rank, op, dtype):
    grid = SPREAD_GRIDS[rank]
    rng = np.random.default_rng(10 + rank)
    pts = rng.uniform(-np.pi, np.pi, (M, rank)).astype(REAL[dtype])
    if op == "interp":
        src = complex_normal(rng, grid, dtype)
        want = jax.jit(functools.partial(tfft.interp, tol=TOL[dtype]))(
            src, pts)
        gots = [tnt.interp(src, pts, tol=TOL[dtype], options=opts(b),
                           device="cpu") for b in BACKENDS]
    else:
        src = complex_normal(rng, (M,), dtype)
        want = jax.jit(functools.partial(tfft.spread, grid_shape=grid,
                                         tol=TOL[dtype]))(src, pts)
        gots = [tnt.spread(src, pts, grid, tol=TOL[dtype], options=opts(b),
                           device="cpu") for b in BACKENDS]
    for backend, got in zip(BACKENDS, gots):
        assert relerr(got, want) <= RTOL[dtype], backend


@pytest.mark.parametrize("backend", BACKENDS)
def test_max_batch_size(backend):
    rng = np.random.default_rng(4)
    pts = rng.uniform(-np.pi, np.pi, (10, 2)).astype(np.float32)
    src = complex_normal(rng, (5, 6, 8), np.complex64)
    chunked = tnt.nufft(src, pts, device="cpu",
                        options=opts(backend, max_batch_size=2))
    whole = tnt.nufft(src, pts, device="cpu", options=opts(backend))
    assert torch.equal(chunked, whole)
    want = np.asarray(tfft.nufft(src, pts,
                                 options=tfft.Options(max_batch_size=2)))
    assert relerr(chunked, want) <= RTOL[np.complex64]


def test_conj_and_strided_sources():
    """A conjugate view and a non-contiguous source give the transform of
    their values."""
    rng = np.random.default_rng(5)
    pts = torch.from_numpy(rng.uniform(-np.pi, np.pi, (40, 2)).astype(
        np.float32))
    src = torch.from_numpy(complex_normal(rng, (20, 16), np.complex64))
    assert torch.equal(tnt.nufft(src.conj(), pts),
                       tnt.nufft(src.conj().resolve_conj(), pts))
    assert torch.equal(tnt.nufft(src.t(), pts),
                       tnt.nufft(src.t().contiguous(), pts))
    c = torch.from_numpy(complex_normal(rng, (40,), np.complex64))
    wide = c.expand(3, 40)
    out = tnt.nufft(wide, pts, grid_shape=(16, 16), transform_type="type_1")
    assert torch.equal(out[2], tnt.nufft(c, pts, grid_shape=(16, 16),
                                         transform_type="type_1"))


def test_complex64_is_the_planar_transform():
    """The complex API's complex64 route is the planar core: equal bit for
    bit, both types."""
    rng = np.random.default_rng(6)
    pts = torch.from_numpy(rng.uniform(-np.pi, np.pi, (300, 2)).astype(
        np.float32))
    img = torch.from_numpy(complex_normal(rng, (2, 24, 32), np.complex64))
    got = tnt.nufft(img, pts, fft_direction="backward")
    want = tnt.planar.nufft(torch.view_as_real(img), pts,
                            fft_direction="backward")
    assert torch.equal(torch.view_as_real(got), want)
    c = torch.from_numpy(complex_normal(rng, (300,), np.complex64))
    got = tnt.nufft(c, pts, grid_shape=(24, 32), transform_type="type_1")
    want = tnt.planar.nufft(torch.view_as_real(c), pts, grid_shape=(24, 32),
                            transform_type="type_1")
    assert torch.equal(torch.view_as_real(got), want)


def test_planar_xla_route_matches_plain():
    """The planar API on the XLA-path route (float32 and float64) against
    its plain-version route, gradients included."""
    rng = np.random.default_rng(12)
    for dt, rtol in ((np.float32, 1e-5), (np.float64, 1e-11)):
        pts = rng.uniform(-np.pi, np.pi, (200, 2)).astype(dt)
        img = rng.standard_normal((2, 16, 16, 2)).astype(dt)
        outs = []
        for backend in BACKENDS:
            x = torch.from_numpy(img).requires_grad_()
            k = torch.from_numpy(pts).requires_grad_()
            out = tnt.planar.nufft(x, k, tol=1e-6 if dt == np.float32
                                   else 1e-12, options=opts(backend))
            out.square().sum().backward()
            outs.append((out.detach(), x.grad, k.grad))
        for a, b in zip(*outs):
            assert relerr(a, b.numpy()) <= rtol


class TestPointsRange:
    """tests/test_points_range.py on the port (complex and planar API)."""

    @staticmethod
    def _run(points, options, planar=False):
        rng = np.random.default_rng(7)
        src = complex_normal(rng, (8, 8), np.complex64)
        if planar:
            return tnt.planar.nufft(tnt.planar.to_planar(src).float(),
                                    points, options=options, device="cpu")
        return tnt.nufft(src, points, options=options, device="cpu")

    @staticmethod
    def _checked(pr):
        return tnt.Options(points_range=pr, debugging=tnt.DebuggingOptions(
            check_points_range=True))

    @pytest.mark.parametrize("planar", [False, True])
    @pytest.mark.parametrize("pr,value", [(tnt.PointsRange.STRICT, 2.0),
                                          (tnt.PointsRange.EXTENDED, 4.0)])
    def test_raises_eager(self, pr, value, planar):
        points = np.full((5, 2), value * np.pi, np.float32)
        with pytest.raises(ValueError, match="supported range") as port:
            self._run(points, self._checked(pr), planar)
        with pytest.raises(ValueError) as ref:
            tfft.nufft(complex_normal(np.random.default_rng(7), (8, 8),
                                np.complex64), points,
                       options=tfft.Options(
                           points_range=int(pr),
                           debugging=tfft.DebuggingOptions(
                               check_points_range=True)))
        assert str(port.value) == str(ref.value)

    def test_infinite_never_raises(self):
        points = np.full((5, 2), 100.0, np.float32)
        out = self._run(points, self._checked(tnt.PointsRange.INFINITE))
        assert bool(torch.isfinite(out).all())

    def test_in_range_passes(self):
        points = np.random.default_rng(1).uniform(
            -np.pi, np.pi, (5, 2)).astype(np.float32)
        out = self._run(points, self._checked(tnt.PointsRange.STRICT))
        assert bool(torch.isfinite(out).all())

    @pytest.mark.parametrize("pr,shifts", [
        (tnt.PointsRange.EXTENDED, None),
        (tnt.PointsRange.INFINITE, (2, -2, 10, -10))])
    def test_periodicity_matches_jax(self, pr, shifts):
        base = np.random.default_rng(2).uniform(
            -np.pi * 0.99, np.pi * 0.99, (12, 2)).astype(np.float32)
        if shifts is None:
            moved = [base + (2 * np.pi * np.sign(-base)).astype(np.float32)]
        else:
            moved = [(base + k * np.pi).astype(np.float32) for k in shifts]
        opts = tnt.Options(points_range=pr)
        ref = self._run(base, opts)
        src = complex_normal(np.random.default_rng(7), (8, 8), np.complex64)
        for pts in moved:
            got = self._run(pts.astype(np.float32), opts)
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-3,
                                       atol=2e-3)
            want = np.asarray(tfft.nufft(src, pts, options=tfft.Options(
                points_range=int(pr))))
            assert relerr(got, want) <= RTOL[np.complex64]

    def test_strict_equals_extended_in_range(self):
        base = np.random.default_rng(3).uniform(
            -np.pi * 0.99, np.pi * 0.99, (12, 2)).astype(np.float32)
        a = self._run(base, tnt.Options(points_range=tnt.PointsRange.STRICT))
        b = self._run(base, tnt.Options(
            points_range=tnt.PointsRange.EXTENDED))
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)


