"""The port's planar API end to end against the JAX package.

``tnt.planar.nufft`` and ``tnt.PlannedNufft`` (CPU tensors, so the plain
spread/interp versions) against ``tfft.planar.nufft``/``PlannedNufft``
with ``backend="pallas"`` (the Pallas kernels in interpret mode) on the
same numpy-seeded inputs, to 1e-5 of the peak; and against the dense
oracle ``tfft.planar.nudft`` at the repo's gate, 1e-3.
"""

import numpy as np
import pytest
import torch

import tensorflow_nufft_tpu as tfft
import tensorflow_nufft_tpu_torch as tnt
from tests.torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-5
ORACLE_TOL = 1e-3
PALLAS = tfft.Options(backend="pallas")


def _points(m, seed, batch=()):
    return np.random.default_rng(seed).uniform(
        -np.pi, np.pi, batch + (m, 2)).astype(np.float32)


def _source(transform_type, grid, m, batch, seed):
    shape = batch + ((m,) if transform_type == "type_1" else grid) + (2,)
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _relerr(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.mark.parametrize("grid,tol,direction,transform_type", [
    ((64, 64), 1e-6, "forward", "type_1"),
    ((64, 96), 1e-6, "backward", "type_1"),
    ((64, 96), 1e-3, "forward", "type_1"),
    ((64, 64), 1e-6, "backward", "type_2"),
    ((64, 96), 1e-6, "forward", "type_2"),
    ((64, 96), 1e-3, "backward", "type_2"),
])
def test_nufft_matches_jax_and_oracle(grid, tol, direction,
                                      transform_type):
    m = 2000
    pts = _points(m, 1)
    src = _source(transform_type, grid, m, (), 2)
    kw = dict(grid_shape=grid if transform_type == "type_1" else None,
              transform_type=transform_type, fft_direction=direction,
              tol=tol)
    want = tfft.planar.nufft(src, pts, options=PALLAS, **kw)
    got = tnt.planar.nufft(torch.from_numpy(src), torch.from_numpy(pts),
                           **kw)
    assert got.dtype == torch.float32
    assert _relerr(got, want) <= RTOL
    oracle = tfft.planar.nudft(src.astype(np.float64),
                               pts.astype(np.float64),
                               grid_shape=kw["grid_shape"],
                               transform_type=transform_type,
                               fft_direction=direction)
    # The repo's oracle gate; a tol above it is held to bench.py's 10*tol.
    assert _relerr(got, oracle) <= max(ORACLE_TOL, 10 * tol)


@pytest.mark.parametrize("points_range,scale,kev,transform_type", [
    (0, 1.0, "auto", "type_1"), (2, 20.0, "auto", "type_2"),
    (1, 3.0, "direct", "type_1"), (1, 1.0, "direct", "type_2")])
def test_options_match_jax(points_range, scale, kev, transform_type):
    """Points ranges (far-out points fold) and in-kernel exp/sqrt
    evaluation in place of the Horner fit."""
    grid, m = (64, 64), 1500
    pts = _points(m, 23) * np.float32(scale)
    src = _source(transform_type, grid, m, (), 24)
    kw = dict(grid_shape=grid if transform_type == "type_1" else None,
              transform_type=transform_type)
    want = tfft.planar.nufft(src, pts, options=tfft.Options(
        backend="pallas", points_range=points_range,
        kernel_evaluation_method=kev), **kw)
    got = tnt.planar.nufft(
        torch.from_numpy(src), torch.from_numpy(pts),
        options=tnt.Options(points_range=points_range,
                            kernel_evaluation_method=kev), **kw)
    err = _relerr(got, want)
    if err > RTOL:
        # Name the side that moved: each against the float64 oracle.
        oracle = tfft.planar.nudft(src.astype(np.float64),
                                   pts.astype(np.float64), **kw)
        pytest.fail(
            f"port vs JAX relative error {err:.3e} > {RTOL:g}; against "
            f"the float64 nudft: port {_relerr(got, oracle):.3e}, JAX "
            f"{_relerr(want, oracle):.3e}")


@pytest.mark.parametrize("transform_type,batch", [
    ("type_1", 1), ("type_1", 3), ("type_2", 1), ("type_2", 3)])
def test_planned_matches_jax(transform_type, batch):
    grid, m = (64, 96), 2000
    pts = _points(m, 3)
    src = _source(transform_type, grid, m, (batch,), 4)
    jop = tfft.planar.PlannedNufft(pts, grid, transform_type=transform_type,
                                   options=PALLAS)
    top = tnt.PlannedNufft(pts, grid, transform_type=transform_type,
                           device="cpu")
    assert _relerr(top(torch.from_numpy(src)), jop(src)) <= RTOL
    # The adjoint shares the plan: swapped type and direction.
    adj_src = _source(top.adjoint().transform_type, grid, m, (batch,), 5)
    assert top.adjoint().fft_direction == "backward"
    assert top.adjoint().adjoint() is top
    assert _relerr(top.adjoint()(torch.from_numpy(adj_src)),
                   jop.adjoint()(adj_src)) <= RTOL


@pytest.mark.parametrize("direction", ["forward", "backward"])
@pytest.mark.parametrize("tol", [1e-6, 1e-3])
def test_planned_batch16_matches_plain_reference(direction, tol):
    """2D type-1 of 16 value sets on one set of points (the upstream 2D
    benchmark case's shape, small) against the benchmark's float64
    NUDFT, plain torch, at every mode: within 10 tol of the peak, the
    configuration's guarantee."""
    from benchmark.reference import nudft
    grid, m, batch = (48, 64), 2000, 16
    pts = _points(m, 11)
    src = _source("type_1", grid, m, (batch,), 12)
    op = tnt.PlannedNufft(pts, grid, transform_type="type_1",
                          fft_direction=direction, tol=tol, device="cpu")
    got = tnt.planar.from_planar(op(torch.from_numpy(src)).double())
    values = tnt.planar.from_planar(torch.from_numpy(src).double())
    want = nudft.exact_type1_subset(
        torch.from_numpy(pts), values, torch.arange(np.prod(grid)), grid,
        sign=-1.0 if direction == "forward" else 1.0)
    assert _relerr(torch.view_as_real(got.reshape(batch, -1)),
                   torch.view_as_real(want)) <= 10 * tol


def test_planned_adjoint_identity():
    """<A x, y> == <x, A^H y> for the planned pair."""
    grid, m = (64, 64), 1500
    pts = _points(m, 6)
    op = tnt.PlannedNufft(pts, grid, transform_type="type_2", device="cpu")
    x = torch.from_numpy(_source("type_2", grid, m, (1,), 7)).double()
    y = torch.from_numpy(_source("type_1", grid, m, (1,), 8)).double()
    ax = tnt.planar.from_planar(op(x.float()).double())
    ahy = tnt.planar.from_planar(op.adjoint()(y.float()).double())
    lhs = torch.vdot(ax.flatten(), tnt.planar.from_planar(y).flatten())
    rhs = torch.vdot(tnt.planar.from_planar(x).flatten(), ahy.flatten())
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)


def test_planned_equals_unplanned():
    grid, m = (64, 96), 2000
    pts = torch.from_numpy(_points(m, 9))
    src = torch.from_numpy(_source("type_1", grid, m, (2,), 10))
    op = tnt.PlannedNufft(pts, grid, transform_type="type_1")
    planned = op(src)
    unplanned = tnt.planar.nufft(src, pts, grid_shape=grid,
                                 transform_type="type_1")
    assert torch.equal(planned, unplanned)


@pytest.mark.parametrize("transform_type", ("type_1", "type_2"))
def test_broadcasting_matches_jax(transform_type):
    """Source batch (3, 1) x points batch (2,) -> (3, 2)."""
    grid, m = (64, 64), 500
    pts = _points(m, 12, batch=(2,))
    src = _source(transform_type, grid, m, (3, 1), 13)
    kw = dict(grid_shape=grid if transform_type == "type_1" else None,
              transform_type=transform_type)
    want = tfft.planar.nufft(src, pts, options=PALLAS, **kw)
    got = tnt.planar.nufft(torch.from_numpy(src), torch.from_numpy(pts),
                           **kw)
    expect = (3, 2) + ((grid + (2,)) if transform_type == "type_1"
                       else (m, 2))
    assert tuple(got.shape) == expect
    assert _relerr(got, want) <= RTOL


def test_max_batch_size_chunks_the_inner_batch():
    grid, m = (64, 64), 800
    pts = torch.from_numpy(_points(m, 14))
    src = torch.from_numpy(_source("type_2", grid, m, (5,), 15))
    full = tnt.planar.nufft(src, pts)
    chunked = tnt.planar.nufft(src, pts,
                               options=tnt.Options(max_batch_size=2))
    assert _relerr(chunked, full) <= 1e-6


def test_float64_matches_jax_float64():
    grid, m = (64, 64), 1000
    pts = _points(m, 16).astype(np.float64)
    src = _source("type_1", grid, m, (), 17).astype(np.float64)
    want = tfft.planar.nufft(src, pts, grid_shape=grid,
                             transform_type="type_1", tol=1e-9)
    got = tnt.planar.nufft(torch.from_numpy(src), torch.from_numpy(pts),
                           grid_shape=grid, transform_type="type_1",
                           tol=1e-9)
    assert got.dtype == torch.float64
    assert _relerr(got, want) <= 1e-9


def test_nudft_matches_jax():
    grid, m = (16, 24), 300
    pts = _points(m, 18).astype(np.float64)
    for transform_type in ("type_1", "type_2"):
        src = _source(transform_type, grid, m, (2,), 19).astype(np.float64)
        kw = dict(grid_shape=grid if transform_type == "type_1" else None,
                  transform_type=transform_type, fft_direction="backward")
        want = tfft.planar.nudft(src, pts, **kw)
        got = tnt.planar.nudft(torch.from_numpy(src),
                               torch.from_numpy(pts), **kw)
        assert _relerr(got, want) <= 1e-12


def test_planar_roundtrip():
    z = np.random.default_rng(20).standard_normal((3, 4)) + 1j
    p = tnt.planar.to_planar(z)
    assert tuple(p.shape) == (3, 4, 2)
    np.testing.assert_array_equal(tnt.planar.from_planar(p).numpy(), z)


def test_errors():
    pts = torch.from_numpy(_points(100, 21))
    src = torch.from_numpy(_source("type_1", (16, 16), 100, (), 22))
    with pytest.raises(ValueError, match="plan data"):
        tnt.PlannedNufft(pts.clone().requires_grad_(), (16, 16))
    op = tnt.PlannedNufft(pts, (16, 16), transform_type="type_1")
    with pytest.raises(ValueError, match="rank must be 1, 2 or 3"):
        tnt.planar.nufft(torch.zeros(10, 2), torch.zeros(10, 4),
                         grid_shape=(16,) * 4, transform_type="type_1")
    with pytest.raises(ValueError, match="grid_shape must be provided"):
        tnt.planar.nufft(src, pts, transform_type="type_1")
    with pytest.raises(ValueError, match="Invalid fft_direction"):
        tnt.planar.nufft(src, pts, grid_shape=(16, 16),
                         transform_type="type_1", fft_direction="up")
    with pytest.raises(TypeError, match="same as planar"):
        tnt.planar.nufft(src.double(), pts, grid_shape=(16, 16),
                         transform_type="type_1")
    with pytest.raises(ValueError, match="expects a source of shape"):
        op(src)
