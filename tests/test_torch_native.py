"""The port's native engine (``tensorflow_nufft_tpu_torch.native``) and
``Options(backend="native")`` against the JAX package.

The engine is the same ``cc/nufft_cpu.cc`` compiled with the same flags,
so the port's bindings give the JAX bindings' arrays bit for bit; the
eager NumPy API agrees with the JAX one within 1e-12 of the peak. The
backend runs the XLA path with the engine's spread and interp: within
1e-10 of the port's ``backend="xla"`` route in complex128 and 1e-5 of
its default route in complex64 (the JAX package's own gates in
``tests/test_native_backend.py``), and its gradients within 1e-3 of the
default route's (complex64) and 1e-8 of the JAX native backend's
(complex128; the source gradient conjugated, PyTorch's convention).
The tests skip only where the engine cannot be built.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorflow_nufft_tpu as tfft
import tensorflow_nufft_tpu_torch as tnt
from tensorflow_nufft_tpu import native as jnative
from tensorflow_nufft_tpu.native import engine as jengine
from tensorflow_nufft_tpu_torch import native as tnative
from tensorflow_nufft_tpu_torch.native import engine as tengine
from tests.torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.skipif(
    not (tnative.available() and jnative.available()),
    reason="native engine unavailable (no C++ compiler)")

NATIVE = tnt.Options(backend="native")
GRIDS = [(16,), (12, 16), (8, 10, 12)]
FINE = {1: (48,), 2: (36, 40), 3: (32, 34, 36)}


def relerr(got, want):
    if isinstance(got, torch.Tensor):
        got = got.detach().resolve_conj().numpy()
    want = np.asarray(want)
    return np.max(np.abs(got - want)) / (np.max(np.abs(want)) or 1.0)


def cplx(rng, shape, dtype=np.complex128):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


def pts(rng, m, rank, dtype=np.float64):
    return rng.uniform(-np.pi, np.pi, (m, rank)).astype(dtype)


def cpu(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("rank", [1, 2, 3])
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_engine_bit_equal_to_jax(dtype, rank):
    """spread and interp, widths 2 and 16, batch 2 (float32 at a smaller
    beta: exp(2.3 * 16) cubed overflows it)."""
    rng = np.random.default_rng(rank)
    fine_shape = FINE[rank]
    p = rng.uniform(0, 1, (40, rank)) * np.asarray(fine_shape)
    for width in (2, 16):
        beta = (2.3 if dtype == np.complex128 else 1.0) * width
        s = cplx(rng, (2, 40), dtype)
        got = tengine.spread(s, p, fine_shape, width, beta)
        want = jengine.spread(s, p, fine_shape, width, beta)
        assert got.dtype == want.dtype == dtype
        np.testing.assert_array_equal(got, want)
        grid = cplx(rng, (2,) + fine_shape, dtype)
        got = tengine.interp(grid, p, width, beta)
        np.testing.assert_array_equal(
            got, jengine.interp(grid, p, width, beta))
        assert np.all(np.isfinite(got)) and np.abs(got).max() > 0


@pytest.mark.parametrize("width", [0, 17])
def test_engine_width_guard(width):
    """The engine's stack-buffer guard, with the JAX message."""
    s = np.zeros((1, 3), np.complex128)
    grid = np.zeros((1, 40, 40), np.complex128)
    p = np.zeros((3, 2))
    with pytest.raises(ValueError) as jerr:
        jengine.spread(s, p, (40, 40), width, 30.0)
    with pytest.raises(ValueError, match=str(jerr.value)):
        tengine.spread(s, p, (40, 40), width, 30.0)
    with pytest.raises(ValueError, match=str(jerr.value)):
        tengine.interp(grid, p, width, 30.0)
    assert tengine.num_threads() >= 1


def test_engine_rank_guard():
    """Points whose rank is not the grid's never reach the engine."""
    with pytest.raises(ValueError, match="points must have shape"):
        tengine.spread(np.zeros((1, 3), np.complex128), np.zeros((3, 3)),
                       (40, 40), 4, 9.0)
    with pytest.raises(ValueError, match="points must have shape"):
        tengine.interp(np.zeros((1, 40), np.complex128), np.zeros((3, 2)),
                       4, 9.0)


@pytest.mark.parametrize("fft_direction", ["forward", "backward"])
@pytest.mark.parametrize("transform_type", ["type_1", "type_2"])
@pytest.mark.parametrize("grid_shape", GRIDS, ids=str)
def test_eager_nufft_matches_jax(grid_shape, transform_type,
                                 fft_direction):
    rng = np.random.default_rng(len(grid_shape))
    rank = len(grid_shape)
    points = pts(rng, 30, rank)
    kw = dict(transform_type=transform_type, fft_direction=fft_direction)
    if transform_type == "type_1":
        src, kw["grid_shape"] = cplx(rng, (2, 30)), grid_shape
    else:
        src = cplx(rng, (2,) + grid_shape)
    got = tnative.nufft(src, points, **kw)
    want = jnative.nufft(src, points, **kw)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert relerr(got, want) < 1e-12
    # complex64 on the engine's float32 entry points
    got = tnative.nufft(src[0].astype(np.complex64), points, **kw)
    want = jnative.nufft(src[0].astype(np.complex64), points, **kw)
    assert got.dtype == np.complex64 and relerr(got, want) < 1e-12


def test_eager_tol_1e12_and_spread_only():
    rng = np.random.default_rng(7)
    points = pts(rng, 40, 2)
    modes = cplx(rng, (12, 16))
    assert relerr(tnative.nufft(modes, points, tol=1e-12),
                  jnative.nufft(modes, points, tol=1e-12)) < 1e-12
    oracle = tnt.nudft(cpu(modes), cpu(points), device="cpu")
    assert relerr(tnative.nufft(modes, points, tol=1e-12), oracle) < 1e-10
    grid = cplx(rng, (3, 32, 40))
    assert relerr(tnative.interp(grid, points, tol=1e-8),
                  jnative.interp(grid, points, tol=1e-8)) < 1e-12
    vals = cplx(rng, (3, 40))
    assert relerr(tnative.spread(vals, points, (32, 40), tol=1e-8),
                  jnative.spread(vals, points, (32, 40), tol=1e-8)) < 1e-12


@pytest.mark.parametrize("transform_type", ["type_1", "type_2"])
def test_backend_complex(transform_type):
    """complex128 against the port's backend='xla' (1e-10) and the JAX
    eager native API (1e-12); complex64 against the default route."""
    rng = np.random.default_rng(11)
    grid_shape = (12, 16)
    points = pts(rng, 20, 2)
    if transform_type == "type_1":
        src, gs = cplx(rng, (20,)), grid_shape
    else:
        src, gs = cplx(rng, grid_shape), None
    kw = dict(grid_shape=gs, transform_type=transform_type, device="cpu")
    got = tnt.nufft(cpu(src), cpu(points), options=NATIVE, **kw)
    want = tnt.nufft(cpu(src), cpu(points),
                     options=tnt.Options(backend="xla"), **kw)
    assert got.dtype == torch.complex128 and relerr(got, want) < 1e-10
    assert relerr(got, jnative.nufft(
        src, points, grid_shape=gs, transform_type=transform_type)) < 1e-12
    s32, p32 = cpu(src.astype(np.complex64)), cpu(points.astype(np.float32))
    got = tnt.nufft(s32, p32, options=NATIVE, **kw)
    assert got.dtype == torch.complex64
    assert relerr(got, tnt.nufft(s32, p32, **kw)) < 1e-5


def test_backend_planar():
    rng = np.random.default_rng(13)
    points = pts(rng, 15, 2, np.float32)
    z = cplx(rng, (16, 16), np.complex64)
    grid = cplx(rng, (32, 32), np.complex64)
    vals = cplx(rng, (15,), np.complex64)
    planar = tnt.planar
    cases = [
        (planar.nufft(cpu(tnt.planar.to_planar(z)), cpu(points),
                      options=NATIVE, device="cpu"),
         jnative.nufft(z, points)),
        (planar.interp(cpu(tnt.planar.to_planar(grid)), cpu(points),
                       options=NATIVE, device="cpu"),
         jnative.interp(grid, points)),
        (planar.spread(cpu(tnt.planar.to_planar(vals)), cpu(points),
                       (32, 32), options=NATIVE, device="cpu"),
         jnative.spread(vals, points, (32, 32))),
    ]
    for got, want in cases:
        assert got.dtype == torch.float32
        assert relerr(tnt.planar.from_planar(got), want) < 1e-5


def _loss_grads(src, points, options, fn="nufft"):
    s = cpu(src).requires_grad_()
    p = cpu(points).requires_grad_()
    out = getattr(tnt, fn)(s, p, options=options, device="cpu")
    out.abs().square().sum().backward()
    return s.grad, p.grad


def test_backend_grad_complex64():
    """Source and points gradients through the transform and through
    the spread-only interp (whose points gradient is the XLA path's
    phi' interp) within 1e-3 of the default route's."""
    rng = np.random.default_rng(17)
    points = pts(rng, 12, 2, np.float32)
    for fn, shape in (("nufft", (16, 16)), ("interp", (32, 32))):
        src = cplx(rng, shape, np.complex64)
        got = _loss_grads(src, points, NATIVE, fn)
        want = _loss_grads(src, points, None, fn)
        for a, b in zip(got, want):
            assert relerr(a, b) < 1e-3, fn


def test_backend_grad_complex128_matches_jax():
    rng = np.random.default_rng(19)
    points = pts(rng, 12, 2)
    src = cplx(rng, (16, 16))
    opts = tfft.Options(backend="native")

    def loss(s, p):
        return jnp.sum(jnp.abs(tfft.nufft(s, p, options=opts)) ** 2)

    js, jp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(src),
                                             jnp.asarray(points))
    gs, gp = _loss_grads(src, points, NATIVE)
    assert relerr(gs.conj(), js) < 1e-8
    assert relerr(gp, jp) < 1e-8


def test_type3_plan_native():
    rng = np.random.default_rng(23)
    x = rng.uniform(-3, 7, (60, 2))
    t = rng.uniform(-20, 50, (50, 2))
    c = cplx(rng, (2, 60))
    got = tnt.Type3Plan(cpu(x), cpu(t), tol=1e-12, options=NATIVE)(cpu(c))
    want = tnt.Type3Plan(cpu(x), cpu(t), tol=1e-12,
                         options=tnt.Options(backend="xla"))(cpu(c))
    assert relerr(got, want) < 1e-10
    exact = tfft.nudft_type3(jnp.asarray(c), jnp.asarray(x), jnp.asarray(t))
    assert relerr(got, exact) < 1e-10


def test_planned_takes_level_none():
    rng = np.random.default_rng(29)
    points = cpu(pts(rng, 40, 2, np.float32))
    op = tnt.PlannedNufft(points, (16, 16), "type_1", options=NATIVE)
    assert op.level == "none"
    vals = cpu(tnt.planar.to_planar(cplx(rng, (1, 40), np.complex64)))
    want = tnt.planar.nufft(vals[0], points, grid_shape=(16, 16),
                            transform_type="type_1", options=NATIVE)
    torch.testing.assert_close(op(vals)[0], want, rtol=0, atol=0)
    x32 = cpu(pts(rng, 30, 2, np.float32) * 3)
    t32 = cpu(pts(rng, 30, 2, np.float32) * 8)
    assert tnt.planar.Type3Plan(x32, t32, options=NATIVE)._spread_level \
        == "none"


def test_unbuildable_engine_raises(monkeypatch):
    monkeypatch.setattr(tengine, "CXX", "/nonexistent/bin/g++")
    tengine._load.cache_clear()
    try:
        assert not tnative.available()
        with pytest.raises(RuntimeError, match="cannot build the native"):
            tnt.nufft(torch.ones(8, 8, dtype=torch.complex64),
                      torch.zeros(3, 2), options=NATIVE, device="cpu")
    finally:
        monkeypatch.undo()
        tengine._load.cache_clear()
    assert tnative.available()
